"""Carry a parameter tree of the JAX package into the port.

``from_flax_params`` maps ``slam_llm_tpu``'s (flax) parameter tree, as
nested dicts of numpy arrays, onto this package's ``state_dict`` names:

* the scanned ``layers`` axis (the ViT encoder's ``blocks``) is unstacked
  into ``layers.{i}`` (``blocks.{i}``), and ``llm.decoder.layers`` becomes
  ``llm.layers``; every leaf under it is cut on axis 0, so the WavLM
  encoder's ``gru_rel_pos_const`` (L, 1, H, 1, 1) becomes each layer's
  (1, H, 1, 1);
* dense ``kernel`` (in, out) becomes ``weight`` (out, in), like ``nn.Linear``;
  the int8 ``kernel_q`` (in, out) becomes ``kernel_q`` (out, in), the K-major
  layout the int8 GEMM reads; LoRA ``lora_a`` (in, r) and ``lora_b`` (r, out)
  are transposed the same way;
* flax ``Conv`` ``kernel`` (k, in / groups, out) becomes ``Conv1d.weight``
  (out, in / groups, k), and back (``.T`` reverses the three axes); a 2-D
  ``Conv`` ``kernel`` (kh, kw, in, out) becomes ``Conv2d.weight`` (out, in,
  kh, kw), a 3-D one (kt, kh, kw, in, out) ``Conv3d.weight`` (out, in, kt,
  kh, kw) (AV-HuBERT's stem);
* ``Embed.embedding`` (V, D) becomes ``embed_tokens.weight``;
* Spatial-AST's flat ``down_kernel`` / ``patch_kernel`` (HWIO) and biases
  become its ``down`` and ``patch_embed`` convolutions; MusicFM's frozen
  BatchNorm leaves ``scale`` / ``mean`` / ``var`` become ``weight`` /
  ``running_mean`` / ``running_var``;
* the backward-only ``kernel_qr`` / ``kernel_scale_r`` and ``kernel_t`` are
  dropped: the port derives its ``int8_rot`` pair itself
  (``ops.quant.quantize_base_params``).

The result loads with ``model.load_state_dict(sd)``, which casts each tensor
to the dtype the port stores it in: the trainable leaves (LoRA factors, the
projector) into their f32 masters, bit-equal to the JAX values.
``trainable_to_flax`` maps trainable tensors back into the flax layout,
an encoder's through ``encoder_to_flax``, the exact inverse of
``encoder_from_flax``, so a trainable checkpoint of an unfrozen encoder
reads and writes the JAX package's names.

The CLAP family keeps flat parameter names in the JAX package (``l0_q_kernel``,
``s0b1_rpb``, ``bn0_mean``), and the port the reference's torch names:
``bert_from_flax``, ``htsat_from_flax``, ``cnn14_from_flax`` and
``clap_from_flax`` invert the JAX package's ``convert_*_torch_state``, and
``from_flax_params`` takes an ``hf-text`` model's BERT encoder through
``bert_from_flax``.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

_DROPPED = ("kernel_qr", "kernel_scale_r", "kernel_t")
_SCANNED = ("layers", "blocks")  # subtrees with a leading layer axis
_TO_FLAX_CONV = {4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}  # Conv2d / Conv3d weight -> flax kernel


def _leaf(name: str, arr: np.ndarray):
    if name in _DROPPED:
        return None
    if name == "kernel":
        if arr.ndim == 5:  # Conv (kt, kh, kw, in, out) -> (out, in, kt, kh, kw)
            return "weight", arr.transpose(4, 3, 0, 1, 2)
        if arr.ndim == 4:  # Conv (kh, kw, in, out) -> (out, in, kh, kw)
            return "weight", arr.transpose(3, 2, 0, 1)
        if arr.ndim == 3:  # Conv (k, in, out) -> (out, in, k)
            return "weight", arr.transpose(2, 1, 0)
        return "weight", arr.T
    if name in ("kernel_q", "lora_a", "lora_b"):
        return name, arr.T
    if name == "embedding":
        return "weight", arr
    return name, arr  # bias, scale, kernel_scale


def _walk(node: Mapping, prefix: List[str], out: Dict[str, torch.Tensor]) -> None:
    for key, val in node.items():
        if isinstance(val, Mapping):
            if key in _SCANNED:
                n = _leading_dim(val)
                for i in range(n):
                    _walk(_index(val, i), prefix + [key, str(i)], out)
            elif key == "decoder":
                _walk(val, prefix, out)
            else:
                _walk(val, prefix + [key], out)
            continue
        mapped = _leaf(key, np.asarray(val))
        if mapped is not None:
            out[".".join(prefix + [mapped[0]])] = torch.from_numpy(np.array(mapped[1]))


def _leading_dim(node: Mapping) -> int:
    for val in node.values():
        return _leading_dim(val) if isinstance(val, Mapping) else np.shape(val)[0]
    raise ValueError("empty layers subtree")


def _index(node: Mapping, i: int) -> dict:
    return {k: _index(v, i) if isinstance(v, Mapping) else np.asarray(v)[i] for k, v in node.items()}


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Map any flax subtree (a whole model or one module) to ``state_dict`` names."""
    out: Dict[str, torch.Tensor] = {}
    _walk(params, [], out)
    return out


def from_flax_params(params: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """``params``: the flax ``params`` collection of a ``SLAMModel`` (unboxed)
    as nested dicts of arrays; ``cfg``: the port's ``SLAMConfig``. Returns
    the port model's ``state_dict``."""
    out = flax_to_state_dict({k: v for k, v in params.items() if k != "encoder"})
    if "encoder" in params:
        enc = encoder_from_flax(params["encoder"], cfg.encoder_name)
        out.update({f"encoder.{k}": v for k, v in enc.items()})
    n = sum(1 for key in out if key.startswith("llm.layers.") and key.endswith(".input_norm.scale"))
    if n != cfg.llm.n_layers:
        raise ValueError(f"parameter tree has {n} decoder layers, config {cfg.llm.n_layers}")
    return out


def encoder_from_flax(params: Mapping, encoder_name: Optional[str]) -> Dict[str, torch.Tensor]:
    """One encoder's flax parameters, the whole tree or a trainable subset of
    it -> the port encoder's ``state_dict`` names: the generic mapping,
    BERT's flat names (``hf-text``), Spatial-AST's flat conv leaves,
    MusicFM's BatchNorm leaves. A leaf no rule knows keeps the generic name,
    so a partial load rejects it."""
    if encoder_name == "hf-text":
        out = {}
        for key, val in params.items():
            name, transposed = _bert_leaf(key) or (key, False)
            out[name] = _t(val, 1, 0) if transposed else _t(val)
        return out
    out = flax_to_state_dict(params)
    if encoder_name == "spatial_ast":
        return {_SPATIAL_AST_NAMES.get(k, k): v.permute(3, 2, 0, 1).contiguous() if k in _SPATIAL_AST_KERNELS else v
                for k, v in out.items()}
    if encoder_name == "musicfm":
        return {_batch_norm_name(k): v for k, v in out.items()}
    return out


def encoder_to_flax(tensors: Mapping, encoder_name: Optional[str]) -> dict:
    """Inverse of ``encoder_from_flax`` for any subset of an encoder's
    tensors (``state_dict`` names without the ``encoder.`` prefix): nested
    dicts of f32 numpy arrays in the JAX package's layout."""
    if encoder_name == "hf-text":
        out = {}
        for name, t in tensors.items():
            key, transposed = _bert_flax_name(name) or (name, False)
            arr = t.detach().cpu().float().numpy()
            out[key] = arr.T if transposed else arr
        return out
    if encoder_name == "spatial_ast":
        inverse = {v: k for k, v in _SPATIAL_AST_NAMES.items()}
        tensors = {inverse.get(n, n): t.permute(2, 3, 1, 0) if inverse.get(n) in _SPATIAL_AST_KERNELS else t
                   for n, t in tensors.items()}
    elif encoder_name == "musicfm":
        tensors = {_batch_norm_flax_name(n): t for n, t in tensors.items()}
    return _to_flax(tensors)


# the JAX SpatialASTEncoder's flat leaves (HWIO conv kernels) -> the port's modules
_SPATIAL_AST_NAMES = {"down_kernel": "down.weight", "down_bias": "down.bias", "patch_kernel": "patch_embed.weight",
                      "patch_bias": "patch_embed.bias"}
_SPATIAL_AST_KERNELS = ("down_kernel", "patch_kernel")
_BN_LEAVES = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def _is_batch_norm(path: List[str]) -> bool:
    return bool(path) and (path[-1].startswith("bn") or path[-1] == "conv_bn")


def _batch_norm_name(name: str) -> str:
    """A frozen BatchNorm's flax leaves (``scale`` / ``mean`` / ``var``, under
    a module named ``bn*`` or ``conv_bn``) -> torch's BatchNorm names."""
    *path, leaf = name.split(".")
    if _is_batch_norm(path) and leaf in _BN_LEAVES:
        return ".".join(path + [_BN_LEAVES[leaf]])
    return name


def _batch_norm_flax_name(name: str) -> str:
    """Inverse of ``_batch_norm_name``."""
    *path, leaf = name.split(".")
    inverse = {v: k for k, v in _BN_LEAVES.items()}
    if _is_batch_norm(path) and leaf in inverse:
        return ".".join(path + [inverse[leaf]])
    return name


def trainable_to_flax(tensors: Mapping, encoder_name: Optional[str] = None) -> dict:
    """Inverse of ``from_flax_params`` for trainable tensors (LoRA factors,
    projector kernels and biases, an unfrozen encoder's tensors): ``{name:
    tensor}`` in the port's ``state_dict`` names -> nested dicts of f32 numpy
    arrays in the flax layout, with the per-layer tensors restacked on the
    ``layers`` (or ``blocks``) axis and the LLM's under ``decoder``. The
    ``encoder.`` tensors go through ``encoder_to_flax`` for
    ``encoder_name``."""
    enc = {n[len("encoder."):]: t for n, t in tensors.items() if n.startswith("encoder.")}
    out = _to_flax({n: t for n, t in tensors.items() if not n.startswith("encoder.")})
    if enc:
        out["encoder"] = encoder_to_flax(enc, encoder_name)
    return out


def _to_flax(tensors: Mapping) -> dict:
    """The generic inverse mapping (see the module docstring)."""
    out: dict = {}
    stacked: Dict[tuple, Dict[int, np.ndarray]] = {}
    for name, t in tensors.items():
        *path, leaf = name.split(".")
        arr = t.detach().cpu().float().numpy()
        if leaf == "weight":
            leaf, arr = "kernel", arr.transpose(_TO_FLAX_CONV[arr.ndim]) if arr.ndim in _TO_FLAX_CONV else arr.T
        elif leaf in ("kernel_q", "lora_a", "lora_b"):
            arr = arr.T
        scanned = [k for k in path if k in _SCANNED]
        if scanned:
            i = path.index(scanned[0])
            key = tuple(path[:i] + (["decoder"] if path[:i] == ["llm"] else []) + [path[i]] + path[i + 2:] + [leaf])
            stacked.setdefault(key, {})[int(path[i + 1])] = arr
        else:
            _set(out, path + [leaf], arr)
    for key, layers in stacked.items():
        _set(out, list(key), np.stack([layers[i] for i in sorted(layers)]))
    return out


def _set(node: dict, path: List[str], value) -> None:
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


# ---------------------------------------------------------------------------
# the CLAP family: flat JAX names -> the reference's torch names
# ---------------------------------------------------------------------------


def _t(arr, *axes) -> torch.Tensor:
    a = np.asarray(arr, np.float32)
    return torch.from_numpy(np.array(a.transpose(*axes) if axes else a))


# BERT's flat JAX names: the embeddings, then l{i}_{module}_{kernel|bias|scale}
_BERT_EMBED = {"word_embeddings": "embeddings.word_embeddings.weight",
               "position_embeddings": "embeddings.position_embeddings.weight",
               "token_type_embeddings": "embeddings.token_type_embeddings.weight",
               "embed_norm_scale": "embeddings.LayerNorm.weight", "embed_norm_bias": "embeddings.LayerNorm.bias"}
_BERT_DENSE = {"q": "attention.self.query", "k": "attention.self.key", "v": "attention.self.value",
               "o": "attention.output.dense", "ffn_in": "intermediate.dense", "ffn_out": "output.dense"}
_BERT_NORMS = {"attn_norm": "attention.output.LayerNorm", "ffn_norm": "output.LayerNorm"}


def _bert_pairs(key: str) -> List[Tuple[str, str, bool]]:
    """The (JAX leaf, ``models.bert.BertEncoder`` name, whether the (in,
    out) kernel is transposed) triples of the layer that ``key`` names
    (``l{i}_...`` or ``encoder.layer.{i}....``), else of the embeddings."""
    m = re.match(r"l(\d+)_|encoder\.layer\.(\d+)\.", key)
    if m is None:
        return [(k, name, False) for k, name in _BERT_EMBED.items()]
    i = m.group(1) or m.group(2)
    out = []
    for name, hf in _BERT_DENSE.items():
        dst = f"encoder.layer.{i}.{hf}"
        out += [(f"l{i}_{name}_kernel", f"{dst}.weight", True), (f"l{i}_{name}_bias", f"{dst}.bias", False)]
    for name, hf in _BERT_NORMS.items():
        dst = f"encoder.layer.{i}.{hf}"
        out += [(f"l{i}_{name}_scale", f"{dst}.weight", False), (f"l{i}_{name}_bias", f"{dst}.bias", False)]
    return out


def _bert_leaf(key: str) -> Optional[Tuple[str, bool]]:
    """A JAX ``BertEncoder`` leaf -> (port name, transposed); None if unknown."""
    return next(((name, tr) for k, name, tr in _bert_pairs(key) if k == key), None)


def _bert_flax_name(name: str) -> Optional[Tuple[str, bool]]:
    """A port ``BertEncoder`` name -> (JAX leaf, transposed); None if unknown."""
    return next(((k, tr) for k, n, tr in _bert_pairs(name) if n == name), None)


def bert_from_flax(p: Mapping, n_layers: int) -> Dict[str, torch.Tensor]:
    """The JAX ``BertEncoder`` params -> ``models.bert.BertEncoder`` names."""
    out = encoder_from_flax(p, "hf-text")
    n = sum(1 for key in out if key.startswith("encoder.layer.") and key.endswith(".attention.self.query.weight"))
    if n != n_layers:
        raise ValueError(f"BERT parameter tree has {n} layers, config {n_layers}")
    return out


def htsat_from_flax(p: Mapping, depths) -> Dict[str, torch.Tensor]:
    """The JAX ``HTSAT`` params -> ``models.htsat.HTSAT`` names."""
    out = {"bn0.weight": _t(p["bn0_scale"]), "bn0.bias": _t(p["bn0_bias"]), "bn0.running_mean": _t(p["bn0_mean"]),
           "bn0.running_var": _t(p["bn0_var"]),
           "patch_embed.proj.weight": _t(p["patch_proj_kernel"], 3, 2, 0, 1),  # HWIO -> OIHW
           "patch_embed.proj.bias": _t(p["patch_proj_bias"]),
           "patch_embed.norm.weight": _t(p["patch_norm_scale"]), "patch_embed.norm.bias": _t(p["patch_norm_bias"]),
           "norm.weight": _t(p["norm_scale"]), "norm.bias": _t(p["norm_bias"]),
           "tscam_conv.weight": _t(p["tscam_kernel"], 3, 2, 0, 1), "tscam_conv.bias": _t(p["tscam_bias"])}
    for i, depth in enumerate(depths):
        for j in range(depth):
            src, dst = f"s{i}b{j}_", f"layers.{i}.blocks.{j}."
            for name, ref in (("norm1", "norm1"), ("norm2", "norm2")):
                out[f"{dst}{ref}.weight"], out[f"{dst}{ref}.bias"] = _t(p[src + name + "_scale"]), _t(p[src + name + "_bias"])
            for name, ref in (("qkv", "attn.qkv"), ("proj", "attn.proj"), ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
                out[f"{dst}{ref}.weight"] = _t(p[src + name + "_kernel"], 1, 0)
                out[f"{dst}{ref}.bias"] = _t(p[src + name + "_bias"])
            out[dst + "attn.relative_position_bias_table"] = _t(p[src + "rpb"])
        if i < len(depths) - 1:
            dst = f"layers.{i}.downsample."
            out[dst + "norm.weight"], out[dst + "norm.bias"] = _t(p[f"d{i}_norm_scale"]), _t(p[f"d{i}_norm_bias"])
            out[dst + "reduction.weight"] = _t(p[f"d{i}_reduction_kernel"], 1, 0)
    return out


def cnn14_from_flax(p: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX ``Cnn14`` params -> ``models.cnn14.Cnn14`` names."""

    def bn(prefix, node):
        return {f"{prefix}.weight": _t(node["scale"]), f"{prefix}.bias": _t(node["bias"]),
                f"{prefix}.running_mean": _t(node["mean"]), f"{prefix}.running_var": _t(node["var"])}

    out = bn("bn0", p["bn0"])
    for i in range(1, 7):
        blk = p[f"conv_block{i}"]
        for j in (1, 2):
            out[f"conv_block{i}.conv{j}.weight"] = _t(blk[f"conv{j}"]["kernel"], 3, 2, 0, 1)
            out.update(bn(f"conv_block{i}.bn{j}", blk[f"bn{j}"]))
    return out


def clap_from_flax(p: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """The JAX ``CLAP`` params (any audio tower) -> ``models.clap.CLAP``
    names; ``cfg``: the port's ``CLAPConfig``."""
    if cfg.audio_tower == "cnn14":
        audio = cnn14_from_flax(p["audio_enc"])
    elif cfg.audio_tower == "vit":  # the EAT ViT keeps the SLAM model's layout
        audio = flax_to_state_dict(p["audio_enc"])
    else:
        audio = htsat_from_flax(p["audio_enc"], cfg.htsat.depths)
    out = {f"audio_enc.{k}": v for k, v in audio.items()}
    out.update({f"text_enc.{k}": v for k, v in bert_from_flax(p["text_enc"], cfg.bert.n_layers).items()})
    for name in ("audio_proj", "text_proj"):
        for fc, i in (("fc1", 0), ("fc2", 2)):
            out[f"{name}.{i}.weight"] = _t(p[name][fc]["kernel"], 1, 0)
            out[f"{name}.{i}.bias"] = _t(p[name][fc]["bias"])
    out["temp"] = _t(p["temp"]).reshape(())
    return out
