"""HF and torch checkpoints -> the port's modules (llama family, whisper, WavLM / HuBERT, EAT, BEATs,
BERT, Spatial-AST, CLAP, AV-HuBERT).

Counterpart of ``slam_llm_tpu/utils/hf_loader.py``. The reference reads an HF
directory into f32 numpy, stacks every per-layer tensor on a scanned layer
axis and transposes (out, in) kernels to flax's (in, out). The port's
``nn.Linear`` layout is HF's own (out, in), so each HF name maps straight
onto one ``state_dict`` name, with no stack, transpose or second copy:

* ``load_hf_state_dict`` reads ``*.safetensors`` with the port's own reader
  (``utils.safetensors_io``, views of a memory map in the stored dtype), or
  ``pytorch_model*.bin`` / ``*.pt`` with ``torch.load(weights_only=True)``;
* ``convert_llama`` / ``convert_whisper_encoder`` rename (TinyLlama, vicuna,
  qwen2's q/k/v biases; whisper's ``model.encoder.`` / ``encoder.`` / bare
  prefixes); HF names nothing maps to are ignored, as in the reference:
  whisper's decoder and its learned ``embed_positions`` (the port's encoder
  adds the fixed sinusoid itself), llama's ``rotary_emb.inv_freq``;
* ``convert_encoder_checkpoint`` dispatches an encoder checkpoint as the
  reference does: an HF directory to whisper's converter or, for ``wavlm`` /
  ``hubert``, to ``models.wavlm.convert_wavlm``, or, for ``hf-text``, to
  ``models.bert.convert_bert_torch_state`` (the reference loads its
  ``HfTextEncoder`` from such a directory; the JAX package refuses it); a
  torch file of ``hubert`` to ``models.wavlm.convert_hubert_fairseq``, of
  ``eat`` to ``models.vit.convert_eat_fairseq``, of ``beats`` to
  ``models.beats.convert_beats``, of ``spatial_ast`` to
  ``models.spatial_ast.convert_spatialast_torch``, of ``beats_tokenizer``
  to ``models.beats_tokenizer.convert_beats_tokenizer``, of ``clap`` to
  ``models.clap.convert_ase_torch_state`` and of ``av_hubert`` to
  ``models.avhubert.convert_avhubert_fairseq``;
* ``overlay_`` copies each tensor into the model's tensor of that name, one
  tensor at a time, converting on the way to the stored dtype and device;
  an fp kernel meeting an int8 base (``kernel_q`` / ``kernel_scale``) is
  quantized per output channel there (``ops.quant.quantize_int8`` over K,
  bit-equal to the reference's host ``quantize_int8_np``).

A missing directory raises ``FileNotFoundError``; a converted name the model
lacks ``KeyError``; a shape that differs ``ValueError``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Tuple

import torch
from torch import nn

from slam_llm_tpu_torch.models.avhubert import convert_avhubert_fairseq
from slam_llm_tpu_torch.models.beats import convert_beats
from slam_llm_tpu_torch.models.beats_tokenizer import convert_beats_tokenizer
from slam_llm_tpu_torch.models.bert import convert_bert_torch_state
from slam_llm_tpu_torch.models.clap import convert_ase_torch_state
from slam_llm_tpu_torch.models.spatial_ast import convert_spatialast_torch
from slam_llm_tpu_torch.models.vit import convert_eat_fairseq
from slam_llm_tpu_torch.models.wavlm import convert_hubert_fairseq, convert_wavlm
from slam_llm_tpu_torch.ops.quant import quantize_int8
from slam_llm_tpu_torch.utils.safetensors_io import load_file, torch_load_file


def load_hf_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of an HF directory's ``*.safetensors`` (preferred) or
    ``pytorch_model*.bin`` / ``*.pt``, in its stored dtype, on the CPU."""
    p = Path(path)
    st_files = sorted(p.glob("*.safetensors"))
    files = st_files or sorted(p.glob("pytorch_model*.bin")) or sorted(p.glob("*.pt"))
    if not files:
        raise FileNotFoundError(f"no safetensors/bin checkpoints under {path}")
    sd: Dict[str, torch.Tensor] = {}
    for f in files:
        sd.update(load_file(str(f)) if st_files else torch_load_file(str(f)))
    return sd


def convert_llama(sd: Dict[str, torch.Tensor], llm_cfg) -> Dict[str, torch.Tensor]:
    """HF llama / vicuna / tinyllama / qwen2 names -> ``CausalLM`` names."""
    n = llm_cfg.n_layers
    pre = "model." if "model.embed_tokens.weight" in sd else ""
    out = {"embed_tokens.weight": sd[pre + "embed_tokens.weight"], "final_norm.scale": sd[pre + "norm.weight"]}
    for i in range(n):
        src, dst = f"{pre}layers.{i}.", f"layers.{i}."
        out[dst + "input_norm.scale"] = sd[src + "input_layernorm.weight"]
        out[dst + "post_attn_norm.scale"] = sd[src + "post_attention_layernorm.weight"]
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            out[f"{dst}attn.{name}.weight"] = sd[f"{src}self_attn.{name}.weight"]
            if llm_cfg.qkv_bias and name != "o_proj":  # qwen2
                out[f"{dst}attn.{name}.bias"] = sd[f"{src}self_attn.{name}.bias"]
        for name in ("gate_proj", "up_proj", "down_proj"):
            out[f"{dst}mlp.{name}.weight"] = sd[f"{src}mlp.{name}.weight"]
    if not llm_cfg.tied_embeddings:
        out["lm_head.weight"] = sd.get("lm_head.weight", sd[pre + "embed_tokens.weight"])
    return out


def convert_whisper_encoder(sd: Dict[str, torch.Tensor], enc_cfg) -> Dict[str, torch.Tensor]:
    """HF whisper (``model.encoder.*``, ``encoder.*`` or bare) -> ``WhisperEncoder`` names."""
    for prefix in ("model.encoder.", "encoder.", ""):
        if prefix + "conv1.weight" in sd:
            break
    else:
        raise KeyError("whisper encoder conv1.weight not found in checkpoint")
    out = {}
    for conv in ("conv1", "conv2"):
        out[f"{conv}.weight"] = sd[f"{prefix}{conv}.weight"]  # (out, in, k), Conv1d's layout
        out[f"{conv}.bias"] = sd[f"{prefix}{conv}.bias"]
    for i in range(enc_cfg.n_layers):
        src, dst = f"{prefix}layers.{i}.", f"layers.{i}."
        for hf, port in (("self_attn_layer_norm", "attn_ln"), ("final_layer_norm", "mlp_ln")):
            out[f"{dst}{port}.scale"] = sd[f"{src}{hf}.weight"]
            out[f"{dst}{port}.bias"] = sd[f"{src}{hf}.bias"]
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out[f"{dst}attn.{name}.weight"] = sd[f"{src}self_attn.{name}.weight"]
            if name != "k_proj":  # whisper's k has no bias
                out[f"{dst}attn.{name}.bias"] = sd[f"{src}self_attn.{name}.bias"]
        for name in ("fc1", "fc2"):
            out[f"{dst}{name}.weight"] = sd[f"{src}{name}.weight"]
            out[f"{dst}{name}.bias"] = sd[f"{src}{name}.bias"]
    out["ln_post.scale"] = sd[prefix + "layer_norm.weight"]
    out["ln_post.bias"] = sd[prefix + "layer_norm.bias"]
    return out


# the file-checkpoint families the port converts, by encoder_name
_FILE_CONVERTERS = {"hubert": convert_hubert_fairseq, "eat": convert_eat_fairseq, "beats": convert_beats,
                    "beats_tokenizer": convert_beats_tokenizer, "spatial_ast": convert_spatialast_torch,
                    "clap": convert_ase_torch_state, "av_hubert": convert_avhubert_fairseq}


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A torch ``.pt`` / ``.pth`` file -> its state dict, unwrapping the
    fairseq / lightning nests (``{"model": sd}``, ``{"state_dict": sd}``,
    ``{"module": sd}``). A fairseq checkpoint pickles its config beside the
    weights, so the file is unpickled whole, as the reference does: load
    only checkpoints from a source you trust."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    while isinstance(sd, dict):
        for k in ("model", "state_dict", "module"):
            if k in sd and isinstance(sd[k], dict):
                sd = sd[k]
                break
        else:
            break
    return sd


def convert_encoder_checkpoint(encoder_path: str, encoder_name: str, enc_cfg) -> Dict[str, torch.Tensor]:
    """An encoder checkpoint through its family's converter, dispatched as
    the reference's: an HF directory serves whisper, wavlm, hubert and
    hf-text (an HF ``BertModel``, any wrapper prefix); a torch file serves
    hubert (fairseq's schema), eat (data2vec2's), beats (the official
    BEATs checkpoint), beats_tokenizer (the official BEATs tokenizer's, into
    ``models.beats_tokenizer.BEATsTokenizer``; ``enc_cfg`` its
    ``BEATsTokenizerConfig``), spatial_ast (BAT's), clap (an ASE checkpoint)
    and av_hubert (fairseq's, its BatchNorms folded). Any other directory
    raises ``ValueError``, as in the reference (which has no directory
    converter for them, emotion2vec included)."""
    if os.path.isdir(encoder_path):
        if encoder_name == "whisper":
            return convert_whisper_encoder(load_hf_state_dict(encoder_path), enc_cfg)
        if encoder_name in ("wavlm", "hubert"):
            return convert_wavlm(load_hf_state_dict(encoder_path), enc_cfg)
        if encoder_name == "hf-text":
            from slam_llm_tpu_torch.utils.fense import strip_prefix

            return convert_bert_torch_state(strip_prefix(load_hf_state_dict(encoder_path)), enc_cfg)
        raise ValueError(f"encoder_name={encoder_name!r} cannot load an HF directory ({encoder_path!r}); "
                         "expected a torch checkpoint file")
    if not os.path.exists(encoder_path):
        # a typo here must not silently train random-init weights
        raise FileNotFoundError(
            f"model_config.encoder_path={encoder_path!r} does not exist (expected an HF dir or a torch checkpoint file)"
        )
    if encoder_name in _FILE_CONVERTERS:
        return _FILE_CONVERTERS[encoder_name](load_torch_checkpoint(encoder_path), enc_cfg)
    raise ValueError(f"no file-checkpoint converter for encoder {encoder_name!r} ({encoder_path!r}); whisper, wavlm, "
                     "hubert and hf-text load HF directories; hubert, eat, beats, beats_tokenizer, spatial_ast, clap "
                     "and av_hubert torch files")


def overlay_plan(module: nn.Module, tensors: Dict[str, torch.Tensor], where: str = "") -> List[Tuple]:
    """``overlay_``'s checks of ``tensors`` against the module's tensors
    (every name and shape), then its writes as ``(target name, source,
    quant)``: ``quant`` where an fp ``weight`` lands in its dense's int8
    base (the target is then its ``kernel_q``)."""
    targets = dict(module.state_dict(keep_vars=True))
    plan = []
    for name, src in tensors.items():
        base, _, leaf = name.rpartition(".")
        quant = leaf == "weight" and name not in targets and f"{base}.kernel_q" in targets
        target = f"{base}.kernel_q" if quant else name
        dst = targets.get(target)
        if dst is None:
            raise KeyError(f"converted key {where}{name} not in the model")
        if tuple(dst.shape) != tuple(src.shape):
            raise ValueError(f"shape mismatch at {where}{name}: model {tuple(dst.shape)} vs ckpt {tuple(src.shape)}")
        plan.append((target, src, quant))
    return plan


@torch.no_grad()
def write_overlay(targets: Dict[str, torch.Tensor], name: str, src: torch.Tensor, quant: bool) -> None:
    """One write of an overlay plan into ``targets`` (state_dict names):
    the source in the target's dtype and device, or quantized per output
    channel (over K) into ``name`` (a ``kernel_q``) and its ``kernel_scale``."""
    dst = targets[name]
    if quant:
        q, scale = quantize_int8(src.to(dst.device), contract_axis=-1)
        dst.copy_(q)
        targets[name[: -len("kernel_q")] + "kernel_scale"].copy_(scale)
    else:
        dst.copy_(src.to(dst.device))  # the stored dtype crosses, the target's dtype lands


@torch.no_grad()
def overlay_(module: nn.Module, tensors: Dict[str, torch.Tensor], where: str = "") -> nn.Module:
    """Copy ``tensors`` (``state_dict`` names under ``module``) into the
    module's tensors, each converted to the target's dtype and device; an fp
    ``weight`` whose dense holds an int8 base is quantized into its
    ``kernel_q`` / ``kernel_scale`` on the module's device. Every name and
    shape is checked before anything is copied; names the module has and
    ``tensors`` lacks (LoRA, the projector) keep their values."""
    targets = dict(module.state_dict(keep_vars=True))
    for name, src, quant in overlay_plan(module, tensors, where):
        write_overlay(targets, name, src, quant)
    return module


def pretrained_plan(model: nn.Module, model_config) -> List[Tuple]:
    """The overlay plan (``overlay_plan``, names under ``model``) of the HF
    LLM (``model_config.llm_path``) and encoder (``encoder_path``) onto a
    built ``SLAMModel``; every check runs first, a missing path raises."""
    plan = []
    if model_config.llm_path:
        if not os.path.isdir(model_config.llm_path):
            # a typo here must not silently train random-init weights
            raise FileNotFoundError(
                f"model_config.llm_path={model_config.llm_path!r} is not a checkpoint directory "
                "(expected an HF dir with config.json + safetensors/bin)"
            )
        sd = convert_llama(load_hf_state_dict(model_config.llm_path), model.cfg.llm)
        plan += [(f"llm.{n}", src, q) for n, src, q in overlay_plan(model.llm, sd, "llm.")]
    if model_config.encoder_path:
        if model.encoder is None:
            raise ValueError(f"model_config.encoder_path={model_config.encoder_path!r} given to a model without "
                             "an encoder")
        sub = convert_encoder_checkpoint(model_config.encoder_path, model_config.encoder_name, model.cfg.encoder)
        plan += [(f"encoder.{n}", src, q) for n, src, q in overlay_plan(model.encoder, sub, "encoder.")]
    return plan


def load_pretrained_into(model: nn.Module, model_config) -> nn.Module:
    """Overlay the HF LLM (``model_config.llm_path``) and encoder
    (``model_config.encoder_path``) onto a built ``SLAMModel`` in place."""
    targets = dict(model.state_dict(keep_vars=True))
    for name, src, quant in pretrained_plan(model, model_config):
        write_overlay(targets, name, src, quant)
    return model
