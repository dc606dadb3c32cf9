"""EnCodec decoder (codes -> waveform), the codec VALL-E X speaks through.

Counterpart of ``slam_llm_tpu/models/encodec.py``: plain functions over the
parameter dict that ``convert_encodec_torch_state`` makes from the
HuggingFace ``EncodecModel`` state dict (``facebook/encodec_24khz``), its
arrays moved to the device once (``ops.torch_port.to_device``).

  RVQ: the sum over the codes' codebooks of embed[code] (codebook_dim is the
  latent's, no output projection) -> (B, 128, T);
  SEANet decoder: causal conv7 (128 -> 512) -> 2-layer LSTM with a skip ->
  4 x [ELU, ConvTranspose(k = 2r, stride r, the causal right trim of k - r),
  ResnetBlock (conv k3 -> conv k1, a 1x1 conv shortcut)] with ratios
  (8, 5, 4, 2) -> ELU -> causal conv7 (32 -> 1): 320 samples a frame at
  24 kHz (75 frames a second).

The causal convolutions pad on the left in reflect mode (zero-extending a
signal shorter than the pad first), as the reference's. Weight norm is
folded at conversion; a ConvTranspose1d is kept in the dilated-conv form
(flipped (O, I, K) kernel, ``stride`` / ``pad_lo`` / ``pad_hi``), which
``ops.torch_port.conv1d_nct`` runs as ``conv_transpose1d``. Strides, pads
and dilations stay Python ints, also when read back from ``.msgpack``.
Everything is f32; ``encodec_decode`` runs with cuDNN's TF32 off
(``ops.torch_port.f32_convolutions``), so the card computes what the CPU
computes. ``load_encodec_checkpoint`` reads ``.safetensors`` and torch
``.bin`` / ``.pt`` state dicts with the port's own readers, and the
converted ``.msgpack`` that ``save_encodec_params`` writes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from slam_llm_tpu_torch.ops.torch_port import conv1d_nct as _conv1d
from slam_llm_tpu_torch.ops.torch_port import f32_convolutions
from slam_llm_tpu_torch.ops.torch_port import fold_weight_norm as _fold_weight_norm
from slam_llm_tpu_torch.ops.torch_port import to_np as _np

_INT_LEAVES = {"in_pad", "out_pad", "stride", "pad_lo", "pad_hi", "dilation", "pad"}


@dataclass(frozen=True)
class EncodecConfig:
    sampling_rate: int = 24000
    hidden_size: int = 128  # the latent's width, the codebook's too (no output projection)
    num_filters: int = 32
    upsampling_ratios: tuple = (8, 5, 4, 2)
    codebook_size: int = 1024
    num_quantizers: int = 32  # the checkpoint's; a decode uses the codes' count
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_growth_rate: int = 2
    num_residual_layers: int = 1
    num_lstm_layers: int = 2
    compress: int = 2
    use_conv_shortcut: bool = True  # the HF default; checkpoints carry a 1x1 shortcut conv

    @property
    def frame_stride(self) -> int:
        return int(np.prod(self.upsampling_ratios))

    @staticmethod
    def encodec_24khz() -> "EncodecConfig":
        return EncodecConfig()

    @staticmethod
    def tiny_test() -> "EncodecConfig":
        return EncodecConfig(hidden_size=16, num_filters=4, upsampling_ratios=(4, 2), codebook_size=32,
                             num_quantizers=4, num_lstm_layers=2)


# ---------------------------------------------------------------------------
# the decode graph
# ---------------------------------------------------------------------------


def rvq_decode(params: Dict, codes: torch.Tensor) -> torch.Tensor:
    """(B, n_q, T) int codes -> the summed latent (B, hidden, T)."""
    emb = params["codebooks"]  # (n_q available, codebook_size, hidden)
    z = emb[0][codes[:, 0]]
    for i in range(1, codes.shape[1]):
        z = z + emb[i][codes[:, i]]
    return z.transpose(1, 2)


def lstm_skip(layers: List[Dict], x: torch.Tensor) -> torch.Tensor:
    """torch ``nn.LSTM`` (gates i, f, g, o) over (B, C, T), plus its input
    (EnCodec's skip block); the input products hoisted out of the time loop."""
    h = x.permute(2, 0, 1)  # (T, B, C)
    for p in layers:
        wh = p["weight_hh"]
        xs = torch.einsum("tbc,gc->tbg", h, p["weight_ih"]) + (p["bias_ih"] + p["bias_hh"])
        hp = cp = h.new_zeros(h.shape[1], wh.shape[1])
        outs = []
        for xt in xs:
            i, f, g, o = (xt + hp @ wh.T).chunk(4, dim=-1)
            cp = torch.sigmoid(f) * cp + torch.sigmoid(i) * torch.tanh(g)
            hp = torch.sigmoid(o) * torch.tanh(cp)
            outs.append(hp)
        h = torch.stack(outs)
    return h.permute(1, 2, 0) + x


def _causal_conv(h: torch.Tensor, w: torch.Tensor, b, pad: int, dilation: int = 1) -> torch.Tensor:
    """Left pad ``pad`` in reflect mode (zero-extended first when the signal
    is not longer than the pad), then the convolution."""
    t = h.shape[-1]
    extra = pad - t + 1 if t <= pad else 0
    if extra:
        h = F.pad(h, (0, extra))
    h = F.pad(h, (pad, 0), mode="reflect")
    if extra:
        h = h[..., :-extra]
    return _conv1d(h, w, b, dilation=dilation)


def decoder_apply(params: Dict, z: torch.Tensor, cfg: EncodecConfig) -> torch.Tensor:
    """latent (B, hidden, T) -> waveform (B, 1, T * frame_stride)."""
    dec = params["decoder"]
    x = _causal_conv(z, dec["in_conv_w"], dec["in_conv_b"], dec["in_pad"])
    x = lstm_skip(dec["lstm"], x)
    for blk in dec["blocks"]:
        x = _conv1d(F.elu(x), blk["up_w"], blk["up_b"], lhs_dilation=blk["stride"], padding=blk["pad_lo"],
                    pad_hi=blk["pad_hi"])
        for ru in blk["res"]:
            y = _causal_conv(F.elu(x), ru["conv1_w"], ru["conv1_b"], ru["pad"], ru["dilation"])
            y = _conv1d(F.elu(y), ru["conv2_w"], ru["conv2_b"])
            sc = _conv1d(x, ru["shortcut_w"], ru["shortcut_b"]) if "shortcut_w" in ru else x
            x = sc + y
    return _causal_conv(F.elu(x), dec["out_conv_w"], dec["out_conv_b"], dec["out_pad"])


@torch.no_grad()
def encodec_decode(params: Dict, codes, cfg: EncodecConfig = EncodecConfig()) -> np.ndarray:
    """(B, n_q, T) int codes -> (B, samples) f32 waveform, on the device of
    ``params`` (``ops.torch_port.to_device``), with cuDNN's TF32 off."""
    dev = params["codebooks"].device
    codes = torch.as_tensor(np.asarray(codes), dtype=torch.int64, device=dev)
    with f32_convolutions():
        wav = decoder_apply(params, rvq_decode(params, codes), cfg)
    return wav[:, 0].cpu().numpy()


# ---------------------------------------------------------------------------
# checkpoints (the HF transformers EncodecModel schema)
# ---------------------------------------------------------------------------


def _bias(sd, prefix):
    k = f"{prefix}.bias"
    return _np(sd[k]) if k in sd else None


def _has_conv(sd, prefix) -> bool:
    return any(f"{prefix}.{leaf}" in sd for leaf in ("weight_g", "parametrizations.weight.original0", "weight"))


def convert_encodec_torch_state(sd: Dict, cfg: EncodecConfig = EncodecConfig()) -> Dict:
    """HF ``EncodecModel`` state dict -> decode params (numpy arrays and
    ints). Codebooks at ``quantizer.layers.{i}.codebook.embed``; the decoder
    at ``decoder.layers.{j}``: 0 the input conv, 1 the LSTM, then per ratio
    [ELU, ConvTranspose, ``num_residual_layers`` ResnetBlocks], then [ELU,
    the output conv]. Weight norm (either key form) is folded; a
    ConvTranspose1d weight (I, O, K) becomes the flipped (O, I, K) kernel of
    the dilated-conv form, with the causal right trim in its pads."""
    n_q = 0
    while f"quantizer.layers.{n_q}.codebook.embed" in sd:
        n_q += 1
    codebooks = np.stack([_np(sd[f"quantizer.layers.{i}.codebook.embed"]) for i in range(n_q)])
    dec: Dict = {
        "in_conv_w": _fold_weight_norm(sd, "decoder.layers.0.conv"),
        "in_conv_b": _bias(sd, "decoder.layers.0.conv"),
        "in_pad": cfg.kernel_size - 1,
        "lstm": [{name: _np(sd[f"decoder.layers.1.lstm.{name}_l{i}"])
                  for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")} for i in range(cfg.num_lstm_layers)],
    }
    blocks = []
    idx = 2
    for ratio in cfg.upsampling_ratios:
        idx += 1  # the ELU
        w_iok = _fold_weight_norm(sd, f"decoder.layers.{idx}.conv")
        k = w_iok.shape[-1]
        blk = {"up_w": np.ascontiguousarray(w_iok.transpose(1, 0, 2)[:, :, ::-1]),
               "up_b": _bias(sd, f"decoder.layers.{idx}.conv"),
               "stride": ratio, "pad_lo": k - 1, "pad_hi": ratio - 1, "res": []}
        idx += 1
        for j in range(cfg.num_residual_layers):
            base = f"decoder.layers.{idx}"
            dil = cfg.dilation_growth_rate ** j
            ru = {"conv1_w": _fold_weight_norm(sd, f"{base}.block.1.conv"), "conv1_b": _bias(sd, f"{base}.block.1.conv"),
                  "conv2_w": _fold_weight_norm(sd, f"{base}.block.3.conv"), "conv2_b": _bias(sd, f"{base}.block.3.conv"),
                  "dilation": dil, "pad": (cfg.residual_kernel_size - 1) * dil}
            if _has_conv(sd, f"{base}.shortcut.conv"):
                ru["shortcut_w"] = _fold_weight_norm(sd, f"{base}.shortcut.conv")
                ru["shortcut_b"] = _bias(sd, f"{base}.shortcut.conv")
            blk["res"].append(ru)
            idx += 1
        blocks.append(blk)
    dec["blocks"] = blocks
    idx += 1  # the final ELU
    dec["out_conv_w"] = _fold_weight_norm(sd, f"decoder.layers.{idx}.conv")
    dec["out_conv_b"] = _bias(sd, f"decoder.layers.{idx}.conv")
    dec["out_pad"] = cfg.last_kernel_size - 1
    return {"codebooks": codebooks, "decoder": dec}


def _ordered(node):
    """msgpack's ``{"0": ..., "1": ...}`` back into lists, and the leaves
    that are strides, pads and dilations back into Python ints."""
    if isinstance(node, dict):
        if node and all(k.isdigit() for k in node):
            return [_ordered(node[k]) for k in sorted(node, key=int)]
        return {k: int(np.asarray(v)) if k in _INT_LEAVES else _ordered(v) for k, v in node.items()}
    if isinstance(node, torch.Tensor):
        return node.float().numpy()
    return node


def load_encodec_checkpoint(path: str, cfg: EncodecConfig = EncodecConfig()) -> Dict:
    """Decode params (numpy, on the host) from ``.safetensors`` (the HF
    artifact), a torch ``.bin`` / ``.pt`` state dict (or ``{"model": sd}``),
    or the converted ``.msgpack`` of ``save_encodec_params``."""
    if path.endswith(".msgpack"):
        from slam_llm_tpu_torch.utils import msgpack_codec

        with open(path, "rb") as f:
            return _ordered(msgpack_codec.restore(f.read()))
    if path.endswith(".safetensors"):
        from slam_llm_tpu_torch.utils.safetensors_io import load_file

        sd = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        sd = sd.get("model", sd) if isinstance(sd, dict) else sd
    return convert_encodec_torch_state(sd, cfg)


def save_encodec_params(path: str, params: Dict) -> None:
    """Converted decode params as msgpack (lists as ``{"0": ...}`` maps, as
    flax's serializer writes them), read by either package."""
    from slam_llm_tpu_torch.utils import msgpack_codec

    def tree(node):
        if isinstance(node, list):
            return {str(i): tree(v) for i, v in enumerate(node)}
        if isinstance(node, dict):
            return {k: tree(v) for k, v in node.items() if v is not None}
        return node

    with open(path, "wb") as f:
        f.write(msgpack_codec.serialize(tree(params)))


def init_encodec_params(rng: np.random.Generator, cfg: EncodecConfig) -> Dict:
    """Random decode params of the right shapes (normal, std 0.05), drawn in
    the JAX package's order."""

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.05

    d0 = 2 ** len(cfg.upsampling_ratios) * cfg.num_filters
    params: Dict = {
        "codebooks": w(cfg.num_quantizers, cfg.codebook_size, cfg.hidden_size),
        "decoder": {
            "in_conv_w": w(d0, cfg.hidden_size, cfg.kernel_size), "in_conv_b": w(d0), "in_pad": cfg.kernel_size - 1,
            "lstm": [{"weight_ih": w(4 * d0, d0), "weight_hh": w(4 * d0, d0), "bias_ih": w(4 * d0),
                      "bias_hh": w(4 * d0)} for _ in range(cfg.num_lstm_layers)],
            "blocks": [],
        },
    }
    dim = d0
    for ratio in cfg.upsampling_ratios:
        k, out = ratio * 2, dim // 2
        blk = {"up_w": w(out, dim, k), "up_b": w(out), "stride": ratio, "pad_lo": k - 1, "pad_hi": ratio - 1,
               "res": []}
        hidden = out // cfg.compress
        for j in range(cfg.num_residual_layers):
            dil = cfg.dilation_growth_rate ** j
            ru = {"conv1_w": w(hidden, out, cfg.residual_kernel_size), "conv1_b": w(hidden),
                  "conv2_w": w(out, hidden, 1), "conv2_b": w(out), "dilation": dil,
                  "pad": (cfg.residual_kernel_size - 1) * dil}
            if cfg.use_conv_shortcut:
                ru["shortcut_w"], ru["shortcut_b"] = w(out, out, 1), w(out)
            blk["res"].append(ru)
        params["decoder"]["blocks"].append(blk)
        dim = out
    params["decoder"]["out_conv_w"] = w(1, dim, cfg.last_kernel_size)
    params["decoder"]["out_conv_b"] = w(1)
    params["decoder"]["out_pad"] = cfg.last_kernel_size - 1
    return params
