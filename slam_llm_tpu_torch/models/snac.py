"""SNAC neural audio codec decoder: codes -> waveform.

Counterpart of ``slam_llm_tpu/models/snac.py``: plain functions over the
parameter dict that ``convert_snac_torch_state`` makes from the published
``hubertsiuzdak/snac_24khz`` state dict (weight norm folded,
ConvTranspose1d in the dilated-conv form), its arrays moved to the device
once (``ops.torch_port.to_device``).

  3 codebooks at temporal strides [4, 2, 1] (codebook_dim 8) -> summed
  latent 768 -> conv7 -> 4 x [Snake, ConvTranspose(stride), NoiseBlock,
  3 x ResidualUnit (depthwise, dilations 1 / 3 / 9)] with rates
  [8, 8, 4, 2] -> Snake -> conv7 -> tanh: 512 samples a frame at 24 kHz.

The NoiseBlocks take their noise as tensors (``noises``), or draw it from a
``torch.Generator``; with neither they add none. f32 throughout.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from slam_llm_tpu_torch.ops.torch_port import conv1d_nct as _conv1d
from slam_llm_tpu_torch.ops.torch_port import fold_weight_norm as _fold_weight_norm
from slam_llm_tpu_torch.ops.torch_port import snake as _snake
from slam_llm_tpu_torch.ops.torch_port import to_np as _np


@dataclass(frozen=True)
class SNACConfig:
    sampling_rate: int = 24000
    decoder_dim: int = 1024
    decoder_rates: tuple = (8, 8, 4, 2)
    latent_dim: int = 768  # encoder_dim 48 * 2 ** len(encoder_rates)
    codebook_size: int = 4096
    codebook_dim: int = 8
    vq_strides: tuple = (4, 2, 1)
    noise: bool = True
    depthwise: bool = True

    @staticmethod
    def snac_24khz() -> "SNACConfig":
        return SNACConfig()

    @staticmethod
    def tiny_test() -> "SNACConfig":
        return SNACConfig(decoder_dim=32, decoder_rates=(4, 2), latent_dim=16, codebook_size=32, codebook_dim=4,
                          vq_strides=(2, 1))


def quantizer_from_codes(params: Dict, codes: Sequence[torch.Tensor], cfg: SNACConfig) -> torch.Tensor:
    """codes[i]: (B, T_i) int with T_i * stride_i == T_frames -> the summed
    latent (B, latent_dim, T_frames)."""
    z = None
    for i, stride in enumerate(cfg.vq_strides):
        p = params["quantizer"][i]
        zi = _conv1d(p["codebook"][codes[i]].transpose(1, 2), p["out_proj_w"], p["out_proj_b"])  # 1x1 -> latent
        if stride > 1:
            zi = torch.repeat_interleave(zi, stride, dim=-1)
        z = zi if z is None else z + zi
    return z


def _residual_unit(p: Dict, x):
    y = _snake(x, p["snake1"])
    y = _conv1d(y, p["conv1_w"], p["conv1_b"], padding=p["pad"], dilation=p["dilation"], groups=p["groups"])
    return x + _conv1d(_snake(y, p["snake2"]), p["conv2_w"], p["conv2_b"])


def noise_lengths(t_frames: int, cfg: SNACConfig) -> List[int]:
    """The time length of each decoder block's NoiseBlock input for a
    latent of ``t_frames`` frames."""
    out, t = [], t_frames
    for r in cfg.decoder_rates:
        t *= r
        out.append(t)
    return out


def decoder_apply(params: Dict, z: torch.Tensor, cfg: SNACConfig, noises: Optional[List[torch.Tensor]] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """latent (B, latent, T) -> waveform (B, 1, T * prod(rates)) in [-1, 1].
    ``noises[i]`` ((B, 1, T_i) f32) feeds block i's NoiseBlock; else noise
    from ``generator``; else none (a deterministic decode)."""
    dec = params["decoder"]
    x = _conv1d(z, dec["in_conv_w"], dec["in_conv_b"], padding=3)
    for i, blk in enumerate(dec["blocks"]):
        x = _snake(x, blk["snake"])
        x = _conv1d(x, blk["up_w"], blk["up_b"], lhs_dilation=blk["stride"], padding=blk["pad_lo"],
                    pad_hi=blk["pad_hi"])
        if cfg.noise and "noise_w" in blk:
            n = None
            if noises is not None:
                n = noises[i]
            elif generator is not None:
                n = torch.randn((x.shape[0], 1, x.shape[2]), generator=generator, device=x.device, dtype=x.dtype)
            if n is not None:
                x = x + _conv1d(x, blk["noise_w"], None) * n
        for ru in blk["res"]:
            x = _residual_unit(ru, x)
    x = _conv1d(_snake(x, dec["out_snake"]), dec["out_conv_w"], dec["out_conv_b"], padding=3)
    return torch.tanh(x)


def snac_decode(params: Dict, codes: Sequence, cfg: SNACConfig = SNACConfig(),
                noises: Optional[List[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """A list of (B, T_i) code arrays -> (B, samples) f32 on the device."""
    dev = params["quantizer"][0]["codebook"].device
    codes = [torch.as_tensor(np.asarray(c) if not isinstance(c, torch.Tensor) else c).to(dev, torch.int64)
             for c in codes]
    return decoder_apply(params, quantizer_from_codes(params, codes, cfg), cfg, noises, generator)[:, 0]


# ---------------------------------------------------------------------------
# the published checkpoint
# ---------------------------------------------------------------------------


def _bias(sd, prefix):
    k = f"{prefix}.bias"
    return _np(sd[k]) if k in sd else None


def transpose_to_conv(w_iok: np.ndarray, torch_padding: int, output_padding: int):
    """A ConvTranspose1d weight (I, O, K) -> the dilated-conv form: the
    flipped (O, I, K) kernel and (pad_lo, pad_hi) for lhs dilation = stride."""
    k = w_iok.shape[-1]
    w_oik = np.ascontiguousarray(w_iok.transpose(1, 0, 2)[:, :, ::-1])
    return w_oik, k - 1 - torch_padding, k - 1 - torch_padding + output_padding


def convert_snac_torch_state(sd: Dict, cfg: SNACConfig = SNACConfig()) -> Dict:
    """A snac-package state dict (tensors or arrays) -> the decode parameters
    as numpy. Keys: ``quantizer.quantizers.{i}.{codebook, out_proj}``,
    ``decoder.model.0`` the in-conv, ``decoder.model.{1 + i}`` the decoder
    blocks (``.block.{0 snake, 1 convT, 2 noise, 3..5 residual units}``),
    then the out snake and the out conv."""
    params: Dict = {"quantizer": [], "decoder": {}}
    for i in range(len(cfg.vq_strides)):
        q = f"quantizer.quantizers.{i}"
        params["quantizer"].append({"codebook": _np(sd[f"{q}.codebook.weight"]),
                                    "out_proj_w": _fold_weight_norm(sd, f"{q}.out_proj"),
                                    "out_proj_b": _bias(sd, f"{q}.out_proj")})
    dec: Dict = {"in_conv_w": _fold_weight_norm(sd, "decoder.model.0"), "in_conv_b": _bias(sd, "decoder.model.0")}
    blocks = []
    noise_off = 1 if cfg.noise else 0
    for i, stride in enumerate(cfg.decoder_rates):
        base = f"decoder.model.{1 + i}.block"
        out_dim = cfg.decoder_dim // (2 ** (i + 1))
        up_w, pad_lo, pad_hi = transpose_to_conv(_fold_weight_norm(sd, f"{base}.1"), math.ceil(stride / 2),
                                                 stride % 2)
        blk = {"snake": _np(sd[f"{base}.0.alpha"]).reshape(-1), "up_w": up_w, "up_b": _bias(sd, f"{base}.1"),
               "stride": stride, "pad_lo": pad_lo, "pad_hi": pad_hi, "res": []}
        if cfg.noise:
            blk["noise_w"] = _fold_weight_norm(sd, f"{base}.2.linear")
        groups = out_dim if cfg.depthwise else 1
        for j, dil in enumerate((1, 3, 9)):
            r = f"{base}.{2 + noise_off + j}.block"
            blk["res"].append({
                "snake1": _np(sd[f"{r}.0.alpha"]).reshape(-1), "conv1_w": _fold_weight_norm(sd, f"{r}.1"),
                "conv1_b": _bias(sd, f"{r}.1"), "snake2": _np(sd[f"{r}.2.alpha"]).reshape(-1),
                "conv2_w": _fold_weight_norm(sd, f"{r}.3"), "conv2_b": _bias(sd, f"{r}.3"),
                "dilation": dil, "pad": ((7 - 1) * dil) // 2, "groups": groups,
            })
        blocks.append(blk)
    dec["blocks"] = blocks
    snake_idx = 1 + len(cfg.decoder_rates)
    dec["out_snake"] = _np(sd[f"decoder.model.{snake_idx}.alpha"]).reshape(-1)
    dec["out_conv_w"] = _fold_weight_norm(sd, f"decoder.model.{snake_idx + 1}")
    dec["out_conv_b"] = _bias(sd, f"decoder.model.{snake_idx + 1}")
    params["decoder"] = dec
    return params
