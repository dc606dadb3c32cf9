"""HiFT-GAN vocoder (CosyVoice): mel (B, 80, T) -> waveform at 22.05 kHz.

Counterpart of ``slam_llm_tpu/models/hift.py``: plain functions over the
parameter dict that ``convert_hift_torch_state`` makes from CosyVoice's
``hift.pt`` (weight norm folded, ConvTranspose1d in the dilated-conv form),
its arrays moved to the device once (``ops.torch_port.to_device``).

  mel -> ConvRNNF0Predictor -> f0 -> 256x nearest upsample -> sine source
  -> tanh(linear) -> source s; s --STFT(16, 4)--> 18 channels fused into
  each scale of conv_pre -> [ConvTranspose x8, x8 + 3 Snake ResBlocks]
  -> conv_post -> (log-magnitude, phase) -> iSTFT -> clip.

The 16-point STFT / iSTFT are DFT products, as in the JAX package. The sine
source's phase is ``cumsum(f0 / sr) % 1`` in f32 over the 22,050 Hz
samples: a different summation order (the card's scan) drifts the phase
over a long clip, so a long clip is compared by its spectral envelope and a
short one sample by sample. ``generator=None`` is the deterministic source
(zero phase offsets, no additive noise), the JAX package's ``rng=None``.
Everything runs in f32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from slam_llm_tpu_torch.ops.torch_port import conv1d_nct as _conv1d
from slam_llm_tpu_torch.ops.torch_port import fold_weight_norm as _fold_wn
from slam_llm_tpu_torch.ops.torch_port import snake as _snake
from slam_llm_tpu_torch.ops.torch_port import to_np as _np


@dataclass(frozen=True)
class HiFTConfig:
    in_channels: int = 80
    base_channels: int = 512
    nb_harmonics: int = 8
    sampling_rate: int = 22050
    nsf_alpha: float = 0.1
    nsf_sigma: float = 0.003
    nsf_voiced_threshold: float = 10.0
    upsample_rates: tuple = (8, 8)
    upsample_kernel_sizes: tuple = (16, 16)
    n_fft: int = 16
    hop_len: int = 4
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilations: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    source_resblock_kernel_sizes: tuple = (7, 11)
    source_resblock_dilations: tuple = ((1, 3, 5), (1, 3, 5))
    lrelu_slope: float = 0.1
    audio_limit: float = 0.99
    f0_cond_channels: int = 512

    @property
    def upsample_total(self) -> int:
        out = self.hop_len
        for u in self.upsample_rates:
            out *= u
        return out  # 256 samples per mel frame

    @staticmethod
    def tiny_test() -> "HiFTConfig":
        return HiFTConfig(
            in_channels=8, base_channels=16, nb_harmonics=2, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
            resblock_kernel_sizes=(3,), resblock_dilations=((1, 2),), source_resblock_kernel_sizes=(3, 3),
            source_resblock_dilations=((1, 2), (1, 2)), f0_cond_channels=12,
        )


def _leaky(x, slope):
    return torch.where(x >= 0, x, slope * x)


def _hann_periodic(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)).astype(np.float32)


def _dft_mats(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """(n_fft, F) cos / -sin matrices; F = n_fft // 2 + 1."""
    ang = 2 * np.pi * np.arange(n_fft)[:, None] * np.arange(n_fft // 2 + 1)[None, :] / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def stft_small(x: torch.Tensor, n_fft: int, hop: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T) -> (real, imag), each (B, F, frames); torch.stft's semantics
    (center, reflect pad, periodic Hann) as DFT products."""
    dev = x.device
    w = torch.from_numpy(_hann_periodic(n_fft)).to(dev)
    cos_m, msin_m = (torch.from_numpy(m).to(dev) for m in _dft_mats(n_fft))
    pad = n_fft // 2
    xp = torch.nn.functional.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    n_frames = 1 + (xp.shape[-1] - n_fft) // hop
    frames = xp.unfold(-1, n_fft, hop)[:, :n_frames] * w  # (B, frames, n_fft)
    return torch.einsum("btn,nf->bft", frames, cos_m), torch.einsum("btn,nf->bft", frames, msin_m)


def istft_small(real: torch.Tensor, imag: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, F, frames) -> (B, (frames - 1) * hop); torch.istft's semantics
    (center, periodic Hann, window-envelope normalization)."""
    b, f, t = real.shape
    dev = real.device
    cos_m, msin_m = _dft_mats(n_fft)
    scale = np.full(f, 2.0, np.float32)  # irfft by conjugate symmetry: bins 1 .. F-2 twice
    scale[0] = 1.0
    if n_fft % 2 == 0:
        scale[-1] = 1.0
    ir_cos = torch.from_numpy((cos_m * scale[None, :]).T / n_fft).to(dev)  # (F, n_fft)
    ir_sin = torch.from_numpy((msin_m * scale[None, :]).T / n_fft).to(dev)
    frames = torch.einsum("bft,fn->btn", real, ir_cos) + torch.einsum("bft,fn->btn", imag, ir_sin)
    w = torch.from_numpy(_hann_periodic(n_fft)).to(dev)
    frames = frames * w
    out_len = n_fft + hop * (t - 1)
    idx = (torch.arange(t, device=dev)[:, None] * hop + torch.arange(n_fft, device=dev)[None, :]).reshape(-1)
    sig = frames.new_zeros(b, out_len).index_add_(1, idx, frames.reshape(b, -1))
    env = w.new_zeros(out_len).index_add_(0, idx, (w * w).repeat(t))
    sig = sig / env.clamp_min(1e-11)[None]
    pad = n_fft // 2
    return sig[:, pad:-pad]


def _resblock(p: Dict, x, dilations):
    for i, _ in enumerate(dilations):
        xt = _snake(x, p[f"a1_{i}"])
        xt = _conv1d(xt, p[f"c1_{i}_w"], p[f"c1_{i}_b"], padding=p[f"c1_{i}_pad"], dilation=p[f"c1_{i}_dil"])
        xt = _snake(xt, p[f"a2_{i}"])
        xt = _conv1d(xt, p[f"c2_{i}_w"], p[f"c2_{i}_b"], padding=p[f"c2_{i}_pad"])
        x = x + xt
    return x


def f0_predict(p: Dict, mel: torch.Tensor) -> torch.Tensor:
    """ConvRNNF0Predictor: mel (B, C, T) -> f0 (B, T) in Hz."""
    x = mel
    for i in range(5):
        x = _conv1d(x, p[f"c{i}_w"], p[f"c{i}_b"], padding=1)
        x = torch.where(x > 0, x, torch.exp(x.clamp_max(0.0)) - 1.0)  # ELU
    x = torch.einsum("bct,co->bto", x, p["cls_w"]) + p["cls_b"]
    return x[..., 0].abs()


def sine_source(p: Dict, f0_up: torch.Tensor, cfg: HiFTConfig,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """SourceModuleHnNSF: upsampled f0 (B, L) -> source (B, 1, L). With a
    ``generator``: uniform phase offsets (none on the fundamental) and
    Gaussian noise, as the reference samples them."""
    b, L = f0_up.shape
    h = cfg.nb_harmonics + 1
    dev = f0_up.device
    mult = (torch.arange(1, h + 1, dtype=torch.float32, device=dev) / cfg.sampling_rate)[None, :, None]
    theta = 2 * np.pi * (torch.cumsum(f0_up[:, None, :] * mult, dim=-1) % 1.0)  # (B, H, L)
    if generator is not None:
        phase = (torch.rand((b, h, 1), generator=generator, device=dev) * 2 - 1) * np.pi
        phase[:, 0] = 0.0
    else:
        phase = theta.new_zeros(b, h, 1)
    sine = cfg.nsf_alpha * torch.sin(theta + phase)
    uv = (f0_up > cfg.nsf_voiced_threshold).float()[:, None, :]
    if generator is not None:
        noise_amp = uv * cfg.nsf_sigma + (1 - uv) * cfg.nsf_alpha / 3
        sine = sine * uv + noise_amp * torch.randn(sine.shape, generator=generator, device=dev)
    else:
        sine = sine * uv
    merged = torch.einsum("bhl,ho->bol", sine, p["lin_w"]) + p["lin_b"][None, :, None]
    return torch.tanh(merged)


def hift_decode(params: Dict, mel: torch.Tensor, cfg: HiFTConfig = HiFTConfig(),
                generator: Optional[torch.Generator] = None, source: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mel (B, 80, T) -> waveform (B, T * 256). ``source`` reuses an NSF
    excitation (streaming continuity)."""
    if source is None:
        f0 = f0_predict(params["f0"], mel)
        f0_up = torch.repeat_interleave(f0, cfg.upsample_total, dim=-1)  # nearest upsample
        source = sine_source(params["source"], f0_up, cfg, generator)
    s_real, s_imag = stft_small(source[:, 0, :], cfg.n_fft, cfg.hop_len)
    s_stft = torch.cat([s_real, s_imag], dim=1)  # (B, 18, Ts)

    p = params
    x = _conv1d(mel, p["conv_pre_w"], p["conv_pre_b"], padding=3)
    n_up, nk = len(cfg.upsample_rates), len(cfg.resblock_kernel_sizes)
    for i in range(n_up):
        x = _leaky(x, cfg.lrelu_slope)
        up = p[f"up_{i}"]
        x = _conv1d(x, up["w"], up["b"], lhs_dilation=up["stride"], padding=up["pad_lo"], pad_hi=up["pad_hi"])
        if i == n_up - 1:
            x = torch.cat([x[:, :, 1:2], x], dim=-1)  # reflection pad (1, 0)
        sd = p[f"source_down_{i}"]
        si = _conv1d(s_stft, sd["w"], sd["b"], stride=sd["stride"], padding=sd["pad"])
        si = _resblock(p[f"source_res_{i}"], si, cfg.source_resblock_dilations[i])
        tlen = x.shape[-1]
        si = si[:, :, :tlen]
        if si.shape[-1] < tlen:
            si = torch.nn.functional.pad(si, (0, tlen - si.shape[-1]))
        x = x + si
        xs = None
        for j in range(nk):
            r = _resblock(p[f"res_{i}_{j}"], x, cfg.resblock_dilations[j])
            xs = r if xs is None else xs + r
        x = xs / nk
    x = _leaky(x, 0.01)  # F.leaky_relu's default slope
    x = _conv1d(x, p["conv_post_w"], p["conv_post_b"], padding=3)
    fbins = cfg.n_fft // 2 + 1
    magnitude = torch.exp(x[:, :fbins].clamp_max(math.log(1e2)))
    phase = torch.sin(x[:, fbins:])
    wav = istft_small(magnitude * torch.cos(phase), magnitude * torch.sin(phase), cfg.n_fft, cfg.hop_len)
    return wav.clamp(-cfg.audio_limit, cfg.audio_limit)


# ---------------------------------------------------------------------------
# the reference checkpoint
# ---------------------------------------------------------------------------


def _resblock_params(sd, prefix, kernel, dilations):
    p = {}
    for i, d in enumerate(dilations):
        p[f"a1_{i}"] = _np(sd[f"{prefix}.activations1.{i}.alpha"]).reshape(-1)
        p[f"a2_{i}"] = _np(sd[f"{prefix}.activations2.{i}.alpha"]).reshape(-1)
        p[f"c1_{i}_w"] = _fold_wn(sd, f"{prefix}.convs1.{i}")
        p[f"c1_{i}_b"] = _np(sd[f"{prefix}.convs1.{i}.bias"])
        p[f"c1_{i}_pad"] = (kernel - 1) * d // 2
        p[f"c1_{i}_dil"] = d
        p[f"c2_{i}_w"] = _fold_wn(sd, f"{prefix}.convs2.{i}")
        p[f"c2_{i}_b"] = _np(sd[f"{prefix}.convs2.{i}.bias"])
        p[f"c2_{i}_pad"] = (kernel - 1) // 2
    return p


def convert_hift_torch_state(sd: Dict[str, Any], cfg: HiFTConfig = HiFTConfig()) -> Dict:
    """CosyVoice ``hift.pt`` state dict -> ``hift_decode``'s parameters as
    numpy (weight norm folded, ConvTranspose1d in the dilated-conv form);
    ``ops.torch_port.to_device`` puts them on the card."""
    p: Dict[str, Any] = {}
    f0p = {}
    for i in range(5):  # condnet 0, 2, 4, 6, 8 are the weight-normed convs
        f0p[f"c{i}_w"] = _fold_wn(sd, f"f0_predictor.condnet.{2 * i}")
        f0p[f"c{i}_b"] = _np(sd[f"f0_predictor.condnet.{2 * i}.bias"])
    f0p["cls_w"] = _np(sd["f0_predictor.classifier.weight"]).T  # (C, 1)
    f0p["cls_b"] = _np(sd["f0_predictor.classifier.bias"])
    p["f0"] = f0p
    p["source"] = {"lin_w": _np(sd["m_source.l_linear.weight"]).T, "lin_b": _np(sd["m_source.l_linear.bias"])}
    p["conv_pre_w"] = _fold_wn(sd, "conv_pre")
    p["conv_pre_b"] = _np(sd["conv_pre.bias"])
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        w = _fold_wn(sd, f"ups.{i}")  # ConvTranspose1d (in, out, k)
        torch_pad = (k - u) // 2
        p[f"up_{i}"] = {"w": np.ascontiguousarray(w.transpose(1, 0, 2)[:, :, ::-1]), "b": _np(sd[f"ups.{i}.bias"]),
                        "stride": u, "pad_lo": k - 1 - torch_pad, "pad_hi": k - 1 - torch_pad}
    down_rates = [1] + list(cfg.upsample_rates[::-1][:-1])
    cum = np.cumprod(down_rates)[::-1]
    for i, u in enumerate(cum):
        u = int(u)
        p[f"source_down_{i}"] = {"w": _np(sd[f"source_downs.{i}.weight"]), "b": _np(sd[f"source_downs.{i}.bias"]),
                                 "stride": u, "pad": 0 if u == 1 else u // 2}
        p[f"source_res_{i}"] = _resblock_params(sd, f"source_resblocks.{i}", cfg.source_resblock_kernel_sizes[i],
                                                cfg.source_resblock_dilations[i])
    nk = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        for j in range(nk):
            p[f"res_{i}_{j}"] = _resblock_params(sd, f"resblocks.{i * nk + j}", cfg.resblock_kernel_sizes[j],
                                                 cfg.resblock_dilations[j])
    p["conv_post_w"] = _fold_wn(sd, "conv_post")
    p["conv_post_b"] = _np(sd["conv_post.bias"])
    return p
