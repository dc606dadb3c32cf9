"""Spatial-AST (BAT): the binaural spectrogram transformer of the SELD recipe.

Counterpart of ``slam_llm_tpu/models/spatial_ast.py``, with the same
presets and numerics:

  stereo wav (B, 2, T) at 32 kHz
  -> centred STFT (n_fft 1024, hop 320, periodic hann, reflect pad) per
     channel, f32                                                    [host]
  -> per-channel log-mel (slaney mel 50-14000 Hz, 10 log10), and the IPD
     (phase R - phase L) as cos / sin through the same filterbank    [host]
  -> (B, 4, frames, 128), 1001 frames for a 10 s clip
  -> BatchNorm of the two log-mel channels from running statistics, the
     bicubic resize to 1024 frames (align_corners, ``ops.resize``), conv3x3
     4 -> 1 (its BatchNorm folded in) + exact GELU
  -> a 16 x 16 patch conv (64 x 8 = 512 patches, time-major), the fixed
     sin-cos table (a parameter: BAT's checkpoint carries its own), 3 CLS
     tokens in front: 515 tokens
  -> 12 pre-LN ViT blocks (``models.vit.ViTBlock``) in the config's dtype,
     f32 for the recipe, so on a CUDA tensor the attention runs K1's f32
     route (``csrc/flash_attention_f32.cu``) and, with the encoder trained
     (``freeze_encoder: false``), its gradient K4's
     (``csrc/flash_attention_bwd_f32.cu``); no final norm.

Every tensor is built frozen (``requires_grad=False``);
``train.optimizer.partition_params`` marks them all trainable when the
encoder trains, the BatchNorm statistics too, as the JAX package's
trainable tree holds every encoder leaf.

The host features are numpy (``binaural_features``). ``convert_spatialast_torch``
maps a BAT ``finetuned.pth``-style state dict (timm ViT names, the fused qkv,
conv_downsample's BatchNorm) onto this module's ``state_dict`` names.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from slam_llm_tpu_torch.models.vit import ViTBlock, ViTEncoderConfig, sincos_2d_positions
from slam_llm_tpu_torch.ops.audio import _rfft_f32
from slam_llm_tpu_torch.ops.resize import resize_bicubic_align_corners

SR = 32000
N_FFT = 1024
HOP = 320
N_MELS = 128
TARGET_FRAMES = 1024


# ---------------------------------------------------------------------------
# host frontend (numpy)
# ---------------------------------------------------------------------------


def _hann(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)).astype(np.float32)


def stft_centered(x: np.ndarray, n_fft: int = N_FFT, hop: int = HOP) -> np.ndarray:
    """(..., T) -> complex (..., frames, n_fft // 2 + 1): centred, reflect
    pad, periodic hann (torch.stft's semantics), f32 throughout."""
    x = np.asarray(x, np.float32)
    pad = n_fft // 2
    x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    frames = np.lib.stride_tricks.sliding_window_view(x, n_fft, axis=-1)[..., ::hop, :]
    frames = np.ascontiguousarray(frames * _hann(n_fft))
    return _rfft_f32(frames)


def mel_filterbank_slaney(
    sr: int = SR, n_fft: int = N_FFT, n_mels: int = N_MELS, fmin: float = 50.0, fmax: float = 14000.0,
) -> np.ndarray:
    """librosa.filters.mel(htk=False, norm='slaney') -> (n_fft // 2 + 1, n_mels) f32."""
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0

    def to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, f / f_sp)

    def to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), m * f_sp)

    mel_f = to_hz(np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2))
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_freqs[None, :]
    weights = np.zeros((n_mels, n_fft // 2 + 1))
    for i in range(n_mels):
        weights[i] = np.maximum(0, np.minimum(-ramps[i] / fdiff[i], ramps[i + 2] / fdiff[i + 1]))
    weights *= (2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.T.astype(np.float32)


@functools.lru_cache(maxsize=1)
def _melw() -> np.ndarray:
    return mel_filterbank_slaney()


def binaural_features(waveforms: np.ndarray) -> np.ndarray:
    """(B, 2, T) stereo at 32 kHz -> (B, 4, frames, 128) f32: [log-mel L,
    log-mel R, melW^T cos(IPD), melW^T sin(IPD)], IPD = phase R - phase L."""
    melw = _melw()
    b, c, t = waveforms.shape
    if c != 2:
        raise ValueError(f"binaural input required (B, 2, T), got {waveforms.shape}")
    spec = stft_centered(waveforms.reshape(b * c, t))  # (B * 2, frames, F)
    log_mel = 10.0 * np.log10(np.maximum(np.abs(spec) @ melw, 1e-10)).reshape(b, c, -1, N_MELS)
    phase = np.angle(spec).reshape(b, c, -1, spec.shape[-1])
    ipd = phase[:, 1] - phase[:, 0]
    ipd_feat = np.stack([np.cos(ipd) @ melw, np.sin(ipd) @ melw], axis=1)
    return np.concatenate([log_mel, ipd_feat], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SpatialASTConfig:
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    mlp_ratio: float = 4.0
    n_cls_tokens: int = 3
    patch_size: int = 16
    target_frames: int = TARGET_FRAMES
    n_mels: int = N_MELS
    bn_eps: float = 1e-5
    dtype: Any = torch.float32

    @staticmethod
    def base() -> "SpatialASTConfig":
        return SpatialASTConfig()

    @staticmethod
    def tiny_test() -> "SpatialASTConfig":
        return SpatialASTConfig(d_model=32, n_heads=2, n_layers=2, n_cls_tokens=3, patch_size=16,
                                target_frames=64, n_mels=32)

    def vit(self) -> ViTEncoderConfig:
        return ViTEncoderConfig(patch_size=self.patch_size, n_mels=self.n_mels, d_model=self.d_model,
                                n_heads=self.n_heads, n_layers=self.n_layers, mlp_ratio=self.mlp_ratio,
                                dtype=self.dtype)


SPATIAL_AST_PRESETS = {
    "spatialast-base": SpatialASTConfig.base,
    "spatialast-tiny-test": SpatialASTConfig.tiny_test,
}


class SpatialASTEncoder(nn.Module):
    """(B, 4, frames, n_mels) binaural feature map -> (B, cls + patches,
    d_model) and an all-ones (B, cls + patches) mask. Weights are built in
    f32; the frontend runs in f32 whatever they are stored in, the blocks in
    the config's dtype."""

    def __init__(self, cfg: SpatialASTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, p = cfg.d_model, cfg.patch_size
        # parameters, as in the reference, so a trainer re-stores them with the other frozen weights
        self.bn_mean = nn.Parameter(torch.zeros(2, device=device), requires_grad=False)
        self.bn_var = nn.Parameter(torch.ones(2, device=device), requires_grad=False)
        self.down = nn.Conv2d(4, 1, 3, padding=1, device=device).requires_grad_(False)
        self.patch_embed = nn.Conv2d(1, d, p, stride=p, device=device).requires_grad_(False)
        grid = (cfg.target_frames // p, cfg.n_mels // p)
        self.pos_embed = nn.Parameter(torch.from_numpy(sincos_2d_positions(*grid, d)).to(device), requires_grad=False)
        self.cls_tokens = nn.Parameter(torch.zeros(cfg.n_cls_tokens, d, device=device), requires_grad=False)
        self.blocks = nn.ModuleList(ViTBlock(cfg.vit(), device) for _ in range(cfg.n_layers))

    def forward(self, feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        c = self.cfg
        b = feats.shape[0]
        x = feats.float()
        inv = torch.rsqrt(self.bn_var.float() + c.bn_eps)
        mel = (x[:, :2] - self.bn_mean.float()[None, :, None, None]) * inv[None, :, None, None]
        x = torch.cat([mel, x[:, 2:]], dim=1)
        if x.shape[2] < c.target_frames:
            # every real 10 s clip (1001 frames) takes this path
            x = resize_bicubic_align_corners(x, c.target_frames, x.shape[3])
        else:
            x = x[:, :, : c.target_frames]
        x = F.gelu(F.conv2d(x, self.down.weight.float(), self.down.bias.float(), padding=1), approximate="none")
        x = F.conv2d(x, self.patch_embed.weight.float(), self.patch_embed.bias.float(), stride=c.patch_size)
        x = x.flatten(2).transpose(1, 2) + self.pos_embed.float()[None]  # (B, T/p * F/p, D), time-major
        x = torch.cat([self.cls_tokens.float().expand(b, -1, -1), x], dim=1).to(c.dtype)
        for block in self.blocks:
            x = block(x, None)
        return x, torch.ones(b, x.shape[1], dtype=torch.int32, device=x.device)


def convert_spatialast_torch(sd: Dict[str, Any], cfg: SpatialASTConfig = SpatialASTConfig()) -> Dict[str, torch.Tensor]:
    """A BAT / Spatial-AST checkpoint (timm ViT names) -> ``SpatialASTEncoder``
    ``state_dict`` names, f32: conv_downsample's BatchNorm folded into the
    conv, the fused qkv split into q / k / v, the legacy leading slot of
    ``pos_embed`` dropped (``pos_embed[0, 1:]``)."""
    sd = {k: torch.as_tensor(v).float() for k, v in sd.items() if hasattr(v, "shape")}
    d = cfg.d_model
    g, beta = sd["conv_downsample.1.weight"], sd["conv_downsample.1.bias"]
    mu, var = sd["conv_downsample.1.running_mean"], sd["conv_downsample.1.running_var"]
    s = g / torch.sqrt(var + cfg.bn_eps)
    out = {
        "bn_mean": sd["bn.running_mean"], "bn_var": sd["bn.running_var"],
        "down.weight": sd["conv_downsample.0.weight"] * s.reshape(-1, 1, 1, 1),  # (1, 4, 3, 3), no bias
        "down.bias": beta - mu * s,
        "patch_embed.weight": sd["patch_embed.proj.weight"], "patch_embed.bias": sd["patch_embed.proj.bias"],
        "pos_embed": sd["pos_embed"][0, 1:],
        "cls_tokens": sd["cls_tokens"].reshape(cfg.n_cls_tokens, d),
    }
    for i in range(cfg.n_layers):
        src = f"blocks.{i}."
        qkv_w, qkv_b = sd[src + "attn.qkv.weight"], sd[src + "attn.qkv.bias"]
        for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
            out[f"{src}{name}.weight"] = qkv_w[j * d:(j + 1) * d]
            out[f"{src}{name}.bias"] = qkv_b[j * d:(j + 1) * d]
        for port, ref in (("proj", "attn.proj"), ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            out[f"{src}{port}.weight"] = sd[f"{src}{ref}.weight"]
            out[f"{src}{port}.bias"] = sd[f"{src}{ref}.bias"]
        for norm in ("norm1", "norm2"):
            out[f"{src}{norm}.scale"] = sd[f"{src}{norm}.weight"]
            out[f"{src}{norm}.bias"] = sd[f"{src}{norm}.bias"]
    return out
