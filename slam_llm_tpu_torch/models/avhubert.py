"""AV-HuBERT audio-visual encoder (the VSR / AVSR recipes).

Counterpart of ``slam_llm_tpu/models/avhubert.py``, with the same presets,
parameter names and numerics:

* video (B, T, H, W) -> a Conv3d stem (5, 7, 7) at stride (1, 2, 2), PReLU,
  a (1, 3, 3) max-pool at stride (1, 2, 2) padded with -inf, time folded
  into the batch, a ResNet-18 trunk of ``BasicBlock2d`` (conv, PReLU, conv,
  a 1 x 1 shortcut where the shape changes, PReLU; BatchNorm folded into
  every conv at conversion), the spatial mean -> (B, T, resnet_dim);
* audio: 26-band ``logfbank_psf`` stacked 4 frames (``stacked_logfbank``,
  25 Hz, the video rate) -> ``audio_proj``;
* the two projections concatenated audio first, a missing modality as
  zeros (the zero half still goes through ``fuse_ln``, which normalizes
  over 2 x d_model), ``post_proj``, the frame mask multiplied in, the
  wav2vec2 positional conv, then pre-LN transformer layers (the WavLM
  encoder's ``WavLMLayer`` without the rel-pos bias) and ``encoder_ln``.

The attention takes the frame mask as a structural key mask, never a dense
bias, so on a CUDA tensor every layer runs the flash kernels (K1 forward,
K4 backward). The convolutions are cuDNN's, in the compute dtype, as they
are XLA convolutions in the JAX package.

``convert_avhubert_fairseq`` maps a fairseq AV-HuBERT checkpoint onto this
module's ``state_dict`` names: the video frontend's BatchNorms folded into
their convs (eps 1e-5; a bias-free conv gets one) and the positional
conv's weight norm folded, both in f32 numpy as the JAX converter does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from slam_llm_tpu_torch.models.layers import DenseGeneralLora, LayerNorm
from slam_llm_tpu_torch.models.wavlm import PositionalConvEmbedding, WavLMConfig, WavLMLayer


@dataclass(frozen=True)
class AVHubertConfig:
    d_model: int = 1024
    n_heads: int = 16
    n_layers: int = 24
    ffn_dim: int = 4096
    resnet_dim: int = 512
    frontend_dim: int = 64
    audio_feat_dim: int = 104  # 26 logfbank x a 4-frame stack
    conv_pos: int = 128
    conv_pos_groups: int = 16
    # fairseq's layer_norm_first: the released LARGE checkpoints are pre-LN;
    # a post-LN base checkpoint needs False, or the features are wrong with no error
    layer_norm_first: bool = True
    dtype: torch.dtype = torch.bfloat16

    def layer_cfg(self) -> WavLMConfig:
        return WavLMConfig(d_model=self.d_model, n_heads=self.n_heads, n_layers=self.n_layers, ffn_dim=self.ffn_dim,
                           rel_bias=False, do_stable_layer_norm=self.layer_norm_first, conv_pos=self.conv_pos,
                           conv_pos_groups=self.conv_pos_groups, dtype=self.dtype)

    @staticmethod
    def large() -> "AVHubertConfig":
        return AVHubertConfig()

    @staticmethod
    def base() -> "AVHubertConfig":
        return AVHubertConfig(d_model=768, n_heads=12, n_layers=12, ffn_dim=3072)

    @staticmethod
    def tiny_test() -> "AVHubertConfig":
        return AVHubertConfig(d_model=32, n_heads=2, n_layers=2, ffn_dim=64, resnet_dim=16, frontend_dim=2,
                              audio_feat_dim=16, conv_pos=16, conv_pos_groups=2)


AVHUBERT_PRESETS = {
    "avhubert-large": AVHubertConfig.large,
    "avhubert-base": AVHubertConfig.base,
    "avhubert-tiny-test": AVHubertConfig.tiny_test,
}


def _prelu(x: torch.Tensor, alpha: nn.Parameter) -> torch.Tensor:
    """max(x, 0) + alpha * min(x, 0), alpha per channel (axis 1), in x's dtype."""
    a = alpha.to(x.dtype).reshape(1, -1, *([1] * (x.dim() - 2)))
    return torch.clamp_min(x, 0) + a * torch.clamp_max(x, 0)


def _frozen_conv(cls, c_in: int, c_out: int, k, stride, padding, dtype, device) -> nn.Module:
    return cls(c_in, c_out, k, stride=stride, padding=padding, dtype=dtype, device=device).requires_grad_(False)


def _prelu_param(n: int, device) -> nn.Parameter:
    return nn.Parameter(torch.full((n,), 0.25, device=device), requires_grad=False)


class BasicBlock2d(nn.Module):
    """conv -> PReLU -> conv, plus the input (through a 1 x 1 conv where
    the stride or width changes), then PReLU; over (N, C, H, W)."""

    def __init__(self, c_in: int, c_out: int, stride: int, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.c1 = _frozen_conv(nn.Conv2d, c_in, c_out, 3, stride, 1, dtype, device)
        self.c2 = _frozen_conv(nn.Conv2d, c_out, c_out, 3, 1, 1, dtype, device)
        self.cd = (_frozen_conv(nn.Conv2d, c_in, c_out, 1, stride, 0, dtype, device)
                   if stride != 1 or c_in != c_out else None)
        self.prelu1 = _prelu_param(c_out, device)
        self.prelu2 = _prelu_param(c_out, device)

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), conv.stride, conv.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self._conv(self.c2, _prelu(self._conv(self.c1, x), self.prelu1))
        res = self._conv(self.cd, x) if self.cd is not None else x
        return _prelu(res + out, self.prelu2)


class VideoFrontend(nn.Module):
    """(B, T, H, W) grey frames -> (B, T, resnet_dim) per-frame features."""

    def __init__(self, cfg: AVHubertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        fd, dt = cfg.frontend_dim, cfg.dtype
        self.stem = _frozen_conv(nn.Conv3d, 1, fd, (5, 7, 7), (1, 2, 2), (2, 3, 3), dt, device)
        self.stem_prelu = _prelu_param(fd, device)
        dims = [fd, fd * 2, fd * 4, cfg.resnet_dim]
        c_in = fd
        for stage, dim in enumerate(dims):
            stride = 1 if stage == 0 else 2
            setattr(self, f"layer{stage}_0", BasicBlock2d(c_in, dim, stride, dt, device))
            setattr(self, f"layer{stage}_1", BasicBlock2d(dim, dim, 1, dt, device))
            c_in = dim

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b, t = video.shape[:2]
        x = video.to(c.dtype)[:, None]  # (B, 1, T, H, W)
        x = F.conv3d(x, self.stem.weight.to(c.dtype), self.stem.bias.to(c.dtype), self.stem.stride,
                     self.stem.padding)
        x = F.max_pool3d(_prelu(x, self.stem_prelu), (1, 3, 3), (1, 2, 2), (0, 1, 1))  # padded with -inf
        x = x.transpose(1, 2).reshape(b * t, c.frontend_dim, x.shape[3], x.shape[4])  # time into the batch
        for stage in range(4):
            x = getattr(self, f"layer{stage}_1")(getattr(self, f"layer{stage}_0")(x))
        return x.mean(dim=(2, 3)).reshape(b, t, c.resnet_dim)


class AVHubertEncoder(nn.Module):
    """video (B, T, H, W) and / or audio features (B, T, F), the (B, T)
    frame mask -> (B, T, d_model) and the mask."""

    def __init__(self, cfg: AVHubertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.d_model, cfg.dtype
        self.video_frontend = VideoFrontend(cfg, device)
        self.audio_proj = DenseGeneralLora(cfg.audio_feat_dim, d, use_bias=True, dtype=dt, device=device)
        self.video_proj = DenseGeneralLora(cfg.resnet_dim, d, use_bias=True, dtype=dt, device=device)
        self.fuse_ln = LayerNorm(2 * d, dtype=dt, device=device)
        self.post_proj = DenseGeneralLora(2 * d, d, use_bias=True, dtype=dt, device=device)
        lc = cfg.layer_cfg()
        self.pos_conv = PositionalConvEmbedding(lc, device)
        self.layers = nn.ModuleList(WavLMLayer(lc, device) for _ in range(cfg.n_layers))
        self.encoder_ln = LayerNorm(d, dtype=dt, device=device)

    def forward(self, video: Optional[torch.Tensor] = None, audio_feats: Optional[torch.Tensor] = None,
                frame_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        c = self.cfg
        if video is None and audio_feats is None:
            raise ValueError("AVHubertEncoder needs video, audio features or both")
        src = video if video is not None else audio_feats
        b, t = src.shape[:2]
        zeros = torch.zeros(b, t, c.d_model, dtype=c.dtype, device=src.device)
        # a missing modality contributes zeros (the reference's concat fuse)
        fa = self.audio_proj(audio_feats.to(c.dtype)) if audio_feats is not None else zeros
        fv = self.video_proj(self.video_frontend(video)) if video is not None else zeros
        x = self.post_proj(self.fuse_ln(torch.cat([fa, fv], dim=-1)))  # audio first
        if frame_mask is None:
            frame_mask = torch.ones(b, t, dtype=torch.int32, device=src.device)
        x = x * frame_mask[..., None].to(x.dtype)
        x = x + self.pos_conv(x)
        for layer in self.layers:
            x = layer(x, None, None, frame_mask)  # the structural key mask: K1 / K4 on the card
        return self.encoder_ln(x), frame_mask


def stacked_logfbank(audio: np.ndarray, stack: int = 4, n_mels: int = 26, normalize: bool = True) -> np.ndarray:
    """AV-HuBERT's audio features: ``logfbank_psf`` (26 bands) of the
    int16-scale samples, zero-padded to a multiple of ``stack`` frames,
    stacked to 25 Hz, then a per-frame layer norm over the stacked 104
    features (eps 1e-5)."""
    from slam_llm_tpu_torch.ops.fbank import logfbank_psf

    mel = logfbank_psf(np.asarray(audio) * 32768.0, nfilt=n_mels)
    if mel.shape[0] % stack:
        mel = np.pad(mel, ((0, stack - mel.shape[0] % stack), (0, 0)))
    feats = mel.reshape(-1, stack * n_mels).astype(np.float32)
    if normalize:
        mu = feats.mean(axis=-1, keepdims=True)
        var = feats.var(axis=-1, keepdims=True)
        feats = (feats - mu) / np.sqrt(var + 1e-5)
    return feats


# ---------------------------------------------------------------------------
# fairseq checkpoint conversion
# ---------------------------------------------------------------------------


def _fold_bn(w: np.ndarray, bn: Dict[str, np.ndarray], eps: float = 1e-5) -> Tuple[np.ndarray, np.ndarray]:
    """An inference BatchNorm folded into the bias-free conv before it (out
    channels first): the kernel scaled per out channel and a new bias."""
    s = bn["weight"] / np.sqrt(bn["running_var"] + eps)
    return w * s.reshape((-1,) + (1,) * (w.ndim - 1)), (np.zeros_like(bn["running_mean"]) - bn["running_mean"]) * s \
        + bn["bias"]


def convert_avhubert_fairseq(sd: Dict, cfg: AVHubertConfig) -> Dict[str, torch.Tensor]:
    """A fairseq AV-HuBERT checkpoint (``{"model": sd}`` or the state dict)
    -> ``AVHubertEncoder`` ``state_dict`` names; the pretraining heads are
    not read."""
    if "model" in sd and hasattr(sd["model"], "items"):
        sd = sd["model"]
    sd = {k: np.asarray(v.detach().cpu().float().numpy() if torch.is_tensor(v) else v, np.float32)
          for k, v in sd.items()}
    out: Dict[str, np.ndarray] = {}

    def bn(prefix):
        return {s: sd[f"{prefix}.{s}"] for s in ("weight", "bias", "running_mean", "running_var")}

    def conv(dst, w_key, bn_prefix):
        out[f"{dst}.weight"], out[f"{dst}.bias"] = _fold_bn(sd[w_key], bn(bn_prefix))

    res, vf = "feature_extractor_video.resnet", "video_frontend"
    conv(f"{vf}.stem", f"{res}.frontend3D.0.weight", f"{res}.frontend3D.1")
    out[f"{vf}.stem_prelu"] = sd[f"{res}.frontend3D.2.weight"]
    for stage in range(4):
        for j in range(2):
            src, dst = f"{res}.trunk.layer{stage + 1}.{j}", f"{vf}.layer{stage}_{j}"
            conv(f"{dst}.c1", f"{src}.conv1.weight", f"{src}.bn1")
            conv(f"{dst}.c2", f"{src}.conv2.weight", f"{src}.bn2")
            out[f"{dst}.prelu1"] = sd[f"{src}.relu1.weight"]
            out[f"{dst}.prelu2"] = sd[f"{src}.relu2.weight"]
            if f"{src}.downsample.0.weight" in sd:
                conv(f"{dst}.cd", f"{src}.downsample.0.weight", f"{src}.downsample.1")

    def take(dst, src):
        out[f"{dst}.weight"], out[f"{dst}.bias"] = sd[f"{src}.weight"], sd[f"{src}.bias"]

    def norm(dst, src):
        out[f"{dst}.scale"], out[f"{dst}.bias"] = sd[f"{src}.weight"], sd[f"{src}.bias"]

    take("audio_proj", "feature_extractor_audio.proj")
    take("video_proj", "feature_extractor_video.proj")
    norm("fuse_ln", "layer_norm")
    take("post_proj", "post_extract_proj")
    base = "encoder.pos_conv.0."
    if base + "weight" in sd:
        w = sd[base + "weight"]
    else:  # weight norm over every axis but the kernel's (dim=2)
        g, v = sd[base + "weight_g"], sd[base + "weight_v"]
        w = g * v / np.maximum(np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True)), 1e-12)
    out["pos_conv.conv.weight"], out["pos_conv.conv.bias"] = w, sd[base + "bias"]
    for i in range(cfg.n_layers):
        src, dst = f"encoder.layers.{i}.", f"layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            take(f"{dst}attention.{name}", f"{src}self_attn.{name}")
        norm(f"{dst}layer_norm", f"{src}self_attn_layer_norm")
        norm(f"{dst}final_layer_norm", f"{src}final_layer_norm")
        take(f"{dst}fc1", f"{src}fc1")
        take(f"{dst}fc2", f"{src}fc2")
    norm("encoder_ln", "encoder.layer_norm")
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in out.items()}
