"""MusicFM 25 Hz: a residual conv2d frontend and a 12-layer Conformer.

Counterpart of ``slam_llm_tpu/models/musicfm.py``, with the same presets
and numerics. The input is the 128-band dB mel of 24 kHz audio at hop 240
(``ops.audio.music_log_mel``, computed by the MIR dataset on the host):

* two residual conv2d blocks (3 x 3, stride (2, 2), their BatchNorms frozen)
  over the (frequency, time) image take 1001 frames x 128 bands to 251 x 32
  at 512 channels; ``proj`` maps the 512 x 32 features of a frame to 1024;
* 12 Wav2Vec2-Conformer layers: a half-step FFN, rotary self-attention, the
  convolution module, a second half-step FFN and a final LayerNorm. HF's
  conformer rotates the attention LayerNorm's output per pseudo-head BEFORE
  the q / k projections and leaves v's input unrotated, so the rotation is
  done here and the attention is K1 without its fused RoPE (on a CUDA tensor,
  with the frame mask as its key mask). The convolution module zeroes the
  padded frames before its pointwise conv, GLU and the depthwise conv of
  kernel 31, then BatchNorm, swish and the second pointwise conv;
* the output mask is the mel mask at every fourth frame.

Under tensor parallelism (``parallel.tensor_parallel.split_conformer``) a
layer runs ``n_heads / tp`` heads a rank (q / k / v and both FFNs' first
dense column-parallel, out_proj and their second row-parallel; the
rotation before q / k stays on the whole LayerNorm output), and the
convolution module runs ``d_model / tp`` channels: ``pointwise_conv1`` holds
the rank's window of each GLU half, the depthwise conv and ``conv_bn`` the
rank's channels, ``pointwise_conv2`` is row-parallel.

BatchNorms run from their running statistics: MusicFM is a frozen encoder
in every SLAM recipe. The JAX package has no converter for MusicFM's
checkpoint, so the encoder runs from its seeded init in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from slam_llm_tpu_torch.models.layers import DenseGeneralLora, FrozenBatchNorm, LayerNorm, mha_attention, rope_tables
from slam_llm_tpu_torch.ops.kernels.flash_attention import apply_rope_tables


@dataclass(frozen=True)
class MusicFMConfig:
    n_mels: int = 128
    conv_dim: int = 512
    d_model: int = 1024
    n_heads: int = 16
    n_layers: int = 12
    ffn_dim: int = 4096
    depthwise_kernel: int = 31
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def musicfm_msd() -> "MusicFMConfig":
        return MusicFMConfig()

    @staticmethod
    def tiny_test() -> "MusicFMConfig":
        return MusicFMConfig(n_mels=16, conv_dim=8, d_model=32, n_heads=2, n_layers=2, ffn_dim=64, depthwise_kernel=7)


MUSICFM_PRESETS = {
    "musicfm-msd": MusicFMConfig.musicfm_msd,
    "musicfm-fma": MusicFMConfig.musicfm_msd,
    "musicfm-tiny-test": MusicFMConfig.tiny_test,
}


def _conv2d(conv: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype), conv.stride, conv.padding)


class Res2dModule(nn.Module):
    """Residual conv2d block over (B, C, F, T): conv (stride) -> BN -> ReLU
    -> conv -> BN, plus a strided conv + BN shortcut, then ReLU."""

    def __init__(self, c_in: int, c_out: int, stride: int, dtype, device=None):
        super().__init__()
        self.dtype = dtype

        def conv(fan_in, s):
            return nn.Conv2d(fan_in, c_out, 3, stride=s, padding=1, dtype=dtype, device=device).requires_grad_(False)

        self.conv1, self.bn1 = conv(c_in, stride), FrozenBatchNorm(c_out, device=device)
        self.conv2, self.bn2 = conv(c_out, 1), FrozenBatchNorm(c_out, device=device)
        self.shortcut = c_in != c_out or stride > 1
        if self.shortcut:
            self.conv3, self.bn3 = conv(c_in, stride), FrozenBatchNorm(c_out, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        out = F.relu(self.bn1(_conv2d(self.conv1, x, dt), axis=1).to(dt))
        out = self.bn2(_conv2d(self.conv2, out, dt), axis=1).to(dt)
        res = self.bn3(_conv2d(self.conv3, x, dt), axis=1).to(dt) if self.shortcut else x
        return F.relu(res + out)


class ConformerLayer(nn.Module):
    def __init__(self, cfg: MusicFMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, f, dt = cfg.d_model, cfg.ffn_dim, cfg.dtype
        for name in ("ffn1_ln", "attn_ln", "conv_ln", "ffn2_ln", "final_ln"):
            setattr(self, name, LayerNorm(d, 1e-5, dt, device))
        for prefix in ("ffn1", "ffn2"):
            setattr(self, f"{prefix}_in", DenseGeneralLora(d, f, use_bias=True, dtype=dt, device=device))
            setattr(self, f"{prefix}_out", DenseGeneralLora(f, d, use_bias=True, dtype=dt, device=device))
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, DenseGeneralLora(d, d, use_bias=True, dtype=dt, device=device))
        self.pointwise_conv1 = DenseGeneralLora(d, 2 * d, dtype=dt, device=device)
        self.depthwise_conv = nn.Conv1d(d, d, cfg.depthwise_kernel, padding=(cfg.depthwise_kernel - 1) // 2,
                                        groups=d, bias=False, dtype=dt, device=device).requires_grad_(False)
        self.conv_bn = FrozenBatchNorm(d, device=device)
        self.pointwise_conv2 = DenseGeneralLora(d, d, dtype=dt, device=device)
        self.n_heads = cfg.n_heads  # this rank's heads (n_heads / tp once split)

    def _ffn(self, h: torch.Tensor, prefix: str) -> torch.Tensor:
        return getattr(self, f"{prefix}_out")(F.silu(getattr(self, f"{prefix}_in")(h)))

    def forward(self, x: torch.Tensor, kv_mask: Optional[torch.Tensor], rope) -> torch.Tensor:
        c = self.cfg
        b, t, _ = x.shape
        nh, hd = self.n_heads, c.d_model // c.n_heads
        x = x + 0.5 * self._ffn(self.ffn1_ln(x), "ffn1")

        h = self.attn_ln(x)
        h_rot = apply_rope_tables(h.reshape(b, t, c.n_heads, hd), *rope).reshape(b, t, c.d_model)
        q = self.q_proj(h_rot).reshape(b, t, nh, hd)
        k = self.k_proj(h_rot).reshape(b, t, nh, hd)
        v = self.v_proj(h).reshape(b, t, nh, hd)  # v: unrotated, as HF's conformer
        x = x + self.out_proj(mha_attention(q, k, v, kv_mask=kv_mask).reshape(b, t, nh * hd))

        h = self.conv_ln(x)
        if kv_mask is not None:  # padded frames are zeroed before the kernel-31 conv mixes them in
            h = h * kv_mask[..., None].to(h.dtype)
        h = F.glu(self.pointwise_conv1(h), dim=-1)
        w = self.depthwise_conv.weight.to(c.dtype)  # (channels, 1, k): this rank's channels under tp
        h = F.conv1d(h.transpose(1, 2), w, None, padding=self.depthwise_conv.padding, groups=w.shape[0])
        h = F.silu(self.conv_bn(h.transpose(1, 2)).to(c.dtype))
        x = x + self.pointwise_conv2(h)

        x = x + 0.5 * self._ffn(self.ffn2_ln(x), "ffn2")
        return self.final_ln(x)


class MusicFMEncoder(nn.Module):
    """(B, T_mel, n_mels) dB mel + (B, T_mel) mask -> (B, T_mel / 4,
    d_model) + the (B, T_mel / 4) mask."""

    def __init__(self, cfg: MusicFMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.res1 = Res2dModule(1, cfg.conv_dim, 2, cfg.dtype, device)
        self.res2 = Res2dModule(cfg.conv_dim, cfg.conv_dim, 2, cfg.dtype, device)
        bands = (cfg.n_mels + 3) // 4  # two stride-2 convs of kernel 3, padding 1: ceil(ceil(F / 2) / 2)
        self.proj = DenseGeneralLora(cfg.conv_dim * bands, cfg.d_model, use_bias=True, dtype=cfg.dtype, device=device)
        self.layers = nn.ModuleList(ConformerLayer(cfg, device) for _ in range(cfg.n_layers))

    def forward(self, mel: torch.Tensor, mel_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        c = self.cfg
        b = mel.shape[0]
        x = mel.transpose(1, 2)[:, None].to(c.dtype)  # (B, 1, F, T)
        x = self.res2(self.res1(x))  # (B, C, F/4, T/4)
        tq = x.shape[3]
        x = self.proj(x.permute(0, 3, 1, 2).reshape(b, tq, -1))  # frame features ordered (channel, band)
        if mel_mask is None:
            out_mask, kv_mask = torch.ones(b, tq, dtype=torch.int32, device=x.device), None
        else:
            out_mask = kv_mask = mel_mask[:, ::4][:, :tq].to(torch.int32)
        positions = torch.arange(tq, device=x.device)[None].expand(b, tq)
        rope = rope_tables(positions, c.d_model // c.n_heads, c.rope_theta)
        for layer in self.layers:
            x = layer(x, kv_mask, rope)
        return x, out_mask
