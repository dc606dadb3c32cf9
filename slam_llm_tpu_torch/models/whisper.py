"""Whisper audio encoder.

Counterpart of ``slam_llm_tpu/models/whisper.py``: conv1d(k3, p1) + GELU,
conv1d(k3, s2, p1) + GELU, fixed sinusoidal positions sliced to the
post-conv length, pre-LN transformer blocks, final LayerNorm. Any even mel
length works. ``mask_padding`` masks padded mel frames in the attention (the
reference's default). Layers are a ``ModuleList`` walked in a loop where the
reference scans a stacked layer axis. Under tensor parallelism
(``parallel.tensor_parallel.split_whisper``) a block runs ``n_heads / tp``
heads a rank: its q / k / v and fc1 column-parallel, out_proj and fc2
row-parallel, as the reference's ``heads`` / ``mlp`` axes shard them.

Input (B, T_mel, n_mels) + optional (B, T_mel) mask -> (B, T_mel // 2, d_model)
+ the post-conv mask.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from slam_llm_tpu_torch.models.layers import (
    DenseGeneralLora,
    LayerNorm,
    mha_attention,
    sinusoidal_positions,
)


@dataclass(frozen=True)
class WhisperEncoderConfig:
    n_mels: int = 80
    d_model: int = 384
    n_heads: int = 6
    n_layers: int = 4
    max_source_positions: int = 1500  # 30 s of mel at 2x conv downsampling
    dtype: torch.dtype = torch.bfloat16
    mask_padding: bool = True

    @staticmethod
    def tiny() -> "WhisperEncoderConfig":
        return WhisperEncoderConfig(80, 384, 6, 4)

    @staticmethod
    def base() -> "WhisperEncoderConfig":
        return WhisperEncoderConfig(80, 512, 8, 6)

    @staticmethod
    def small() -> "WhisperEncoderConfig":
        return WhisperEncoderConfig(80, 768, 12, 12)

    @staticmethod
    def medium() -> "WhisperEncoderConfig":
        return WhisperEncoderConfig(80, 1024, 16, 24)

    @staticmethod
    def large_v2() -> "WhisperEncoderConfig":
        return WhisperEncoderConfig(80, 1280, 20, 32)

    @staticmethod
    def large_v3() -> "WhisperEncoderConfig":
        return WhisperEncoderConfig(128, 1280, 20, 32)

    @staticmethod
    def tiny_test() -> "WhisperEncoderConfig":
        return WhisperEncoderConfig(n_mels=8, d_model=32, n_heads=2, n_layers=2, max_source_positions=64)


PRESETS = {
    "whisper-tiny": WhisperEncoderConfig.tiny,
    "whisper-base": WhisperEncoderConfig.base,
    "whisper-small": WhisperEncoderConfig.small,
    "whisper-medium": WhisperEncoderConfig.medium,
    "whisper-large-v2": WhisperEncoderConfig.large_v2,
    "whisper-large-v3": WhisperEncoderConfig.large_v3,
    "whisper-tiny-test": WhisperEncoderConfig.tiny_test,
}


class WhisperAttention(nn.Module):
    def __init__(self, cfg: WhisperEncoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.n_heads = cfg.n_heads  # this rank's heads (n_heads / tp once split)

        def dense(use_bias):
            return DenseGeneralLora(d, d, use_bias=use_bias, dtype=cfg.dtype, device=device)

        # whisper: q/v/out have a bias, k does not
        self.q_proj, self.k_proj, self.v_proj = dense(True), dense(False), dense(True)
        self.out_proj = dense(True)

    def forward(self, x: torch.Tensor, kv_mask: Optional[torch.Tensor]) -> torch.Tensor:
        c = self.cfg
        b, t, _ = x.shape
        h, hd = self.n_heads, c.d_model // c.n_heads
        q = self.q_proj(x).reshape(b, t, h, hd)
        k = self.k_proj(x).reshape(b, t, h, hd)
        v = self.v_proj(x).reshape(b, t, h, hd)
        out = mha_attention(q, k, v, kv_mask=kv_mask)
        return self.out_proj(out.reshape(b, t, h * hd))


class WhisperBlock(nn.Module):
    def __init__(self, cfg: WhisperEncoderConfig, device=None):
        super().__init__()
        d, dt = cfg.d_model, cfg.dtype
        self.attn_ln = LayerNorm(d, dtype=dt, device=device)
        self.attn = WhisperAttention(cfg, device)
        self.mlp_ln = LayerNorm(d, dtype=dt, device=device)
        self.fc1 = DenseGeneralLora(d, 4 * d, use_bias=True, dtype=dt, device=device)
        self.fc2 = DenseGeneralLora(4 * d, d, use_bias=True, dtype=dt, device=device)

    def forward(self, x, kv_mask):
        x = x + self.attn(self.attn_ln(x), kv_mask)
        h = F.gelu(self.fc1(self.mlp_ln(x)), approximate="none")
        return x + self.fc2(h)


class WhisperEncoder(nn.Module):
    def __init__(self, cfg: WhisperEncoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.d_model, cfg.dtype
        # Conv1d weights (out, in, k), stored in the compute dtype
        self.conv1 = nn.Conv1d(cfg.n_mels, d, 3, padding=1, dtype=dt, device=device)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1, dtype=dt, device=device)
        self.conv1.requires_grad_(False)
        self.conv2.requires_grad_(False)
        self.layers = nn.ModuleList(WhisperBlock(cfg, device) for _ in range(cfg.n_layers))
        self.ln_post = LayerNorm(d, dtype=dt, device=device)

    def forward(
        self, mel: torch.Tensor, mel_mask: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        c = self.cfg
        b = mel.shape[0]
        x = mel.to(c.dtype).transpose(1, 2)  # (B, n_mels, T)
        x = F.gelu(_conv(self.conv1, x, c.dtype), approximate="none")
        x = F.gelu(_conv(self.conv2, x, c.dtype), approximate="none").transpose(1, 2)  # (B, T//2, D)
        t_out = x.shape[1]
        x = x + sinusoidal_positions(t_out, c.d_model, device=x.device).to(c.dtype)[None]

        if mel_mask is None:
            out_mask = torch.ones(b, t_out, dtype=torch.int32, device=x.device)
        else:
            # post-conv frame i is valid iff mel frame 2i is valid
            out_mask = mel_mask[:, ::2][:, :t_out].to(torch.int32)
        kv_mask = out_mask if c.mask_padding and mel_mask is not None else None
        for layer in self.layers:
            x = layer(x, kv_mask)
        return self.ln_post(x), out_mask


def _conv(conv: nn.Conv1d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``conv(x)`` with its weights cast to the compute dtype at use."""
    return F.conv1d(x, conv.weight.to(dtype), conv.bias.to(dtype), conv.stride, conv.padding)
