"""Shared building blocks: dense + LoRA, norms, RoPE, attention.

Counterpart of ``slam_llm_tpu/models/layers.py``. Numerics follow the
reference: dense products run in the compute ``dtype``; norms reduce in f32;
attention scores and softmax are f32 over compute-dtype operands.

Parameter storage: weights whose reference counterpart is cast to the
compute dtype at every use (dense and conv kernels, biases, LoRA factors,
embeddings) are stored in the compute dtype, which gives the same values
without a cast per call; norm scales and biases, which the reference reads
in f32, are stored in f32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from slam_llm_tpu_torch.ops.kernels.flash_attention import flash_attention_fwd
from slam_llm_tpu_torch.ops.quant import int8_linear

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


class DenseGeneralLora(nn.Module):
    """``y = x W^T (+ b) + (x A^T * alpha/r) B^T``.

    ``quant="int8"`` stores the frozen base as ``kernel_q`` (F, K) int8 and
    ``kernel_scale`` (F,) f32 and runs it through ``int8_linear`` (K2 + K3
    on CUDA); otherwise ``weight`` (F, K) is a plain product. LoRA ``lora_a``
    (r, K) and ``lora_b`` (F, r) stay in the compute dtype, and the LoRA
    scale multiplies the rank-r intermediate, as in the reference.
    """

    def __init__(
        self, in_features: int, features: int, *, use_bias: bool = False,
        dtype: torch.dtype = torch.bfloat16, lora_rank: int = 0, lora_alpha: float = 32.0,
        quant: str = "none", device=None,
    ):
        super().__init__()
        if quant not in ("none", "int8"):
            raise ValueError(f"unknown quant {quant!r}")
        self.in_features, self.features = in_features, features
        self.dtype, self.quant = dtype, quant
        self.lora_rank, self.lora_alpha = lora_rank, lora_alpha
        # the reference multiplies by the scale rounded to the compute dtype
        self.lora_scale = float(torch.tensor(lora_alpha / max(lora_rank, 1), dtype=dtype))
        if quant == "int8":
            self.register_buffer(
                "kernel_q", torch.zeros(features, in_features, dtype=torch.int8, device=device)
            )
            self.register_buffer(
                "kernel_scale", torch.ones(features, dtype=torch.float32, device=device)
            )
        else:
            self.weight = nn.Parameter(
                torch.zeros(features, in_features, dtype=dtype, device=device), requires_grad=False
            )
        self.bias = (
            nn.Parameter(torch.zeros(features, dtype=dtype, device=device), requires_grad=False)
            if use_bias else None
        )
        if lora_rank > 0:
            self.lora_a = nn.Parameter(
                torch.zeros(lora_rank, in_features, dtype=dtype, device=device), requires_grad=False
            )
            self.lora_b = nn.Parameter(
                torch.zeros(features, lora_rank, dtype=dtype, device=device), requires_grad=False
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(self.dtype)
        if self.quant == "int8":
            y = int8_linear(h, self.kernel_q, self.kernel_scale)
        else:
            y = F.linear(h, self.weight)
        if self.bias is not None:
            y = y + self.bias
        if self.lora_rank > 0:
            y = y + F.linear(F.linear(h, self.lora_a) * self.lora_scale, self.lora_b)
        return y


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.ones(dim, device=device), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        norm = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + self.eps)
        return (norm * self.scale).to(self.dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.ones(dim, device=device), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(dim, device=device), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = (x32 - mean).square().mean(-1, keepdim=True)
        norm = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (norm * self.scale + self.bias).to(self.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (HF-llama rotate-half layout)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float = 10000.0):
    """(cos, sin), each (B, T, D/2) f32."""
    freqs = rope_frequencies(head_dim, theta, positions.device)
    angles = positions.float()[..., None] * freqs[None, None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope_tables(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, D); rotate in f32 and cast each half back to x's dtype."""
    half = x.shape[-1] // 2
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out1 = (x1 * cos - x2 * sin).to(x.dtype)
    out2 = (x2 * cos + x1 * sin).to(x.dtype)
    return torch.cat([out1, out2], dim=-1)


# ---------------------------------------------------------------------------
# Attention core
# ---------------------------------------------------------------------------


def mha_attention(
    q: torch.Tensor,  # (B, Tq, H, D)
    k: torch.Tensor,  # (B, Tk, Hkv, D)
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,  # (B, 1|H, Tq, Tk) additive f32
    kv_mask: Optional[torch.Tensor] = None,  # (B, Tk) structured key validity
    causal: bool = False,
) -> torch.Tensor:
    """Multi-head attention with GQA. A structured mask (no ``bias``) on a
    CUDA tensor runs the flash kernel K1; a dense bias, a CPU tensor, or
    causal with Tq != Tk (end-aligned, which only the plain path defines)
    runs the plain path."""
    use_kernel = bias is None and q.is_cuda and not (causal and q.shape[1] != k.shape[1])
    if use_kernel:
        mask = (
            kv_mask.to(torch.int32)
            if kv_mask is not None
            else torch.ones(k.shape[:2], dtype=torch.int32, device=k.device)
        )
        return flash_attention_fwd(q, k, v, mask, causal)[0]
    return _xla_attention(q, k, v, bias, kv_mask, causal)


def _xla_attention(q, k, v, bias, kv_mask=None, causal=False):
    """Plain attention: f32 scores over compute-dtype operands, f32 softmax,
    probabilities cast to v's dtype for the value product. Query rows whose
    every key is masked output 0 (the flash kernel's convention)."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.reshape(b, tq, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * (1.0 / math.sqrt(d))
    row_live = None
    if bias is None and (kv_mask is not None or causal):
        mask = (
            kv_mask.bool()[:, None, None, :]
            if kv_mask is not None
            else torch.ones(b, 1, 1, tk, dtype=torch.bool, device=q.device)
        )
        if causal:
            mask = mask & torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril(tk - tq)
        bias = torch.where(mask, 0.0, NEG_INF).float()
    if bias is not None:
        row_live = (bias > NEG_INF * 0.5).any(-1)  # (B, 1|H, Tq)
        bh = bias.shape[1]
        bias5 = bias.reshape(b, hkv, g, tq, tk) if bh == h else bias[:, :, None]
        logits = logits + bias5
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(), v.float()).reshape(b, tq, h, d)
    if row_live is not None:
        out = out * row_live.transpose(1, 2)[..., None].float()
    return out.to(v.dtype)


def make_padding_bias(attention_mask: torch.Tensor, q_len: int) -> torch.Tensor:
    """(B, Tk) key padding mask -> (B, 1, q_len, Tk) additive f32 bias."""
    mask = attention_mask.bool()[:, None, None, :].expand(-1, 1, q_len, -1)
    return torch.where(mask, 0.0, NEG_INF).float()


def sinusoidal_positions(length: int, channels: int, max_timescale: float = 10000.0, device=None):
    """Whisper-style fixed sinusoid table: (length, channels) f32."""
    log_inc = math.log(max_timescale) / (channels // 2 - 1)
    inv = torch.exp(-log_inc * torch.arange(channels // 2, dtype=torch.float32, device=device))
    scaled = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)

