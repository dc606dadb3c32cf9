"""Flash-attention forward: the CUDA kernel K1 and its plain twin.

Counterpart of the forward half of
``slam_llm_tpu/ops/kernels/flash_attention.py`` (``flash_attention`` /
``_flash_fwd``). Inputs keep the model's layout: q (B, Tq, H, D), k/v
(B, Tk, Hkv, D), ``H % Hkv == 0`` (query head h reads kv head h // (H/Hkv)),
kv_mask (B, Tk) with 1 on valid keys. ``causal`` is start-aligned and so
only defined for Tq == Tk. Returns ``out`` like q and ``lse`` (B, Tq, H) f32
in the log2 domain (log2-sum-exp2 of the scaled scores). Query rows that see
no valid key output exactly 0; their lse carries no meaning.

``flash_attention_fwd`` sends CPU tensors to ``flash_attention_ref`` and CUDA
tensors to ``csrc/flash_attention.cu`` (bf16, D in {64, 128}, last dim
contiguous); it raises on anything else. The backward and the fused-RoPE
variant serve training and are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1.0e30  # masked-score sentinel, as in the TPU kernel
LOG2E = 1.4426950408889634


def _check_shapes(q, k, v, kv_mask, causal):
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if causal and tq != tk:
        raise ValueError(f"causal flash attention requires tq == tk, got {tq} vs {tk}")
    if h % hkv != 0:
        raise ValueError(f"H={h} not a multiple of Hkv={hkv}")
    if k.shape != (b, tk, hkv, d) or v.shape != k.shape or kv_mask.shape != (b, tk):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} "
            f"kv_mask {tuple(kv_mask.shape)}"
        )


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_mask: torch.Tensor,
    causal: bool = False, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the kernel, in f32: ``(out, lse)``."""
    _check_shapes(q, k, v, kv_mask, causal)
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qg = q.float().reshape(b, tq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (scale * LOG2E)
    valid = kv_mask.bool()[:, None, None, None, :]
    if causal:
        tri = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril()
        valid = valid & tri
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    live = (m > 0.5 * NEG_INF).float()
    o = torch.einsum("bhgqk,bkhd->bqhgd", p / l * live, v.float())
    lse = (m + torch.log2(l))[..., 0]  # (B, Hkv, G, Tq)
    return (
        o.reshape(b, tq, h, d).to(q.dtype),
        lse.permute(0, 3, 1, 2).reshape(b, tq, h),
    )


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_mask: torch.Tensor,
    causal: bool = False, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)``: the kernel on CUDA tensors, the twin on CPU tensors."""
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, kv_mask, causal, scale)
    _check_shapes(q, k, v, kv_mask, causal)
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash kernel takes bfloat16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in (64, 128):
        raise ValueError(f"flash kernel takes head_dim 64 or 128, got {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        # 16-byte K/V row loads and 4-byte Q fragment loads
        if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:-1]) or x.data_ptr() % 16:
            raise ValueError(f"flash kernel needs {name} with a contiguous, 16-byte aligned last dim")
    mask = kv_mask.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, tq, h), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    from slam_llm_tpu_torch.kernels.build import check, library, stream_ptr

    scale = 1.0 / math.sqrt(d) if scale is None else scale
    with torch.cuda.device(q.device):
        err = library().slam_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, tq, tk, h, hkv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), int(causal), stream_ptr(q),
        )
    check(err, "flash_attention")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0

