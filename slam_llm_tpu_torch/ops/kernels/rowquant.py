"""Per-row dynamic int8 quantization: the CUDA kernel K2 and its plain twin.

Counterpart of ``slam_llm_tpu/ops/kernels/rowquant.py``. ``rowquant`` sends
a CPU tensor to ``rowquant_ref`` and a CUDA tensor to the kernel in
``csrc/rowquant.cu`` (one warp per row, bit-exact against the reference's
``jnp.round(x / s)``); it raises on what the kernel does not take. The
reference's fold, stochastic-rounding and Hadamard-rotation variants serve
only the training backward and are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_EPS_AMAX = 1e-28  # amax floor: keeps s > 0 for all-zero rows


def rowquant_ref(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch rowquant: ``q = clip(round(x / s))``, ``s = amax/127``."""
    x32 = x.float()
    a = x32.abs().amax(dim=-1, keepdim=True)
    # divide by a tensor, not the Python scalar: on CUDA, PyTorch turns division
    # by a host scalar into a multiplication by its reciprocal, which rounds
    # differently from the true division the reference (and K2) performs
    s = torch.clamp_min(a, _EPS_AMAX) / a.new_full((), 127.0)
    q = torch.round(x32 / s).clamp_(-127, 127).to(torch.int8)
    return q, s


def rowquant(
    x: torch.Tensor,
    fold: Optional[torch.Tensor] = None,
    *,
    seed: Optional[int] = None,
    rotate: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last-axis) symmetric int8: ``(q int8 like x, s f32 x.shape[:-1] + (1,))``."""
    if fold is not None or seed is not None or rotate:
        raise NotImplementedError(
            "rowquant fold / stochastic rounding / rotate are training-only and not ported yet"
        )
    if not x.is_cuda:
        return rowquant_ref(x)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"rowquant kernel takes bfloat16, got {x.dtype}")
    k = x.shape[-1]
    if k % 8 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("rowquant kernel needs a contiguous, 16-byte aligned input with K % 8 == 0")
    from slam_llm_tpu_torch.kernels.build import check, library, stream_ptr

    m = x.numel() // k if k else 0
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=x.device)
    if m == 0 or k == 0:
        return q, s.fill_(_EPS_AMAX / 127.0)
    with torch.cuda.device(x.device):
        err = library().slam_rowquant(x.data_ptr(), q.data_ptr(), s.data_ptr(), m, k, stream_ptr(x))
    check(err, "rowquant")
    rowquant.launches += 1
    return q, s


rowquant.launches = 0
