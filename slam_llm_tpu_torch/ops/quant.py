"""Int8 (W8A8) forward path for frozen decoder dense layers.

Counterpart of the forward half of ``slam_llm_tpu/ops/quant.py``. Weights are
symmetric per-output-channel int8, stored ``(F, K)`` (K-major, the layout the
K3 kernel reads); activations are quantized per row on the fly (K2); the
product runs s8 x s8 -> s32 and applies both scales in its epilogue (K3):

    y = (x_q @ w_q^T) * x_s * w_scale

``int8_matmul`` sends CPU tensors to ``int8_matmul_ref`` and CUDA tensors to
``csrc/int8_matmul.cu``; it raises on what the kernel does not take. The
reference's int8 backward modes serve training and are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

from slam_llm_tpu_torch.ops.kernels.rowquant import rowquant

_EPS = 1e-30


def quantize_int8(w: torch.Tensor, contract_axis: int = -2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8, reducing |amax| over ``contract_axis``:
    ``(q int8 like w, scale f32 with that axis removed)``."""
    w32 = w.float()
    amax = w32.abs().amax(dim=contract_axis)
    # a tensor divisor keeps the true division on CUDA (see rowquant_ref)
    scale = torch.clamp_min(amax, _EPS) / amax.new_full((), 127.0)
    q = torch.round(w32 / scale.unsqueeze(contract_axis)).clamp_(-127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(
    q: torch.Tensor, scale: torch.Tensor, contract_axis: int = -2, dtype=torch.float32
) -> torch.Tensor:
    return (q.float() * scale.unsqueeze(contract_axis)).to(dtype)


def act_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row dynamic int8 of an activation (K2 on CUDA)."""
    return rowquant(x)


def int8_matmul_ref(
    x_q: torch.Tensor, w_q: torch.Tensor, x_s: torch.Tensor, w_scale: torch.Tensor,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Plain twin of K3. The s32 sum is formed in float64, where every partial
    sum of int8 products is an exact integer (|acc| < 2**53)."""
    acc = (x_q.double() @ w_q.double().T).float()
    return (acc * x_s.reshape(-1, 1) * w_scale).to(out_dtype)


def int8_matmul(
    x_q: torch.Tensor, w_q: torch.Tensor, x_s: torch.Tensor, w_scale: torch.Tensor,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """x_q (M, K) int8, w_q (F, K) int8, x_s (M,) or (M, 1) f32, w_scale (F,)
    f32 -> (M, F) ``out_dtype``; the kernel writes bfloat16 only."""
    if not x_q.is_cuda:
        return int8_matmul_ref(x_q, w_q, x_s, w_scale, out_dtype)
    m, k = x_q.shape
    f = w_q.shape[0]
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8 or w_q.shape != (f, k):
        raise TypeError(f"int8_matmul takes int8 (M, K) x (F, K), got {x_q.dtype}{tuple(x_q.shape)} "
                        f"x {w_q.dtype}{tuple(w_q.shape)}")
    if x_s.dtype != torch.float32 or w_scale.dtype != torch.float32 or x_s.numel() != m \
            or w_scale.shape != (f,):
        raise TypeError("int8_matmul takes f32 scales x_s (M,) and w_scale (F,)")
    if out_dtype != torch.bfloat16:
        raise TypeError(f"int8_matmul kernel writes bfloat16, got {out_dtype}")
    if k % 16 or not all(t.is_contiguous() for t in (x_q, w_q, x_s, w_scale)) \
            or x_q.data_ptr() % 16 or w_q.data_ptr() % 16:
        raise ValueError("int8_matmul kernel needs contiguous, 16-byte aligned operands and K % 16 == 0")
    out = torch.empty((m, f), dtype=out_dtype, device=x_q.device)
    if out.numel() == 0:
        return out
    from slam_llm_tpu_torch.kernels.build import check, library, stream_ptr

    with torch.cuda.device(x_q.device):
        err = library().slam_int8_matmul(
            x_q.data_ptr(), w_q.data_ptr(), x_s.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
            m, f, k, stream_ptr(x_q),
        )
    check(err, "int8_matmul")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def int8_linear(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """Forward of the reference's ``int8_dot``: ``x (..., K) @ dequant(w_q)^T``
    computed s8 x s8, returned in x's dtype."""
    k = x.shape[-1]
    x_q, x_s = act_quant(x)
    y = int8_matmul(x_q.reshape(-1, k), w_q, x_s.reshape(-1), w_scale, x.dtype)
    return y.reshape(*x.shape[:-1], w_q.shape[0])
