"""Int8 (W8A8) path for frozen decoder dense layers, forward and backward.

Counterpart of ``slam_llm_tpu/ops/quant.py``. Weights are symmetric
per-output-channel int8, stored ``(F, K)`` (K-major, the layout the K3
kernel reads); activations are quantized per row on the fly (K2); the
product runs s8 x s8 -> s32 and applies both scales in its epilogue (K3):

    y = (x_q @ w_q^T) * x_s * w_scale

``int8_dot`` is the trainable form: an autograd Function whose gradient
flows to ``x`` only (straight-through; the base is frozen) and which saves
no activation. Its backward modes, per module through ``resolve_bwd``:

* ``"bf16"``: dx = dy @ dequant(w), a plain bf16 product (XLA in JAX too);
* ``"int8_rot"``: dy is rotated by the block-diagonal Hadamard and
  stochastically rounded to int8 (K2), then contracted with the write-once
  rotated weight ``quant(W R)`` (K3): dx = (dy R)(W R)^T, R orthonormal.

``int8_sr`` / ``int8`` (rowquant ``fold``) are not ported yet (ROADMAP
Queue 1); ``int8_rot_otf`` is not ported (ROADMAP "Do not port").
``int8_matmul`` sends CPU tensors to ``int8_matmul_ref`` and CUDA tensors to
``csrc/int8_matmul.cu``; it raises on what the kernel does not take.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from slam_llm_tpu_torch.ops.kernels.rowquant import rotate_cols, rowquant

_EPS = 1e-30

# decoder dense modules whose frozen kernels are eligible for int8
PROJ_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
# the MLP subset: a "_mlp"-suffixed mode quantizes dy only here
MLP_PROJ_NAMES = ("gate_proj", "up_proj", "down_proj")
PORTED_BWD = ("bf16", "int8_rot")
_TODO_BWD = {
    "int8_sr": "ROADMAP Queue 1: rowquant fold and the int8_sr / int8 backward modes",
    "int8": "ROADMAP Queue 1: rowquant fold and the int8_sr / int8 backward modes",
    "int8_rot_otf": "ROADMAP: do not port (80 GB holds the stored rotated pair)",
}


def resolve_bwd(mode: str, proj_name: str) -> str:
    """Per-module dx mode. A ``_mlp``-suffixed mode applies the quantized
    backward to the MLP denses only and keeps the attention dx in bf16."""
    if mode.endswith("_mlp"):
        return mode[:-4] if proj_name in MLP_PROJ_NAMES else "bf16"
    return mode


def check_bwd_mode(mode: str) -> None:
    """Raise on a ``base_quant_bwd`` the port does not run."""
    for name in PROJ_NAMES:
        bwd = resolve_bwd(mode, name)
        if bwd in _TODO_BWD:
            raise NotImplementedError(f"base_quant_bwd={mode!r} is not ported ({_TODO_BWD[bwd]})")
        if bwd not in PORTED_BWD:
            raise ValueError(f"unknown base_quant_bwd {mode!r}")


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


def rotate_quantize_bwd(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``int8_rot`` backward weight: ``(quant(w R), scale)`` for ``w``
    (..., K, F) in the reference's (in, out) layout, R the block-diagonal
    Hadamard along F (``rotate_cols``, the same transform K2 applies to dy).
    Quantized per K-row over the rotated F axis: q (..., K, F) int8 with F
    contiguous (the (N, Kc) layout K3 reads for the dx product), scale
    (..., K) f32."""
    wr = rotate_cols(w)
    amax = wr.abs().amax(dim=-1)
    scale = torch.clamp_min(amax, _EPS) / amax.new_full((), 127.0)
    q = torch.round(wr / scale[..., None]).clamp_(-127, 127)
    return q.to(torch.int8).contiguous(), scale


@torch.no_grad()
def quantize_base_params(model: nn.Module) -> nn.Module:
    """Derive every ``int8_rot`` dense's rotated pair (``kernel_qr``,
    ``kernel_scale_r``) from its forward pair (``kernel_q``, ``kernel_scale``)
    in place: from the DEQUANTIZED forward weight, so the backward
    approximates the matrix the forward used. The pair is always re-derived,
    never trusted (a converter or loader may carry a stale copy). The port
    keeps ``kernel_scale_r`` in f32."""
    for mod in model.modules():
        if getattr(mod, "kernel_qr", None) is None:
            continue
        w = dequantize_int8(mod.kernel_q, mod.kernel_scale, contract_axis=-1)  # (F, K)
        qr, sr = rotate_quantize_bwd(w.T)
        mod.kernel_qr.copy_(qr)
        mod.kernel_scale_r.copy_(sr)
    return model


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


class _Int8Dot(torch.autograd.Function):
    """``int8_linear`` with the straight-through gradient to ``x``. Saves
    the frozen weights the backward contracts (buffers, no copy) and never
    the activation or its int8 form."""

    @staticmethod
    def forward(ctx, x, w_q, w_scale, wr_q, wr_scale, bwd: str, seed: int):
        ctx.bwd, ctx.seed, ctx.x_dtype = bwd, seed, x.dtype
        if bwd == "int8_rot":
            ctx.save_for_backward(wr_q, wr_scale)
        else:
            ctx.save_for_backward(w_q, w_scale)
        return int8_linear(x, w_q, w_scale)

    @staticmethod
    def backward(ctx, dy):
        w, scale = ctx.saved_tensors
        f = dy.shape[-1]
        dy2 = dy.reshape(-1, f)
        if ctx.bwd == "int8_rot":
            z, s_dy = rowquant(dy2.contiguous(), seed=ctx.seed, rotate=True)
            dx = int8_matmul(z, w, s_dy.reshape(-1), scale, ctx.x_dtype)
        else:
            # the dequantized weight in bf16, contracted with f32 accumulation:
            # an f32 x keeps the f32 sum, a bf16 x rounds it once
            acc = torch.float32 if ctx.x_dtype == torch.float32 else torch.bfloat16
            wd = dequantize_int8(w, scale, contract_axis=-1, dtype=torch.bfloat16)
            dx = torch.matmul(dy2.to(torch.bfloat16).to(acc), wd.to(acc)).to(ctx.x_dtype)
        return dx.reshape(*dy.shape[:-1], dx.shape[-1]), None, None, None, None, None, None


def int8_dot(
    x: torch.Tensor,
    w_q: torch.Tensor,
    w_scale: torch.Tensor,
    *,
    bwd: str = "bf16",
    seed: Optional[int] = None,
    w_rot: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """``x @ dequant(w_q)^T`` computed s8 x s8, differentiable in ``x``.

    x (..., K); w_q int8 (F, K); w_scale f32 (F,). ``bwd="int8_rot"`` needs
    ``w_rot=(wr_q (K, F) int8, wr_scale (K,) f32)`` from
    ``rotate_quantize_bwd`` and a uint32 ``seed``, fresh per step."""
    if bwd not in PORTED_BWD:
        raise NotImplementedError(f"int8_dot bwd={bwd!r} is not ported ({_TODO_BWD.get(bwd, 'unknown mode')})")
    if bwd == "int8_rot" and w_rot is None:
        raise ValueError("int8_dot bwd='int8_rot' needs w_rot=(wr_q, wr_scale)")
    if not (torch.is_grad_enabled() and x.requires_grad):
        return int8_linear(x, w_q, w_scale)  # no backward to prepare for
    wr_q, wr_scale = w_rot if w_rot is not None else (None, None)
    return _Int8Dot.apply(x, w_q, w_scale, wr_q, wr_scale, bwd, 0 if seed is None else int(seed))
