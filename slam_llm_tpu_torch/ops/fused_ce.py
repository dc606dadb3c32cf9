"""Fused linear + cross-entropy: loss and accuracy without the (B, T, V) logits.

Counterpart of ``slam_llm_tpu/ops/fused_ce.py`` (``fused_linear_ce``), an
autograd Function chunked over T:

  forward:  per chunk  logits = x_c W^T  (compute-dtype operands, f32 sum)
            keep only  lse (B, T) f32 + the running loss / accuracy sums
  backward: recompute the chunk's logits, form (softmax - onehot) * w and
            contract it back to dx (and dW when the head trains).

Peak extra memory is one chunk of logits. The head products are plain
PyTorch matrix products (XLA's in the reference), except under an int8 head
(``head=QuantHead(...)``, the reference's ``quant=True``, ``ce_quant`` int8 /
int8_sr): a frozen head quantized per vocab row over D, each chunk's
activations quantized per row (K2) and f32 logits ``acc * x_s * head_scale``
from K3's f32 epilogue, in the forward and the backward's recompute. The
int8 dx contracts the dequantized head in the compute dtype (a plain
product); int8_sr folds the head scales into the f32 ``dlog`` and quantizes
it per row with stochastic rounding (K2 fold, seed ``seed + chunk index``
mod 2**32), then contracts the head's int8 transpose (K3).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from slam_llm_tpu_torch.ops.kernels.rowquant import rowquant
from slam_llm_tpu_torch.ops.quant import act_quant, dequantize_int8, int8_matmul, unit_scale


class QuantHead(NamedTuple):
    """The int8 head: ``q`` (V, D) int8 and ``scale`` (V,) f32 from
    ``quantize_int8`` over D, ``qt`` (D, V) its transpose; ``int8_sr``
    selects the stochastic dx with uint32 ``seed``."""

    q: torch.Tensor
    scale: torch.Tensor
    qt: torch.Tensor
    int8_sr: bool
    seed: int = 0


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D) with an f32 sum and f32 result over compute-dtype
    operands: the reference's ``preferred_element_type=float32``."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()  # bf16 products are exact in f32


def _chunk_logits(xc: torch.Tensor, wc_t: Optional[torch.Tensor], head: Optional[QuantHead]) -> torch.Tensor:
    """(M, V) f32 logits of xc (M, D), already in the compute dtype."""
    if head is None:
        return _mm_f32(xc, wc_t)
    xq, xs = act_quant(xc)
    return int8_matmul(xq, head.q, xs.reshape(-1), head.scale, torch.float32)


class _FusedLinearCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, kernel, labels, chunk: int, kernel_needs_grad: bool,
                compute_dtype: torch.dtype, ignore_index: int, head: Optional[QuantHead]):
        b, t, d = hidden.shape
        valid = labels != ignore_index
        safe = torch.where(valid, labels, torch.zeros_like(labels))
        w = valid.float()
        denom = w.sum().clamp_min(1.0)
        wc_t = kernel.to(compute_dtype).t() if head is None else None
        nll = hidden.new_zeros((), dtype=torch.float32)
        correct = hidden.new_zeros((), dtype=torch.float32)
        lses = []
        for i in range(0, t, chunk):
            xc = hidden[:, i:i + chunk].to(compute_dtype)
            c = xc.shape[1]
            logits = _chunk_logits(xc.reshape(b * c, d), wc_t, head).reshape(b, c, -1)
            lse = torch.logsumexp(logits, dim=-1)
            lab, wt = safe[:, i:i + c], w[:, i:i + c]
            ll = logits.gather(-1, lab[..., None])[..., 0]
            nll = nll + ((lse - ll) * wt).sum()
            correct = correct + ((logits.argmax(-1) == lab).float() * wt).sum()
            lses.append(lse)
        ctx.chunk, ctx.kernel_needs_grad, ctx.compute_dtype, ctx.head = chunk, kernel_needs_grad, compute_dtype, head
        ctx.save_for_backward(hidden, kernel, safe, w, torch.cat(lses, dim=1), denom)
        acc = correct / denom
        ctx.mark_non_differentiable(acc)
        return nll / denom, acc

    @staticmethod
    def backward(ctx, g_loss, g_acc):
        hidden, kernel, safe, w, lse, denom = ctx.saved_tensors
        b, t, d = hidden.shape
        cdt, head = ctx.compute_dtype, ctx.head
        wc = wc_t = None
        if head is None:
            wc = kernel.to(cdt)
            wc_t = wc.t()
        elif not head.int8_sr:
            # the exact gradient of the quantized forward contracts the
            # dequantized head (int8_sr contracts head.qt instead)
            wc = dequantize_int8(head.q, head.scale, contract_axis=-1, dtype=cdt)
        dx = torch.empty_like(hidden)
        dw = torch.zeros(kernel.shape, dtype=torch.float32, device=kernel.device) if ctx.kernel_needs_grad else None
        scale = g_loss / denom
        for n, i in enumerate(range(0, t, ctx.chunk)):
            xc = hidden[:, i:i + ctx.chunk].to(cdt)
            c = xc.shape[1]
            logits = _chunk_logits(xc.reshape(b * c, d), wc_t, head).reshape(b, c, -1)
            # (softmax - onehot) * w * g / denom
            dlog = torch.exp(logits - lse[:, i:i + c, None])
            dlog.scatter_add_(-1, safe[:, i:i + c, None], torch.full((b, c, 1), -1.0, device=dlog.device))
            dlog = dlog * (w[:, i:i + c] * scale)[..., None]
            if head is not None and head.int8_sr:
                z, sz = rowquant(dlog.reshape(b * c, -1), head.scale, seed=(head.seed + n) & 0xFFFFFFFF)
                dxc = int8_matmul(z, head.qt, sz.reshape(-1), unit_scale(d, head.qt.device), hidden.dtype)
                dx[:, i:i + c] = dxc.reshape(b, c, d)
                continue
            dlog = dlog.to(cdt)
            dx[:, i:i + c] = torch.matmul(dlog, wc).to(hidden.dtype)
            if dw is not None:
                dw += _mm_f32(dlog.reshape(b * c, -1).t(), xc.reshape(b * c, d))
        return dx, (dw.to(kernel.dtype) if dw is not None else None), None, None, None, None, None, None


def fused_linear_ce(
    hidden: torch.Tensor,  # (B, T, D), already shifted by the caller
    kernel: torch.Tensor,  # (V, D): lm_head.weight or the tied embedding table
    labels: torch.Tensor,  # (B, T), already shifted; ignore_index masks
    *,
    ignore_index: int = -100,
    chunk: int = 64,
    kernel_needs_grad: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
    head: Optional[QuantHead] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked-mean CE loss + next-token accuracy (not differentiable),
    exactly ``mean_over_valid(logsumexp(xW^T) - (xW^T)[label])`` with f32
    sums. ``kernel_needs_grad=False`` (a frozen head) skips dW; ``head``
    runs the int8 head, which must be frozen."""
    if head is not None and kernel_needs_grad:
        raise ValueError(
            "fused_linear_ce with an int8 head requires a frozen head (kernel_needs_grad=False): "
            "the s8 product's kernel gradient is zero by construction"
        )
    chunk = max(1, min(chunk, hidden.shape[1]))
    return _FusedLinearCE.apply(hidden, kernel, labels, chunk, kernel_needs_grad, compute_dtype, ignore_index, head)
