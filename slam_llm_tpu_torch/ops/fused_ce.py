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

Vocab-parallel (``tp``, a ``parallel.tensor_parallel.TP``): ``kernel`` (and
the int8 head) hold this rank's V / tp rows, from row ``tp.rank * V / tp``,
and each rank forms its chunk's V / tp columns of the logits (1 / tp of the
head's products). The chunk's logits are all-gathered in rank order for its
statistics, so the logsumexp, the label logit and the accuracy's argmax
(the lowest index among equal values) are one process's, bit for bit where
the logits are (the int8 head; a plain head's products may round apart): a
MAX and a SUM all-reduce of per-rank statistics would sum the exponentials
in another order. The peak is one chunk's whole logits, as in one process.
The backward recomputes only the rank's columns: dlog from the saved
logsumexp, dW local, and dx's partial sums over V all-reduced: f32 partials
rounded once, or, under ``int8_sr``, the dlog row scale all-reduced with
MAX, the Philox columns offset by the rank's first vocabulary row, and the
s32 accumulators all-reduced (exact).

Column windows (``windowed_linear_ce``, ``windowed_logits_ce``; S2S's text
and codebook CEs): each of several CEs reads the columns [lo, hi) of one
vocabulary, its labels relative to lo, and a window may straddle the tp
shards. The gathered chunk's logsumexp and argmax read only the window's
columns, so the statistics are one process's; the backward forms each
window's ``dlog`` on the rank's columns that fall inside it (zero
elsewhere), one dx product for all windows; ``windowed_linear_ce`` rounds
the head's logits to the compute dtype, as S2S's head output is rounded.
``windowed_logits_ce`` takes the
logits a rank already holds (a column-parallel dense's output, a bias
included) instead of a head, and returns their gradient. Either gathers
one chunk of T at a time: a rank's peak is one chunk's logits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from slam_llm_tpu_torch.ops.kernels.rowquant import row_scale, rowquant, rowquant_absmax, rowquant_scaled
from slam_llm_tpu_torch.ops.quant import (
    act_quant,
    dequantize_int8,
    int8_epilogue,
    int8_matmul,
    int8_matmul_s32,
    mm_f32,
    unit_scale,
)
from slam_llm_tpu_torch.parallel.sharding import token_count
from slam_llm_tpu_torch.parallel.tensor_parallel import TP, all_gather_last, all_reduce_max, all_reduce_sum


class QuantHead(NamedTuple):
    """The int8 head: ``q`` (V, D) int8 and ``scale`` (V,) f32 from
    ``quantize_int8`` over D, ``qt`` (D, V) its transpose; ``int8_sr``
    selects the stochastic dx with uint32 ``seed``."""

    q: torch.Tensor
    scale: torch.Tensor
    qt: torch.Tensor
    int8_sr: bool
    seed: int = 0


def _chunk_logits(xc: torch.Tensor, wc_t: Optional[torch.Tensor], head: Optional[QuantHead],
                  round_to: Optional[torch.dtype] = None) -> torch.Tensor:
    """(M, V) f32 logits of xc (M, D), already in the compute dtype;
    ``round_to``: rounded to that dtype first, as a head whose output is
    stored in it (S2S's)."""
    if head is None:
        logits = mm_f32(xc, wc_t)
    else:
        xq, xs = act_quant(xc)
        logits = int8_matmul(xq, head.q, xs.reshape(-1), head.scale, torch.float32)
    return logits if round_to is None else logits.to(round_to).float()


def _targets(labels: torch.Tensor, ignore_index: int):
    """(W, B, T) labels -> the safe labels, the weights and each window's
    global count of valid labels (``parallel.sharding.token_count``)."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    w = valid.float()
    return safe, w, torch.stack([token_count(wj) for wj in w])


def _window_stats(logits: torch.Tensor, windows, lab: torch.Tensor, wt: torch.Tensor):
    """Per window [lo, hi) of a chunk's whole (B, c, V) logits: its
    logsumexp (B, c), the weighted NLL sum and the correct-prediction sum
    (the argmax is the lowest index among equal values)."""
    out = []
    for j, (lo, hi) in enumerate(windows):
        lg = logits[..., lo:hi]
        lse = torch.logsumexp(lg, dim=-1)
        ll = lg.gather(-1, lab[j][..., None])[..., 0]
        out.append((lse, ((lse - ll) * wt[j]).sum(), ((lg.argmax(-1) == lab[j]).float() * wt[j]).sum()))
    return out


def _window_dlog(logits: torch.Tensor, first: int, windows, lab, wt, lse, scale) -> torch.Tensor:
    """(softmax - onehot) * w * g / denom of every window on this rank's
    columns [first, first + n) of the vocabulary, f32 (B, c, n): each
    window's softmax over its own columns, zero outside the windows."""
    n = logits.shape[-1]
    dlog = None
    for j, (lo, hi) in enumerate(windows):
        a, e = max(lo, first), min(hi, first + n)
        if a >= e:
            continue
        part = torch.exp(logits[..., a - first:e - first] - lse[j][..., None])
        k = lab[j][..., None] + (lo - a)  # the label's column in the part
        mine = (k >= 0) & (k < e - a)
        part.scatter_add_(-1, k.clamp(0, e - a - 1), torch.where(mine, -1.0, 0.0).to(part.dtype))
        part = part * (wt[j] * scale[j])[..., None]
        if dlog is None and (a, e) == (first, first + n):
            dlog = part
            continue
        if dlog is None:
            dlog = logits.new_zeros(logits.shape)
        dlog[..., a - first:e - first] += part
    return logits.new_zeros(logits.shape) if dlog is None else dlog


class _FusedLinearCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, kernel, labels, windows, chunk: int, kernel_needs_grad: bool,
                compute_dtype: torch.dtype, ignore_index: int, head: Optional[QuantHead], tp: Optional[TP],
                round_to: Optional[torch.dtype]):
        b, t, d = hidden.shape
        safe, w, denom = _targets(labels, ignore_index)
        wc_t = kernel.to(compute_dtype).t() if head is None else None
        nw = len(windows)
        nll = hidden.new_zeros((nw,), dtype=torch.float32)
        correct = hidden.new_zeros((nw,), dtype=torch.float32)
        lses = []
        for i in range(0, t, chunk):
            xc = hidden[:, i:i + chunk].to(compute_dtype)
            c = xc.shape[1]
            logits = _chunk_logits(xc.reshape(b * c, d), wc_t, head, round_to)
            if tp is not None:  # the whole vocabulary's logits, in rank order
                logits = all_gather_last(logits, tp)
            stats = _window_stats(logits.reshape(b, c, -1), windows, safe[:, :, i:i + c], w[:, :, i:i + c])
            nll = nll + torch.stack([s[1] for s in stats])
            correct = correct + torch.stack([s[2] for s in stats])
            lses.append(torch.stack([s[0] for s in stats]))
        ctx.windows, ctx.chunk, ctx.kernel_needs_grad = windows, chunk, kernel_needs_grad
        ctx.compute_dtype, ctx.head, ctx.tp, ctx.round_to = compute_dtype, head, tp, round_to
        ctx.save_for_backward(hidden, kernel, safe, w, torch.cat(lses, dim=2), denom)
        acc = correct / denom
        ctx.mark_non_differentiable(acc)
        return nll / denom, acc

    @staticmethod
    def backward(ctx, g_loss, g_acc):
        hidden, kernel, safe, w, lse, denom = ctx.saved_tensors
        b, t, d = hidden.shape
        cdt, head, tp = ctx.compute_dtype, ctx.head, ctx.tp
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
            logits = _chunk_logits(xc.reshape(b * c, d), wc_t, head, ctx.round_to).reshape(b, c, -1)
            v = logits.shape[-1]
            dlog = _window_dlog(logits, 0 if tp is None else tp.rank * v, ctx.windows, safe[:, :, i:i + c],
                                w[:, :, i:i + c], lse[:, :, i:i + c], scale)
            seed = (head.seed + n) & 0xFFFFFFFF if head is not None else None
            if head is not None and head.int8_sr and tp is not None:
                d2 = dlog.reshape(b * c, -1)
                s = row_scale(all_reduce_max(rowquant_absmax(d2, head.scale), tp))
                z = rowquant_scaled(d2, s, head.scale, seed=seed, col_offset=tp.rank * v)
                acc = all_reduce_sum(int8_matmul_s32(z, head.qt), tp)
                dx[:, i:i + c] = int8_epilogue(acc, s, unit_scale(d, head.qt.device), hidden.dtype).reshape(b, c, d)
                continue
            if head is not None and head.int8_sr:
                z, sz = rowquant(dlog.reshape(b * c, -1), head.scale, seed=seed)
                dxc = int8_matmul(z, head.qt, sz.reshape(-1), unit_scale(d, head.qt.device), hidden.dtype)
                dx[:, i:i + c] = dxc.reshape(b, c, d)
                continue
            dlog = dlog.to(cdt)
            if tp is None:
                dx[:, i:i + c] = torch.matmul(dlog, wc).to(hidden.dtype)
            else:  # f32 partial sums over the vocabulary shards, reduced, rounded once
                part = all_reduce_sum(mm_f32(dlog.reshape(b * c, -1), wc), tp)
                dx[:, i:i + c] = part.reshape(b, c, d).to(hidden.dtype)
            if dw is not None:
                dw += mm_f32(dlog.reshape(b * c, -1).t(), xc.reshape(b * c, d))
        return (dx, (dw.to(kernel.dtype) if dw is not None else None), None, None, None, None, None, None, None, None,
                None)


class _WindowedLogitsCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, labels, windows, chunk: int, ignore_index: int, tp: Optional[TP]):
        t = local.shape[1]
        safe, w, denom = _targets(labels, ignore_index)
        nll = local.new_zeros((len(windows),), dtype=torch.float32)
        correct = torch.zeros_like(nll)
        lses = []
        for i in range(0, t, chunk):
            logits = local[:, i:i + chunk].float()
            if tp is not None:
                logits = all_gather_last(logits, tp)
            stats = _window_stats(logits, windows, safe[:, :, i:i + chunk], w[:, :, i:i + chunk])
            nll = nll + torch.stack([s[1] for s in stats])
            correct = correct + torch.stack([s[2] for s in stats])
            lses.append(torch.stack([s[0] for s in stats]))
        ctx.windows, ctx.chunk, ctx.tp = windows, chunk, tp
        ctx.save_for_backward(local, safe, w, torch.cat(lses, dim=2), denom)
        acc = correct / denom
        ctx.mark_non_differentiable(acc)
        return nll / denom, acc

    @staticmethod
    def backward(ctx, g_loss, g_acc):
        local, safe, w, lse, denom = ctx.saved_tensors
        scale = g_loss / denom
        first = 0 if ctx.tp is None else ctx.tp.rank * local.shape[-1]
        grad = torch.empty_like(local)
        for i in range(0, local.shape[1], ctx.chunk):
            sl = slice(i, i + ctx.chunk)
            grad[:, sl] = _window_dlog(local[:, sl].float(), first, ctx.windows, safe[:, :, sl], w[:, :, sl],
                                       lse[:, :, sl], scale).to(local.dtype)
        return grad, None, None, None, None, None


def windowed_linear_ce(
    hidden: torch.Tensor,  # (B, T, D), already shifted by the caller
    kernel: torch.Tensor,  # (V, D), this rank's V / tp rows under tp
    labels: Sequence[torch.Tensor],  # per window (B, T), relative to its lo, shifted; ignore_index masks
    windows: Sequence[Tuple[int, int]],  # per window its columns [lo, hi) of the whole vocabulary
    *,
    ignore_index: int = -100,
    chunk: int = 64,
    kernel_needs_grad: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
    tp: Optional[TP] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each window's masked-mean CE and accuracy (``(W,)`` each, the
    accuracies not differentiable) over the head's logits ``x W^T``, which
    are formed a chunk of T at a time and never whole, and rounded to
    ``compute_dtype`` as a head whose output is stored in it (S2S's)."""
    chunk = max(1, min(chunk, hidden.shape[1]))
    return _FusedLinearCE.apply(hidden, kernel, torch.stack(list(labels)), tuple(windows), chunk, kernel_needs_grad,
                                compute_dtype, ignore_index, None, tp, compute_dtype)


def windowed_logits_ce(
    local: torch.Tensor,  # (B, T, V / tp): this rank's columns of the logits (already shifted)
    labels: Sequence[torch.Tensor],  # per window (B, T), relative to its lo; ignore_index masks
    windows: Sequence[Tuple[int, int]],
    *,
    ignore_index: int = -100,
    chunk: int = 64,
    tp: Optional[TP] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``windowed_linear_ce`` over logits a rank already holds (whole without
    tp): their statistics in f32 from one gathered chunk at a time, their
    gradient in ``local``'s dtype."""
    chunk = max(1, min(chunk, local.shape[1]))
    return _WindowedLogitsCE.apply(local, torch.stack(list(labels)), tuple(windows), chunk, ignore_index, tp)


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
    tp: Optional[TP] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked-mean CE loss + next-token accuracy (not differentiable),
    exactly ``mean_over_valid(logsumexp(xW^T) - (xW^T)[label])`` with f32
    sums; the count of valid labels is the global batch's
    (``parallel.sharding.token_count``). ``kernel_needs_grad=False`` (a frozen head) skips dW; ``head``
    runs the int8 head, which must be frozen. ``tp``: ``kernel`` / ``head``
    are this rank's vocabulary shard (see the note at the top)."""
    if head is not None and kernel_needs_grad:
        raise ValueError(
            "fused_linear_ce with an int8 head requires a frozen head (kernel_needs_grad=False): "
            "the s8 product's kernel gradient is zero by construction"
        )
    chunk = max(1, min(chunk, hidden.shape[1]))
    v = kernel.shape[0] if head is None else head.q.shape[0]
    loss, acc = _FusedLinearCE.apply(hidden, kernel, labels[None], ((0, v * (1 if tp is None else tp.size)),), chunk,
                                     kernel_needs_grad, compute_dtype, ignore_index, head, tp, None)
    return loss[0], acc[0]
