"""Flash attention: the CUDA kernels K1 (forward) and K4 (backward), their
plain twins, and the autograd Function that joins them.

Counterpart of ``slam_llm_tpu/ops/kernels/flash_attention.py``
(``flash_attention``: ``_flash_fwd``, ``_flash_bwd``, ``_fwd_rule``,
``_bwd_rule``). Inputs keep the model's layout: q (B, Tq, H, D), k/v
(B, Tk, Hkv, D), ``H % Hkv == 0`` (query head h reads kv head h // (H/Hkv)),
kv_mask (B, Tk) with 1 on valid keys. ``causal`` is start-aligned and so
only defined for Tq == Tk. ``lse`` (B, Tq, H) f32 is in the log2 domain
(log2-sum-exp2 of the scaled scores). Query rows that see no valid key
output exactly 0 and get dq = 0; their lse carries no meaning.

``rope=(cos, sin)``, each (B, T, D/2) f32 from ``rope_tables``, fuses the
RoPE rotation: q/k come PRE-rotation, the kernels rotate them as they load
them (f32 rotation, one rounding to q's dtype: ``apply_rope_tables``) and
the backward counter-rotates dq/dk. Self-attention only (Tq == Tk).

The wrappers send CPU tensors to the twins and CUDA tensors to
``csrc/flash_attention.cu`` (K1) and ``csrc/flash_attention_bwd.cu`` (K4):
bf16, D in {64, 128}. f32 CUDA tensors take the f32 routes, f32-accurate
products on the tensor cores as 3-pass split TF32 (``tf32_split``: each
product is hi_a hi_b + hi_a lo_b + lo_a hi_b), without fused RoPE: K1's
(``csrc/flash_attention_f32.cu``, ``flash_attention_fwd_f32``) and K4's
(``csrc/flash_attention_bwd_f32.cu``, ``flash_attention_bwd_f32``). They
raise on anything else.
``plan_flash`` decides, in plain Python, how the bf16 kernels cut a call
into units of work (rows per
unit, query heads packed per unit, key or query tile, ring stages, grid,
launch order, shared memory); the C entry points take its choices.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

NEG_INF = -1.0e30  # masked-score sentinel, as in the TPU kernel
LOG2E = 1.4426950408889634

Rope = Optional[Tuple[torch.Tensor, torch.Tensor]]


def apply_rope_tables(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, inverse: bool = False
) -> torch.Tensor:
    """x (B, T, H, D) rotate-half RoPE with (B, T, D/2) tables: rotate in
    f32 and cast each half back to x's dtype. ``inverse`` applies R^T."""
    half = x.shape[-1] // 2
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    if inverse:
        sin = -sin
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out1 = (x1 * cos - x2 * sin).to(x.dtype)
    out2 = (x2 * cos + x1 * sin).to(x.dtype)
    return torch.cat([out1, out2], dim=-1)


def _check_shapes(q, k, v, kv_mask, causal, rope: Rope = None):
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
    if rope is not None:
        if tq != tk:
            raise ValueError(f"fused rope requires self-attention (tq == tk), got {tq} vs {tk}")
        for t in rope:
            if t.shape != (b, tq, d // 2):
                raise ValueError(f"rope tables must be (B, T, D/2) = {(b, tq, d // 2)}, got {tuple(t.shape)}")


def _scores(q, k, kv_mask, causal, scale, rope: Rope):
    """(rotated q, rotated k, log2-domain scores (B, Hkv, G, Tq, Tk) f32,
    validity mask) of the twin."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if rope is not None:
        q = apply_rope_tables(q, *rope)
        k = apply_rope_tables(k, *rope)
    qg = q.float().reshape(b, tq, hkv, h // hkv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (scale * LOG2E)
    valid = kv_mask.bool()[:, None, None, None, :]
    if causal:
        valid = valid & torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril()
    return q, k, s, valid.expand(s.shape)


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_mask: torch.Tensor,
    causal: bool = False, scale: Optional[float] = None, rope: Rope = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of K1, in f32: ``(out, lse)``."""
    _check_shapes(q, k, v, kv_mask, causal, rope)
    b, tq, h, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    _, _, s, valid = _scores(q, k, kv_mask, causal, scale, rope)
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


def flash_attention_bwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_mask: torch.Tensor,
    out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
    causal: bool = False, scale: Optional[float] = None, rope: Rope = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of K4, in f32: ``(dq, dk, dv)`` in q's / k's / v's dtypes.
    P is recomputed from (q, k, lse) as the kernel does; invalid pairs and
    dead rows give P = 0. As in the kernel, P and dS = P (dP - delta) are
    rounded to q's dtype before their products (dV = P^T dout, dQ = dS K,
    dK = dS^T Q), which leaves f32 inputs exact."""
    _check_shapes(q, k, v, kv_mask, causal, rope)
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qr, kr, s, valid = _scores(q, k, kv_mask, causal, scale, rope)
    lse5 = lse.float().reshape(b, tq, hkv, g).permute(0, 2, 3, 1)[..., None]  # (B, Hkv, G, Tq, 1)
    p = torch.where(valid, torch.exp2(torch.where(valid, s - lse5, 0.0)), 0.0)
    do = dout.float().reshape(b, tq, hkv, g, d)
    delta = (dout.float() * out.float()).sum(-1).reshape(b, tq, hkv, g).permute(0, 2, 3, 1)[..., None]
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(q.dtype).float(), do)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do, v.float())
    ds = (p * (dp - delta)).to(q.dtype).float()
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kr.float()).reshape(b, tq, h, d) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qr.float().reshape(b, tq, hkv, g, d)) * scale
    if rope is not None:
        dq = apply_rope_tables(dq, *rope, inverse=True)
        dk = apply_rope_tables(dk, *rope, inverse=True)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bwd_f32_error(got, want, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor) -> float:
    """The error the f32 backward route is held to (2e-5) against its twin's
    ``want``: the largest of dq's, dk's and dv's max |got - want| over the
    twin's largest entry. At T = 1 every row sees its own key alone, so P =
    1 and dS = dP - delta = 0 in exact arithmetic: dq and dk are then the
    round-off of that cancellation on both sides (the twin's largest entry
    is itself round-off), so the larger of the two largest entries is taken
    over the largest |dP| x |k| (or |q|) x scale, dk's over its G heads.
    For the tests and the on-card check; no route calls it."""

    def rel(g, w):
        err, top = (g - w).abs().max().item(), w.abs().max().item()
        return err / top if top else (math.inf if err else 0.0)

    errs = [rel(g, w) for g, w in zip(got, want)]
    if q.shape[1] == 1:
        h, hkv, d = q.shape[2], k.shape[2], q.shape[3]
        dp = (dout.float() * v.float().repeat_interleave(h // hkv, 2)).sum(-1).abs().max().item()
        errs[:2] = [max(g.abs().max().item(), w.abs().max().item()) / (dp * x.abs().max().item() * d ** -0.5 * n)
                    for g, w, x, n in ((got[0], want[0], k, 1), (got[1], want[1], q, h // hkv))]
    return max(errs)


# ---- the kernels' planner ---------------------------------------------------

UNIT_ROWS = 128  # query rows of a K1 / dq unit, keys of a dk/dv unit: two consumer warpgroups of 64
SMEM_LIMIT = 232448  # dynamic shared memory one block may use on the H100 (227 KB)
_BAR_BYTES = 8
_ALIGN_SLACK = 1024  # the kernels align their shared memory to the 128-byte swizzle's 1024 bytes


class PassPlan(NamedTuple):
    """One kernel's cut of a call. ``rows``: rows of a unit (query rows =
    positions x ``heads`` query heads of one kv head; keys for dk/dv, which
    loops over the G heads); ``positions``: query positions of a unit (K1,
    dq); ``tile``: keys (K1, dq) or queries (dk/dv) per ring stage; ``units``
    over a persistent ``grid``, the longest first when ``longest_first``."""

    rows: int
    heads: int
    positions: int
    tile: int
    stages: int
    units: int
    grid: int
    longest_first: bool
    smem_bytes: int


class FlashPlan(NamedTuple):
    fwd: PassPlan
    dq: Optional[PassPlan]  # None where the backward kernel does not run (Tq != Tk)
    dkv: Optional[PassPlan]


def heads_per_unit(g: int) -> int:
    """Query heads packed into one unit's rows: the largest divisor of the
    group G = H / Hkv that fits the unit's 128 rows (G itself up to 128)."""
    return max(x for x in range(1, min(g, UNIT_ROWS) + 1) if g % x == 0)


def plan_flash(b: int, tq: int, tk: int, h: int, hkv: int, d: int, causal: bool, rope: bool,
               sms: int = 132) -> FlashPlan:
    """K1's and K4's plans for one call (mirrors the layouts in
    csrc/flash_attention*.cu). K1 and the dq pass pack ``heads_per_unit``
    query heads of one kv head into 128 rows, so a K / V tile serves all of
    them, and double-buffer the unit's Q (and dout); K1 streams 128-key
    tiles through 3 stages at D = 64 without the causal mask, else 64-key
    tiles through 4 (3 at D = 128); dq 64-key tiles through 3. The dk/dv
    pass owns 128 keys of one kv head and streams 64-query tiles of each of
    the G heads through 3 stages (2 at D = 128). K4's two passes are one
    launch: they share its grid and shared memory. Raises on what the
    kernels do not take."""
    if d not in (64, 128):
        raise ValueError(f"flash kernels take head_dim 64 or 128, got {d}")
    if min(b, tq, tk, h, hkv) < 1 or h % hkv:
        raise ValueError(f"flash kernels need B, T >= 1 and H % Hkv == 0, got B={b} Tq={tq} Tk={tk} H={h} Hkv={hkv}")
    if (causal or rope) and tq != tk:
        raise ValueError(f"causal / fused-rope flash attention requires tq == tk, got {tq} vs {tk}")
    g = h // hkv
    # K1: 128-key tiles at D = 64 without the causal mask, else 64 (less of
    # the diagonal tile is wasted, and D = 128 fits); two Q buffers and the
    # output's staging rows
    bn = 128 if d == 64 and not causal else 64
    st_fwd = 3 if bn == 128 else (4 if d == 64 else 3)
    hb = heads_per_unit(g)
    units = -(-tq // (UNIT_ROWS // hb)) * (h // hb) * b
    smem = (2 * UNIT_ROWS * d * 2 + UNIT_ROWS * (d * 2 + 16) + st_fwd * (2 * bn * d * 2 + bn // 32 * 4)
            + (4 + 2 * st_fwd) * _BAR_BYTES + _ALIGN_SLACK)
    fwd = PassPlan(UNIT_ROWS, hb, UNIT_ROWS // hb, bn, st_fwd, units, min(units, sms), causal, smem)
    if tq != tk:
        return FlashPlan(fwd, None, None)
    # K4: the dk/dv and dq passes run as one persistent launch (dk/dv units
    # first) in one shared-memory region, the larger of the two layouts
    st_dkv = 3 if d == 64 else 2
    dkv_bytes = 2 * UNIT_ROWS * d * 2 + st_dkv * (2 * 64 * d * 2 + 2 * 64 * 4)
    dq_bytes = 4 * UNIT_ROWS * d * 2 + 3 * 2 * 64 * d * 2
    smem = max(dkv_bytes, dq_bytes) + 3 * 2 * 4 + (2 + 2 * st_dkv + 4 + 2 * 3) * _BAR_BYTES + _ALIGN_SLACK
    dq_units = -(-tq // (UNIT_ROWS // hb)) * (h // hb) * b
    dkv_units = -(-tq // UNIT_ROWS) * hkv * b
    grid = min(dq_units + dkv_units, sms)
    dq = PassPlan(UNIT_ROWS, hb, UNIT_ROWS // hb, 64, 3, dq_units, grid, causal, smem)
    dkv = PassPlan(UNIT_ROWS, 1, 0, 64, st_dkv, dkv_units, grid, causal, smem)
    return FlashPlan(fwd, dq, dkv)


def unit_rows(plan: PassPlan, b: int, t: int, h: int, u: int):
    """``(batch, positions, heads)`` of the live rows of unit ``u`` of a K1
    or dq pass, in the kernels' order: the rank (slowest) walks the query
    tiles, reversed when ``longest_first``; then batch; then head group."""
    groups = h // plan.heads
    n_qt = -(-t // plan.positions)
    rank, rem = divmod(u, groups * b)
    bb, hg = divmod(rem, groups)
    q0 = (n_qt - 1 - rank if plan.longest_first else rank) * plan.positions
    r = torch.arange(plan.heads * plan.positions)
    pos = q0 + r // plan.heads
    live = pos < t
    return bb, pos[live], (hg * plan.heads + r % plan.heads)[live]


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` of f32 ``x`` as the f32 routes split their operands:
    ``hi = tf32(x)``, ``lo = tf32(x - hi)``, each rounded to TF32's 10
    mantissa bits to nearest, ties away from zero (``cvt.rna.tf32.f32``).
    ``x - hi`` is exact in f32, so ``hi + lo`` is within 2^-22 of ``x``
    relative."""

    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    x = x.float()
    hi = rna(x)
    return hi, rna(x - hi)


def _f32_operand(x: torch.Tensor) -> torch.Tensor:
    """x as the f32 kernels read it: a contiguous last dim and 16-byte
    aligned rows (each row is loaded as float4), else a contiguous copy."""
    if x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and all(st % 4 == 0 for st in x.stride()[:-1]):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _check_kernel_inputs(d, *tensors, dtype=torch.bfloat16):
    if any(t.dtype != dtype for t in tensors):
        raise TypeError(f"flash kernels take {dtype} here, got {[t.dtype for t in tensors]}")
    if d not in (64, 128):
        raise ValueError(f"flash kernels take head_dim 64 or 128, got {d}")


def _is_f32(*tensors) -> bool:
    return all(t.dtype == torch.float32 for t in tensors)


def _kernel_rope(rope: Rope, device):
    if rope is None:
        return None, None, 0, 0
    cos, sin = (t.to(device=device, dtype=torch.float32).contiguous() for t in rope)
    return cos, sin, cos.data_ptr(), sin.data_ptr()


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_mask: torch.Tensor,
    causal: bool = False, scale: Optional[float] = None, rope: Rope = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)``: K1 on CUDA tensors, the twin on CPU tensors."""
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, kv_mask, causal, scale, rope)
    if _is_f32(q, k, v):
        if rope is not None:
            raise NotImplementedError("K1's f32 route takes no fused RoPE (ROADMAP Queue 2): rotate q / k first")
        return flash_attention_fwd_f32(q, k, v, kv_mask, causal, scale)
    _check_shapes(q, k, v, kv_mask, causal, rope)
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    _check_kernel_inputs(d, q, k, v)
    for name, x in (("q", q), ("k", k), ("v", v)):
        # TMA: 16-byte aligned base and strides
        if x.stride(-1) != 1 or any(s % 8 or s == 0 for s in x.stride()[:-1]) or x.data_ptr() % 16:
            raise ValueError(f"flash kernel needs {name} with a contiguous, 16-byte aligned last dim")
    mask = kv_mask.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, tq, h), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    from slam_llm_tpu_torch.kernels.build import check, library, sm_count, stream_ptr

    cos, sin, cos_p, sin_p = _kernel_rope(rope, q.device)
    plan = plan_flash(b, tq, tk, h, hkv, d, causal, rope is not None)
    # fused RoPE: k is rotated into this scratch once, then loaded by TMA
    k_rot = torch.empty((b, tk, hkv, d), dtype=k.dtype, device=q.device) if rope is not None else None
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    with torch.cuda.device(q.device):
        err = library().slam_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(), cos_p, sin_p, k_rot.data_ptr() if k_rot is not None else 0,
            b, tq, tk, h, hkv, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), int(causal), plan.fwd.heads, plan.fwd.tile, sm_count(q.device.index), stream_ptr(q),
        )
    check(err, "flash_attention")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_fwd_f32(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_mask: torch.Tensor,
    causal: bool = False, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` of f32 q / k / v: K1's f32 route
    (``csrc/flash_attention_f32.cu``) on CUDA tensors, the twin on CPU
    tensors. Any strides (a view whose rows are not 16-byte aligned is
    copied); D in {64, 128}."""
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, kv_mask, causal, scale)
    _check_shapes(q, k, v, kv_mask, causal)
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    _check_kernel_inputs(d, q, k, v, dtype=torch.float32)
    q, k, v = (_f32_operand(x) for x in (q, k, v))
    mask = kv_mask.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((b, tq, h, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, tq, h), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    from slam_llm_tpu_torch.kernels.build import check, library, stream_ptr

    scale = 1.0 / math.sqrt(d) if scale is None else scale
    with torch.cuda.device(q.device):
        err = library().slam_flash_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b, tq, tk, h, hkv, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], float(scale), int(causal),
            stream_ptr(q),
        )
    check(err, "flash_attention_f32")
    flash_attention_fwd_f32.launches += 1
    return out, lse


flash_attention_fwd_f32.launches = 0


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_mask: torch.Tensor,
    out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
    causal: bool = False, scale: Optional[float] = None, rope: Rope = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)``: K4 on CUDA tensors, the twin on CPU tensors.
    Self-attention only on the card (Tq == Tk)."""
    if not q.is_cuda:
        return flash_attention_bwd_ref(q, k, v, kv_mask, out, lse, dout, causal, scale, rope)
    _check_shapes(q, k, v, kv_mask, causal, rope)
    b, t, h, d = q.shape
    hkv = k.shape[2]
    if k.shape[1] != t:
        raise ValueError(f"flash backward kernel takes self-attention (tq == tk), got {t} vs {k.shape[1]}")
    if _is_f32(q, k, v):
        if rope is not None:
            raise NotImplementedError("K4's f32 route takes no fused RoPE (ROADMAP Queue 2): rotate q / k first")
        return flash_attention_bwd_f32(q, k, v, kv_mask, out, lse, dout, causal, scale)
    _check_kernel_inputs(d, q, k, v, out, dout)
    q, k, v, out, dout = (x.contiguous() for x in (q, k, v, out, dout))
    lse = lse.float().contiguous()
    mask = kv_mask.to(device=q.device, dtype=torch.int32).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0:
        return dq, dk, dv
    plan = plan_flash(b, t, t, h, hkv, d, causal, rope is not None)
    # lse and delta in a (B, H, Tpad) layout, each query tile's values one
    # 256-byte bulk copy; with fused RoPE, q and k rotated once
    tpad = -(-t // 64) * 64
    lse_t = torch.empty((b, h, tpad), dtype=torch.float32, device=q.device)
    dlt_t = torch.empty_like(lse_t)
    q_rot = torch.empty_like(q) if rope is not None else None
    k_rot = torch.empty_like(k) if rope is not None else None
    from slam_llm_tpu_torch.kernels.build import check, library, sm_count, stream_ptr

    cos, sin, cos_p, sin_p = _kernel_rope(rope, q.device)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    with torch.cuda.device(q.device):
        err = library().slam_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), cos_p, sin_p, lse_t.data_ptr(), dlt_t.data_ptr(),
            q_rot.data_ptr() if q_rot is not None else 0, k_rot.data_ptr() if k_rot is not None else 0,
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t, h, hkv, d,
            float(scale), int(causal), plan.dq.heads, tpad, sm_count(q.device.index), stream_ptr(q),
        )
    check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def flash_attention_bwd_f32(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_mask: torch.Tensor,
    out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
    causal: bool = False, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of f32 q / k / v / out / dout: K4's f32 route
    (``csrc/flash_attention_bwd_f32.cu``, two launches: dq with delta, then
    dk / dv) on CUDA tensors, the twin on CPU tensors. Self-attention only
    on the card (Tq == Tk); any strides (a view whose rows are not 16-byte
    aligned is copied); D in {64, 128}; ``lse`` is K1 f32's log2 value."""
    if not q.is_cuda:
        return flash_attention_bwd_ref(q, k, v, kv_mask, out, lse, dout, causal, scale)
    _check_shapes(q, k, v, kv_mask, causal)
    b, t, h, d = q.shape
    hkv = k.shape[2]
    if k.shape[1] != t:
        raise ValueError(f"flash backward kernel takes self-attention (tq == tk), got {t} vs {k.shape[1]}")
    _check_kernel_inputs(d, q, k, v, out, dout, dtype=torch.float32)
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != (b, t, h):
        raise ValueError(f"out / dout must be {tuple(q.shape)} and lse {(b, t, h)}, got {tuple(out.shape)}, "
                         f"{tuple(dout.shape)}, {tuple(lse.shape)}")
    q, k, v, out, dout = (_f32_operand(x) for x in (q, k, v, out, dout))
    lse = lse.float().contiguous()
    mask = kv_mask.to(device=q.device, dtype=torch.int32).contiguous()
    dq = torch.empty((b, t, h, d), dtype=torch.float32, device=q.device)
    dk = torch.empty((b, t, hkv, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0:
        return dq, dk, dv
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    from slam_llm_tpu_torch.kernels.build import check, library, stream_ptr

    scale = 1.0 / math.sqrt(d) if scale is None else scale
    with torch.cuda.device(q.device):
        err = library().slam_flash_bwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t, h, hkv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], *dout.stride()[:3],
            float(scale), int(causal), stream_ptr(q),
        )
    check(err, "flash_attention_bwd_f32")
    flash_attention_bwd_f32.launches += 1
    return dq, dk, dv


flash_attention_bwd_f32.launches = 0


class FlashAttention(torch.autograd.Function):
    """K1 forward, K4 backward (their f32 routes on f32 tensors). Saves
    (q, k, v, kv_mask, out, lse, rope) as the reference's ``_fwd_rule``
    does: no (Tq, Tk) tensor survives the forward. Given ``out`` and ``lse`` (a checkpointed layer's replay), the
    forward takes them instead of running K1."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal: bool, scale: Optional[float], cos, sin, out, lse):
        rope = None if cos is None else (cos, sin)
        if out is None:
            out, lse = flash_attention_fwd(q, k, v, kv_mask, causal, scale, rope)
        ctx.causal, ctx.scale, ctx.has_rope = causal, scale, rope is not None
        ctx.save_for_backward(q, k, v, kv_mask, out, lse, *(rope or ()))
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out, lse, *rope = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, kv_mask, out, lse, dout, ctx.causal, ctx.scale, tuple(rope) if ctx.has_rope else None
        )
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_mask: torch.Tensor,
    causal: bool = False, rope: Rope = None, scale: Optional[float] = None, tape=None, owner=None,
) -> torch.Tensor:
    """Differentiable flash attention over (q, k, v); ``rope`` fuses RoPE.
    With a ``models.remat.Tape`` the call is the checkpoint site ``flash`` of
    ``owner``: a recording tape keeps (out, lse) when its policy saves them,
    a replaying one hands them back and K1 does not run again."""
    saved = tape is not None and tape.saves("flash")
    cos, sin = rope if rope is not None else (None, None)
    if saved and tape.replaying:
        out, lse = tape.get(owner, "flash_out"), tape.get(owner, "flash_lse")
        return FlashAttention.apply(q, k, v, kv_mask, causal, scale, cos, sin, out, lse)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
        out, lse = flash_attention_fwd(q, k, v, kv_mask, causal, scale, rope)  # no backward to prepare for
        if saved:
            tape.put(owner, "flash_out", out)
            tape.put(owner, "flash_lse", lse)
        return out
    return FlashAttention.apply(q, k, v, kv_mask, causal, scale, cos, sin, None, None)
