"""Per-row dynamic int8 quantization: the CUDA kernel K2 and its plain twin.

Counterpart of ``slam_llm_tpu/ops/kernels/rowquant.py``. ``rowquant`` sends
a CPU tensor to ``rowquant_ref`` and a CUDA tensor to the one kernel of
``csrc/rowquant.cu``, through three wrappers with a launch count each; it
raises on what the kernel does not take. ``plan_rowquant`` (pure Python)
picks the kernel's block, rows per group and units per thread from the
shape.

* Deterministic rounding (forward activations): ``q = round(x / s)``,
  bit-exact against the reference's ``jnp.round(x / s)``. Counted on
  ``rowquant.launches``.
* ``seed`` (stochastic rounding, ``q = floor(y + u)``) and ``rotate`` (the
  block-diagonal Hadamard of ``rotate_cols`` before quantizing), the dy
  quantization of the ``int8_rot`` backward: a fast Walsh-Hadamard
  transform in f32 and a counter-based Philox4x32-10 stream. Counted on
  ``rowquant_rot_sr.launches``.
* ``fold`` (a per-column f32 vector multiplied into x first, one rounding):
  the dy quantization of the ``int8`` (deterministic) and ``int8_sr``
  (stochastic) backward modes, whose weight scales sit inside the dx
  contraction, and of the int8 CE head's f32 ``dlog``. bf16 or f32 input;
  counted on ``rowquant_fold.launches``. ``fold`` with ``rotate`` raises, as
  in the reference (the two would order the column mixing differently).

Each wrapper also counts its launches by row width in ``.widths``.

The TPU draws ``u`` from its own generator, which nothing else reproduces.
Here ``u`` comes from Philox4x32-10 keyed by ``(seed, 0)`` with counter
``(col // 4, row mod 2**32, row // 2**32, 0)``, word ``col % 4``, low 24
bits times ``2**-24``. The twin computes the same stream in int64 torch
arithmetic and the same butterfly order, so kernel and twin agree bit for
bit; against JAX the stochastic rounding is tested by its statistics.
"""

from __future__ import annotations

import collections
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

_EPS_AMAX = 1e-28  # amax floor: keeps s > 0 for all-zero rows
ROT_BLOCK = 256  # preferred block-diagonal Hadamard rotation block


def rot_block(f: int, cap: int = ROT_BLOCK) -> int:
    """Rotation block for a feature dim ``f``: the largest power of two
    dividing ``f``, capped at ``cap``. The dy quantization and the rotated
    weight (``ops.quant.rotate_quantize_bwd``) derive it from the same axis."""
    b = f & -f
    return min(b, cap) if f else cap


def hadamard(n: int = ROT_BLOCK) -> torch.Tensor:
    """Sylvester Hadamard matrix scaled orthonormal (``H @ H.T = I``), f32."""
    if n <= 0 or n & (n - 1):
        raise ValueError(f"hadamard size must be a power of 2, got {n}")
    h = torch.ones(1, 1)
    while h.shape[0] < n:
        h = torch.cat([torch.cat([h, h], 1), torch.cat([h, -h], 1)], 0)
    return h / math.sqrt(n)


def _fwht_scale(b: int) -> float:
    """1/sqrt(b) rounded to f32 (exact for b a power of four, e.g. 256)."""
    return float(torch.tensor(1.0 / math.sqrt(b), dtype=torch.float32))


def rotate_cols(x: torch.Tensor) -> torch.Tensor:
    """Block-diagonal orthonormal Hadamard along the last axis, block
    ``rot_block(F)``, computed in f32 as a fast Walsh-Hadamard transform:
    log2(b) butterfly stages of add/sub in natural (Sylvester) order, stride
    1 first, then one multiply by 1/sqrt(b). K2 runs the same stages in the
    same order, so the two agree bit for bit. Returns f32."""
    f = x.shape[-1]
    b = rot_block(f)
    y = x.float().reshape(-1, f // b, b)
    h = 1
    while h < b:
        y = y.reshape(-1, f // b, b // (2 * h), 2, h)
        lo, hi = y[..., 0, :], y[..., 1, :]
        y = torch.stack([lo + hi, lo - hi], dim=-2)
        h *= 2
    # an f32-representable Python scalar: the product is exact f32 rounding
    return y.reshape(x.shape[:-1] + (f,)) * _fwht_scale(b)


# ---- Philox4x32-10 in int64 arithmetic ------------------------------------

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """High and low 32 bits of ``a * b`` for a < 2**32 and int64 b in
    [0, 2**32). The 64-bit product would overflow int64, so b is split into
    16-bit halves and every partial product stays below 2**49."""
    p1 = a * (b & 0xFFFF)
    t = (p1 >> 16) + a * (b >> 16)
    return t >> 16, ((t & 0xFFFF) << 16) | (p1 & 0xFFFF)


def philox4x32(c0, c1, c2, c3, k0: int, k1: int = 0):
    """Ten Philox4x32 rounds on int64 tensors holding uint32 values; the key
    is bumped by the Weyl constants before every round but the first."""
    for i in range(10):
        if i:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform_ref(m: int, k: int, seed: int, device=None) -> torch.Tensor:
    """The (m, k) f32 uniforms in [0, 1) that K2's stochastic rounding adds:
    element (row, col) is word ``col % 4`` of Philox at counter
    ``(col // 4, row lo, row hi, 0)``, key ``(seed, 0)``, low 24 bits."""
    g = (k + 3) // 4
    c0 = torch.arange(g, dtype=torch.int64, device=device)[None, :].expand(m, g)
    rows = torch.arange(m, dtype=torch.int64, device=device)[:, None].expand(m, g)
    zero = torch.zeros_like(c0)
    words = philox4x32(c0, rows & _MASK32, rows >> 32, zero, int(seed) & _MASK32)
    bits = torch.stack(words, dim=-1).reshape(m, 4 * g)[:, :k]
    return (bits & 0xFFFFFF).float() * 2.0 ** -24


# ---- the twin and the wrapper ----------------------------------------------


def _check_fold(fold: Optional[torch.Tensor], rotate: bool) -> None:
    if fold is not None and rotate:
        raise ValueError("rowquant: fold and rotate are mutually exclusive")


def rowquant_ref(
    x: torch.Tensor, fold: Optional[torch.Tensor] = None, *, seed: Optional[int] = None,
    rotate: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch rowquant: ``s = amax/127`` per row of (rotated, or
    folded: ``x * fold`` in f32) x, ``q = clip(round(x / s))``, or
    ``clip(floor(x / s + u))`` with ``seed``."""
    _check_fold(fold, rotate)
    k = x.shape[-1]
    if rotate:
        x32 = rotate_cols(x)
    elif fold is not None:
        x32 = x.float() * fold.float()
    else:
        x32 = x.float()
    a = x32.abs().amax(dim=-1, keepdim=True)
    # divide by a tensor, not the Python scalar: on CUDA, PyTorch turns division
    # by a host scalar into a multiplication by its reciprocal, which rounds
    # differently from the true division the reference (and K2) performs
    s = torch.clamp_min(a, _EPS_AMAX) / a.new_full((), 127.0)
    y = x32 / s
    if seed is None:
        q = torch.round(y)
    else:
        m = x.numel() // k if k else 0
        q = torch.floor(y + uniform_ref(m, k, seed, x.device).reshape(x.shape))
    return q.clamp_(-127, 127).to(torch.int8), s


def _check_kernel_input(x: torch.Tensor, k_multiple: int, dtypes=(torch.bfloat16,)) -> None:
    if x.dtype not in dtypes:
        raise TypeError(f"rowquant kernel takes {' or '.join(map(str, dtypes))}, got {x.dtype}")
    if x.shape[-1] % k_multiple or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(
            f"rowquant kernel needs a contiguous, 16-byte aligned input with K % {k_multiple} == 0"
        )


# ---- the kernel's plan -------------------------------------------------------

MAX_THREADS = 512
MAX_ROWS = 64  # rows per group
MAX_VALUES = 64  # f32 values a thread holds in registers
MAX_K = MAX_THREADS * MAX_VALUES  # the longest row one block holds; longer rows take the long-row path
ONE_ROW_UNITS = 4  # above this many units a thread, a group is one row (the kernel's rule)
FOLD_SMEM_MAX = 128 * 1024  # fold bytes the kernel stages in shared memory
SMEM_MAX = 200 * 1024  # dynamic shared memory of a block: fold and the stochastic-rounding stage
MIN_GROUPS_PER_SM = 4  # row groups per SM before rows are grouped at all
BLOCK_TARGET = 128  # threads a block should have at least, where rows allow (64 under the rotation)
SR_THREADS = 128  # the block of a one-row group under stochastic rounding without the rotation


class RowquantPlan(NamedTuple):
    """How K2 runs one call (``csrc/rowquant.cu``): ``threads`` per block,
    ``rows`` per group, ``units`` per thread per group (16 bytes of x, or 32
    columns under the rotation; 0 for the long-row path), and whether
    ``fold`` sits in shared memory (beside the group's f32 stage under
    stochastic rounding)."""

    threads: int
    rows: int
    units: int
    fold_smem: bool


def unit_elems(elem_bytes: int, rotate: bool) -> int:
    """Columns a thread takes at a time: 32 under the rotation, else 16 bytes."""
    return 32 if rotate else 16 // elem_bytes


def _threads_for(units: int, max_per_thread: int, target: int) -> Tuple[float, int, int]:
    """(fill, threads, units per thread) for a group of ``units``: the
    multiple of 32 threads and the units each takes that leave the fewest
    threads idle, then units per thread nearest ``target``, then the
    smaller block; fill 0 where no block holds the group."""
    best = ((0.0,), 0, 0)
    for n in range(1, max_per_thread + 1):
        nt = 32 * -(-units // (32 * n))
        if nt > MAX_THREADS:
            continue
        key = (units / (nt * n), -abs(n - target), -nt)
        if key > best[0]:
            best = (key, nt, n)
    return best[0][0], best[1], best[2]


@functools.lru_cache(maxsize=4096)
def plan_rowquant(m: int, k: int, elem_bytes: int = 2, rotate: bool = False, fold: bool = False,
                  sms: int = 132, sr: bool = False) -> RowquantPlan:
    """K2's plan for an (m, k) input of ``elem_bytes`` per element.

    Units per thread aim at 2 (1 under the rotation, whose 32 values a unit
    already fill the registers): measured on the H100, more loads per thread
    cost more in occupancy than they gain in bytes in flight. A group takes
    rows (powers of two) until its block reaches ``BLOCK_TARGET`` threads
    (64 under the rotation), while the card keeps ``MIN_GROUPS_PER_SM``
    groups per SM; without the rotation, twice as many rows where that
    leaves fewer threads idle (the rotation measured faster with idle lanes
    than with larger blocks). Stochastic rounding without the rotation
    gives a one-row group ``SR_THREADS`` threads where that leaves at most a
    tenth of them idle and the rows fill the card: its pass over the stage
    measured faster with fewer, busier threads (fold SR at (8192, 5632):
    0.100 ms at 128 x 6 units against 0.112 at 352 x 2). Rows longer than
    ``MAX_K`` elements do not fit one block's registers: they take the
    kernel's long-row path (``units`` 0: a block of ``MAX_THREADS`` per row,
    x read twice, nothing staged). ``fold`` goes to shared memory where it
    fits beside the stochastic-rounding stage (``rows`` x K f32)."""
    unit = unit_elems(elem_bytes, rotate)
    if k % unit or (rotate and k % 256):
        raise ValueError(f"rowquant kernel takes K % {256 if rotate else unit} == 0, got K={k}")
    if k > MAX_K:
        return RowquantPlan(MAX_THREADS, 1, 0, False)
    w = k // unit  # units per row
    slots = MAX_VALUES // unit
    target = 1 if rotate else 2
    block = BLOCK_TARGET // 2 if rotate else BLOCK_TARGET
    rows = 1
    while (rows * w < block * target and 2 * rows <= MAX_ROWS
           and -(-m // (2 * rows)) >= MIN_GROUPS_PER_SM * sms):
        rows *= 2
    cap = slots if rows == 1 else min(slots, ONE_ROW_UNITS)
    fill, threads, units = _threads_for(rows * w, cap, target)
    if not rotate and 2 * rows <= MAX_ROWS and -(-m // (2 * rows)) >= sms:
        fill2, threads2, units2 = _threads_for(2 * rows * w, min(slots, ONE_ROW_UNITS), target)
        if fill2 >= fill + 0.05:
            rows, threads, units = 2 * rows, threads2, units2
    if sr and not rotate and rows == 1 and m >= sms:
        n = -(-w // SR_THREADS)
        if n <= slots and w / (SR_THREADS * n) >= 0.9:
            threads, units = SR_THREADS, n
    stage = 4 * rows * k + 2 * k if sr else 0  # and Philox's 8 bytes per column group
    return RowquantPlan(threads, rows, units, fold and 4 * k <= FOLD_SMEM_MAX and 4 * k + stage <= SMEM_MAX)


def _launch(x: torch.Tensor, fold: Optional[torch.Tensor], seed: Optional[int], rotate: bool,
            plan: Optional[RowquantPlan] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One K2 launch on a checked CUDA input; ``plan`` overrides
    ``plan_rowquant`` (tests and measurements)."""
    from slam_llm_tpu_torch.kernels.build import check, library, sm_count, stream_ptr

    k = x.shape[-1]
    m = x.numel() // k if k else 0
    dev = x.device
    q = torch.empty(x.shape, dtype=torch.int8, device=dev)
    s = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=dev)
    if m == 0 or k == 0:
        return q, s.fill_(_EPS_AMAX / 127.0)
    plan = plan or plan_rowquant(m, k, x.element_size(), rotate, fold is not None, sm_count(dev.index),
                                 seed is not None)
    with torch.cuda.device(dev):
        err = library().slam_rowquant(
            x.data_ptr(), None if fold is None else fold.data_ptr(), q.data_ptr(), s.data_ptr(), m, k,
            int(x.dtype == torch.float32), int(rotate), int(seed is not None),
            (int(seed) & _MASK32) if seed is not None else 0, *plan, stream_ptr(x),
        )
    if err:  # the message is formatted only on failure: this path runs per decode step
        check(err, f"rowquant {plan}")
    return q, s


def rowquant(
    x: torch.Tensor,
    fold: Optional[torch.Tensor] = None,
    *,
    seed: Optional[int] = None,
    rotate: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last-axis) symmetric int8: ``(q int8 like x, s f32
    x.shape[:-1] + (1,))``. ``fold``: a (K,) f32 vector multiplied into x
    before quantizing; ``seed``: a uint32 switching to stochastic rounding;
    ``rotate``: the block-diagonal Hadamard before quantizing."""
    _check_fold(fold, rotate)
    if not x.is_cuda:
        return rowquant_ref(x, fold, seed=seed, rotate=rotate)
    if fold is not None:
        return rowquant_fold(x, fold, seed=seed)
    if seed is not None or rotate:
        return rowquant_rot_sr(x, seed=seed, rotate=rotate)
    _check_kernel_input(x, 8)
    out = _launch(x, None, None, False)
    rowquant.launches += 1
    rowquant.widths[x.shape[-1]] += 1
    return out


rowquant.launches = 0
rowquant.widths = collections.Counter()  # launches by row width K


def rowquant_rot_sr(
    x: torch.Tensor, *, seed: Optional[int] = None, rotate: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's rotate / stochastic-rounding kernel on a CUDA bf16 tensor.
    Rotation takes K % 256 == 0 (block 256, the only block the slice's
    widths give); without it K % 8 == 0."""
    if not x.is_cuda:
        return rowquant_ref(x, seed=seed, rotate=rotate)
    if rotate and rot_block(x.shape[-1]) != ROT_BLOCK:
        raise ValueError(f"rowquant rotate kernel takes K % {ROT_BLOCK} == 0, got K={x.shape[-1]}")
    _check_kernel_input(x, ROT_BLOCK if rotate else 8)
    out = _launch(x, None, seed, rotate)
    rowquant_rot_sr.launches += 1
    rowquant_rot_sr.widths[x.shape[-1]] += 1
    return out


rowquant_rot_sr.launches = 0
rowquant_rot_sr.widths = collections.Counter()  # launches by row width K


def rowquant_fold(
    x: torch.Tensor, fold: torch.Tensor, *, seed: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's fold kernel on a CUDA tensor: bf16 x with K % 8 == 0 or f32 x
    with K % 4 == 0, fold a contiguous (K,) f32 vector; deterministic
    rounding, or stochastic with ``seed``."""
    if not x.is_cuda:
        return rowquant_ref(x, fold, seed=seed)
    _check_kernel_input(x, 4 if x.dtype == torch.float32 else 8, (torch.bfloat16, torch.float32))
    k = x.shape[-1]
    if fold.shape != (k,) or fold.dtype != torch.float32 or not fold.is_contiguous() \
            or fold.data_ptr() % 16 or fold.device != x.device:
        raise ValueError(f"rowquant fold kernel takes a contiguous, 16-byte aligned f32 fold of shape ({k},) "
                         f"on {x.device}, got {fold.dtype}{tuple(fold.shape)} on {fold.device}")
    out = _launch(x, fold, seed, False)
    rowquant_fold.launches += 1
    rowquant_fold.widths[k] += 1
    return out


rowquant_fold.launches = 0
rowquant_fold.widths = collections.Counter()  # launches by row width K
