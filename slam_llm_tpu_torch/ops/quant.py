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
  rotated weight ``quant(W R)`` (K3): dx = (dy R)(W R)^T, R orthonormal;
* ``"int8_rot_otf"``: the same product with ``quant(W R)`` re-derived from
  ``(w_q, w_scale)`` inside the backward (``rotate_quantize_bwd`` of the
  dequantized weight, the chain ``quantize_base_params`` runs for the stored
  pair, so the two modes give the same dx bit for bit): no second copy;
* ``"int8_sr"`` / ``"int8"``: ``w_scale`` folded into dy and dy quantized per
  row (K2 fold; stochastic rounding with the seed, or round-half-even),
  then contracted with the int8 weight (K3): dx = (dy_q w_q) * s_dy.

Layout of the int8_sr / int8 dx product. K3 contracts the last axis of
both operands (``mma.sync`` s8 takes B only K-major, and ``ldmatrix`` has no
``.trans`` for 8-bit elements), but dx contracts ``w_q`` (F, K) over F. So
each such dense keeps ``kernel_qt`` (K, F) int8, the transpose of
``kernel_q``, as a non-persistent buffer that ``quantize_base_params``
derives and no checkpoint stores: one more byte per base parameter, as the
int8_rot pair costs. K3 gets a cached ``ones(K)`` as its column scale, so
its epilogue ``acc * s_dy * 1.0`` equals the reference's ``acc * s_dy``.

``int8_matmul`` sends CPU tensors to ``int8_matmul_ref`` and CUDA tensors to
``csrc/int8_matmul.cu`` (bf16 output, counted on ``int8_matmul.launches``;
f32 output through ``int8_matmul_f32``, counted on its own); it raises on
what the kernel does not take. ``plan_int8_matmul`` picks the kernel's code
path (wgmma at M >= 128, split-K below), its tile and its K splits; each
path counts its launches in ``K3_PATHS``, and each wrapper its launches by
``(K, F)`` in ``.widths``.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from slam_llm_tpu_torch.ops.kernels.rowquant import rotate_cols, rowquant

_EPS = 1e-30

# decoder dense modules whose frozen kernels are eligible for int8
PROJ_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
# the MLP subset: a "_mlp"-suffixed mode quantizes dy only here
MLP_PROJ_NAMES = ("gate_proj", "up_proj", "down_proj")
BWD_MODES = ("bf16", "int8_rot", "int8_rot_otf", "int8_sr", "int8")
# modes whose dy quantization rounds stochastically: a fresh seed per step
SR_MODES = ("int8_rot", "int8_rot_otf", "int8_sr")


def resolve_bwd(mode: str, proj_name: str) -> str:
    """Per-module dx mode. A ``_mlp``-suffixed mode applies the quantized
    backward to the MLP denses only and keeps the attention dx in bf16."""
    if mode.endswith("_mlp"):
        return mode[:-4] if proj_name in MLP_PROJ_NAMES else "bf16"
    return mode


def check_bwd_mode(mode: str) -> None:
    """Raise on a ``base_quant_bwd`` the reference does not define."""
    for name in PROJ_NAMES:
        if resolve_bwd(mode, name) not in BWD_MODES:
            raise ValueError(f"unknown base_quant_bwd {mode!r}: expected one of {BWD_MODES} or <mode>_mlp")


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
    """Derive, in place, every buffer that the backward contracts and no
    checkpoint stores, from the forward pair (``kernel_q``, ``kernel_scale``):
    an ``int8_rot`` dense's rotated pair (``kernel_qr``, ``kernel_scale_r``)
    from the DEQUANTIZED forward weight, so the backward approximates the
    matrix the forward used, and an ``int8_sr`` / ``int8`` dense's transpose
    ``kernel_qt``; and the int8 CE head of a ``ce_quant`` model
    (``head_q``, ``head_scale``, ``head_qt``, from ``head_weight()``). They are
    always re-derived, never trusted (a converter or loader may carry a stale
    copy). The port keeps ``kernel_scale_r`` in f32."""
    for mod in model.modules():
        if getattr(mod, "kernel_qr", None) is not None:
            qr, sr = rotated_pair(mod.kernel_q, mod.kernel_scale)
            mod.kernel_qr.copy_(qr)
            mod.kernel_scale_r.copy_(sr)
        if getattr(mod, "kernel_qt", None) is not None:
            mod.kernel_qt.copy_(mod.kernel_q.T)
        if getattr(mod, "head_q", None) is not None:
            q, scale = quantize_int8(mod.head_weight(), contract_axis=-1)  # per vocab row, over D
            mod.head_q.copy_(q)
            mod.head_scale.copy_(scale)
            mod.head_qt.copy_(q.T)
    return model


def dequantize_base_params(module: nn.Module, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The module's ``state_dict`` with every int8 base (``kernel_q``,
    ``kernel_scale``) replaced by its dequantized fp ``weight`` (F, K) in
    ``dtype``, the structure an fp model of the same config has (export,
    interop). Values are lossy-roundtripped. The module is not changed."""
    sd = dict(module.state_dict())
    for name in [n for n in sd if n.endswith(".kernel_q") or n == "kernel_q"]:
        base = name[: -len("kernel_q")]
        q, scale = sd.pop(name), sd.pop(base + "kernel_scale")
        sd[base + "weight"] = dequantize_int8(q, scale, contract_axis=-1, dtype=dtype)
    return sd


def rotated_pair(w_q: torch.Tensor, w_scale: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``int8_rot`` backward pair ``(quant(W R) (K, F), scale (K,))`` of
    the dequantized forward weight ``W = dequant(w_q (F, K), w_scale)^T``."""
    w = dequantize_int8(w_q, w_scale, contract_axis=-1)  # (F, K)
    return rotate_quantize_bwd(w.T)


def act_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row dynamic int8 of an activation (K2 on CUDA)."""
    return rowquant(x)


class SharedActQuant:
    """``act_quant(x)`` of one activation that several denses read (q / k /
    v, gate / up), formed at the first call and kept: the ``pre_quant`` the
    denses hand to ``int8_dot``. Lazy, so a checkpointed layer's replay in
    which every such dense takes its saved value quantizes nothing."""

    def __init__(self, x: torch.Tensor):
        self.x = x
        self._pair: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def __call__(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._pair is None:
            self._pair = act_quant(self.x)
        return self._pair


def int8_matmul_ref(
    x_q: torch.Tensor, w_q: torch.Tensor, x_s: torch.Tensor, w_scale: torch.Tensor,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Plain twin of K3. The s32 sum is formed in float64, where every partial
    sum of int8 products is an exact integer (|acc| < 2**53)."""
    acc = (x_q.double() @ w_q.double().T).float()
    return (acc * x_s.reshape(-1, 1) * w_scale).to(out_dtype)


class Int8Plan(NamedTuple):
    """How K3 runs one product: ``path`` "wgmma" (TMA + wgmma, tile 128 x
    256) or "splitk" (TMA + mma.sync, tile bm x 64, the splits of a tile one
    thread-block cluster), the tile ``(bm, bn, bk)`` with bk in bytes, and
    ``splits``, the number of parts K is cut into (a divisor of the 128-byte
    K slices)."""

    path: str
    tile: Tuple[int, int, int]
    splits: int


K_SLICE = 128  # bytes of K per pipeline stage, both paths
WGMMA_MIN_M = 128
# a wgmma split pays its partial-sum round trip only over a long K
WGMMA_MIN_SPLIT_SLICES = 32
# the split-K kernel's TMA ring by tile rows (sk_stages in csrc/int8_matmul.cu)
SPLITK_STAGES = {16: 6, 32: 6, 64: 4}
SPLITK_MAX_SPLITS = 16  # its splits form one thread-block cluster (non-portable above 8)


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


@functools.lru_cache(maxsize=4096)
def plan_int8_matmul(m: int, n: int, k: int, sms: int = 132) -> Int8Plan:
    """K3's path, tile and K splits for (M, K) x (N, K) on a card of ``sms``
    SMs. M >= 128 takes the wgmma path; where its tiles leave SMs idle and K
    is long, K is split too: the divisor of the K slices that fills the last
    wave best while each split keeps at least ``WGMMA_MIN_SPLIT_SLICES``.
    Smaller M takes split-K, bound by the bytes of the weight: K is cut (into
    at most 16 parts, one cluster) so that each block's slices fit its ring
    at once (one round trip to memory), and into more parts while the grid
    has fewer than one and a half blocks per SM. A split product reduces in
    s32, so no plan changes the result."""
    k_slices = -(-k // K_SLICE)
    if m >= WGMMA_MIN_M:
        tiles = -(-m // 128) * -(-n // 256)

        def fill(d):
            units = tiles * d
            return units / (-(-units // sms) * sms)

        splits = max((d for d in _divisors(k_slices) if d == 1 or k_slices // d >= WGMMA_MIN_SPLIT_SLICES),
                     key=lambda d: (fill(d), -d))
        return Int8Plan("wgmma", (128, 256, K_SLICE), splits)
    bm = 16 if m <= 16 else 32 if m <= 32 else 64
    tiles = -(-m // bm) * -(-n // 64)
    # a cluster of more than 8 (non-portable) pays only for 16-row tiles (measured)
    divs = [d for d in _divisors(k_slices) if d <= (SPLITK_MAX_SPLITS if bm == 16 else 8)]
    fits = [d for d in divs if -(-k_slices // d) <= SPLITK_STAGES[bm]] or divs[-1:]
    splits = next((d for d in fits if 2 * tiles * d >= 3 * sms), fits[-1])
    return Int8Plan("splitk", (bm, 64, K_SLICE), splits)


@dataclasses.dataclass
class PathCount:
    launches: int = 0


# launches per K3 code path (beside the per-epilogue counts on the wrappers)
K3_PATHS = {"wgmma": PathCount(), "splitk": PathCount()}


_counters = {}  # device index -> s32 tile counters of split wgmma products, 0 between calls


def _split_counters(device: torch.device, tiles: int) -> torch.Tensor:
    """The per-tile counters a split wgmma product's blocks count on. The
    kernel leaves them 0 again, so one zeroed tensor per device serves every
    call (calls on one device run in stream order)."""
    have = _counters.get(device.index)
    if have is None or have.numel() < tiles:
        have = _counters[device.index] = torch.zeros(max(tiles, 4096), dtype=torch.int32, device=device)
    return have


def _tiles(plan: Int8Plan, m: int, n: int) -> int:
    bm, bn, _ = plan.tile
    return -(-m // bm) * -(-n // bn)


def _int8_matmul_launch(x_q, w_q, x_s, w_scale, out_dtype: torch.dtype, plan: Optional[Int8Plan] = None):
    m, k = x_q.shape
    f = w_q.shape[0]
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8 or w_q.shape != (f, k):
        raise TypeError(f"int8_matmul takes int8 (M, K) x (F, K), got {x_q.dtype}{tuple(x_q.shape)} "
                        f"x {w_q.dtype}{tuple(w_q.shape)}")
    if x_s.dtype != torch.float32 or w_scale.dtype != torch.float32 or x_s.numel() != m \
            or w_scale.shape != (f,):
        raise TypeError("int8_matmul takes f32 scales x_s (M,) and w_scale (F,)")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"int8_matmul kernel writes bfloat16 or float32, got {out_dtype}")
    if k % 16 or not all(t.is_contiguous() for t in (x_q, w_q, x_s, w_scale)) \
            or x_q.data_ptr() % 16 or w_q.data_ptr() % 16:
        raise ValueError("int8_matmul kernel needs contiguous, 16-byte aligned operands and K % 16 == 0")
    out = torch.empty((m, f), dtype=out_dtype, device=x_q.device)
    if out.numel() == 0:
        return out
    from slam_llm_tpu_torch.kernels.build import check, library, sm_count, stream_ptr

    sms = sm_count(x_q.device.index)
    plan = plan or plan_int8_matmul(m, f, k, sms)
    scratch = counters = None
    if plan.path == "wgmma" and plan.splits > 1:  # (splits, M, N) partial sums, and a counter per tile
        scratch = torch.empty((plan.splits, m, f), dtype=torch.int32, device=x_q.device)
        counters = _split_counters(x_q.device, _tiles(plan, m, f))
    with torch.cuda.device(x_q.device):
        err = library().slam_int8_matmul(
            x_q.data_ptr(), w_q.data_ptr(), x_s.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), None if counters is None else counters.data_ptr(),
            m, f, k, int(out_dtype == torch.float32), 0 if plan.path == "wgmma" else 1, plan.tile[0], plan.splits,
            sms, stream_ptr(x_q),
        )
    check(err, f"int8_matmul {plan}")
    K3_PATHS[plan.path].launches += 1
    return out


def int8_matmul(
    x_q: torch.Tensor, w_q: torch.Tensor, x_s: torch.Tensor, w_scale: torch.Tensor,
    out_dtype: torch.dtype = torch.bfloat16, plan: Optional[Int8Plan] = None,
) -> torch.Tensor:
    """x_q (M, K) int8, w_q (F, K) int8, x_s (M,) or (M, 1) f32, w_scale (F,)
    f32 -> (M, F) ``out_dtype``; the kernel writes bfloat16, or float32
    through ``int8_matmul_f32``. ``plan`` overrides ``plan_int8_matmul``
    (tests and measurements)."""
    if not x_q.is_cuda:
        return int8_matmul_ref(x_q, w_q, x_s, w_scale, out_dtype)
    if out_dtype == torch.float32:
        return int8_matmul_f32(x_q, w_q, x_s, w_scale, plan)
    out = _int8_matmul_launch(x_q, w_q, x_s, w_scale, out_dtype, plan)
    int8_matmul.launches += 1
    int8_matmul.widths[tuple(reversed(w_q.shape))] += 1
    return out


int8_matmul.launches = 0
int8_matmul.widths = collections.Counter()  # launches by (K, F)


def int8_matmul_f32(
    x_q: torch.Tensor, w_q: torch.Tensor, x_s: torch.Tensor, w_scale: torch.Tensor,
    plan: Optional[Int8Plan] = None,
) -> torch.Tensor:
    """K3 with the f32 epilogue (the int8 CE head's logits, and dx in f32)."""
    if not x_q.is_cuda:
        return int8_matmul_ref(x_q, w_q, x_s, w_scale, torch.float32)
    out = _int8_matmul_launch(x_q, w_q, x_s, w_scale, torch.float32, plan)
    int8_matmul_f32.launches += 1
    int8_matmul_f32.widths[tuple(reversed(w_q.shape))] += 1
    return out


int8_matmul_f32.launches = 0
int8_matmul_f32.widths = collections.Counter()  # launches by (K, F)


@functools.lru_cache(maxsize=None)
def unit_scale(n: int, device: torch.device) -> torch.Tensor:
    """A cached ``ones(n)`` f32: K3's column scale where the reference
    applies the row scale alone."""
    return torch.ones(n, dtype=torch.float32, device=device)


PreQuant = Callable[[], Tuple[torch.Tensor, torch.Tensor]]


def int8_linear(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                pre_quant: Optional[PreQuant] = None) -> torch.Tensor:
    """Forward of the reference's ``int8_dot``: ``x (..., K) @ dequant(w_q)^T``
    computed s8 x s8, returned in x's dtype; ``pre_quant`` returns x's
    ``act_quant`` pair."""
    k = x.shape[-1]
    x_q, x_s = act_quant(x) if pre_quant is None else pre_quant()
    y = int8_matmul(x_q.reshape(-1, k), w_q, x_s.reshape(-1), w_scale, x.dtype)
    return y.reshape(*x.shape[:-1], w_q.shape[0])


def int8_dx(dy: torch.Tensor, bwd: str, seed: int, out_dtype: torch.dtype, w_q, w_scale, w_aux=None):
    """dx (M, K) of ``dy (M, F) @ dequant(w_q (F, K))`` in a quantized mode:
    ``w_aux`` is the rotated pair (int8_rot), or ``kernel_qt`` (int8_sr /
    int8); int8_rot_otf derives the rotated pair here."""
    if bwd in ("int8_rot", "int8_rot_otf"):
        wr_q, wr_scale = w_aux if bwd == "int8_rot" else rotated_pair(w_q, w_scale)
        z, s_dy = rowquant(dy, seed=seed, rotate=True)
        return int8_matmul(z, wr_q, s_dy.reshape(-1), wr_scale, out_dtype)
    z, s_dy = rowquant(dy, w_scale, seed=seed if bwd == "int8_sr" else None)
    return int8_matmul(z, w_aux, s_dy.reshape(-1), unit_scale(w_aux.shape[0], w_aux.device), out_dtype)


class _Int8Dot(torch.autograd.Function):
    """``int8_linear`` with the straight-through gradient to ``x``. Saves
    the frozen weights the backward contracts (buffers, no copy) and never
    the activation or its int8 form; the stochastic-rounding seed is a
    plain int fixed when the forward ran, so a checkpointed layer's replay
    reads the same one. With ``out`` the forward returns ``out`` instead of
    computing the product (a replay that already holds the value, or whose
    value nothing reads), and never asks ``pre_quant`` for x's int8 form."""

    @staticmethod
    def forward(ctx, x, w_q, w_scale, w_aux_a, w_aux_b, bwd: str, seed: int, out, pre_quant):
        ctx.bwd, ctx.seed, ctx.x_dtype = bwd, seed, x.dtype
        if bwd == "int8_rot":
            ctx.save_for_backward(w_aux_a, w_aux_b)
        elif bwd in ("int8_sr", "int8"):
            ctx.save_for_backward(w_q, w_scale, w_aux_a)
        else:
            ctx.save_for_backward(w_q, w_scale)
        return int8_linear(x, w_q, w_scale, pre_quant) if out is None else out

    @staticmethod
    def backward(ctx, dy):
        f = dy.shape[-1]
        dy2 = dy.reshape(-1, f).contiguous()
        if ctx.bwd == "int8_rot":
            wr_q, wr_scale = ctx.saved_tensors
            dx = int8_dx(dy2, "int8_rot", ctx.seed, ctx.x_dtype, None, None, (wr_q, wr_scale))
        elif ctx.bwd == "bf16":
            w, scale = ctx.saved_tensors
            # the dequantized weight in bf16, contracted with f32 accumulation:
            # an f32 x keeps the f32 sum, a bf16 x rounds it once
            acc = torch.float32 if ctx.x_dtype == torch.float32 else torch.bfloat16
            wd = dequantize_int8(w, scale, contract_axis=-1, dtype=torch.bfloat16)
            dx = torch.matmul(dy2.to(torch.bfloat16).to(acc), wd.to(acc)).to(ctx.x_dtype)
        else:
            dx = int8_dx(dy2, ctx.bwd, ctx.seed, ctx.x_dtype, *ctx.saved_tensors)
        return dx.reshape(*dy.shape[:-1], dx.shape[-1]), None, None, None, None, None, None, None, None


def int8_dot(
    x: torch.Tensor,
    w_q: torch.Tensor,
    w_scale: torch.Tensor,
    *,
    bwd: str = "bf16",
    seed: Optional[int] = None,
    w_rot: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    w_t: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
    pre_quant: Optional[PreQuant] = None,
) -> torch.Tensor:
    """``x @ dequant(w_q)^T`` computed s8 x s8, differentiable in ``x``.

    x (..., K); w_q int8 (F, K); w_scale f32 (F,). ``bwd="int8_rot"`` needs
    ``w_rot=(wr_q (K, F) int8, wr_scale (K,) f32)`` from
    ``rotate_quantize_bwd``; ``"int8_sr"`` and ``"int8"`` need ``w_t``, the
    (K, F) transpose of ``w_q``. The stochastic modes take a uint32 ``seed``,
    fresh per step. ``out``: the product's value, already known (see
    ``_Int8Dot``). ``pre_quant``: a callable returning ``act_quant(x)``'s
    ``(x_q, x_s)`` (``SharedActQuant``), asked only when the product is
    computed: denses over one input quantize it once, as with the
    reference's ``pre_quant``. The gradient flows through ``x`` alone."""
    if bwd not in BWD_MODES:
        raise ValueError(f"int8_dot bwd={bwd!r}: expected one of {BWD_MODES}")
    if bwd == "int8_rot" and w_rot is None:
        raise ValueError("int8_dot bwd='int8_rot' needs w_rot=(wr_q, wr_scale)")
    if bwd in ("int8_sr", "int8") and w_t is None:
        raise ValueError(f"int8_dot bwd={bwd!r} needs w_t, the (K, F) transpose of w_q")
    if not (torch.is_grad_enabled() and x.requires_grad):
        return int8_linear(x, w_q, w_scale, pre_quant) if out is None else out  # no backward to prepare for
    aux_a, aux_b = w_rot if w_rot is not None else (w_t, None)
    return _Int8Dot.apply(x, w_q, w_scale, aux_a, aux_b, bwd, 0 if seed is None else int(seed), out, pre_quant)
