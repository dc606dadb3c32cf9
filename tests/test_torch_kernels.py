"""Kernel twins of slam_llm_tpu_torch against the JAX package's kernels.

On the CPU each wrapper runs its plain PyTorch twin; the same numpy inputs go
through the JAX function (Pallas in interpret mode, or its XLA expression)
and the twin. The CUDA kernels against their twins: tests/test_torch_gpu.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_llm_tpu.ops import quant as jquant
from slam_llm_tpu.ops.kernels.flash_attention import _flash_fwd
from slam_llm_tpu.ops.kernels.rowquant import rowquant as jrowquant
from slam_llm_tpu_torch.ops import quant as tquant
from slam_llm_tpu_torch.ops.kernels import flash_attention as tflash
from slam_llm_tpu_torch.ops.kernels import rowquant as trowquant


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- K1 flash-attention forward ----------------------------------------


@pytest.mark.parametrize(
    "t,h,hkv,causal,pad",
    [
        (200, 4, 4, False, "right"),  # ragged T, MHA (whisper-like)
        (128, 4, 2, True, "left"),  # GQA causal prefill, left-padded prompts
        (130, 2, 1, True, "none"),  # MQA, ragged causal
    ],
)
def test_flash_twin_matches_pallas_forward(t, h, hkv, causal, pad):
    """Twin vs the Pallas forward (interpret mode), f32: out and live-row lse
    within 1e-5 abs; rows with no visible key exactly 0 in both."""
    rng = np.random.default_rng(t + h)
    b, d = 2, 64
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    mask = np.ones((b, t), np.int32)
    if pad == "right":
        mask[1, t - 37:] = 0
    elif pad == "left":
        mask[0, :29] = 0
    scale = 1.0 / np.sqrt(d)
    j_out, j_lse = _flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), causal, scale,
        128, 128, True,
    )
    t_out, t_lse = tflash.flash_attention_fwd(_t(q), _t(k), _t(v), _t(mask), causal)
    live = mask.cumsum(1) > 0 if causal else np.ones((b, t), bool)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_lse.numpy()[live], np.asarray(j_lse)[live], atol=1e-5, rtol=0)
    assert np.all(t_out.numpy()[~live] == 0) and np.all(np.asarray(j_out)[~live] == 0)


def test_flash_wrapper_uses_twin_on_cpu_and_checks_causal_shapes():
    q = torch.randn(1, 8, 2, 64)
    k = torch.randn(1, 8, 2, 64)
    mask = torch.ones(1, 8, dtype=torch.int32)
    before = tflash.flash_attention_fwd.launches
    out = tflash.flash_attention_fwd(q, k, k, mask, causal=True)[0]
    ref, _ = tflash.flash_attention_ref(q, k, k, mask, causal=True)
    assert torch.equal(out, ref) and tflash.flash_attention_fwd.launches == before
    with pytest.raises(ValueError, match="tq == tk"):
        tflash.flash_attention_fwd(q[:, :4], k, k, mask, causal=True)


def test_tf32_split_reconstructs_f32():
    """``tf32_split``: hi and lo keep TF32's 10 mantissa bits (the low 13
    bits of each are 0), hi is x rounded to nearest with ties away from
    zero, and hi + lo is within 2^-22 of x relative, over 23 binades and
    the ties."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(200_000) * np.exp(rng.uniform(-8, 8, 200_000))).astype(np.float32))
    ties = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 3 * 2.0 ** -11), 3.0 + 2.0 ** -10], dtype=torch.float32)
    hi, lo = tflash.tf32_split(torch.cat([x, ties]))
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    full = torch.cat([x, ties]).double()
    assert ((hi.double() + lo.double() - full).abs() <= 2.0 ** -22 * full.abs()).all()
    assert ((hi.double() - full).abs() <= 2.0 ** -11 * full.abs()).all()
    assert hi[-3:].tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2 * 2.0 ** -10), 3.0 + 2.0 ** -9]


def _mm3(eq, a, b):
    """einsum ``eq`` of f32 a and b as the f32 kernels take each product:
    3-pass split TF32, the small terms first, f32 sums."""
    ah, al = tflash.tf32_split(a)
    bh, bl = tflash.tf32_split(b)
    return (torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)) + torch.einsum(eq, ah, bh)


@pytest.mark.parametrize("d", [64, 128])
def test_3xtf32_attention_within_the_f32_limits(d):
    """The f32 routes' numeric scheme, before any card: forward and backward
    at (2, 515, 2/2, D) with every product (S, O, dP, dq, dk, dv) taken as
    3xTF32, against the f32 twins (themselves held to the JAX package
    above): S and dP within 2e-5 of their largest entry, out within 2e-5
    abs, dq / dk / dv within 2e-5 of the twin's largest entry, the limits
    the card tests hold the kernels to. The tensor core's own rounding of
    its sums is not modelled: only the card shows it."""
    rng = np.random.default_rng(1)
    b, t, h = 2, 515, 2
    q, k, v, dout = (torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(np.float32)) for _ in range(4))
    mask = torch.ones(b, t, dtype=torch.int32)
    mask[1, 400:] = 0
    scale = 1.0 / np.sqrt(d)
    scale2 = float(np.float32(scale * tflash.LOG2E))
    valid = mask.bool()[:, None, None, :]
    out, lse = tflash.flash_attention_ref(q, k, v, mask)
    # forward: q pre-scaled into the exp2 domain, as K1 f32 stages it
    s = _mm3("bqhd,bkhd->bhqk", q * scale2, k)
    s_ref = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale2
    assert (s - s_ref).abs().max() <= 2e-5 * s_ref.abs().max()
    s = torch.where(valid, s, torch.full_like(s, tflash.NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    o = _mm3("bhqk,bkhd->bqhd", p, v) / p.sum(-1).permute(0, 2, 1)[..., None]
    assert (o - out).abs().max() <= 2e-5
    # backward on the twin's out / lse
    dq_ref, dk_ref, dv_ref = tflash.flash_attention_bwd_ref(q, k, v, mask, out, lse, dout)
    s = _mm3("bqhd,bkhd->bhqk", q, k) * scale2
    p = torch.where(valid, torch.exp2(s - lse.permute(0, 2, 1)[..., None]), 0.0)
    dp = _mm3("bqhd,bkhd->bhqk", dout, v)
    dp_ref = torch.einsum("bqhd,bkhd->bhqk", dout, v)
    assert (dp - dp_ref).abs().max() <= 2e-5 * dp_ref.abs().max()
    delta = (dout * out).sum(-1).permute(0, 2, 1)[..., None]
    ds = p * (dp - delta)
    got = (_mm3("bhqk,bkhd->bqhd", ds, k) * scale, _mm3("bhqk,bqhd->bkhd", ds, q) * scale,
           _mm3("bhqk,bqhd->bkhd", p, dout))
    for g, w in zip(got, (dq_ref, dk_ref, dv_ref)):
        assert (g - w).abs().max() <= 2e-5 * w.abs().max()


@pytest.mark.parametrize("t", [1, 70])
def test_bwd_f32_error_passes_f32_against_f64(t):
    """``bwd_f32_error``, the measure K4 f32 is held to (2e-5) on the card:
    the f32 twin against causal GQA attention's autograd in f64 passes it
    at T = 1 (dS = 0 exactly, so dq and dk are the cancellation's
    round-off) as at T = 70; one dq entry off by 1e-2 does not."""
    rng = np.random.default_rng(2)
    q, dout = (rng.standard_normal((3, t, 4, 64)) for _ in range(2))
    k, v = (rng.standard_normal((3, t, 2, 64)) for _ in range(2))
    qd, kd, vd = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd.repeat_interleave(2, 2)) / 8.0
    s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), -math.inf)
    o = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), vd.repeat_interleave(2, 2))
    want = torch.autograd.grad(o, (qd, kd, vd), torch.from_numpy(dout))
    q, k, v, dout = (torch.from_numpy(x.astype(np.float32)) for x in (q, k, v, dout))
    mask = torch.ones(3, t, dtype=torch.int32)
    got = tflash.flash_attention_bwd_ref(q, k, v, mask, *tflash.flash_attention_ref(q, k, v, mask, True), dout, True)
    assert tflash.bwd_f32_error(got, want, q, k, v, dout) <= 2e-5
    off = got[0].clone()
    off[0, 0, 0, 0] += 1e-2
    assert tflash.bwd_f32_error((off, *got[1:]), want, q, k, v, dout) > 2e-5


# the slices' shapes (B, Tq, Tk, H, Hkv, D, causal, rope), then edges: cross
# attention, T = 1, G = 3, G above a unit's 128 rows, D = 128
FLASH_PLAN_SHAPES = [
    (8, 1500, 1500, 12, 12, 64, False, False),  # whisper-small encoder, decode batch
    (16, 1500, 1500, 12, 12, 64, False, False),  # the same, training batch
    (8, 512, 512, 32, 4, 64, True, False),  # TinyLlama prefill
    (16, 512, 512, 32, 4, 64, True, True),  # TinyLlama training, fused RoPE
    (2, 70, 200, 4, 2, 64, False, False),
    (2, 1, 1, 8, 1, 128, True, False),
    (3, 449, 449, 12, 4, 128, True, True),
    (1, 70, 70, 256, 1, 64, True, False),
]


@pytest.mark.parametrize("shape", FLASH_PLAN_SHAPES)
def test_flash_plan_covers_every_row_once_and_fits(shape):
    """K1's and dq's units cover every (batch, position, head) row exactly
    once; dk/dv's cover every key of every kv head; every pass fits the
    card's 227 KB of shared memory; G >= 2 heads are packed into a unit."""
    b, tq, tk, h, hkv, d, causal, rope = shape
    plan = tflash.plan_flash(*shape)
    for p in (plan.fwd, plan.dq):
        if p is None:
            continue
        count = torch.zeros(b, tq, h, dtype=torch.int32)
        for u in range(p.units):
            bb, pos, head = tflash.unit_rows(p, b, tq, h, u)
            count[bb, pos, head] += 1
        assert bool((count == 1).all())
        assert p.heads * p.positions <= p.rows
        assert (h // hkv) % p.heads == 0 and p.heads >= min(h // hkv, 2)
        assert p.smem_bytes <= tflash.SMEM_LIMIT
    assert plan.fwd.grid == min(plan.fwd.units, 132)
    assert (plan.dq is None) == (tq != tk) == (plan.dkv is None)
    if plan.dkv is not None:  # K4's two passes: one launch, one grid
        assert plan.dkv.units * plan.dkv.rows >= tk * hkv * b and plan.dkv.units == -(-tk // 128) * hkv * b
        assert plan.dq.grid == plan.dkv.grid == min(plan.dq.units + plan.dkv.units, 132)
        assert plan.dkv.smem_bytes == plan.dq.smem_bytes <= tflash.SMEM_LIMIT


def test_flash_plan_at_the_slices_shapes():
    """The plans PERF.md names: 128-row units, 128 positions of one head at
    whisper's G = 1, 16 positions x 8 heads at TinyLlama's G = 8; K1 takes
    128-key tiles through 3 stages without the causal mask at D = 64, else
    64-key tiles (4 stages, 3 at D = 128); dk/dv 3 stages (2 at D = 128);
    causal units longest first; and the planner refuses what the kernels do
    not take."""
    whisper = tflash.plan_flash(8, 1500, 1500, 12, 12, 64, False, False)
    assert whisper.fwd == tflash.PassPlan(128, 1, 128, 128, 3, 1152, 132, False, 150656)
    assert whisper.dq == tflash.PassPlan(128, 1, 128, 64, 3, 1152, 132, False, 115880)
    assert whisper.dkv == tflash.PassPlan(128, 1, 0, 64, 3, 1152, 132, False, 115880)
    prefill = tflash.plan_flash(8, 512, 512, 32, 4, 64, True, False)
    assert prefill.fwd == tflash.PassPlan(128, 8, 16, 64, 4, 1024, 132, True, 117888)
    train = tflash.plan_flash(16, 512, 512, 32, 4, 64, True, True)
    assert train.fwd.units == 2048 and train.dq.units == 2048 and train.dkv.units == 256
    wide = tflash.plan_flash(2, 512, 512, 32, 32, 128, True, False)
    assert (wide.fwd.tile, wide.fwd.stages, wide.dq.stages, wide.dkv.stages) == (64, 3, 3, 2)
    assert max(wide.fwd.smem_bytes, wide.dq.smem_bytes, wide.dkv.smem_bytes) <= tflash.SMEM_LIMIT
    for bad in ((2, 64, 64, 4, 4, 32, False, False), (2, 64, 64, 6, 4, 64, False, False),
                (2, 64, 80, 4, 4, 64, True, False), (2, 64, 80, 4, 4, 64, False, True),
                (2, 0, 0, 4, 4, 64, False, False)):
        with pytest.raises(ValueError):
            tflash.plan_flash(*bad)


# ---- K2 rowquant -----------------------------------------------------------


def _rowquant_inputs(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((37, 256)) * 3).astype(np.float32)
    x[0] = 0.0  # all-zero row: s = 1e-28 / 127, q = 0
    # exact .5 ties: amax 127 makes s == 1, so x / s == x
    x[1] = (np.arange(256) % 254 - 127) + 0.5
    x[1, 0] = 127.0
    x[2] = x[1] * 1e-3  # ties that land after a true division
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rowquant_twin_bit_exact_against_jax(dtype):
    x = _rowquant_inputs(np.float32)
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = jrowquant(jx)
    tq, ts = trowquant.rowquant(tx)
    assert tq.dtype == torch.int8 and ts.shape == (37, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert np.all(tq.numpy()[0] == 0)


def test_rowquant_training_variants_not_ported():
    """Every training variant runs on the twin: ``fold`` (the int8 / int8_sr
    backward modes and the int8 CE head) bit-exact against the reference's
    ``rowquant(x, fold)`` with and without a seed's stochastic rounding
    (the seeded streams differ, so only the scale is compared there), seed
    and rotate; ``fold`` with ``rotate`` raises as in the reference."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((5, 32)).astype(np.float32)
    fold = rng.uniform(0.1, 3.0, 32).astype(np.float32)
    jq, js = jrowquant(jnp.asarray(x), jnp.asarray(fold))
    tq, ts = trowquant.rowquant(_t(x), _t(fold))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    _, js_sr = jrowquant(jnp.asarray(x), jnp.asarray(fold), seed=jnp.uint32(3))
    q_sr, ts_sr = trowquant.rowquant(_t(x), _t(fold), seed=3)
    np.testing.assert_array_equal(ts_sr.numpy(), np.asarray(js_sr))
    assert (q_sr.int() - tq.int()).abs().max() <= 1
    with pytest.raises(ValueError, match="mutually exclusive"):
        trowquant.rowquant(_t(x), fold=_t(fold), rotate=True)
    for kw in ({"seed": 0}, {"rotate": True}, {"seed": 7, "rotate": True}):
        q, s = trowquant.rowquant(_t(x), **kw)
        assert q.dtype == torch.int8 and q.shape == x.shape and s.shape == (5, 1)
        assert q.abs().max() <= 127


# ---- K3 int8 GEMM + int8_linear ------------------------------------------


def test_quantize_int8_matches_jax():
    w = np.random.default_rng(1).standard_normal((48, 24)).astype(np.float32)
    jq, js = jquant.quantize_int8(jnp.asarray(w))
    tq, ts = tquant.quantize_int8(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    deq = tquant.dequantize_int8(tq, ts)
    np.testing.assert_allclose(deq.numpy(), np.asarray(jquant.dequantize_int8(jq, js)), rtol=0, atol=0)


def test_int8_matmul_twin_is_exact_integer_product():
    rng = np.random.default_rng(2)
    xq = rng.integers(-127, 128, (9, 5632), dtype=np.int8)
    wq = rng.integers(-127, 128, (7, 5632), dtype=np.int8)
    xs = rng.random(9).astype(np.float32)
    ws = rng.random(7).astype(np.float32)
    acc = xq.astype(np.int64) @ wq.astype(np.int64).T
    want = acc.astype(np.float32) * xs[:, None] * ws[None, :]
    got = tquant.int8_matmul(_t(xq), _t(wq), _t(xs), _t(ws), torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


# the shapes chip_smoke.py phase 3 checks (M, K, N), and edge shapes
K3_PHASE3_SHAPES = [(m, kc, n) for m in (4096, 32, 8, 3584)
                    for kc, n in ((2048, 2048), (2048, 256), (2048, 5632), (5632, 2048))]
K3_PHASE3_SHAPES += [(8192, kc, n) for kc, n in ((2048, 2048), (256, 2048), (5632, 2048), (2048, 5632))]
K3_PHASE3_SHAPES += [(1024, 32000, 2048), (1024, 2048, 32000), (37, 48, 40)]
K3_EDGE_SHAPES = [(m, 48, 40) for m in (1, 16, 17, 64, 65, 127, 128)] + [(300, 5632, 2048), (129, 2064, 264)]
K3_EDGE_SHAPES += [(64, 32000, 2048), (100, 5632, 2048)]


@pytest.mark.parametrize("m,k,n", K3_PHASE3_SHAPES + K3_EDGE_SHAPES)
def test_k3_planner_picks_a_path_the_kernel_takes(m, k, n):
    """wgmma (tile 128 x 256) from M = 128 up, split-K below; the splits
    divide the 128-byte K slices, stay within a cluster on the split-K path,
    and on the wgmma path split only K long enough to pay its round trip."""
    plan = tquant.plan_int8_matmul(m, n, k, 132)
    slices = -(-k // tquant.K_SLICE)
    assert slices % plan.splits == 0
    if m >= 128:
        assert plan.path == "wgmma" and plan.tile == (128, 256, 128)
        assert plan.splits == 1 or slices // plan.splits >= tquant.WGMMA_MIN_SPLIT_SLICES
    else:
        assert plan.path == "splitk" and plan.tile[1:] == (64, 128)
        bm = plan.tile[0]
        assert bm in (16, 32, 64) and (bm >= m or bm == 64) and (bm == 16 or bm // 2 < m)
        assert 1 <= plan.splits <= tquant.SPLITK_MAX_SPLITS


def test_k3_planner_fills_the_card_where_it_should():
    """The CE head's dx (8 x 8 tiles of 128 x 256) splits K in two: 128 units
    on 132 SMs; decode cuts K = 2048 so a block's share fits the split-K ring
    (4 parts), and into 8 where 32 column tiles would leave the grid under
    one and a half blocks per SM; the training shapes run unsplit."""
    assert tquant.plan_int8_matmul(1024, 2048, 32000, 132).splits == 2
    assert tquant.plan_int8_matmul(32, 5632, 2048, 132) == tquant.Int8Plan("splitk", (32, 64, 128), 4)
    assert tquant.plan_int8_matmul(8, 2048, 2048, 132) == tquant.Int8Plan("splitk", (16, 64, 128), 8)
    for n, k in ((2048, 2048), (2048, 5632), (5632, 2048), (2048, 256)):
        assert tquant.plan_int8_matmul(8192, n, k, 132).splits == 1


def _split_k_emulation(xq, wq, xs, ws, plan, out_dtype):
    """K3's arithmetic for one plan on the CPU: per-split s32 partial sums over
    the plan's 128-byte K slices, added in split order, then the epilogue."""
    k = xq.shape[1]
    per = -(-k // tquant.K_SLICE) // plan.splits * tquant.K_SLICE
    acc = torch.zeros(xq.shape[0], wq.shape[0], dtype=torch.int32)
    for s in range(plan.splits):
        part = slice(s * per, min((s + 1) * per, k))
        acc += (xq[:, part].to(torch.int64) @ wq[:, part].to(torch.int64).T).to(torch.int32)
    return (acc.float() * xs.reshape(-1, 1) * ws).to(out_dtype)


@pytest.mark.parametrize("m,k,n", [(8, 2048, 96), (32, 5632, 40), (37, 48, 40), (300, 4096, 264), (129, 2064, 264)])
def test_k3_split_k_s32_reduction_equals_the_twin(m, k, n):
    """Any split of K reaches the epilogue with the same integer: the
    emulation of every plan the path allows equals int8_matmul_ref bit for
    bit, f32 and bf16."""
    rng = np.random.default_rng(m + k + n)
    xq = _t(rng.integers(-127, 128, (m, k), dtype=np.int8))
    wq = _t(rng.integers(-127, 128, (n, k), dtype=np.int8))
    xs = _t(rng.random(m).astype(np.float32) * 0.05 + 1e-3)
    ws = _t(rng.random(n).astype(np.float32) * 0.01 + 1e-4)
    plan = tquant.plan_int8_matmul(m, n, k, 132)
    slices = -(-k // tquant.K_SLICE)
    for d in [d for d in range(1, 9) if slices % d == 0]:
        alt = tquant.Int8Plan(plan.path, plan.tile, d)
        for dt in (torch.float32, torch.bfloat16):
            assert torch.equal(_split_k_emulation(xq, wq, xs, ws, alt, dt), tquant.int8_matmul_ref(xq, wq, xs, ws, dt))


def test_int8_linear_matches_jax_int8_dot_forward():
    """fp32, within 1e-6 relative of the reference's s8 product + epilogue."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal((64, 48)).astype(np.float32) * 0.1
    jq, js = jquant.quantize_int8(jnp.asarray(w))  # (K, F) int8, (F,)
    want = np.asarray(jquant.int8_dot(jnp.asarray(x), jq, js, bwd="bf16"))
    got = tquant.int8_linear(_t(x), _t(np.asarray(jq).T.copy()), _t(js))
    assert got.shape == (2, 5, 48) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_kernel_build_raises_without_nvcc(monkeypatch):
    from slam_llm_tpu_torch.kernels import build

    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build, "library_path", lambda: build.BUILD_DIR / "absent.so")
    if __import__("os").path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this host has nvcc under /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


def test_jax_runs_on_cpu_here():
    assert jax.default_backend() == "cpu"


@pytest.mark.parametrize("bwd", ["bf16", "int8_rot", "int8_sr"])
def test_int8_dot_pre_quant_is_the_same_product(bwd):
    """``int8_dot`` with ``pre_quant`` (a callable returning the pair, or
    the lazy shared form) is bit-equal to the one that quantizes x itself,
    forward and dx; and equals the reference's ``int8_dot`` with
    ``pre_quant`` within 1e-6 relative (f32)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 256)).astype(np.float32)
    w = rng.standard_normal((256, 512)).astype(np.float32) * 0.1
    jq, js = jquant.quantize_int8(jnp.asarray(w))
    wq, ws = _t(np.asarray(jq).T.copy()), _t(js)
    aux = dict(w_rot=tquant.rotated_pair(wq, ws)) if bwd == "int8_rot" else dict(w_t=wq.T.contiguous())
    dy = torch.from_numpy(rng.standard_normal((2, 5, 512)).astype(np.float32))
    outs = []
    for pre in (None, "pair", "shared"):
        xt = _t(x).requires_grad_(True)
        pair = tquant.act_quant(xt.detach())
        pq = {"pair": lambda: pair, "shared": tquant.SharedActQuant(xt.detach())}.get(pre)
        y = tquant.int8_dot(xt, wq, ws, bwd=bwd, seed=9, pre_quant=pq, **aux)
        (dx,) = torch.autograd.grad(y, xt, dy)
        outs.append((y.detach(), dx))
    for y, dx in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(dx, outs[0][1])
    xj = jnp.asarray(x)
    want = np.asarray(jquant.int8_dot(xj, jq, js, bwd="bf16", pre_quant=jquant.act_quant(xj)))
    np.testing.assert_allclose(outs[0][0].numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("m,k,elem,rotate,fold", [
    (8192, 2048, 2, False, False), (4096, 5632, 2, False, False), (32, 2048, 2, False, False),
    (32, 5632, 2, False, False), (8192, 2048, 2, True, False), (8192, 256, 2, True, False),
    (8192, 5632, 2, True, False), (8192, 2048, 2, False, True), (1024, 32000, 4, False, True),
])
def test_k2_planner_fills_every_thread_at_the_slices_widths(m, k, elem, rotate, fold):
    """At the widths the slices launch, K2's plan leaves at most a tenth of
    its threads idle (none at the bf16 widths without the rotation), a
    block's units cover its group, every unit stays in the register slots
    the kernel has, a decode batch gets a block per row, and the f32 dlog's
    fold sits in shared memory."""
    plan = trowquant.plan_rowquant(m, k, elem, rotate, fold)
    unit = trowquant.unit_elems(elem, rotate)
    assert plan.threads % 32 == 0 and plan.threads <= trowquant.MAX_THREADS
    held = plan.threads * plan.units * unit
    assert held >= plan.rows * k and plan.rows * k / held >= 0.9
    if elem == 2 and not rotate:
        assert held == plan.rows * k
    assert plan.units * unit <= trowquant.MAX_VALUES and plan.rows <= trowquant.MAX_ROWS
    if m <= 64:
        assert plan.rows == 1
    assert plan.fold_smem == fold


@pytest.mark.parametrize("m,k,elem,rotate", [(1337, 2056, 2, False), (5, 104, 2, False), (7, 44, 4, False),
                                             (3, 512, 2, True), (100, 32768, 4, False)])
def test_k2_planner_covers_other_widths(m, k, elem, rotate):
    """Any other width the wrappers take gets a plan whose threads cover its
    group within the register slots; rows beyond MAX_K (qwen2's 152064-wide
    dlog) take the long-row path, one row a block with nothing staged, SR
    and fold included; widths the kernel does not take are refused."""
    plan = trowquant.plan_rowquant(m, k, elem, rotate, False)
    unit = trowquant.unit_elems(elem, rotate)
    assert plan.rows * k <= plan.threads * plan.units * unit and plan.units * unit <= trowquant.MAX_VALUES
    assert plan.units >= 1
    for long_k in (trowquant.MAX_K + 256, 152064):
        for sr in (False, True):
            assert trowquant.plan_rowquant(m, long_k, elem, rotate, not rotate, sr=sr) == \
                trowquant.RowquantPlan(trowquant.MAX_THREADS, 1, 0, False)
    with pytest.raises(ValueError, match="K %"):
        trowquant.plan_rowquant(m, k + (128 if rotate else 2), elem, rotate, False)


@pytest.mark.parametrize("m,k,elem,rotate,fold_fits", [(1024, 32000, 4, False, False), (8192, 5632, 2, False, True),
                                                       (8192, 256, 2, False, True), (8192, 5632, 2, True, False)])
def test_k2_planner_keeps_the_sr_stage_in_shared_memory(m, k, elem, rotate, fold_fits):
    """Under stochastic rounding a group's values wait in an f32 stage of
    rows x K in shared memory; ``fold`` joins it there only where both fit
    (not beside the f32 dlog's 32000-wide row), and never under the
    rotation, which takes no fold."""
    fold = not rotate
    plan = trowquant.plan_rowquant(m, k, elem, rotate, fold, sr=True)
    assert plan.fold_smem == fold_fits
    assert 4 * k * (plan.rows + plan.fold_smem) <= trowquant.SMEM_MAX
    assert trowquant.plan_rowquant(m, k, elem, rotate, fold).fold_smem == fold


@pytest.mark.parametrize("m,k,fold,want", [
    (8192, 5632, True, (128, 1, 6)), (8192, 2048, True, (128, 1, 2)), (8192, 256, True, (128, 8, 2)),
    (32, 5632, False, (352, 1, 2)), (37, 2056, True, (96, 1, 3)), (8192, 5632, False, (128, 1, 6)),
])
def test_k2_planner_gives_sr_rows_a_block_of_128(m, k, fold, want):
    """Stochastic rounding without the rotation: a one-row group takes 128
    threads where at most a tenth of them idle and the rows fill the card
    (measured faster at 5632 wide); decode-sized M and ragged widths keep
    the deterministic plan's wider block."""
    plan = trowquant.plan_rowquant(m, k, 2, False, fold, sr=True)
    assert (plan.threads, plan.rows, plan.units) == want
    assert plan.threads * plan.units * 8 >= plan.rows * k
    if m < 132:
        assert plan[:3] == trowquant.plan_rowquant(m, k, 2, False, fold)[:3]
