"""Training-path kernel twins of slam_llm_tpu_torch against the JAX package.

On the CPU each wrapper runs its plain twin. The same numpy inputs go
through the JAX function (Pallas in interpret mode, as the JAX package's own
tests run it, or its XLA expression) and the port: the flash-attention
backward with and without fused RoPE, the Hadamard rotation, stochastic
rounding (by its statistics: no bit stream can match the TPU's), the
rotated weight, the int8_dot backward modes and the fused linear + CE.
The CUDA kernels against these twins: tests/test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_llm_tpu.models.layers import rope_tables as j_rope_tables
from slam_llm_tpu.ops import fused_ce as jce
from slam_llm_tpu.ops import quant as jquant
from slam_llm_tpu.ops.kernels import rowquant as jrq
from slam_llm_tpu.ops.kernels.flash_attention import flash_attention as j_flash
from slam_llm_tpu_torch.models.layers import DenseGeneralLora
from slam_llm_tpu_torch.ops import fused_ce as tce
from slam_llm_tpu_torch.ops import quant as tquant
from slam_llm_tpu_torch.ops.kernels import flash_attention as tflash
from slam_llm_tpu_torch.ops.kernels import rowquant as trq


def _t(a):
    return torch.from_numpy(np.array(a))


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


# ---- (a) flash-attention backward (K4 twin) and the autograd Function ------


@pytest.mark.parametrize(
    "h,hkv,causal,rope,t,padded",
    [
        pytest.param(4, 2, True, True, 128, True, id="4-2-True-True"),  # GQA, causal, fused RoPE: the training path
        pytest.param(4, 2, True, False, 128, True, id="4-2-True-False"),
        pytest.param(2, 1, True, True, 128, True, id="2-1-True-True"),  # MQA
        pytest.param(4, 4, False, False, 128, True, id="4-4-False-False"),  # whisper-like, not causal
        pytest.param(4, 4, False, True, 128, True, id="4-4-False-True"),
        # Spatial-AST-like, K4's f32 route: T not a multiple of 64, not causal, every key valid
        pytest.param(2, 2, False, False, 131, False, id="spatial_ast-f32"),
    ],
)
def test_flash_backward_matches_pallas_grad(h, hkv, causal, rope, t, padded):
    """dq, dk, dv of the twin (``flash_attention_bwd_ref``) and of the
    autograd ``flash_attention`` against ``jax.grad`` of the Pallas kernel
    (interpret mode), f32, left + right padding (causal left padding leaves
    dead query rows) or none: atol = rtol = 1e-3. Dead rows get dq exactly
    0."""
    rng = np.random.default_rng(h * 10 + hkv + 2 * causal + rope + (t != 128))
    b, d = 2, 64
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    w = rng.standard_normal((b, t, h, d)).astype(np.float32)  # dout
    mask = np.ones((b, t), np.int32)
    if padded:
        mask[0, :17] = 0  # left padding
        mask[1, t - 11:] = 0  # right padding
    pos = np.maximum(mask.cumsum(1) - 1, 0)
    cos, sin = (np.asarray(a) for a in j_rope_tables(jnp.asarray(pos), d))
    rkw = {"rope_cos": jnp.asarray(cos), "rope_sin": jnp.asarray(sin)} if rope else {}

    def loss(q_, k_, v_):
        out = j_flash(q_, k_, v_, jnp.asarray(mask), causal, None, 128, 128, None, None, True, **rkw)
        return jnp.sum(out * jnp.asarray(w))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    trope = (_t(cos), _t(sin)) if rope else None
    out, lse = tflash.flash_attention_ref(_t(q), _t(k), _t(v), _t(mask), causal, rope=trope)
    twin = tflash.flash_attention_bwd_ref(_t(q), _t(k), _t(v), _t(mask), out, lse, _t(w), causal, rope=trope)
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    (tflash.flash_attention(tq, tk, tv, _t(mask), causal, trope) * _t(w)).sum().backward()
    for got in (twin, (tq.grad, tk.grad, tv.grad)):
        for g, wnt in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=1e-3, rtol=1e-3)
    if causal:
        dead = mask.cumsum(1) == 0
        assert dead.any() and np.all(twin[0].numpy()[dead] == 0)


def test_flash_backward_twin_rounds_p_and_ds_like_the_kernel():
    """On bf16 inputs the K4 twin rounds dS to bf16 before dQ = dS K, as K4
    does. Keys that share a large common part make dQ a small difference
    (each row of dS sums to ~0), so dS's rounding moves dQ by ~8 %: the
    twin's dQ is within 10 % of that move from an f64 reference that rounds
    dS, while the same twin on the f32 values is a whole move away."""
    g = torch.Generator().manual_seed(0)
    b, t, h, d = 2, 64, 2, 64
    q, k = ((0.05 * torch.randn(b, t, h, d, generator=g) + 2.0 * torch.randn(1, 1, h, d, generator=g)).bfloat16()
            for _ in range(2))
    v, dout = (torch.randn(b, t, h, d, generator=g).bfloat16() for _ in range(2))
    mask = torch.ones(b, t, dtype=torch.int32)
    out, lse = tflash.flash_attention_ref(q, k, v, mask)
    dq = tflash.flash_attention_bwd_ref(q, k, v, mask, out, lse, dout)[0]
    dq32 = tflash.flash_attention_bwd_ref(q.float(), k.float(), v.float(), mask, out.float(), lse, dout.float())[0]
    qd, kd, vd, od, dod = (x.double() for x in (q, k, v, out, dout))
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qd, kd) / d**0.5, -1)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dod, vd) - (dod * od).sum(-1).permute(0, 2, 1)[..., None])
    exact, rounded = (torch.einsum("bhqk,bkhd->bqhd", x, kd) / d**0.5 for x in (ds, ds.bfloat16().double()))
    move = (rounded - exact).norm()
    assert move > 0.05 * exact.norm()
    assert (dq.double() - rounded).norm() < 0.1 * move
    assert (dq32.double() - rounded).norm() > 0.5 * move


def test_flash_function_saves_no_score_matrix_and_cpu_routes_to_twins():
    """The Function's saved tensors are the reference's residuals (q, k, v,
    mask, out, lse, rope tables): nothing (Tq, Tk)-shaped; the CPU wrappers
    never count a launch."""
    q = torch.randn(1, 48, 2, 64, requires_grad=True)
    k = torch.randn(1, 48, 1, 64, requires_grad=True)
    mask = torch.ones(1, 48, dtype=torch.int32)
    rope = tuple(torch.randn(1, 48, 32) for _ in range(2))
    before = (tflash.flash_attention_fwd.launches, tflash.flash_attention_bwd.launches)
    out = tflash.flash_attention(q, k, k, mask, True, rope)
    shapes = [tuple(t.shape) for t in out.grad_fn.saved_tensors]
    assert len(shapes) == 8 and all(s[1:3] != (48, 48) and s[-2:] != (48, 48) for s in shapes)
    out.sum().backward()
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    assert (tflash.flash_attention_fwd.launches, tflash.flash_attention_bwd.launches) == before
    with pytest.raises(ValueError, match="self-attention"):
        tflash.flash_attention_fwd(q[:, :16].detach(), k.detach(), k.detach(), mask, False, rope=rope)


def test_fused_rope_forward_equals_rotate_then_attend():
    """Fused RoPE in the twin is exactly apply_rope_tables + attention (the
    kernel's numerics: f32 rotation, one rounding to the input dtype)."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 40, 4, 64, generator=g).bfloat16()
    k = torch.randn(2, 40, 2, 64, generator=g).bfloat16()
    mask = torch.ones(2, 40, dtype=torch.int32)
    mask[0, :5] = 0
    rope = tuple(torch.randn(2, 40, 32, generator=g) for _ in range(2))
    fused = tflash.flash_attention_ref(q, k, k, mask, True, rope=rope)
    qr, kr = (tflash.apply_rope_tables(x, *rope) for x in (q, k))
    plain = tflash.flash_attention_ref(qr, kr, k, mask, True)
    assert torch.equal(fused[0], plain[0]) and torch.equal(fused[1], plain[1])
    angles = torch.randn(2, 40, 32, generator=g) * 5
    c, s = angles.cos(), angles.sin()
    back = tflash.apply_rope_tables(tflash.apply_rope_tables(q.float(), c, s), c, s, inverse=True)
    np.testing.assert_allclose(back.numpy(), q.float().numpy(), atol=1e-5)  # R^T R = I


# ---- (b) Hadamard rotation -------------------------------------------------


def test_rotation_matches_jax():
    """rot_block and hadamard equal the reference's; rotate_cols (the FWHT
    K2 runs) matches JAX's matrix form to f32 rounding (1e-5 of the row
    scale) at the slice's widths and at a width whose block is 64."""
    for f in (256, 2048, 5632, 192, 96, 0):
        assert trq.rot_block(f) == jrq.rot_block(f)
    for n in (1, 2, 8, 64, 256):
        np.testing.assert_allclose(trq.hadamard(n).numpy(), jrq.hadamard(n), rtol=1e-7, atol=0)
    rng = np.random.default_rng(0)
    for f in (256, 2048, 5632, 192):
        x = (rng.standard_normal((6, f)) * rng.uniform(0.1, 10, (6, 1))).astype(np.float32)
        want = np.asarray(jrq.rotate_cols(jnp.asarray(x)))
        got = trq.rotate_cols(_t(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(x).max())
        # orthonormal and its own inverse
        np.testing.assert_allclose(trq.rotate_cols(_t(got)).numpy(), x, rtol=0, atol=1e-5 * np.abs(x).max())


# ---- (c) stochastic rounding -----------------------------------------------


def _sr_stats(x, rotate, n_seeds=1000):
    q0, s = trq.rowquant(_t(x), rotate=rotate)
    y = (trq.rotate_cols(_t(x)) if rotate else _t(x)) / s
    lo = torch.floor(y)
    est = torch.zeros(x.shape, dtype=torch.float64)
    for seed in range(n_seeds):
        q, s2 = trq.rowquant(_t(x), seed=seed, rotate=rotate)
        assert torch.equal(s2, s)
        assert bool(((q.double() == lo.double()) | (q.double() == lo.double() + 1)).all())
        deq = q.float() * s
        est += (trq.rotate_cols(deq) if rotate else deq).double()
    est /= n_seeds
    p = (y - lo).double()
    var = (s.double() ** 2) * p * (1 - p)  # per entry, of the quantized (rotated) domain
    if rotate:
        b = trq.rot_block(x.shape[-1])
        var = var.reshape(var.shape[0], -1, b).mean(-1, keepdim=True).expand(-1, -1, b).reshape(var.shape)
    return est - torch.from_numpy(x).double(), var / n_seeds


@pytest.mark.parametrize("rotate", [False, True])
def test_stochastic_rounding_is_unbiased(rotate):
    """Every q is floor(y) or floor(y) + 1; over 1,000 seeds the mean of the
    dequantized value (counter-rotated for rotate) is unbiased: the bias
    averaged over all entries is below 3 standard errors and no entry is
    more than 5 standard errors off. Same seed reproduces, others differ."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 256)) * 0.5).astype(np.float32)
    x[1, 3] = 40.0  # an outlier row: most entries sit far below the scale
    err, var = _sr_stats(x, rotate)
    se = var.sqrt()
    live = se > 0
    assert float(err.mean().abs()) < 3 * float(var.sum().sqrt()) / err.numel()
    assert float((err.abs()[live] / se[live]).max()) < 5
    assert bool((err.abs()[~live] < 1e-6).all())  # integral y: q is exact every time
    qa, _ = trq.rowquant(_t(x), seed=123, rotate=rotate)
    qb, _ = trq.rowquant(_t(x), seed=123, rotate=rotate)
    qc, _ = trq.rowquant(_t(x), seed=124, rotate=rotate)
    assert torch.equal(qa, qb) and not torch.equal(qa, qc)


def test_philox_matches_the_published_known_answer():
    """Philox4x32-10 of the int64 twin against Random123's known-answer
    vectors (kat_vectors: counter 0 / key 0 and counter all-ones / key
    all-ones), the stream K2 implements."""
    z = torch.zeros(1, dtype=torch.int64)
    got = [int(w) for w in trq.philox4x32(z, z, z, z, 0, 0)]
    assert got == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    f = torch.full((1,), 0xFFFFFFFF, dtype=torch.int64)
    got = [int(w) for w in trq.philox4x32(f, f, f, f, 0xFFFFFFFF, 0xFFFFFFFF)]
    assert got == [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]


# ---- (d) the rotated backward weight ----------------------------------------


def test_rotated_weight_matches_jax():
    """rotate_quantize_bwd and quantize_base_params (always re-derived from
    the forward pair) against the reference: scales within 2e-6 relative
    (each is the amax of 256-term rotated sums that the FWHT and the
    reference's matrix product round in different orders, a few f32 ulps),
    q within 1 everywhere and equal on >= 99.9 % of the entries."""
    rng = np.random.default_rng(2)
    k, f = 512, 768
    w = (rng.standard_normal((k, f)) * 0.05).astype(np.float32)
    jq, js = jquant.quantize_int8(jnp.asarray(w))
    jqr, jsr = (np.asarray(a) for a in jquant.rotate_quantize_bwd(jquant.dequantize_int8(jq, js)))
    mod = DenseGeneralLora(k, f, dtype=torch.float32, quant="int8", quant_bwd="int8_rot")
    mod.load_state_dict({"kernel_q": _t(np.asarray(jq).T), "kernel_scale": _t(js)})
    assert "kernel_qr" not in mod.state_dict()  # derived, never loaded
    mod.kernel_qr.fill_(7)  # a stale pair is overwritten
    tquant.quantize_base_params(mod)
    qr, sr = mod.kernel_qr.numpy(), mod.kernel_scale_r.numpy()
    assert qr.shape == (k, f) and sr.dtype == np.float32
    np.testing.assert_allclose(sr, jsr, rtol=2e-6, atol=0)
    diff = np.abs(qr.astype(np.int32) - jqr.astype(np.int32))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999


def test_rot_pair_only_where_the_mode_asks():
    """int8_rot_mlp: only gate / up / down carry the rotated pair."""
    from slam_llm_tpu_torch.models.llm import CausalLM, LLMConfig

    cfg = LLMConfig(**{**LLMConfig.tiny_test().__dict__, "base_quant": "int8", "base_quant_bwd": "int8_rot_mlp"})
    names = {n.rsplit(".", 1)[0].rsplit(".", 1)[-1] for n, _ in CausalLM(cfg).named_buffers() if n.endswith("kernel_qr")}
    assert names == {"gate_proj", "up_proj", "down_proj"}
    assert [tquant.resolve_bwd("int8_rot_mlp", n) for n in ("q_proj", "down_proj")] == ["bf16", "int8_rot"]


# ---- (e) int8_dot backward modes ---------------------------------------------


def test_int8_dot_bf16_backward_matches_jax():
    """bwd="bf16": dx within 1e-6 relative of the reference (f32 x, the
    dequantized weight rounded to bf16, f32 accumulation); the forward too."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 48)) * 0.1).astype(np.float32)
    g = rng.standard_normal((2, 5, 48)).astype(np.float32)
    jq, js = jquant.quantize_int8(jnp.asarray(w))

    def loss(xx):
        return jnp.sum(jquant.int8_dot(xx, jq, js, bwd="bf16") * jnp.asarray(g))

    want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    tx = _t(x).requires_grad_(True)
    y = tquant.int8_dot(tx, _t(np.asarray(jq).T.copy()), _t(js), bwd="bf16")
    (y * _t(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_int8_dot_rot_backward_on_outlier_dy():
    """bwd="int8_rot" on the reference's outlier-dy case (8 of 512 output
    coordinates x300): dx keeps a cosine > 0.999 with the exact dx, and the
    backward saves no activation (only the two rotated weight buffers); a
    mode the reference does not define raises."""
    rng = np.random.default_rng(4)
    kk, f, b = 256, 512, 32
    x = rng.standard_normal((b, kk)).astype(np.float32)
    w = (rng.standard_normal((kk, f)) * 0.05).astype(np.float32)
    wq, ws = tquant.quantize_int8(_t(w).T.contiguous(), contract_axis=-1)  # (F, K), (F,)
    w_deq = tquant.dequantize_int8(wq, ws, contract_axis=-1)
    qr, sr = tquant.rotate_quantize_bwd(w_deq.T)
    m = np.ones(f, np.float32)
    m[:8] = 300.0
    tx = _t(x).requires_grad_(True)
    y = tquant.int8_dot(tx, wq, ws, bwd="int8_rot", seed=7, w_rot=(qr, sr))
    assert {t.data_ptr() for t in y.grad_fn.saved_tensors} == {qr.data_ptr(), sr.data_ptr()}
    (y * _t(m)).sum().backward()
    exact = np.broadcast_to(m, (b, f)).astype(np.float64) @ w_deq.double().numpy()
    assert _cos(tx.grad.numpy(), exact) > 0.999
    with pytest.raises(ValueError, match="int8_dot bwd='int8_fp8'"):
        tquant.int8_dot(tx, wq, ws, bwd="int8_fp8")


# ---- (f) fused linear + cross-entropy -----------------------------------------


@pytest.mark.parametrize("head_grad", [True, False])
def test_fused_ce_matches_jax(head_grad):
    """f32, a chunk (8) that does not divide T (37): loss within 1e-6
    relative, acc equal, dx and dW within 1e-5 of the reference's."""
    rng = np.random.default_rng(5)
    b, t, d, v = 2, 37, 32, 50
    hidden = rng.standard_normal((b, t, d)).astype(np.float32)
    kernel = (rng.standard_normal((d, v)) * 0.3).astype(np.float32)  # (D, V), the reference's layout
    labels = rng.integers(0, v, (b, t)).astype(np.int32)
    labels[0, :5] = -100
    labels[1, -3:] = -100

    def loss(h, k):
        return jce.fused_linear_ce(h, k, jnp.asarray(labels), chunk=8, compute_dtype=jnp.float32,
                                   kernel_needs_grad=head_grad)

    jl, ja = loss(jnp.asarray(hidden), jnp.asarray(kernel))
    jdx, jdw = jax.grad(lambda h, k: loss(h, k)[0], argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(kernel))
    th = _t(hidden).requires_grad_(True)
    tk = _t(kernel.T.copy()).requires_grad_(head_grad)
    tl, ta = tce.fused_linear_ce(th, tk, _t(labels).long(), chunk=8, compute_dtype=torch.float32,
                                 kernel_needs_grad=head_grad)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    assert float(ta) == float(ja) and not ta.requires_grad
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdx), rtol=0, atol=1e-5 * np.abs(jdx).max())
    if head_grad:
        np.testing.assert_allclose(tk.grad.numpy().T, np.asarray(jdw), rtol=0, atol=1e-5 * np.abs(jdw).max())
    else:
        assert tk.grad is None
