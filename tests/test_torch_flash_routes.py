"""The flash kernels' routes that the port added last, held on the CPU.

The routes (f32 operands with fused RoPE; the backward at Tq != Tk; head_dim
192 and 256; the panel route above 256) run as hand-written kernels on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``); here their plain twins
(``flash_attention_ref``, ``flash_attention_bwd_ref``) stand against the
JAX package's Pallas ``flash_attention`` in interpret mode, on the same
numpy-seeded inputs: the output, the live rows' lse, and dq / dk / dv from
``jax.vjp`` against the twin's backward on the JAX forward's own (out,
lse). f32 cases agree within 2e-5 absolute on O(1) inputs; bf16 cases
within the tolerance stated beside them (the JAX kernel rotates and
rounds P in bf16, the twin in f32). Then the planner at the new shapes, and
the port's ``CausalLM`` against the JAX one at head_dim 256 and 512 and in
f32 (loss and LoRA gradients within 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from slam_llm_tpu.models import llm as jllm
from slam_llm_tpu.ops.kernels.flash_attention import _flash_fwd as j_flash_fwd
from slam_llm_tpu.ops.kernels.flash_attention import flash_attention as j_flash
from slam_llm_tpu_torch.models import llm as tllm
from slam_llm_tpu_torch.models.layers import rope_tables
from slam_llm_tpu_torch.ops.kernels import flash_attention as tflash
from slam_llm_tpu_torch.utils.convert import flax_to_state_dict

F32 = jnp.float32


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, b, tq, tk, h, hkv, d, pad):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, tk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, tk, hkv, d)).astype(np.float32)
    dout = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    mask = np.ones((b, tk), np.int32)
    if pad == "left":  # left-padded prompts: the rows before the first key see nothing under the causal mask
        mask[0, :37] = 0
    elif pad == "right":  # key padding, one row's keys all valid
        mask[-1, tk - 53:] = 0
    return q, k, v, dout, mask


def _jax_route(q, k, v, mask, dout, causal, rope, dtype):
    """(out, lse, (dq, dk, dv)) of the Pallas kernel in interpret mode."""
    qj, kj, vj = (jnp.asarray(x, dtype) for x in (q, k, v))
    cos, sin = (jnp.asarray(x) for x in rope) if rope is not None else (None, None)
    scale = 1.0 / np.sqrt(q.shape[-1])
    _, lse = j_flash_fwd(qj, kj, vj, jnp.asarray(mask), causal, scale, 256, 256, True, cos, sin)

    def f(a, b_, c):
        return j_flash(a, b_, c, jnp.asarray(mask), causal, None, 256, 256, 128, None, True, cos, sin)

    out, vjp = jax.vjp(f, qj, kj, vj)
    grads = vjp(jnp.asarray(dout, dtype))
    return (np.asarray(out.astype(F32)), np.asarray(lse),
            tuple(np.asarray(g.astype(F32)) for g in grads))


def _twin_route(q, k, v, mask, dout, causal, rope, dtype, out_j, lse_j):
    """(out, lse, (dq, dk, dv)) of the port's twins; the backward on the JAX
    forward's (out, lse), as a kernel's backward sees its own forward's."""
    tq, tk, tv, tdout = (_t(x).to(dtype) for x in (q, k, v, dout))
    trope = tuple(_t(x) for x in rope) if rope is not None else None
    out, lse = tflash.flash_attention_fwd(tq, tk, tv, _t(mask), causal, rope=trope)
    grads = tflash.flash_attention_bwd(tq, tk, tv, _t(mask), _t(out_j).to(dtype), _t(lse_j), tdout, causal,
                                       rope=trope)
    return out.float().numpy(), lse.numpy(), tuple(g.float().numpy() for g in grads)


def _rope(mask, d, theta=1e4):
    pos = (torch.as_tensor(mask).long().cumsum(1) - 1).clamp_min(0)
    return tuple(x.numpy() for x in rope_tables(pos, d, theta))


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# (b, tq, tk, h, hkv, d, causal, fused RoPE, padding, dtype, bf16 limits: out abs, gradient rel L2)
CASES = [
    # f32 with fused RoPE, with and without GQA (the f32 decoder's training path)
    (1, 256, 256, 2, 2, 64, True, True, "left", "f32", None),
    (2, 256, 256, 4, 2, 64, True, True, "left", "f32", None),
    # head_dim 192 / 256
    (1, 256, 256, 2, 1, 192, True, True, "left", "bf16", (3e-2, 2e-2)),
    (1, 256, 256, 2, 2, 256, False, False, "right", "bf16", (3e-2, 3e-2)),
    (1, 256, 256, 2, 2, 192, False, False, "right", "f32", None),
    (1, 256, 256, 2, 1, 256, True, True, "left", "f32", None),
    # Tq != Tk: non-causal, keys right-padded, in both orders
    (2, 128, 384, 2, 2, 64, False, False, "right", "f32", None),
    (2, 384, 256, 4, 2, 64, False, False, "right", "f32", None),
    (2, 128, 384, 2, 1, 128, False, False, "right", "bf16", (3e-2, 3e-2)),
    # the panel route: head_dim 320 / 512, and Tq != Tk at 384
    (1, 256, 256, 2, 1, 320, True, True, "left", "f32", None),
    (1, 256, 256, 2, 1, 512, True, True, "left", "f32", None),
    (1, 256, 256, 2, 2, 320, False, False, "right", "bf16", (3e-2, 3e-2)),
    (1, 256, 256, 2, 2, 512, False, False, "right", "bf16", (3e-2, 3e-2)),
    (2, 128, 256, 2, 1, 384, False, False, "right", "f32", None),
]


@pytest.mark.parametrize("b,tq,tk,h,hkv,d,causal,fused,pad,dt,limits", CASES)
def test_twins_match_pallas_on_the_new_routes(b, tq, tk, h, hkv, d, causal, fused, pad, dt, limits):
    q, k, v, dout, mask = _inputs(tq + 7 * d + h, b, tq, tk, h, hkv, d, pad)
    rope = _rope(mask, d) if fused else None
    jdt, tdt = (F32, torch.float32) if dt == "f32" else (jnp.bfloat16, torch.bfloat16)
    out_j, lse_j, g_j = _jax_route(q, k, v, mask, dout, causal, rope, jdt)
    out_t, lse_t, g_t = _twin_route(q, k, v, mask, dout, causal, rope, tdt, out_j, lse_j)
    live = mask.cumsum(1) > 0 if causal else np.broadcast_to(mask.sum(1, keepdims=True) > 0, (b, tq))
    assert np.all(out_t[~live] == 0) and np.all(out_j[~live] == 0)
    assert np.all(g_t[0][~live] == 0)
    if limits is None:
        np.testing.assert_allclose(out_t, out_j, atol=2e-5, rtol=0)
        np.testing.assert_allclose(lse_t[live], lse_j[live], atol=2e-5, rtol=0)
        for got, want in zip(g_t, g_j):
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    else:
        out_abs, grad_l2 = limits
        np.testing.assert_allclose(out_t, out_j, atol=out_abs, rtol=0)
        np.testing.assert_allclose(lse_t[live], lse_j[live], atol=2e-2, rtol=0)
        for got, want in zip(g_t, g_j):
            assert _rel_l2(got, want) <= grad_l2


# ---- the planner ------------------------------------------------------------


PLAN_SHAPES = [
    # (b, tq, tk, h, hkv, d, causal, rope)
    (8, 512, 512, 8, 1, 256, True, True),  # the head_dim-256 decoder (Gemma-2B's widths): 8:1 GQA
    (4, 1024, 1024, 16, 2, 192, True, True),
    (2, 449, 449, 8, 8, 256, False, False),
    (3, 70, 70, 6, 3, 192, False, False),
    (8, 256, 1500, 12, 12, 64, False, False),  # queries over whisper-small's frames
    (8, 1500, 256, 12, 12, 64, False, False),
    (2, 130, 300, 8, 2, 128, False, False),
    (2, 300, 130, 4, 1, 256, False, False),
    (2, 100, 260, 4, 2, 192, False, False),
]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plans_at_the_new_shapes_cover_every_row_and_fit(shape):
    """Every pass fits SMEM_LIMIT; K1's and dq's units cover every (batch,
    query, head) row once, over Tq; dk/dv's units cover the Tk keys of
    every kv head once; D 192 / 256 take the wide layouts."""
    b, tq, tk, h, hkv, d, causal, rope = shape
    plan = tflash.plan_flash(*shape)
    for p in (plan.fwd, plan.dq):
        count = torch.zeros(b, tq, h, dtype=torch.int32)
        for u in range(p.units):
            bb, pos, head = tflash.unit_rows(p, b, tq, h, u)
            count[bb, pos, head] += 1
        assert bool((count == 1).all())
    keys = torch.zeros(b, hkv, -(-tk // plan.dkv.rows) * plan.dkv.rows, dtype=torch.int32)
    for u in range(plan.dkv.units):  # the kernels' order: the rank (first key) slowest, then batch, then kv head
        rank, rem = divmod(u, hkv * b)
        bb, hk = divmod(rem, hkv)
        keys[bb, hk, rank * plan.dkv.rows:(rank + 1) * plan.dkv.rows] += 1
    assert bool((keys == 1).all())
    assert max(p.smem_bytes for p in plan) <= tflash.SMEM_LIMIT
    wide = d in tflash.WIDE_HEAD_DIMS
    assert (plan.dkv.rows, plan.dkv.tile, plan.dq.tile) == ((64, 32, 32) if wide else (128, 64, 64))


def test_planner_refuses_what_the_kernels_do_not_take():
    """D % 64 != 0, and the causal mask or RoPE at Tq != Tk, at any D; D
    320 and 512 are planned (the panel route) within SMEM_LIMIT."""
    for bad in ((2, 64, 64, 4, 4, 32, False, False), (2, 64, 64, 4, 4, 352, False, False),
                (2, 64, 80, 4, 4, 64, True, False), (2, 64, 80, 4, 4, 256, False, True),
                (2, 64, 80, 4, 4, 512, True, False), (2, 64, 80, 4, 4, 320, False, True)):
        with pytest.raises(ValueError):
            tflash.plan_flash(*bad)
    for d in (320, 512):
        plan = tflash.plan_flash(2, 64, 64, 4, 4, d, False, False)
        assert max(p.smem_bytes for p in plan) <= tflash.SMEM_LIMIT


PANEL_SHAPES = [
    # (b, tq, tk, h, hkv, d, causal, rope)
    (8, 512, 512, 4, 1, 512, True, True),  # the head_dim-512 decoder: 4:1 GQA
    (4, 1024, 1024, 16, 2, 320, True, False),
    (2, 130, 300, 4, 2, 384, False, False),  # Tq != Tk
    (2, 300, 130, 4, 1, 448, False, False),
    (2, 512, 512, 4, 1, 1024, False, False),
]


@pytest.mark.parametrize("shape", PANEL_SHAPES)
def test_panel_plans_cover_every_row_and_fit(shape):
    """Above D 256 the panel route's plan: K1's and dq's 64-row units
    cover every (batch, query, head) row once, dk / dv's 64-key units every
    key of every kv head once; each pass fits SMEM_LIMIT; O, dq and dK / dV
    are walked in 256 / 256 / 128-column panels."""
    b, tq, tk, h, hkv, d, causal, rope = shape
    plan = tflash.plan_flash(*shape)
    for p in (plan.fwd, plan.dq):
        count = torch.zeros(b, tq, h, dtype=torch.int32)
        for u in range(p.units):
            bb, pos, head = tflash.unit_rows(p, b, tq, h, u)
            count[bb, pos, head] += 1
        assert bool((count == 1).all())
    assert plan.dkv.units * plan.dkv.rows >= tk * hkv * b > (plan.dkv.units - hkv * b) * plan.dkv.rows
    assert max(p.smem_bytes for p in plan) <= tflash.SMEM_LIMIT
    assert (plan.fwd.panels, plan.dq.panels, plan.dkv.panels) == (-(-d // 256), -(-d // 256), -(-d // 128))
    assert plan.dq.grid == plan.dq.units * plan.dq.panels and plan.dkv.grid == plan.dkv.units * plan.dkv.panels


# ---- the decoders that reach the routes -------------------------------------


def _params(variables, seed=0):
    """numpy params with every lora_b drawn nonzero (it inits to 0)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        return {key: walk(val) if isinstance(val, dict)
                else (rng.standard_normal(np.shape(val)) * 0.1).astype(np.float32) if key == "lora_b"
                else np.asarray(val) for key, val in node.items()}

    return walk(nn.meta.unbox(variables["params"]))


LLM_CASES = {
    # a head_dim-256 decoder as the Gemma-2B widths have it, cut: 2 heads over 1 kv head, tied embeddings
    "head_dim_256": dict(vocab_size=256, d_model=64, n_layers=2, n_heads=2, n_kv_heads=1, head_dim=256,
                         ffn_dim=128, rms_eps=1e-6, tied_embeddings=True),
    # the head_dim-512 decoder, cut the same way (the panel route on the card); its gradients are held at
    # 3e-5: against a float64 run of the port both sides lie within 1.4e-5 of the largest entry, in opposite
    # directions, so 1e-5 would hold the two f32 roundings to less than their sum; the test holds the port's
    # f32 gradients within 1e-5 of that float64 run
    "head_dim_512": dict(vocab_size=256, d_model=64, n_layers=2, n_heads=2, n_kv_heads=1, head_dim=512,
                         ffn_dim=128, rms_eps=1e-6, tied_embeddings=True, grad_tol=3e-5),
    # the f32 decoder at TinyLlama's head_dim, cut
    "f32_d64": dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=64, ffn_dim=128),
}


@pytest.mark.parametrize("case", sorted(LLM_CASES))
def test_causal_lm_loss_and_lora_grads_match_jax(case):
    """The port's CausalLM (f32, LoRA r4 on q / v, left-padded rows)
    against the JAX one through ``utils.convert``: the loss and every LoRA
    gradient within 1e-5 (relative to the gradient's largest entry; a
    case's ``grad_tol`` where it states one, and then the port's gradients
    also within 1e-5 of a float64 run of the port)."""
    extra = dict(LLM_CASES[case], lora_rank=4)
    grad_tol = extra.pop("grad_tol", 1e-5)
    jcfg = jllm.LLMConfig(**{**jllm.LLMConfig.tiny_test().__dict__, **extra, "dtype": F32})
    tcfg = tllm.LLMConfig(**{**tllm.LLMConfig.tiny_test().__dict__, **extra, "dtype": torch.float32})
    jm = jllm.CausalLM(jcfg)
    ids0 = jnp.zeros((1, 4), jnp.int32)
    params = _params(jm.init(jax.random.PRNGKey(3), ids0, jnp.ones((1, 4), jnp.int32), method="init_all"))
    tm = tllm.CausalLM(tcfg)
    tm.load_state_dict(flax_to_state_dict(params))

    rng = np.random.default_rng(11)
    b, t = 2, 24
    ids = rng.integers(3, 256, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    mask[0, :7] = 0
    labels = np.where(mask == 1, ids, -100).astype(np.int32)
    labels[:, :10] = -100

    def loss_fn(p):
        m = jllm.CausalLM(jcfg)
        emb = m.apply({"params": p}, jnp.asarray(ids), method="embed")
        loss, _ = m.apply({"params": p}, emb, jnp.asarray(mask), jnp.asarray(labels), method="loss_and_accuracy")
        return loss

    jl, jg = jax.value_and_grad(loss_fn)(params)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jg))
    names = [n for n, _ in tm.named_parameters() if "lora_" in n]
    assert len(names) == 4 * jcfg.n_layers  # a and b on q_proj and v_proj

    def port_grads(model):
        params = dict(model.named_parameters())
        for n in names:
            params[n].requires_grad_(True)
        loss, _ = model.loss_and_accuracy(model.embed(_t(ids).long()), _t(mask), _t(labels).long())
        return loss, torch.autograd.grad(loss, [params[n] for n in names])

    loss, grads = port_grads(tm)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for n, g in zip(names, grads):
        w = np.asarray(want[n])
        assert np.abs(w).max() > 0
        assert np.abs(g.numpy() - w).max() <= grad_tol * np.abs(w).max(), n
    if grad_tol != 1e-5:  # the witness for the wider limit: the port's f32 against its own float64 run
        t64 = tllm.CausalLM(tllm.LLMConfig(**{**tcfg.__dict__, "dtype": torch.float64}))
        t64.load_state_dict(flax_to_state_dict(params))
        t64.double()
        _, grads64 = port_grads(t64)
        for n, g, g64 in zip(names, grads, grads64):
            assert g64.dtype == torch.float64, n
            assert (g.double() - g64).abs().max() <= 1e-5 * g64.abs().max(), n
