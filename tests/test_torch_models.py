"""Modules of slam_llm_tpu_torch against their JAX counterparts on the CPU.

One set of weights (the JAX module's init, with LoRA B and biases made
nonzero) goes into both packages through ``utils.convert``; the same numpy
inputs go through both. f32 throughout; outputs agree within 1e-4 relative
(max abs difference over max abs value) unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from slam_llm_tpu.models import layers as jl
from slam_llm_tpu.models import llm as jllm
from slam_llm_tpu.models import whisper as jw
from slam_llm_tpu_torch.models import layers as tl
from slam_llm_tpu_torch.models import llm as tllm
from slam_llm_tpu_torch.models import whisper as tw
from slam_llm_tpu_torch.utils.convert import flax_to_state_dict

F32 = jnp.float32


def _t(a):
    return torch.from_numpy(np.array(a))


def _params(variables, seed=0):
    """numpy params with every lora_b and bias drawn nonzero (both init to 0)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for key, val in node.items():
            if isinstance(val, dict):
                out[key] = walk(val)
            elif key in ("lora_b", "bias"):
                out[key] = (rng.standard_normal(np.shape(val)) * 0.1).astype(np.float32)
            else:
                out[key] = np.asarray(val)
        return out

    return walk(nn.meta.unbox(jax.tree_util.tree_map(lambda x: x, variables["params"])))


def assert_rel(got, want, tol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"relative error {err:.3e} > {tol:.0e}"


# ---- layers ------------------------------------------------------------


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_dense_lora_matches_jax(quant):
    x = np.random.default_rng(1).standard_normal((2, 5, 32)).astype(np.float32)
    jm = jl.DenseGeneralLora(features=24, use_bias=True, dtype=F32, lora_rank=4, quant=quant)
    params = _params(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = jm.apply({"params": params}, jnp.asarray(x))
    tm = tl.DenseGeneralLora(32, 24, use_bias=True, dtype=torch.float32, lora_rank=4, quant=quant)
    tm.load_state_dict(flax_to_state_dict(params))
    assert_rel(tm(_t(x)).numpy(), want)


def test_norms_match_jax():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 7, 16)) * 4 + 1).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    want = jl.RMSNorm(eps=1e-5, dtype=F32).apply({"params": {"scale": scale}}, jnp.asarray(x))
    got = tl.RMSNorm(16, 1e-5, torch.float32)
    got.load_state_dict({"scale": _t(scale)})
    assert_rel(got(_t(x)).numpy(), want, 1e-5)
    want = jl.LayerNorm(dtype=F32).apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    got = tl.LayerNorm(16, dtype=torch.float32)
    got.load_state_dict({"scale": _t(scale), "bias": _t(bias)})
    assert_rel(got(_t(x)).numpy(), want, 1e-5)


def test_rope_matches_jax():
    rng = np.random.default_rng(3)
    mask = np.ones((2, 9), np.int32)
    mask[0, :3] = 0
    pos = np.maximum(mask.cumsum(1) - 1, 0)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    jc, js = jl.rope_tables(jnp.asarray(pos), 16)
    tc, ts = tl.rope_tables(_t(pos), 16)
    assert_rel(tc.numpy(), jc, 1e-6)
    assert_rel(ts.numpy(), js, 1e-6)
    assert_rel(tl.apply_rope_tables(_t(x), tc, ts).numpy(), jl.apply_rope_tables(jnp.asarray(x), jc, js), 1e-6)


def _mask(b, t, left=0, right=0):
    m = np.ones((b, t), np.int32)
    m[0, :left] = 0
    m[-1, t - right:] = 0
    return m


@pytest.mark.parametrize(
    "case", ["kv_mask_causal_gqa", "causal_end_aligned", "padding_bias", "per_head_bias"]
)
def test_plain_attention_matches_jax(case):
    """The plain path (the CPU route of ``mha_attention``) against
    ``_xla_attention``, including all-masked rows, which both define as 0."""
    rng = np.random.default_rng(4)
    b, tq, tk, h, hkv, d = 2, 11, 11, 4, 2, 16
    bias = kv_mask = None
    causal = False
    if case == "causal_end_aligned":
        tq = 5
    q = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, tk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, tk, hkv, d)).astype(np.float32)
    if case in ("kv_mask_causal_gqa", "causal_end_aligned"):
        kv_mask, causal = _mask(b, tk, left=4, right=2), True
    elif case == "padding_bias":
        bias = np.asarray(jl.make_padding_bias(jnp.asarray(_mask(b, tk, right=3)), tq))
        np.testing.assert_array_equal(tl.make_padding_bias(_t(_mask(b, tk, right=3)), tq).numpy(), bias)
    else:
        bias = (rng.standard_normal((b, h, tq, tk)) * 0.5).astype(np.float32)
        bias[0, 1, 2] = jl.NEG_INF  # one fully masked (row, head)
    jargs = [jnp.asarray(a) if a is not None else None for a in (q, k, v, bias, kv_mask)]
    want = jl._xla_attention(*jargs, causal=causal)
    targs = [_t(a) if a is not None else None for a in (q, k, v, bias, kv_mask)]
    got = tl.mha_attention(targs[0], targs[1], targs[2], bias=targs[3], kv_mask=targs[4], causal=causal)
    assert_rel(got.numpy(), want, 1e-5)
    if case == "kv_mask_causal_gqa":
        assert np.all(got.numpy()[0, :4] == 0)  # left-padded rows see no key


def test_sinusoidal_positions_match_jax():
    assert_rel(tl.sinusoidal_positions(30, 32).numpy(), jl.sinusoidal_positions(30, 32), 1e-6)


# ---- whisper -------------------------------------------------------------


def test_whisper_encoder_matches_jax():
    rng = np.random.default_rng(5)
    jcfg = jw.WhisperEncoderConfig.tiny_test()
    jcfg = jw.WhisperEncoderConfig(**{**jcfg.__dict__, "dtype": F32})
    mel = rng.standard_normal((2, 128, 8)).astype(np.float32)
    mel_mask = np.ones((2, 128), np.int32)
    mel_mask[1, 100:] = 0
    jm = jw.WhisperEncoder(jcfg)
    params = _params(jm.init(jax.random.PRNGKey(1), jnp.asarray(mel), jnp.asarray(mel_mask)))
    want, want_mask = jm.apply({"params": params}, jnp.asarray(mel), jnp.asarray(mel_mask))
    tm = tw.WhisperEncoder(tw.WhisperEncoderConfig(n_mels=8, d_model=32, n_heads=2, n_layers=2,
                                                   max_source_positions=64, dtype=torch.float32))
    tm.load_state_dict(flax_to_state_dict(params))
    got, got_mask = tm(_t(mel), _t(mel_mask))
    assert got.shape == (2, 64, 32)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert_rel(got.numpy(), want)


def test_whisper_presets_match_jax():
    for name, fn in jw.PRESETS.items():
        j, t = fn(), tw.PRESETS[name]()
        assert (j.n_mels, j.d_model, j.n_heads, j.n_layers, j.max_source_positions) == (
            t.n_mels, t.d_model, t.n_heads, t.n_layers, t.max_source_positions)


# ---- llm -------------------------------------------------------------------


def _llm_pair(base_quant="int8"):
    jcfg = jllm.LLMConfig(**{**jllm.LLMConfig.tiny_test().__dict__, "dtype": F32, "lora_rank": 4,
                             "base_quant": base_quant})
    tcfg = tllm.LLMConfig(**{**tllm.LLMConfig.tiny_test().__dict__, "dtype": torch.float32,
                             "lora_rank": 4, "base_quant": base_quant})
    jm = jllm.CausalLM(jcfg)
    ids = jnp.zeros((1, 4), jnp.int32)
    params = _params(jm.init(jax.random.PRNGKey(2), ids, jnp.ones((1, 4), jnp.int32), method="init_all"))
    tm = tllm.CausalLM(tcfg)
    tm.load_state_dict(flax_to_state_dict(params))
    return jcfg, jm, {"params": params}, tcfg, tm


def _to_np(cache):
    return {k: np.asarray(v) for k, v in cache.items()}


@pytest.mark.parametrize("base_quant", ["int8", "none"])
def test_llm_prefill_and_decode_steps_match_jax(base_quant):
    """Prefill logits and cache, a greedy decode step (split cache, B rows)
    and a beam decode step (prefix at B rows, tails at B*K rows)."""
    jcfg, jm, jp, tcfg, tm = _llm_pair(base_quant)
    rng = np.random.default_rng(6)
    b, t, max_new, d = 2, 10, 6, jcfg.d_model
    embeds = rng.standard_normal((b, t, d)).astype(np.float32)
    mask = _mask(b, t, left=3)

    jcache = jllm.init_kv_cache(jcfg, b, t + max_new, gen_start=t)
    jlogits, jcache = jm.apply(jp, jnp.asarray(embeds), jnp.asarray(mask), jcache, method="prefill")
    tcache = tllm.init_kv_cache(tcfg, b, t + max_new, gen_start=t)
    with torch.inference_mode():
        tlogits, tcache = tm.prefill(_t(embeds), _t(mask), tcache)
    assert_rel(tlogits.numpy(), jlogits)
    for key in ("k", "v"):
        assert_rel(tcache[key].numpy(), jcache[key])

    # greedy step: slot t is this token's
    tok = rng.standard_normal((b, 1, d)).astype(np.float32)
    step_mask = np.concatenate([mask, np.zeros((b, max_new), np.int32)], 1)
    step_mask[:, t] = 1
    pos = mask.sum(1, keepdims=True)
    jl_, jc_ = jm.apply(jp, jnp.asarray(tok), jcache, jnp.int32(t), jnp.asarray(step_mask),
                        jnp.asarray(pos), method="decode_step")
    with torch.inference_mode():
        tl_, tc_ = tm.decode_step(_t(tok), {k: v.clone() for k, v in tcache.items()}, t,
                                  _t(step_mask), _t(pos))
    assert_rel(tl_.numpy(), jl_)
    assert_rel(tc_["k_gen"].numpy()[:, :, 0], np.asarray(jc_["k_gen"])[:, :, 0])

    # beam step at slot t + 2: prefix at B rows, per-beam tails at B*K rows
    kb = 3
    gen_k = (rng.standard_normal((jcfg.n_layers, b * kb, max_new, jcfg.n_kv_heads, jcfg.head_dim))
             .astype(np.float32))
    gen_v = gen_k[::-1].copy()
    beam_cache = {"k": np.asarray(jcache["k"]), "v": np.asarray(jcache["v"]), "k_gen": gen_k, "v_gen": gen_v}
    tok = rng.standard_normal((b * kb, 1, d)).astype(np.float32)
    step_mask = np.repeat(step_mask, kb, 0)
    step_mask[:, t : t + 3] = 1
    pos = np.repeat(pos, kb, 0) + 2
    jl_, jc_ = jm.apply(jp, jnp.asarray(tok), {k: jnp.asarray(v) for k, v in beam_cache.items()},
                        jnp.int32(t + 2), jnp.asarray(step_mask), jnp.asarray(pos), method="decode_step")
    with torch.inference_mode():
        tl_, tc_ = tm.decode_step(_t(tok), {k: _t(v) for k, v in beam_cache.items()}, t + 2,
                                  _t(step_mask), _t(pos))
    assert_rel(tl_.numpy(), jl_)
    assert_rel(tc_["v_gen"].numpy(), jc_["v_gen"])


def test_reorder_cache_matches_jax():
    rng = np.random.default_rng(7)
    cache = {k: rng.standard_normal((2, 6, 3, 2, 4)).astype(np.float32) for k in ("k", "v", "k_gen", "v_gen")}
    idx = np.array([2, 2, 0, 5, 1, 3])
    want = jllm.reorder_cache({k: jnp.asarray(v) for k, v in cache.items()}, jnp.asarray(idx))
    got = tllm.reorder_cache({k: _t(v) for k, v in cache.items()}, _t(idx))
    for key in cache:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_positions_from_mask_match_jax():
    mask = _mask(3, 8, left=5, right=2)
    np.testing.assert_array_equal(
        tllm._positions_from_mask(_t(mask)).numpy(), np.asarray(jllm._positions_from_mask(jnp.asarray(mask)))
    )
