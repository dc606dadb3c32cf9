"""Prefix-tuning and llama-adapter in the port against the JAX package, on the CPU.

One set of weights (the JAX tiny sandwich: whisper-tiny-test, a linear
projector, the tiny LLM with ``prefix`` or ``adaption_prompt`` PEFT, the
adapter's gates drawn nonzero: at gate 0 the prompt's gradient is exactly
0) goes into both packages through ``utils.convert.from_flax_params``. In
f32: the logits, the loss and every trainable gradient (the projector and
the new leaves, the only tensors that train) agree with
``jax.value_and_grad`` within 1e-5 of each tensor's largest entry; the
gradients are the same under every activation-checkpointing policy; a zero
gate leaves the model as it was; prefix prefill + decode equal the full
forward; greedy and beam-4 tokens equal the JAX ``Generator``'s; the method
names are accepted or refused as the JAX package does, and the new leaves
pass through ``model.msgpack`` both ways.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from slam_llm_tpu.inference.generate import GenerationConfig as JGenerationConfig
from slam_llm_tpu.inference.generate import Generator as JGenerator
from slam_llm_tpu.models.llm import init_kv_cache as j_init_kv_cache
from slam_llm_tpu.models.slam_model import SLAMModel as JSLAMModel
from slam_llm_tpu.train.optimizer import merge_params as j_merge
from slam_llm_tpu.train.optimizer import partition_params as j_partition
from slam_llm_tpu_torch.inference.generate import GenerationConfig, Generator
from slam_llm_tpu_torch.models import llm as tllm
from slam_llm_tpu_torch.models import slam_model as tslam
from slam_llm_tpu_torch.models.remat import POLICIES
from slam_llm_tpu_torch.train.optimizer import partition_params
from slam_llm_tpu_torch.utils.convert import from_flax_params, trainable_to_flax
from test_torch_train import _batch, _jax_cfg, _leaves, _port_cfg, _tbatch

LEAVES = {"prefix": ("prefix_k", "prefix_v"), "adaption_prompt": ("adaption_prompt", "adaption_gate")}
EOS, PAD = 2, 0


def _cfg(method):
    cfg = _jax_cfg()
    extra = {"prefix": {"prefix_tokens": 3}, "adaption_prompt": {"adaption_prompt_len": 4}}[method]
    return dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, peft_method=method, lora_rank=0, **extra))


@pytest.fixture(scope="module", params=["prefix", "adaption_prompt"])
def pair(request):
    """(method, JAX config, JAX params, the port's model) with the gates nonzero."""
    jcfg = _cfg(request.param)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    variables = JSLAMModel(jcfg).init(jax.random.PRNGKey(0), batch, method="init_all")
    rng = np.random.default_rng(1)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict)
                else (rng.standard_normal(np.shape(v)) * 0.5).astype(np.float32) if k == "adaption_gate"
                else np.asarray(v) for k, v in node.items()}

    params = walk(nn.meta.unbox(variables["params"]))
    tcfg = _port_cfg(jcfg)
    tm = tslam.SLAMModel(tcfg)
    tm.load_state_dict(from_flax_params(params, tcfg))
    return request.param, jcfg, params, tm


def _grads(tm, tcfg):
    tr, _ = partition_params(tm, tcfg)
    out = tm(_tbatch())
    return tr, out, dict(zip(tr.keys(), torch.autograd.grad(out["loss"], list(tr.values()))))


def test_loss_logits_and_trainable_grads_match_jax(pair):
    method, jcfg, params, tm = pair
    trainable, frozen = j_partition(params, jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in _batch().items()}

    def loss_fn(tr):
        out = JSLAMModel(jcfg).apply({"params": j_merge(tr, frozen)}, jbatch)
        return out["loss"], out["acc"]

    (jl, ja), jg = jax.value_and_grad(loss_fn, has_aux=True)(trainable)
    tr, out, grads = _grads(tm, tm.cfg)
    np.testing.assert_allclose(float(out["loss"].detach()), float(jl), rtol=1e-5)
    assert float(out["acc"]) == float(ja)
    names = {n.rsplit(".", 1)[-1] for n in tr if not n.startswith("encoder_projector.")}
    assert names == set(LEAVES[method])  # only the new leaves train in the LLM
    got, want = _leaves(trainable_to_flax(grads)), _leaves(jg)
    assert set(got) == set(want)
    for path, g in got.items():
        w = want[path]
        assert np.abs(w).max() > 0 and np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), path
    # the prefill logits (the cache path: RoPE applied first, the prefix slots prepended)
    b, t = jbatch["input_ids"].shape
    jlogits, _ = JSLAMModel(jcfg).apply({"params": params}, jbatch, j_init_kv_cache(jcfg.llm, b, t + 2, gen_start=t),
                                        method="prefill")
    with torch.no_grad():
        logits, _ = tm.prefill(_tbatch(), tllm.init_kv_cache(tm.cfg.llm, b, t + 2, gen_start=t))
    live = _batch()["attention_mask"].astype(bool)
    jl_, tl_ = np.asarray(jlogits)[live], logits.numpy()[live]
    np.testing.assert_allclose(tl_, jl_, rtol=0, atol=1e-5 * np.abs(jl_).max())


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_every_remat_policy_gives_the_same_gradients(pair, policy):
    method, _, _, tm = pair
    base = dataclasses.replace(tm.cfg, llm=dataclasses.replace(tm.cfg.llm, remat=False))
    remat = dataclasses.replace(tm.cfg, llm=dataclasses.replace(tm.cfg.llm, remat=True, remat_policy=policy))
    results = []
    for cfg in (base, remat):
        m = tslam.SLAMModel(cfg)
        m.load_state_dict(tm.state_dict())
        results.append(_grads(m, cfg))
    (_, out0, g0), (_, out1, g1) = results
    assert float(out0["loss"]) == float(out1["loss"])
    for name, g in g0.items():
        torch.testing.assert_close(g1[name], g, rtol=1e-6, atol=1e-7 * float(g.abs().max()))


@pytest.mark.parametrize("pair", ["adaption_prompt"], indirect=True)
def test_a_zero_gate_leaves_the_model_as_it_was(pair):
    method, _, _, tm = pair
    plain = tslam.SLAMModel(dataclasses.replace(tm.cfg, llm=dataclasses.replace(tm.cfg.llm, peft_method="lora")))
    gated = tslam.SLAMModel(tm.cfg)
    sd = tm.state_dict()
    gated.load_state_dict({n: torch.zeros_like(v) if n.endswith("adaption_gate") else v for n, v in sd.items()})
    plain.load_state_dict({n: v for n, v in sd.items() if not n.endswith(LEAVES[method])})
    with torch.no_grad():
        a, b = (m(_tbatch(), return_logits=True)["logits"] for m in (plain, gated))
    assert torch.equal(a, b)
    tr, _, grads = _grads(gated, gated.cfg)
    assert all(float(g.abs().max()) == 0 for n, g in grads.items() if n.endswith("adaption_prompt"))
    assert all(float(g.abs().max()) > 0 for n, g in grads.items() if n.endswith("adaption_gate"))


def test_prefill_and_decode_equal_the_full_forward(pair):
    """The prompt through ``prefill``, then two tokens through ``decode_step``:
    each step's logits equal the full forward's at that position."""
    _, _, _, tm = pair
    llm = tm.llm.eval()
    rng = np.random.default_rng(3)
    b, t = 2, 9
    ids = torch.from_numpy(rng.integers(3, 250, (b, t + 2)))
    mask = torch.ones(b, t + 2, dtype=torch.int32)
    mask[0, :2] = 0
    with torch.no_grad():
        full = llm(llm.embed(ids), mask)
        cache = tllm.init_kv_cache(llm.cfg, b, t + 2, gen_start=t)
        logits, cache = llm.prefill(llm.embed(ids[:, :t]), mask[:, :t], cache)
        torch.testing.assert_close(logits[1], full[1, :t], rtol=0, atol=1e-5 * float(full.abs().max()))
        torch.testing.assert_close(logits[0, 2:], full[0, 2:t], rtol=0, atol=1e-5 * float(full.abs().max()))
        pos = mask[:, :t].sum(1, keepdim=True).long()
        for i in range(2):
            step_mask = mask[:, : t + i + 1]
            step_mask = torch.nn.functional.pad(step_mask, (0, t + 2 - step_mask.shape[1]))
            lg, cache = llm.decode_step(llm.embed(ids[:, t + i: t + i + 1]), cache, t + i, step_mask, pos + i)
            torch.testing.assert_close(lg[:, 0], full[:, t + i], rtol=0, atol=1e-5 * float(full.abs().max()))


@pytest.mark.parametrize("num_beams", [1, 4])
def test_tokens_match_the_jax_generator(pair, num_beams):
    method, jcfg, params, tm = pair
    kw = dict(max_new_tokens=8, num_beams=num_beams, eos_token_id=EOS, pad_token_id=PAD)
    batch = {k: v for k, v in _batch().items() if k != "labels"}
    want = JGenerator(JSLAMModel(jcfg), JGenerationConfig(**kw)).generate({"params": params}, batch)
    got = Generator(tm.eval(), GenerationConfig(**kw)).generate(batch)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pair", ["prefix"], indirect=True)
def test_a_shared_prefix_beam_cache_is_refused_under_prefix_tuning(pair):
    _, _, _, tm = pair
    attn = tm.llm.layers[0].attn
    c = tm.cfg.llm
    q = torch.zeros(4, 1, c.d_model)
    cache = torch.zeros(2, 5, c.n_kv_heads, c.head_dim)
    gen = torch.zeros(4, 3, c.n_kv_heads, c.head_dim)
    with pytest.raises(NotImplementedError, match="tiled prefix cache"):
        attn(q, torch.zeros(4, 1, dtype=torch.long), bias=torch.zeros(4, 1, 1, 8), cache_k=cache, cache_v=cache,
             gen_k=gen, gen_v=gen, cache_index=5)


def test_seeded_init_of_the_new_leaves(pair):
    """``materialize_params`` draws the prefix slots and the adapter prompt
    with std 0.02, as the reference, and the adapter's gates at 0."""
    from slam_llm_tpu_torch.config import RunConfig
    from slam_llm_tpu_torch.pipeline.common import materialize_params

    method, _, _, tm = pair
    fresh = tslam.SLAMModel(tm.cfg)
    materialize_params(fresh, RunConfig())
    leaves = {n: p for n, p in fresh.named_parameters() if n.endswith(LEAVES[method])}
    assert len(leaves) == 2 * tm.cfg.llm.n_layers
    for name, p in leaves.items():
        if name.endswith("adaption_gate"):
            assert not p.any()
        else:
            assert abs(float(p.std()) - 0.02) < 0.004, name


def test_method_names_are_accepted_or_refused_as_jax():
    from slam_llm_tpu.config import RunConfig as JRunConfig
    from slam_llm_tpu.models.slam_model import build_slam_config as j_build
    from slam_llm_tpu_torch.config import RunConfig

    for method in ("lora", "prefix", "prefix_tuning", "llama_adapter", "adaption_prompt", "ia3"):
        cfgs = []
        for rc in (JRunConfig(), RunConfig()):
            rc.model_config.llm_name, rc.model_config.encoder_config = "tiny-test", "whisper-tiny-test"
            rc.train_config.use_peft = True
            rc.train_config.peft_config.peft_method = method
            rc.train_config.peft_config.num_virtual_tokens, rc.train_config.peft_config.adapter_len = 5, 6
            cfgs.append(rc)
        if method == "ia3":
            for build, rc in ((j_build, cfgs[0]), (tslam.build_slam_config, cfgs[1])):
                with pytest.raises(ValueError, match="unknown peft_method"):
                    build(rc.train_config, rc.model_config)
            continue
        j = j_build(cfgs[0].train_config, cfgs[0].model_config).llm
        t = tslam.build_slam_config(cfgs[1].train_config, cfgs[1].model_config).llm
        fields = ("peft_method", "lora_rank", "prefix_tokens", "adaption_prompt_len")
        assert tuple(getattr(t, f) for f in fields) == tuple(getattr(j, f) for f in fields), method
        names = {n.rsplit(".", 1)[-1] for n, _ in tslam.SLAMModel(
            tslam.build_slam_config(cfgs[1].train_config, cfgs[1].model_config), device="meta").named_parameters()}
        assert names >= set(LEAVES.get(t.peft_method, ())) and not names & (
            {"prefix_k", "adaption_prompt"} - set(LEAVES.get(t.peft_method, ())))


def test_the_new_leaves_pass_through_model_msgpack(pair, tmp_path):
    from slam_llm_tpu.utils.checkpoint import load_trainable as j_load
    from slam_llm_tpu.utils.checkpoint import save_trainable as j_save
    from slam_llm_tpu_torch.utils.checkpoint import load_trainable, save_trainable_msgpack

    method, jcfg, params, tm = pair
    tr, _ = partition_params(tm, tm.cfg)
    save_trainable_msgpack(str(tmp_path / "t.msgpack"), tr, tm.cfg)
    jtrainable = _leaves(j_partition(params, jcfg)[0])
    got = {tuple(k.split("/")): v for k, v in j_load(str(tmp_path / "t.msgpack")).items()}
    assert set(got) == set(jtrainable) and all(np.array_equal(got[k], jtrainable[k]) for k in got)
    j_save(str(tmp_path / "j.msgpack"), j_partition(params, jcfg)[0])
    back = load_trainable(str(tmp_path / "j.msgpack"), tm.cfg)
    assert set(back) == set(tr) and all(torch.equal(back[n].float(), tr[n].detach()) for n in tr)
