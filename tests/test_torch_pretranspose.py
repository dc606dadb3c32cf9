"""``shard.bwd_pretranspose`` in the port against the JAX package, on the CPU.

The cases of ``tests/test_pretranspose.py``, held against the JAX package: a
dense's output and gradients equal the plain dense's and the JAX
``_pretransposed_dot``'s; the tiny sandwich's LoRA steps (f32) meet the JAX
``Trainer`` within 1e-5 at world size 1, tp=2 and fsdp=2 (two gloo ranks
each, launched as ``test_torch_distributed``'s groups with this file as the
worker script), where ``kernel_t`` is the transpose of each rank's own shard
and FSDP2 shards it in its dense's unit; ``kernel_t`` is derived after the
seeded init and after a loader (an HF directory, a JAX tree carrying
``kernel_t`` leaves); it raises where the JAX package raises.
"""

import dataclasses
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
STEPS = 3
DENSES = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def _kernel_t_report(model):
    """Per dense with ``kernel_t``: (its local shape, whether it equals the
    transpose of the rank's weight; under FSDP2 both gathered whole)."""
    from slam_llm_tpu_torch.models.layers import DenseGeneralLora
    from slam_llm_tpu_torch.parallel.sharding import local_part

    out = {}
    for name, mod in model.named_modules():
        if isinstance(mod, DenseGeneralLora) and getattr(mod, "kernel_t", None) is not None:
            t, w = mod.kernel_t, mod.weight
            whole_t = t.full_tensor() if hasattr(t, "full_tensor") else t
            whole_w = w.full_tensor() if hasattr(w, "full_tensor") else w
            out[name] = (tuple(local_part(t).shape), bool(torch.equal(whole_t, whole_w.t())))
    return out


def _steps(tcfg, state_dict, tc, batch, mesh=None):
    """STEPS port trainer steps: metrics, whole trainable tensors and the
    ``kernel_t`` report after the state is built."""
    from slam_llm_tpu_torch.models import slam_model as tslam
    from slam_llm_tpu_torch.train.state import Trainer

    model = tslam.SLAMModel(tcfg)
    model.load_state_dict(state_dict)
    trainer = Trainer(model, tcfg, tc, mesh=mesh).state_from_params()
    report = _kernel_t_report(model)
    metrics = [{k: float(v) for k, v in trainer.train_step(trainer.put_batch(batch)).items()} for _ in range(STEPS)]
    return {"metrics": metrics, "trainable": trainer.whole_trainable(), "kernel_t": report}


def _worker(payload: str, out_dir: str) -> None:
    import torch.distributed as dist
    from test_torch_distributed import DIST_TIMEOUT

    from slam_llm_tpu_torch.parallel.sharding import make_mesh
    from slam_llm_tpu_torch.pipeline.common import maybe_init_distributed

    torch.set_num_threads(1)
    assert maybe_init_distributed("cpu", timeout=DIST_TIMEOUT)
    for job in torch.load(payload, weights_only=False):
        mesh = make_mesh(dp=1, fsdp=job["fsdp"], tp=job["tp"], device_type="cpu")
        result = _steps(job["tcfg"], job["state_dict"], job["tc"], job["batch"], mesh)
        result["reports"] = [None] * dist.get_world_size()
        dist.all_gather_object(result["reports"], result["kernel_t"])
        if dist.get_rank() == 0:
            torch.save(result, Path(out_dir) / f"{job['name']}.pt")
    dist.destroy_process_group()


# ---- the references (JAX) -------------------------------------------------------------


def _configs(pretranspose=True):
    """(JAX SLAMConfig, port SLAMConfig, JAX params with ``kernel_t``
    leaves, port state dict) of ``test_torch_train``'s tiny f32 sandwich
    with a plain LLM base and LoRA."""
    from test_torch_train import _jax_cfg, _params, _port_model

    jcfg = _jax_cfg()
    jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm, bwd_pretranspose=pretranspose))
    params = _params(jcfg)
    tcfg, tm = _port_model(jcfg, params)
    return jcfg, tcfg, params, tm.state_dict()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """tp=2 and fsdp=2 (two gloo ranks each) running while the JAX
    references and the one-process port run here."""
    from test_torch_distributed import _global_batch, _Group, _jax_steps, _train_config

    root = tmp_path_factory.mktemp("pretranspose")
    jcfg, tcfg, params, sd = _configs()
    batch, tc = _global_batch(), _train_config()
    job = {"tcfg": tcfg, "state_dict": sd, "tc": tc, "batch": batch}
    groups = {name: _Group(2, [{**job, "name": name, **mesh}], root / name, script=Path(__file__))
              for name, mesh in (("tp2", {"fsdp": 1, "tp": 2}), ("fsdp2", {"fsdp": 2, "tp": 1}))}
    torch.set_num_threads(2)
    refs = {"one": _steps(tcfg, sd, tc, batch), "plain": _steps(_configs(False)[1], sd, tc, batch),
            "jax": _jax_steps(jcfg, params, 1, 1), "jax_tp2": _jax_steps(jcfg, params, 1, 1, tp=2),
            "jax_fsdp2": _jax_steps(jcfg, params, 1, 2)}
    yield {"groups": groups, "refs": refs, "tcfg": tcfg}
    for group in groups.values():
        for p in group.procs:
            if p.poll() is None:
                p.kill()


def test_pretransposed_dense_equals_the_plain_dense_and_jax():
    """One dense (f32, LoRA r4): output, dx and the LoRA gradients equal the
    plain dense's within 1e-6 and the JAX ``_pretransposed_dot`` dense's
    within 1e-5 of the largest entry;
    ``kernel_t`` gets no gradient; a base that trains gets the exact dw."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    from slam_llm_tpu.models.layers import DenseGeneralLora as JDense
    from slam_llm_tpu.models.layers import refresh_pretransposed as j_refresh
    from slam_llm_tpu_torch.models.layers import DenseGeneralLora, refresh_pretransposed
    from slam_llm_tpu_torch.utils.convert import flax_to_state_dict

    kw = dict(features=24, dtype=jnp.float32, param_dtype=jnp.float32, lora_rank=4)
    x = jax.random.normal(jax.random.PRNGKey(0), (3, 16), jnp.float32)
    dy = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (3, 24), jnp.float32))
    p = nn.meta.unbox(JDense(**kw).init(jax.random.PRNGKey(1), x)["params"])
    p = {**p, "lora_b": jax.random.normal(jax.random.PRNGKey(3), p["lora_b"].shape) * 0.3}
    pt = j_refresh({**p, "kernel_t": jnp.zeros((24, 16))})

    def jgrads(params):
        return jax.grad(lambda pp, xx: jnp.vdot(JDense(pretranspose_bwd=True, **kw).apply({"params": pp}, xx), dy),
                        argnums=(0, 1))(params, x)

    jg, jdx = jgrads(pt)
    assert not np.asarray(jg["kernel_t"]).any()
    sd = flax_to_state_dict(p)
    outs = []
    for pre in (True, False):
        d = DenseGeneralLora(16, 24, dtype=torch.float32, lora_rank=4, lora_alpha=32.0, pretranspose_bwd=pre)
        d.load_state_dict(sd)
        refresh_pretransposed(d)
        for t in (d.lora_a, d.lora_b):
            t.requires_grad_(True)
        tx = torch.from_numpy(np.array(x)).requires_grad_(True)
        y = d(tx)
        y.backward(torch.from_numpy(dy.copy()))
        outs.append((y.detach().numpy(), tx.grad.numpy(), d.lora_a.grad.numpy(), d.lora_b.grad.numpy()))
        if pre:
            assert d.kernel_t.grad is None and torch.equal(d.kernel_t, d.weight.t())
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    for got, want in ((outs[0][1], jdx), (outs[0][2], np.asarray(jg["lora_a"]).T),
                      (outs[0][3], np.asarray(jg["lora_b"]).T)):
        assert np.abs(got - np.asarray(want)).max() <= 1e-5 * np.abs(want).max()
    # a trainable base: the exact weight gradient, as the reference's bwd returns
    d = DenseGeneralLora(16, 24, dtype=torch.float32, frozen_base=False, pretranspose_bwd=True)
    d.weight.data.normal_()
    refresh_pretransposed(d)
    d.weight.requires_grad_(True)
    tx = torch.from_numpy(np.array(x))
    d(tx).backward(torch.from_numpy(dy.copy()))
    np.testing.assert_allclose(d.weight.grad.numpy(), dy.T @ np.asarray(x), rtol=1e-5, atol=1e-6)


def _assert_steps(got, want, spread):
    """``test_torch_distributed._assert_matches_jax`` with ``spread`` the
    JAX Trainer on another mesh: a tensor may differ by twice the JAX
    package's own difference between the two meshes (the zero-initialised
    projector biases, whose values are Adam's first updates of f32
    round-off)."""
    from test_torch_distributed import _assert_matches_jax

    _assert_matches_jax(got, want, spread=spread)


def test_trainer_steps_match_jax_at_world_size_1(runs):
    """Three steps (f32, LoRA, warmup 2) against the JAX Trainer with
    ``bwd_pretranspose``: loss and grad norm within 1e-5 relative, every
    LoRA / projector tensor within 1e-5 of its norm (``_assert_steps``); and equal to the port
    without the option at 1e-6; ``kernel_t`` is every decoder dense's
    ``weight.T`` once the state is built."""
    one = runs["refs"]["one"]
    _assert_steps(one, runs["refs"]["jax"], runs["refs"]["jax_fsdp2"])
    for a, b in zip(one["metrics"], runs["refs"]["plain"]["metrics"]):
        np.testing.assert_allclose([a["loss"], a["grad_norm"]], [b["loss"], b["grad_norm"]], rtol=1e-6)
    n_layers = runs["tcfg"].llm.n_layers
    assert len(one["kernel_t"]) == len(DENSES) * n_layers and all(ok for _, ok in one["kernel_t"].values())


@pytest.mark.parametrize("mesh", ["tp2", "fsdp2"])
def test_sharded_steps_match_jax(runs, mesh):
    """tp=2 and fsdp=2: the JAX Trainer on the same mesh within 1e-5; each
    rank's ``kernel_t`` is the transpose of its own weight shard (tp: a
    column dense holds (K, F / 2), a row one (K / 2, F)); under FSDP2 it is a
    parameter sharded on its first dim in its dense's unit, gathered equal
    to the whole weight's transpose."""
    got = runs["groups"][mesh].result(mesh)
    _assert_steps(got, runs["refs"][f"jax_{mesh}"], runs["refs"]["jax"])
    whole = runs["refs"]["one"]["kernel_t"]
    for report in got["reports"]:
        assert set(report) == set(whole)
        for name, (shape, ok) in report.items():
            k, f = whole[name][0]
            if mesh == "fsdp2":
                want = (k // 2, f)
            else:
                want = (k // 2, f) if name.endswith(("o_proj", "down_proj")) else (k, f // 2)
            assert ok and shape == want, (name, shape, want)


def test_kernel_t_is_derived_after_init_and_after_a_loader(tmp_path):
    """Through ``build_slam_config``: ``materialize_params`` (the seeded
    init), then the Trainer: every ``kernel_t`` is its weight's transpose;
    again after an HF directory's weights are loaded over the init; a JAX
    tree carrying ``kernel_t`` leaves converts without them (they are
    derived, not state) and loads strictly."""
    from test_torch_distributed import _tiny_cfg

    from slam_llm_tpu_torch.models.slam_model import model_factory
    from slam_llm_tpu_torch.pipeline.common import materialize_params
    from slam_llm_tpu_torch.tools.synth_checkpoint import write_llama
    from slam_llm_tpu_torch.train.state import Trainer
    from slam_llm_tpu_torch.utils.convert import from_flax_params

    cfg = _tiny_cfg(tmp_path, **{"train_config.shard.base_quant": "none", "train_config.shard.bwd_pretranspose": True})
    for llm_path in (None, tmp_path / "llm"):
        model, _ = model_factory(cfg.train_config, cfg.model_config, device="cpu")
        if llm_path is not None:
            write_llama(str(llm_path), model.cfg.llm, seed=7)
            cfg.model_config.llm_path = str(llm_path)
            cfg.model_config.file = None
        before = {n: b.clone() for n, b in model.named_buffers() if n.endswith("kernel_t")}
        materialize_params(model, cfg)
        Trainer(model, model.cfg, cfg.train_config).state_from_params()
        report = _kernel_t_report(model)
        assert len(report) == len(before) == len(DENSES) * model.cfg.llm.n_layers
        assert all(ok for _, ok in report.values())
        assert not any(b.any() for b in before.values())
    q = model.llm.layers[0].attn.q_proj
    assert q.weight.abs().sum() > 0 and torch.equal(q.kernel_t, q.weight.t())
    _, tcfg, params, _ = _configs()
    assert any("kernel_t" in str(k) for k in _flat_keys(params))
    sd = from_flax_params(params, tcfg)
    assert not any("kernel_t" in k for k in sd)
    from slam_llm_tpu_torch.models import slam_model as tslam

    tslam.SLAMModel(tcfg).load_state_dict(sd)  # strict: kernel_t is not in the state dict


def _flat_keys(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_keys(v, prefix + (k,))
        else:
            yield prefix + (k,)


def test_refusals_follow_jax():
    """With the LLM trained, the Trainer refuses the option with the JAX
    Trainer's message; with the int8 base the dense refuses it, as the JAX
    dense does."""
    import jax
    import jax.numpy as jnp

    from slam_llm_tpu.models.layers import DenseGeneralLora as JDense
    from slam_llm_tpu_torch.models import slam_model as tslam
    from slam_llm_tpu_torch.models.layers import DenseGeneralLora
    from slam_llm_tpu_torch.train.state import Trainer
    from test_torch_distributed import _train_config

    _, tcfg, _, sd = _configs()
    unfrozen = dataclasses.replace(tcfg, freeze_llm=False)
    model = tslam.SLAMModel(unfrozen)
    model.load_state_dict(sd)
    with pytest.raises(ValueError, match="bwd_pretranspose requires freeze_llm") as got:
        Trainer(model, unfrozen, _train_config()).state_from_params()
    assert "desynchronize their kernel_t copies" in str(got.value)
    with pytest.raises(ValueError, match="quant='int8' and pretranspose_bwd are exclusive"):
        JDense(features=8, quant="int8", pretranspose_bwd=True).init(jax.random.PRNGKey(0), jnp.ones((2, 8)))
    with pytest.raises(ValueError, match="quant='int8' and pretranspose_bwd are exclusive"):
        DenseGeneralLora(8, 8, quant="int8", pretranspose_bwd=True)


if __name__ == "__main__":
    sys.path.insert(0, str(HERE))
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    _worker(sys.argv[1], sys.argv[2])
