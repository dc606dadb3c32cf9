"""The training options of slam_llm_tpu_torch.pipeline.finetune against the JAX package, on the CPU.

The same numpy inputs go through the JAX function and the port's plain
path: K2's ``fold`` (bit-exact), the ``int8`` / ``int8_sr`` / ``_mlp`` /
``int8_rot_otf`` backward modes, the int8 CE head, activation
checkpointing under every policy (bit-identical to no checkpointing, LoRA
dropout replayed), ``anyprecision``, gradient accumulation, full-state
resume and the validation decode. Stochastic rounding cannot match the
TPU's bits, so it is held to its statistics and to the exact gradient.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_train import _batch, _jax_cfg, _leaves, _params, _port_model, _tbatch, _tiny_train_cfg

from slam_llm_tpu.config import TrainConfig
from slam_llm_tpu.models.slam_model import SLAMModel as JSLAMModel
from slam_llm_tpu.ops import fused_ce as jce
from slam_llm_tpu.ops import quant as jquant
from slam_llm_tpu.ops.kernels.rowquant import rowquant as jrowquant
from slam_llm_tpu.train.optimizer import anyprecision_adamw
from slam_llm_tpu.train.optimizer import merge_params as j_merge
from slam_llm_tpu.train.optimizer import partition_params as j_partition
from slam_llm_tpu_torch.models import remat
from slam_llm_tpu_torch.models.layers import DenseGeneralLora
from slam_llm_tpu_torch.ops import fused_ce as tce
from slam_llm_tpu_torch.ops import quant as tquant
from slam_llm_tpu_torch.ops.kernels import flash_attention as tflash
from slam_llm_tpu_torch.ops.kernels import rowquant as trq
from slam_llm_tpu_torch.train.optimizer import AnyPrecisionAdamW, partition_params
from slam_llm_tpu_torch.train.state import Trainer
from slam_llm_tpu_torch.utils.convert import trainable_to_flax


def _t(a):
    return torch.from_numpy(np.array(a))


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---- K2 fold ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [256, 2048, 32000])
def test_rowquant_fold_twin_bit_exact_against_jax(dtype, k):
    """Deterministic fold, 37 rows (a ragged row count): q and s equal to
    the reference's ``rowquant(x, fold)`` bit for bit, with an all-zero row
    and a row of exact .5 ties after the fold."""
    rng = np.random.default_rng(k)
    x = (rng.standard_normal((37, k)) * 3).astype(np.float32)
    fold = rng.uniform(1e-3, 2e-2, k).astype(np.float32)
    x[0] = 0.0
    x[1] = ((np.arange(k) % 254 - 127) + 0.5) / fold  # x * fold lands near .5 ties
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = jrowquant(jx, jnp.asarray(fold))
    tq, ts = trq.rowquant(tx, _t(fold))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert np.all(tq.numpy()[0] == 0)


def test_rowquant_fold_sr_is_unbiased_and_refuses_rotate():
    """SR fold: every q is floor(y) or floor(y) + 1, and over 256 seeds the
    mean of q * s is unbiased against x * fold (the bias averaged over all
    entries within 3 standard errors, no entry past 5); seeds reproduce;
    ``fold`` with ``rotate`` raises, as in the reference."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 512)).astype(np.float32)
    fold = rng.uniform(0.5, 2.0, 512).astype(np.float32)
    x[2, 9] = 60.0  # an outlier row
    xf = torch.from_numpy(x * fold).double()
    _, s = trq.rowquant(_t(x), _t(fold))
    y = torch.from_numpy(x).float() * _t(fold) / s
    lo = torch.floor(y).double()
    est = torch.zeros(x.shape, dtype=torch.float64)
    n = 256
    for seed in range(n):
        q, s2 = trq.rowquant(_t(x), _t(fold), seed=seed)
        assert torch.equal(s2, s) and bool(((q.double() == lo) | (q.double() == lo + 1)).all())
        est += q.double() * s.double()
    err = est / n - xf
    p = y.double() - lo
    var = s.double() ** 2 * p * (1 - p) / n
    assert float(err.mean().abs()) < 3 * float(var.sum().sqrt()) / err.numel()
    live = var > 0
    assert float((err.abs()[live] / var[live].sqrt()).max()) < 5
    a, _ = trq.rowquant(_t(x), _t(fold), seed=5)
    b, _ = trq.rowquant(_t(x), _t(fold), seed=5)
    c, _ = trq.rowquant(_t(x), _t(fold), seed=6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="mutually exclusive"):
        trq.rowquant(_t(x), _t(fold), rotate=True)


# ---- int8 backward modes ---------------------------------------------------------


def _dense_case(seed=4, kk=256, f=512, m=64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, kk)).astype(np.float32)
    w = (rng.standard_normal((kk, f)) * 0.05).astype(np.float32)  # (K, F), the reference's layout
    g = rng.standard_normal((m, f)).astype(np.float32)
    jq, js = jquant.quantize_int8(jnp.asarray(w))
    return x, g, jq, js


def _port_dense(jq, js, bwd):
    kk, f = np.shape(jq)
    mod = DenseGeneralLora(kk, f, dtype=torch.float32, quant="int8", quant_bwd=bwd)
    mod.load_state_dict({"kernel_q": _t(np.asarray(jq).T), "kernel_scale": _t(js)})
    return tquant.quantize_base_params(mod)


def _port_dx(mod, x, g, seed=0):
    mod.quant_seed = seed
    tx = _t(x).requires_grad_(True)
    (mod(tx) * _t(g)).sum().backward()
    return tx.grad.numpy()


def _jax_dx(x, g, jq, js, bwd, seed=0):
    def loss(xx):
        return jnp.sum(jquant.int8_dot(xx, jq, js, bwd=bwd, bwd_seed=jnp.uint32(seed)) * jnp.asarray(g))

    return np.asarray(jax.grad(loss)(jnp.asarray(x)))


def test_int8_backward_bit_exact_against_jax():
    """bwd="int8" (w_scale folded into dy, deterministic rounding, the s8
    product against the stored transpose): dx equal to the reference's bit
    for bit, in f32; ``kernel_qt`` is derived, not loaded."""
    x, g, jq, js = _dense_case()
    mod = _port_dense(jq, js, "int8")
    assert "kernel_qt" not in mod.state_dict()
    np.testing.assert_array_equal(_port_dx(mod, x, g), _jax_dx(x, g, jq, js, "int8"))


@pytest.mark.parametrize("bwd", ["int8_sr", "int8_sr_mlp"])
def test_int8_sr_backward_seeds_and_accuracy(bwd):
    """int8_sr (on an MLP dense for the _mlp mode; its attention denses keep
    the exact bf16 dx): the same seed gives the same dx, another seed
    another; cosine > 0.99 against the exact dx, as the reference's."""
    x, g, jq, js = _dense_case()
    mode = tquant.resolve_bwd(bwd, "gate_proj")
    assert mode == "int8_sr" and tquant.resolve_bwd(bwd, "q_proj") == ("bf16" if bwd.endswith("_mlp") else "int8_sr")
    mod = _port_dense(jq, js, mode)
    a, b, c = _port_dx(mod, x, g, 11), _port_dx(mod, x, g, 11), _port_dx(mod, x, g, 12)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    exact = g.astype(np.float64) @ (np.asarray(jq, np.float64) * np.asarray(js, np.float64)).T
    assert _cos(a, exact) > 0.99 and _cos(_jax_dx(x, g, jq, js, "int8_sr", 11), exact) > 0.99


def test_int8_rot_otf_equals_the_stored_pair():
    """int8_rot_otf derives the rotated pair inside the backward with the
    chain quantize_base_params runs: dx equal to int8_rot's bit for bit,
    and cosine > 0.999 against the reference's int8_rot_otf."""
    x, g, jq, js = _dense_case()
    otf = _port_dx(_port_dense(jq, js, "int8_rot_otf"), x, g, 21)
    stored = _port_dx(_port_dense(jq, js, "int8_rot"), x, g, 21)
    np.testing.assert_array_equal(otf, stored)
    assert _cos(otf, _jax_dx(x, g, jq, js, "int8_rot_otf", 21)) > 0.999


def test_slam_model_int8_backward_matches_jax():
    """The tiny SLAMModel with bwd="int8", f32, dropout off: the loss equal
    to jax.value_and_grad's of the JAX SLAMModel within 1e-6 relative, and
    every trainable gradient within 5e-3 relative (L2). The dense's dx is
    bit-exact (test above), but the two frameworks' f32 backward sums
    (attention, norms) differ in the last bits, and each difference that
    moves a dy entry across a round-half-even boundary moves dx by a whole
    int8 step: the bf16 backward of the same model is 2.7e-4 off, the int8
    one 2.0e-3 (measured on an x86 CPU)."""
    jcfg = _jax_cfg("int8", "int8")
    params = _params(jcfg)
    trainable, frozen = j_partition(params, jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in _batch().items()}

    def loss_fn(tr):
        out = JSLAMModel(jcfg).apply({"params": j_merge(tr, frozen)}, jbatch)
        return out["loss"]

    jl, jg = jax.value_and_grad(loss_fn)(trainable)
    tcfg, tm = _port_model(jcfg, params)
    tquant.quantize_base_params(tm)
    tr, _ = partition_params(tm, tcfg)
    out = tm(_tbatch())
    grads = torch.autograd.grad(out["loss"], list(tr.values()))
    np.testing.assert_allclose(float(out["loss"].detach()), float(jl), rtol=1e-6)
    want = _leaves(jg)
    got = _leaves(trainable_to_flax(dict(zip(tr.keys(), grads))))
    assert set(got) == set(want) and len(got) == 8
    for path, g in got.items():
        assert _rel_l2(g, want[path]) <= 5e-3, path


# ---- the int8 CE head --------------------------------------------------------------


def _ce_case():
    rng = np.random.default_rng(5)
    b, t, d, v = 2, 37, 64, 96
    hidden = rng.standard_normal((b, t, d)).astype(np.float32)
    kernel = (rng.standard_normal((d, v)) * 0.3).astype(np.float32)  # (D, V), the reference's layout
    labels = rng.integers(0, v, (b, t)).astype(np.int32)
    labels[0, :5] = -100
    return hidden, kernel, labels


def _port_ce(hidden, kernel, labels, int8_sr, seed=0):
    q, scale = tquant.quantize_int8(_t(kernel.T.copy()), contract_axis=-1)
    head = tce.QuantHead(q, scale, q.T.contiguous(), int8_sr, seed)
    th = _t(hidden).requires_grad_(True)
    loss, acc = tce.fused_linear_ce(th, _t(kernel.T.copy()), _t(labels).long(), chunk=8,
                                    compute_dtype=torch.float32, kernel_needs_grad=False, head=head)
    loss.backward()
    return float(loss.detach()), float(acc), th.grad.numpy()


@pytest.mark.parametrize("ce_quant", ["int8", "int8_sr"])
def test_int8_ce_head_matches_jax(ce_quant):
    """f32, chunk 8 over T 37: loss and accuracy within 1e-6 relative of the
    reference's ``fused_linear_ce(quant=True)``; the int8 dx within 1e-5
    relative L2; the int8_sr dx reproduces with its seed, changes with
    another, and keeps a cosine > 0.99 with the exact dx; a trainable head
    raises."""
    hidden, kernel, labels = _ce_case()
    sr = ce_quant == "int8_sr"

    def jloss(h):
        return jce.fused_linear_ce(h, jnp.asarray(kernel), jnp.asarray(labels), chunk=8,
                                   compute_dtype=jnp.float32, kernel_needs_grad=False, quant=True,
                                   quant_bwd="int8_sr" if sr else "bf16", quant_seed=jnp.uint32(3))

    jl, ja = jloss(jnp.asarray(hidden))
    jdx = np.asarray(jax.grad(lambda h: jloss(h)[0])(jnp.asarray(hidden)))
    loss, acc, dx = _port_ce(hidden, kernel, labels, sr, seed=3)
    np.testing.assert_allclose(loss, float(jl), rtol=1e-6)
    np.testing.assert_allclose(acc, float(ja), rtol=1e-6)
    if not sr:
        assert _rel_l2(dx, jdx) <= 1e-5
    else:
        assert np.array_equal(dx, _port_ce(hidden, kernel, labels, True, seed=3)[2])
        assert not np.array_equal(dx, _port_ce(hidden, kernel, labels, True, seed=4)[2])
        exact = np.asarray(jax.grad(lambda h: jce.fused_linear_ce(
            h, jnp.asarray(kernel), jnp.asarray(labels), chunk=8, compute_dtype=jnp.float32,
            kernel_needs_grad=False, quant=True)[0])(jnp.asarray(hidden)))
        assert _cos(dx, exact) > 0.99
    q, scale = tquant.quantize_int8(_t(kernel.T.copy()), contract_axis=-1)
    with pytest.raises(ValueError, match="frozen head"):
        tce.fused_linear_ce(_t(hidden), _t(kernel.T.copy()).requires_grad_(True), _t(labels).long(),
                            head=tce.QuantHead(q, scale, q.T.contiguous(), sr))


# ---- activation checkpointing ----------------------------------------------------


def _remat_model(policy, remat_on=True):
    jcfg = _jax_cfg("int8", "int8_rot")
    tcfg, tm = _port_model(jcfg, _params(jcfg))
    llm = dataclasses.replace(tcfg.llm, lora_dropout=0.05, remat=remat_on, remat_policy=policy)
    tcfg = dataclasses.replace(tcfg, llm=llm)
    sd = tm.state_dict()
    tm = type(tm)(tcfg)
    tm.load_state_dict(sd)
    tc = TrainConfig()
    tc.use_peft, tc.seed = True, 7
    tc.peft_config.lora_dropout = 0.05
    trainer = Trainer(tm, tcfg, tc).state_from_params()
    return tm, trainer


def _remat_run(policy, remat_on):
    """Loss, trainable grads and saved-for-backward bytes of one training
    forward + backward with dropout on and fixed seeds."""
    tm, trainer = _remat_model(policy, remat_on)
    trainer.draw_quant_seeds()
    tm.train()
    seen = {}

    def pack(t):
        seen[(t.untyped_storage().data_ptr(), t.dtype)] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = tm(_tbatch())
    grads = torch.autograd.grad(out["loss"], list(trainer.trainable.values()))
    return out["loss"].detach(), grads, sum(seen.values())


def test_remat_is_bit_identical_under_every_policy_and_saves_less():
    """f32, LoRA dropout 0.05, the int8_rot backward: for every policy (and
    an unknown name, which saves nothing) the loss and every trainable
    gradient with checkpointing equal those without it bit for bit (the
    replay redraws the dropout mask from the recorded generator state),
    and the bytes saved for the backward shrink: off > dots_flash_saveable
    >= flash_only >= full."""
    loss0, grads0, bytes_off = _remat_run("dots_flash_saveable", False)
    saved = {}
    for policy in ("full", "dots_saveable", "flash_only", "dots_flash_saveable", "min_saves", "no_such_policy"):
        loss, grads, saved[policy] = _remat_run(policy, True)
        assert torch.equal(loss, loss0), policy
        assert all(torch.equal(a, b) for a, b in zip(grads, grads0)), policy
    assert bytes_off > saved["dots_flash_saveable"] >= saved["flash_only"] >= saved["full"]
    assert saved["no_such_policy"] == saved["full"] < saved["dots_saveable"]


def test_remat_without_replaying_the_generator_would_differ():
    """The generator replay is what makes the test above pass: with the
    generator state not restored, the replay draws another mask and the
    gradients change."""
    _, grads0, _ = _remat_run("full", False)
    states = remat._generator_states
    remat._generator_states = lambda s: __import__("contextlib").nullcontext()
    try:
        _, grads, _ = _remat_run("full", True)
    finally:
        remat._generator_states = states
    assert not all(torch.equal(a, b) for a, b in zip(grads, grads0))


def test_flash_site_replays_saved_out_and_lse():
    """The flash site (the kernel path's K1 / K4 Function, here on its
    twins): a recording tape keeps (out, lse); the replay returns them
    without running the forward again and gives the same gradients."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 40, h, 64, generator=g) for h in (4, 2, 2))
    mask = torch.ones(1, 40, dtype=torch.int32)
    rope = tuple(torch.randn(1, 40, 32, generator=g) for _ in range(2))
    owner = torch.nn.Module()
    tape = remat.Tape(remat.policy_names("flash_only"))
    with torch.no_grad():
        out = tflash.flash_attention(q, k, v, mask, True, rope, tape=tape, owner=owner)
    assert set(tape.values) == {(owner, "flash_out"), (owner, "flash_lse")}
    replay = remat.Tape(tape.names, dict(tape.values))
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    got = tflash.flash_attention(qa, ka, va, mask, True, rope, tape=replay, owner=owner)
    assert got.data_ptr() == out.data_ptr()
    got.sum().backward()
    qb, kb, vb = (t.clone().requires_grad_(True) for t in (q, k, v))
    tflash.flash_attention(qb, kb, vb, mask, True, rope).sum().backward()
    for a, b in ((qa, qb), (ka, kb), (va, vb)):
        assert torch.equal(a.grad, b.grad)


# ---- optimizer, accumulation, resume -------------------------------------------


def test_anyprecision_matches_jax_chain():
    """Three steps of clip_by_global_norm(1.0) then the reference's
    anyprecision_adamw (bf16 moments, Kahan compensation, weight decay):
    parameters within 1e-6 relative, mu and nu within one bf16 ulp."""
    rng = np.random.default_rng(6)
    shapes = [(8, 16), (16,), (4, 8)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * (0.5 if i else 3.0)).astype(np.float32) for s in shapes] for i in range(3)]

    def sched(count):
        return 1e-2 * (count + 1)

    tx = optax.chain(optax.clip_by_global_norm(1.0), anyprecision_adamw(sched, weight_decay=0.01))
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [_t(p) for p in params]
    opt = AnyPrecisionAdamW(tp, lambda c: float(np.float32(sched(c))), weight_decay=0.01)
    for step in range(3):
        upd, state = tx.update([jnp.asarray(gr) for gr in grads[step]], state, jp)
        jp = [(p + u).astype(p.dtype) for p, u in zip(jp, upd)]
        opt.step([_t(gr) for gr in grads[step]])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    inner = state[1]
    for ours, theirs in ((opt.mu, inner["mu"]), (opt.nu, inner["nu"])):
        for a, b in zip(ours, theirs):
            ulp = (a.view(torch.int16).int() - _t(np.asarray(b).view(np.int16)).int()).abs().max()
            assert a.dtype == torch.bfloat16 and int(ulp) <= 1
    assert opt.count == 3


def test_gradient_accumulation_matches_jax_multisteps():
    """Four micro-steps at gradient_accumulation_steps=2 against the JAX
    Trainer (optax MultiSteps): loss, lr and every trainable tensor within
    1e-6 relative after each micro-step; the parameters do not move after
    micro-steps 1 and 3 (nor after 2, whose inner update has the warmup's lr
    0), move after 4, and the schedule counts inner updates."""
    from slam_llm_tpu.parallel import make_mesh
    from slam_llm_tpu.train.state import build_trainer

    jcfg = _jax_cfg("none")
    params = _params(jcfg)
    tc = TrainConfig()
    tc.use_peft, tc.lr, tc.warmup_steps, tc.total_steps, tc.seed = True, 1e-3, 2, 10, 0
    tc.gradient_accumulation_steps = 2
    tc.peft_config.lora_dropout = 0.0
    mesh = make_mesh(dp=1, fsdp=1, tp=1, devices=jax.devices()[:1])
    jt = build_trainer(JSLAMModel(jcfg), jcfg, tc, mesh)
    state = jt.state_from_params(jax.tree_util.tree_map(jnp.asarray, params))
    with mesh:
        db = jt.put_batch(_batch())
    tcfg, tm = _port_model(jcfg, params)
    trainer = Trainer(tm, tcfg, tc).state_from_params()
    before = {n: p.detach().clone() for n, p in trainer.trainable.items()}
    for i in range(4):
        with mesh:
            state, m = jt.train_step(state, db, jax.random.PRNGKey(i))
        tmet = trainer.train_step(_tbatch())
        assert np.float32(tmet["lr"]) == np.float32(m["lr"])
        np.testing.assert_allclose(float(tmet["loss"]), float(m["loss"]), rtol=1e-6)
        want = _leaves(state["trainable"])
        for path, got in _leaves(trainable_to_flax(trainer.trainable)).items():
            assert np.linalg.norm(got - want[path]) <= 1e-6 * np.linalg.norm(want[path]), (i, path)
        moved = [not torch.equal(p, before[n]) for n, p in trainer.trainable.items()]
        assert any(moved) if i == 3 else not any(moved)
        before = {n: p.detach().clone() for n, p in trainer.trainable.items()}
    assert trainer.optimizer.inner.count == 2 and trainer.step == 4


def test_resume_restores_the_full_state_and_continues(tmp_path):
    """save_optimizer writes full_state.pt beside model.pt; resume_from (the
    directory or the file) restores the trainable tensors, the optimizer
    state (anyprecision under accumulation) and the step bit for bit; the
    next micro-steps with reset generators equal the uninterrupted run's."""
    from slam_llm_tpu_torch.pipeline import finetune
    from slam_llm_tpu_torch.utils.checkpoint import load_state

    opts = {"train_config.optimizer": "anyprecision", "train_config.gradient_accumulation_steps": 2,
            "train_config.save_optimizer": True, "train_config.max_steps_per_epoch": 1,
            "train_config.run_validation": False, "train_config.shard.base_quant_bwd": "int8_sr",
            "train_config.shard.ce_quant": "int8_sr"}
    res = finetune.main(_tiny_train_cfg(tmp_path, **opts), device="cpu")
    ckpt = res["checkpoints"][-1]
    full = load_state(ckpt)
    trainer = res["trainer"]
    assert full["step"] == 1 and full["optimizer"]["mini_step"] == 1
    resumed = finetune.main(_tiny_train_cfg(tmp_path, **{**opts, "train_config.resume_from": ckpt + "/full_state.pt",
                                                         "train_config.num_epochs": 0,
                                                         "train_config.save_model": False}), device="cpu")
    again = resumed["trainer"]
    assert again.step == 1
    for name, p in again.trainable.items():
        assert torch.equal(p, full["trainable"][name]) and torch.equal(p, trainer.trainable[name])
    for ours, theirs in ((again.optimizer.state_dict(), full["optimizer"]),):
        assert ours["mini_step"] == theirs["mini_step"] and ours["inner"]["count"] == theirs["inner"]["count"]
        for key in ("mu", "nu", "compensation"):
            assert all(torch.equal(a, b) for a, b in zip(ours["inner"][key], theirs["inner"][key]))
        assert all(torch.equal(a, b) for a, b in zip(ours["acc"], theirs["acc"]))
    # the next step from both, generators reset to the seed as a resumed run's are
    batch = next(iter(_loader(tmp_path)))
    for t in (trainer, again):
        t.quant_generator.manual_seed(t.train_config.seed)
        t.dropout_generator.manual_seed(t.train_config.seed)
        t.train_step(t.put_batch(batch))
    assert all(torch.equal(a, b) for a, b in zip(trainer.trainable.values(), again.trainable.values()))
    assert trainer.optimizer.inner.count == again.optimizer.inner.count == 1


def _loader(tmp_path):
    from slam_llm_tpu.data.loader import build_dataloader
    from slam_llm_tpu_torch.pipeline.common import build_model_and_data

    cfg = _tiny_train_cfg(tmp_path)
    _, _, ds = build_model_and_data(cfg, device="cpu")
    return build_dataloader(ds, 2, shuffle=False)


def test_run_test_during_validation_logs_a_decoded_string(tmp_path):
    """After each validation the finetune loop decodes the one wav greedily
    (the reference's encode_one batch) and logs the text; a non-whisper
    encoder refuses at start-up."""
    import logging

    from helpers import write_wav

    from slam_llm_tpu_torch.pipeline import finetune

    wav = write_wav(tmp_path / "probe.wav", seconds=0.4)
    cfg = _tiny_train_cfg(tmp_path, **{"train_config.run_test_during_validation": True,
                                       "train_config.run_test_during_validation_file": str(wav),
                                       "train_config.validation_interval": 1,
                                       "decode_config.max_new_tokens": 4})
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logging.getLogger("slam_llm_tpu").addHandler(handler)
    try:
        res = finetune.main(cfg, device="cpu")
    finally:
        logging.getLogger("slam_llm_tpu").removeHandler(handler)
    assert len(res["decoded"]) == 2 and all(isinstance(t, str) for t in res["decoded"])
    logged = [r.getMessage() for r in records if r.getMessage().startswith("validation decode:")]
    assert logged == [f"validation decode: {t}" for t in res["decoded"]]
    cfg.model_config.encoder_name = "wavlm"
    with pytest.raises(ValueError, match="whisper"):
        finetune.build_decode_hook(cfg, None, None)


def test_frozen_dtype_float32_keeps_frozen_parameters_f32():
    jcfg = _jax_cfg("int8", "int8_rot")
    tcfg, tm = _port_model(jcfg, _params(jcfg))
    tc = TrainConfig()
    tc.use_peft, tc.frozen_dtype = True, "float32"
    trainer = Trainer(tm, tcfg, tc).state_from_params()
    assert {p.dtype for p in trainer.frozen.values()} == {torch.float32}
    tc.frozen_dtype = "float16"
    with pytest.raises(ValueError, match="frozen_dtype"):
        Trainer(tm, tcfg, tc)
