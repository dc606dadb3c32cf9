"""The ported training step against the JAX package, end to end on the CPU.

One set of weights (the JAX tiny sandwich: whisper-tiny-test encoder,
linear projector, tiny LoRA LLM, LoRA B made nonzero) goes into both
packages through ``utils.convert.from_flax_params``. In f32 the loss, the
accuracy and every trainable gradient agree with ``jax.value_and_grad`` of
the JAX ``SLAMModel``, and three optimizer steps agree with the JAX
``Trainer``. Then the port's own training machinery: fresh stochastic-
rounding seeds, LoRA dropout, and the finetune CLI on the CPU.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from slam_llm_tpu.config import TrainConfig
from slam_llm_tpu.models.llm import LLMConfig as JLLMConfig
from slam_llm_tpu.models.projector import ProjectorConfig as JProjectorConfig
from slam_llm_tpu.models.slam_model import SLAMConfig as JSLAMConfig
from slam_llm_tpu.models.slam_model import SLAMModel as JSLAMModel
from slam_llm_tpu.models.whisper import WhisperEncoderConfig as JWhisperConfig
from slam_llm_tpu.train.optimizer import merge_params as j_merge
from slam_llm_tpu.train.optimizer import partition_params as j_partition
from slam_llm_tpu_torch.models import llm as tllm
from slam_llm_tpu_torch.models import projector as tproj
from slam_llm_tpu_torch.models import slam_model as tslam
from slam_llm_tpu_torch.models import whisper as twhisper
from slam_llm_tpu_torch.models.layers import DenseGeneralLora
from slam_llm_tpu_torch.train.optimizer import lr_schedule, param_label, partition_params
from slam_llm_tpu_torch.train.state import Trainer
from slam_llm_tpu_torch.utils.convert import from_flax_params, trainable_to_flax

PAD = 0


def _jax_cfg(base_quant="none", bwd="bf16", dtype=jnp.float32):
    llm = dataclasses.replace(JLLMConfig.tiny_test(), lora_rank=4, lora_dropout=0.0, dtype=dtype,
                              base_quant=base_quant, base_quant_bwd=bwd)
    enc = dataclasses.replace(JWhisperConfig.tiny_test(), dtype=dtype)
    proj = JProjectorConfig(encoder_dim=enc.d_model, llm_dim=llm.d_model, ds_rate=5, hidden_dim=32, dtype=dtype)
    return JSLAMConfig(llm=llm, encoder_name="whisper", encoder=enc, projector="linear",
                       projector_cfg=proj, freeze_encoder=True, freeze_llm=True)


def _port_cfg(jcfg, dtype=torch.float32):
    def conv(cls, obj):
        names = {f.name for f in dataclasses.fields(cls)} - {"dtype", "param_dtype"}
        return cls(**{n: getattr(obj, n) for n in names if hasattr(obj, n)}, dtype=dtype)

    return tslam.SLAMConfig(
        llm=conv(tllm.LLMConfig, jcfg.llm), encoder_name="whisper",
        encoder=conv(twhisper.WhisperEncoderConfig, jcfg.encoder), projector="linear",
        projector_cfg=conv(tproj.ProjectorConfig, jcfg.projector_cfg),
        freeze_encoder=jcfg.freeze_encoder, freeze_llm=jcfg.freeze_llm,
    )


def _batch():
    """Two rows, row 0 left-padded by 3: 12 audio pseudo-tokens (-1), then
    text; labels on the text after the first two tokens of each row."""
    rng = np.random.default_rng(0)
    b, t, n_audio = 2, 24, 12
    ids = rng.integers(3, 250, (b, t)).astype(np.int64)
    attn = np.ones((b, t), np.int32)
    modality = np.zeros((b, t), np.int32)
    labels = ids.copy()
    attn[0, :3] = 0
    ids[0, :3] = PAD
    for row, start in ((0, 3), (1, 0)):
        ids[row, start:start + n_audio] = -1
        modality[row, start:start + n_audio] = 1
        labels[row, :start + n_audio + 2] = -100
    mel_mask = np.ones((b, 128), np.int32)
    mel_mask[1, 100:] = 0
    return {"input_ids": ids, "attention_mask": attn, "modality_mask": modality, "labels": labels,
            "audio_mel": rng.standard_normal((b, 128, 8)).astype(np.float32), "audio_mel_mask": mel_mask}


def _params(jcfg, seed=0):
    """JAX init with every lora_b drawn nonzero (it inits to 0)."""
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    variables = JSLAMModel(jcfg).init(jax.random.PRNGKey(seed), batch, method="init_all")
    rng = np.random.default_rng(seed + 1)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict)
                else (rng.standard_normal(np.shape(v)) * 0.3).astype(np.float32) if k == "lora_b"
                else np.asarray(v) for k, v in node.items()}

    return walk(nn.meta.unbox(variables["params"]))


def _port_model(jcfg, params, dtype=torch.float32):
    tcfg = _port_cfg(jcfg, dtype)
    tm = tslam.SLAMModel(tcfg)
    tm.load_state_dict(from_flax_params(params, tcfg))
    return tcfg, tm


def _leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: x is None)[0]
    return {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v) for path, v in flat if v is not None}


def _tbatch():
    return {k: torch.from_numpy(v) for k, v in _batch().items()}


def test_trainable_masters_load_f32_bit_equal():
    """A bf16 port model keeps the LoRA factors and the projector as f32
    masters, bit-equal to the JAX values; frozen weights stay bf16."""
    jcfg = _jax_cfg("int8")
    params = _params(jcfg)
    tcfg, tm = _port_model(jcfg, params, torch.bfloat16)
    trainable, frozen = partition_params(tm, tcfg)
    assert trainable and all(p.dtype == torch.float32 for p in trainable.values())
    assert {p.dtype for n, p in frozen.items() if "norm" not in n and "ln" not in n} == {torch.bfloat16}
    want = _leaves(params)
    for path, arr in _leaves(trainable_to_flax(trainable)).items():
        np.testing.assert_array_equal(arr, want[path])


def _nearest(records, x):
    """The recorded JAX array of ``x``'s shape nearest to ``x`` (max abs)."""
    cands = [r for r in records if r[0].shape == x.shape]
    assert cands, x.shape
    return min(cands, key=lambda r: np.abs(r[0] - x).max())


def _pin_int8_roundings(monkeypatch):
    """Make the port take the JAX side's rounding decisions in the int8
    base, after checking that they differ only where the two f32 values
    straddle a rounding boundary.

    Two roundings depend on f32 values that the packages compute in another
    order: the activation's int8 codes (``act_quant``) and, in the bf16
    backward, dy's rounding to bf16. Where an f32 value sits on a boundary,
    the two sides round it apart; a flipped bf16 dy entry moves a gradient
    by up to 2**-8 of that entry, which is why the comparison used to hinge
    on the host. Here the JAX side records its codes and its bf16 dy (a
    wrapper on ``act_quant`` and on the bf16 backward rule), and the port's
    ``act_quant`` and each int8 dense's incoming dy are held against the
    record: activations and dy agree within f32 noise (1e-4 of the largest
    entry), codes differ by at most 1 in at most 1% of the entries, and every
    bf16 flip is between adjacent bf16 values, unless the two f32 values are
    already over half a bf16 step apart (entries near 0, where f32 noise is
    large beside the value). The port then proceeds with the
    JAX decisions, so the gradients meet the f32 bound. Returns the JAX
    package's recording hooks to install: ``(install, restore)``."""
    import slam_llm_tpu.ops.quant as jq
    import slam_llm_tpu_torch.models.layers as tl
    import slam_llm_tpu_torch.ops.quant as tq

    acts, dys = [], []
    j_act_quant = jq.act_quant

    def j_recording_act_quant(x):
        x_q, x_s = j_act_quant(x)
        jax.debug.callback(lambda *a: acts.append(tuple(np.asarray(v) for v in a)), x, x_q, x_s)
        return x_q, x_s

    def j_recording_bwd(res, dy):
        jax.debug.callback(lambda a: dys.append((np.asarray(a),)), dy)
        return jq._int8_dot_bwdbf16_bwd(res, dy)

    def install():
        jq.act_quant = j_recording_act_quant
        jq._int8_dot_bwdbf16.defvjp(jq._int8_dot_bwdbf16_fwd, j_recording_bwd)

    def restore():
        jq.act_quant = j_act_quant
        jq._int8_dot_bwdbf16.defvjp(jq._int8_dot_bwdbf16_fwd, jq._int8_dot_bwdbf16_bwd)
        jax.effects_barrier()

    t_act_quant = tq.act_quant

    def pinned_act_quant(x):
        x_q, x_s = t_act_quant(x)
        xa, jx_q, jx_s = _nearest(acts, x.detach().numpy())
        assert np.abs(xa - x.detach().numpy()).max() <= 1e-4 * np.abs(xa).max()
        diff = np.abs(jx_q.astype(np.int32) - x_q.numpy().reshape(jx_q.shape).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, (diff.max(), (diff > 0).sum())
        np.testing.assert_allclose(x_s.numpy().reshape(jx_s.shape), jx_s, rtol=1e-5)
        return torch.from_numpy(jx_q.reshape(x_q.shape).copy()), torch.from_numpy(jx_s.reshape(x_s.shape).copy())

    def pin_dy(g):
        gn = g.numpy()
        (jd,) = _nearest(dys, gn)
        top = np.abs(jd).max()
        assert np.abs(jd - gn).max() <= 1e-4 * top
        pb = torch.from_numpy(gn).to(torch.bfloat16)
        jb = torch.from_numpy(jd).to(torch.bfloat16)
        flip = (pb != jb).numpy()
        steps = np.abs(pb.view(torch.int16).numpy().astype(np.int32) - jb.view(torch.int16).numpy().astype(np.int32))
        apart = np.abs(gn - jd) > 2.0**-9 * np.maximum(np.abs(gn), np.abs(jd))  # over half a bf16 step
        assert ((steps == 1) | apart)[flip].all()
        return torch.from_numpy(np.where(flip, jb.float().numpy(), gn))

    t_int8_dot = tl.int8_dot

    def pinned_int8_dot(*args, **kwargs):
        y = t_int8_dot(*args, **kwargs)
        if y.requires_grad:
            y.register_hook(pin_dy)
        return y

    monkeypatch.setattr(tq, "act_quant", pinned_act_quant)
    monkeypatch.setattr(tl, "int8_dot", pinned_int8_dot)
    return install, restore


@pytest.mark.parametrize("base_quant", ["none", "int8"])
def test_loss_and_trainable_grads_match_jax(base_quant, monkeypatch):
    """f32, dropout off, int8 with the bf16 backward: loss within 1e-5
    relative, acc equal, every trainable gradient (projector, LoRA) within
    1e-4 of its largest entry against jax.value_and_grad; the unfused
    ``return_logits`` path gives the same loss. With the int8 base the port
    takes the JAX side's int8 codes and bf16 dy roundings, after checking
    that they differ only at rounding boundaries (``_pin_int8_roundings``)."""
    jcfg = _jax_cfg(base_quant)
    params = _params(jcfg)
    trainable, frozen = j_partition(params, jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in _batch().items()}

    def loss_fn(tr):
        out = JSLAMModel(jcfg).apply({"params": j_merge(tr, frozen)}, jbatch)
        return out["loss"], out["acc"]

    install = restore = lambda: None  # noqa: E731
    if base_quant == "int8":
        install, restore = _pin_int8_roundings(monkeypatch)
    install()
    try:
        (jl, ja), jg = jax.value_and_grad(loss_fn, has_aux=True)(trainable)
    finally:
        restore()
    tcfg, tm = _port_model(jcfg, params)
    tr, _ = partition_params(tm, tcfg)
    out = tm(_tbatch())
    grads = torch.autograd.grad(out["loss"], list(tr.values()))
    np.testing.assert_allclose(float(out["loss"].detach()), float(jl), rtol=1e-5)
    assert float(out["acc"]) == float(ja)
    got = _leaves(trainable_to_flax(dict(zip(tr.keys(), grads))))
    want = _leaves(jg)
    assert set(got) == set(want) and len(got) == 4 + 4  # projector kernels + biases, LoRA A/B of q and v (layer-stacked)
    for path, g in got.items():
        w = want[path]
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), path
    with torch.no_grad():
        unfused = tm(_tbatch(), return_logits=True)
    np.testing.assert_allclose(float(unfused["loss"]), float(out["loss"].detach()), rtol=1e-5)


def test_three_trainer_steps_match_jax():
    """Three steps of the port's Trainer against the JAX Trainer.train_step
    on the same batch (f32, bf16-stored frozen base, warmup 2): the
    lr trajectory is equal, loss and grad norm agree within 1e-5 relative,
    and every trainable tensor after each step is within 1e-5 of its norm."""
    from slam_llm_tpu.parallel import make_mesh
    from slam_llm_tpu.train.state import build_trainer

    jcfg = _jax_cfg("none")
    params = _params(jcfg)
    tc = TrainConfig()
    tc.use_peft, tc.lr, tc.warmup_steps, tc.total_steps, tc.seed = True, 1e-3, 2, 10, 0
    tc.peft_config.lora_dropout = 0.0
    mesh = make_mesh(dp=1, fsdp=1, tp=1, devices=jax.devices()[:1])
    jt = build_trainer(JSLAMModel(jcfg), jcfg, tc, mesh)
    state = jt.state_from_params(jax.tree_util.tree_map(jnp.asarray, params))
    with mesh:
        db = jt.put_batch(_batch())
    tcfg, tm = _port_model(jcfg, params)
    trainer = Trainer(tm, tcfg, tc).state_from_params()
    lrs = []
    for i in range(3):
        with mesh:
            state, m = jt.train_step(state, db, jax.random.PRNGKey(i))
        tmet = trainer.train_step(_tbatch())
        lrs.append(tmet["lr"])
        assert np.float32(tmet["lr"]) == np.float32(m["lr"])
        np.testing.assert_allclose(float(tmet["loss"]), float(m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(m["grad_norm"]), rtol=1e-5)
        want = _leaves(state["trainable"])
        for path, got in _leaves(trainable_to_flax(trainer.trainable)).items():
            w = want[path]
            assert np.linalg.norm(got - w) <= 1e-5 * np.linalg.norm(w), (i, path)
    assert lrs[0] == 0.0 and 0 < lrs[1] < lrs[2]  # warmup from lr 0 at step 0


def test_lr_schedule_matches_optax():
    from slam_llm_tpu.train.optimizer import lr_schedule as j_schedule

    tc = TrainConfig()
    tc.lr, tc.warmup_steps, tc.total_steps = 1e-4, 1000, 100000
    ours, theirs = lr_schedule(tc), j_schedule(tc)
    for count in (0, 1, 2, 500, 999, 1000, 1001, 50000, 99999, 100000, 200000):
        assert np.float32(ours(count)) == np.float32(theirs(count)), count


def test_param_labels_follow_the_reference():
    cfg = tslam.SLAMConfig(freeze_encoder=True, freeze_llm=True)
    assert param_label("encoder_projector.linear1.weight", cfg) == "train"
    assert param_label("llm.layers.3.attn.q_proj.lora_a", cfg) == "train"
    assert param_label("encoder.layers.0.fc1.weight", cfg) == "freeze"
    assert param_label("llm.layers.0.attn.q_proj.weight", cfg) == "freeze"
    unfrozen = dataclasses.replace(cfg, freeze_encoder=False, freeze_llm=False)
    assert param_label("encoder.conv1.weight", unfrozen) == param_label("llm.lm_head.weight", unfrozen) == "train"


# ---- the port's own training machinery -----------------------------------------


def _rot_model():
    jcfg = _jax_cfg("int8", "int8_rot")
    tcfg, tm = _port_model(jcfg, _params(jcfg))
    tc = TrainConfig()
    tc.use_peft, tc.seed = True, 3
    tc.peft_config.lora_dropout = 0.0
    return tm, Trainer(tm, tcfg, tc).state_from_params()


def test_int8_rot_seeds_are_fresh_per_step_and_per_layer():
    """One uint32 per int8_rot dense per step, all distinct, drawn anew each
    step from the seeded generator; the seeds reach the backward (the
    reference's quant rng stream: a fixed seed would repeat the dither)."""
    tm, trainer = _rot_model()
    assert len(trainer.sr_modules) == 2 * 7
    s1, s2 = trainer.draw_quant_seeds(), trainer.draw_quant_seeds()
    assert len(set(s1)) == len(s1) and not set(s1) & set(s2)
    assert [m.quant_seed for m in trainer.sr_modules] == s2
    assert all(0 <= s < 2 ** 32 for s in s1 + s2)
    _, again = _rot_model()
    assert again.draw_quant_seeds() == s1  # seeded from train_config.seed

    def grads(seeds):
        for mod, seed in zip(trainer.sr_modules, seeds):
            mod.quant_seed = seed
        out = tm(_tbatch())
        return torch.autograd.grad(out["loss"], list(trainer.trainable.values()))

    a, b, c = grads(s1), grads(s1), grads(s2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))


def test_lora_dropout_rate_and_scaling():
    """Training mode drops LoRA inputs at the configured rate (within 4
    standard errors over 262,144 draws) and scales the kept ones by
    1 / (1 - p); eval mode and the base path see no dropout; the
    generator's seed reproduces the mask."""
    p, k = 0.25, 64
    mod = DenseGeneralLora(k, k, dtype=torch.float32, lora_rank=k, lora_alpha=float(k), lora_dropout=p)
    with torch.no_grad():
        mod.weight.copy_(torch.eye(k) * 0)
        mod.lora_a.copy_(torch.eye(k))
        mod.lora_b.copy_(torch.eye(k))
    x = torch.ones(4096, k)
    mod.generator = torch.Generator().manual_seed(0)
    y = mod.train()(x)
    dropped = (y == 0).double().mean().item()
    assert abs(dropped - p) < 4 * (p * (1 - p) / x.numel()) ** 0.5
    kept = y[y != 0]
    assert torch.equal(kept, torch.full_like(kept, 1.0) / torch.tensor(1.0 - p))
    mod.generator = torch.Generator().manual_seed(0)
    assert torch.equal(mod(x), y)
    assert torch.equal(mod.eval()(x), x)


def _tiny_train_cfg(tmp_path, **extra):
    from helpers import make_corpus, tiny_run_config

    manifest = make_corpus(tmp_path, n=4)
    return tiny_run_config(manifest, **{
        "train_config.use_peft": True,
        "train_config.freeze_encoder": True,
        "train_config.freeze_llm": True,
        "train_config.shard.base_quant": "int8",
        "train_config.shard.base_quant_bwd": "int8_rot",
        "train_config.max_steps_per_epoch": 2,
        "train_config.log_interval": 1,
        "train_config.model_name": "tiny_asr",
        "train_config.output_dir": str(tmp_path / "out"),
        **extra,
    })


def test_finetune_cli_cpu_trains_and_writes_the_checkpoint(tmp_path):
    """The recipe's training options (int8 base, int8_rot backward, LoRA
    dropout 0.05) on the tiny corpus: finite losses and gradient norms,
    a validation, and a trainable-only ``model.pt`` of f32 tensors."""
    from slam_llm_tpu_torch.pipeline import finetune

    res = finetune.main(_tiny_train_cfg(tmp_path), device="cpu")
    steps = res["steps"]
    assert [s["step"] for s in steps] == [1, 2] and all(s["shape"][0] == 2 for s in steps)
    assert all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) and s["tokens"] > 0 for s in steps)
    assert steps[0]["lr"] == 0.0 and steps[1]["lr"] > 0
    assert np.isfinite(res["final_val"]["loss"])
    ckpt = Path(res["checkpoints"][-1])
    assert ckpt.name == "tiny_asr_epoch_1_step_2"
    sd = torch.load(ckpt / "model.pt", map_location="cpu", weights_only=True)
    assert set(sd) == set(res["trainer"].trainable) and all(t.dtype == torch.float32 for t in sd.values())
    assert any("lora_a" in n for n in sd) and any("encoder_projector" in n for n in sd)


def test_finetune_cli_refuses_cuda_without_a_gpu():
    from slam_llm_tpu_torch.pipeline import finetune

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        finetune.main_cli(["--device", "cuda"])


def _dense_modes(trainer):
    return {n.rsplit(".", 1)[-1]: m.quant_bwd for n, m in trainer.model.named_modules()
            if n.startswith("llm.layers.0.") and hasattr(m, "quant_bwd")}


def _reached(key, res, tmp_path):
    """What each ported training option leaves behind after its step."""
    from slam_llm_tpu_torch.train.optimizer import AnyPrecisionAdamW, MultiSteps

    trainer = res["trainer"]
    llm = trainer.model.llm
    return {
        "int8_sr": lambda: set(_dense_modes(trainer).values()) == {"int8_sr"} and all(
            m.kernel_qt.abs().sum() > 0 for m in trainer.sr_modules),
        "int8": lambda: set(_dense_modes(trainer).values()) == {"int8"} and not trainer.sr_modules,
        "int8_sr_mlp": lambda: _dense_modes(trainer) == {
            "q_proj": "bf16", "k_proj": "bf16", "v_proj": "bf16", "o_proj": "bf16",
            "gate_proj": "int8_sr", "up_proj": "int8_sr", "down_proj": "int8_sr"},
        "int8_rot_otf": lambda: set(_dense_modes(trainer).values()) == {"int8_rot_otf"} and not any(
            n.endswith("kernel_qr") for n, _ in trainer.model.named_buffers()) and len(trainer.sr_modules) == 14,
        "ce_quant": lambda: llm.head_q.abs().sum() > 0 and torch.equal(llm.head_qt, llm.head_q.T),
        "frozen_dtype": lambda: {p.dtype for n, p in trainer.frozen.items() if "norm" in n} == {torch.float32},
        "optimizer": lambda: isinstance(trainer.optimizer, AnyPrecisionAdamW) and trainer.optimizer.count == 1,
        "gradient_accumulation_steps": lambda: isinstance(trainer.optimizer, MultiSteps) and trainer.step == 2
        and trainer.optimizer.inner.count == 1,
        "run_test_during_validation": lambda: len(res["decoded"]) == 1 and isinstance(res["decoded"][0], str),
        "save_optimizer": lambda: (Path(res["checkpoints"][-1]) / "full_state.pt").is_file(),
    }[key]()


@pytest.mark.parametrize(
    "key,overrides,raises",
    [
        ("int8_sr", {"train_config.shard.base_quant_bwd": "int8_sr"}, None),
        ("int8", {"train_config.shard.base_quant_bwd": "int8"}, None),
        ("int8_sr_mlp", {"train_config.shard.base_quant_bwd": "int8_sr_mlp"}, None),
        ("int8_rot_otf", {"train_config.shard.base_quant_bwd": "int8_rot_otf"}, None),
        ("ce_quant", {"train_config.shard.ce_quant": "int8"}, None),
        ("frozen_dtype", {"train_config.frozen_dtype": "float32"}, None),
        ("optimizer", {"train_config.optimizer": "anyprecision"}, None),
        ("gradient_accumulation_steps", {"train_config.gradient_accumulation_steps": 2,
                                         "train_config.max_steps_per_epoch": 2}, None),
        ("run_test_during_validation", {"train_config.run_test_during_validation": True,
                                        "decode_config.max_new_tokens": 3}, None),
        ("resume_from", {"train_config.resume_from": "/nonexistent"}, (FileNotFoundError, "full training state")),
        ("save_optimizer", {"train_config.save_optimizer": True}, None),
        ("tp", {"train_config.shard.tp": 2}, (ValueError, r"1 processes not divisible by fsdp\*tp=2")),
        ("fsdp", {"train_config.shard.fsdp": 2}, (ValueError, "1 processes not divisible by fsdp")),
    ],
)
def test_unported_training_options_raise(tmp_path, key, overrides, raises):
    """The training options that were not ported before: each ported one
    trains on the CPU through the finetune CLI and reaches its own code
    path; a mesh of two processes (fsdp=2 or tp=2) in one process raises as
    the reference's ``make_mesh`` does on one device, and a resume from a
    directory with no full state says so."""
    from helpers import write_wav

    from slam_llm_tpu_torch.pipeline import finetune

    extra = {"train_config.max_steps_per_epoch": 1, **overrides}
    if key == "run_test_during_validation":
        extra["train_config.run_test_during_validation_file"] = str(write_wav(tmp_path / "probe.wav", seconds=0.3))
    cfg = _tiny_train_cfg(tmp_path, **extra)
    if raises is not None:
        with pytest.raises(raises[0], match=raises[1]):
            finetune.main(cfg, device="cpu")
        return
    res = finetune.main(cfg, device="cpu")
    assert res["steps"] and all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) for s in res["steps"])
    assert _reached(key, res, tmp_path)


def test_build_slam_config_maps_the_recipes_training_knobs():
    """The recipe's yaml through the port's ``build_slam_config``: the int8
    base with the int8_rot backward, LoRA r8 / alpha 32 / dropout 0.05 on
    q and v, remat with the dots_flash_saveable policy, both freeze flags,
    f32 trainable masters."""
    from slam_llm_tpu.config import load_run_config

    recipe = Path(__file__).resolve().parent.parent / "examples/asr_librispeech/conf/asr_whisper_tinyllama.yaml"
    cfg = load_run_config(["--config", str(recipe)])
    sc = tslam.build_slam_config(cfg.train_config, cfg.model_config)
    llm = sc.llm
    assert (llm.base_quant, llm.base_quant_bwd) == ("int8", "int8_rot")
    assert (llm.lora_rank, llm.lora_alpha, llm.lora_dropout, llm.lora_targets) == (8, 32.0, 0.05, ("q_proj", "v_proj"))
    assert llm.remat and llm.remat_policy == "dots_flash_saveable"
    assert sc.freeze_encoder and sc.freeze_llm
    assert sc.projector_cfg.param_dtype == torch.float32 and llm.dtype == torch.bfloat16
