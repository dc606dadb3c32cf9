"""The port's (dp, fsdp) mesh on torch.distributed, on the CPU with gloo.

Worker processes run this file as a script with torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT`` on a
free port, ``OMP_NUM_THREADS=1``), each joining one gloo process group and
running the jobs of a payload file in order; rank 0 writes each job's
result. Three groups run side by side while this process computes the
references:

* two ranks: ``fsdp=2`` trainer steps (LoRA and remat ``dots_flash_saveable``
  in f32 against the JAX ``Trainer`` on its own ``fsdp=2`` mesh; the int8 base
  with the ``int8_rot`` backward against the one-process port), the mesh
  checks, ``pipeline.finetune`` at ``fsdp=2`` (checkpoints, resume from a
  one-process state) and a two-rank ``pipeline.inference_batch``;
* two ranks, started once the JAX side has recorded its int8 roundings:
  ``fsdp=2`` with the int8 base and the bf16 backward against the JAX
  ``Trainer`` (the port taking the JAX side's rounding decisions), and LoRA
  under every other remat policy and with remat off;
* four ranks: ``(dp=2, fsdp=2)`` with the whole model trained against the
  JAX ``Trainer`` on ``(dp=2, fsdp=2)``.

The weights go into both packages through ``utils.convert``; every worker
has ``PROC_TIMEOUT`` seconds and each collective ``DIST_TIMEOUT``.
"""

import contextlib
import dataclasses
import os
import socket
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

from slam_llm_tpu_torch.models.remat import POLICIES

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
PROC_TIMEOUT = 120
DIST_TIMEOUT = timedelta(seconds=90)  # a worker's collectives; a hang fails the group
STEPS = 3
# the remat settings held sharded besides the recipe's dots_flash_saveable
OTHER_REMAT = sorted(set(POLICIES) - {"dots_flash_saveable"}) + ["off"]
BF16 = 2.0 ** -8  # one rounding of the compute dtype, relative
# one more step from a saved state: its first batch, then a checkpoint
_CONTINUE = {"train_config.num_epochs": 1, "train_config.max_steps_per_epoch": 1,
             "train_config.run_validation": False}


# ---- the worker side (no JAX) ------------------------------------------------------


def _trainer_job(job):
    import torch.distributed as dist

    from slam_llm_tpu_torch.models import remat
    from slam_llm_tpu_torch.models import slam_model as tslam
    from slam_llm_tpu_torch.parallel.sharding import INT8_BASE_TENSORS, local_part, make_mesh
    from slam_llm_tpu_torch.train.state import Trainer

    calls = [0]
    apply = remat._CheckpointedLayer.apply

    def counted(*args):
        calls[0] += 1
        return apply(*args)

    remat._CheckpointedLayer.apply = counted
    unpin = _pin_int8(job["pins"], dist.get_rank(), dist.get_world_size()) if "pins" in job else None
    pinned = None
    try:
        model = tslam.SLAMModel(job["tcfg"])
        model.load_state_dict(job["state_dict"])
        mesh = make_mesh(dp=job["dp"], fsdp=job["fsdp"], device_type="cpu")
        trainer = Trainer(model, job["tcfg"], job["tc"], mesh=mesh).state_from_params()
        metrics = []
        for _ in range(STEPS):
            m = trainer.train_step(trainer.put_batch(job["batch"]))
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        remat._CheckpointedLayer.apply = apply
        if unpin is not None:
            pinned = unpin()
    base = {n: tuple(local_part(p).shape) for n, p in model.named_parameters()
            if n.rsplit(".", 1)[-1] in INT8_BASE_TENSORS}
    return {"metrics": metrics, "trainable": trainer.whole_trainable(), "remat_calls": calls[0],
            "base_shapes": base, "world": dist.get_world_size(), "pinned": pinned}


def _nearest(records, x):
    """The record (a tuple of arrays) whose first array has ``x``'s shape
    and is nearest to ``x`` (max abs)."""
    cands = [r for r in records if r[0].shape == x.shape]
    assert cands, x.shape
    return min(cands, key=lambda r: np.abs(r[0] - x).max())


def _pin_int8(pins, rank: int, world: int):
    """``test_torch_train._pin_int8_roundings``'s port side on one rank of an
    ``fsdp`` mesh: the JAX ``Trainer`` recorded, on the global batch, each
    int8 dense's activation with its int8 codes and scales, and each bf16
    backward's dy; this rank holds rows ``[r B/n, (r+1) B/n)`` of each. The
    port's ``act_quant`` and incoming dy are held against the record
    (activations and dy within 1e-4 of the largest entry, codes apart by at
    most 1 in at most 1% of the entries, bf16 flips between adjacent values
    unless the f32 values are over half a bf16 step apart), then take the
    JAX side's decisions. Returns the undo, which returns how often each
    was pinned."""
    import slam_llm_tpu_torch.models.layers as tl
    import slam_llm_tpu_torch.ops.quant as tq

    def mine(a):
        n = a.shape[0] // world
        return a[rank * n:(rank + 1) * n]

    acts = [tuple(mine(a) for a in rec) for rec in pins["acts"]]
    pinned = {"act_quant": 0, "dy": 0}
    dys = [(mine(d),) for (d,) in pins["dys"]]
    t_act_quant, t_int8_dot = tq.act_quant, tl.int8_dot

    def pinned_act_quant(x):
        x_q, x_s = t_act_quant(x)
        xa, jx_q, jx_s = _nearest(acts, x.detach().numpy())
        assert np.abs(xa - x.detach().numpy()).max() <= 1e-4 * np.abs(xa).max()
        diff = np.abs(jx_q.astype(np.int32) - x_q.numpy().reshape(jx_q.shape).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, (diff.max(), (diff > 0).sum())
        np.testing.assert_allclose(x_s.numpy().reshape(jx_s.shape), jx_s, rtol=1e-5)
        pinned["act_quant"] += 1
        return torch.from_numpy(jx_q.reshape(x_q.shape).copy()), torch.from_numpy(jx_s.reshape(x_s.shape).copy())

    def pin_dy(g):
        gn = g.numpy()
        (jd,) = _nearest(dys, gn)
        assert np.abs(jd - gn).max() <= 1e-4 * np.abs(jd).max()
        pb, jb = torch.from_numpy(gn).to(torch.bfloat16), torch.from_numpy(jd).to(torch.bfloat16)
        flip = (pb != jb).numpy()
        steps = np.abs(pb.view(torch.int16).numpy().astype(np.int32) - jb.view(torch.int16).numpy().astype(np.int32))
        apart = np.abs(gn - jd) > 2.0**-9 * np.maximum(np.abs(gn), np.abs(jd))  # over half a bf16 step
        assert ((steps == 1) | apart)[flip].all()
        pinned["dy"] += 1
        return torch.from_numpy(np.where(flip, jb.float().numpy(), gn))

    def pinned_int8_dot(*args, **kwargs):
        y = t_int8_dot(*args, **kwargs)
        if y.requires_grad:
            y.register_hook(pin_dy)
        return y

    tq.act_quant, tl.int8_dot = pinned_act_quant, pinned_int8_dot

    def undo():
        tq.act_quant, tl.int8_dot = t_act_quant, t_int8_dot
        return pinned

    return undo


def _mesh_job(job):
    import torch.distributed as dist

    from slam_llm_tpu_torch.parallel.sharding import data_rank, data_size, make_mesh, shard_batch

    world = dist.get_world_size()
    out = {"world": world}
    mesh = make_mesh(dp=-1, fsdp=1, device_type="cpu")
    out["absorbed"] = tuple(mesh.shape)
    for name, kw in (("smaller", {"dp": 1, "fsdp": 1}), ("indivisible", {"dp": -1, "fsdp": 3})):
        try:
            make_mesh(device_type="cpu", **kw)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    mesh = make_mesh(dp=1, fsdp=world, device_type="cpu")
    rows = shard_batch(mesh, {"x": np.arange(2 * world)[:, None], "keys": ["k"] * 2 * world})
    got = [None] * world
    dist.all_gather_object(got, (data_rank(mesh), data_size(mesh), rows["x"][:, 0].tolist()))
    out["rows"] = got
    try:
        shard_batch(mesh, {"x": np.zeros((world + 1, 2))})
        out["ragged"] = None
    except ValueError as e:
        out["ragged"] = str(e)
    return out


def _finetune_job(job):
    from slam_llm_tpu_torch.pipeline import finetune

    res = finetune.main(job["cfg"], device="cpu")
    return {k: res[k] for k in ("steps", "checkpoints", "final_val", "base_bytes") if k in res}


def _decode_job(job):
    from slam_llm_tpu_torch.pipeline import inference_batch

    return inference_batch.main(job["cfg"], device="cpu")


def _worker(payload: str, out_dir: str) -> None:
    import torch.distributed as dist

    from slam_llm_tpu_torch.pipeline.common import maybe_init_distributed

    torch.set_num_threads(1)
    assert maybe_init_distributed("cpu", timeout=DIST_TIMEOUT)
    jobs = {"trainer": _trainer_job, "mesh": _mesh_job, "finetune": _finetune_job, "decode": _decode_job}
    for job in torch.load(payload, weights_only=False):
        result = jobs[job["kind"]](job)
        if dist.get_rank() == 0:
            torch.save(result, Path(out_dir) / f"{job['name']}.pt")
    dist.destroy_process_group()


# ---- the launcher ---------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _Group:
    """``n`` worker processes on one payload; ``result(name)`` waits for all.
    Each runs ``script`` (this file by default) with the payload and the
    output directory as its arguments."""

    def __init__(self, n: int, jobs, tmp: Path, script: Path = Path(__file__)):
        self.dir = tmp
        tmp.mkdir(parents=True, exist_ok=True)
        torch.save(jobs, tmp / "payload.pt")
        port = _free_port()
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   WORLD_SIZE=str(n))
        self.procs = []
        for r in range(n):
            log = open(tmp / f"rank{r}.log", "w")
            self.procs.append(subprocess.Popen(
                [sys.executable, str(script), str(tmp / "payload.pt"), str(tmp)],
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=log, stderr=subprocess.STDOUT, cwd=str(tmp)))
        self.t0 = time.monotonic()
        self.rcs = None

    def wait(self):
        if self.rcs is None:
            rcs = []
            for p in self.procs:
                try:
                    rcs.append(p.wait(timeout=max(1.0, PROC_TIMEOUT - (time.monotonic() - self.t0))))
                except subprocess.TimeoutExpired:
                    for q in self.procs:
                        q.kill()
                    rcs.append("timeout")
            self.rcs = rcs
        if any(rc != 0 for rc in self.rcs):
            logs = "\n".join((self.dir / f"rank{r}.log").read_text()[-3000:] for r in range(len(self.procs)))
            pytest.fail(f"worker exit codes {self.rcs}:\n{logs}")

    def result(self, name: str):
        self.wait()
        return torch.load(self.dir / f"{name}.pt", weights_only=False)


# ---- the references -------------------------------------------------------------------


def _train_config(port=True):
    """The trainer settings of ``test_torch_train``: warmup 2 from lr 0,
    LoRA dropout off (the port's TrainConfig, or the JAX package's)."""
    if port:
        from slam_llm_tpu_torch.config import TrainConfig
    else:
        from slam_llm_tpu.config import TrainConfig

    tc = TrainConfig()
    tc.use_peft, tc.lr, tc.warmup_steps, tc.total_steps, tc.seed = True, 1e-3, 2, 10, 0
    tc.peft_config.lora_dropout = 0.0
    return tc


def _global_batch():
    """Four rows in ``test_torch_train._batch``'s layout (12 audio
    pseudo-tokens, then text; labels after the first two text tokens), rows
    0 and 2 left-padded, so every rank of a four-way split gets a row."""
    rng = np.random.default_rng(1)
    b, t, n_audio = 4, 24, 12
    ids = rng.integers(3, 250, (b, t)).astype(np.int64)
    attn = np.ones((b, t), np.int32)
    modality = np.zeros((b, t), np.int32)
    labels = ids.copy()
    mel_mask = np.ones((b, 128), np.int32)
    for row, start in enumerate((3, 0, 2, 0)):
        attn[row, :start] = 0
        ids[row, :start] = 0
        ids[row, start:start + n_audio] = -1
        modality[row, start:start + n_audio] = 1
        labels[row, :start + n_audio + 2] = -100
    mel_mask[1, 100:] = 0
    mel_mask[3, 64:] = 0
    return {"input_ids": ids, "attention_mask": attn, "modality_mask": modality, "labels": labels,
            "audio_mel": rng.standard_normal((b, 128, 8)).astype(np.float32), "audio_mel_mask": mel_mask}


def _configs(kind):
    """(JAX SLAMConfig, port SLAMConfig, JAX params, port state dict) of a case."""
    from test_torch_train import _jax_cfg, _params, _port_model

    from slam_llm_tpu_torch.models import slam_model as tslam

    base, bwd = {"int8_rot": ("int8", "int8_rot"), "int8": ("int8", "bf16")}.get(kind, ("none", "bf16"))
    jcfg = _jax_cfg(base, bwd)
    if kind == "full":
        jcfg = dataclasses.replace(jcfg, freeze_encoder=False, freeze_llm=False)
    jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm, remat=True,
                                                             remat_policy="dots_flash_saveable"))
    params = _params(jcfg)
    tcfg, tm = _port_model(jcfg, params)
    llm = dataclasses.replace(tcfg.llm, remat=True, remat_policy="dots_flash_saveable")
    tcfg = dataclasses.replace(tcfg, llm=llm)
    if kind == "full":
        tcfg = dataclasses.replace(tcfg, freeze_encoder=False, freeze_llm=False)
    sd = tm.state_dict()
    tm = tslam.SLAMModel(tcfg)
    tm.load_state_dict(sd)
    return jcfg, tcfg, params, sd


@contextlib.contextmanager
def _jax_int8_records():
    """Inside, the JAX package's int8 base records what it rounds
    (``test_torch_train._pin_int8_roundings``'s JAX side): each
    ``act_quant``'s activation, codes and scales, and each bf16 backward's
    incoming dy, all of the global batch; yields ``{"acts", "dys"}``."""
    import jax

    import slam_llm_tpu.ops.quant as jq

    pins = {"acts": [], "dys": []}
    j_act_quant = jq.act_quant

    def recording_act_quant(x):
        x_q, x_s = j_act_quant(x)
        jax.debug.callback(lambda *a: pins["acts"].append(tuple(np.asarray(v) for v in a)), x, x_q, x_s)
        return x_q, x_s

    def recording_bwd(res, dy):
        jax.debug.callback(lambda a: pins["dys"].append((np.asarray(a),)), dy)
        return jq._int8_dot_bwdbf16_bwd(res, dy)

    jq.act_quant = recording_act_quant
    jq._int8_dot_bwdbf16.defvjp(jq._int8_dot_bwdbf16_fwd, recording_bwd)
    try:
        yield pins
    finally:
        jq.act_quant = j_act_quant
        jq._int8_dot_bwdbf16.defvjp(jq._int8_dot_bwdbf16_fwd, jq._int8_dot_bwdbf16_bwd)
        jax.effects_barrier()


def _jax_steps(jcfg, params, dp, fsdp, tp=1):
    """The JAX Trainer's losses, grad norms and trainable leaves over STEPS
    steps on its (dp, fsdp, tp) mesh of virtual CPU devices, the params laid
    out by the logical rules."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn
    from test_torch_train import _batch, _leaves

    from slam_llm_tpu.models.slam_model import SLAMModel as JSLAMModel
    from slam_llm_tpu.parallel import make_mesh
    from slam_llm_tpu.parallel.sharding import logical_to_sharding
    from slam_llm_tpu.train.state import build_trainer

    mesh = make_mesh(dp=dp, fsdp=fsdp, tp=tp, devices=jax.devices()[:dp * fsdp * tp])
    jt = build_trainer(JSLAMModel(jcfg), jcfg, _train_config(port=False), mesh)
    example = {k: jnp.asarray(v) for k, v in _batch().items()}
    boxed = jax.eval_shape(lambda r: JSLAMModel(jcfg).init(r, example, method="init_all"), jax.random.PRNGKey(0))
    shardings = logical_to_sharding(mesh, nn.get_partition_spec(boxed["params"]))
    state = jt.state_from_params(jax.device_put(params, shardings))
    with mesh:
        db = jt.put_batch(_global_batch())
    out = []
    for i in range(STEPS):
        with mesh:
            state, m = jt.train_step(state, db, jax.random.PRNGKey(i))
        out.append((float(m["loss"]), float(m["grad_norm"]), _leaves(state["trainable"])))
    return out


def _assert_matches_jax(got, want, encoder=None, spread=None):
    """Loss and grad norm of every step within 1e-5 relative; every
    trainable tensor after the last within 1e-5 of its norm, or within twice
    ``spread``'s difference for that tensor where that is larger: the JAX
    package's own difference between two meshes, large where Adam's first
    updates amplify f32 round-off (zero-initialised biases, whose value is
    their updates alone)."""
    from test_torch_train import _leaves

    from slam_llm_tpu_torch.utils.convert import trainable_to_flax

    for step, (m, (loss, gnorm, leaves)) in enumerate(zip(got["metrics"], want)):
        np.testing.assert_allclose(m["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"], gnorm, rtol=1e-5)
    ours = _leaves(trainable_to_flax(got["trainable"], encoder))
    assert set(ours) == set(leaves)
    for path, w in leaves.items():
        bound = 1e-5 * np.linalg.norm(w)
        if spread is not None:
            bound = max(bound, 2 * np.linalg.norm(spread[-1][2][path] - w))
        assert np.linalg.norm(ours[path] - w) <= bound, path


def _one_process_int8_rot(tcfg, sd, rows_per_rank):
    """The one-process port on the global batch, with each rank's rows'
    stochastic rounding as that rank draws it: ``int8_rot``'s dy rows
    quantized per rank's block, rank r's seed offset by r strides
    (``train.state._SEED_STRIDE``)."""
    import slam_llm_tpu_torch.ops.quant as tq
    from slam_llm_tpu_torch.models import slam_model as tslam
    from slam_llm_tpu_torch.train.state import _SEED_STRIDE, Trainer

    rowquant = tq.rowquant

    def per_rank(x, *args, seed=None, rotate=False, **kw):
        if not rotate:
            return rowquant(x, *args, seed=seed, rotate=rotate, **kw)
        n = x.shape[0] // rows_per_rank
        parts = [rowquant(x[i * rows_per_rank:(i + 1) * rows_per_rank], *args,
                          seed=(seed + i * _SEED_STRIDE) % 2 ** 32, rotate=True, **kw) for i in range(n)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    model = tslam.SLAMModel(tcfg)
    model.load_state_dict(sd)
    trainer = Trainer(model, tcfg, _train_config()).state_from_params()
    tq.rowquant = per_rank
    try:
        metrics = []
        for _ in range(STEPS):
            m = trainer.train_step(trainer.put_batch(_global_batch()))
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        tq.rowquant = rowquant
    base = {n: tuple(b.shape) for n, b in model.named_buffers() if n.endswith(("kernel_q", "kernel_qr"))}
    return {"metrics": metrics, "trainable": trainer.whole_trainable(), "base_shapes": base}


def _tiny_cfg(root: Path, **overrides):
    """The port's RunConfig of ``helpers.tiny_run_config`` (the tiny whisper
    + tiny LLM sandwich on a five-utterance corpus), deterministic: LoRA
    dropout off, the int8 base with the exact (bf16) backward."""
    from helpers import make_corpus

    from slam_llm_tpu_torch.config import RunConfig, set_by_path

    manifest = root / "corpus" / "train.jsonl"
    if not manifest.exists():
        (root / "corpus").mkdir(parents=True, exist_ok=True)
        manifest = make_corpus(root / "corpus", n=5)
    cfg = RunConfig()
    settings = {
        "model_config.llm_name": "tiny-test", "model_config.encoder_name": "whisper",
        "model_config.encoder_config": "whisper-tiny-test", "model_config.encoder_projector": "linear",
        "model_config.encoder_projector_ds_rate": 5, "dataset_config.train_data_path": str(manifest),
        "dataset_config.val_data_path": str(manifest), "dataset_config.mel_size": 8,
        "dataset_config.input_type": "mel",
        "train_config.batch_size_training": 2, "train_config.val_batch_size": 2,
        "train_config.warmup_steps": 1, "train_config.total_steps": 20, "train_config.shard.dp": -1,
        "train_config.use_peft": True, "train_config.peft_config.lora_dropout": 0.0,
        "train_config.freeze_encoder": True, "train_config.freeze_llm": True,
        "train_config.shard.base_quant": "int8", "train_config.shard.base_quant_bwd": "bf16",
        "train_config.max_steps_per_epoch": 2, "train_config.log_interval": 1,
        "train_config.model_name": "tiny_asr", "train_config.save_optimizer": True,
        "decode_config.max_new_tokens": 3, **overrides,
    }
    for k, v in settings.items():
        set_by_path(cfg, k, v)
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts both worker groups (after the one-process run whose state the
    two-rank resume reads), then computes the references meanwhile."""
    from slam_llm_tpu_torch.pipeline import finetune

    root = tmp_path_factory.mktemp("dist")
    one = finetune.main(_tiny_cfg(root, **{"train_config.output_dir": str(root / "one")}), device="cpu")
    lora_j, lora_t, lora_params, lora_sd = _configs("lora")
    _, rot_t, _, rot_sd = _configs("int8_rot")
    full_j, full_t, full_params, full_sd = _configs("full")
    batch = _global_batch()
    two = _Group(2, [
        {"kind": "mesh", "name": "mesh"},
        {"kind": "trainer", "name": "lora", "tcfg": lora_t, "state_dict": lora_sd, "tc": _train_config(),
         "batch": batch, "dp": 1, "fsdp": 2},
        {"kind": "trainer", "name": "int8_rot", "tcfg": rot_t, "state_dict": rot_sd, "tc": _train_config(),
         "batch": batch, "dp": 1, "fsdp": 2},
        {"kind": "finetune", "name": "finetune", "cfg": _tiny_cfg(root, **{
            "train_config.output_dir": str(root / "two"), "train_config.shard.fsdp": 2})},
        {"kind": "finetune", "name": "resume", "cfg": _tiny_cfg(root, **{
            "train_config.output_dir": str(root / "two_resumed"), "train_config.shard.fsdp": 2,
            "train_config.resume_from": one["checkpoints"][-1], "train_config.num_epochs": 0,
            "train_config.run_validation": False})},
        {"kind": "finetune", "name": "continue", "cfg": _tiny_cfg(root, **_CONTINUE, **{
            "train_config.output_dir": str(root / "two_continued"), "train_config.shard.fsdp": 2,
            "train_config.resume_from": str(root / "two" / "tiny_asr_epoch_1_step_2")})},
        {"kind": "decode", "name": "decode", "cfg": _tiny_cfg(root, **{
            "decode_config.decode_log": str(root / "two_decode")})},
    ], root / "group2")
    four = _Group(4, [
        {"kind": "trainer", "name": "full", "tcfg": full_t, "state_dict": full_sd, "tc": _train_config(),
         "batch": batch, "dp": 2, "fsdp": 2},
    ], root / "group4")
    int8_j, int8_t, int8_params, int8_sd = _configs("int8")
    with _jax_int8_records() as pins:
        int8_ref = _jax_steps(int8_j, int8_params, 1, 2)
    policies = []
    for policy in OTHER_REMAT:
        llm = dataclasses.replace(lora_t.llm, **({"remat": False} if policy == "off" else {"remat_policy": policy}))
        policies.append({"kind": "trainer", "name": f"lora_{policy}", "tcfg": dataclasses.replace(lora_t, llm=llm),
                         "state_dict": lora_sd, "tc": _train_config(), "batch": batch, "dp": 1, "fsdp": 2})
    three = _Group(2, [
        {"kind": "trainer", "name": "int8", "tcfg": int8_t, "state_dict": int8_sd, "tc": _train_config(),
         "batch": batch, "dp": 1, "fsdp": 2, "pins": pins},
        *policies,
    ], root / "group3")
    refs = {
        "int8": int8_ref, "int8_shapes": {n: tuple(t.shape) for n, t in int8_sd.items()},
        "lora": _jax_steps(lora_j, lora_params, 1, 2),
        "full": _jax_steps(full_j, full_params, 2, 2),
        "full_one_device": _jax_steps(full_j, full_params, 1, 1),
        "int8_rot": _one_process_int8_rot(rot_t, rot_sd, rows_per_rank=2 * batch["input_ids"].shape[1]),
        "one": one,
    }
    yield {"root": root, "two": two, "three": three, "four": four, "refs": refs}
    for group in (two, three, four):
        for p in group.procs:
            if p.poll() is None:
                p.kill()


def test_fsdp2_lora_remat_matches_the_jax_trainer(runs):
    """fsdp=2, LoRA, remat dots_flash_saveable, f32: three steps of the
    port's two ranks against the JAX Trainer on its fsdp=2 mesh: loss and
    grad norm within 1e-5 relative, every trainable tensor within 1e-5 of
    its norm; every decoder layer went through the checkpoint."""
    got = runs["two"].result("lora")
    _assert_matches_jax(got, runs["refs"]["lora"])
    assert got["remat_calls"] == STEPS * 2  # two decoder layers a step


@pytest.mark.parametrize("policy", OTHER_REMAT)
def test_fsdp2_lora_every_remat_policy_matches_the_jax_trainer(runs, policy):
    """fsdp=2, LoRA, f32, under each other remat policy and with remat off:
    three steps of the port's two ranks against the JAX Trainer (within
    1e-5, as above); every decoder layer went through the checkpoint, or
    none with remat off. The reference is the JAX Trainer under
    dots_flash_saveable: a remat policy chooses what the backward recomputes,
    not what it computes, and the JAX package's losses and grad norms are
    the same under each of its policies and without remat."""
    got = runs["three"].result(f"lora_{policy}")
    _assert_matches_jax(got, runs["refs"]["lora"])
    assert got["remat_calls"] == (0 if policy == "off" else STEPS * 2)


def test_fsdp2_int8_base_matches_the_jax_trainer(runs):
    """fsdp=2, LoRA, the int8 base with the bf16 backward, remat
    dots_flash_saveable, f32: each rank holds half of every ``kernel_q`` /
    ``kernel_scale`` (and the derived transpose), and three steps of the two
    ranks match the JAX Trainer on its fsdp=2 mesh within 1e-5 (loss, grad
    norm; every trainable tensor of its norm). The port takes the JAX side's
    int8 codes and bf16 dy roundings, after checking, on each rank's rows,
    that they differ only at rounding boundaries (``_pin_int8``)."""
    got, shapes = runs["three"].result("int8"), runs["refs"]["int8_shapes"]
    base = {n: s for n, s in shapes.items() if n.rsplit(".", 1)[-1] in ("kernel_q", "kernel_scale")}
    assert base and set(base) <= set(got["base_shapes"])
    for name, shape in base.items():
        assert got["base_shapes"][name] == (shape[0] // 2, *shape[1:]), name
    assert got["pinned"]["act_quant"] > 0 and got["pinned"]["dy"] > 0
    _assert_matches_jax(got, runs["refs"]["int8"])
    assert got["remat_calls"] == STEPS * 2


def test_fsdp2_int8_rot_base_matches_one_process(runs):
    """fsdp=2, LoRA, the int8 base with the int8_rot backward, remat
    dots_flash_saveable: each rank holds half of every int8 base tensor
    (``kernel_q`` / ``kernel_scale`` and the derived rotated pair), and three
    steps equal the one-process port's on the global batch whose rows are
    stochastically rounded as each rank rounds its own (the TPU's bits
    cannot be matched: ``test_torch_train_modes``)."""
    got, want = runs["two"].result("int8_rot"), runs["refs"]["int8_rot"]
    for name, shape in want["base_shapes"].items():
        assert got["base_shapes"][name] == (shape[0] // 2, shape[1]), name
    assert any(n.endswith("kernel_scale_r") for n in got["base_shapes"])
    for m, w in zip(got["metrics"], want["metrics"]):
        np.testing.assert_allclose(m["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"], w["grad_norm"], rtol=1e-5)
    for name, w in want["trainable"].items():
        assert torch.linalg.norm(got["trainable"][name] - w) <= 1e-5 * torch.linalg.norm(w), name
    assert got["remat_calls"] == STEPS * 2


def test_dp2_fsdp2_full_finetune_matches_the_jax_trainer(runs):
    """(dp=2, fsdp=2), freeze_llm=false, freeze_encoder=false (every tensor
    trains), four ranks against the JAX Trainer on (dp=2, fsdp=2): loss and
    grad norm within 1e-5; the tensors within 1e-5 of their norm, or twice
    the JAX package's own one-device vs (2, 2) difference where larger (its
    zero-initialised encoder biases move by ~2e-5 of their norm between its
    own meshes)."""
    got = runs["four"].result("full")
    assert got["world"] == 4
    _assert_matches_jax(got, runs["refs"]["full"], encoder="whisper", spread=runs["refs"]["full_one_device"])


def test_mesh_absorbs_dp_and_refuses_a_mesh_that_is_not_the_world(runs):
    """dp=-1 absorbs the world; a mesh smaller than the world raises (the
    reference's truncation to the leading devices is not copied), as does
    one the world does not divide; shard_batch gives rank r rows
    [r B/n, (r+1) B/n) and refuses a batch that does not split."""
    from slam_llm_tpu_torch.parallel.sharding import mesh_shape

    got = runs["two"].result("mesh")
    assert got["absorbed"] == (2, 1, 1)
    assert "mesh 1x1x1 != 2 processes" in got["smaller"]
    assert "not divisible by fsdp*tp=3" in got["indivisible"]
    assert got["rows"] == [(0, 2, [0, 1]), (1, 2, [2, 3])]
    assert "does not split" in got["ragged"]
    assert mesh_shape(-1, 2, 1, 8) == (4, 2, 1)
    for bad in ((2, 2, 1, 8), (1, 3, 1, 8), (-1, 1, 1, 0)):
        with pytest.raises(ValueError):
            mesh_shape(*bad)




def _close(a, b, rtol):
    return float(torch.linalg.norm(a - b)) <= rtol * float(torch.linalg.norm(b))


def test_checkpoints_hold_whole_tensors_and_resume_across_world_sizes(runs):
    """pipeline.finetune at fsdp=2 (the int8 base, LoRA, validation over a
    ragged last batch): rank 0's model.pt and full_state.pt hold whole
    tensors, of the one-process run's names, shapes and values; the fsdp=2
    state resumed in one process is restored bit for bit and its next step
    follows the fsdp=2 run's own next step; the one-process state resumed at
    fsdp=2 is gathered back bit for bit. The recipe computes in bf16, whose CPU
    products round differently for another row count, so the two runs agree
    within one bf16 rounding (relative); the f32 trainer tests above hold
    the sharded step to 1e-5."""
    from slam_llm_tpu_torch.pipeline import finetune
    from slam_llm_tpu_torch.utils.checkpoint import load_state

    root, one = runs["root"], runs["refs"]["one"]
    two = runs["two"].result("finetune")
    assert [s["step"] for s in two["steps"]] == [s["step"] for s in one["steps"]] == [1, 2]
    for a, b in zip(two["steps"], one["steps"]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=BF16)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=BF16)
    np.testing.assert_allclose(two["final_val"]["loss"], one["final_val"]["loss"], rtol=BF16)
    assert two["base_bytes"] * 2 == one["base_bytes"]
    ckpt_two, ckpt_one = Path(two["checkpoints"][-1]), Path(one["checkpoints"][-1])
    assert ckpt_two.name == ckpt_one.name
    sd_two = torch.load(ckpt_two / "model.pt", weights_only=True)
    sd_one = torch.load(ckpt_one / "model.pt", weights_only=True)
    assert set(sd_two) == set(sd_one)
    for name, w in sd_one.items():
        assert sd_two[name].shape == w.shape and sd_two[name].dtype == w.dtype, name
        assert _close(sd_two[name], w, BF16), name
    full_two, full_one = load_state(str(ckpt_two)), load_state(str(ckpt_one))
    assert full_two["step"] == full_one["step"] == 2
    for key, rtol in (("mu", BF16), ("nu", 2 * BF16)):  # nu holds squares: twice the relative error
        for a, b in zip(full_two["optimizer"][key], full_one["optimizer"][key]):
            assert a.shape == b.shape and _close(a, b, rtol), key

    # the fsdp=2 state in one process: restored exactly, and its next step follows the fsdp=2 run's own
    cfg = _tiny_cfg(root, **_CONTINUE, **{"train_config.output_dir": str(root / "one_continued"),
                                          "train_config.resume_from": str(ckpt_two)})
    res = finetune.main(cfg, device="cpu")
    assert [s["step"] for s in res["steps"]] == [3]
    continued = runs["two"].result("continue")
    assert [s["step"] for s in continued["steps"]] == [3]
    np.testing.assert_allclose(res["steps"][0]["loss"], continued["steps"][0]["loss"], rtol=BF16)
    sd_a = torch.load(Path(res["checkpoints"][-1]) / "model.pt", weights_only=True)
    sd_b = torch.load(Path(continued["checkpoints"][-1]) / "model.pt", weights_only=True)
    for name, w in sd_b.items():
        assert _close(sd_a[name], w, BF16) and not torch.equal(w, sd_two[name]), name
    again = _tiny_cfg(root, **{"train_config.output_dir": str(root / "restored"), "train_config.num_epochs": 0,
                               "train_config.resume_from": str(ckpt_two), "train_config.save_model": False})
    trainer = finetune.main(again, device="cpu")["trainer"]
    assert trainer.step == 2
    for name, p in trainer.trainable.items():
        assert torch.equal(p.detach(), full_two["trainable"][name]), name
    state = trainer.optimizer.state_dict()
    for key in ("mu", "nu"):
        assert all(torch.equal(a, b) for a, b in zip(state[key], full_two["optimizer"][key]))

    # the one-process state at fsdp=2: gathered back whole, unchanged
    resumed = runs["two"].result("resume")
    back = load_state(resumed["checkpoints"][-1])
    assert back["step"] == 2
    for name, w in full_one["trainable"].items():
        assert torch.equal(back["trainable"][name], w), name
    for key in ("mu", "nu"):
        assert all(torch.equal(a, b) for a, b in zip(back["optimizer"][key], full_one["optimizer"][key]))


def test_two_rank_decode_writes_rank_logs_equal_to_one_process(runs):
    """inference_batch on two ranks writes _pred_rank0/1 and _gt_rank0/1:
    each rank decodes every other batch of the test split (the ragged tail
    wrapping to the first), the union of their keys is the split, and every
    line equals the one-process decode's line of that key."""
    from slam_llm_tpu_torch.pipeline import inference_batch

    root = runs["root"]
    runs["two"].wait()
    one = inference_batch.main(_tiny_cfg(root, **{"decode_config.decode_log": str(root / "one_decode")}),
                               device="cpu")

    def lines(path):
        return [line.split("\t", 1) for line in Path(path).read_text().splitlines()]

    want_pred, want_gt = dict(lines(one["pred"])), dict(lines(one["gt"]))
    assert len(want_pred) == 5
    got = {}
    for r in (0, 1):
        pred, gt = lines(f"{root}/two_decode_pred_rank{r}"), lines(f"{root}/two_decode_gt_rank{r}")
        # batches of 2, 2 and 1: rank 0 takes the first and the last, rank 1 the second and the first again
        assert len(pred) == len(gt) == (3, 4)[r]
        for (key, text), (gkey, target) in zip(pred, gt):
            assert key == gkey and text == want_pred[key] and target == want_gt[key]
            got[key] = text
    assert got == want_pred
    assert not Path(f"{root}/two_decode_pred").exists()


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
