"""Tensor parallelism (``shard.tp``) of the port's decoder LLM, on the CPU with gloo.

Worker processes run this file as a script through
``test_torch_distributed``'s launcher (``_Group``: torchrun's environment,
``PROC_TIMEOUT`` a worker, ``DIST_TIMEOUT`` a collective), each running the
jobs of its payload; rank 0 writes each job's result. Three groups run side
by side while this process computes the references:

* two ranks (tp=2), trainer steps: LoRA in f32 with remat
  ``dots_flash_saveable`` against the JAX ``Trainer`` on its own (1, 1, 2)
  mesh; the int8 base (``int8_rot`` / ``int8_sr`` / ``int8`` backward, the
  ``int8_sr`` CE head, the projector trained) against the one-process port
  bit for bit; LoRA over the int8 base (``int8_rot``, the ``int8`` CE head;
  the ``bf16`` backward) against the one-process port;
* two ranks (tp=2): the int8 denses of both roles in every backward mode, the
  vocab-parallel CE (a tie planted across the shard border), the embedding;
  LoRA under every other remat policy and with remat off; ``pipeline.finetune``
  (checkpoints) and ``pipeline.inference_batch``;
* four ranks (fsdp=2 x tp=2): LoRA in f32 against the same JAX reference,
  the dropout masks and rounding seeds of the ranks, and a one-process state
  resumed through ``pipeline.finetune``.

The tiny LLM has 8 / 4 heads of 8 and an MLP of 512 (its rotation block 256
holds whole in a rank's 256 columns), so q / k / v (64 / 32 wide, blocks
64 / 32) take the gather path of the ``int8_rot`` dx and gate / up the
row-split one.
"""

import dataclasses
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from slam_llm_tpu_torch.models.remat import POLICIES

HERE = Path(__file__).resolve().parent
STEPS = 3
OTHER_REMAT = sorted(set(POLICIES) - {"dots_flash_saveable"}) + ["off"]
BF16 = 2.0 ** -8
LLM_DIMS = {"n_heads": 8, "n_kv_heads": 4, "head_dim": 8, "ffn_dim": 512}
EVEN_VOCAB = 264  # the byte tokenizer's 259 ids, padded so tp=2 divides the vocabulary
FACTORY = f"{Path(__file__).resolve()}:even_vocab_factory"
TP2_ORDER_FACTORY = f"{Path(__file__).resolve()}:tp2_order_factory"
F32_FACTORY = f"{Path(__file__).resolve()}:f32_factory"
# the int8 base tensors (and the weights) whose local shapes a rank reports
SHAPE_LEAVES = ("kernel_q", "kernel_scale", "kernel_qr", "kernel_scale_r", "kernel_qt", "head_q", "head_scale",
                "head_qt", "weight", "lora_a", "lora_b")
# the split dim of each leaf by dense role (parallel.tensor_parallel.DENSE_DIMS), None: whole
COLUMN_DIMS = {"weight": 0, "kernel_q": 0, "kernel_scale": 0, "kernel_qr": 1, "kernel_scale_r": None, "kernel_qt": 1,
               "lora_a": None, "lora_b": 0}
ROW_DIMS = {"weight": 1, "kernel_q": 1, "kernel_scale": None, "kernel_qr": 0, "kernel_scale_r": 0, "kernel_qt": 0,
            "lora_a": 1, "lora_b": None}


def even_vocab_factory(train_config, model_config, device=None, **kwargs):
    """The port's model factory with the vocabulary padded to ``EVEN_VOCAB``
    (the tiny recipe's byte tokenizer has 259 ids, which tp=2 does not
    divide); the one-process runs use it too."""
    from slam_llm_tpu_torch.data.tokenizer import load_tokenizer
    from slam_llm_tpu_torch.models.slam_model import SLAMModel, build_slam_config

    cfg = build_slam_config(train_config, model_config)
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, vocab_size=EVEN_VOCAB))
    return SLAMModel(cfg, device), load_tokenizer(model_config.llm_path)


def tp2_order_factory(train_config, model_config, device=None, **kwargs):
    """``even_vocab_factory``'s model summing its split modules' row products
    in a tp=2 run's order (``sum_in_tp2_order``): the one-process reference
    of the bf16 pipeline runs."""
    model, tokenizer = even_vocab_factory(train_config, model_config, device, **kwargs)
    sum_in_tp2_order(model)
    return model, tokenizer


def f32_factory(train_config, model_config, device=None, **kwargs):
    """``even_vocab_factory``'s model computing in f32 (the LLM, the encoder
    and the projector), for the decodes compared without reordering."""
    from slam_llm_tpu_torch.data.tokenizer import load_tokenizer
    from slam_llm_tpu_torch.models.slam_model import SLAMModel, build_slam_config

    cfg = build_slam_config(train_config, model_config)
    f32 = torch.float32
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, vocab_size=EVEN_VOCAB, dtype=f32),
                              encoder=dataclasses.replace(cfg.encoder, dtype=f32),
                              projector_cfg=dataclasses.replace(cfg.projector_cfg, dtype=f32))
    return SLAMModel(cfg, device), load_tokenizer(model_config.llm_path)


def _tp2_row_base(self, h, out, pre_quant):
    """A plain row dense's product as two tp=2 ranks form it: each half of
    K in the compute dtype, the two summed in f32 and rounded once
    (``parallel.tensor_parallel.reduce_from_tp``)."""
    from slam_llm_tpu_torch.models.layers import linear

    assert out is None and self.quant == "none" and self.tp is None
    w, k = self.weight.to(self.dtype), h.shape[-1] // 2
    a, b = (linear(h[..., r * k:(r + 1) * k].contiguous(), w[:, r * k:(r + 1) * k].contiguous()) for r in (0, 1))
    return a + b if a.dtype in (torch.float32, torch.float64) else (a.float() + b.float()).to(a.dtype)


def sum_in_tp2_order(model):
    """One process's row-parallel products of the modules tp splits past
    the LLM (the whisper encoder's out_proj / fc2, the projector's linear2)
    summed in the order of a tp=2 run (``_tp2_row_base``); the LLM's own
    row denses are the int8 base's exact s32 sums. In bf16, the order moves
    a rounding now and then, so the one-process port in this order equals
    tp=2 where one in its own order would differ by those roundings (the
    f32 decodes compare the two orders: ``test_tp2_decode_in_f32_...``)."""
    import types

    from slam_llm_tpu_torch.models.projector import ProjectorConcat, ProjectorConv1d
    from slam_llm_tpu_torch.models.whisper import WhisperEncoder

    rows = []
    for m in model.modules():
        if isinstance(m, WhisperEncoder):
            rows += [d for layer in m.layers for d in (layer.attn.out_proj, layer.fc2)]
        elif isinstance(m, (ProjectorConcat, ProjectorConv1d)):
            rows.append(m.linear2)
    for dense in rows:
        dense._base = types.MethodType(_tp2_row_base, dense)
    return model


# ---- shared by the workers and the references (no JAX) -----------------------------


def _trainer_steps(tcfg, state_dict, tc, batch, mesh=None, tp_order=False):
    """STEPS trainer steps: metrics, whole trainable tensors, the checkpointed
    layer calls, the local shapes of ``SHAPE_LEAVES`` and the seeds drawn.
    ``tp_order`` (one process): the split modules' row products and the
    gradient norm summed in the order of a tp=2 run's (``sum_in_tp2_order``,
    ``_tp2_norm``)."""
    from slam_llm_tpu_torch.models import remat
    from slam_llm_tpu_torch.models import slam_model as tslam
    from slam_llm_tpu_torch.parallel.sharding import local_part
    from slam_llm_tpu_torch.train.state import Trainer

    calls = [0]
    apply = remat._CheckpointedLayer.apply

    def counted(*args):
        calls[0] += 1
        return apply(*args)

    remat._CheckpointedLayer.apply = counted
    try:
        model = tslam.SLAMModel(tcfg)
        model.load_state_dict(state_dict)
        if tp_order:
            sum_in_tp2_order(model)
        trainer = Trainer(model, tcfg, tc, mesh=mesh).state_from_params()
        if tp_order:
            trainer.norm_group = trainer.optimizer.norm_group = _tp2_norm(list(trainer.trainable))
        metrics, seeds = [], []
        for _ in range(STEPS):
            m = trainer.train_step(trainer.put_batch(batch))
            metrics.append({k: float(v) for k, v in m.items()})
            seeds.append([mod.quant_seed for mod in trainer.sr_modules])
    finally:
        remat._CheckpointedLayer.apply = apply
    shapes = {n: tuple(local_part(t).shape) for n, t in [*model.named_parameters(), *model.named_buffers()]
              if n.rsplit(".", 1)[-1] in SHAPE_LEAVES}
    return {"metrics": metrics, "trainable": trainer.whole_trainable(), "remat_calls": calls[0], "shapes": shapes,
            "seeds": seeds}


def _tp2_norm(names):
    """A one-process ``norm_group`` summing the gradient's squares as a tp=2
    run's ``NormGroups`` does: each rank's part of the split tensors in
    turn (the projector's linear1 on its outputs, linear2's weight on its
    inputs), the two ranks' sums added, then the whole tensors."""
    from slam_llm_tpu_torch.parallel.tensor_parallel import DENSE_DIMS

    def dim(name):
        owner, leaf = name.rsplit(".", 1)
        role = {"linear1": "column", "linear2": "row"}.get(owner.rsplit(".", 1)[-1])
        return None if role is None or not owner.startswith("encoder_projector.") else DENSE_DIMS[role].get(leaf)

    dims = [dim(n) for n in names]

    class Norm:
        @staticmethod
        def square_sum(grads):
            zero = torch.zeros((), dtype=torch.float32)
            ranks = [sum((g.narrow(d, r * (g.shape[d] // 2), g.shape[d] // 2).contiguous().float().square().sum()
                          for g, d in zip(grads, dims) if d is not None), zero) for r in (0, 1)]
            whole = sum((g.float().square().sum() for g, d in zip(grads, dims) if d is None), zero)
            return torch.stack([ranks[0] + ranks[1], whole]).sum()

    return Norm()


def _dense_cases():
    """(role, K, F) of the unit denses: a column one whose rotation blocks
    straddle the ranks (F 64), one that holds whole blocks (F 512), a row one."""
    return (("column", 64, 64), ("column", 64, 512), ("row", 512, 64))


def _units(tp=None):
    """The int8 denses of both roles in every backward mode, the fused CE
    with each head and the embedding, on this rank's shards (``tp``) or
    whole; every result whole (gathered over tp)."""
    from slam_llm_tpu_torch.models.layers import DenseGeneralLora
    from slam_llm_tpu_torch.models.llm import CausalLM, LLMConfig
    from slam_llm_tpu_torch.ops.fused_ce import QuantHead, fused_linear_ce
    from slam_llm_tpu_torch.ops.quant import BWD_MODES, quantize_base_params, quantize_int8
    from slam_llm_tpu_torch.parallel.tensor_parallel import all_gather_last, split_dense, split_llm

    bf16 = torch.bfloat16
    rng = np.random.default_rng(7)
    out = {}

    def cols(t, n):  # this rank's columns of a whole tensor
        return t if tp is None else t[..., tp.rank * n // tp.size:(tp.rank + 1) * n // tp.size]

    def whole(t):
        return t if tp is None else all_gather_last(t.contiguous(), tp)

    for role, k, f in _dense_cases():
        w = torch.from_numpy(rng.standard_normal((f, k)).astype(np.float32))
        x = torch.from_numpy(rng.standard_normal((24, k)).astype(np.float32)).to(bf16)
        dy = torch.from_numpy(rng.standard_normal((24, f)).astype(np.float32)).to(bf16)
        for mode in BWD_MODES:
            dense = DenseGeneralLora(k, f, dtype=bf16, quant="int8", quant_bwd=mode)
            q, s = quantize_int8(w, contract_axis=-1)
            with torch.no_grad():
                dense.kernel_q.copy_(q)
                dense.kernel_scale.copy_(s)
            quantize_base_params(dense)
            dense.quant_seed = 1234
            xi, dyi = x, dy
            if tp is not None:
                split_dense(dense, tp, role)
                xi, dyi = (cols(x, k), dy) if role == "row" else (x, cols(dy, f))
            xi = xi.clone().requires_grad_(True)
            y = dense(xi)
            y.backward(dyi)
            out[f"{role}_{k}x{f}_{mode}"] = (whole(y) if role == "column" else y,
                                             whole(xi.grad) if role == "row" else xi.grad)

    v, d = 256, 64
    hidden = torch.from_numpy(rng.standard_normal((2, 12, d)).astype(np.float32))
    kernel = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32) * 0.5)
    tie = torch.from_numpy(rng.integers(-3, 4, d).astype(np.float32))
    hidden[0, 0] = tie  # logits 127 and 128 equal (exact small integers) and the row's largest
    kernel[127] = kernel[128] = 2 * tie
    labels = torch.from_numpy(rng.integers(0, v, (2, 12)))
    labels[0, 0] = 127
    labels[1, :3] = -100
    for head_kind in ("plain", "int8", "int8_sr"):
        h = hidden.clone().requires_grad_(True)
        kern = cols(kernel.T, v).T.contiguous().to(bf16).requires_grad_(head_kind == "plain")
        head = None
        if head_kind != "plain":
            q, s = quantize_int8(kernel.to(bf16), contract_axis=-1)
            qr = cols(q.T, v).T.contiguous()
            head = QuantHead(qr, cols(s, v).contiguous(), qr.T.contiguous(), head_kind == "int8_sr", 99)
        loss, acc = fused_linear_ce(h, kern, labels, chunk=8, kernel_needs_grad=head is None,
                                    compute_dtype=bf16, head=head, tp=tp)
        loss.backward()
        out[f"ce_{head_kind}"] = (loss.detach(), acc, h.grad,
                                  None if kern.grad is None else whole(kern.grad.T.contiguous()).T)

    llm = CausalLM(dataclasses.replace(LLMConfig.tiny_test(), **LLM_DIMS))
    with torch.no_grad():
        llm.embed_tokens.weight.copy_(torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32)))
    ids = torch.from_numpy(rng.integers(0, 256, (3, 10)))
    if tp is not None:
        split_llm(llm, tp)
    out["embed"] = llm.embed(ids)
    return out


def _seeds_job(job):
    """Each rank's LoRA dropout mask and stochastic-rounding seeds of one
    step (int8_rot base, dropout 0.05), gathered to rank 0 with the ranks'
    data / tp indices."""
    import torch.distributed as dist

    from slam_llm_tpu_torch.models import slam_model as tslam
    from slam_llm_tpu_torch.parallel.sharding import data_rank, make_mesh
    from slam_llm_tpu_torch.train.state import Trainer

    mesh = make_mesh(dp=job["dp"], fsdp=job["fsdp"], tp=job["tp"], device_type="cpu")
    model = tslam.SLAMModel(job["tcfg"])
    model.load_state_dict(job["state_dict"])
    trainer = Trainer(model, job["tcfg"], job["tc"], mesh=mesh).state_from_params()
    seeds = trainer.draw_quant_seeds()
    mask = torch.rand((4, 16), generator=trainer.dropout_generator)
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, {"data": data_rank(mesh), "tp": mesh["tp"].get_local_rank(), "seeds": seeds,
                                 "mask": mask})
    return got


def _worker(payload: str, out_dir: str) -> None:
    import torch.distributed as dist

    from test_torch_distributed import DIST_TIMEOUT

    from slam_llm_tpu_torch.parallel.sharding import make_mesh
    from slam_llm_tpu_torch.parallel.tensor_parallel import tp_of
    from slam_llm_tpu_torch.pipeline import finetune, inference_batch
    from slam_llm_tpu_torch.pipeline.common import maybe_init_distributed

    torch.set_num_threads(1)
    assert maybe_init_distributed("cpu", timeout=DIST_TIMEOUT)

    def trainer(job):
        mesh = make_mesh(dp=job["dp"], fsdp=job["fsdp"], tp=job["tp"], device_type="cpu")
        return _trainer_steps(job["tcfg"], job["state_dict"], job["tc"], job["batch"], mesh)

    def units(job):
        return _units(tp_of(make_mesh(dp=1, fsdp=1, tp=dist.get_world_size(), device_type="cpu")))

    def run_finetune(job):
        res = finetune.main(job["cfg"], device="cpu")
        return {k: res[k] for k in ("steps", "checkpoints", "final_val", "base_bytes") if k in res}

    jobs = {"trainer": trainer, "units": units, "seeds": _seeds_job, "finetune": run_finetune,
            "decode": lambda job: inference_batch.main(job["cfg"], device="cpu")}
    for job in torch.load(payload, weights_only=False):
        result = jobs[job["kind"]](job)
        if dist.get_rank() == 0:
            torch.save(result, Path(out_dir) / f"{job['name']}.pt")
    dist.destroy_process_group()


# ---- the references ------------------------------------------------------------------


def _configs():
    """(JAX SLAMConfig, port SLAMConfig, JAX params, port state dict) of the
    tiny f32 LoRA model with ``LLM_DIMS``, remat ``dots_flash_saveable``."""
    from test_torch_train import _jax_cfg, _params, _port_model

    jcfg = _jax_cfg()
    jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(
        jcfg.llm, remat=True, remat_policy="dots_flash_saveable", **LLM_DIMS))
    params = _params(jcfg)
    tcfg, tm = _port_model(jcfg, params)
    return jcfg, tcfg, params, tm.state_dict()


def _port_configs(base, bwd, ce="none", lora=True):
    """(port SLAMConfig, state dict) of the tiny model with ``LLM_DIMS`` in
    bf16 for the one-process comparisons: the port's seeded init, every
    ``lora_b`` drawn nonzero (std 0.3, as ``test_torch_train._params``)."""
    from slam_llm_tpu_torch.models import llm as tllm
    from slam_llm_tpu_torch.models import projector as tproj
    from slam_llm_tpu_torch.models import slam_model as tslam
    from slam_llm_tpu_torch.models import whisper as twhisper
    from slam_llm_tpu_torch.pipeline.common import init_params_

    bf16 = torch.bfloat16
    llm = dataclasses.replace(tllm.LLMConfig.tiny_test(), **LLM_DIMS, lora_rank=4 if lora else 0, dtype=bf16,
                              base_quant=base, base_quant_bwd=bwd, ce_quant=ce, ce_chunk=8)
    enc = dataclasses.replace(twhisper.PRESETS["whisper-tiny-test"](), dtype=bf16)
    proj = tproj.ProjectorConfig(encoder_dim=enc.d_model, llm_dim=llm.d_model, ds_rate=5, hidden_dim=32, dtype=bf16)
    cfg = tslam.SLAMConfig(llm=llm, encoder_name="whisper", encoder=enc, projector="linear", projector_cfg=proj)
    model = tslam.SLAMModel(cfg)
    gen = torch.Generator().manual_seed(0)
    init_params_(model, gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    return cfg, model.state_dict()


def _policy_cfg(tcfg, policy):
    llm = dataclasses.replace(tcfg.llm, **({"remat": False} if policy == "off" else {"remat_policy": policy}))
    return dataclasses.replace(tcfg, llm=llm)


def _run_cfg(root: Path, **overrides):
    from test_torch_distributed import _tiny_cfg

    return _tiny_cfg(root, **{"model_config.file": FACTORY, **overrides})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worker groups (the four ranks once the one-process finetune has
    written the state they resume), then the references meanwhile."""
    from test_torch_distributed import _global_batch, _Group, _jax_steps, _train_config

    from slam_llm_tpu_torch.pipeline import finetune

    root = tmp_path_factory.mktemp("tp")
    batch, tc = _global_batch(), _train_config()
    lora_j, lora_t, lora_params, lora_sd = _configs()
    exact = {mode: _port_configs("int8", mode, ce="int8_sr", lora=False) for mode in ("int8_rot", "int8_sr", "int8")}
    mixed = {"int8_rot": _port_configs("int8", "int8_rot", ce="int8"), "bf16": _port_configs("int8", "bf16")}

    def trainer_job(name, tcfg, sd, **mesh):
        return {"kind": "trainer", "name": name, "tcfg": tcfg, "state_dict": sd, "tc": tc, "batch": batch,
                "dp": 1, "fsdp": 1, "tp": 2, **mesh}

    steps = _Group(2, [
        trainer_job("lora", lora_t, lora_sd),
        *(trainer_job(f"exact_{mode}", *exact[mode]) for mode in exact),
        *(trainer_job(f"mixed_{mode}", *mixed[mode]) for mode in mixed),
    ], root / "steps", script=Path(__file__))
    rest = _Group(2, [
        {"kind": "units", "name": "units"},
        {"kind": "finetune", "name": "finetune", "cfg": _run_cfg(root, **{
            "train_config.output_dir": str(root / "tp2"), "train_config.shard.tp": 2})},
        {"kind": "decode", "name": "decode", "cfg": _run_cfg(root, **{
            "decode_config.decode_log": str(root / "tp2_decode"), "train_config.shard.tp": 2})},
        {"kind": "decode", "name": "decode_f32", "cfg": _run_cfg(root, **{
            "decode_config.decode_log": str(root / "tp2_f32_decode"), "train_config.shard.tp": 2,
            "model_config.file": F32_FACTORY})},
        *(trainer_job(f"lora_{p}", _policy_cfg(lora_t, p), lora_sd) for p in OTHER_REMAT),
    ], root / "rest", script=Path(__file__))
    one = finetune.main(_run_cfg(root, **{"train_config.output_dir": str(root / "one"),
                                          "model_config.file": TP2_ORDER_FACTORY}), device="cpu")
    seeds_t = dataclasses.replace(mixed["int8_rot"][0], llm=dataclasses.replace(
        mixed["int8_rot"][0].llm, lora_dropout=0.05))
    seeds_tc = _train_config()
    seeds_tc.peft_config.lora_dropout = 0.05
    four = _Group(4, [
        trainer_job("lora4", lora_t, lora_sd, fsdp=2),
        {"kind": "seeds", "name": "seeds", "tcfg": seeds_t, "state_dict": mixed["int8_rot"][1], "tc": seeds_tc,
         "dp": 1, "fsdp": 2, "tp": 2},
        {"kind": "finetune", "name": "resume4", "cfg": _run_cfg(root, **{
            "train_config.output_dir": str(root / "resumed4"), "train_config.shard.fsdp": 2,
            "train_config.shard.tp": 2, "train_config.resume_from": one["checkpoints"][-1],
            "train_config.num_epochs": 0, "train_config.run_validation": False})},
    ], root / "four", script=Path(__file__))
    torch.set_num_threads(2)
    refs = {
        "lora": _jax_steps(lora_j, lora_params, 1, 1, tp=2),
        **{f"exact_{m}": _trainer_steps(*exact[m], tc, batch, tp_order=True) for m in exact},
        **{f"mixed_{m}": _trainer_steps(*mixed[m], tc, batch, tp_order=True) for m in mixed},
        "units": _units(),
        "one": one,
    }
    yield {"root": root, "steps": steps, "rest": rest, "four": four, "refs": refs}
    for group in (steps, rest, four):
        for p in group.procs:
            if p.poll() is None:
                p.kill()


# ---- the tests ------------------------------------------------------------------------


def test_tp2_lora_remat_matches_the_jax_trainer(runs):
    """(a) tp=2, LoRA, remat dots_flash_saveable, f32: three steps of the
    port's two ranks against the JAX Trainer on its (1, 1, 2) mesh: loss and
    grad norm within 1e-5 relative, every trainable tensor within 1e-5 of
    its norm; every decoder layer went through the checkpoint."""
    from test_torch_distributed import _assert_matches_jax

    got = runs["steps"].result("lora")
    _assert_matches_jax(got, runs["refs"]["lora"])
    assert got["remat_calls"] == STEPS * 2


def test_fsdp2_tp2_lora_matches_the_jax_trainer(runs):
    """(a) fsdp=2 x tp=2 (four ranks), LoRA, f32: the same three steps
    against the same JAX Trainer (GSPMD keeps the function at any mesh),
    within 1e-5."""
    from test_torch_distributed import _assert_matches_jax

    got = runs["four"].result("lora4")
    _assert_matches_jax(got, runs["refs"]["lora"])
    assert got["remat_calls"] == STEPS * 2


@pytest.mark.parametrize("policy", OTHER_REMAT)
def test_tp2_every_remat_policy_matches_the_jax_trainer(runs, policy):
    """(c) tp=2, LoRA, f32, under each other remat policy and with remat
    off: the replays run the collectives in the same order on both ranks,
    and the three steps meet the JAX Trainer within 1e-5, as above."""
    from test_torch_distributed import _assert_matches_jax

    got = runs["rest"].result(f"lora_{policy}")
    _assert_matches_jax(got, runs["refs"]["lora"])
    assert got["remat_calls"] == (0 if policy == "off" else STEPS * 2)


@pytest.mark.parametrize("mode", ["int8_rot", "int8_sr", "int8"])
def test_tp2_int8_base_equals_one_process_bit_for_bit(runs, mode):
    """(b, e) tp=2, the int8 base with the ``mode`` backward and the int8_sr
    CE head, bf16, the projector trained (no LoRA: every reduction of the
    backward is an s32 sum): three steps of the two ranks equal the
    one-process port's bit for bit: losses, accuracies, grad norms, the
    stochastic-rounding seeds and every trainable tensor. The projector is
    split over tp, so the ranks sum its gradient's squares a part at a
    time (``NormGroups``): the one-process norm is summed in that
    association (``_tp2_norm``), as test_torch_distributed's one-process
    reference rounds each rank's rows as that rank does."""
    got, want = runs["steps"].result(f"exact_{mode}"), runs["refs"][f"exact_{mode}"]
    assert got["metrics"] == want["metrics"]
    assert got["seeds"] == want["seeds"]
    for name, w in want["trainable"].items():
        assert torch.equal(got["trainable"][name], w), name


@pytest.mark.parametrize("mode", ["int8_rot", "bf16"])
def test_tp2_lora_over_the_int8_base_matches_one_process(runs, mode):
    """(b, c) tp=2, LoRA over the int8 base, bf16. The first two steps run
    at the seed's weights (the warmup's first rate is 0): their losses and
    accuracies equal the one-process port's bit for bit (the forward's int8
    products and the int8 CE head are exact), and as the LoRA rank-r sums
    and the ``bf16`` dx reduce f32 partials, their grad norms agree within
    two bf16 roundings. The third step's loss follows within two bf16
    roundings."""
    got, want = runs["steps"].result(f"mixed_{mode}"), runs["refs"][f"mixed_{mode}"]
    for a, b in zip(got["metrics"][:2], want["metrics"][:2]):
        assert (a["loss"], a["acc"]) == (b["loss"], b["acc"])
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=2 * BF16)
    np.testing.assert_allclose(got["metrics"][2]["loss"], want["metrics"][2]["loss"], rtol=2 * BF16)


def test_tp2_holds_its_shards_of_the_int8_base(runs):
    """A tp=2 rank holds half of every split tensor on the axis its dense
    splits (q / k / v, gate / up column-parallel on F; o_proj / down_proj
    row-parallel on K; the head on the vocabulary; the whisper encoder's
    q / k / v / fc1 on F and out_proj / fc2 on K; the projector's linear1 on
    F and linear2 on K), and the scales whose axis is not split whole, each
    quantized from the whole tensor first."""
    got = runs["steps"].result("exact_int8_rot")["shapes"]
    want = runs["refs"]["exact_int8_rot"]["shapes"]
    assert set(got) == set(want)
    seen = set()
    for name, shape in want.items():
        owner, leaf = name.rsplit(".", 1)
        dense = owner.rsplit(".", 1)[-1]
        llm = owner.startswith("llm.")
        whisper = owner.startswith("encoder.")
        dims = (COLUMN_DIMS if llm and dense in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "lm_head")
                else ROW_DIMS if llm and dense in ("o_proj", "down_proj")
                else COLUMN_DIMS if whisper and dense in ("q_proj", "k_proj", "v_proj", "fc1") or dense == "linear1"
                else ROW_DIMS if whisper and dense in ("out_proj", "fc2") or dense == "linear2" else None)
        if owner == "llm":
            dim = {"head_q": 0, "head_scale": 0, "head_qt": 1}[leaf]
        elif owner == "llm.embed_tokens":
            dim = 0
        elif dims is not None:
            dim = dims[leaf]
        else:
            dim = None  # the encoder's convolutions and LayerNorms: whole
        expect = list(shape)
        if dim is not None:
            expect[dim] //= 2
            seen.add(leaf)
        assert got[name] == tuple(expect), (name, got[name], shape)
    assert seen >= {"kernel_q", "kernel_scale", "kernel_qr", "kernel_scale_r", "head_q", "head_scale", "head_qt"}


def test_tp2_units_equal_one_process(runs):
    """(b, d) tp=2 against one process on the same inputs: each int8 dense's
    output and dx, both roles, every backward mode, bit for bit (the
    column-parallel int8_rot dx through the gather where the rotation block
    straddles the ranks, F 64, and the row-split passes where it does not,
    F 512), except the bf16 backward's column dx (f32 partials, one bf16
    rounding); the vocab-parallel CE's loss and accuracy bit for bit with
    every head, a tie planted across the shard border (rows 127 / 128)
    resolved to the lower index, its dx bit for bit under int8_sr (within a
    bf16 rounding where dx reduces f32 partials) and the plain head's dW;
    the vocab-parallel embedding bit for bit."""
    got, want = runs["rest"].result("units"), runs["refs"]["units"]
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if key == "embed":
            assert torch.equal(g, w)
            continue
        if key.startswith("ce_"):
            loss, acc, dx, dw = g
            assert torch.equal(loss, w[0]) and torch.equal(acc, w[1]), key
            if key == "ce_int8_sr":
                assert torch.equal(dx, w[2])
            else:
                torch.testing.assert_close(dx, w[2], rtol=BF16, atol=BF16 * float(w[2].abs().max()))
            if dw is not None:
                torch.testing.assert_close(dw.float(), w[3].float(), rtol=BF16, atol=BF16 * float(w[3].abs().max()))
            continue
        (y, dx), (wy, wdx) = g, w
        assert torch.equal(y, wy), key
        if key.endswith("_bf16"):
            torch.testing.assert_close(dx.float(), wdx.float(), rtol=BF16, atol=BF16 * float(wdx.abs().max()))
        else:
            assert torch.equal(dx, wdx), key
    assert float(want["ce_int8_sr"][1]) > 0  # the tied row's label is predicted


def test_tp_ranks_of_a_data_rank_draw_the_same_masks_and_seeds(runs):
    """(f) fsdp=2 x tp=2: the two tp ranks of each data rank draw the same
    LoRA dropout mask and the same stochastic-rounding seeds; the two data
    ranks draw different ones (each keyed on its data rank)."""
    got = runs["four"].result("seeds")
    by_data = {}
    for r in got:
        by_data.setdefault(r["data"], []).append(r)
    assert sorted(by_data) == [0, 1] and all(len(v) == 2 for v in by_data.values())
    for ranks in by_data.values():
        assert {r["tp"] for r in ranks} == {0, 1}
        assert ranks[0]["seeds"] == ranks[1]["seeds"] and ranks[0]["seeds"]
        assert torch.equal(ranks[0]["mask"], ranks[1]["mask"])
    assert by_data[0][0]["seeds"] != by_data[1][0]["seeds"]
    assert not torch.equal(by_data[0][0]["mask"], by_data[1][0]["mask"])


def test_tp2_checkpoints_hold_whole_tensors_and_resume_across_meshes(runs):
    """(g) pipeline.finetune at tp=2 (the int8 base, LoRA, validation):
    model.pt and full_state.pt hold whole tensors of the one-process run's
    names and shapes (its whisper and projector summing in the tp=2 order,
    ``sum_in_tp2_order``), within a bf16 rounding of its values; the tp=2 state
    resumed in one process is restored bit for bit; the one-process state
    resumed at fsdp=2 x tp=2 is gathered back bit for bit."""
    from test_torch_distributed import _close

    from slam_llm_tpu_torch.pipeline import finetune
    from slam_llm_tpu_torch.utils.checkpoint import load_state

    root, one = runs["root"], runs["refs"]["one"]
    two = runs["rest"].result("finetune")
    assert [s["step"] for s in two["steps"]] == [s["step"] for s in one["steps"]] == [1, 2]
    for a, b in zip(two["steps"], one["steps"]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=BF16)
    # half of each split tensor of the int8 base, the scales of an unsplit axis whole
    assert one["base_bytes"] / 2 < two["base_bytes"] < 0.55 * one["base_bytes"]
    ckpt_two, ckpt_one = Path(two["checkpoints"][-1]), Path(one["checkpoints"][-1])
    sd_two = torch.load(ckpt_two / "model.pt", weights_only=True)
    sd_one = torch.load(ckpt_one / "model.pt", weights_only=True)
    assert set(sd_two) == set(sd_one)
    for name, w in sd_one.items():
        assert sd_two[name].shape == w.shape and sd_two[name].dtype == w.dtype, name
        assert _close(sd_two[name], w, 2 * BF16), name
    full_two = load_state(str(ckpt_two))
    again = _run_cfg(root, **{"train_config.output_dir": str(root / "restored"), "train_config.num_epochs": 0,
                              "train_config.resume_from": str(ckpt_two), "train_config.save_model": False})
    trainer = finetune.main(again, device="cpu")["trainer"]
    assert trainer.step == 2
    for name, p in trainer.trainable.items():
        assert torch.equal(p.detach(), full_two["trainable"][name]), name
    state = trainer.optimizer.state_dict()
    for key in ("mu", "nu"):
        assert all(torch.equal(a, b) for a, b in zip(state[key], full_two["optimizer"][key]))

    full_one = load_state(one["checkpoints"][-1])
    back = load_state(runs["four"].result("resume4")["checkpoints"][-1])
    assert back["step"] == 2
    for name, w in full_one["trainable"].items():
        assert torch.equal(back["trainable"][name], w), name
    for key in ("mu", "nu"):
        assert all(torch.equal(a, b) for a, b in zip(back["optimizer"][key], full_one["optimizer"][key]))


def _decode_equals_one_process(runs, name: str, factory: str) -> None:
    from slam_llm_tpu_torch.pipeline import inference_batch

    root = runs["root"]
    runs["rest"].result(name)
    one = inference_batch.main(_run_cfg(root, **{"decode_config.decode_log": str(root / f"one_{name}"),
                                                 "model_config.file": factory}), device="cpu")
    log = {"decode": "tp2_decode", "decode_f32": "tp2_f32_decode"}[name]
    for kind in ("pred", "gt"):
        want = Path(one[kind]).read_text().splitlines()
        assert len(want) == 5
        assert Path(f"{root}/{log}_{kind}").read_text().splitlines() == want
    assert not Path(f"{root}/{log}_pred_rank0").exists()


def test_tp2_decode_writes_logs_equal_to_one_process(runs):
    """(h) inference_batch at tp=2, the recipe's bf16: tp rank 0 writes
    ``_pred`` / ``_gt`` (one data rank: no rank suffix), line for line the
    one-process decode's whose whisper and projector sum their row products
    in the tp=2 order (``sum_in_tp2_order``: the order alone moves a bf16
    rounding now and then, and the random tiny model's beams hold near
    ties)."""
    _decode_equals_one_process(runs, "decode", TP2_ORDER_FACTORY)


def test_tp2_decode_in_f32_writes_logs_equal_to_one_process(runs):
    """(h) inference_batch at tp=2 in f32 (the LLM, the encoder and the
    projector): line for line the one-process decode's in its own order."""
    _decode_equals_one_process(runs, "decode_f32", F32_FACTORY)


def test_unsplit_paths_raise_under_tp(tmp_path, monkeypatch):
    """(h) inference_vallex under several processes raises, naming its
    ROADMAP entry (VALL-E X itself splits over tp: its tables and heads hold
    half their rows a rank; ``tests/test_torch_tp_families.py`` runs it). A decode
    sharded over fsdp (``inference_batch`` and ``generate_s2s`` under
    ``shard.fsdp=2``) in one process raises ValueError: its mesh is not the
    world. (The sharded decodes run: ``tests/test_torch_sharded_serving.py``;
    generate_s2s under tp: ``tests/test_torch_s2s_tp.py``.)"""
    from slam_llm_tpu_torch.config import RunConfig, set_by_path
    from slam_llm_tpu_torch.models.vallex import VALLE, VallexConfig
    from slam_llm_tpu_torch.parallel.tensor_parallel import split_for_tp
    from slam_llm_tpu_torch.pipeline import generate_s2s, inference_batch, inference_vallex

    cfg = RunConfig()
    set_by_path(cfg, "train_config.shard.fsdp", 2)
    for entry in (generate_s2s, inference_batch):
        with pytest.raises(ValueError, match="shard.fsdp=2 x shard.tp=1 needs 2 processes"):
            entry.main(cfg, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="ROADMAP, Do not port: a multi-rank inference_vallex"):
        inference_vallex.main(["--ckpt_path", "x", "--codec_path", "x", "--prompt_text", "a", "--prompt_codes", "x",
                               "--target_text", "b", "--save_path", str(tmp_path / "o.wav"), "--device", "cpu"])

    class Mesh:  # a tp axis of two, without a process group (the split itself runs no collective)
        def __getitem__(self, axis):
            return type("Axis", (), {"size": lambda s: 2, "get_group": lambda s: None,
                                     "get_local_rank": lambda s: 0})()

    model = VALLE(VallexConfig.tiny_test())
    assert split_for_tp(model, Mesh()) == ["VALLE"]
    assert model.text_embedding.weight.shape == (16, 32) and model.ar_head.weight.shape == (12, 32)


@pytest.mark.parametrize("mode", ["deterministic", "sr", "fold", "fold_sr", "rotate_sr", "f32_fold_sr"])
def test_row_split_twins_equal_whole_row_runs(mode):
    """K2's row-split twins: at column offset 0 with the row's own scale,
    ``rowquant_scaled_ref`` is ``rowquant_ref``; each rank's slice of a
    (24, 512) row, at its offset with the scale of the MAX over the slices'
    absmax, equals those columns of the whole-row run, bit for bit (the
    rotation by the whole row's block 256, which holds whole in a slice of
    256, at tp=2; without it at tp=4)."""
    from slam_llm_tpu_torch.ops.kernels.rowquant import (
        row_scale,
        rowquant_absmax_ref,
        rowquant_ref,
        rowquant_scaled_ref,
    )

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((24, 512)).astype(np.float32) * 2)
    x[0] = 0.0
    x = x if mode.startswith("f32") else x.to(torch.bfloat16)
    fold = torch.from_numpy(rng.random(512).astype(np.float32) + 0.1) if "fold" in mode else None
    seed = 2**32 - 7 if "sr" in mode else None
    rotate = mode.startswith("rotate")
    block, tp = (256, 2) if rotate else (0, 4)
    q, s = rowquant_ref(x, fold, seed=seed, rotate=rotate)
    assert torch.equal(rowquant_scaled_ref(x, s, fold, seed=seed, rotate_block=block), q)
    n = 512 // tp
    slices = [(x[:, a:a + n], None if fold is None else fold[a:a + n], a) for a in range(0, 512, n)]
    amax = torch.stack([rowquant_absmax_ref(xs, fs, rotate_block=block) for xs, fs, _ in slices]).amax(0)
    assert torch.equal(row_scale(amax), s.reshape(-1))
    for xs, fs, a in slices:
        got = rowquant_scaled_ref(xs, row_scale(amax), fs, seed=seed, col_offset=a, rotate_block=block)
        assert torch.equal(got, q[:, a:a + n]), a


def test_s32_twin_shards_sum_to_the_whole_product():
    """K3's s32 twin over K shards sums, as integers, to the whole
    product's accumulators, and the epilogue twin on them is
    ``int8_matmul_ref`` (bf16 and f32) bit for bit."""
    from slam_llm_tpu_torch.ops.quant import int8_epilogue_ref, int8_matmul_ref, int8_matmul_s32_ref

    rng = np.random.default_rng(4)
    xq = torch.from_numpy(rng.integers(-127, 128, (20, 96)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (40, 96)).astype(np.int8))
    xs, ws = (torch.from_numpy(rng.random(n).astype(np.float32) * 0.1) for n in (20, 40))
    acc = sum(int8_matmul_s32_ref(xq[:, a:a + 32], wq[:, a:a + 32]) for a in range(0, 96, 32))
    assert acc.dtype == torch.int32 and torch.equal(acc, int8_matmul_s32_ref(xq, wq))
    for dt in (torch.bfloat16, torch.float32):
        assert torch.equal(int8_epilogue_ref(acc, xs, ws, dt), int8_matmul_ref(xq, wq, xs, ws, dt))


@pytest.mark.parametrize("what,dims", [
    ("attention heads", {"n_heads": 3, "n_kv_heads": 1}), ("kv heads", {"n_heads": 6, "n_kv_heads": 3}),
    ("ffn", {"ffn_dim": 511}), ("vocabulary", {"vocab_size": 255})])
def test_a_dimension_tp_does_not_divide_raises(what, dims):
    """(i) tp=2 over an odd dimension raises ValueError naming it, before any
    tensor is touched."""
    from slam_llm_tpu_torch.models.llm import CausalLM, LLMConfig
    from slam_llm_tpu_torch.parallel.tensor_parallel import TP, split_llm

    llm = CausalLM(dataclasses.replace(LLMConfig.tiny_test(), **{**LLM_DIMS, "n_layers": 1, **dims}))
    before = llm.embed_tokens.weight.shape
    with pytest.raises(ValueError, match=f"does not divide the {what} "):
        split_llm(llm, TP(None, 2, 0))
    assert llm.embed_tokens.weight.shape == before


if __name__ == "__main__":
    sys.path.insert(0, str(HERE))
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    _worker(sys.argv[1], sys.argv[2])
