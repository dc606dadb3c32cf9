"""Tensor parallelism (``shard.tp``) of every model family past the decoder
LLM and whisper, on the CPU with gloo: the Q-Former, the WavLM layer
(WavLM with its gated rel-pos bias, HuBERT without it, BEATs, AV-HuBERT),
the ViT block (EAT, Spatial-AST), MusicFM's Conformer and VALL-E X.

Worker processes run this file as a script through
``test_torch_distributed``'s launcher (``_Group``: torchrun's environment,
``PROC_TIMEOUT`` a worker, ``DIST_TIMEOUT`` a collective), each running the
jobs of its payload; rank 0 writes each job's result. Two groups run side by
side while this process computes the references:

* two ranks (tp=2): every family's module split in f32 and in bf16 (its
  outputs, the split dim of each tensor, what stays whole); VALL-E X's
  trainer steps; an SEC-style step (emotion2vec-shaped encoder split, the
  Q-Former trained and split, the tiny LLM split); ``pipeline.inference_batch``
  of a whisper + Q-Former recipe in f32 and in bf16; ``pipeline.finetune``
  of VALL-E X (``model.pt``) and its state resumed at fsdp=2;
* four ranks (fsdp=2 x tp=2): VALL-E X's trainer steps.

The references: each JAX module on the JAX package's own (1, 1, 2) mesh,
its params laid out by the logical rules; the JAX ``Trainer`` on its
(1, 1, 2) and (1, 2, 2) meshes; the one-process port, in bf16 with its row
products summed in the tp=2 order (``test_torch_tensor_parallel._tp2_row_base``)
and in its own.
"""

import dataclasses
import fnmatch
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
STEPS = 3
BF16 = 2.0 ** -8  # one bf16 rounding, relative
FAMILIES = ["qformer", "wavlm", "hubert", "beats", "eat", "spatial_ast", "musicfm", "avhubert", "vallex"]
# the tensors the port splits where the reference keeps them whole (PERF.md):
# MusicFM's depthwise conv and its BatchNorm run on the rank's channels
PORT_ONLY_SPLITS = ("layers.*.depthwise_conv.weight", "layers.*.conv_bn.*")
VOCAB = 264  # the byte tokenizer's ids padded so tp=2 divides them
QUERIES = 8
MAX_NEW = 6
F32_VALLEX = f"{Path(__file__).resolve()}:f32_vallex_factory"


def f32_vallex_factory(train_config, model_config, device=None, **kwargs):
    """The port's VALL-E X factory computing in f32 (``vallex-tiny-test`` at
    four heads), for the finetune runs compared across meshes."""
    from slam_llm_tpu_torch.data.tokenizer import load_tokenizer
    from slam_llm_tpu_torch.models.vallex import VALLE

    return VALLE(_vallex_cfg(), device), load_tokenizer(model_config.llm_path)


def _vallex_cfg(dtype=torch.float32):
    from slam_llm_tpu_torch.models.vallex import VallexConfig

    return dataclasses.replace(VallexConfig.tiny_test(), n_heads=4, dtype=dtype)


# ---- the worker side (no JAX) ------------------------------------------------------


def _port_module(kind, cfg):
    from slam_llm_tpu_torch.models import avhubert, beats, musicfm, projector, spatial_ast, vallex, vit, wavlm

    ctor = {"qformer": projector.ProjectorQFormer, "wavlm": wavlm.WavLMEncoder, "hubert": wavlm.WavLMEncoder,
            "beats": beats.BEATsEncoder, "eat": vit.ViTEncoder, "spatial_ast": spatial_ast.SpatialASTEncoder,
            "musicfm": musicfm.MusicFMEncoder, "avhubert": avhubert.AVHubertEncoder, "vallex": vallex.VALLE}[kind]
    return ctor(cfg)


def _port_call(kind, module, inputs):
    """The family's output(s) on ``inputs`` (numpy), whole on every rank."""
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    with torch.no_grad():
        if kind == "vallex":
            ar = module.ar_forward(t["text_ids"], t["text_mask"], t["audio_ids"][:, 0], t["audio_mask"])
            nar = module.nar_forward(t["text_ids"], t["text_mask"], t["audio_ids"], t["audio_mask"], t["nar_stage"])
            return {"ar": ar, "nar": nar}
        if kind == "qformer":
            return {"out": module(t["x"], t["mask"])}
        if kind == "spatial_ast":
            return {"out": module(t["x"])[0]}
        if kind == "avhubert":
            return {"out": module(t["video"], t["x"], t["mask"])[0]}
        return {"out": module(t["x"], t["mask"])[0]}


def _family(kind, cfg, state_dict, inputs, dtype, tp=None, tp2_order=False):
    """The family's port module at ``dtype`` holding ``state_dict``, split
    over ``tp`` where given: its outputs, each tensor's split dim, what stays
    whole (``replicated_modules``). ``tp2_order`` (one process): its row
    products summed in a tp=2 run's order."""
    from slam_llm_tpu_torch.parallel.tensor_parallel import replicated_modules, split_for_tp, tp_dim

    module = _port_module(kind, dataclasses.replace(cfg, dtype=dtype))
    module.load_state_dict(state_dict)
    if tp is not None:
        split_for_tp(module, _MeshOf(tp))
    if tp2_order:
        _rows_in_tp2_order(module, _port_module(kind, dataclasses.replace(cfg, dtype=torch.float32)))
    names = [n for n, _ in [*module.named_parameters(), *module.named_buffers()]]
    return {**_port_call(kind, module, inputs), "dims": {n: tp_dim(module, n) for n in names},
            "shapes": {n: tuple(t.shape) for n, t in module.state_dict().items()},
            "whole": replicated_modules(module) if tp is not None else None}


class _MeshOf:
    """A mesh stand-in whose tp axis is ``tp`` (a ``parallel.tensor_parallel.TP``)."""

    def __init__(self, tp):
        self.tp = tp

    def __getitem__(self, axis):
        tp = self.tp
        return type("Axis", (), {"size": lambda s: tp.size, "get_group": lambda s: tp.group,
                                 "get_local_rank": lambda s: tp.rank})()


def _rows_in_tp2_order(module, shadow):
    """Every dense that a tp=2 split makes row-parallel in ``shadow`` (a
    whole copy of ``module``'s structure, consumed) sums its product in
    ``module`` (whole) as two tp=2 ranks do (``_tp2_row_base``)."""
    import types

    from test_torch_tensor_parallel import _tp2_row_base

    from slam_llm_tpu_torch.parallel.tensor_parallel import TP, split_for_tp

    split_for_tp(shadow, _MeshOf(TP(None, 2, 0)))
    rows = {n for n, m in shadow.named_modules() if getattr(getattr(m, "tp", None), "role", None) == "row"}
    assert rows
    for name in rows:
        dense = module.get_submodule(name)
        dense._base = types.MethodType(_tp2_row_base, dense)


def _vallex_steps(job, mesh):
    """VALL-E X's trainer steps (f32) over ``job["batches"]``: metrics, whole
    trainable tensors, local shapes."""
    from slam_llm_tpu_torch.models.vallex import VALLE
    from slam_llm_tpu_torch.parallel.sharding import local_part
    from slam_llm_tpu_torch.train.state import Trainer

    model = VALLE(job["cfg"])
    model.load_state_dict(job["state_dict"])
    trainer = Trainer(model, model.cfg, job["tc"], mesh=mesh).state_from_params()
    metrics = []
    for batch in job["batches"]:
        m = trainer.train_step(trainer.put_batch(batch))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "trainable": trainer.whole_trainable(),
            "shapes": {n: tuple(local_part(p).shape) for n, p in model.named_parameters()}}


def _slam_steps(job, mesh):
    """STEPS trainer steps of a SLAMModel (the SEC-style recipe, f32)."""
    from slam_llm_tpu_torch.models.slam_model import SLAMModel
    from slam_llm_tpu_torch.train.state import Trainer

    model = SLAMModel(job["cfg"])
    model.load_state_dict(job["state_dict"])
    trainer = Trainer(model, model.cfg, job["tc"], mesh=mesh).state_from_params()
    metrics = []
    for _ in range(STEPS):
        m = trainer.train_step(trainer.put_batch(job["batch"]))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "trainable": trainer.whole_trainable(),
            "shapes": {n: tuple(p.shape) for n, p in model.named_parameters()}}


def _qformer_slam_cfg(dtype):
    """A whisper + Q-Former ASR / ST-style tiny recipe (tiny LLM at VOCAB)."""
    from slam_llm_tpu_torch.models import llm as tllm
    from slam_llm_tpu_torch.models import projector as tproj
    from slam_llm_tpu_torch.models import slam_model as tslam
    from slam_llm_tpu_torch.models import whisper as twhisper

    llm = dataclasses.replace(tllm.LLMConfig.tiny_test(VOCAB), lora_rank=0, dtype=dtype)
    enc = dataclasses.replace(twhisper.WhisperEncoderConfig.tiny_test(), dtype=dtype)
    proj = tproj.ProjectorConfig(encoder_dim=enc.d_model, llm_dim=llm.d_model, query_len=QUERIES, qformer_layers=2,
                                 qformer_dim=32, qformer_heads=4, dtype=dtype)
    return tslam.SLAMConfig(llm=llm, encoder_name="whisper", encoder=enc, projector="q-former", projector_cfg=proj)


def _decode_cfg(manifest: str, log: str, **shard):
    from slam_llm_tpu_torch.config import RunConfig, set_by_path

    cfg = RunConfig()
    for key, value in {"model_config.llm_name": "tiny-test", "model_config.encoder_name": "whisper",
                       "model_config.encoder_config": "whisper-tiny-test", "model_config.encoder_projector": "q-former",
                       "dataset_config.val_data_path": manifest, "dataset_config.fix_length_audio": QUERIES,
                       "dataset_config.mel_size": 8, "dataset_config.input_type": "mel",
                       "train_config.val_batch_size": 2, "decode_config.max_new_tokens": MAX_NEW,
                       "decode_config.num_beams": 1, "decode_config.decode_log": log,
                       **{f"train_config.shard.{k}": v for k, v in shard.items()}}.items():
        set_by_path(cfg, key, value)
    return cfg


def with_weights(cfg, state_dict):
    """A copy of ``cfg`` whose ``ckpt_path`` holds ``state_dict`` whole (a
    ``model.pt`` of this process's own), which overlays the seeded init as
    the entry point builds the model, into its shards under a mesh."""
    import copy

    import torch.distributed as dist

    from slam_llm_tpu_torch.utils.checkpoint import save_trainable

    rank = dist.get_rank() if dist.is_initialized() else 0
    cfg = copy.deepcopy(cfg)
    cfg.ckpt_path = save_trainable(f"{cfg.decode_config.decode_log}_weights_rank{rank}.pt", state_dict)
    return cfg


def run_decode(cfg, state_dict, dtype, tp2_order=False):
    """``pipeline.inference_batch.main`` on the whisper + Q-Former recipe at
    ``dtype`` holding ``state_dict``; returns its ``_pred`` lines and each
    greedy step's whole logits, batch by batch: (B, V) f32 a step.
    ``tp2_order`` (one process): every row-parallel product summed in a
    tp=2 run's order."""
    from slam_llm_tpu_torch.models import slam_model as tslam
    from slam_llm_tpu_torch.pipeline import inference_batch

    steps = []
    generator_cls = inference_batch.Generator

    class Recording(generator_cls):
        def __init__(self, model, *args, **kwargs):
            if tp2_order:
                _rows_in_tp2_order(model, tslam.SLAMModel(_qformer_slam_cfg(torch.float32)))
            super().__init__(model, *args, **kwargs)
            step = model.decode_step

            def decode_step(*a, **kw):
                logits, cache = step(*a, **kw)
                steps[-1].append(logits[:, 0].float().clone())
                return logits, cache

            model.decode_step = decode_step

        def _prefill(self, batch, max_new):
            out = super()._prefill(batch, max_new)
            steps.append([out[1].float().clone()])
            return out

    build = tslam.build_slam_config
    tslam.build_slam_config = lambda train_config, model_config: _qformer_slam_cfg(dtype)
    inference_batch.Generator = Recording
    try:
        res = inference_batch.main(with_weights(cfg, state_dict), device="cpu")
    finally:
        tslam.build_slam_config = build
        inference_batch.Generator = generator_cls
    return {"pred": Path(res["pred"]).read_text().splitlines(), "steps": steps}


def _worker(payload: str, out_dir: str) -> None:
    import torch.distributed as dist
    from test_torch_distributed import DIST_TIMEOUT, _finetune_job

    from slam_llm_tpu_torch.parallel.sharding import make_mesh
    from slam_llm_tpu_torch.parallel.tensor_parallel import tp_of
    from slam_llm_tpu_torch.pipeline.common import maybe_init_distributed

    torch.set_num_threads(1)
    assert maybe_init_distributed("cpu", timeout=DIST_TIMEOUT)

    def mesh(fsdp=1):
        return make_mesh(dp=1, fsdp=fsdp, tp=dist.get_world_size() // fsdp, device_type="cpu")

    def families(job):
        tp = tp_of(mesh())
        return {kind: _family(kind, f["cfg"], f["state_dict"], f["inputs"], job["dtype"], tp)
                for kind, f in job["families"].items()}

    def decode(job):
        out = run_decode(job["cfg"], job["state_dict"], job["dtype"])
        return {"pred": out["pred"], "steps": out["steps"]}

    jobs = {"families": families, "vallex": lambda job: _vallex_steps(job, mesh(job.get("fsdp", 1))),
            "slam": lambda job: _slam_steps(job, mesh()), "decode": decode, "finetune": _finetune_job}
    for job in torch.load(payload, weights_only=False):
        result = jobs[job["kind"]](job)
        if dist.get_rank() == 0:
            torch.save(result, Path(out_dir) / f"{job['name']}.pt")
    dist.destroy_process_group()


# ---- the references ------------------------------------------------------------------


def _seeded(tree, seed):
    """Every float leaf of a flax parameter tree (arrays or their shapes,
    ``jax.eval_shape``'s) drawn from a numpy generator: kernels and tables normal with std 1 / sqrt(fan_in), scales,
    gate constants and BatchNorm variances around 1, biases and means small
    (nonzero, so a bias added twice or split wrongly shows)."""
    from flax import linen as nn

    rng = np.random.default_rng(seed)

    def draw(key, x):
        shape = tuple(x.shape)
        if key in ("scale", "gn_scale", "gru_rel_pos_const") or key.endswith("var"):
            return (1.0 + 0.1 * np.abs(rng.standard_normal(shape))).astype(np.float32)
        if key in ("bias", "gn_bias") or key.endswith("mean"):
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else draw(k, v) for k, v in node.items()}

    return walk(nn.meta.unbox(tree))


def _conv(cls, obj, **kw):
    """The port's config dataclass ``cls`` from the JAX one's fields (f32)."""
    names = {f.name for f in dataclasses.fields(cls)} - {"dtype", "param_dtype"}
    return cls(**{n: getattr(obj, n) for n in names if hasattr(obj, n)}, dtype=torch.float32, **kw)


def _vallex_batch(b=4, tt=8, ta=12, seed=0):
    rng = np.random.default_rng(seed)
    tm = np.zeros((b, tt), np.int32)
    am = np.zeros((b, ta), np.int32)
    for i, (nt, na) in enumerate(((8, 12), (5, 7), (3, 10), (6, 9))[:b]):  # text padded inside the row
        tm[i, :nt], am[i, :na] = 1, 1
    return {"text_ids": (rng.integers(0, 32, (b, tt)) * tm).astype(np.int32), "text_mask": tm,
            "audio_ids": (rng.integers(0, 16, (b, 4, ta)) * am[:, None]).astype(np.int32), "audio_mask": am,
            "nar_stage": np.array([1, 3, 2, 1][:b], np.int32)}


def _family_specs():
    """Per family: the JAX module, its call's arguments and method, the
    port's config and the numpy inputs, the converter's encoder name (None:
    the generic mapping). Every family at four heads, so a rank holds two."""
    import jax.numpy as jnp

    from slam_llm_tpu.models import avhubert as javhubert
    from slam_llm_tpu.models import beats as jbeats
    from slam_llm_tpu.models import musicfm as jmusicfm
    from slam_llm_tpu.models import projector as jproj
    from slam_llm_tpu.models import spatial_ast as jspatial
    from slam_llm_tpu.models import vallex as jv
    from slam_llm_tpu.models import vit as jvit
    from slam_llm_tpu.models import wavlm as jwavlm
    from slam_llm_tpu_torch.models import avhubert, beats, musicfm, projector, spatial_ast, vallex, vit, wavlm

    f32 = jnp.float32
    rng = np.random.default_rng(7)

    def masked(b, t, valid):
        m = np.ones((b, t), np.int32)
        m[1, valid:] = 0
        return m

    specs = {}
    jq = jproj.ProjectorConfig(encoder_dim=32, llm_dim=48, query_len=QUERIES, qformer_layers=2, qformer_dim=32,
                               qformer_heads=4, dtype=f32)
    specs["qformer"] = (jproj.ProjectorQFormer(jq), _conv(projector.ProjectorConfig, jq),
                        {"x": rng.standard_normal((2, 10, 32)).astype(np.float32), "mask": masked(2, 10, 6)}, None)
    for kind, bias in (("wavlm", True), ("hubert", False)):
        jc = dataclasses.replace(jwavlm.WavLMConfig.tiny_test(rel_bias=bias), n_heads=4, dtype=f32)
        specs[kind] = (jwavlm.WavLMEncoder(jc), _conv(wavlm.WavLMConfig, jc),
                       {"x": (rng.standard_normal((2, 800)) * 0.3).astype(np.float32), "mask": masked(2, 800, 600)},
                       "wavlm")
    fbank = {"x": rng.standard_normal((2, 32, 16)).astype(np.float32), "mask": masked(2, 32, 20)}
    jc = dataclasses.replace(jbeats.BEATsEncoderConfig.tiny_test(), n_heads=4, dtype=f32)
    specs["beats"] = (jbeats.BEATsEncoder(jc), _conv(beats.BEATsEncoderConfig, jc), fbank, "beats")
    jc = dataclasses.replace(jvit.ViTEncoderConfig.tiny_test(), n_heads=4, dtype=f32)
    specs["eat"] = (jvit.ViTEncoder(jc), _conv(vit.ViTEncoderConfig, jc), fbank, "eat")
    jc = dataclasses.replace(jspatial.SpatialASTConfig.tiny_test(), n_heads=4)
    specs["spatial_ast"] = (jspatial.SpatialASTEncoder(jc), _conv(spatial_ast.SpatialASTConfig, jc),
                            {"x": (rng.standard_normal((2, 4, 50, 32)) * 5).astype(np.float32)}, "spatial_ast")
    jc = dataclasses.replace(jmusicfm.MusicFMConfig.tiny_test(), n_heads=4, dtype=f32)
    specs["musicfm"] = (jmusicfm.MusicFMEncoder(jc), _conv(musicfm.MusicFMConfig, jc),
                        {"x": (rng.standard_normal((2, 40, 16)) * 10 - 20).astype(np.float32),
                         "mask": masked(2, 40, 28)}, "musicfm")
    jc = dataclasses.replace(javhubert.AVHubertConfig.tiny_test(), n_heads=4, dtype=f32)
    specs["avhubert"] = (javhubert.AVHubertEncoder(jc), _conv(avhubert.AVHubertConfig, jc),
                         {"video": rng.standard_normal((2, 6, 32, 32)).astype(np.float32),
                          "x": rng.standard_normal((2, 6, 16)).astype(np.float32), "mask": masked(2, 6, 4)},
                         "av_hubert")
    jc = dataclasses.replace(jv.VallexConfig.tiny_test(), n_heads=4, dtype=f32)
    specs["vallex"] = (jv.VALLE(jc), _conv(vallex.VallexConfig, jc), _vallex_batch(), None)
    return specs


def _jax_args(kind, inputs):
    import jax.numpy as jnp

    a = {k: jnp.asarray(v) for k, v in inputs.items()}
    if kind == "vallex":
        return a
    if kind == "spatial_ast":
        return (a["x"],)
    if kind == "avhubert":
        return (a["video"], a["x"], a["mask"])
    return (a["x"], a["mask"])


def _to_port(tree, encoder):
    from slam_llm_tpu_torch.utils.convert import encoder_from_flax, flax_to_state_dict

    return flax_to_state_dict(tree) if encoder is None else encoder_from_flax(tree, encoder)


def _jax_family_params():
    """Each family's JAX module and its seeded params: the port config,
    state dict and inputs, and per port tensor whether the reference's
    tensor carries a ``heads`` / ``mlp`` / ``vocab`` axis (its tp axis)."""
    import jax
    from flax import linen as nn
    from jax.sharding import PartitionSpec

    out = {}
    for i, (kind, (module, cfg, inputs, encoder)) in enumerate(_family_specs().items()):
        args = _jax_args(kind, inputs)
        if kind == "vallex":
            boxed = jax.eval_shape(lambda r: module.init(r, args, method="init_all"), jax.random.PRNGKey(i))
        else:
            boxed = jax.eval_shape(lambda r: module.init(r, *args), jax.random.PRNGKey(i))
        boxed = boxed["params"]
        specs = nn.get_partition_spec(boxed)
        params = _seeded(boxed, seed=i)
        tp_axes = jax.tree_util.tree_map(
            lambda s, v: np.full(np.shape(v), float(any(a in ("heads", "kv_heads", "mlp", "vocab") for a in s
                                                        if a is not None)), np.float32),
            specs, params, is_leaf=lambda x: isinstance(x, PartitionSpec))
        flags = _to_port(tp_axes, encoder)
        out[kind] = {"module": module, "params": params, "specs": specs, "cfg": cfg, "inputs": inputs,
                     "state_dict": _to_port(params, encoder),
                     "tp_axis": {n: bool(t.numpy().any()) for n, t in flags.items()},
                     "uniform": all(float(t.min()) == float(t.max()) for t in flags.values())}
    return out


def _jax_family_outputs(fams):
    """Each family's JAX module on a (1, 1, 2) mesh (f32), its params laid
    out by the logical rules: its outputs."""
    import jax

    from slam_llm_tpu.parallel import make_mesh
    from slam_llm_tpu.parallel.sharding import logical_to_sharding

    mesh = make_mesh(dp=1, fsdp=1, tp=2, devices=jax.devices()[:2])
    out = {}
    for kind, f in fams.items():
        module, args = f["module"], _jax_args(kind, f["inputs"])
        placed = jax.device_put(f["params"], logical_to_sharding(mesh, f["specs"]))
        with mesh:
            if kind == "vallex":
                a = args
                got = {"ar": jax.jit(lambda p: module.apply({"params": p}, a["text_ids"], a["text_mask"],
                                                            a["audio_ids"][:, 0], a["audio_mask"],
                                                            method="ar_forward"))(placed),
                       "nar": jax.jit(lambda p: module.apply({"params": p}, a["text_ids"], a["text_mask"],
                                                             a["audio_ids"], a["audio_mask"], a["nar_stage"],
                                                             method="nar_forward"))(placed)}
            else:
                y = jax.jit(lambda p, *x: module.apply({"params": p}, *x))(placed, *args)
                got = {"out": y if kind == "qformer" else y[0]}
        out[kind] = {k: np.asarray(v) for k, v in got.items()}
    return out


def _jax_train_config(port_tc):
    """The JAX package's TrainConfig with the port one's scalar settings."""
    from slam_llm_tpu.config import TrainConfig

    tc = TrainConfig()
    for f in dataclasses.fields(tc):
        value = getattr(port_tc, f.name, None)
        if isinstance(value, (bool, int, float, str)):
            setattr(tc, f.name, value)
    return tc


def _jax_trainer_steps(model, jcfg, params, example, batches, port_tc, fsdp, tp=2):
    """The JAX Trainer's (loss, acc, grad norm) a step over ``batches`` on its
    (1, fsdp, tp) mesh, the params laid out by the logical rules, and its
    trainable tensors after the last, in the port's names."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    from slam_llm_tpu.parallel import make_mesh
    from slam_llm_tpu.parallel.sharding import logical_to_sharding
    from slam_llm_tpu.train.state import build_trainer

    mesh = make_mesh(dp=1, fsdp=fsdp, tp=tp, devices=jax.devices()[:fsdp * tp])
    jt = build_trainer(model, jcfg, _jax_train_config(port_tc), mesh)
    ex = {k: jnp.asarray(v) for k, v in example.items()}
    boxed = jax.eval_shape(lambda r: model.init(r, ex, method="init_all"), jax.random.PRNGKey(0))
    state = jt.state_from_params(jax.device_put(params, logical_to_sharding(mesh, nn.get_partition_spec(
        boxed["params"]))))
    metrics = []
    for i, batch in enumerate(batches):
        with mesh:
            state, m = jt.train_step(state, jt.put_batch(batch), jax.random.PRNGKey(i))
        metrics.append({k: float(m[k]) for k in ("loss", "acc", "grad_norm")})
    return metrics, jax.tree_util.tree_map(np.asarray, state["trainable"])


def _vallex_run_cfg(root: Path, corpus: Path, **overrides):
    from slam_llm_tpu_torch.config import load_run_config

    settings = {"model_config.file": F32_VALLEX, "model_config.llm_name": "vallex-tiny-test",
                "dataset_config.train_data_path": corpus, "dataset_config.val_data_path": corpus,
                "dataset_config.code_layer": 4, "dataset_config.text_vocabsize": 32,
                "dataset_config.text_buckets": "[16]", "dataset_config.audio_token_buckets": "[16]",
                "train_config.batch_size_training": 4, "train_config.val_batch_size": 4, "train_config.lr": 1e-3,
                "train_config.warmup_steps": 1, "train_config.total_steps": 10, "train_config.seed": 0,
                "train_config.num_epochs": 2, "train_config.log_interval": 1, "train_config.save_optimizer": True,
                "train_config.output_dir": root / "one", "train_config.shard.dp": -1, **overrides}
    return load_run_config(["--config", "examples/vallex/conf/vallex_tts.yaml",
                            *(f"++{k}={v}" for k, v in settings.items())])


def _recorded_finetune(cfg):
    """One-process ``pipeline.finetune``: its result, the host batches it
    trained on and the whole state dict it started from."""
    from slam_llm_tpu_torch.pipeline import finetune
    from slam_llm_tpu_torch.train.state import Trainer

    batches, start = [], {}
    step = Trainer.train_step

    def recording(self, batch):
        if not start:
            start.update({n: t.detach().clone() for n, t in self.model.state_dict().items()})
        batches.append({k: v.numpy().copy() for k, v in batch.items()})
        return step(self, batch)

    Trainer.train_step = recording
    try:
        res = finetune.main(cfg, device="cpu")
    finally:
        Trainer.train_step = step
    return res, batches, start


def _seeded_state(model, seed):
    """``model``'s state dict redrawn from a torch generator (f32): matrices
    and tables normal with std 1 / sqrt(fan_in), norm scales around 1,
    vectors small."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, t in model.state_dict().items():
        n = torch.randn(t.shape, generator=gen)
        if name.endswith(".scale"):
            out[name] = 1.0 + 0.1 * n
        elif t.ndim == 1:
            out[name] = 0.1 * n
        else:
            out[name] = n / float(np.sqrt(t[0].numel()))
    return out


def _sec_refs():
    """The SEC-style recipe (test_torch_music_spatial's: an emotion2vec-shaped
    tiny encoder + Q-Former, the tiny LLM, f32, the projector trained): the
    port config, state dict, batch and trainer settings, the JAX pieces."""
    import jax
    import jax.numpy as jnp
    from test_torch_music_spatial import _batch, _recipe

    from slam_llm_tpu.models.slam_model import SLAMModel as JSLAMModel
    from slam_llm_tpu_torch.config import TrainConfig
    from slam_llm_tpu_torch.utils.convert import from_flax_params

    jcfg, tcfg = _recipe("sec")
    batch = _batch("sec")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = _seeded(jax.eval_shape(lambda r: JSLAMModel(jcfg).init(r, jb, method="init_all"),
                                    jax.random.PRNGKey(0))["params"], seed=5)
    tc = TrainConfig()
    tc.lr, tc.warmup_steps, tc.total_steps, tc.seed = 1e-3, 1, 10, 0
    return {"jcfg": jcfg, "cfg": tcfg, "params": params, "batch": batch, "tc": tc,
            "state_dict": from_flax_params(params, tcfg)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax.numpy as jnp
    from test_torch_distributed import _Group
    from test_torch_sharded_serving import _asr_corpus

    from slam_llm_tpu.models import vallex as jv
    from slam_llm_tpu.models.slam_model import SLAMModel as JSLAMModel
    from slam_llm_tpu_torch.models.slam_model import SLAMModel
    from slam_llm_tpu_torch.tools.synth_checkpoint import write_vallex_corpus
    from slam_llm_tpu_torch.utils.convert import trainable_to_flax

    root = tmp_path_factory.mktemp("tp_families")
    torch.set_num_threads(2)
    # what the workers need: the one-process VALL-E X finetune (its batches
    # and start feed the trainer jobs), the families' and SEC's params
    corpus = write_vallex_corpus(str(root / "vallex.jsonl"), 8, frames=(6, 12), text_len=(4, 9), n_codebooks=4,
                                 audio_vocab=16, text_vocab=32)
    one, batches, start = _recorded_finetune(_vallex_run_cfg(root, corpus))
    fams = _jax_family_params()
    sec = _sec_refs()
    manifest = _asr_corpus(root)
    decode_sd = _seeded_state(SLAMModel(_qformer_slam_cfg(torch.float32)), seed=3)
    tp2_dir = root / "tp2"
    payload = {kind: {k: f[k] for k in ("cfg", "state_dict", "inputs")} for kind, f in fams.items()}
    vallex_job = {"kind": "vallex", "cfg": _vallex_cfg(), "state_dict": start, "tc": one["trainer"].train_config,
                  "batches": batches}
    two = _Group(2, [
        {"kind": "families", "name": "families_f32", "families": payload, "dtype": torch.float32},
        {"kind": "families", "name": "families_bf16", "families": payload, "dtype": torch.bfloat16},
        {**vallex_job, "name": "vallex_tp2"},
        {"kind": "slam", "name": "sec_tp2", "cfg": sec["cfg"], "state_dict": sec["state_dict"], "tc": sec["tc"],
         "batch": sec["batch"]},
        {"kind": "decode", "name": "decode_f32", "state_dict": decode_sd, "dtype": torch.float32,
         "cfg": _decode_cfg(str(manifest), str(root / "decode_f32_tp2"), tp=2)},
        {"kind": "decode", "name": "decode_bf16", "state_dict": decode_sd, "dtype": torch.bfloat16,
         "cfg": _decode_cfg(str(manifest), str(root / "decode_bf16_tp2"), tp=2)},
        {"kind": "finetune", "name": "finetune_tp2", "cfg": _vallex_run_cfg(root, corpus, **{
            "train_config.output_dir": tp2_dir, "train_config.shard.tp": 2})},
        {"kind": "finetune", "name": "resume_fsdp2", "cfg": _vallex_run_cfg(root, corpus, **{
            "train_config.output_dir": root / "fsdp2", "train_config.shard.fsdp": 2,
            "train_config.resume_from": tp2_dir / "vallex_tts_epoch_2_step_4", "train_config.num_epochs": 0,
            "train_config.run_validation": False})},
    ], root / "two", script=Path(__file__))
    four = _Group(4, [{**vallex_job, "name": "vallex_fsdp2_tp2", "fsdp": 2}], root / "four", script=Path(__file__))

    refs = {"families": fams, "jax_families": _jax_family_outputs(fams), "one": one, "batches": batches}
    jv_cfg = dataclasses.replace(jv.VallexConfig.tiny_test(), n_heads=4, dtype=jnp.float32)
    jparams = trainable_to_flax(start)
    for fsdp in (1, 2):
        refs[f"vallex_jax_{fsdp}"] = _jax_trainer_steps(jv.VALLE(jv_cfg), jv_cfg, jparams, batches[0], batches,
                                                        one["trainer"].train_config, fsdp)
    refs["sec_jax"] = _jax_trainer_steps(JSLAMModel(sec["jcfg"]), sec["jcfg"], sec["params"], sec["batch"],
                                         [sec["batch"]] * STEPS, sec["tc"], 1)
    refs["families_bf16"] = {order: {kind: _family(kind, f["cfg"], f["state_dict"], f["inputs"], torch.bfloat16,
                                                   tp2_order=order == "tp2") for kind, f in fams.items()}
                             for order in ("own", "tp2")}
    refs["decode"] = {run: run_decode(_decode_cfg(str(manifest), str(root / f"decode_{run}_one")), decode_sd,
                                      torch.float32 if run == "f32" else torch.bfloat16, tp2_order=run == "bf16_tp2")
                      for run in ("f32", "bf16", "bf16_tp2")}
    yield {"root": root, "two": two, "four": four, "refs": refs, "tp2_dir": tp2_dir, "corpus": corpus}
    for group in (two, four):
        for p in group.procs:
            if p.poll() is None:
                p.kill()


# ---- the tests ------------------------------------------------------------------------


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _covers(pattern: str, name: str) -> bool:
    return fnmatch.fnmatchcase(name, pattern) or fnmatch.fnmatchcase(name, pattern + ".*")


@pytest.mark.parametrize("kind", FAMILIES)
def test_family_split_over_tp_matches_jax(runs, kind):
    """(a) tp=2, f32: the family's outputs meet the JAX module's on its
    (1, 1, 2) mesh within 1e-5 of their largest entry, and each split
    tensor holds half of its whole tensor along its split dim (a grouped
    dim: half of each group)."""
    from slam_llm_tpu_torch.parallel.tensor_parallel import Grouped

    got = runs["two"].result("families_f32")[kind]
    want = runs["refs"]["jax_families"][kind]
    for key, w in want.items():
        _close(got[key].numpy(), w)
    whole = {n: tuple(t.shape) for n, t in runs["refs"]["families"][kind]["state_dict"].items()}
    assert set(got["shapes"]) == set(whole)
    split = 0
    for name, shape in got["shapes"].items():
        dim = got["dims"][name]
        expect = list(whole[name])
        if dim is not None:
            d = dim.dim if isinstance(dim, Grouped) else dim
            expect[d] //= 2
            split += 1
        assert shape == tuple(expect), (name, shape, whole[name], dim)
    assert split > 0


@pytest.mark.parametrize("kind", FAMILIES)
def test_family_split_over_tp_in_bf16_equals_one_process_in_tp_order(runs, kind):
    """(b) tp=2, bf16: the family's outputs equal, bit for bit, the
    one-process module's whose row-parallel products are summed in the tp=2
    order (each rank's product rounded to bf16, the two summed in f32 and
    rounded once, as every row-parallel plain dense is reduced); against the
    one-process module in its own order they differ by the roundings that
    order moves: the gap (printed) under four bf16 roundings (2^-6) of the
    output's norm, where a wrong split moves it by about its size."""
    got = runs["two"].result("families_bf16")[kind]
    ref = runs["refs"]["families_bf16"]
    for key in [k for k in got if k in ("out", "ar", "nar")]:
        assert torch.equal(got[key], ref["tp2"][kind][key]), key
        own = ref["own"][kind][key].float()
        gap = float(torch.linalg.norm(got[key].float() - own)) / float(torch.linalg.norm(own))
        print(f"bf16 tp=2 vs one process in its own order, {kind} {key}: relative gap {gap:.3e}")
        assert gap <= 2.0 ** -6, (key, gap)


@pytest.mark.parametrize("kind", FAMILIES)
def test_what_tp_keeps_whole_carries_no_tp_axis_in_jax(runs, kind):
    """``split_for_tp`` splits exactly the tensors whose JAX parameters carry
    a ``heads`` / ``mlp`` / ``vocab`` axis (``nn.get_partition_spec`` of the
    tiny model), but MusicFM's depthwise conv and its BatchNorm (the port
    runs them on the rank's channels; the reference keeps them whole), and
    every tensor under a ``replicated_modules`` entry carries none."""
    fam = runs["refs"]["families"][kind]
    got = runs["two"].result("families_f32")[kind]
    assert fam["uniform"]  # every port tensor comes from one reference tensor
    for name, has_tp_axis in fam["tp_axis"].items():
        port_only = kind == "musicfm" and any(fnmatch.fnmatchcase(name, p) for p in PORT_ONLY_SPLITS)
        assert (got["dims"][name] is not None) == (has_tp_axis or port_only), (name, got["dims"][name])
    assert got["whole"]
    for pattern in got["whole"]:
        covered = [n for n in fam["tp_axis"] if _covers(pattern, n)]
        assert covered, pattern
        assert not any(fam["tp_axis"][n] or got["dims"][n] is not None for n in covered), pattern


def _leaves_of(tree):
    from test_torch_train import _leaves

    return {"/".join(k): v for k, v in _leaves(tree).items()}


def _assert_trainer_matches(got, want, skip=("k_proj/bias",)):
    """Loss, accuracy and gradient norm of every step within 1e-5 relative;
    every trainable tensor after the last within 1e-5 of its norm, but the
    key biases: their gradients are round-off on both sides (0 in exact
    arithmetic: the softmax cancels them), below AdamW's eps, so their
    updates normalise round-off."""
    from slam_llm_tpu_torch.utils.convert import trainable_to_flax

    metrics, trainable = want
    assert len(got["metrics"]) == len(metrics)
    for m, w in zip(got["metrics"], metrics):
        for key in ("loss", "acc", "grad_norm"):
            np.testing.assert_allclose(m[key], w[key], rtol=1e-5, atol=1e-7, err_msg=key)
    ours, theirs = _leaves_of(trainable_to_flax(got["trainable"])), _leaves_of(trainable)
    assert set(ours) == set(theirs)
    for path, w in theirs.items():
        if not path.endswith(skip):
            assert np.linalg.norm(ours[path] - w) <= 1e-5 * np.linalg.norm(w), path


@pytest.mark.parametrize("mesh", ["tp2", "fsdp2_tp2"])
def test_vallex_trainer_steps_over_tp_match_the_jax_trainer(runs, mesh):
    """(c) VALL-E X in f32 (every tensor trained), four steps of the batches
    the one-process finetune took, at tp=2 and fsdp=2 x tp=2: loss,
    accuracy, gradient norm and every tensor within 1e-5 of the JAX
    Trainer on its (1, 1, 2) / (1, 2, 2) mesh. The vocab-parallel NLL reads
    labels on both sides of the shard border (the 24-row audio vocabulary,
    12 rows a rank; the end-of-audio 16 on rank 1), and each rank holds half
    of every table, head, attention and MLP tensor."""
    got = runs["two" if mesh == "tp2" else "four"].result(f"vallex_{mesh}")
    _assert_trainer_matches(got, runs["refs"][f"vallex_jax_{1 if mesh == 'tp2' else 2}"])
    labels = np.concatenate([b["audio_ids"][:, 0][b["audio_mask"] > 0] for b in runs["refs"]["batches"]])
    assert (labels < 12).any() and (labels >= 12).any()
    shapes = got["shapes"]
    if mesh == "tp2":
        assert shapes["audio_embedding_0.weight"] == (12, 32) and shapes["ar_head.weight"] == (12, 32)
        assert shapes["nar_stage_embedding.weight"] == (2, 32) and shapes["text_embedding.weight"] == (16, 32)
        assert shapes["nar_decoder.layers.0.norm1.mod.weight"] == (32, 32)
        assert shapes["ar_decoder.layers.0.fc2.weight"] == (32, 64)


def test_sec_step_with_the_qformer_and_encoder_split_matches_the_jax_trainer(runs):
    """(d) the SEC-style recipe at tp=2 (emotion2vec-shaped encoder split
    and frozen, the Q-Former split and trained, the tiny LLM split): three
    steps against the JAX Trainer on its (1, 1, 2) mesh within 1e-5."""
    got = runs["two"].result("sec_tp2")
    _assert_trainer_matches(got, runs["refs"]["sec_jax"])
    assert set(got["trainable"]) and all(n.startswith("encoder_projector.") for n in got["trainable"])
    assert got["shapes"]["encoder_projector.block_0.cross_k_proj.weight"] == (16, 32)
    assert got["shapes"]["encoder.layers.0.fc2.weight"] == (32, 32)


def test_qformer_recipe_decode_at_tp2_equals_one_process_in_f32(runs):
    """(e) ``pipeline.inference_batch`` of a whisper + Q-Former recipe at
    tp=2 in f32 (the encoder, the Q-Former and the LLM split) writes the
    one-process ``_pred`` line for line."""
    got = runs["two"].result("decode_f32")
    want = runs["refs"]["decode"]["f32"]
    assert len(want["pred"]) == 4 and got["pred"] == want["pred"]


def test_qformer_recipe_decode_at_tp2_in_bf16_equals_one_process_in_tp_order(runs):
    """(e) the same decode in bf16 (the recipe's dtype): every greedy step's
    logits and the ``_pred`` lines equal, bit for bit, the one-process
    decode whose row-parallel products (whisper's, the Q-Former's, the
    LLM's) are summed in the tp=2 order. Against the one process in its
    own order, at every step whose history agrees, each logit lies within
    eight bf16 roundings (2^-5) of the step's largest (the gap, printed, is
    the order's: twelve row-parallel sums, two in each of the 2 + 2 + 2
    layers, each may move a rounding that the layers after amplify), and
    the tokens are equal except where the one-process top-2 margin is
    below twice that; a row that diverges there is compared no further."""
    got = runs["two"].result("decode_bf16")
    tp2, own = runs["refs"]["decode"]["bf16_tp2"], runs["refs"]["decode"]["bf16"]
    assert got["pred"] == tp2["pred"] and len(got["pred"]) == 4
    assert len(got["steps"]) == len(tp2["steps"]) == len(own["steps"]) == 2
    compared, worst = 0, 0.0
    for g_batch, t_batch, w_batch in zip(got["steps"], tp2["steps"], own["steps"]):
        assert len(g_batch) == len(t_batch) and all(torch.equal(g, t) for g, t in zip(g_batch, t_batch))
        live = torch.ones(w_batch[0].shape[0], dtype=torch.bool)
        for g, w in zip(g_batch, w_batch):
            scale = w.abs().amax(-1)
            rel = (g - w).abs().amax(-1) / scale
            worst = max(worst, float(rel[live].max()))
            assert bool((rel[live] <= 2.0 ** -5).all()), rel
            top2 = w.topk(2, dim=-1).values
            differ = g.argmax(-1) != w.argmax(-1)
            assert bool(((top2[:, 0] - top2[:, 1]) <= 2 * 2.0 ** -5 * scale)[differ & live].all())
            compared += int(live.sum())
            live &= ~differ
    print(f"bf16 decode, tp=2 vs one process in its own order: largest logit gap {worst:.3e} of the step's largest")
    assert compared >= 2 * 2 * MAX_NEW // 2


def test_vallex_finetune_at_tp2_writes_whole_tensors_and_resumes_at_tp1_and_fsdp2(runs):
    """(f) ``pipeline.finetune`` of VALL-E X (f32) at tp=2 trains as one
    process does (every step's loss within 1e-5; those losses are the JAX
    Trainer's at tp=2, test (c)); its ``model.pt`` holds every tensor whole;
    its full state resumed in one process is restored bit for bit, and at
    fsdp=2 gathered back bit for bit."""
    from slam_llm_tpu_torch.pipeline import finetune
    from slam_llm_tpu_torch.utils.checkpoint import load_state

    root, one = runs["root"], runs["refs"]["one"]
    two = runs["two"].result("finetune_tp2")
    assert len(two["steps"]) == len(one["steps"]) == 4
    jax_steps = runs["refs"]["vallex_jax_1"][0]
    assert len(jax_steps) == 4
    for a, b, w in zip(two["steps"], one["steps"], jax_steps):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        np.testing.assert_allclose(a["loss"], w["loss"], rtol=1e-5)
    ckpt = Path(two["checkpoints"][-1])
    assert ckpt == runs["tp2_dir"] / "vallex_tts_epoch_2_step_4"
    sd = torch.load(ckpt / "model.pt", weights_only=True)
    whole = {n: tuple(t.shape) for n, t in one["trainer"].model.state_dict().items()}
    assert {n: tuple(t.shape) for n, t in sd.items()} == whole
    full = load_state(str(ckpt))
    again = _vallex_run_cfg(root, runs["corpus"], **{
        "train_config.output_dir": root / "tp1", "train_config.num_epochs": 0,
        "train_config.resume_from": ckpt, "train_config.save_model": False})
    trainer = finetune.main(again, device="cpu")["trainer"]
    for name, p in trainer.trainable.items():
        assert torch.equal(p.detach(), full["trainable"][name]), name
    back = load_state(runs["two"].result("resume_fsdp2")["checkpoints"][-1])
    assert back["step"] == full["step"]
    for name, w in full["trainable"].items():
        assert torch.equal(back["trainable"][name], w), name
    for key in ("mu", "nu"):
        assert all(torch.equal(a, b) for a, b in zip(back["optimizer"][key], full["optimizer"][key]))


def _refusal_cases():
    """(family, config change, tp, the dimension named): a tp of 8 over 12
    heads (the Q-Former's, emotion2vec's), and heads, MLPs, an output width
    and VALL-E X's vocabularies that tp does not divide."""
    return [
        ("qformer", {"qformer_heads": 12, "qformer_dim": 96}, 8, "Q-Former's attention heads"),
        ("qformer", {"llm_dim": 36}, 8, "Q-Former's output width"),
        ("hubert", {"n_heads": 12, "d_model": 96, "ffn_dim": 64}, 8, "WavLMEncoder's attention heads"),
        ("wavlm", {"ffn_dim": 36}, 8, "WavLMEncoder's mlp"),
        ("beats", {"n_heads": 12, "d_model": 96}, 8, "BEATsEncoder's attention heads"),
        ("avhubert", {"ffn_dim": 36}, 8, "AVHubertEncoder's mlp"),
        ("eat", {"n_heads": 12, "d_model": 96}, 8, "ViT's attention heads"),
        ("spatial_ast", {"mlp_ratio": 1.125}, 8, "ViT's mlp"),
        ("musicfm", {}, 4, "MusicFM Conformer's attention heads"),
        ("musicfm", {"ffn_dim": 33}, 2, "MusicFM Conformer's ffn"),
        ("vallex", {}, 16, "VALL-E X's audio vocabulary"),
        ("vallex", {"text_vocab": 40, "audio_vocab": 24}, 16, "VALL-E X's text vocabulary"),
        ("vallex", {"audio_vocab": 24}, 16, "VALL-E X's stage vocabulary"),
    ]


@pytest.mark.parametrize("case", range(len(_refusal_cases())))
def test_a_tp_that_does_not_divide_a_family_raises(case):
    """(g) ``split_for_tp`` over a family whose split dimension tp does not
    divide raises ValueError naming it, before any tensor is touched."""
    from slam_llm_tpu_torch.models import avhubert, beats, musicfm, projector, spatial_ast, vallex, vit, wavlm
    from slam_llm_tpu_torch.parallel.tensor_parallel import TP, split_for_tp

    kind, change, size, what = _refusal_cases()[case]
    base = {"qformer": projector.ProjectorConfig(encoder_dim=32, llm_dim=48, query_len=4, qformer_layers=1,
                                                 qformer_dim=32, qformer_heads=8),
            "hubert": wavlm.WavLMConfig.tiny_test(rel_bias=False), "wavlm": dataclasses.replace(
                wavlm.WavLMConfig.tiny_test(), n_heads=8),
            "beats": beats.BEATsEncoderConfig.tiny_test(),
            "avhubert": dataclasses.replace(avhubert.AVHubertConfig.tiny_test(), n_heads=8),
            "eat": vit.ViTEncoderConfig.tiny_test(),
            "spatial_ast": dataclasses.replace(spatial_ast.SpatialASTConfig.tiny_test(), n_heads=8),
            "musicfm": musicfm.MusicFMConfig.tiny_test(),
            "vallex": dataclasses.replace(vallex.VallexConfig.tiny_test(), n_heads=16, d_model=64,
                                          text_vocab=64)}[kind]
    module = _port_module(kind, dataclasses.replace(base, **change))
    before = {n: t.clone() for n, t in module.state_dict().items()}
    with pytest.raises(ValueError, match=f"tp={size} does not divide the {what}"):
        split_for_tp(module, _MeshOf(TP(None, size, 0)))
    after = module.state_dict()
    assert set(after) == set(before) and all(torch.equal(after[n], t) for n, t in before.items())


if __name__ == "__main__":
    sys.path.insert(0, str(HERE))
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    _worker(sys.argv[1], sys.argv[2])
