"""Sharded serving: the decodes sharded over ``fsdp`` and the whisper encoder
and MLP projectors split over ``tp``, on the CPU with gloo.

Worker processes run this file as a script through
``test_torch_distributed``'s launcher (``_Group``: torchrun's environment,
``PROC_TIMEOUT`` a worker, ``DIST_TIMEOUT`` a collective, so a hang fails
instead of blocking), each running the jobs of its payload; rank 0 writes
each job's result. Two groups run side by side while this process computes
the references:

* two ranks: ``pipeline.inference_batch`` at fsdp=2, greedy and beam 4, on
  a tiny f32 model whose head makes one rank's rows end at the first token
  while the other rank's run to ``max_new_tokens`` (greedy); ``pipeline.generate_s2s``
  batch mode at fsdp=2 over three questions (one rank decodes a wrapped
  one unwritten); the whisper encoder and both MLP projectors split at tp=2
  (f32, and bf16 against the one-process modules in either summation order);
  the ASR LoRA step with the projector trained at tp=2; ``pipeline.finetune``
  at tp=2 (``model.pt``) and its state resumed at fsdp=2;
* four ranks: ``pipeline.inference_batch`` at fsdp=2 x tp=2, greedy and
  beam 4.

The references: the one-process port, the JAX ``Generator`` on the same f32
weights, the JAX whisper encoder and projectors on their own (1, 1, 2)
mesh, the JAX ``Trainer`` on its (1, 1, 2) mesh.
"""

import dataclasses
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
VOCAB = 264  # the byte tokenizer's 259 ids (EOS 257 among them), padded so tp=2 divides it
MAX_NEW = 6
EOS = 257
MARGIN = 8.0  # the planted EOS logit's distance from the other logits at the first token


# ---- the worker side (no JAX) ------------------------------------------------------


def _port_slam_cfg():
    """The port's tiny f32 ASR model (test_torch_train's at vocabulary VOCAB)."""
    from slam_llm_tpu_torch.models import llm as tllm
    from slam_llm_tpu_torch.models import projector as tproj
    from slam_llm_tpu_torch.models import slam_model as tslam
    from slam_llm_tpu_torch.models import whisper as twhisper

    f32 = torch.float32
    llm = dataclasses.replace(tllm.LLMConfig.tiny_test(VOCAB), lora_rank=4, lora_dropout=0.0, dtype=f32)
    enc = dataclasses.replace(twhisper.WhisperEncoderConfig.tiny_test(), dtype=f32)
    proj = tproj.ProjectorConfig(encoder_dim=enc.d_model, llm_dim=llm.d_model, ds_rate=5, hidden_dim=32, dtype=f32)
    return tslam.SLAMConfig(llm=llm, encoder_name="whisper", encoder=enc, projector="linear", projector_cfg=proj)


def _decode_cfg(manifest: str, log: str, num_beams: int, **shard):
    from slam_llm_tpu_torch.config import RunConfig, set_by_path

    cfg = RunConfig()
    for key, value in {"model_config.llm_name": "tiny-test", "model_config.encoder_name": "whisper",
                       "model_config.encoder_config": "whisper-tiny-test", "model_config.encoder_projector": "linear",
                       "model_config.encoder_projector_ds_rate": 5, "dataset_config.val_data_path": manifest,
                       "dataset_config.mel_size": 8, "dataset_config.input_type": "mel",
                       "train_config.val_batch_size": 2, "train_config.shard.dp": -1,
                       "decode_config.max_new_tokens": MAX_NEW, "decode_config.num_beams": num_beams,
                       "decode_config.decode_log": log,
                       **{f"train_config.shard.{k}": v for k, v in shard.items()}}.items():
        set_by_path(cfg, key, value)
    return cfg


def run_decode(cfg, state_dict):
    """``pipeline.inference_batch.main`` on the tiny f32 model holding
    ``state_dict`` (its seeded init replaced)."""
    from slam_llm_tpu_torch.models import slam_model as tslam
    from slam_llm_tpu_torch.pipeline import inference_batch

    from test_torch_tp_families import with_weights

    build = tslam.build_slam_config
    tslam.build_slam_config = lambda train_config, model_config: _port_slam_cfg()
    try:
        return inference_batch.main(with_weights(cfg, state_dict), device="cpu")
    finally:
        tslam.build_slam_config = build


def _unit_watch():
    """Forward pre-hooks recording, whenever a layer unit (an FSDP2 module
    other than the root) runs, how many OTHER layer units hold gathered
    parameters, and any parameter a module computes with that is a DTensor
    or not contiguous. Returns the record and a ``Generator`` subclass that
    installs the hooks on the model it binds."""
    from torch.distributed.fsdp import FSDPModule
    from torch.distributed.tensor import DTensor

    from slam_llm_tpu_torch.pipeline import inference_batch

    seen = {"max_other_gathered": 0, "unit_calls": 0, "bad": set(), "checked": 0}
    generator_cls = inference_batch.Generator

    def install(model):
        units = [m for m in model.modules() if isinstance(m, FSDPModule) and m is not model]

        def gathered(unit):
            return not any(isinstance(p, DTensor) for p in unit.parameters())

        def unit_hook(mod, args):
            seen["unit_calls"] += 1
            seen["max_other_gathered"] = max(seen["max_other_gathered"],
                                             sum(gathered(u) for u in units if u is not mod))

        def param_hook(mod, args):
            for name, p in mod.named_parameters(recurse=False):
                seen["checked"] += 1
                if isinstance(p, DTensor) or not p.is_contiguous():
                    seen["bad"].add(f"{type(mod).__name__}.{name}")

        for u in units:
            u.register_forward_pre_hook(unit_hook)
        for mod in model.modules():
            if any(True for _ in mod.parameters(recurse=False)):
                mod.register_forward_pre_hook(param_hook)
        seen["units"] = len(units)

    class Watched(generator_cls):
        def __init__(self, model, *args, **kwargs):
            install(model)
            super().__init__(model, *args, **kwargs)

    return seen, Watched


def _decode_job(job):
    import torch.distributed as dist

    from slam_llm_tpu_torch.pipeline import inference_batch

    seen, watched = _unit_watch()
    saved = inference_batch.Generator
    inference_batch.Generator = watched
    try:
        res = run_decode(job["cfg"], job["state_dict"])
    finally:
        inference_batch.Generator = saved
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, {"decode_steps": res["decode_steps"], "useful_steps": res["useful_steps"],
                                   "pred": res["pred"], "watch": {**seen, "bad": sorted(seen["bad"])}})
    return {"ranks": ranks}


def _generate_job(job):
    import torch.distributed as dist
    from test_torch_s2s_tp import f32_recipe

    from slam_llm_tpu_torch.pipeline import generate_s2s

    with f32_recipe():
        res = generate_s2s.main(job["cfg"], device="cpu")
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, {"n": res["n"], "pred": res["pred"],
                                   "steps": [(u["decode_steps"], u["useful_steps"]) for u in res["utterances"]]})
    return {"ranks": ranks}


def _units(tp, encoder_sd, projector_sds, inputs, dtype=torch.float32, tp2_order=False):
    """The whisper encoder and both MLP projectors (``dtype``) on this
    rank's shards: outputs and the local shapes of their split tensors.
    ``tp2_order`` (one process): their row products summed in a tp=2 run's
    order (``test_torch_tensor_parallel.sum_in_tp2_order``)."""
    from test_torch_tensor_parallel import sum_in_tp2_order

    from slam_llm_tpu_torch.models import projector as tproj
    from slam_llm_tpu_torch.models import whisper as twhisper
    from slam_llm_tpu_torch.parallel.tensor_parallel import split_projector, split_whisper

    enc = twhisper.WhisperEncoder(dataclasses.replace(twhisper.WhisperEncoderConfig.tiny_test(), dtype=dtype))
    enc.load_state_dict(encoder_sd)
    if tp is not None:
        split_whisper(enc, tp)
    if tp2_order:
        sum_in_tp2_order(enc)
    mel, mask = (torch.from_numpy(a) for a in inputs["mel"])
    out = {"encoder": enc(mel, mask)[0].detach(),
           "encoder_shapes": {n: tuple(p.shape) for n, p in enc.state_dict().items()},
           "encoder_heads": [layer.attn.n_heads for layer in enc.layers]}
    for kind, sd in projector_sds.items():
        cfg = tproj.ProjectorConfig(encoder_dim=32, llm_dim=64, ds_rate=5, hidden_dim=48, dtype=dtype)
        proj = tproj.build_projector(kind, cfg)
        proj.load_state_dict(sd)
        if tp is not None:
            split_projector(proj, tp)
        if tp2_order:
            sum_in_tp2_order(proj)
        out[kind] = proj(torch.from_numpy(inputs["features"])).detach()
        out[f"{kind}_shapes"] = {n: tuple(p.shape) for n, p in proj.state_dict().items()}
    return out


def _worker(payload: str, out_dir: str) -> None:
    import torch.distributed as dist
    from test_torch_distributed import DIST_TIMEOUT, _finetune_job
    from test_torch_tensor_parallel import _trainer_steps

    from slam_llm_tpu_torch.parallel.sharding import make_mesh
    from slam_llm_tpu_torch.parallel.tensor_parallel import tp_of
    from slam_llm_tpu_torch.pipeline.common import maybe_init_distributed

    torch.set_num_threads(1)
    assert maybe_init_distributed("cpu", timeout=DIST_TIMEOUT)

    def trainer(job):
        mesh = make_mesh(dp=1, fsdp=1, tp=2, device_type="cpu")
        return _trainer_steps(job["tcfg"], job["state_dict"], job["tc"], job["batch"], mesh)

    def units(job):
        return _units(tp_of(make_mesh(dp=1, fsdp=1, tp=2, device_type="cpu")), job["encoder"], job["projectors"],
                      job["inputs"], job.get("dtype", torch.float32))

    jobs = {"decode": _decode_job, "generate": _generate_job, "units": units, "trainer": trainer,
            "finetune": _finetune_job}
    for job in torch.load(payload, weights_only=False):
        result = jobs[job["kind"]](job)
        if dist.get_rank() == 0:
            torch.save(result, Path(out_dir) / f"{job['name']}.pt")
    dist.destroy_process_group()


# ---- the references ------------------------------------------------------------------


def _jax_weights(manifest: Path, root: Path):
    """(JAX SLAMConfig, JAX params, port state dict) of the tiny f32 model
    (test_torch_train's, LoRA B nonzero) at vocabulary VOCAB, its head's EOS
    row changed so that the greedy decode of utterances 0 and 1 (data rank
    0's batch at fsdp=2) ends at the first token (EOS MARGIN above every
    other logit) and that of 2 and 3 (rank 1's) never emits EOS (MARGIN
    below the best other token at each of its positions): the least-norm
    change of that row meeting those targets, solved again on the new
    trajectory until the decode does so."""
    from test_torch_train import _jax_cfg, _params, _port_model

    from slam_llm_tpu_torch.inference.generate import GenerationConfig, Generator, _last_valid_index
    from slam_llm_tpu_torch.pipeline.common import build_model_and_data
    from slam_llm_tpu_torch.pipeline.inference_batch import decode_loader

    jcfg = _jax_cfg()
    jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm, vocab_size=VOCAB))
    params = _params(jcfg)
    cfg = _decode_cfg(str(manifest), str(root / "unused"), 1)
    cfg.dataset_config.inference_mode = True
    _, tok, dataset = build_model_and_data(cfg, split="test", device="cpu")
    batches = [{k: v for k, v in b.items() if isinstance(v, np.ndarray)} for b in decode_loader(cfg, dataset)]
    assert [len(b["input_ids"]) for b in batches] == [2, 2]
    gen_cfg = GenerationConfig(max_new_tokens=MAX_NEW, num_beams=1, eos_token_id=EOS, pad_token_id=tok.pad_token_id)
    for _ in range(4):
        _, tm = _port_model(jcfg, params)
        head, seen = tm.llm._head, []
        tm.llm._head = lambda x: seen.append(x.detach().double()) or head(x)
        tokens = []
        for batch in batches:
            seen.clear()
            tokens.append(Generator(tm, gen_cfg).generate(batch))
            last = _last_valid_index(torch.as_tensor(batch["attention_mask"]))
            steps = [seen[0][torch.arange(2), last]] + [x[:, 0] for x in seen[1:]]
            h = steps[0] if batch is batches[0] else torch.cat([h, *steps])
        if (tokens[0][:, 0] == EOS).all() and not (tokens[1] == EOS).any() and (tokens[1] != tok.pad_token_id).all():
            break
        kernel = np.array(params["llm"]["lm_head"]["kernel"])  # (d, V)
        lg = h @ torch.from_numpy(kernel.astype(np.float64))
        best_other = torch.cat([lg[:, :EOS], lg[:, EOS + 1:]], dim=1).amax(1)
        target = torch.cat([best_other[:2] + MARGIN, best_other[2:] - MARGIN])
        w = torch.from_numpy(kernel[:, EOS].astype(np.float64))
        kernel[:, EOS] = (w + torch.linalg.pinv(h) @ (target - h @ w)).float().numpy()
        params["llm"]["lm_head"]["kernel"] = kernel
    else:
        raise AssertionError(f"no EOS row makes rank 0's rows end first and rank 1's run on: {tokens}")
    return jcfg, params, tm.state_dict()


def _jax_texts(jcfg, params, manifest: Path, root: Path, num_beams: int):
    """The JAX ``Generator``'s decode of the manifest (the port's batches of
    two), as the port's ``_pred`` lines."""
    import jax.numpy as jnp

    from slam_llm_tpu.inference.generate import GenerationConfig as JGenerationConfig
    from slam_llm_tpu.inference.generate import Generator as JGenerator
    from slam_llm_tpu.models.slam_model import SLAMModel as JSLAMModel
    from slam_llm_tpu_torch.inference.generate import strip_after_eos
    from slam_llm_tpu_torch.pipeline.common import build_model_and_data
    from slam_llm_tpu_torch.pipeline.inference_batch import decode_loader

    cfg = _decode_cfg(str(manifest), str(root / "unused"), num_beams)
    cfg.dataset_config.inference_mode = True
    _, tok, dataset = build_model_and_data(cfg, split="test", device="cpu")
    gen = JGenerator(JSLAMModel(jcfg), JGenerationConfig(max_new_tokens=MAX_NEW, num_beams=num_beams,
                                                          eos_token_id=EOS, pad_token_id=tok.pad_token_id,
                                                          bos_token_id=tok.bos_token_id))
    lines = []
    for batch in decode_loader(cfg, dataset):
        jb = {k: jnp.asarray(v) for k, v in batch.items() if isinstance(v, np.ndarray) and k != "labels"}
        tokens = strip_after_eos(np.asarray(gen.generate({"params": params}, jb)), EOS, tok.pad_token_id)
        lines += [f"{key}\t{tok.decode(row)}" for key, row in zip(batch["keys"], tokens)]
    return lines


def _jax_units(inputs):
    """The JAX whisper encoder and both MLP projectors (f32) on a (1, 1, 2)
    mesh, their params laid out by the logical rules: outputs and the port
    state dicts of the same params."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    from slam_llm_tpu.models import projector as jproj
    from slam_llm_tpu.models import whisper as jwhisper
    from slam_llm_tpu.parallel import make_mesh
    from slam_llm_tpu.parallel.sharding import logical_to_sharding
    from slam_llm_tpu_torch.utils.convert import encoder_from_flax, flax_to_state_dict

    mesh = make_mesh(dp=1, fsdp=1, tp=2, devices=jax.devices()[:2])

    def run(module, args, seed):
        boxed = module.init(jax.random.PRNGKey(seed), *args)
        shardings = logical_to_sharding(mesh, nn.get_partition_spec(boxed["params"]))
        unboxed = nn.meta.unbox(boxed["params"])
        # nonzero biases, so a bias added twice (or split wrongly) shows
        rng = np.random.default_rng(seed)
        unboxed = jax.tree_util.tree_map_with_path(
            lambda p, v: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
            if str(getattr(p[-1], "key", "")) == "bias" else np.asarray(v), unboxed)
        with mesh:
            out = jax.jit(lambda p, *a: module.apply({"params": p}, *a))(jax.device_put(unboxed, shardings), *args)
        return out, unboxed

    enc_cfg = dataclasses.replace(jwhisper.WhisperEncoderConfig.tiny_test(), dtype=jnp.float32)
    mel, mask = (jnp.asarray(a) for a in inputs["mel"])
    (enc_out, _), enc_params = run(jwhisper.WhisperEncoder(enc_cfg), (mel, mask), 0)
    out = {"encoder": np.asarray(enc_out), "encoder_sd": encoder_from_flax(enc_params, "whisper"), "projectors": {}}
    cfg = jproj.ProjectorConfig(encoder_dim=32, llm_dim=64, ds_rate=5, hidden_dim=48, dtype=jnp.float32)
    for kind, cls in (("linear", jproj.ProjectorConcat), ("cov1d-linear", jproj.ProjectorConv1d)):
        y, p = run(cls(cfg), (jnp.asarray(inputs["features"]),), 1)
        out[kind] = np.asarray(y)
        out["projectors"][kind] = flax_to_state_dict(p)
    return out


def _unit_inputs():
    rng = np.random.default_rng(5)
    mask = np.ones((2, 64), np.int32)
    mask[1, 40:] = 0
    return {"mel": (rng.standard_normal((2, 64, 8)).astype(np.float32), mask),
            "features": rng.standard_normal((2, 23, 32)).astype(np.float32)}


def _asr_corpus(root: Path) -> Path:
    from helpers import make_corpus

    (root / "asr").mkdir(parents=True, exist_ok=True)
    return make_corpus(root / "asr", n=4, targets=["hello world", "good day", "fine thanks", "so long"])


def _s2s_questions(root: Path) -> Path:
    """test_torch_s2s_tp's corpus, its first three questions."""
    from test_torch_s2s_tp import _corpus

    (root / "s2s").mkdir(parents=True, exist_ok=True)
    manifest = _corpus(root / "s2s")
    manifest.write_text("".join(manifest.read_text().splitlines(keepends=True)[:3]))
    return manifest


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from test_torch_distributed import _global_batch, _Group, _jax_steps, _train_config
    from test_torch_s2s_tp import _gen_cfg, f32_recipe
    from test_torch_tensor_parallel import _configs, _run_cfg

    from slam_llm_tpu_torch.pipeline import generate_s2s

    root = tmp_path_factory.mktemp("sharded_serving")
    manifest = _asr_corpus(root)
    questions = _s2s_questions(root)
    jcfg, params, sd = _jax_weights(manifest, root)
    inputs = _unit_inputs()
    junits = _jax_units(inputs)
    lora_j, lora_t, lora_params, lora_sd = _configs()
    tp2_dir = root / "tp2"

    def decode_job(name, num_beams, **shard):
        return {"kind": "decode", "name": name, "state_dict": sd,
                "cfg": _decode_cfg(str(manifest), str(root / name), num_beams, **shard)}

    def gen_cfg(name, fsdp=1):
        cfg = _gen_cfg(str(questions), str(root / name))
        cfg.train_config.shard.fsdp = fsdp
        return cfg

    two = _Group(2, [
        decode_job("greedy_fsdp2", 1, fsdp=2),
        decode_job("beam_fsdp2", 4, fsdp=2),
        {"kind": "generate", "name": "s2s_fsdp2", "cfg": gen_cfg("s2s_fsdp2", fsdp=2)},
        {"kind": "units", "name": "units", "encoder": junits["encoder_sd"], "projectors": junits["projectors"],
         "inputs": inputs},
        {"kind": "units", "name": "units_bf16", "encoder": junits["encoder_sd"], "projectors": junits["projectors"],
         "inputs": inputs, "dtype": torch.bfloat16},
        {"kind": "trainer", "name": "lora", "tcfg": lora_t, "state_dict": lora_sd, "tc": _train_config(),
         "batch": _global_batch()},
        {"kind": "finetune", "name": "finetune_tp2", "cfg": _run_cfg(root, **{
            "train_config.output_dir": str(tp2_dir), "train_config.shard.tp": 2})},
        {"kind": "finetune", "name": "resume_fsdp2", "cfg": _run_cfg(root, **{
            "train_config.output_dir": str(root / "fsdp2"), "train_config.shard.fsdp": 2,
            "train_config.resume_from": str(tp2_dir / "tiny_asr_epoch_1_step_2"), "train_config.num_epochs": 0,
            "train_config.run_validation": False})},
    ], root / "two", script=Path(__file__))
    four = _Group(4, [decode_job("greedy_fsdp2_tp2", 1, fsdp=2, tp=2), decode_job("beam_fsdp2_tp2", 4, fsdp=2, tp=2)],
                  root / "four", script=Path(__file__))
    torch.set_num_threads(2)
    refs = {f"{kind}_one": run_decode(_decode_cfg(str(manifest), str(root / f"{kind}_one"), beams), sd)
            for kind, beams in (("greedy", 1), ("beam", 4))}
    refs.update({f"{kind}_jax": _jax_texts(jcfg, params, manifest, root, beams)
                 for kind, beams in (("greedy", 1), ("beam", 4))})
    with f32_recipe():
        refs["s2s_one"] = generate_s2s.main(gen_cfg("s2s_one"), device="cpu")
    refs["lora"] = _jax_steps(lora_j, lora_params, 1, 1, tp=2)
    refs["units"] = junits
    refs["units_bf16"] = {order: _units(None, junits["encoder_sd"], junits["projectors"], inputs, torch.bfloat16,
                                        tp2_order=order == "tp2") for order in ("own", "tp2")}
    yield {"root": root, "two": two, "four": four, "refs": refs, "tp2_dir": tp2_dir}
    for group in (two, four):
        for p in group.procs:
            if p.poll() is None:
                p.kill()


# ---- the tests ------------------------------------------------------------------------


def _lines(path) -> list:
    return Path(path).read_text().splitlines()


@pytest.mark.parametrize("mesh", ["fsdp2", "fsdp2_tp2"])
@pytest.mark.parametrize("kind", ["greedy", "beam"])
def test_sharded_decode_rank_logs_equal_one_process_and_jax(runs, kind, mesh):
    """inference_batch at fsdp=2 (two ranks) and fsdp=2 x tp=2 (four):
    the data ranks' ``_pred_rank{r}`` logs, merged by key, equal the
    one-process port's ``_pred`` line for line, whose tokens are the JAX
    Generator's (f32). The ranks stepped in lockstep, as many steps as the
    later of their own last useful steps (greedy: rank 0's rows ended at
    the first token, rank 1's ran to max_new_tokens), every layer unit ran
    with no other layer unit gathered (no rank held a whole replica), and every module computed
    with plain, contiguous parameters, never a DTensor."""
    group = runs["two"] if mesh == "fsdp2" else runs["four"]
    got = group.result(f"{kind}_{mesh}")["ranks"]
    one = runs["refs"][f"{kind}_one"]
    want = _lines(one["pred"])
    assert len(want) == 4 and want == runs["refs"][f"{kind}_jax"]
    tp = 2 if mesh == "fsdp2_tp2" else 1
    writers = got[::tp]  # tp rank 0 of each data rank writes
    merged = {}
    for r, rank in enumerate(writers):
        assert rank["pred"].endswith(f"_pred_rank{r}")
        merged.update(line.split("\t", 1) for line in _lines(rank["pred"]))
    assert [f"{k}\t{merged[k]}" for k in (line.split("\t", 1)[0] for line in want)] == want
    steps = {rank["decode_steps"] for rank in got}
    assert len(steps) == 1  # lockstep
    useful = [rank["useful_steps"] for rank in writers]
    assert max(useful) == steps.pop()
    if kind == "greedy":
        assert useful == [0, MAX_NEW - 1]
        assert all(line.split("\t", 1)[1] == "" for line in want[:2])
    for rank in got:
        watch = rank["watch"]
        assert watch["units"] == 2 + 2 and watch["unit_calls"] > 0  # 2 decoder layers + 2 encoder blocks
        assert watch["max_other_gathered"] == 0
        assert watch["checked"] > 0 and watch["bad"] == []


def test_sharded_generate_s2s_equals_one_process(runs):
    """generate_s2s batch mode at fsdp=2 over three questions: rank 0
    writes q0 and q2, rank 1 q1 (and decodes q0 again, unwritten, so both
    run two decodes); the rank logs merged equal the one-process ``_pred``,
    and each utterance's audio tokens (its decode steps) are the one
    process's."""
    from test_torch_s2s_tp import _entries

    root, one = runs["root"], runs["refs"]["s2s_one"]
    got = runs["two"].result("s2s_fsdp2")["ranks"]
    assert [rank["n"] for rank in got] == [2, 1] and one["n"] == 3
    want = _entries(Path(one["pred"]))
    ranks = [_entries(Path(f"{root}/s2s_fsdp2_pred_rank{r}")) for r in (0, 1)]
    assert list(ranks[0]) == ["q0", "q2"] and list(ranks[1]) == ["q1"]
    assert {**ranks[0], **ranks[1]} == want
    mine = dict(zip(["q0", "q2"], got[0]["steps"])) | dict(zip(["q1"], got[1]["steps"]))
    for u in one["utterances"]:
        steps, useful = mine[u["key"]]
        assert useful == u["decode_steps"] and steps >= useful


def test_whisper_and_projectors_split_over_tp_match_jax(runs):
    """tp=2: each rank holds half of whisper's q / k / v / out / fc1 / fc2
    (q / k / v / fc1 and their biases on their outputs, out / fc2 on their
    inputs, their biases whole) at one head of two, and half of each
    projector's linear1 / linear2 (the conv1d whole); the encoder's and the
    projectors' outputs meet the JAX modules on their (1, 1, 2) mesh within
    1e-5 (f32)."""
    got, want = runs["two"].result("units"), runs["refs"]["units"]
    np.testing.assert_allclose(got["encoder"].numpy(), want["encoder"], rtol=1e-5, atol=1e-5)
    assert got["encoder_heads"] == [1, 1]
    whole = {n: tuple(t.shape) for n, t in want["encoder_sd"].items()}
    for name, shape in got["encoder_shapes"].items():
        leaf = name.rsplit(".", 2)
        dense = leaf[-2]
        dim = ({"q_proj": 0, "k_proj": 0, "v_proj": 0, "fc1": 0}.get(dense) if leaf[-1] in ("weight", "bias")
               else None)
        if dense in ("out_proj", "fc2") and leaf[-1] == "weight":
            dim = 1
        expect = list(whole[name])
        if dim is not None:
            expect[dim] //= 2
        assert shape == tuple(expect), (name, shape, whole[name])
    for kind in ("linear", "cov1d-linear"):
        np.testing.assert_allclose(got[kind].numpy(), want[kind], rtol=1e-5, atol=1e-5)
        shapes = got[f"{kind}_shapes"]
        assert shapes["linear1.weight"] == (24, want["projectors"][kind]["linear1.weight"].shape[1])
        assert shapes["linear1.bias"] == (24,) and shapes["linear2.weight"] == (64, 24)
        assert shapes["linear2.bias"] == (64,)
        if kind == "cov1d-linear":
            assert shapes["conv1d.weight"] == (32, 32, 5)


def test_whisper_and_projectors_split_over_tp_in_bf16_differ_from_one_process_in_order_only(runs):
    """tp=2 in bf16: the encoder's and the projectors' outputs equal the
    one-process modules' bit for bit where those sum their row products in
    the tp=2 order (each rank's product rounded to bf16, the two summed in
    f32 and rounded once, as the LLM's plain row denses are reduced), and
    differ from the one-process modules in their own order by the rounding
    that order moves: under four bf16 roundings (2^-6) of the output's norm,
    where a wrong split or a bias added twice moves it by about its size."""
    got, want = runs["two"].result("units_bf16"), runs["refs"]["units_bf16"]
    for key in ("encoder", "linear", "cov1d-linear"):
        assert got[key].dtype == torch.bfloat16
        assert torch.equal(got[key], want["tp2"][key]), key
        diff = float(torch.linalg.norm(got[key].float() - want["own"][key].float()))
        assert diff <= 2.0 ** -6 * float(torch.linalg.norm(want["own"][key].float())), key


def test_tp2_asr_lora_step_with_the_projector_split_matches_the_jax_trainer(runs):
    """tp=2, LoRA with the projector trained, f32, the whisper encoder and
    the projector split: three steps against the JAX Trainer on its
    (1, 1, 2) mesh within 1e-5 (loss, grad norm, every trainable tensor)."""
    from test_torch_distributed import _assert_matches_jax

    got = runs["two"].result("lora")
    _assert_matches_jax(got, runs["refs"]["lora"])
    # test_torch_train's projector: 5 x 32 -> 32 -> 64, half of the hidden width a rank
    assert got["shapes"]["encoder_projector.linear1.weight"] == (16, 160)
    assert got["shapes"]["encoder_projector.linear2.weight"] == (64, 16)
    assert got["shapes"]["encoder.layers.0.fc2.weight"] == (32, 64)


def test_tp2_checkpoint_holds_whole_projector_tensors_and_resumes_at_tp1_and_fsdp2(runs):
    """pipeline.finetune at tp=2 with the projector split: ``model.pt`` holds
    the whole projector tensors (linear1 / linear2 at their full shapes);
    its whole state resumed in one process is restored bit for bit, and at
    fsdp=2 gathered back bit for bit."""
    from test_torch_tensor_parallel import _run_cfg

    from slam_llm_tpu_torch.pipeline import finetune
    from slam_llm_tpu_torch.utils.checkpoint import load_state

    root = runs["root"]
    two = runs["two"].result("finetune_tp2")
    ckpt = Path(two["checkpoints"][-1])
    sd = torch.load(ckpt / "model.pt", weights_only=True)
    assert sd["encoder_projector.linear1.weight"].shape == (2048, 160)  # the recipe's hidden width 2048
    assert sd["encoder_projector.linear1.bias"].shape == (2048,)
    assert sd["encoder_projector.linear2.weight"].shape == (64, 2048)
    full = load_state(str(ckpt))
    again = _run_cfg(root, **{"train_config.output_dir": str(root / "tp1"), "train_config.num_epochs": 0,
                              "train_config.resume_from": str(ckpt), "train_config.save_model": False})
    trainer = finetune.main(again, device="cpu")["trainer"]
    for name, p in trainer.trainable.items():
        assert torch.equal(p.detach(), full["trainable"][name]), name
    back = load_state(runs["two"].result("resume_fsdp2")["checkpoints"][-1])
    assert back["step"] == full["step"]
    for name, w in full["trainable"].items():
        assert torch.equal(back["trainable"][name], w), name
    for key in ("mu", "nu"):
        assert all(torch.equal(a, b) for a, b in zip(back["optimizer"][key], full["optimizer"][key]))


@pytest.mark.parametrize("heads,d_model,what", [(3, 24, "whisper encoder's attention heads"),
                                                (2, 30, "projector's hidden width")])
def test_a_tp_that_does_not_divide_whisper_or_the_projector_raises(heads, d_model, what):
    """tp=2 over a whisper encoder of 3 heads, or a projector whose hidden
    width is odd, raises ValueError naming it before any tensor is split
    (``split_for_tp`` checks every module first)."""
    from slam_llm_tpu_torch.models import slam_model as tslam
    from slam_llm_tpu_torch.models import whisper as twhisper
    from slam_llm_tpu_torch.parallel.tensor_parallel import split_for_tp

    cfg = _port_slam_cfg()
    enc = dataclasses.replace(twhisper.WhisperEncoderConfig.tiny_test(), n_heads=heads, d_model=d_model)
    proj = dataclasses.replace(cfg.projector_cfg, encoder_dim=d_model, hidden_dim=31 if d_model == 30 else 32)
    model = tslam.SLAMModel(dataclasses.replace(cfg, encoder=enc, projector_cfg=proj))
    before = {n: p.shape for n, p in model.state_dict().items()}

    class Mesh:  # a tp axis of two, without a process group (the check raises first)
        def __getitem__(self, axis):
            return type("Axis", (), {"size": lambda s: 2, "get_group": lambda s: None,
                                     "get_local_rank": lambda s: 0})()

    with pytest.raises(ValueError, match=f"does not divide the {what}"):
        split_for_tp(model, Mesh())
    assert {n: p.shape for n, p in model.state_dict().items()} == before


if __name__ == "__main__":
    sys.path.insert(0, str(HERE))
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    _worker(sys.argv[1], sys.argv[2])
