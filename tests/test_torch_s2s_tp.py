"""S2S (SLAM-Omni) under tensor parallelism (``shard.tp``), on the CPU with gloo.

Worker processes run this file as a script through
``test_torch_distributed``'s launcher (``_Group``), each running the jobs
of its payload; rank 0 writes each job's result. Two groups run side by
side while this process computes the references:

* two ranks: tp=2 trainer steps of the tiny S2S model in f32 (group decode
  against the JAX ``Trainer`` on its (1, 1, 2) mesh; the TTS adapter and
  ``train_audio_embed_only`` against the one-process port), each step's
  largest gathered tensor, the whole state; the windowed CE alone (a tie
  across the shard border, labels at both window edges); greedy decoding
  and ``return_logits`` of each head variant; ``generate_s2s``
  batch at tp=2 and at two data ranks, and one online round at tp=2;
* four ranks: fsdp=2 x tp=2, group decode against the same JAX reference,
  and the TTS adapter against one process.

The tiny vocabulary puts the traps of the full one in place: the head (72
text + 40 audio = 112 rows) splits 56 / 56, so the text / audio boundary
lies inside rank 1's rows; the group-decode adapter's 3 x 40 = 120 outputs
split 60 / 60, so codebook 1 straddles the ranks.
"""

import contextlib
import dataclasses
import functools
import io
import json
import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
STEPS = 3
CHUNK = 16  # the CE chunk of T: every loss gathers (B, 16, vocabulary) at a time
ROWS = (0, 1, 2, 3)
NEW_TOKENS = 12
ONLINE = ["t:hello there", ""]


class FoldedTokenizer:
    """The byte tokenizer folded into the tiny 64-entry text vocabulary (as
    ``test_torch_s2s``'s), built without JAX for the workers."""

    def __new__(cls):
        from slam_llm_tpu_torch.data.tokenizer import ByteTokenizer

        class _Tok(ByteTokenizer):
            def encode(self, text, add_bos=True):
                return [3 + b % 57 for b in text.encode("utf-8")]

        return _Tok()


@contextlib.contextmanager
def stdin_lines(lines):
    """``sys.stdin`` reading ``lines`` (unchanged for None)."""
    saved = sys.stdin
    if lines is not None:
        sys.stdin = io.StringIO("".join(line + "\n" for line in lines))
    try:
        yield
    finally:
        sys.stdin = saved


@contextlib.contextmanager
def f32_recipe():
    """The recipe factory's tiny presets in f32 with the folded tokenizer,
    so the decoded tokens of two meshes can be compared exactly."""
    from slam_llm_tpu_torch.data import tokenizer as ttok
    from slam_llm_tpu_torch.models import llm as tllm
    from slam_llm_tpu_torch.models import projector as tproj
    from slam_llm_tpu_torch.models import s2s as ts2s
    from slam_llm_tpu_torch.models import whisper as twhisper

    saved = (tllm.LLMConfig.tiny_test, twhisper.PRESETS["whisper-tiny-test"], ts2s.ProjectorConfig,
             ttok.load_tokenizer)
    small = tllm.LLMConfig.tiny_test
    tllm.LLMConfig.tiny_test = staticmethod(lambda: dataclasses.replace(small(), dtype=torch.float32))
    twhisper.PRESETS["whisper-tiny-test"] = lambda: dataclasses.replace(
        twhisper.WhisperEncoderConfig.tiny_test(), dtype=torch.float32)
    ts2s.ProjectorConfig = functools.partial(tproj.ProjectorConfig, dtype=torch.float32)
    ttok.load_tokenizer = lambda path: FoldedTokenizer()
    try:
        yield
    finally:
        (tllm.LLMConfig.tiny_test, twhisper.PRESETS["whisper-tiny-test"], ts2s.ProjectorConfig,
         ttok.load_tokenizer) = saved


def _gen_cfg(manifest: str, log: str, tp: int = 1, mode: str = "batch"):
    """The recipe's own specs (factory and dataset) at the tiny sizes."""
    from slam_llm_tpu_torch.config import RunConfig

    cfg = RunConfig()
    mc, dc = cfg.model_config, cfg.dataset_config
    mc.file = "examples/s2s/model/slam_model_s2s.py:model_factory"
    mc.llm_name, mc.encoder_name, mc.encoder_config = "tiny-test", "whisper", "whisper-tiny-test"
    mc.encoder_projector, mc.encoder_projector_ds_rate = "linear", 5
    mc.text_vocabsize, mc.code_layer = 64, 3
    dc.file = "slam_llm_tpu.data.s2s_dataset:get_s2s_dataset"
    dc.val_data_path, dc.mel_size, dc.max_audio_length_s, dc.prompt = manifest, 8, 1.0, "Answer."
    dc.text_vocabsize, dc.code_layer = 64, 3
    cfg.decode_config.max_new_tokens, cfg.decode_config.decode_log = NEW_TOKENS, log
    cfg.decode_config.mode = mode
    cfg.train_config.shard.tp = tp
    return cfg


# ---- the worker side (no JAX) ------------------------------------------------------


def _trainer_steps(tcfg, state_dict, tc, batch, mesh=None):
    """STEPS trainer steps of the S2S model: each step's metrics with the
    forward's parts (summed over the data ranks), the largest tensor the
    first step gathered, the whole trainable tensors and the whole state."""
    from slam_llm_tpu_torch.models import s2s as ts2s
    from slam_llm_tpu_torch.parallel import tensor_parallel as tpar
    from slam_llm_tpu_torch.parallel.sharding import all_reduce_sum, data_group
    from slam_llm_tpu_torch.train.state import Trainer

    model = ts2s.S2SModel(tcfg)
    model.load_state_dict(state_dict)
    trainer = Trainer(model, tcfg, tc, mesh=mesh).state_from_params()
    L = tcfg.vocab.code_layer
    parts = []
    model.register_forward_hook(lambda m, args, out: parts.append(
        [out["text_loss"], *out["audio_loss"], *out["audio_acc"]]))
    metrics, gathered = [], None
    for step in range(STEPS):
        tpar.reset_largest_gather()
        m = trainer.train_step(trainer.put_batch(batch))
        if step == 0:
            gathered = dict(tpar.LARGEST_GATHER)
        got = parts.pop() if mesh is None else all_reduce_sum(parts.pop(), data_group(mesh))
        m = {k: float(v) for k, v in m.items()}
        m.update(text_loss=float(got[0]), audio_loss=[float(x) for x in got[1:1 + L]],
                 audio_acc=[float(x) for x in got[1 + L:]])
        metrics.append(m)
    return {"metrics": metrics, "trainable": trainer.whole_trainable(), "gathered": gathered,
            "state": trainer.state_dict(), "T": int(batch["input_ids"].shape[-1])}


def _windowed_cases():
    """Inputs of the windowed CE alone: a 20-entry vocabulary (10 a rank at
    tp=2), windows [3, 13) across the border and [13, 20) inside rank 1,
    logits 9 and 10 tied as a row's largest (exact small integers) with
    label 6 (column 9), labels at both edges of the first window (0 and 9)
    and ignored positions."""
    rng = np.random.default_rng(5)
    b, t, d, v = 2, 7, 8, 20
    hidden = torch.from_numpy(rng.standard_normal((b, t, d)).astype(np.float32))
    kernel = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32) * 0.5)
    tie = torch.from_numpy(rng.integers(-3, 4, d).astype(np.float32))
    hidden[0, 0] = tie
    kernel[9] = kernel[10] = 2 * tie
    lab0 = torch.from_numpy(rng.integers(0, 10, (b, t)))
    lab0[0, 0], lab0[0, 1], lab0[1, 2], lab0[1, 0] = 6, 0, 9, -100
    lab1 = torch.from_numpy(rng.integers(0, 7, (b, t)))
    lab1[1, 3:] = -100
    logits = hidden @ kernel.T
    return hidden, kernel, logits, [lab0, lab1], [(3, 13), (13, 20)]


def _windowed(tp=None):
    """The two windowed CEs on this rank's rows / columns (whole without
    ``tp``): losses, accuracies and the gradients, gathered whole."""
    from slam_llm_tpu_torch.ops.fused_ce import windowed_linear_ce, windowed_logits_ce
    from slam_llm_tpu_torch.parallel.tensor_parallel import all_gather_last

    hidden, kernel, logits, labels, windows = _windowed_cases()
    n = kernel.shape[0] if tp is None else kernel.shape[0] // tp.size
    first = 0 if tp is None else tp.rank * n
    h = hidden.clone().requires_grad_(True)
    k = kernel[first:first + n].clone().requires_grad_(True)
    loss, acc = windowed_linear_ce(h, k, labels, windows, chunk=3, compute_dtype=torch.float32, tp=tp)
    loss.sum().backward()
    whole = (lambda x: x) if tp is None else (lambda x: all_gather_last(x.contiguous(), tp))
    lg = logits[..., first:first + n].clone().requires_grad_(True)
    loss2, acc2 = windowed_logits_ce(lg, labels, windows, chunk=3, tp=tp)
    (loss2 * torch.tensor([1.0, 2.0])).sum().backward()
    return {"linear": (loss.detach(), acc, h.grad, whole(k.grad.T).T),
            "logits": (loss2.detach(), acc2, whole(lg.grad))}


def _decode(tcfg, state_dict, batch, tp=None, mesh=None):
    """The model's greedy tokens (7 steps, a repetition penalty) and its
    forward's loss and ``return_logits`` logits, on this rank's shards when
    ``mesh`` has a tp axis."""
    from slam_llm_tpu_torch.models import s2s as ts2s
    from slam_llm_tpu_torch.parallel.tensor_parallel import split_for_tp

    model = ts2s.S2SModel(tcfg)
    model.load_state_dict(state_dict)
    if mesh is not None:
        split_for_tp(model, mesh)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        out = model(tb, return_logits=True)
    gen = ts2s.S2SGenerator(model.eval(), max_new_tokens=7, text_repetition_penalty=1.3, audio_repetition_penalty=1.2)
    return {"tokens": gen.generate(tb), "loss": out["loss"], "logits": out["logits"]}


def _worker(payload: str, out_dir: str) -> None:
    import torch.distributed as dist

    from test_torch_distributed import DIST_TIMEOUT

    from slam_llm_tpu_torch.parallel.sharding import make_mesh
    from slam_llm_tpu_torch.parallel.tensor_parallel import tp_of
    from slam_llm_tpu_torch.pipeline import generate_s2s
    from slam_llm_tpu_torch.pipeline.common import maybe_init_distributed

    torch.set_num_threads(1)
    assert maybe_init_distributed("cpu", timeout=DIST_TIMEOUT)

    def trainer(job):
        mesh = make_mesh(dp=1, fsdp=job["fsdp"], tp=2, device_type="cpu")
        return _trainer_steps(job["tcfg"], job["state_dict"], job["tc"], job["batch"], mesh)

    def generate(job):
        with f32_recipe(), stdin_lines(job.get("lines")):
            try:
                return generate_s2s.main(job["cfg"], device="cpu")
            except NotImplementedError as e:  # the refusal is the result
                return {"refused": str(e)}

    def decode(job):
        return _decode(job["tcfg"], job["state_dict"], job["batch"], mesh=make_mesh(dp=1, fsdp=1, tp=2,
                                                                                    device_type="cpu"))

    jobs = {"trainer": trainer, "generate": generate, "decode": decode,
            "windowed": lambda job: _windowed(tp_of(make_mesh(dp=1, fsdp=1, tp=2, device_type="cpu")))}
    for job in torch.load(payload, weights_only=False):
        result = jobs[job["kind"]](job)
        if dist.get_rank() == 0:
            torch.save(result, Path(out_dir) / f"{job['name']}.pt")
    dist.destroy_process_group()


# ---- the references ------------------------------------------------------------------


def _corpus(root: Path) -> Path:
    from helpers import write_wav

    rows = []
    for i in range(4):
        wav = write_wav(root / f"q{i}.wav", seconds=0.3 + 0.2 * i, freq=300 + 200 * i, seed=i)
        rows.append({"key": f"q{i}", "source_wav": str(wav),
                     "source_text": "hi there <USER>: question 1" if i == 2 else f"question {i}",
                     "target_text": "sure thing" * (1 + i % 2), "target_token": list(range(3 * (6 + 2 * i)))})
    manifest = root / "test.jsonl"
    manifest.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return manifest


def _model(manifest, seed, **kw):
    """(JAX S2SConfig, port S2SConfig with CE chunk ``CHUNK``, JAX params,
    port state dict) of ``test_torch_s2s``'s tiny f32 pair."""
    from test_torch_s2s import _pair

    jmodel, params, tmodel, _, _ = _pair(manifest, seed, **kw)
    tcfg = dataclasses.replace(tmodel.cfg, llm=dataclasses.replace(tmodel.cfg.llm, ce_chunk=CHUNK))
    return jmodel.cfg, tcfg, params, tmodel.state_dict()


def _jax_s2s_steps(jcfg, params, batch, fsdp: int, tp: int):
    """The JAX Trainer's S2S steps on its (1, fsdp, tp) mesh: per step the
    loss, grad norm and trainable leaves (as ``_jax_steps``), and the
    forward's parts at the step's parameters. The params are laid out by
    the logical rules, except that the group-decode adapter's kernel,
    which names ``vocab`` on both axes (flax refuses to lay out a repeated
    name), is split on its output axis alone, as the port splits it; GSPMD
    computes the same function at any layout."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn
    from jax.sharding import PartitionSpec
    from test_torch_distributed import _train_config
    from test_torch_train import _leaves

    from slam_llm_tpu.models import s2s as js2s
    from slam_llm_tpu.parallel import make_mesh
    from slam_llm_tpu.parallel.sharding import logical_to_sharding
    from slam_llm_tpu.train.optimizer import merge_params
    from slam_llm_tpu.train.state import build_trainer

    model = js2s.S2SModel(jcfg)
    mesh = make_mesh(dp=1, fsdp=fsdp, tp=tp, devices=jax.devices()[:fsdp * tp])
    jt = build_trainer(model, jcfg, _train_config(port=False), mesh)
    example = {k: jnp.asarray(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
    boxed = jax.eval_shape(lambda r: model.init(r, example, method="init_all"), jax.random.PRNGKey(0))

    def once(spec):  # a name repeated in one spec (the adapter's ("vocab", "vocab")) kept on its last axis
        names = list(spec)
        return PartitionSpec(*(None if n is not None and n in names[i + 1:] else n for i, n in enumerate(names)))

    specs = jax.tree_util.tree_map(once, nn.get_partition_spec(boxed["params"]),
                                   is_leaf=lambda x: isinstance(x, PartitionSpec))
    state = jt.state_from_params(jax.device_put(params["params"], logical_to_sharding(mesh, specs)))
    forward = jax.jit(lambda p, b: model.apply({"params": p}, b))
    with mesh:
        db = jt.put_batch(batch)
    out, parts = [], []
    for i in range(STEPS):
        with mesh:
            f = forward(merge_params(state["trainable"], state["frozen"]), db)
            state, m = jt.train_step(state, db, jax.random.PRNGKey(i))
        parts.append({k: np.asarray(f[k]) for k in ("text_loss", "audio_loss", "acc", "audio_acc")})
        out.append((float(m["loss"]), float(m["grad_norm"]), _leaves(state["trainable"])))
    return out, parts


def _port_steps(tcfg, sd, batch):
    from test_torch_distributed import _train_config

    return _trainer_steps(tcfg, sd, _train_config(), batch)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worker groups, then the references meanwhile."""
    from test_torch_distributed import _Group, _train_config
    from test_torch_s2s import _batch

    from slam_llm_tpu_torch.pipeline import generate_s2s

    root = tmp_path_factory.mktemp("s2s_tp")
    manifest = _corpus(root)
    batch = {k: v for k, v in _batch(manifest, rows=ROWS).items() if isinstance(v, np.ndarray)}
    from slam_llm_tpu.models import s2s as js2s

    tc = _train_config()
    gd = _model(manifest, 0, group_decode=True)
    # 80-entry audio vocabularies: the head's 72 + 80 = 152 rows split 76 / 76, so
    # the audio slot [72, 152) straddles the border (in the tiny and shipped
    # vocabularies it lies inside the last rank)
    wide = js2s.VocabConfig(text_vocabsize=64, text_specialtokens=8, audio_vocabsize=72, audio_specialtokens=8,
                            code_layer=3)
    slot = _model(manifest, 3, vocab=wide, group_decode=True)
    slot_batch = {k: v for k, v in _batch(manifest, vocab=wide, rows=ROWS).items() if isinstance(v, np.ndarray)}
    tts = _model(manifest, 1, tts_adapter=True)
    emb = _model(manifest, 2, train_audio_embed_only=True)

    def trainer_job(name, model, fsdp=1, rows=batch):
        return {"kind": "trainer", "name": name, "tcfg": model[1], "state_dict": model[3], "tc": tc,
                "batch": rows, "fsdp": fsdp}

    def gen_job(name, tp, mode="batch", lines=None):
        return {"kind": "generate", "name": name, "lines": lines,
                "cfg": _gen_cfg(str(manifest), str(root / name), tp=tp, mode=mode)}

    variants = {"group_decode": gd, "tts_adapter": tts, "plain": emb}
    two = _Group(2, [
        trainer_job("gd", gd), trainer_job("tts", tts), trainer_job("emb", emb),
        trainer_job("slot", slot, rows=slot_batch),
        *({"kind": "decode", "name": f"decode_{v}", "tcfg": m[1], "state_dict": m[3], "batch": batch}
          for v, m in variants.items()),
        {"kind": "windowed", "name": "windowed"},
        gen_job("gen_tp2", 2), gen_job("gen_dp2", 1), gen_job("online_tp2", 2, mode="online", lines=ONLINE),
        gen_job("online_dp2", 1, mode="online", lines=ONLINE),
    ], root / "two", script=Path(__file__))
    four = _Group(4, [trainer_job("gd4", gd, fsdp=2), trainer_job("tts4", tts, fsdp=2)], root / "four",
                  script=Path(__file__))
    torch.set_num_threads(2)
    with f32_recipe():
        one_gen = generate_s2s.main(_gen_cfg(str(manifest), str(root / "gen_one")), device="cpu")
        with stdin_lines(ONLINE):
            one_online = generate_s2s.main(_gen_cfg(str(manifest), str(root / "online_one"), mode="online"),
                                           device="cpu")
    refs = {
        "jax": _jax_s2s_steps(gd[0], gd[2], batch, 1, 2),
        "gd": _port_steps(gd[1], gd[3], batch),
        "tts": _port_steps(tts[1], tts[3], batch),
        "emb": _port_steps(emb[1], emb[3], batch),
        "slot": _port_steps(slot[1], slot[3], slot_batch),
        "windowed": _windowed(),
        **{f"decode_{v}": _decode(m[1], m[3], batch) for v, m in variants.items()},
        "gen_one": one_gen, "online_one": one_online,
    }
    yield {"root": root, "two": two, "four": four, "refs": refs, "models": {"gd": gd, "emb": emb}, "batch": batch}
    for group in (two, four):
        for p in group.procs:
            if p.poll() is None:
                p.kill()


# ---- the tests ------------------------------------------------------------------------


def _assert_parts_match_jax(got, parts):
    """Each step's text / audio losses and accuracies against the JAX
    forward's at the same parameters, within 1e-5 relative."""
    for m, want in zip(got["metrics"], parts):
        np.testing.assert_allclose(m["text_loss"], want["text_loss"], rtol=1e-5)
        np.testing.assert_allclose(m["acc"], want["acc"], rtol=1e-5)
        np.testing.assert_allclose(m["audio_loss"], want["audio_loss"], rtol=1e-5)
        np.testing.assert_allclose(m["audio_acc"], want["audio_acc"], rtol=1e-5)


@pytest.mark.parametrize("mesh", ["tp2", "fsdp2_tp2"])
def test_group_decode_training_matches_the_jax_trainer(runs, mesh):
    """tp=2 (two ranks) and fsdp=2 x tp=2 (four), group decode, the whole
    LLM trained, f32: three steps against the JAX Trainer on its (1, 1, 2)
    mesh: loss and grad norm (1e-5 relative), the text and each codebook's
    loss and accuracy (1e-5), every trainable tensor after the last step
    (1e-5 of its norm)."""
    from test_torch_distributed import _assert_matches_jax

    got = runs["two"].result("gd") if mesh == "tp2" else runs["four"].result("gd4")
    want, parts = runs["refs"]["jax"]
    _assert_matches_jax(got, want, encoder="whisper")
    _assert_parts_match_jax(got, parts)


@pytest.mark.parametrize("route", ["tts", "emb", "tts4", "slot"])
def test_s2s_routes_match_one_process(runs, route):
    """tp=2 against the one-process port over the same weights, f32: the
    TTS adapter route (its blocks split as decoder layers, its head over
    the audio vocabularies; also at fsdp=2 x tp=2, ``tts4``, its blocks
    FSDP2 units), ``train_audio_embed_only`` (the full vocabulary's head
    alone trains, every CE a window of it) and group decode with the head's
    audio slot across the shard border (``slot``: each rank forms its part
    of the slot): losses, parts and grad norms within 1e-5, every trainable
    tensor within 1e-5 of its norm; the audio-embed update mask lands on
    each rank's rows (the text rows stay bit for bit)."""
    got = runs["four"].result(route) if route == "tts4" else runs["two"].result(route)
    want = runs["refs"][route.rstrip("4")]
    for a, b in zip(got["metrics"], want["metrics"]):
        for key in ("loss", "grad_norm", "text_loss", "acc", "audio_loss", "audio_acc"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5, err_msg=key)
    assert set(got["trainable"]) == set(want["trainable"])
    for name, w in want["trainable"].items():
        assert float((got["trainable"][name] - w).norm()) <= 1e-5 * float(w.norm()), name
    if route == "emb":
        before = runs["models"]["emb"][3]["llm.lm_head.weight"]
        head = got["trainable"]["llm.lm_head.weight"]
        ptv = 72  # the tiny vocabulary's padded text
        assert list(got["trainable"]) == ["llm.lm_head.weight"]
        assert torch.equal(head[:ptv], before[:ptv]) and not torch.equal(head[ptv:], before[ptv:])


@pytest.mark.parametrize("variant", ["group_decode", "tts_adapter", "plain"])
def test_decoding_and_return_logits_under_tp_match_one_process(runs, variant):
    """At tp=2 the sampler reads whole gathered logits (``split_logits``,
    ``prefill_tts`` / ``decode_step_tts`` with the TTS adapter's cache at
    the rank's heads), so greedy tokens with repetition penalties equal one
    process's; ``return_logits`` gathers the head's logits whole (within
    1e-5), beside the loss."""
    got, want = runs["two"].result(f"decode_{variant}"), runs["refs"][f"decode_{variant}"]
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["logits"].shape == want["logits"].shape
    torch.testing.assert_close(got["logits"], want["logits"], rtol=1e-5, atol=1e-5 * float(want["logits"].abs().max()))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)


def test_no_rank_gathers_more_than_one_chunk_of_logits(runs):
    """In each tp=2 training step's forward and backward the largest tensor
    any rank gathered is one CE chunk of the widest vocabulary a loss reads,
    B x CHUNK x V: with group decode the adapter's 120 (the head's 112 is
    narrower), with the TTS adapter or no group decode the whole head's
    192; never (B, T, V) whole."""
    widths = {"gd": 120, "tts": 192, "emb": 192}
    for name, width in widths.items():
        got = runs["two"].result(name)
        assert got["T"] - 1 > CHUNK
        shape = got["gathered"]["shape"]
        assert shape[-1] == width and got["gathered"]["numel"] == len(ROWS) * CHUNK * width, (name, shape)


def test_tp2_state_is_the_one_process_tree_and_resumes_at_tp1(runs):
    """The tp=2 trainer's whole state (trainable tensors, Adam's moments,
    the step) has the one-process state's names and shapes and its values
    within 1e-5 of each tensor's norm; loaded into one process, it is
    restored bit for bit and takes a fourth step whose loss is the
    one-process run's fourth within 1e-5."""
    from test_torch_distributed import _train_config

    from slam_llm_tpu_torch.models import s2s as ts2s
    from slam_llm_tpu_torch.train.state import Trainer

    got, want = runs["two"].result("gd")["state"], runs["refs"]["gd"]["state"]
    assert got["step"] == want["step"] == STEPS
    assert set(got["trainable"]) == set(want["trainable"])
    for name, w in want["trainable"].items():
        assert got["trainable"][name].shape == w.shape
        assert float((got["trainable"][name] - w).norm()) <= 1e-5 * float(w.norm()), name
    for key in ("mu", "nu"):
        for a, b in zip(got["optimizer"][key], want["optimizer"][key]):
            assert a.shape == b.shape and float((a - b).norm()) <= 1e-4 * float(b.norm()) + 1e-12, key
    _, tcfg, _, sd = runs["models"]["gd"]
    losses = []
    for state in (got, want):
        model = ts2s.S2SModel(tcfg)
        model.load_state_dict(sd)
        trainer = Trainer(model, tcfg, _train_config()).state_from_params()
        trainer.load_state_dict(state)
        assert all(torch.equal(p.detach(), state["trainable"][n]) for n, p in trainer.trainable.items())
        batch = trainer.put_batch(runs["batch"])
        losses.append(float(trainer.train_step(batch)["loss"]))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)


def test_windowed_ce_equals_the_plain_ce_across_the_shard_border(runs):
    """The windowed CEs at tp=2 against the plain CE over the whole logits'
    window columns (autograd through logsumexp and a gather): losses,
    accuracies (the tie across the border read as the lower index) and
    every gradient, f32, within 1e-6 relative; and without tp as well."""
    hidden, kernel, logits, labels, windows = _windowed_cases()

    def plain(h, k, lg_whole=None):
        lg_whole = h @ k.T if lg_whole is None else lg_whole
        losses, accs = [], []
        for lab, (lo, hi) in zip(labels, windows):
            lg = lg_whole[..., lo:hi]
            mask = (lab != -100).float()
            safe = lab.clamp_min(0)
            nll = torch.logsumexp(lg, -1) - lg.gather(-1, safe[..., None])[..., 0]
            losses.append((nll * mask).sum() / mask.sum())
            accs.append(((lg.argmax(-1) == safe).float() * mask).sum() / mask.sum())
        return torch.stack(losses), torch.stack(accs)

    h, k = hidden.clone().requires_grad_(True), kernel.clone().requires_grad_(True)
    loss, acc = plain(h, k)
    loss.sum().backward()
    lg = logits.clone().requires_grad_(True)
    loss2, acc2 = plain(None, None, lg)
    (loss2 * torch.tensor([1.0, 2.0])).sum().backward()
    want = {"linear": (loss.detach(), acc, h.grad, k.grad), "logits": (loss2.detach(), acc2, lg.grad)}
    tied = logits[0, 0, 3:13]
    assert tied[6] == tied[7] == tied.max() and int(tied.argmax()) == 6 and labels[0][0, 0] == 6
    for got in (runs["two"].result("windowed"), runs["refs"]["windowed"]):
        for key, w in want.items():
            for a, b in zip(got[key], w):
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * float(b.abs().max()))


def test_generate_s2s_under_tp_and_data_ranks_writes_what_one_process_writes(runs):
    """``pipeline.generate_s2s`` batch mode (greedy, f32) at tp=2 writes
    ``_pred`` / ``_gt`` line for line the one-process run's (tp rank 0
    writes, no rank suffix); at two data ranks each writes its strided
    items to ``_rank{r}`` logs, whose union is the one-process logs; one
    online round at tp=2 answers as one process does, and at two data ranks
    the online mode refuses, naming why."""
    root, one = runs["root"], runs["refs"]["gen_one"]
    tp2 = runs["two"].result("gen_tp2")
    runs["two"].result("gen_dp2")
    assert tp2["n"] == one["n"] == 4
    for kind in ("pred", "gt"):
        want = _entries(Path(one[kind]))
        assert list(want) == ["q0", "q1", "q2", "q3"]
        assert Path(f"{root}/gen_tp2_{kind}").read_text() == Path(one[kind]).read_text()
        assert not Path(f"{root}/gen_tp2_{kind}_rank0").exists()
        ranks = [_entries(Path(f"{root}/gen_dp2_{kind}_rank{r}")) for r in (0, 1)]
        assert list(ranks[0]) == ["q0", "q2"] and list(ranks[1]) == ["q1", "q3"]
        assert {**ranks[0], **ranks[1]} == want
    assert runs["two"].result("online_tp2") == runs["refs"]["online_one"]
    assert len(runs["refs"]["online_one"]) == 1
    assert "decodes one dialogue" in runs["two"].result("online_dp2")["refused"]


@pytest.mark.parametrize("variant,what", [
    ("group_decode", "group-decode adapter's audio vocabularies"), ("tts_adapter", "TTS adapter head's audio")])
def test_an_s2s_head_tp_does_not_divide_raises(variant, what):
    """tp=2 over S2S heads of 3 x 41 audio entries (the LLM's head and
    vocabulary even) raises ValueError naming the head, before any tensor
    is split."""
    from slam_llm_tpu_torch.models import s2s as ts2s
    from slam_llm_tpu_torch.parallel.tensor_parallel import split_for_tp

    vocab = ts2s.VocabConfig(text_vocabsize=65, text_specialtokens=8, audio_vocabsize=33, audio_specialtokens=8,
                             code_layer=3)
    model = ts2s.S2SModel(ts2s.S2SConfig(vocab=vocab, encoder_name=None, **{variant: True}, tts_adapter_layers=1))
    before = model.llm.embed_tokens.weight.shape

    class Mesh:  # a tp axis of two, without a process group (the check raises first)
        def __getitem__(self, axis):
            return type("Axis", (), {"size": lambda s: 2, "get_group": lambda s: None,
                                     "get_local_rank": lambda s: 0})()

    with pytest.raises(ValueError, match=f"does not divide the {what}"):
        split_for_tp(model, Mesh())
    assert model.llm.embed_tokens.weight.shape == before and model.tp is None


def _entries(path: Path) -> dict:
    """A decode log's entries by key: a random model's text holds line
    breaks, but never a ``q`` (the folded vocabulary decodes to bytes below
    64), so an entry starts where a line starts with ``q<digit><tab>``."""
    text = path.read_text()
    return {e.split("\t", 1)[0]: e for e in re.split(r"(?m)^(?=q\d\t)", text) if e}


if __name__ == "__main__":
    sys.path.insert(0, str(HERE))
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    _worker(sys.argv[1], sys.argv[2])
