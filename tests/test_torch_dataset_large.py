"""The large-scale multitask dataset, Kaldi arks and the hotword filter in
the port against the JAX package, on the CPU.

* arks: matrices and wav entries written by either package's writer read
  back equal by both readers; hand-made double, vector and compressed
  (``CM``) entries read equal;
* ``MultiTaskDataset``: items equal to JAX's (ids, labels, the prompts drawn
  from the pools with ``random.Random(seed + rank)``, the ``{}`` hotword
  injection, rank shards, the length filter, raw audio normalized, the
  unpadded mel within 1e-6);
* ``TokenBudgetBatcher``: the same batches, shape and content, for the
  train and eval budgets;
* ``hotword_filter``: scores and filtered lists equal to JAX's;
* ``pipeline.finetune`` of both packages refusing the iterable dataset with
  the same ``TypeError``;
* a tiny aispeech slice (whisper-tiny-test, linear ds 5, the tiny LLM, f32)
  on a batcher batch: loss and projector gradients against
  ``jax.value_and_grad``.
"""

import dataclasses
import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_llm_tpu.config import RunConfig as JRunConfig
from slam_llm_tpu.data import kaldi_ark as jark
from slam_llm_tpu.data import speech_dataset_large as jlarge
from slam_llm_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from slam_llm_tpu.models.llm import LLMConfig as JLLMConfig
from slam_llm_tpu.models.projector import ProjectorConfig as JProjectorConfig
from slam_llm_tpu.models.slam_model import SLAMConfig as JSLAMConfig
from slam_llm_tpu.models.slam_model import SLAMModel as JSLAMModel
from slam_llm_tpu.models.whisper import WhisperEncoderConfig as JWhisperConfig
from slam_llm_tpu.train.optimizer import merge_params as j_merge
from slam_llm_tpu.train.optimizer import partition_params as j_partition
from slam_llm_tpu.utils import hotword_filter as jhot
from slam_llm_tpu_torch.config import RunConfig
from slam_llm_tpu_torch.data import kaldi_ark as tark
from slam_llm_tpu_torch.data import speech_dataset_large as tlarge
from slam_llm_tpu_torch.data.tokenizer import ByteTokenizer
from slam_llm_tpu_torch.models import llm as tllm
from slam_llm_tpu_torch.models import projector as tproj
from slam_llm_tpu_torch.models import slam_model as tslam
from slam_llm_tpu_torch.models import whisper as twhisper
from slam_llm_tpu_torch.train.optimizer import partition_params
from slam_llm_tpu_torch.utils import hotword_filter as thot
from slam_llm_tpu_torch.utils.convert import from_flax_params, trainable_to_flax
from test_torch_music_spatial import _close, _conv, _flat, _seeded

# ---------------------------------------------------------------------------
# Kaldi arks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ark_round_trips_between_the_packages(tmp_path, writer):
    rng = np.random.default_rng(0)
    mats = {"a": rng.standard_normal((7, 13)).astype(np.float32), "b": np.zeros((2, 3), np.float32)}
    waves = {"u1": (0.3 * np.sin(np.linspace(0, 200, 8000))).astype(np.float32),
             "u2": (0.1 * rng.standard_normal(3001)).astype(np.float32)}
    mod = tark if writer == "port" else jark
    mat_specs = mod.write_float_matrix(str(tmp_path / "m.ark"), mats)
    wav_specs = mod.write_wav_ark(str(tmp_path / "w.ark"), waves)
    other = jark.write_float_matrix(str(tmp_path / "m2.ark"), mats) if writer == "port" else \
        tark.write_float_matrix(str(tmp_path / "m2.ark"), mats)
    assert open(tmp_path / "m.ark", "rb").read() == open(tmp_path / "m2.ark", "rb").read() and len(other) == 2
    for spec, want in zip(mat_specs, mats.values()):
        np.testing.assert_array_equal(tark.load_mat(spec), want)
        np.testing.assert_array_equal(jark.load_mat(spec), want)
    for spec, want in zip(wav_specs, waves.values()):
        (sr, got), (jsr, jgot) = tark.load_mat(spec), jark.load_mat(spec)
        assert sr == jsr == 16000 and got.dtype == np.int16
        np.testing.assert_array_equal(got, jgot)
        np.testing.assert_allclose(got / 32768.0, want, atol=1e-3)


def _entry(token: bytes, payload: bytes) -> bytes:
    return b"\x00B" + token + payload


def _compressed(rows: int, cols: int, rng) -> bytes:
    """A Kaldi CompressedMatrix (format 1) with every uint8 range hit."""
    pct = np.sort(rng.integers(0, 65536, (cols, 4)), axis=1).astype("<u2")
    data = rng.integers(0, 256, (cols, rows)).astype(np.uint8)
    data[0, :4] = [0, 64, 192, 255]
    return struct.pack("<ff", -3.5, 9.25) + struct.pack("<ii", rows, cols) + pct.tobytes() + data.tobytes()


def test_ark_reads_double_vector_and_compressed_entries_as_jax(tmp_path):
    rng = np.random.default_rng(1)
    dm = rng.standard_normal((4, 5))
    fv, dv = rng.standard_normal(6).astype(np.float32), rng.standard_normal(3)
    entries = [
        _entry(b"DM ", b"\x04" + struct.pack("<i", 4) + b"\x04" + struct.pack("<i", 5) + dm.astype("<f8").tobytes()),
        _entry(b"FV ", b"\x04" + struct.pack("<i", 6) + fv.astype("<f4").tobytes()),
        _entry(b"DV ", b"\x04" + struct.pack("<i", 3) + dv.astype("<f8").tobytes()),
        _entry(b"CM ", _compressed(9, 5, rng)),
    ]
    path, specs = tmp_path / "mixed.ark", []
    with open(path, "wb") as f:
        for i, e in enumerate(entries):
            f.write(f"k{i} ".encode())
            specs.append(f"{path}:{f.tell()}")
            f.write(e)
    for spec in specs:
        got, want = tark.load_mat(spec), jark.load_mat(spec)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tark.load_mat(specs[0]), dm.astype(np.float32))
    assert tark.load_mat(specs[3]).shape == (9, 5)
    with pytest.raises(ValueError, match="not a kaldi binary entry"):
        tark.load_mat(f"{path}:1")


# ---------------------------------------------------------------------------
# the dataset and the batcher
# ---------------------------------------------------------------------------

PROMPTS = [("asr", "Transcribe. "), ("asr", "Write down what is said. "), ("asr", "ASR: "),
           ("hotword", "Transcribe, the hotwords are {}. "), ("hotword", "Hotwords {}: transcribe. ")]


@pytest.fixture()
def corpus(tmp_path):
    """14 wav-ark utterances of 0.3-2.1 s (the longest two past a 2 s
    filter), asr and hotword tasks, a ``multiprompt.jsonl`` of two pools."""
    rng = np.random.default_rng(3)
    waves = {f"u{i}": (0.2 * np.sin(2 * np.pi * (200 + 30 * i) * np.arange(int(16000 * (0.3 + 0.15 * i))) / 16000)
                       + 0.01 * rng.standard_normal(int(16000 * (0.3 + 0.15 * i)))).astype(np.float32)
             for i in range(14)}
    specs = tark.write_wav_ark(str(tmp_path / "audio.ark"), waves)
    with open(tmp_path / "multitask.jsonl", "w") as f:
        for i, spec in enumerate(specs):
            task = "hotword" if i % 3 else "asr"
            row = {"key": f"u{i}", "path": spec, "task": task, "target": f"text number {i} " * (1 + i % 4)}
            if task == "hotword":
                row["hotword"] = f"SLAM{i}, LLM"
            f.write(json.dumps(row) + "\n")
    (tmp_path / "multiprompt.jsonl").write_text("".join(json.dumps({"task": t, "prompt": p}) + "\n"
                                                        for t, p in PROMPTS))
    return tmp_path


def _configs(corpus, **kw):
    out = []
    for mod in (JRunConfig, RunConfig):
        cfg = mod().dataset_config
        for k, v in {**dict(dataset="speech_dataset_large", train_data_path=str(corpus), val_data_path=str(corpus),
                            input_type="mel", mel_size=8, pad_or_trim=False, seed=11, max_audio_length_s=2.0,
                            text_buckets=[96, 128, 192, 256], train_max_frame_length=512, eval_max_frame_length=256,
                            append_info_tasks=["hotword"]), **kw}.items():
            setattr(cfg, k, v)
        out.append(cfg)
    return out


def _same(a, b, mel_tol=0.0):
    assert a.keys() == b.keys()
    for k in b:
        if isinstance(b[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            if k == "audio_mel":
                assert np.abs(a[k] - b[k]).max() <= mel_tol, k
            else:
                assert np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("input_type,inference,rank,world", [("mel", False, 0, 1), ("raw", False, 0, 1),
                                                             ("mel", True, 0, 1), ("raw", False, 1, 3)])
def test_items_match_jax(corpus, input_type, inference, rank, world):
    jc, tc = _configs(corpus, input_type=input_type, normalize=True, inference_mode=inference)
    tok = ByteTokenizer()
    titems = list(tlarge.MultiTaskDataset(tc, tok, "train", rank=rank, world_size=world))
    jitems = list(jlarge.MultiTaskDataset(jc, JByteTokenizer(), "train", rank=rank, world_size=world))
    keys = [f"u{i}" for i in range(rank, 12, world)]  # the two past 2 s are skipped
    assert [it["key"] for it in titems] == keys
    for a, b in zip(titems, jitems):
        _same(a, b, mel_tol=1e-6)
    texts = [tok.decode(it["input_ids"][it["audio_length"]:]) for it in titems]
    assert all(f"SLAM{i}, LLM" in t for i, t in zip(range(rank, 12, world), texts) if i % 3)
    if rank == 0:  # the seeded draws pick more than one prompt of a pool
        assert len({t.split("\n")[0] for t, it in zip(texts, titems) if it["key"] in ("u0", "u3", "u6", "u9")}) > 1


@pytest.mark.parametrize("split,input_type", [("train", "mel"), ("validation", "mel"), ("train", "raw")])
def test_batcher_batches_match_jax(corpus, split, input_type):
    jc, tc = _configs(corpus, input_type=input_type)
    tbat = tlarge.get_speech_dataset_large(tc, ByteTokenizer(), split)
    jbat = jlarge.get_speech_dataset_large(jc, JByteTokenizer(), split)
    tb, jb = list(tbat), list(jbat)
    assert len(tb) == len(jb) > 1 and not hasattr(tbat, "__len__")
    budget = 512 if split == "train" else 256
    for a, b in zip(tb, jb):
        _same(a, b, mel_tol=1e-6)
        n, t = a["input_ids"].shape  # a bucket's batch pads to the bucket, or to twice it where the
        assert t in (96, 128, 192, 256) and n <= budget // 96  # left-padded prompts and answers overrun it
    assert sum(b["input_ids"].shape[0] for b in tb) == 12
    assert tc.text_buckets == [96, 128, 192, 256]  # the batcher leaves the caller's config as it was


def test_hotword_filter_matches_jax():
    rng = np.random.default_rng(5)
    letters = list("abcdeilmnorstu ")
    names = ["".join(rng.choice(letters[:-1], size=rng.integers(3, 9))).capitalize() for _ in range(60)]
    names += [f"{a} {b}" for a, b in zip(names[:10], names[10:20])]
    for _ in range(20):
        words = ["".join(rng.choice(letters[:-1], size=rng.integers(2, 8))) for _ in range(rng.integers(3, 12))]
        words[rng.integers(len(words))] = names[int(rng.integers(len(names)))].lower()
        sentence = " ".join(words)
        index = thot.build_ngram_index(names)
        assert index == jhot.build_ngram_index(names)
        cands = thot.find_candidate_names(sentence, index)
        assert cands == jhot.find_candidate_names(sentence, index)
        assert thot.score_candidates(cands, sentence) == jhot.score_candidates(cands, sentence)
        for kw in ({}, {"common_words": {"the", words[0]}, "probability_threshold": 0.8, "word_num": 5}):
            assert thot.filter_hotwords(sentence, names, **kw) == jhot.filter_hotwords(sentence, names, **kw)


# ---------------------------------------------------------------------------
# the entry points and the tiny aispeech slice
# ---------------------------------------------------------------------------


def test_finetune_refuses_the_iterable_dataset_as_jax(corpus, tmp_path):
    """The loader takes map-style datasets: ``pipeline.finetune`` of both
    packages stops at it with ``TypeError: object of type
    'TokenBudgetBatcher' has no len()``."""
    from helpers import tiny_run_config
    from slam_llm_tpu.pipeline import finetune as jfinetune
    from slam_llm_tpu_torch.config import set_by_path
    from slam_llm_tpu_torch.pipeline import finetune as tfinetune

    over = {"dataset_config.dataset": "speech_dataset_large", "dataset_config.train_data_path": str(corpus),
            "dataset_config.val_data_path": str(corpus), "train_config.output_dir": str(tmp_path / "out")}
    jcfg = tiny_run_config(corpus, **over)
    tcfg = RunConfig()
    for key, value in {"model_config.llm_name": "tiny-test", "model_config.encoder_name": "whisper",
                       "model_config.encoder_config": "whisper-tiny-test", "model_config.encoder_projector": "linear",
                       "dataset_config.mel_size": 8, **over}.items():
        set_by_path(tcfg, key, value)
    for main, kw in ((jfinetune.main, {}), (tfinetune.main, {"device": "cpu"})):
        with pytest.raises(TypeError, match="'TokenBudgetBatcher' has no len"):
            main(jcfg if not kw else tcfg, **kw)


def test_tiny_aispeech_slice_matches_jax(corpus):
    """The first train batch of the batcher (unpadded mel) through a tiny
    whisper + linear ds 5 + tiny LLM in f32: the loss within 1e-5 and every
    projector gradient within 1e-5 relative of ``jax.value_and_grad``."""
    _, tc = _configs(corpus, input_type="mel", max_audio_length_s=1.2)
    batch = next(iter(tlarge.get_speech_dataset_large(tc, ByteTokenizer(), "train")))
    batch = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    assert batch["audio_mel"].shape[1] < 3000 and batch["audio_mel_mask"].min() == 0  # ragged, not 30 s
    llm = dataclasses.replace(JLLMConfig.tiny_test(vocab_size=259), lora_rank=0, dtype=jnp.float32)
    enc = dataclasses.replace(JWhisperConfig.tiny_test(), dtype=jnp.float32)
    proj = JProjectorConfig(encoder_dim=enc.d_model, llm_dim=llm.d_model, ds_rate=5, hidden_dim=32, dtype=jnp.float32)
    jcfg = JSLAMConfig(llm=llm, encoder_name="whisper", encoder=enc, projector="linear", projector_cfg=proj,
                       freeze_encoder=True, freeze_llm=True)
    tcfg = tslam.SLAMConfig(
        llm=dataclasses.replace(_conv(tllm.LLMConfig, llm), remat=False), encoder_name="whisper",
        encoder=_conv(twhisper.WhisperEncoderConfig, enc), projector="linear",
        projector_cfg=_conv(tproj.ProjectorConfig, proj), freeze_encoder=True, freeze_llm=True)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = _seeded(JSLAMModel(jcfg).init(jax.random.PRNGKey(0), jbatch, method="init_all")["params"], seed=5)
    trainable, frozen = j_partition(params, jcfg)

    def loss_fn(tr):
        return JSLAMModel(jcfg).apply({"params": j_merge(tr, frozen)}, jbatch)["loss"]

    jl, jg = jax.value_and_grad(loss_fn)(trainable)
    tm = tslam.SLAMModel(tcfg).eval()
    tm.load_state_dict(from_flax_params(params, tcfg))
    tr, _ = partition_params(tm, tm.cfg)
    out = tm({k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(out["loss"], list(tr.values()))
    np.testing.assert_allclose(float(out["loss"].detach()), float(jl), rtol=1e-5)
    got, want = _flat(trainable_to_flax(dict(zip(tr.keys(), grads)))), _flat(jg)
    assert set(got) == set(want)
    for key, g in got.items():
        _close(g, want[key])
