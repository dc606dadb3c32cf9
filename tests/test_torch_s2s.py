"""The S2S (SLAM-Omni) slice of the port against the JAX package, on the CPU.

One set of weights (a tiny JAX ``S2SModel``: whisper-tiny-test, a linear
projector, the tiny LLM over the tiny vocabulary) goes into both packages
through ``utils.convert.from_flax_params``. In f32: the dataset's items and
batches are equal; the parallel loss and its parts agree within 1e-5
relative, the trainable gradients of the group-decode and TTS-adapter
variants within 1e-4 of each tensor's largest entry; greedy and penalized
generation give identical tokens; the trick partitions and the update mask
are the JAX package's; the batch / online / stream drivers write the same
``_pred`` / ``_gt`` and wavs of the expected length; a codec that does not
load raises. The recipe's two ``file:`` specs resolve in a fresh
interpreter without loading JAX, flax, the JAX package or an HF package.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from helpers import write_wav
from slam_llm_tpu.data import s2s_dataset as jds_mod
from slam_llm_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from slam_llm_tpu.models import s2s as js2s
from slam_llm_tpu.models.llm import LLMConfig as JLLMConfig
from slam_llm_tpu.models.projector import ProjectorConfig as JProjectorConfig
from slam_llm_tpu.models.whisper import WhisperEncoderConfig as JWhisperConfig
from slam_llm_tpu.train import optimizer as jopt
from slam_llm_tpu_torch.data import s2s_dataset as tds_mod
from slam_llm_tpu_torch.data.tokenizer import ByteTokenizer
from slam_llm_tpu_torch.models import llm as tllm
from slam_llm_tpu_torch.models import projector as tproj
from slam_llm_tpu_torch.models import s2s as ts2s
from slam_llm_tpu_torch.models import whisper as twhisper
from slam_llm_tpu_torch.train import optimizer as topt
from slam_llm_tpu_torch.utils.convert import flax_to_state_dict, from_flax_params

REPO = Path(__file__).resolve().parent.parent
JV, TV = js2s.VocabConfig.tiny_test(), ts2s.VocabConfig.tiny_test()


class _JTok(JByteTokenizer):
    """The byte tokenizer folded into the tiny 64-entry text vocabulary."""

    def encode(self, text, add_bos=True):
        return [3 + b % 57 for b in text.encode("utf-8")]


class _Tok(ByteTokenizer):
    def encode(self, text, add_bos=True):
        return [3 + b % 57 for b in text.encode("utf-8")]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four grouped (CosyVoice-style) items, one a multi-round history, and
    one SNAC-style item of per-layer lists."""
    d = tmp_path_factory.mktemp("s2s")
    rows = []
    for i in range(4):
        wav = write_wav(d / f"q{i}.wav", seconds=0.3 + 0.2 * i, freq=300 + 200 * i, seed=i)
        rows.append({"key": f"q{i}", "source_wav": str(wav),
                     "source_text": "hi there <USER>: question 1" if i == 2 else f"question {i}",
                     "target_text": "sure thing" * (1 + i % 2), "target_token": list(range(3 * (6 + 2 * i)))})
    rows.append({"key": "snac", "source_wav": str(d / "q0.wav"), "source_text": "q", "target_text": "ok",
                 "target_token": [[1, 2, 3], [4, 5, 6, 7], [8, 9]]})
    manifest = d / "test.jsonl"
    manifest.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return manifest


def _ds_config(manifest, vocab, **kw):
    class C:
        pass

    c = C()
    c.train_data_path = c.val_data_path = str(manifest)
    c.vocab_config, c.task_type, c.mel_size, c.max_audio_length_s = vocab, "s2s", 8, 1.0
    c.text_buckets, c.prompt, c.inference_mode = [96, 160, 256], "Answer.", False
    c.fix_length_audio, c.num_latency_tokens = -1, 0
    for k, v in kw.items():
        setattr(c, k, v)
    return c


def _same(a, b):
    assert a.keys() == b.keys()
    for k in b:
        if isinstance(b[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("kw", [{}, {"inference_mode": True}, {"task_type": "asr"}, {"num_latency_tokens": 2}])
def test_dataset_items_and_batches_match_jax(corpus, kw):
    jds = jds_mod.S2SDatasetJsonl(_ds_config(corpus, JV, **kw), _JTok(), "train")
    tds = tds_mod.S2SDatasetJsonl(_ds_config(corpus, TV, **kw), _Tok(), "train")
    assert len(tds) == len(jds) == 5
    for i in range(5):
        # the port's items also carry the seconds the model hears (the RTF's)
        _same({k: x for k, x in tds[i].items() if k != "audio_seconds"}, jds[i])
        assert tds.sort_key(i) == jds.sort_key(i)
    for rows in ((0, 1), (2, 3, 4)):
        _same(tds.collator([tds[i] for i in rows]), jds.collator([jds[i] for i in rows]))
    item = tds[0]
    assert item["header_length"] == item["prompt_length"] + item["audio_length"] + 3 and item["audio_length"] == 10


@pytest.mark.parametrize("max_s,want", [(1.0, [0.3, 0.5, 0.7, 0.9, 0.3]), (0.6, [0.3, 0.5, 0.6, 0.6, 0.3])])
def test_items_count_the_question_seconds_the_model_hears(corpus, max_s, want):
    """A question longer than ``max_audio_length_s`` is cut to it before the
    mel: its item counts the cut length, not the file's."""
    tds = tds_mod.S2SDatasetJsonl(_ds_config(corpus, TV, max_audio_length_s=max_s, inference_mode=True), _Tok(), "test")
    assert [tds[i]["audio_seconds"] for i in range(5)] == pytest.approx(want)


def test_group_and_snac_answer_tokens_match_jax():
    v = TV
    for args in (([*range(11)], 3, 2, v.pad_a, v.eoa), ([*range(9)], 3, 0, v.pad_a, v.eoa)):
        np.testing.assert_array_equal(tds_mod.group_answer_tokens(*args), jds_mod.group_answer_tokens(*args))
    lists = [[1, 2], [3, 4, 5], [6]]
    np.testing.assert_array_equal(tds_mod.snac_answer_tokens(lists, v.pad_a, v.eoa),
                                  jds_mod.snac_answer_tokens(lists, v.pad_a, v.eoa))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _configs(vocab=None, **kw):
    """(JAX S2SConfig, the port's) in f32 at the tiny sizes."""
    vocab = vocab or JV
    jcfg = js2s.S2SConfig(
        llm=dataclasses.replace(JLLMConfig.tiny_test(), remat=False, dtype=jnp.float32),
        vocab=vocab, encoder_name="whisper", encoder=dataclasses.replace(JWhisperConfig.tiny_test(), dtype=jnp.float32),
        projector="linear",
        projector_cfg=JProjectorConfig(encoder_dim=32, llm_dim=64, ds_rate=5, hidden_dim=16, dtype=jnp.float32),
        tts_adapter_layers=2, **kw)

    def conv(cls, obj):
        names = {f.name for f in dataclasses.fields(cls)} - {"dtype", "param_dtype"}
        return cls(**{n: getattr(obj, n) for n in names if hasattr(obj, n)}, dtype=torch.float32)

    tcfg = ts2s.S2SConfig(
        llm=dataclasses.replace(conv(tllm.LLMConfig, jcfg.llm), remat=False),
        vocab=ts2s.VocabConfig(**dataclasses.asdict(vocab)), encoder_name="whisper",
        encoder=conv(twhisper.WhisperEncoderConfig, jcfg.encoder), projector="linear",
        projector_cfg=conv(tproj.ProjectorConfig, jcfg.projector_cfg),
        **{k: v for k, v in kw.items()}, tts_adapter_layers=2)
    return jcfg, tcfg


def _batch(corpus, vocab=None, rows=(0, 1, 3)):
    ds = jds_mod.S2SDatasetJsonl(_ds_config(corpus, vocab or JV), _JTok(), "train")
    return ds.collator([ds[i] for i in rows])


def _pair(corpus, seed=0, vocab=None, **kw):
    """A JAX model with its params and the port model with the same weights."""
    jcfg, tcfg = _configs(vocab, **kw)
    batch = _batch(corpus, vocab)
    jmodel = js2s.S2SModel(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
    params = {"params": nn.meta.unbox(jmodel.init(jax.random.PRNGKey(seed), jb, method="init_all")["params"])}
    # a nonzero group-decode bias, so the test sees it
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.05 if "group_decode_adapter" in jax.tree_util.keystr(p) and x.ndim == 1 else x, params)
    tmodel = ts2s.S2SModel(tcfg, device="cpu")
    tmodel.load_state_dict(from_flax_params(jax.device_get(params["params"]), tcfg), strict=True)
    tb = {k: torch.as_tensor(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
    return jmodel, params, tmodel.eval(), jb, tb


VARIANTS = {"plain": {}, "group_decode": {"group_decode": True}, "tts_adapter": {"tts_adapter": True}}


@pytest.fixture(scope="module")
def pairs(corpus):
    return {name: _pair(corpus, i, **kw) for i, (name, kw) in enumerate(VARIANTS.items())}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_parts_match_jax(pairs, variant):
    jmodel, params, tmodel, jb, tb = pairs[variant]
    want = jmodel.apply(params, jb)
    with torch.no_grad():
        got = tmodel(tb)
    for key in ("loss", "text_loss", "audio_loss", "acc", "audio_acc"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5, atol=1e-6, err_msg=key)
    assert got["audio_loss"].shape == (JV.code_layer,)


def test_asr_task_trains_the_text_head_alone(corpus):
    jmodel, params, tmodel, jb, tb = _pair(corpus, task_type="asr")
    with torch.no_grad():
        got = tmodel(tb)
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(jmodel.apply(params, jb)["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["loss"].numpy(), got["text_loss"].numpy())


@pytest.mark.parametrize("variant", ["group_decode", "tts_adapter"])
def test_gradients_match_jax(pairs, variant):
    """Every tensor but the frozen encoder's: the LLM (its embedding and
    narrow head), the projector, the group-decode adapter or the TTS
    adapter's blocks, norm and head."""
    jmodel, params, tmodel, jb, tb = pairs[variant]
    grads = jax.grad(lambda p: jmodel.apply(p, jb)["loss"])(params)["params"]
    want = flax_to_state_dict({k: v for k, v in jax.device_get(grads).items() if k != "encoder"})
    named = {n: p for n, p in tmodel.named_parameters() if not n.startswith("encoder.")}
    for p in named.values():
        p.requires_grad_(True)
    try:
        got = dict(zip(named, torch.autograd.grad(tmodel(tb)["loss"], list(named.values()), allow_unused=True)))
    finally:
        for p in named.values():
            p.requires_grad_(False)
    assert set(got) == set(want)
    assert any(n.startswith("group_decode_adapter" if variant == "group_decode" else "tts_adapter_1") for n in got)
    for name, g in got.items():
        w = want[name].numpy()
        scale = max(float(np.abs(w).max()), 1e-6)
        err = 0.0 if g is None and not np.abs(w).max() else float((g.numpy() - w).__abs__().max())
        assert err <= 1e-4 * scale, (name, err, scale)


def test_trick_partitions_match_jax(pairs):
    """train_embed_only / train_audio_embed_only train the lm_head alone;
    train_embed adds it to the usual policy (freeze_llm here)."""
    _, params, tmodel, _, _ = pairs["plain"]
    host = jax.device_get(params)
    for flags in ({}, {"train_embed_only": True}, {"train_audio_embed_only": True},
                  {"train_embed": True, "freeze_llm": True}):
        jcfg, tcfg = _configs(**flags)
        # each leaf labelled by the JAX package, then carried to the port's names
        labels = jax.tree_util.tree_map_with_path(
            lambda p, x: np.full(np.shape(x), float(jopt.param_label(jopt._path_str(p), jcfg) == "train"),
                                 np.float32), host)["params"]
        flat = flax_to_state_dict({k: v for k, v in labels.items() if k != "encoder"})
        flat.update({f"encoder.{k}": v for k, v in flax_to_state_dict(labels["encoder"]).items()})
        jnames = {n for n, a in flat.items() if bool(a.reshape(-1)[0])}
        tnames = {n for n, _ in tmodel.named_parameters() if topt.param_label(n, tcfg) == "train"}
        assert tnames == jnames, (flags, tnames ^ jnames)
        if flags.get("train_embed_only"):
            assert tnames == {"llm.lm_head.weight"}


def test_partial_embed_grad_mask_matches_jax():
    """The update mask on a full-vocabulary head and embedding; a narrower
    head (group decode's) is left unmasked in both packages."""
    v = TV
    d = 4
    tree = {"params": {"llm": {"lm_head": {"kernel": jnp.ones((d, v.total_vocabsize))},
                               "embed_tokens": {"embedding": jnp.ones((v.total_vocabsize, d))},
                               "narrow": {"lm_head": {"kernel": jnp.ones((d, v.total_vocabsize - 1))}}}}}
    tx = jopt.partial_embed_grad_mask(v.padded_text_vocabsize, v.total_vocabsize)
    upd, _ = tx.update(tree, tx.init(tree))
    masks = topt.partial_embed_grad_mask(
        {"llm.lm_head.weight": torch.ones(v.total_vocabsize, d), "llm.embed_tokens.weight":
         torch.ones(v.total_vocabsize, d), "llm.narrow.lm_head.weight": torch.ones(v.total_vocabsize - 1, d)},
        v.padded_text_vocabsize, v.total_vocabsize)
    np.testing.assert_array_equal(np.asarray(upd["params"]["llm"]["lm_head"]["kernel"]).T,
                                  masks["llm.lm_head.weight"].expand(-1, d).numpy())
    np.testing.assert_array_equal(np.asarray(upd["params"]["llm"]["embed_tokens"]["embedding"]),
                                  masks["llm.embed_tokens.weight"].expand(-1, d).numpy())
    assert "llm.narrow.lm_head.weight" not in masks


def test_train_audio_embed_only_moves_the_audio_columns_alone(corpus):
    """Two trainer steps: the head's audio vocabulary rows move, its text
    rows and every other tensor stay."""
    from slam_llm_tpu_torch.config import RunConfig
    from slam_llm_tpu_torch.train.state import Trainer

    _, _, tmodel, _, tb = _pair(corpus, train_audio_embed_only=True)
    tc = RunConfig().train_config
    tc.warmup_steps, tc.lr, tc.frozen_dtype = 1, 1e-2, "float32"
    before = {n: t.clone() for n, t in tmodel.state_dict().items()}
    trainer = Trainer(tmodel, tmodel.cfg, tc).state_from_params()
    assert list(trainer.trainable) == ["llm.lm_head.weight"]
    for _ in range(2):
        trainer.train_step(tb)
    head = tmodel.llm.lm_head.weight
    ptv = TV.padded_text_vocabsize
    assert torch.equal(head[:ptv], before["llm.lm_head.weight"][:ptv])
    assert not torch.equal(head[ptv:], before["llm.lm_head.weight"][ptv:])
    assert all(torch.equal(t, before[n]) for n, t in tmodel.state_dict().items() if n != "llm.lm_head.weight")


@pytest.mark.parametrize("variant", ["group_decode", "tts_adapter"])
def test_trainable_checkpoints_carry_the_s2s_tree_both_ways(pairs, variant, tmp_path):
    """With freeze_llm false the trainable tree holds the whole LLM (the
    full-vocabulary embedding, the narrow head), the projector and the
    adapters: the JAX package's model.msgpack loads into the port, the
    port's model.msgpack into the JAX package, and model.pt round-trips."""
    from slam_llm_tpu.utils.checkpoint import load_trainable_into as j_load_trainable_into
    from slam_llm_tpu.utils.checkpoint import save_trainable as j_save_trainable
    from slam_llm_tpu_torch.utils import checkpoint as tckpt

    jmodel, params, tmodel, _, _ = pairs[variant]
    jcfg, tcfg = jmodel.cfg, tmodel.cfg
    jtrain = jopt.partition_params(params["params"], jcfg)[0]
    j_save_trainable(str(tmp_path / "j" / "model.msgpack"), jtrain)
    trainable = {n: p for n, p in tmodel.named_parameters() if topt.param_label(n, tcfg) == "train"}
    assert "llm.embed_tokens.weight" in trainable and "llm.lm_head.weight" in trainable
    fresh = ts2s.S2SModel(tcfg, device="cpu")
    tckpt.load_trainable_into(fresh, str(tmp_path / "j"))
    got = fresh.state_dict()
    for name in trainable:
        assert torch.equal(got[name], tmodel.state_dict()[name]), name
    tckpt.save_trainable_msgpack(str(tmp_path / "t" / "model.msgpack"), trainable, "whisper")
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params["params"])
    loaded = j_load_trainable_into(zeros, str(tmp_path / "t" / "model.msgpack"))
    for (path, x), (_, y), (_, t) in zip(jax.tree_util.tree_leaves_with_path(loaded),
                                         jax.tree_util.tree_leaves_with_path(params["params"]),
                                         jax.tree_util.tree_leaves_with_path(jtrain, is_leaf=lambda a: a is None)):
        assert np.array_equal(np.asarray(x), np.asarray(y) if t is not None else np.zeros_like(y)), path
    tckpt.save_trainable(str(tmp_path / "pt" / "model.pt"), trainable)
    again = ts2s.S2SModel(tcfg, device="cpu")
    tckpt.load_trainable_into(again, str(tmp_path / "pt"))
    assert all(torch.equal(again.state_dict()[n], t) for n, t in trainable.items())


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------


GEN = {
    "group_decode, penalized": ("group_decode", dict(text_repetition_penalty=1.3, audio_repetition_penalty=1.2)),
    "tts_adapter, greedy": ("tts_adapter", {}),
    "plain, latency 2": ("plain", dict(num_latency_tokens=2, audio_repetition_penalty=1.5)),
}


@pytest.mark.parametrize("case", list(GEN))
def test_generation_tokens_match_jax(pairs, case):
    variant, kw = GEN[case]
    jmodel, params, tmodel, jb, tb = pairs[variant]
    keys = ("input_ids", "attention_mask", "modality_mask", "audio_mel", "audio_mel_mask")
    want = js2s.S2SGenerator(jmodel, max_new_tokens=7, **kw).generate(params, {k: jb[k] for k in keys})
    gen = ts2s.S2SGenerator(tmodel, max_new_tokens=7, **kw)
    got = gen.generate({k: tb[k] for k in keys})
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, JV.code_layer + 1, 7) and gen.stats["decode_steps"] == 7
    if case == "group_decode, penalized":  # the chunks of the stream are the same tokens
        chunks = list(gen.stream_generate({k: tb[k] for k in keys}, stream_stride=3, max_new_tokens=7))
        assert [c["text_tokens"].shape[1] for c in chunks] == [3, 3, 1]
        np.testing.assert_array_equal(np.concatenate([c["audio_tokens"] for c in chunks], -1), got[:, :JV.code_layer])


def test_generation_stops_at_text_and_audio_eos(pairs):
    """A head biased to EOT and EOA: every row ends after one step."""
    _, _, tmodel, _, tb = pairs["plain"]
    with torch.no_grad():
        bias = torch.zeros(tmodel.llm.lm_head.weight.shape[0])
        bias[TV.eot] = 1e4
        for layer in range(TV.code_layer):
            bias[TV.layershift(TV.eoa, layer)] = 1e4
        tmodel.llm.lm_head.bias = torch.nn.Parameter(bias, requires_grad=False)
    try:
        gen = ts2s.S2SGenerator(tmodel, max_new_tokens=5)
        out = gen.generate({k: v for k, v in tb.items() if k != "labels"})
    finally:
        tmodel.llm.lm_head.bias = None
    assert gen.stats["decode_steps"] == 1 and (out[:, TV.code_layer, 0] == TV.eot).all()
    assert (out[:, :TV.code_layer, 0] == TV.eoa).all() and (out[:, :TV.code_layer, 1:] == TV.pad_a).all()


def test_trim_generated_matches_jax():
    rng = np.random.default_rng(0)
    v, L = TV, TV.code_layer
    cases = []
    for kind in ("last", "any", "none", "empty"):
        tok = rng.integers(0, v.audio_vocabsize, (L + 1, 12))
        tok[L, 7] = v.eot
        if kind == "last":
            tok[L - 1, 9] = v.eoa
        elif kind == "any":
            tok[0, 6] = v.eoa
        elif kind == "none":
            tok[:L, 10:] = v.pad_a
        else:
            tok[:L] = v.pad_a
        cases.append(tok)
    for tok in cases:
        for a, b in zip(ts2s.trim_generated(tok, v), js2s.trim_generated(tok, JV)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------


def _run_cfg(manifest, tmp, code_layer=3, **extra):
    from slam_llm_tpu_torch.config import RunConfig

    cfg = RunConfig()
    mc, dc = cfg.model_config, cfg.dataset_config
    mc.file = "examples/s2s/model/slam_model_s2s.py:model_factory"
    mc.llm_name, mc.encoder_name, mc.encoder_config = "tiny-test", "whisper", "whisper-tiny-test"
    mc.encoder_projector, mc.encoder_projector_ds_rate = "linear", 5
    mc.text_vocabsize, mc.code_layer = 64, code_layer  # the factory reads both off the model config
    dc.file = "slam_llm_tpu.data.s2s_dataset:get_s2s_dataset"
    dc.val_data_path, dc.mel_size, dc.max_audio_length_s, dc.prompt = str(manifest), 8, 1.0, "Answer."
    dc.text_vocabsize, dc.code_layer = 64, code_layer
    cfg.decode_config.max_new_tokens, cfg.decode_config.decode_log = 12, str(tmp / "decode")
    for k, v in extra.items():
        obj, leaf = cfg, k.split(".")
        for part in leaf[:-1]:
            obj = getattr(obj, part)
        setattr(obj, leaf[-1], v)
    return cfg


def _jax_session(tsession, params):
    """The JAX package's session over the same weights (its constructor's
    factory and mesh are not what is under test)."""
    import contextlib

    from slam_llm_tpu.pipeline.generate_s2s import S2SSession as JSession

    tc = tsession.model.cfg

    def conv(cls, obj):
        names = {f.name for f in dataclasses.fields(cls)} - {"dtype", "param_dtype"}
        return cls(**{n: getattr(obj, n) for n in names if hasattr(obj, n)}, dtype=jnp.float32)

    jcfg = js2s.S2SConfig(llm=conv(JLLMConfig, tc.llm), vocab=js2s.VocabConfig(**dataclasses.asdict(tc.vocab)),
                          encoder=conv(JWhisperConfig, tc.encoder), projector_cfg=conv(JProjectorConfig,
                                                                                        tc.projector_cfg),
                          group_decode=tc.group_decode)
    s = object.__new__(JSession)
    dc = tsession.cfg.decode_config
    s.model, s.tokenizer, s.vocab = js2s.S2SModel(jcfg), _JTok(), jcfg.vocab
    s.mesh, s.codec, s.history, s.cfg = contextlib.nullcontext(), None, "", None
    s.mel_size, s.max_audio_s, s.fix_length_audio, s.system_prompt = 8, 1.0, -1, "Answer."
    s.gen = js2s.S2SGenerator(s.model, max_new_tokens=dc.max_new_tokens,
                              text_repetition_penalty=dc.text_repetition_penalty,
                              audio_repetition_penalty=dc.audio_repetition_penalty)
    s.params = params
    s._ensure_params = lambda b: params
    return s


def _flax_params(tmodel):
    from slam_llm_tpu_torch.utils.convert import trainable_to_flax

    return {"params": jax.tree_util.tree_map(jnp.asarray, trainable_to_flax(
        {n: t.float() for n, t in tmodel.state_dict().items()}, "whisper"))}


@pytest.fixture
def f32_factory(monkeypatch):
    """The recipe factory's tiny presets in f32, so the drivers' tokens can
    be compared with the JAX package's exactly."""
    import functools

    small = tllm.LLMConfig.tiny_test
    monkeypatch.setattr(tllm.LLMConfig, "tiny_test", staticmethod(lambda: dataclasses.replace(
        small(), dtype=torch.float32)))
    monkeypatch.setitem(twhisper.PRESETS, "whisper-tiny-test", lambda: dataclasses.replace(
        twhisper.WhisperEncoderConfig.tiny_test(), dtype=torch.float32))
    monkeypatch.setattr(ts2s, "ProjectorConfig", functools.partial(tproj.ProjectorConfig, dtype=torch.float32))


@pytest.fixture
def tiny_codec(monkeypatch, tmp_path):
    """A tiny CosyVoice pair on disk, loaded at its own widths."""
    from slam_llm_tpu_torch.models import cosyvoice_flow as tflow
    from slam_llm_tpu_torch.models import hift as thift
    from slam_llm_tpu_torch.tools import synth_checkpoint as synth

    # the published 4096 speech tokens, so no generated token reads as EOA
    f, h = dataclasses.replace(tflow.FlowConfig.tiny_test(), vocab_size=4096), thift.HiFTConfig.tiny_test()
    synth.write_cosyvoice(str(tmp_path / "cosyvoice"), f, h, seed=1)
    monkeypatch.setattr(tflow, "FlowConfig", lambda: f)
    monkeypatch.setattr(thift, "HiFTConfig", lambda: h)
    return str(tmp_path / "cosyvoice"), lambda tokens: int(tokens / f.input_frame_rate * f.mel_sr / f.mel_hop) * \
        h.upsample_total


def test_batch_driver_writes_pred_gt_and_wavs_as_jax(corpus, tmp_path, tiny_codec, f32_factory):
    """``pipeline.generate_s2s`` in batch mode from the recipe's own specs
    (factory and dataset), f32, with the CosyVoice codec: the same
    ``_pred`` / ``_gt`` as the JAX package's ``run_batch`` over the same
    weights, and a wav per utterance of 3 x frames tokens' length."""
    from slam_llm_tpu.pipeline.generate_s2s import run_batch as j_run_batch
    from slam_llm_tpu_torch.pipeline import generate_s2s as tgen

    path, samples_of = tiny_codec
    cfg = _run_cfg(corpus, tmp_path, **{"decode_config.mode": "batch", "model_config.codec_decoder_type": "CosyVoice",
                                        "model_config.codec_decoder_path": path})
    session = tgen.S2SSession(cfg, device="cpu")
    session.tokenizer = _Tok()
    res = tgen.run_batch(session, cfg)
    assert res["n"] == 5 and len(res["utterances"]) == 5 and res["audio_seconds"] == pytest.approx(2.7)
    for u in res["utterances"]:
        assert u["decode_steps"] >= 1 and u["prompt_len"] > 0
        if u["audio_frames"] > 8:
            assert u["samples"] == samples_of(3 * u["audio_frames"]), u
            assert os.path.getsize(f"{res['wav_dir']}/{u['key']}.wav") == 44 + 2 * u["samples"]
    jcfg = _run_cfg(corpus, tmp_path / "jax")
    jcfg.decode_config.decode_log = str(tmp_path / "jdecode")
    from slam_llm_tpu.config import RunConfig as JRunConfig

    jrun = JRunConfig()
    jrun.dataset_config.file = "slam_llm_tpu.data.s2s_dataset:get_s2s_dataset"
    jrun.dataset_config.val_data_path, jrun.dataset_config.mel_size = str(corpus), 8
    jrun.dataset_config.max_audio_length_s, jrun.dataset_config.prompt = 1.0, "Answer."
    jrun.dataset_config.text_vocabsize, jrun.dataset_config.code_layer = 64, 3
    jrun.decode_config.decode_log = str(tmp_path / "jdecode")
    j_run_batch(_jax_session(session, _flax_params(session.model)), jrun)
    for suffix in ("_pred", "_gt"):
        assert Path(res[suffix[1:]]).read_text() == (tmp_path / f"jdecode{suffix}").read_text()


def test_online_rounds_and_stream_match_jax(corpus, tmp_path, f32_factory):
    """A text round, a wav round threading the history (online multi-round
    through ``run_online``), then ``stream_round``: the texts of the JAX
    package's rounds over the same weights."""
    from slam_llm_tpu_torch.pipeline import generate_s2s as tgen

    cfg = _run_cfg(corpus, tmp_path, **{"decode_config.mode": "online_multi_round"})
    session = tgen.S2SSession(cfg, device="cpu")
    session.tokenizer = _Tok()
    wav = str(corpus.parent / "q1.wav")
    texts = tgen.run_online(session, cfg, multi_round=True, stream=False, lines=["t:hello there", wav, ""])
    jsession = _jax_session(session, _flax_params(session.model))
    want = [jsession.run_round(None, "hello there", keep_history=True)[0],
            jsession.run_round(wav, None, keep_history=True)[0]]
    assert texts == want and session.history == jsession.history
    pieces = [t for t, _ in session.stream_round(wav, stream_stride=5)]
    assert "".join(pieces).strip() == jsession.run_round(wav, None)[0]  # a round strips its text


def test_online_round_batch_is_the_datasets_inference_item(corpus, tmp_path):
    """The online drivers and the batch driver frame a spoken question
    alike: with no prompt configured both take ``DEFAULT_S2S_PROMPT``, and
    a wav round's batch is the dataset's inference item, left-padded."""
    from slam_llm_tpu_torch.pipeline import generate_s2s as tgen

    cfg = _run_cfg(corpus, tmp_path)
    cfg.dataset_config.prompt = None
    session = tgen.S2SSession(cfg, device="cpu")
    session.tokenizer = _Tok()
    assert session.system_prompt == tds_mod.DEFAULT_S2S_PROMPT
    cfg.dataset_config.inference_mode = True
    item = tds_mod.S2SDatasetJsonl(cfg.dataset_config, _Tok(), "test")[1]
    batch = session._round_batch(str(corpus.parent / "q1.wav"), None)
    t = item["input_ids"].shape[1]
    left = batch["input_ids"].shape[2] - t
    assert left >= 0 and not batch["attention_mask"][0, :left].any()
    want = tgen.item_batch(item)
    np.testing.assert_array_equal(batch["input_ids"][:, :, left:], want["input_ids"])
    np.testing.assert_array_equal(batch["modality_mask"][:, left:], want["modality_mask"])
    np.testing.assert_array_equal(batch["audio_mel"], want["audio_mel"])


def test_snac_stream_round_writes_chunks(corpus, tmp_path, monkeypatch):
    """code_layer 7 with a (narrow) SNAC: ``run_online`` in stream mode
    writes the round's wav from the chunks' windows: 4 latent steps (the
    finest codebook's) of 8 samples a 7-token frame at this width."""
    from slam_llm_tpu_torch.models import snac as tsnac
    from slam_llm_tpu_torch.pipeline import generate_s2s as tgen
    from slam_llm_tpu_torch.tools import synth_checkpoint as synth

    narrow = tsnac.SNACConfig(decoder_dim=32, decoder_rates=(4, 2), latent_dim=16, codebook_dim=4)
    synth.write_snac(str(tmp_path / "snac.pt"), narrow, seed=2)
    monkeypatch.setattr(tsnac.SNACConfig, "snac_24khz", staticmethod(lambda: narrow))
    cfg = _run_cfg(corpus, tmp_path, code_layer=7, **{"decode_config.mode": "online_stream",
                                                       "decode_config.stream_stride": 4,
                                                       "model_config.codec_decoder_path": str(tmp_path / "snac.pt")})
    cfg.decode_config.max_new_tokens = 20
    session = tgen.S2SSession(cfg, device="cpu")
    out_dir = tmp_path / "online"
    cfg.decode_config.decode_log = str(out_dir)
    # the audio streams never end early at random weights: 20 steps, 13 frames
    chunks = list(session.stream_round(text_input="hi", stream_stride=4))
    assert len(chunks) == 5
    wavs = [w for _, w in chunks if w is not None]
    assert sum(len(w) for w in wavs) == 13 * 4 * 8
    tgen.run_online(session, cfg, multi_round=False, stream=True, lines=["t:hi", ""])
    assert os.path.getsize(out_dir / "round0.wav") == 44 + 2 * 13 * 4 * 8


def test_a_codec_that_does_not_load_or_decode_raises(corpus, tmp_path, monkeypatch):
    from slam_llm_tpu_torch.pipeline import generate_s2s as tgen
    from slam_llm_tpu_torch.utils.codec_utils import CodecDecoder

    for ctype, path in (("CosyVoice", str(tmp_path / "missing")), ("SNAC", str(tmp_path / "missing.pt")),
                        ("Vocos", str(tmp_path))):
        cfg = _run_cfg(corpus, tmp_path, **{"model_config.codec_decoder_type": ctype,
                                            "model_config.codec_decoder_path": path})
        with pytest.raises((FileNotFoundError, ValueError)):
            tgen.S2SSession(cfg, device="cpu")
    session = tgen.S2SSession(_run_cfg(corpus, tmp_path), device="cpu")

    def broken(self, streams, **kw):
        raise RuntimeError("vocoder failed")

    monkeypatch.setattr(CodecDecoder, "decode", broken)
    session.codec = CodecDecoder(codec_type="cosyvoice")
    with pytest.raises(RuntimeError, match="vocoder failed"):
        for _ in range(3):  # a random model's first rounds may end before 9 frames
            session.run_round(text_input="hello")


_SPEC_PROBE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from slam_llm_tpu_torch.config import load_run_config
from slam_llm_tpu_torch.registry import get_custom_dataset_factory, get_custom_model_factory
cfg = load_run_config(["--config", sys.argv[2]])
model_factory = get_custom_model_factory(cfg.model_config)
dataset_factory = get_custom_dataset_factory(cfg.dataset_config)
banned = ("jax", "jaxlib", "flax", "slam_llm_tpu", "transformers", "safetensors", "msgpack")
print(json.dumps({"model": model_factory.__module__ + ":" + model_factory.__name__,
                  "dataset": dataset_factory.__module__ + ":" + dataset_factory.__name__,
                  "imported": sorted(m for m in sys.modules if m.split(".")[0] in banned)}))
"""


def test_recipe_specs_resolve_in_a_fresh_interpreter_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _SPEC_PROBE, str(REPO), str(REPO / "examples/s2s/conf/s2s_qwen.yaml")],
                         capture_output=True, text=True, env=env, timeout=300, check=True, cwd=str(REPO))
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"model": "slam_llm_tpu_torch.models.s2s:model_factory",
                   "dataset": "slam_llm_tpu_torch.data.s2s_dataset:get_s2s_dataset", "imported": []}


@pytest.mark.parametrize("d", [16, 40, 64, 80, 96, 128, 192, 256])
def test_flash_head_dim_routes_as_jax(d):
    """Structured attention takes the flash kernels at D 64, 128, 192 and
    256, where the JAX package takes Pallas, and the plain path wherever D
    % 64 != 0, where the JAX package runs XLA (``_should_use_pallas``)."""
    from slam_llm_tpu_torch.models.layers import flash_head_dim
    from slam_llm_tpu_torch.ops.kernels.flash_attention import HEAD_DIMS

    assert flash_head_dim(d) is (d % 64 == 0)
    assert (d in HEAD_DIMS) is (d % 64 == 0)
