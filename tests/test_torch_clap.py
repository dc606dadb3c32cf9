"""CLAP, BERT, HTSAT, Cnn14, FENSE, CLAP-Refine and DRCap in the port against the JAX package, on the CPU.

Tiny sizes, f32, weights and inputs from numpy seeds carried across with
``utils.convert``; atol 1e-5 / rtol 1e-4 unless a test says otherwise. No
test here imports transformers.

* ``BertEncoder`` with a ragged key mask and an all-masked row;
  ``resize_bicubic_align_corners`` at non-square and upsampling shapes;
  ``HTSAT`` (shifted windows, the resize of a short mel), ``Cnn14`` and
  ``CLAP`` (``encode_audio``, ``encode_text``, the InfoNCE loss, both
  towers); ``convert_ase_torch_state`` on one ``write_clap`` file;
* ``WordPieceTokenizer`` ids; ``FenseScorer`` ``embed`` /
  ``fluency_errors`` / ``score`` on ``write_sbert`` / ``write_echecker``
  files, and the head count read from ``config.json``;
* ``clap_refine`` selections, ``clap_refine_with_model`` at tiny size
  against the JAX CLAP; the five DRCap functions, a JAX-written store
  included;
* the ``hf-text`` SLAMModel (loss, gradients, greedy and beam tokens through
  the generator's text keys) and the encoder-less one (DRCap's latents:
  spliced embeddings, loss, projector gradient), the DRCap slice as a whole
  (RAG manifest -> collation + latents -> loss and projector gradient);
* the AAC items' true ``audio_seconds`` for the RTF; ``drcap.yaml`` over a
  ``.npy`` manifest raises at the projector; ``tools/profile_train.py
  --recipe drcap`` builds on the CPU.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_corpus, write_wav
from test_torch_wavlm import _flat, _seeded

from slam_llm_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from slam_llm_tpu.inference.generate import GenerationConfig as JGenerationConfig
from slam_llm_tpu.inference.generate import Generator as JGenerator
from slam_llm_tpu.models import bert as jbert
from slam_llm_tpu.models import clap as jclap
from slam_llm_tpu.models import cnn14 as jcnn14
from slam_llm_tpu.models import htsat as jhtsat
from slam_llm_tpu.models import vit as jvit
from slam_llm_tpu.models.llm import LLMConfig as JLLMConfig
from slam_llm_tpu.models.projector import ProjectorConfig as JProjectorConfig
from slam_llm_tpu.models.slam_model import SLAMConfig as JSLAMConfig
from slam_llm_tpu.models.slam_model import SLAMModel as JSLAMModel
from slam_llm_tpu.ops.torch_port import resize_bicubic_align_corners as j_resize
from slam_llm_tpu.train.optimizer import merge_params as j_merge
from slam_llm_tpu.train.optimizer import partition_params as j_partition
from slam_llm_tpu.utils import clap_refine as jrefine
from slam_llm_tpu.utils import drcap as jdrcap
from slam_llm_tpu.utils import fense as jfense
from slam_llm_tpu_torch.data.tokenizer import ByteTokenizer
from slam_llm_tpu_torch.inference.generate import GenerationConfig, Generator
from slam_llm_tpu_torch.models import bert as tbert
from slam_llm_tpu_torch.models import clap as tclap
from slam_llm_tpu_torch.models import cnn14 as tcnn14
from slam_llm_tpu_torch.models import htsat as thtsat
from slam_llm_tpu_torch.models import llm as tllm
from slam_llm_tpu_torch.models import projector as tproj
from slam_llm_tpu_torch.models import slam_model as tslam
from slam_llm_tpu_torch.models import vit as tvit
from slam_llm_tpu_torch.ops.resize import resize_bicubic_align_corners
from slam_llm_tpu_torch.tools import synth_checkpoint as synth
from slam_llm_tpu_torch.train.optimizer import partition_params
from slam_llm_tpu_torch.utils import clap_refine as trefine
from slam_llm_tpu_torch.utils import convert
from slam_llm_tpu_torch.utils import drcap as tdrcap
from slam_llm_tpu_torch.utils import fense as tfense

REPO = Path(__file__).resolve().parent.parent
EOS, PAD = 2, 0
TOL = dict(atol=1e-5, rtol=1e-4)
# HTSAT at tiny width with a shifted second block in its first stage
# (8 x 8 patches, window 4) and a 4 x 4 second stage (no shift)
HTSAT_SHIFT = jhtsat.HTSATConfig(spec_size=32, patch_size=4, patch_stride=4, num_classes=6, embed_dim=8,
                                 depths=(2, 2), num_heads=(2, 2), window_size=4, n_mels=8)


def _same(jcfg, cls):
    """The port's dataclass ``cls`` with the JAX config's field values."""
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {n: getattr(jcfg, n) for n in names if hasattr(jcfg, n) and n not in ("dtype", "param_dtype")}
    for n in ("htsat", "cnn14", "bert"):
        if n in kw:
            kw[n] = _same(kw[n], {"htsat": thtsat.HTSATConfig, "cnn14": tcnn14.Cnn14Config,
                                  "bert": tbert.BertConfig}[n])
    if kw.get("vit") is not None:
        kw["vit"] = dataclasses.replace(_same(kw["vit"], tvit.ViTEncoderConfig), dtype=torch.float32)
    return cls(**kw)


def _params(module, *args, seed=0, method=None):
    """numpy-seeded params of a JAX module (``_seeded``'s draws)."""
    variables = module.init(jax.random.PRNGKey(0), *args, **({"method": method} if method else {}))
    return _seeded(variables["params"], seed)


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


def test_bert_matches_jax():
    """Ragged key masks: row 1 keeps 5 keys, row 2 none (the -1e9 mask then
    shifts every score alike, as in JAX); token types on row 0."""
    cfg = jbert.BertConfig.tiny_test()
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.vocab_size, (3, 11))
    mask = np.ones((3, 11), np.int32)
    mask[1, 5:] = 0
    mask[2] = 0
    types = np.zeros((3, 11), np.int32)
    types[0, 6:] = 1
    params = _params(jbert.BertEncoder(cfg), jnp.asarray(ids), jnp.asarray(mask), seed=2)
    want = jbert.BertEncoder(cfg).apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(types))
    tm = tbert.BertEncoder(_same(cfg, tbert.BertConfig))
    tm.load_state_dict(convert.bert_from_flax(params, cfg.n_layers))
    got = tm(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(types))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape,out", [((2, 1, 100, 8), (128, 8)), ((1, 3, 7, 5), (20, 11)), ((1, 1, 6, 6), (6, 6))])
def test_resize_bicubic_matches_jax(shape, out):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(j_resize(jnp.asarray(x), *out))
    got = _np(resize_bicubic_align_corners(torch.from_numpy(x), *out))
    assert got.shape == shape[:2] + out
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("t", [128, 90])  # the exact target, and a short mel the resize stretches
def test_htsat_matches_jax(t):
    cfg = HTSAT_SHIFT
    mel = np.random.default_rng(3).standard_normal((2, t, cfg.n_mels)).astype(np.float32)
    params = _params(jhtsat.HTSAT(cfg), jnp.asarray(mel), seed=4)
    want = jhtsat.HTSAT(cfg).apply({"params": params}, jnp.asarray(mel))
    tm = thtsat.HTSAT(_same(cfg, thtsat.HTSATConfig))
    tm.load_state_dict(convert.htsat_from_flax(params, cfg.depths))
    assert tm.layers[0].blocks[1].shift == 2 and tm.layers[1].blocks[1].shift == 0
    got = tm(torch.from_numpy(mel))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(_np(got[key]), np.asarray(want[key]), **TOL, err_msg=key)


def test_cnn14_matches_jax():
    cfg = jcnn14.Cnn14Config(base_channels=2)
    mel = np.random.default_rng(5).standard_normal((2, 130, 64)).astype(np.float32)
    params = _params(jcnn14.Cnn14(cfg), jnp.asarray(mel), seed=6)
    want = jcnn14.Cnn14(cfg).apply({"params": params}, jnp.asarray(mel))
    tm = tcnn14.Cnn14(tcnn14.Cnn14Config(base_channels=2))
    tm.load_state_dict(convert.cnn14_from_flax(params))
    got = tm(torch.from_numpy(mel))
    assert got.shape == (2, 2, 64)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def _clap_batch(cfg, b=3, t=110):
    rng = np.random.default_rng(7)
    n_mels = {"htsat": cfg.htsat.n_mels, "cnn14": cfg.cnn14.mel_bins, "vit": cfg.vit and cfg.vit.n_mels}[cfg.audio_tower]
    mask = np.ones((b, 9), np.int32)
    mask[1, 4:] = 0
    return {"audio_mel": rng.standard_normal((b, t, n_mels)).astype(np.float32),
            "text_ids": rng.integers(-1, cfg.bert.vocab_size, (b, 9)), "text_mask": mask}


def _clap_pair(jcfg, seed=8):
    batch = _clap_batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = _params(jclap.CLAP(jcfg), jb, seed=seed, method="init_all")
    tcfg = _same(jcfg, tclap.CLAPConfig)
    tm = tclap.CLAP(tcfg).eval()
    tm.load_state_dict(convert.clap_from_flax(params, tcfg))
    return batch, params, tm


@pytest.mark.parametrize("tower", ["htsat", "cnn14", "vit"])
def test_clap_matches_jax(tower):
    """``encode_audio`` (HTSAT's fine-grained mean, Cnn14's time mean, the
    EAT ViT's token mean), ``encode_text`` (ids of -1 clamped to 0, a ragged
    mask) and the InfoNCE loss, accuracy and logits."""
    jcfg = dataclasses.replace(jclap.CLAPConfig.tiny_test(), audio_tower=tower, htsat=HTSAT_SHIFT,
                               cnn14=jcnn14.Cnn14Config(base_channels=2),
                               vit=dataclasses.replace(jvit.ViTEncoderConfig.tiny_test(), dtype=jnp.float32))
    batch, params, tm = _clap_pair(jcfg)
    jm, jb = jclap.CLAP(jcfg), {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        za, zt, out = tm.encode_audio(tb["audio_mel"]), tm.encode_text(tb["text_ids"], tb["text_mask"]), tm(tb)
    np.testing.assert_allclose(_np(za), np.asarray(jm.apply({"params": params}, jb["audio_mel"],
                                                            method="encode_audio")), **TOL)
    np.testing.assert_allclose(_np(zt), np.asarray(jm.apply({"params": params}, jb["text_ids"], jb["text_mask"],
                                                            method="encode_text")), **TOL)
    want = jm.apply({"params": params}, jb)
    np.testing.assert_allclose(float(out["loss"]), float(want["loss"]), rtol=1e-5)
    assert float(out["acc"]) == float(want["acc"])
    np.testing.assert_allclose(_np(out["logits"]), np.asarray(want["logits"]), atol=1e-4, rtol=1e-4)


def test_convert_ase_torch_state_matches_jax(tmp_path):
    """One ``write_clap`` file (the reference ASE key schema), read by both
    converters, with and without HTSAT's ``sed_model.`` prefix."""
    tcfg = dataclasses.replace(tclap.CLAPConfig.tiny_test(), htsat=_same(HTSAT_SHIFT, thtsat.HTSATConfig))
    jcfg = dataclasses.replace(jclap.CLAPConfig.tiny_test(), htsat=HTSAT_SHIFT)
    synth.write_clap(str(tmp_path / "clap.pt"), tcfg, seed=3)
    sd = torch.load(tmp_path / "clap.pt", weights_only=True)["model"]
    prefixed = {k.replace("audio_encoder.audio_enc.", "audio_encoder.audio_enc.sed_model."): v for k, v in sd.items()}
    torch.save({"state_dict": prefixed}, tmp_path / "prefixed.pt")
    batch = _clap_batch(jcfg, t=128)
    jm = jclap.CLAP(jcfg)
    want_a = np.asarray(jm.apply(jclap.convert_ase_torch_state(sd, jcfg), jnp.asarray(batch["audio_mel"]),
                                 method="encode_audio"))
    want_t = np.asarray(jm.apply(jclap.convert_ase_torch_state(sd, jcfg), jnp.asarray(batch["text_ids"]),
                                 jnp.asarray(batch["text_mask"]), method="encode_text"))
    for name in ("clap.pt", "prefixed.pt"):
        tm = tclap.load_clap(str(tmp_path / name), tcfg, device="cpu")
        with torch.no_grad():
            np.testing.assert_allclose(_np(tm.encode_audio(torch.from_numpy(batch["audio_mel"]))), want_a, **TOL)
            np.testing.assert_allclose(_np(tm.encode_text(torch.from_numpy(batch["text_ids"]),
                                                          torch.from_numpy(batch["text_mask"]))), want_t, **TOL)
    assert float(tm.temp.detach()) == pytest.approx(0.07)


# ---------------------------------------------------------------------------
# FENSE
# ---------------------------------------------------------------------------

TEXTS = ["A dog barks, loudly!", "rain falls on a metal roof", "zzqx unknownword", "the man's voice echoes...",
         "Birds chirp; wind blows", "a" * 120, "water"]


def test_wordpiece_matches_jax(tmp_path):
    synth.write_bert_vocab(str(tmp_path / "vocab.txt"), 3000, seed=1,
                           words=["dog", "barks", "rain", "falls", "man", "voice", "##s"])
    got, want = tfense.WordPieceTokenizer(str(tmp_path / "vocab.txt")), jfense.WordPieceTokenizer(
        str(tmp_path / "vocab.txt"))
    assert (got.pad_id, got.unk_id, got.cls_id, got.sep_id) == (0, 1, 2, 3)
    for text in TEXTS:
        assert got.encode(text, 16) == want.encode(text, 16), text
    for a, b in zip(got.batch(TEXTS, 12), want.batch(TEXTS, 12)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def fense_files(tmp_path_factory):
    """A tiny SBERT directory (64 wide, 1 head: d / 64 heads, which the JAX
    scorer assumes) and a tiny echecker checkpoint."""
    d = tmp_path_factory.mktemp("fense")
    cfg = tbert.BertConfig(vocab_size=400, d_model=64, n_layers=2, n_heads=1, ffn_dim=96, max_positions=64)
    synth.write_sbert(str(d / "sbert"), cfg, seed=1, words=" ".join(TEXTS).split())
    synth.write_echecker(str(d / "echecker.ckpt"), dataclasses.replace(cfg, n_layers=1), seed=2)
    return d


def test_fense_scorer_matches_jax(fense_files):
    """``embed``, ``fluency_errors`` and ``score`` at the default threshold
    (0.9) and at the median of the candidates' largest error probability,
    where the penalty falls on some candidates and not on others."""
    d = fense_files
    sbert, echecker = str(d / "sbert"), str(d / "echecker.ckpt")
    got, want = tfense.FenseScorer(sbert, echecker, device="cpu"), jfense.FenseScorer(sbert, echecker)
    np.testing.assert_allclose(got.embed(TEXTS), want.embed(TEXTS), **TOL)
    ids, mask = got._tokens(TEXTS)
    with torch.no_grad():
        probs = torch.sigmoid(got.echecker(ids, mask)[:, 0] @ got.head[0].T + got.head[1]).amax(-1)
    refs = [[TEXTS[(i + 1) % len(TEXTS)], TEXTS[i]] for i in range(len(TEXTS))]
    for threshold in (0.9, float(probs.median())):
        got.error_threshold = want.error_threshold = threshold
        flags = got.fluency_errors(TEXTS)
        assert flags == [bool(f) for f in want.fluency_errors(TEXTS)]
        assert got.score(TEXTS[::-1], refs) == pytest.approx(want.score(TEXTS[::-1], refs), abs=1e-5)
    assert 0 < sum(flags) < len(flags)


def test_fense_reads_the_head_count_of_config_json(tmp_path):
    """A 32-wide, 2-head SBERT: the port takes 2 heads from ``config.json``
    and matches ``BertEncoder`` with 2 heads (the JAX scorer assumes 1)."""
    cfg = tbert.BertConfig(vocab_size=200, d_model=32, n_layers=1, n_heads=2, ffn_dim=64, max_positions=64)
    synth.write_sbert(str(tmp_path), cfg, seed=4)
    scorer = tfense.FenseScorer(str(tmp_path), device="cpu")
    assert scorer.sbert.cfg == cfg and jfense._bert_cfg_from_state(
        jfense._strip_prefix(dict(scorer.sbert.state_dict()))).n_heads == 1
    from slam_llm_tpu_torch.utils.hf_loader import load_hf_state_dict

    ref = tbert.BertEncoder(cfg).eval()
    ref.load_state_dict(tbert.convert_bert_torch_state(load_hf_state_dict(str(tmp_path)), cfg))
    ids, mask = scorer.tokenizer.batch(TEXTS[:3])
    with torch.no_grad():
        h = ref(torch.from_numpy(ids), torch.from_numpy(mask))
    m = torch.from_numpy(mask)[..., None].float()
    z = (h * m).sum(1) / m.sum(1)
    np.testing.assert_allclose(scorer.embed(TEXTS[:3]), _np(z / z.norm(dim=-1, keepdim=True)), **TOL)


# ---------------------------------------------------------------------------
# CLAP-Refine and DRCap
# ---------------------------------------------------------------------------


def test_clap_refine_selects_as_jax(tmp_path):
    (tmp_path / "p_a").write_text("u1\tgood caption\nu2\tbad caption\nu1\tworse\n")
    (tmp_path / "p_b").write_text("u2\tbest caption\n\nu3\t\n")
    logs = [str(tmp_path / "p_a"), str(tmp_path / "p_b")]
    cands = trefine.read_candidates(logs)
    assert cands == jrefine.read_candidates(logs) == {
        "u1": ["good caption", "worse"], "u2": ["bad caption", "best caption"], "u3": [""]}
    rng = np.random.default_rng(0)
    vecs = {t: rng.standard_normal(4) for ts in cands.values() for t in ts}
    audio = {k: rng.standard_normal(4) for k in cands}
    args = (cands, lambda k: audio[k], lambda ts: np.stack([vecs[t] for t in ts]))
    sel = trefine.clap_refine(*args)
    assert sel == jrefine.clap_refine(*args)
    trefine.write_selection(sel, str(tmp_path / "ours"))
    jrefine.write_selection(sel, str(tmp_path / "theirs"))
    assert (tmp_path / "ours").read_text() == (tmp_path / "theirs").read_text()


def test_clap_refine_with_model_matches_jax(tmp_path):
    """The port's whole rerank at tiny size (a ``write_clap`` file, a
    ``write_bert_vocab`` vocabulary, 4 candidates a key over 3 clips, one
    key missing from the manifest) against the JAX CLAP on the JAX log-mel
    and tokenizer: the similarities within 1e-5, and the same choice on
    every key."""
    from slam_llm_tpu.ops import audio as jaudio

    tcfg = dataclasses.replace(tclap.CLAPConfig.tiny_test(), htsat=_same(HTSAT_SHIFT, thtsat.HTSATConfig))
    jcfg = dataclasses.replace(jclap.CLAPConfig.tiny_test(), htsat=HTSAT_SHIFT)
    synth.write_clap(str(tmp_path / "clap.pt"), tcfg, seed=5)
    captions = ["a dog barks", "rain falls", "a man speaks", "birds chirp", "an engine idles", "water runs"]
    synth.write_bert_vocab(str(tmp_path / "vocab.txt"), tcfg.bert.vocab_size, words=captions)
    with open(tmp_path / "m.jsonl", "w") as f:
        for i in range(3):
            write_wav(tmp_path / f"c{i}.wav", seconds=0.6 + 0.5 * i, freq=300 + 200 * i, seed=i)
            f.write(json.dumps({"key": f"c{i}", "source": str(tmp_path / f"c{i}.wav"), "target": "x"}) + "\n")
    with open(tmp_path / "pred", "w") as f:
        for i in range(4):
            for j in range(4):
                f.write(f"c{i}\t{captions[(i + j) % 6]}\n")
    sel = trefine.clap_refine_with_model([str(tmp_path / "pred")], str(tmp_path / "clap.pt"), str(tmp_path / "m.jsonl"),
                                         str(tmp_path / "refined"), cfg=tcfg, device="cpu")
    assert set(sel) == {"c0", "c1", "c2"} and (tmp_path / "refined").read_text().count("\n") == 3

    params = jclap.convert_ase_torch_state(torch.load(tmp_path / "clap.pt", weights_only=True)["model"], jcfg)
    jm, tok = jclap.CLAP(jcfg), jfense.WordPieceTokenizer(str(tmp_path / "vocab.txt"))
    target_t = jcfg.htsat.spec_size * jcfg.htsat.freq_ratio
    port = tclap.load_clap(str(tmp_path / "clap.pt"), tcfg, device="cpu")
    for i in range(3):
        mel = jaudio.log_mel_spectrogram(jaudio.load_audio(str(tmp_path / f"c{i}.wav")), n_mels=jcfg.htsat.n_mels)
        mel = np.pad(mel, ((0, max(0, target_t - mel.shape[0])), (0, 0)))[:target_t]
        np.testing.assert_array_equal(trefine.clip_mel(str(tmp_path / f"c{i}.wav"), tcfg), mel)
        za = np.asarray(jm.apply(params, jnp.asarray(mel[None]), method="encode_audio"))[0]
        texts = [captions[(i + j) % 6] for j in range(4)]
        ids, mask = tok.batch(texts, 64)
        zt = np.asarray(jm.apply(params, jnp.asarray(ids), jnp.asarray(mask), method="encode_text"))
        ours = tclap.embed_texts(port, tfense.WordPieceTokenizer(str(tmp_path / "vocab.txt")), texts)
        np.testing.assert_allclose(ours, zt, **TOL)
        sims = zt @ za
        assert np.sort(sims)[-1] - np.sort(sims)[-2] > 1e-4 and sel[f"c{i}"] == texts[int(np.argmax(sims))]


def test_drcap_functions_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    captions = [f"caption {i}" for i in range(10)]
    support = rng.standard_normal((10, 6)).astype(np.float32)
    support /= np.linalg.norm(support, axis=1, keepdims=True)
    z = np.concatenate([support[3:4], rng.standard_normal((2, 6)).astype(np.float32)])
    for temp in (0.07, 1.0):
        np.testing.assert_allclose(tdrcap.projection_decode(z, support, temp), jdrcap.projection_decode(z, support, temp),
                                   **TOL)
    for exclude in (False, True):
        assert tdrcap.retrieve_topk(z, support, captions, 3, exclude) == jdrcap.retrieve_topk(z, support, captions, 3,
                                                                                               exclude)
    assert "caption 3" not in tdrcap.retrieve_topk(z, support, captions, 3, True)[0]
    # encode_captions: the port's CLAP text tower and WordPiece, batches of 4, against the JAX one's
    jcfg = jclap.CLAPConfig.tiny_test()
    batch, params, tm = _clap_pair(jcfg, seed=9)
    synth.write_bert_vocab(str(tmp_path / "vocab.txt"), jcfg.bert.vocab_size, words=captions)
    tok = tfense.WordPieceTokenizer(str(tmp_path / "vocab.txt"))
    jtok = jfense.WordPieceTokenizer(str(tmp_path / "vocab.txt"))

    def hf_like(texts, padding, truncation, max_length, return_tensors):
        ids, mask = jtok.batch(texts, max_length)  # padded to the longest, as the port's
        return {"input_ids": ids, "attention_mask": mask}

    got = tdrcap.encode_captions(captions, lambda i, m: tm.encode_text(torch.from_numpy(i), torch.from_numpy(m)), tok,
                                 batch_size=4)
    want = jdrcap.encode_captions(captions, lambda i, m: jclap.CLAP(jcfg).apply({"params": params}, i, m,
                                                                                method="encode_text"), hf_like,
                                  batch_size=4)
    np.testing.assert_allclose(got, want, **TOL)
    # the RAG manifest, and the support store across packages
    (tmp_path / "in.jsonl").write_text("".join(json.dumps({"key": f"k{i}", "target": captions[i]}) + "\n"
                                               for i in (0, 4, 7)))
    lut = dict(zip(captions, support))

    def embed(ts):
        return np.stack([lut[t] for t in ts])

    for mod, name in ((tdrcap, "ours"), (jdrcap, "theirs")):
        assert mod.augment_manifest_with_rag(str(tmp_path / "in.jsonl"), str(tmp_path / name), captions, support, embed,
                                             k=3, batch_size=2) == 3
    assert (tmp_path / "ours").read_text() == (tmp_path / "theirs").read_text()
    jdrcap.save_support(str(tmp_path / "jax_store"), captions, support)
    caps, emb = tdrcap.load_support(str(tmp_path / "jax_store"))
    assert caps == captions and np.array_equal(emb, support)
    tdrcap.save_support(str(tmp_path / "port_store.npz"), captions, support)
    caps, emb = jdrcap.load_support(str(tmp_path / "port_store"))
    assert caps == captions and np.array_equal(emb, support)


# ---------------------------------------------------------------------------
# the SLAM models: hf-text, and no encoder (DRCap)
# ---------------------------------------------------------------------------


def _jax_slam(encoder_name, encoder, encoder_dim, ds_rate):
    llm = dataclasses.replace(JLLMConfig.tiny_test(), dtype=jnp.float32)
    proj = JProjectorConfig(encoder_dim=encoder_dim, llm_dim=llm.d_model, ds_rate=ds_rate, hidden_dim=32,
                            dtype=jnp.float32)
    return JSLAMConfig(llm=llm, encoder_name=encoder_name, encoder=encoder, projector="linear", projector_cfg=proj,
                       freeze_encoder=True, freeze_llm=True)


def _port_slam(jcfg):
    def conv(cls, obj):
        names = {f.name for f in dataclasses.fields(cls)} - {"dtype", "param_dtype"}
        return cls(**{n: getattr(obj, n) for n in names if hasattr(obj, n)}, dtype=torch.float32)

    enc = _same(jcfg.encoder, tbert.BertConfig) if jcfg.encoder_name == "hf-text" else None
    return tslam.SLAMConfig(
        llm=dataclasses.replace(conv(tllm.LLMConfig, jcfg.llm), remat=False), encoder_name=jcfg.encoder_name,
        encoder=enc, projector="linear", projector_cfg=conv(tproj.ProjectorConfig, jcfg.projector_cfg),
        freeze_encoder=True, freeze_llm=True)


def _text_batch(n_slots, b=2, t=18, seed=0):
    """Row 0 left-padded by 3; ``n_slots`` audio pseudo-tokens (-1) then
    text; labels after the first two text tokens."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 250, (b, t)).astype(np.int64)
    attn = np.ones((b, t), np.int32)
    modality = np.zeros((b, t), np.int32)
    labels = ids.copy()
    attn[0, :3] = 0
    ids[0, :3] = PAD
    for row in range(b):
        start = 3 if row == 0 else 0
        ids[row, start:start + n_slots] = -1
        modality[row, start:start + n_slots] = 1
        labels[row, :start + n_slots + 2] = -100
    return {"input_ids": ids, "attention_mask": attn, "modality_mask": modality, "labels": labels}


def _slam_pair(jcfg, batch, seed=5):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = _seeded(JSLAMModel(jcfg).init(jax.random.PRNGKey(0), jb, method="init_all")["params"], seed)
    tcfg = _port_slam(jcfg)
    tm = tslam.SLAMModel(tcfg).eval()
    tm.load_state_dict(convert.from_flax_params(params, tcfg))
    return params, tm


def _check_loss_and_grads(jcfg, params, tm, batch):
    """Loss within 1e-5 relative, accuracy equal, every projector gradient
    within 1e-4 of its largest entry of ``jax.value_and_grad``'s."""
    trainable, frozen = j_partition(params, jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(tr):
        out = JSLAMModel(jcfg).apply({"params": j_merge(tr, frozen)}, jb)
        return out["loss"], out["acc"]

    (jl, ja), jg = jax.value_and_grad(loss_fn, has_aux=True)(trainable)
    tr, _ = partition_params(tm, tm.cfg)
    out = tm({k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(out["loss"], list(tr.values()))
    np.testing.assert_allclose(float(out["loss"].detach()), float(jl), rtol=1e-5)
    assert float(out["acc"]) == float(ja)
    got, want = _flat(convert.trainable_to_flax(dict(zip(tr.keys(), grads)))), _flat(jg)
    assert set(got) == set(want) and all(k.startswith("encoder_projector") for k in got)
    for key, g in got.items():
        assert np.abs(g - want[key]).max() <= 1e-4 * np.abs(want[key]).max() > 0, key


def test_hf_text_slam_model_matches_jax():
    """The ``hf-text`` encoder (tiny BERT, 10 text tokens, row 1 ragged,
    projector ds 2 -> 5 slots): loss and projector gradients against JAX;
    greedy and beam-4 tokens identical to the JAX ``Generator``, the batch's
    ``text_input_ids`` / ``text_input_mask`` kept by the generator."""
    bcfg = jbert.BertConfig.tiny_test()
    jcfg = _jax_slam("hf-text", bcfg, bcfg.d_model, 2)
    batch = _text_batch(5)
    rng = np.random.default_rng(4)
    batch["text_input_ids"] = rng.integers(0, bcfg.vocab_size, (2, 10))
    batch["text_input_mask"] = np.ones((2, 10), np.int32)
    batch["text_input_mask"][1, 6:] = 0
    params, tm = _slam_pair(jcfg, batch)
    assert isinstance(tm.encoder, tbert.BertEncoder)
    _check_loss_and_grads(jcfg, params, tm, batch)
    decode = {k: v for k, v in batch.items() if k != "labels"}
    for num_beams in (1, 4):
        kw = dict(max_new_tokens=6, num_beams=num_beams, eos_token_id=EOS, pad_token_id=PAD)
        want = JGenerator(JSLAMModel(jcfg), JGenerationConfig(**kw)).generate({"params": params}, decode)
        np.testing.assert_array_equal(Generator(tm, GenerationConfig(**kw)).generate(decode), want)


def test_hf_text_encoder_loads_an_hf_bert_directory(tmp_path):
    """``encoder_name: hf-text`` with ``encoder_path`` = an HF ``BertModel``
    directory (``write_sbert`` at the ``bert-tiny-test`` widths):
    ``materialize_params`` overlays every BERT tensor on the seeded init."""
    from slam_llm_tpu_torch.config import RunConfig
    from slam_llm_tpu_torch.pipeline.common import materialize_params
    from slam_llm_tpu_torch.utils.hf_loader import load_hf_state_dict

    bcfg = tbert.BertConfig.tiny_test()
    synth.write_sbert(str(tmp_path / "bert"), bcfg, seed=6)
    cfg = RunConfig()
    for key, value in {"llm_name": "tiny-test", "encoder_name": "hf-text", "encoder_config": "bert-tiny-test",
                       "encoder_path": str(tmp_path / "bert"), "encoder_projector_ds_rate": 2}.items():
        setattr(cfg.model_config, key, value)
    model, _ = tslam.model_factory(cfg.train_config, cfg.model_config, device="cpu")
    materialize_params(model, cfg)
    written = load_hf_state_dict(str(tmp_path / "bert"))
    state = model.encoder.state_dict()
    assert isinstance(model.encoder, tbert.BertEncoder) and set(state) == set(written)
    assert all(torch.equal(state[k], written[k]) for k in written)


@pytest.mark.parametrize("keys", ["audio_mel+mask", "audio_mel", "audio"])
def test_encoder_less_model_splices_the_features_as_jax(keys):
    """``encoder_name: null`` with one (B, 1, 24) latent a row (DRCap): the
    batch's ``audio_mel`` (with or without its mask) or ``audio`` is the
    encoder output; the spliced embeddings (the slot holds the projected
    latent, not the embedding of id 0), the loss and the projector's
    gradients equal the JAX model's."""
    jcfg = _jax_slam(None, None, 24, 1)
    batch = _text_batch(1, seed=3)
    lat = np.random.default_rng(6).standard_normal((2, 1, 24)).astype(np.float32)
    batch["audio" if keys == "audio" else "audio_mel"] = lat
    if keys == "audio_mel+mask":
        batch["audio_mel_mask"] = np.ones((2, 1), np.int32)
    params, tm = _slam_pair(jcfg, batch)
    assert tm.encoder is None
    want, _ = JSLAMModel(jcfg).apply({"params": params}, {k: jnp.asarray(v) for k, v in batch.items()},
                                     method="forward_embeds")
    with torch.no_grad():
        got, _ = tm.forward_embeds({k: torch.from_numpy(v) for k, v in batch.items()})
        embed0 = tm.llm.embed(torch.zeros(1, 1, dtype=torch.long))[0, 0]
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    slot = torch.from_numpy(batch["modality_mask"]).bool()
    assert not torch.allclose(got[slot], embed0.expand(2, -1))
    _check_loss_and_grads(jcfg, params, tm, batch)


def _drcap_dataset(config_mod, dataset_mod, manifest, tok):
    """The speech dataset of one package (its config and dataset modules)
    as ``drcap.yaml`` sets it up: one audio slot, the recipe's prompt."""
    cfg = config_mod.RunConfig().dataset_config
    cfg.train_data_path = cfg.val_data_path = str(manifest)
    cfg.prompt, cfg.fix_length_audio, cfg.mel_size = "Describe the audio you hear. ", 1, 8
    return dataset_mod.SpeechDatasetJsonl(cfg, tok, "train")


def test_drcap_slice_matches_jax(tmp_path):
    """DRCap at tiny size, as a whole: a RAG manifest from the port's CLAP
    text tower (a ``write_clap`` file; ``augment_manifest_with_rag``, k 3, each row's own caption
    excluded), the speech dataset's text collation equal to the JAX
    package's, the captions' latents attached as (B, 1, D) ``audio_mel``
    (``LatentCaptionDataset``), and the encoder-less model's loss and
    projector gradient against the JAX model's on that batch."""
    from slam_llm_tpu import config as jconfig
    from slam_llm_tpu.data import speech_dataset as jspeech
    from slam_llm_tpu_torch import config as tconfig
    from slam_llm_tpu_torch.data import speech_dataset as tspeech

    ccfg = tclap.CLAPConfig.tiny_test()
    synth.write_clap(str(tmp_path / "clap.pt"), ccfg, seed=3)
    clap = tclap.load_clap(str(tmp_path / "clap.pt"), ccfg, device="cpu")
    captions = ["a dog barks", "rain falls on a roof", "a man speaks", "birds chirp loudly", "an engine idles",
                "water runs into a sink"]
    synth.write_bert_vocab(str(tmp_path / "vocab.txt"), ccfg.bert.vocab_size, words=captions)
    tok = tfense.WordPieceTokenizer(str(tmp_path / "vocab.txt"))

    def embed(texts):
        return tclap.embed_texts(clap, tok, texts)

    support = tdrcap.encode_captions(captions, lambda i, m: clap.encode_text(torch.from_numpy(i), torch.from_numpy(m)),
                                     tok)
    manifest = make_corpus(tmp_path, n=4, targets=captions[:4])
    tdrcap.augment_manifest_with_rag(str(manifest), str(tmp_path / "rag.jsonl"), captions, support, embed, k=3)
    rows = [json.loads(line) for line in open(tmp_path / "rag.jsonl")]
    assert all(len(r["similar_captions"]) == 3 and r["target"] not in r["similar_captions"] for r in rows)

    ds = tdrcap.LatentCaptionDataset(_drcap_dataset(tconfig, tspeech, tmp_path / "rag.jsonl", ByteTokenizer()),
                                     embed([r["target"] for r in rows]))
    jds = _drcap_dataset(jconfig, jspeech, tmp_path / "rag.jsonl", JByteTokenizer())
    batch = ds.collator([ds[i] for i in (0, 3, 1)])
    text = jds.collate_text([jds[i] for i in (0, 3, 1)])
    assert text.keys() <= batch.keys()
    for k, v in text.items():
        np.testing.assert_array_equal(batch[k], v)
    assert batch["audio_mel"].shape == (3, 1, ccfg.embed_dim) and batch["modality_mask"].sum(1).tolist() == [1] * 3
    assert batch["audio_seconds"] == pytest.approx(0.5 + 0.5 + 0.6)  # the clips' true seconds
    batch = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    jcfg = _jax_slam(None, None, ccfg.embed_dim, 1)
    jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm, vocab_size=512))
    params, tm = _slam_pair(jcfg, batch, seed=11)
    _check_loss_and_grads(jcfg, params, tm, batch)


# ---------------------------------------------------------------------------
# the step-0 repairs and the entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fixed", [True, False])
def test_audio_dataset_items_carry_the_true_seconds(tmp_path, fixed):
    """The AAC items' ``audio_seconds`` is the clip's length before the
    crop or pad (an unreadable clip: its 1 s of silence), and the
    collator and ``batch_audio_seconds`` sum it, whatever the fbank mask
    says (1024 frames a fixed-length clip)."""
    from slam_llm_tpu_torch.config import RunConfig
    from slam_llm_tpu_torch.data.audio_dataset import get_audio_dataset
    from slam_llm_tpu_torch.pipeline.inference_batch import batch_audio_seconds

    manifest = make_corpus(tmp_path, n=3)
    with open(manifest, "a") as f:
        f.write(json.dumps({"key": "broken", "source": str(tmp_path / "missing.wav"), "target": "x"}) + "\n")
    cfg = RunConfig().dataset_config
    cfg.dataset, cfg.train_data_path, cfg.val_data_path = "audio_dataset", str(manifest), str(manifest)
    cfg.fixed_length, cfg.inference_mode = fixed, True
    ds = get_audio_dataset(cfg, ByteTokenizer(), "test")
    assert [ds[i]["audio_seconds"] for i in range(4)] == pytest.approx([0.5, 0.6, 0.7, 1.0])
    batch = ds.collator([ds[i] for i in range(4)])
    assert batch_audio_seconds(batch) == pytest.approx(2.8)
    assert (batch["audio_mel_mask"].sum() * 0.01 == pytest.approx(4 * 10.24)) == fixed


def _drcap_run_config(tmp_path, manifest, *extra):
    from slam_llm_tpu_torch.pipeline import finetune

    return finetune.load_run_config([
        "--config", str(REPO / "examples" / "drcap_zeroshot_aac" / "conf" / "drcap.yaml"),
        "++model_config.llm_name=tiny-test", f"++dataset_config.train_data_path={manifest}",
        f"++dataset_config.val_data_path={manifest}", "++train_config.batch_size_training=2",
        "++train_config.max_steps_per_epoch=1", f"++train_config.output_dir={tmp_path / 'out'}", *extra])


def test_drcap_manifest_route_refuses_the_mel(tmp_path):
    """``drcap.yaml`` through ``pipeline.finetune`` over a manifest of
    ``.npy`` latents: the speech dataset makes an 80-bin log-mel of each
    (as the JAX one does), the encoder-less model hands it to the
    1024 -> 4096 projector's first 1024-wide product, which raises; nothing
    trains and no checkpoint is written."""
    from slam_llm_tpu_torch.pipeline import finetune

    with open(tmp_path / "m.jsonl", "w") as f:
        for i in range(2):
            np.save(tmp_path / f"z{i}.npy", np.random.default_rng(i).standard_normal(1024).astype(np.float32))
            f.write(json.dumps({"key": f"z{i}", "source": str(tmp_path / f"z{i}.npy"), "target": "a dog barks"}) + "\n")
    cfg = _drcap_run_config(tmp_path, tmp_path / "m.jsonl")
    mc = cfg.model_config
    assert (mc.encoder_name, mc.encoder_dim, mc.encoder_projector, cfg.dataset_config.fix_length_audio) == (
        None, 1024, "linear", 1)
    with pytest.raises(RuntimeError, match="shapes cannot be multiplied"):
        finetune.main(cfg, device="cpu")
    assert not (tmp_path / "out").exists()


def test_profile_train_builds_the_drcap_recipe(tmp_path):
    """``tools/profile_train.py --recipe drcap`` at tiny width on the CPU:
    drcap.yaml's model (no encoder, the 1024-wide linear projector, a
    frozen bf16 LLM), its RAG manifest over the synthetic captions, and one
    training step on the recipe's batch of 16 latents; the test split
    ``tools/profile_decode.py`` reads, through the decode loader, carries
    the latents too."""
    from slam_llm_tpu_torch.tools import profile_train
    from slam_llm_tpu_torch.train.state import Trainer

    recipe, overrides = profile_train.split_recipe(["--recipe", "drcap", "++model_config.llm_name=tiny-test"])
    cfg, model, tok, dataset, n = profile_train.build_recipe(recipe, overrides, tmp_path, device="cpu")
    assert model.encoder is None and n == 16 and tok.vocab_size == 32000
    assert model.cfg.projector_cfg.encoder_dim == 1024 and isinstance(dataset, tdrcap.LatentCaptionDataset)
    trainer = Trainer(model, model.cfg, cfg.train_config).state_from_params()
    batch = trainer.put_batch(dataset.collator([dataset[i] for i in range(n)]))
    assert batch["audio_mel"].shape == (16, 1, 1024) and int(batch["modality_mask"].sum()) == 16
    m = trainer.train_step(batch)
    assert np.isfinite(float(m["loss"])) and set(trainer.trainable) == {
        k for k, _ in model.named_parameters() if k.startswith("encoder_projector.")}
    from slam_llm_tpu_torch.pipeline.inference_batch import decode_loader

    cfg, _, _, dataset, _ = profile_train.build_recipe(recipe, overrides, tmp_path / "decode", device="cpu",
                                                       split="test")
    item = dataset[0]
    assert cfg.dataset_config.inference_mode and item["input_ids"][0] == -1 and item["latent"].shape == (1024,)
    batch = next(iter(decode_loader(cfg, dataset)))  # the batch tools/profile_decode.py takes
    assert batch["audio_mel"].shape == (cfg.train_config.val_batch_size, 1, 1024) and "labels" not in batch
