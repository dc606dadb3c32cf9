"""The SELD, music-captioning and SEC / E-chat recipes' pieces in the port
against the JAX package, on the CPU (tiny widths, numpy-seeded inputs).

* ``music_log_mel`` and ``binaural_features`` within 1e-5 relative of the
  JAX functions;
* MIR, spatial and E-chat items and collated batches equal to the JAX
  datasets' on the same manifests and seeds (the seeded crop; the SELD
  manifests' split aliases, mixup and a jsonl; E-chat's JSON and
  python-literal dialogs, the ``xxx`` skip, the 90 / 10 split of one file
  and two files);
* ``MusicFMEncoder`` (a ragged mel mask) and ``SpatialASTEncoder`` (64
  target frames from 50 and from 70: the bicubic path and the cut) against
  the JAX modules through ``utils.convert``, f32 within 1e-5 relative;
  ``convert_spatialast_torch`` against the JAX converter on a
  ``tools/synth_checkpoint.write_spatial_ast`` file, which the encoder-file
  dispatch loads too;
* each recipe as a tiny SLAMModel (tiny LLM, f32): the loss and every
  trainable gradient against ``jax.value_and_grad``, beam-4 tokens
  identical to the JAX ``Generator``; the SELD case feeds ``audio_binaural``
  through the ``Generator``, and its RTF seconds follow the JAX formula;
* the registry resolves the three datasets to the port's modules, and
  ``pipeline.finetune`` trains from one E-chat ``data_path`` with its 10 %
  validation split;
* SELD with the encoder unfrozen (``freeze_encoder: false``): the loss and
  every trainable gradient, Spatial-AST's included, against
  ``jax.value_and_grad``; two trainer steps against the JAX ``Trainer``
  (the global-norm clip over the encoder's gradients); a JAX
  ``model.msgpack`` with trained encoder tensors read by the port and the
  port's read by the JAX package; ``encoder_to_flax`` inverting
  ``encoder_from_flax`` for Spatial-AST, MusicFM and BERT; and
  ``pipeline.finetune`` with ``++train_config.freeze_encoder=false`` then
  ``pipeline.inference_batch`` with ``ckpt_path`` at a narrow Spatial-AST.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from slam_llm_tpu.config import RunConfig as JRunConfig
from slam_llm_tpu.data import echat_dataset as jechat
from slam_llm_tpu.data import mir_dataset as jmir
from slam_llm_tpu.data import spatial_dataset as jspatial
from slam_llm_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from slam_llm_tpu.inference.generate import GenerationConfig as JGenerationConfig
from slam_llm_tpu.inference.generate import Generator as JGenerator
from slam_llm_tpu.models import musicfm as jmusicfm
from slam_llm_tpu.models import spatial_ast as jspatial_ast
from slam_llm_tpu.models import wavlm as jwavlm
from slam_llm_tpu.models.llm import LLMConfig as JLLMConfig
from slam_llm_tpu.models.projector import ProjectorConfig as JProjectorConfig
from slam_llm_tpu.models.slam_model import SLAMConfig as JSLAMConfig
from slam_llm_tpu.models.slam_model import SLAMModel as JSLAMModel
from slam_llm_tpu.ops import audio as jaudio
from slam_llm_tpu.train.optimizer import merge_params as j_merge
from slam_llm_tpu.train.optimizer import partition_params as j_partition
from slam_llm_tpu_torch.config import RunConfig
from slam_llm_tpu_torch.data import echat_dataset as techat
from slam_llm_tpu_torch.data import mir_dataset as tmir
from slam_llm_tpu_torch.data import spatial_dataset as tspatial
from slam_llm_tpu_torch.data.tokenizer import ByteTokenizer
from slam_llm_tpu_torch.inference.generate import GenerationConfig, Generator
from slam_llm_tpu_torch.models import llm as tllm
from slam_llm_tpu_torch.models import musicfm as tmusicfm
from slam_llm_tpu_torch.models import projector as tproj
from slam_llm_tpu_torch.models import slam_model as tslam
from slam_llm_tpu_torch.models import spatial_ast as tspatial_ast
from slam_llm_tpu_torch.models import wavlm as twavlm
from slam_llm_tpu_torch.models.layers import FrozenBatchNorm
from slam_llm_tpu_torch.ops import audio as taudio
from slam_llm_tpu_torch.tools import synth_checkpoint as synth
from slam_llm_tpu_torch.train.optimizer import partition_params
from slam_llm_tpu_torch.utils import hf_loader
from slam_llm_tpu_torch.utils.convert import encoder_from_flax, encoder_to_flax, from_flax_params, trainable_to_flax

EOS, PAD = 2, 0


def _seeded(tree, seed):
    """Every float leaf of a flax parameter tree redrawn from a numpy
    generator: kernels normal with std 1/sqrt(fan_in), norm scales and
    BatchNorm variances around 1 (positive), biases and means small, CLS
    tokens at std 0.02; the fixed sin-cos table keeps its init."""
    rng = np.random.default_rng(seed)

    def draw(key, x):
        shape = np.shape(x)
        if key == "pos_embed":
            return np.asarray(x)
        if key in ("scale", "gn_scale", "gru_rel_pos_const"):
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if key in ("var", "bn_var"):
            return (0.5 + rng.random(shape)).astype(np.float32)
        if key in ("bias", "gn_bias", "mean", "bn_mean", "down_bias", "patch_bias"):
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        if key == "cls_tokens":
            return (0.02 * rng.standard_normal(shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else draw(k, v) for k, v in node.items()}

    return walk(nn.meta.unbox(tree))


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


def _conv(cls, obj, dtype=torch.float32):
    """The port's config dataclass ``cls`` from the JAX one's fields."""
    names = {f.name for f in dataclasses.fields(cls)} - {"dtype", "param_dtype"}
    return cls(**{n: getattr(obj, n) for n in names if hasattr(obj, n)}, dtype=dtype)


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


# ---------------------------------------------------------------------------
# the host features
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seconds", [10.0, 3.7])
def test_music_log_mel_matches_jax(seconds):
    x = np.random.default_rng(0).standard_normal(int(seconds * 24000)).astype(np.float32) * 0.2
    got, want = taudio.music_log_mel(x), jaudio.music_log_mel(x)
    assert got.dtype == np.float32 and got.shape == want.shape == (1 + int(seconds * 24000) // 240, 128)
    _close(got, want)
    np.testing.assert_array_equal(taudio._htk_mel_banks(128, 24000, 2048), jaudio._htk_mel_banks(128, 24000, 2048))


def test_binaural_features_match_jax():
    x = np.random.default_rng(1).standard_normal((2, 2, 48000)).astype(np.float32) * 0.1
    got, want = tspatial_ast.binaural_features(x), jspatial_ast.binaural_features(x)
    assert got.shape == want.shape == (2, 4, 151, 128) and got.dtype == np.float32
    for c in range(4):  # the dB log-mels and the IPD projections each against their own scale
        _close(got[:, c], want[:, c])
    np.testing.assert_array_equal(tspatial_ast.mel_filterbank_slaney(), jspatial_ast.mel_filterbank_slaney())


# ---------------------------------------------------------------------------
# the datasets
# ---------------------------------------------------------------------------


def _configs(**kw):
    """The same dataset_config in both packages."""
    out = []
    for mod in (JRunConfig, RunConfig):
        cfg = mod().dataset_config
        for k, v in kw.items():
            setattr(cfg, k, v)
        out.append(cfg)
    return out


def _same(a, b):
    assert a.keys() == b.keys()
    for k in b:
        if isinstance(b[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def _pairs_equal(tds, jds, n_items, batches=((0, 1),)):
    assert len(tds) == len(jds)
    for i in range(n_items):
        _same(tds[i], jds[i])
    for rows in batches:
        _same(tds.collator([tds[i] for i in rows]), jds.collator([jds[i] for i in rows]))


@pytest.mark.parametrize("split,inference", [("train", False), ("test", True)])
def test_mir_items_and_batches_match_jax(tmp_path, split, inference):
    """10 s crops of 8-14 s clips (seeded at a random start in train, at 0
    otherwise), a 5 s clip zero-padded; 50 audio slots at ds 5."""
    manifest = synth.write_music_corpus(str(tmp_path), n=4, seconds=(8.0, 14.0))
    with open(manifest, "a") as f:
        path = str(tmp_path / "short.wav")
        synth.write_wav(path, np.full(5 * 24000, 0.1), 24000)
        f.write(json.dumps({"key": "short", "source": path, "target": "a short one"}) + "\n")
    jc, tc = _configs(dataset="mir_dataset", train_data_path=manifest, val_data_path=manifest, prompt=None,
                      seed=3, inference_mode=inference)
    tds = tmir.get_mir_dataset(tc, ByteTokenizer(), split)
    jds = jmir.get_mir_dataset(jc, JByteTokenizer(), split)
    assert tds.prompt == tmir.DEFAULT_MC_PROMPT and tds.random_crop == (split == "train")
    assert tds[0]["audio_mel"].shape == (1001, 128) and tds[0]["audio_length"] == 50
    _pairs_equal(_Without(tds, "audio_seconds"), jds, 5, batches=((0, 4), (2, 3)))
    assert tds[4]["audio_seconds"] == 5.0 and all(8.0 <= tds[i]["audio_seconds"] <= 10.0 for i in range(4))


class _Without:
    """A dataset whose items lack ``key``, which the port adds and the JAX
    package's items do not carry."""

    def __init__(self, ds, key):
        self.ds, self.key, self.collator = ds, key, ds.collator

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return {k: v for k, v in self.ds[i].items() if k != self.key}


def test_mir_rtf_counts_the_music_not_the_padded_crop(tmp_path):
    """A 6 s clip is zero-padded to the 10 s crop: its batch counts 6 s of
    audio for the RTF, not the crop's 1001 mel frames (10.01 s)."""
    from slam_llm_tpu_torch.pipeline.inference_batch import batch_audio_seconds

    path = str(tmp_path / "six.wav")
    synth.write_wav(path, np.full(6 * 24000, 0.1), 24000)
    manifest = tmp_path / "m.jsonl"
    manifest.write_text(json.dumps({"key": "six", "source": path, "target": "six seconds"}) + "\n")
    _, tc = _configs(dataset="mir_dataset", train_data_path=str(manifest), val_data_path=str(manifest),
                     inference_mode=True)
    tds = tmir.get_mir_dataset(tc, ByteTokenizer(), "test")
    batch = tds.collator([tds[0]])
    assert batch["audio_mel_mask"].sum() == 1001
    assert batch_audio_seconds(batch) == pytest.approx(6.0)


@pytest.mark.parametrize("split,inference", [("train", False), ("validation", False), ("test", True)])
def test_spatial_items_and_batches_match_jax(tmp_path, split, inference):
    """The ``{qa_data_root}/{stage}/{split}.json`` manifests (validation
    resolves to val.json), clips padded and cut to 10 s, a two-source mixup
    item, ``audio_binaural`` (B, 4, 1001, 128)."""
    over = synth.write_seld_corpus(str(tmp_path), n=4, n_reverbs=2)
    jc, tc = _configs(dataset="spatial_audio_dataset", fix_length_audio=64, inference_mode=inference, **over)
    tds = tspatial.get_spatial_audio_dataset(tc, ByteTokenizer(), split)
    jds = jspatial.get_spatial_audio_dataset(jc, JByteTokenizer(), split)
    batch = tds.collator([tds[0], tds[3]])
    assert batch["audio_binaural"].shape == (2, 4, 1001, 128) and tds[3]["audio_stereo"].shape == (2, 320000)
    _pairs_equal(tds, jds, 4, batches=((0, 3),))


def test_spatial_jsonl_manifest_matches_jax(tmp_path):
    over = synth.write_seld_corpus(str(tmp_path), n=2, n_reverbs=1, splits=("train",))
    with open(os.path.join(over.pop("qa_data_root"), over["stage"], "train.json")) as f:
        items = json.load(f)["data"]
    items[1].pop("reverb_id")  # no IR: the mono clip is duplicated onto both channels
    manifest = tmp_path / "items.jsonl"
    manifest.write_text("".join(json.dumps(it) + "\n" for it in items))
    jc, tc = _configs(dataset="spatial_audio_dataset", train_data_path=str(manifest), **over)
    tds = tspatial.get_spatial_audio_dataset(tc, ByteTokenizer(), "train")
    jds = jspatial.get_spatial_audio_dataset(jc, JByteTokenizer(), "train")
    assert np.array_equal(tds[1]["audio_stereo"][0], tds[1]["audio_stereo"][1])
    _pairs_equal(tds, jds, 2)


@pytest.mark.parametrize("python_literal", [False, True])
def test_echat_manifest_and_split_match_jax(tmp_path, python_literal):
    """Turn pairs skip a next turn whose emotion is ``xxx``; one data_path
    splits 90 / 10 by position; separate files are each their split."""
    tsv = synth.write_echat_corpus(str(tmp_path), n_dialogs=6, python_literal=python_literal)
    records = techat.parse_echat_manifest(tsv)
    assert records == jechat.parse_echat_manifest(tsv) and len(records) > 10
    assert all(not r["target"].startswith("<|xxx|>") for r in records)
    for split in ("train", "validation"):
        jc, tc = _configs(dataset="echat_dataset", data_path=tsv, input_type="raw", normalize=True, prompt=None)
        tds = techat.get_echat_dataset(tc, ByteTokenizer(), split)
        jds = jechat.get_echat_dataset(jc, JByteTokenizer(), split)
        assert tds.data_list == jds.data_list and tds.prompt == techat.DEFAULT_ECHAT_PROMPT
        cut = int(len(records) * 0.9)
        assert tds.data_list == (records[:cut] if split == "train" else records[cut:])
        _pairs_equal(tds, jds, 2)
    other = synth.write_echat_corpus(str(tmp_path), n_dialogs=2, seed=1, name="val")
    jc, tc = _configs(dataset="echat_dataset", train_data_path=tsv, val_data_path=other)
    for split, path in (("train", tsv), ("validation", other)):
        tds = techat.get_echat_dataset(tc, ByteTokenizer(), split)
        assert tds.data_list == jechat.get_echat_dataset(jc, JByteTokenizer(), split).data_list
        assert tds.data_list == techat.parse_echat_manifest(path)


def test_registry_resolves_the_recipes_datasets():
    from slam_llm_tpu_torch.registry import get_custom_dataset_factory

    for name, fn in (("mir_dataset", tmir.get_mir_dataset), ("echat_dataset", techat.get_echat_dataset),
                     ("spatial_audio_dataset", tspatial.get_spatial_audio_dataset)):
        cfg = RunConfig().dataset_config
        cfg.dataset = name
        assert get_custom_dataset_factory(cfg) is fn


# ---------------------------------------------------------------------------
# the encoders and the Spatial-AST converter
# ---------------------------------------------------------------------------


def test_musicfm_encoder_matches_jax():
    """musicfm-tiny-test in f32 on a ragged mel mask (row 1 valid for 57 of
    90 frames): outputs within 1e-5 relative at the valid frames, masks equal."""
    jcfg = dataclasses.replace(jmusicfm.MusicFMConfig.tiny_test(), dtype=jnp.float32)
    rng = np.random.default_rng(2)
    mel = (rng.standard_normal((2, 90, 16)) * 10 - 20).astype(np.float32)
    mask = np.ones((2, 90), np.int32)
    mask[1, 57:] = 0
    jm = jmusicfm.MusicFMEncoder(jcfg)
    params = _seeded(jm.init(jax.random.PRNGKey(0), jnp.asarray(mel), jnp.asarray(mask))["params"], seed=3)
    want, want_mask = (np.asarray(a) for a in jm.apply({"params": params}, jnp.asarray(mel), jnp.asarray(mask)))
    tm = tmusicfm.MusicFMEncoder(_conv(tmusicfm.MusicFMConfig, jcfg))
    tm.load_state_dict(encoder_from_flax(params, "musicfm"))
    with torch.no_grad():
        got, got_mask = tm(torch.from_numpy(mel), torch.from_numpy(mask))
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    live = want_mask.astype(bool)
    assert got.shape == want.shape == (2, 23, 32)
    _close(got.numpy()[live], want[live])


@pytest.mark.parametrize("frames", [50, 70])
def test_spatial_ast_encoder_matches_jax(frames):
    """spatialast-tiny-test (64 target frames) in f32: 50 frames take the
    bicubic resize, 70 the cut; 3 CLS + 8 patches out, within 1e-5 relative."""
    jcfg = jspatial_ast.SpatialASTConfig.tiny_test()
    feats = (np.random.default_rng(4).standard_normal((2, 4, frames, 32)) * 5).astype(np.float32)
    jm = jspatial_ast.SpatialASTEncoder(jcfg)
    params = _seeded(jm.init(jax.random.PRNGKey(0), jnp.asarray(feats))["params"], seed=5)
    want, want_mask = (np.asarray(a) for a in jm.apply({"params": params}, jnp.asarray(feats)))
    tm = tspatial_ast.SpatialASTEncoder(_conv(tspatial_ast.SpatialASTConfig, jcfg))
    tm.load_state_dict(encoder_from_flax(params, "spatial_ast"))
    with torch.no_grad():
        got, got_mask = tm(torch.from_numpy(feats))
    assert got.shape == want.shape == (2, 11, 32) and got.dtype == torch.float32
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    _close(got.numpy(), want)


def test_convert_spatialast_matches_jax_converter(tmp_path):
    """A ``write_spatial_ast`` file (BAT's layout) through both converters,
    and through the encoder-file dispatch into a model: the same tensors."""
    from slam_llm_tpu.models.spatial_ast import convert_spatialast_torch as j_convert

    cfg = tspatial_ast.SpatialASTConfig.tiny_test()
    path = tmp_path / "spatial_ast.pt"
    synth.write_spatial_ast(str(path), cfg, seed=7)
    sd = hf_loader.load_torch_checkpoint(str(path))
    got = tspatial_ast.convert_spatialast_torch(sd, cfg)
    want = encoder_from_flax(j_convert(sd, jspatial_ast.SpatialASTConfig.tiny_test()), "spatial_ast")
    assert got.keys() == want.keys() == tspatial_ast.SpatialASTEncoder(cfg).state_dict().keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
    loaded = hf_loader.convert_encoder_checkpoint(str(path), "spatial_ast", cfg)
    enc = hf_loader.overlay_(tspatial_ast.SpatialASTEncoder(cfg), loaded)
    assert torch.equal(enc.blocks[1].k_proj.weight, sd["blocks.1.attn.qkv.weight"][32:64])
    assert torch.equal(enc.pos_embed, sd["pos_embed"][0, 1:])


# ---------------------------------------------------------------------------
# the three recipes as tiny SLAMModels
# ---------------------------------------------------------------------------

N_SLOTS = 8  # audio pseudo-tokens: the Q-Former's queries, or MusicFM's frames / 5


def _recipe(kind):
    """(JAX SLAMConfig, the port's, the batch's audio keys) of a tiny recipe:
    seld (spatialast-tiny-test + Q-Former), mc (musicfm-tiny-test + linear
    ds 5), sec (an emotion2vec-shaped tiny encoder + Q-Former); the tiny LLM
    in f32, everything frozen but the projector."""
    llm = dataclasses.replace(JLLMConfig.tiny_test(), lora_rank=0, dtype=jnp.float32)
    qformer = dict(query_len=N_SLOTS, qformer_layers=2, qformer_dim=32, qformer_heads=2)
    if kind == "seld":
        name, enc = "spatial_ast", jspatial_ast.SpatialASTConfig.tiny_test()
        port_enc = _conv(tspatial_ast.SpatialASTConfig, enc)
    elif kind == "mc":
        name, enc = "musicfm", dataclasses.replace(jmusicfm.MusicFMConfig.tiny_test(), dtype=jnp.float32)
        port_enc, qformer = _conv(tmusicfm.MusicFMConfig, enc), {}
    else:
        name = "emotion2vec"
        enc = dataclasses.replace(jwavlm.WavLMConfig.tiny_test(rel_bias=False), feat_extract_norm="layer",
                                  do_stable_layer_norm=True, dtype=jnp.float32)
        port_enc = _conv(twavlm.WavLMConfig, enc)
    projector = "q-former" if qformer else "linear"
    proj = JProjectorConfig(encoder_dim=enc.d_model, llm_dim=llm.d_model, ds_rate=5, hidden_dim=32, **qformer,
                            dtype=jnp.float32)
    jcfg = JSLAMConfig(llm=llm, encoder_name=name, encoder=enc, projector=projector, projector_cfg=proj,
                       freeze_encoder=True, freeze_llm=True)
    tcfg = tslam.SLAMConfig(
        llm=dataclasses.replace(_conv(tllm.LLMConfig, llm), remat=False), encoder_name=name, encoder=port_enc,
        projector=projector, projector_cfg=_conv(tproj.ProjectorConfig, proj), freeze_encoder=True,
        freeze_llm=True)
    return jcfg, tcfg


def _batch(kind):
    """Two rows, row 0 left-padded by 3: N_SLOTS audio pseudo-tokens, then
    text, labelled after its first two tokens; the recipe's audio input."""
    rng = np.random.default_rng(0)
    b, t = 2, 22
    ids = rng.integers(3, 250, (b, t)).astype(np.int64)
    attn = np.ones((b, t), np.int32)
    modality = np.zeros((b, t), np.int32)
    labels = ids.copy()
    attn[0, :3] = 0
    ids[0, :3] = PAD
    for row, start in ((0, 3), (1, 0)):
        ids[row, start:start + N_SLOTS] = -1
        modality[row, start:start + N_SLOTS] = 1
        labels[row, :start + N_SLOTS + 2] = -100
    out = {"input_ids": ids, "attention_mask": attn, "modality_mask": modality, "labels": labels}
    if kind == "seld":
        out["audio_binaural"] = (rng.standard_normal((b, 4, 50, 32)) * 5).astype(np.float32)
    elif kind == "mc":  # 161 frames -> 41 -> 8 slots at ds 5
        out["audio_mel"] = (rng.standard_normal((b, 161, 16)) * 10 - 20).astype(np.float32)
        out["audio_mel_mask"] = np.ones((b, 161), np.int32)
        out["audio_mel_mask"][1, 120:] = 0
    else:
        out["audio"] = (rng.standard_normal((b, 2000)) * 0.3).astype(np.float32)
        out["audio_mask"] = np.ones((b, 2000), np.int32)
        out["audio_mask"][1, 1300:] = 0
    return out


@pytest.fixture(scope="module", params=["seld", "mc", "sec"])
def recipe(request):
    jcfg, tcfg = _recipe(request.param)
    batch = {k: jnp.asarray(v) for k, v in _batch(request.param).items()}
    params = _seeded(JSLAMModel(jcfg).init(jax.random.PRNGKey(0), batch, method="init_all")["params"], seed=5)
    tm = tslam.SLAMModel(tcfg).eval()
    tm.load_state_dict(from_flax_params(params, tcfg))
    return request.param, jcfg, params, tm


def test_recipe_loss_and_projector_grads_match_jax(recipe):
    """Loss within 1e-5 relative, accuracy equal, every projector gradient
    within 1e-4 of its largest entry, the gradient having come back through
    the frozen LLM; a Q-Former key bias (gradient 0 in exact arithmetic:
    the softmax cancels it) is held to round-off on both sides."""
    kind, jcfg, params, tm = recipe
    trainable, frozen = j_partition(params, jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in _batch(kind).items()}

    def loss_fn(tr):
        out = JSLAMModel(jcfg).apply({"params": j_merge(tr, frozen)}, jbatch)
        return out["loss"], out["acc"]

    (jl, ja), jg = jax.value_and_grad(loss_fn, has_aux=True)(trainable)
    tr, _ = partition_params(tm, tm.cfg)
    assert tr and all(n.startswith("encoder_projector.") for n in tr)
    out = tm({k: torch.from_numpy(v) for k, v in _batch(kind).items()})
    grads = torch.autograd.grad(out["loss"], list(tr.values()))
    np.testing.assert_allclose(float(out["loss"].detach()), float(jl), rtol=1e-5)
    assert float(out["acc"]) == float(ja)
    got, want = _flat(trainable_to_flax(dict(zip(tr.keys(), grads)))), _flat(jg)
    assert set(got) == set(want)
    top = max(np.abs(w).max() for w in want.values())
    for key, g in got.items():
        if key.endswith("k_proj/bias"):
            assert max(np.abs(g).max(), np.abs(want[key]).max()) <= 1e-6 * top, key
            continue
        assert np.abs(g - want[key]).max() <= 1e-4 * np.abs(want[key]).max(), key


def test_recipe_beam_tokens_identical_to_jax(recipe):
    kind, jcfg, params, tm = recipe
    kw = dict(max_new_tokens=6, num_beams=4, eos_token_id=EOS, pad_token_id=PAD)
    batch = {k: v for k, v in _batch(kind).items() if k != "labels"}
    want = JGenerator(JSLAMModel(jcfg), JGenerationConfig(**kw)).generate({"params": params}, batch)
    got = Generator(tm, GenerationConfig(**kw)).generate(batch)
    assert got.shape == want.shape == (2, 6)
    np.testing.assert_array_equal(got, want)


def test_binaural_batch_seconds_follow_the_jax_formula():
    """A SELD decode batch carries no audio_seconds or masks: its RTF counts
    the feature map's frames at the 10 ms hop, as the JAX pipeline does."""
    from slam_llm_tpu_torch.pipeline.inference_batch import batch_audio_seconds

    feats = np.zeros((3, 4, 1001, 128), np.float32)
    want = float(feats.shape[0] * feats.shape[2]) * 0.01  # slam_llm_tpu/pipeline/inference_batch.py:114-116
    assert batch_audio_seconds({"input_ids": np.zeros((3, 5)), "audio_binaural": feats}) == pytest.approx(want)
    assert want == pytest.approx(30.03)


def test_finetune_trains_from_one_echat_file(tmp_path):
    """``pipeline.finetune`` on the CPU with ``dataset: echat_dataset`` and
    one ``data_path`` (the tiny whisper + tiny LLM sandwich): two steps on
    the 90 % split, then validation on the other 10 %."""
    from slam_llm_tpu_torch.config import set_by_path
    from slam_llm_tpu_torch.pipeline import finetune

    tsv = synth.write_echat_corpus(str(tmp_path), n_dialogs=6)
    cfg = RunConfig()
    for key, val in (("model_config.llm_name", "tiny-test"), ("model_config.encoder_name", "whisper"),
                     ("model_config.encoder_config", "whisper-tiny-test"), ("dataset_config.dataset", "echat_dataset"),
                     ("dataset_config.data_path", tsv), ("dataset_config.mel_size", 8),
                     ("train_config.batch_size_training", 2), ("train_config.val_batch_size", 2),
                     ("train_config.max_steps_per_epoch", 2), ("train_config.num_epochs", 1),
                     ("train_config.output_dir", str(tmp_path / "out")), ("train_config.log_interval", 1)):
        set_by_path(cfg, key, val)
    res = finetune.main(cfg, device="cpu")
    assert len(res["steps"]) == 2 and all(np.isfinite(s["loss"]) for s in res["steps"])
    assert res["final_val"] is not None and np.isfinite(res["final_val"]["loss"])


# ---------------------------------------------------------------------------
# SELD with the encoder unfrozen
# ---------------------------------------------------------------------------


def _unfrozen(kind, freeze_encoder=False):
    """The tiny ``kind`` recipe with ``freeze_encoder: false`` (or as
    given) in both packages: (JAX config, its params, the port model loaded
    from them)."""
    jcfg, tcfg = _recipe(kind)
    jcfg = dataclasses.replace(jcfg, freeze_encoder=freeze_encoder)
    tcfg = dataclasses.replace(tcfg, freeze_encoder=freeze_encoder)
    batch = {k: jnp.asarray(v) for k, v in _batch(kind).items()}
    params = _seeded(JSLAMModel(jcfg).init(jax.random.PRNGKey(0), batch, method="init_all")["params"], seed=5)
    tm = tslam.SLAMModel(tcfg).eval()
    tm.load_state_dict(from_flax_params(params, tcfg))
    return jcfg, params, tm


@pytest.fixture(scope="module")
def unfrozen_seld():
    return _unfrozen("seld")


@pytest.fixture(scope="module")
def unfrozen_mc():
    return _unfrozen("mc")


def _every_grad(kind, jcfg, params, tm):
    """(port loss, JAX loss, the port's gradients and JAX's in the flax
    layout, the port's trainable names) of the unfrozen recipe ``kind``."""
    trainable, frozen = j_partition(params, jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in _batch(kind).items()}

    def loss_fn(tr):
        return JSLAMModel(jcfg).apply({"params": j_merge(tr, frozen)}, jbatch)["loss"]

    jl, jg = jax.value_and_grad(loss_fn)(trainable)
    tr, _ = partition_params(tm, tm.cfg)
    out = tm({k: torch.from_numpy(v) for k, v in _batch(kind).items()})
    grads = torch.autograd.grad(out["loss"], list(tr.values()))
    got = _flat(trainable_to_flax(dict(zip(tr.keys(), grads)), jcfg.encoder_name))
    return float(out["loss"].detach()), float(jl), got, _flat(jg), set(tr)


def _grads_close(got, want):
    """Every gradient within 1e-4 of its own largest entry; the key biases'
    (0 in exact arithmetic: the softmax cancels them) round-off on both
    sides."""
    assert set(got) == set(want)
    top = max(np.abs(w).max() for w in want.values())
    for key, g in got.items():
        assert g.shape == want[key].shape, key
        if key.endswith("k_proj/bias"):
            assert max(np.abs(g).max(), np.abs(want[key]).max()) <= 1e-6 * top, key
            continue
        assert np.abs(g - want[key]).max() <= 1e-4 * np.abs(want[key]).max(), key


def test_unfrozen_seld_loss_and_every_grad_match_jax(unfrozen_seld):
    """Loss within 1e-5 relative and every trainable gradient (Spatial-AST's
    convolutions, BatchNorm statistics, sin-cos table, CLS tokens and ViT
    blocks; the Q-Former) within 1e-4 of its own largest entry, compared in
    the flax layout through ``trainable_to_flax``, so the encoder's inverse
    mapping is held too. ``partition_params`` overrides the encoder's
    ``requires_grad=False``: every encoder tensor trains, as every leaf of
    the JAX encoder is in its trainable tree; the key biases' gradients (0
    in exact arithmetic) are round-off on both sides."""
    jcfg, params, tm = unfrozen_seld
    assert not any(p.requires_grad for p in tm.encoder.parameters())  # built frozen, as the module keeps it
    loss, jl, got, want, names = _every_grad("seld", jcfg, params, tm)
    encoder_names = {n for n in names if n.startswith("encoder.")}
    assert encoder_names == {f"encoder.{n}" for n, _ in tm.encoder.named_parameters()}
    assert {"encoder.bn_mean", "encoder.down.weight", "encoder.pos_embed", "encoder.cls_tokens"} <= encoder_names
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    assert {"encoder/down_kernel", "encoder/bn_var", "encoder/blocks/fc1/kernel"} <= set(got)
    _grads_close(got, want)


def test_unfrozen_mc_loss_and_every_grad_match_jax(unfrozen_mc):
    """The music-captioning recipe with MusicFM unfrozen: as the SELD test
    above. MusicFM's BatchNorm statistics (``running_mean`` /
    ``running_var`` of its conv stem's ``bn*`` and ``conv_bn``) are
    parameters, as the JAX module's ``mean`` / ``var`` leaves are, so they
    train and their gradients match ``jax.value_and_grad``'s."""
    jcfg, params, tm = unfrozen_mc
    loss, jl, got, want, names = _every_grad("mc", jcfg, params, tm)
    encoder_names = {n for n in names if n.startswith("encoder.")}
    assert encoder_names == {f"encoder.{n}" for n, _ in tm.encoder.named_parameters()}
    bns = [n for n, m in tm.encoder.named_modules() if isinstance(m, FrozenBatchNorm)]
    assert bns and all(f"encoder.{n}.{s}" in encoder_names for n in bns for s in ("running_mean", "running_var"))
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    assert {k for k in got if k.endswith(("/mean", "/var"))} == {k for k in want if k.endswith(("/mean", "/var"))}
    assert any(k.endswith("/var") for k in got)
    _grads_close(got, want)


def test_unfrozen_seld_trainer_steps_match_jax(unfrozen_seld):
    """Two steps of the port's Trainer against the JAX ``Trainer.train_step``
    (f32, the LLM stored in bf16, lr 1e-3, warmup 1): the encoder's tensors
    are f32 masters, the global gradient norm (above the clip's 1.0, so the
    clip scales every gradient, the encoder's included) within 1e-5
    relative, and every trainable tensor after each step within 1e-5 of its
    norm, but the key biases: their gradients are round-off on both sides
    (0 in exact arithmetic), below AdamW's eps, so the update normalises
    round-off."""
    from slam_llm_tpu.config import TrainConfig
    from slam_llm_tpu.parallel import make_mesh
    from slam_llm_tpu.train.state import build_trainer
    from slam_llm_tpu_torch.train.state import Trainer

    jcfg, params, tm = unfrozen_seld
    tc = TrainConfig()
    tc.lr, tc.warmup_steps, tc.total_steps, tc.seed = 1e-3, 1, 10, 0
    mesh = make_mesh(dp=1, fsdp=1, tp=1, devices=jax.devices()[:1])
    jt = build_trainer(JSLAMModel(jcfg), jcfg, tc, mesh)
    state = jt.state_from_params(jax.tree_util.tree_map(jnp.asarray, params))
    with mesh:
        db = jt.put_batch(_batch("seld"))
    port = tslam.SLAMModel(tm.cfg)
    port.load_state_dict(tm.state_dict())
    trainer = Trainer(port, port.cfg, tc).state_from_params()
    assert all(p.dtype == torch.float32 for n, p in trainer.trainable.items() if n.startswith("encoder."))
    assert port.llm.embed_tokens.weight.dtype == torch.bfloat16
    tbatch = {k: torch.from_numpy(v) for k, v in _batch("seld").items()}
    for i in range(2):
        with mesh:
            state, m = jt.train_step(state, db, jax.random.PRNGKey(i))
        met = trainer.train_step(tbatch)
        assert float(met["grad_norm"]) > 1.0
        np.testing.assert_allclose(float(met["loss"]), float(m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(met["grad_norm"]), float(m["grad_norm"]), rtol=1e-5)
        want = _flat(state["trainable"])
        got = _flat(trainable_to_flax(trainer.trainable, "spatial_ast"))
        assert set(got) == set(want)
        for key, g in got.items():
            if not key.endswith("k_proj/bias"):
                assert np.linalg.norm(g - want[key]) <= 1e-5 * np.linalg.norm(want[key]), (i, key)
    moved = _flat(trainable_to_flax(trainer.trainable, "spatial_ast"))
    start = _flat(j_partition(params, jcfg)[0])
    assert all(not np.array_equal(moved[k], start[k]) for k in moved if k.startswith("encoder/"))


def test_unfrozen_seld_msgpack_round_trips_with_jax(unfrozen_seld, tmp_path):
    """A JAX ``model.msgpack`` of an unfrozen run (Spatial-AST's flat HWIO
    conv leaves, BatchNorm statistics, table, CLS tokens and stacked blocks,
    the Q-Former) loads into a port model built from other weights and
    gives the JAX weights' tensors exactly; the port's ``model.msgpack``
    of those tensors loads into the JAX package over other weights and
    gives the same leaves exactly."""
    from slam_llm_tpu.utils.checkpoint import load_trainable_into as j_load_into
    from slam_llm_tpu.utils.checkpoint import save_trainable as j_save
    from slam_llm_tpu_torch.utils.checkpoint import load_trainable_into, save_trainable_msgpack

    jcfg, params, tm = unfrozen_seld
    trained = j_partition(params, jcfg)[0]
    other = _seeded(params, seed=11)  # the same tree, every leaf drawn anew
    j_save(str(tmp_path / "jax" / "model.msgpack"), trained)
    port = tslam.SLAMModel(tm.cfg)
    port.load_state_dict(from_flax_params(other, tm.cfg))
    load_trainable_into(port, str(tmp_path / "jax"))
    want = tm.state_dict()
    tr, _ = partition_params(port, port.cfg)
    assert any(n.startswith("encoder.") for n in tr)
    for name, t in port.state_dict().items():
        if name in tr:
            assert torch.equal(t, want[name]), name
    save_trainable_msgpack(str(tmp_path / "port" / "model.msgpack"), tr, port.cfg)
    loaded = _flat(j_load_into(jax.tree_util.tree_map(jnp.asarray, other), str(tmp_path / "port" / "model.msgpack")))
    expect = _flat(params)
    for key, val in _flat(trained).items():
        np.testing.assert_array_equal(loaded[key], expect[key], err_msg=key)
    assert not np.array_equal(loaded["encoder/down_kernel"], _flat(other)["encoder/down_kernel"])


def _trainer_pair(jcfg, params, tm):
    """The JAX ``Trainer``'s state and the port's ``Trainer`` over the same
    weights, with the default ``frozen_dtype`` (bf16), f32 compute, lr
    1e-3, warmup 1: (JAX trainer, its state, its mesh, the port's)."""
    from slam_llm_tpu.config import TrainConfig
    from slam_llm_tpu.parallel import make_mesh
    from slam_llm_tpu.train.state import build_trainer
    from slam_llm_tpu_torch.train.state import Trainer

    tc = TrainConfig()
    tc.lr, tc.warmup_steps, tc.total_steps, tc.seed = 1e-3, 1, 10, 0
    mesh = make_mesh(dp=1, fsdp=1, tp=1, devices=jax.devices()[:1])
    jt = build_trainer(JSLAMModel(jcfg), jcfg, tc, mesh)
    state = jt.state_from_params(jax.tree_util.tree_map(jnp.asarray, params))
    port = tslam.SLAMModel(tm.cfg)
    port.load_state_dict(tm.state_dict())
    return jt, state, mesh, Trainer(port, port.cfg, tc).state_from_params()


def test_frozen_mc_trainer_steps_match_jax():
    """The music-captioning recipe as shipped (MusicFM frozen) through both
    Trainers with the default ``frozen_dtype``: JAX's ``_cast_frozen``
    stores every frozen f32 leaf in bf16, MusicFM's BatchNorm ``mean`` /
    ``var`` included, and the port stores its ``running_mean`` /
    ``running_var`` in bf16 too; two steps' loss and gradient norm within
    1e-5 relative and the projector after each within 1e-5 of its norm."""
    jcfg, params, tm = _unfrozen("mc", freeze_encoder=True)
    jt, state, mesh, trainer = _trainer_pair(jcfg, params, tm)
    jstats = {k: v for k, v in _flat(state["frozen"]).items() if k.endswith(("/mean", "/var"))}
    assert jstats and all(v.dtype == jnp.bfloat16 for v in jstats.values())
    bns = [m for m in trainer.model.encoder.modules() if isinstance(m, FrozenBatchNorm)]
    assert sum(m.running_mean.numel() + m.running_var.numel() for m in bns) == sum(v.size for v in jstats.values())
    assert all(t.dtype == torch.bfloat16 for m in bns for t in (m.running_mean, m.running_var))
    assert set(trainer.trainable) == {n for n, _ in trainer.model.named_parameters() if "encoder_projector" in n}
    with mesh:
        db = jt.put_batch(_batch("mc"))
    tbatch = {k: torch.from_numpy(v) for k, v in _batch("mc").items()}
    for i in range(2):
        with mesh:
            state, m = jt.train_step(state, db, jax.random.PRNGKey(i))
        met = trainer.train_step(tbatch)
        np.testing.assert_allclose(float(met["loss"]), float(m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(met["grad_norm"]), float(m["grad_norm"]), rtol=1e-5)
        want, got = _flat(state["trainable"]), _flat(trainable_to_flax(trainer.trainable, "musicfm"))
        assert set(got) == set(want)
        for key, g in got.items():
            assert np.linalg.norm(g - want[key]) <= 1e-5 * np.linalg.norm(want[key]), (i, key)


def test_unfrozen_mc_msgpack_round_trips_with_jax(unfrozen_mc, tmp_path):
    """As the SELD round trip above, for MusicFM unfrozen: a JAX
    ``model.msgpack`` holds MusicFM's BatchNorm ``mean`` / ``var`` among
    its trained leaves; the port reads them into ``running_mean`` /
    ``running_var`` and writes them back, and the JAX package reads the
    port's file to the same leaves, bit for bit."""
    from slam_llm_tpu.utils.checkpoint import load_trainable_into as j_load_into
    from slam_llm_tpu.utils.checkpoint import save_trainable as j_save
    from slam_llm_tpu_torch.utils.checkpoint import load_trainable_into, save_trainable_msgpack

    jcfg, params, tm = unfrozen_mc
    trained = j_partition(params, jcfg)[0]
    assert any(k.endswith("/var") and k.startswith("encoder/") for k in _flat(trained))
    other = _seeded(params, seed=11)
    j_save(str(tmp_path / "jax" / "model.msgpack"), trained)
    port = tslam.SLAMModel(tm.cfg)
    port.load_state_dict(from_flax_params(other, tm.cfg))
    load_trainable_into(port, str(tmp_path / "jax"))
    want = tm.state_dict()
    assert all(torch.equal(t, want[n]) for n, t in port.state_dict().items() if n.startswith("encoder"))
    tr, _ = partition_params(port, port.cfg)
    assert any(n.endswith(".running_var") for n in tr)
    save_trainable_msgpack(str(tmp_path / "port" / "model.msgpack"), tr, port.cfg)
    loaded = _flat(j_load_into(jax.tree_util.tree_map(jnp.asarray, other), str(tmp_path / "port" / "model.msgpack")))
    expect = _flat(params)
    for key in _flat(trained):
        np.testing.assert_array_equal(loaded[key], expect[key], err_msg=key)


def _bert_tree():
    from slam_llm_tpu.models import bert as jbert

    cfg = jbert.BertConfig.tiny_test()
    ids = jnp.zeros((1, 5), jnp.int32)
    return _seeded(jbert.BertEncoder(cfg).init(jax.random.PRNGKey(0), ids, jnp.ones((1, 5), jnp.int32))["params"],
                   seed=2)


def _encoder_tree(name):
    """A seeded JAX parameter tree of a tiny Spatial-AST, MusicFM or BERT."""
    if name == "hf-text":
        return _bert_tree()
    if name == "spatial_ast":
        feats = jnp.zeros((1, 4, 64, 32), jnp.float32)
        jm = jspatial_ast.SpatialASTEncoder(jspatial_ast.SpatialASTConfig.tiny_test())
        return _seeded(jm.init(jax.random.PRNGKey(0), feats)["params"], seed=3)
    jcfg = dataclasses.replace(jmusicfm.MusicFMConfig.tiny_test(), dtype=jnp.float32)
    mel, mask = jnp.zeros((1, 90, 16), jnp.float32), jnp.ones((1, 90), jnp.int32)
    return _seeded(jmusicfm.MusicFMEncoder(jcfg).init(jax.random.PRNGKey(0), mel, mask)["params"], seed=3)


@pytest.mark.parametrize("name", ["spatial_ast", "musicfm", "hf-text"])
def test_encoder_to_flax_inverts_encoder_from_flax(name):
    """The whole tree and a subset of it (as a trainable checkpoint holds)
    through ``encoder_from_flax`` and back: the same leaves, bit for bit."""
    tree = _encoder_tree(name)
    sd = encoder_from_flax(tree, name)
    back = _flat(encoder_to_flax(sd, name))
    want = _flat(tree)
    assert back.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(back[key], want[key], err_msg=key)
    partial: dict = {}
    for key in sorted(want)[::3]:
        *path, leaf = key.split("/")
        node = partial
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = want[key]
    part_sd = encoder_from_flax(partial, name)
    assert set(part_sd) < set(sd)
    part = _flat(encoder_to_flax(part_sd, name))
    assert part.keys() == set(sorted(want)[::3]) and all(np.array_equal(part[k], want[k]) for k in part)


def test_finetune_unfrozen_seld_then_decode_from_ckpt_path(tmp_path, monkeypatch):
    """The recipe's entry points on the CPU with ``freeze_encoder=false``:
    ``pipeline.finetune`` (2 steps of 2, a narrow Spatial-AST that keeps the
    1024-frame, 128-mel grid) moves every encoder tensor, and ``model.pt``
    carries them; ``pipeline.inference_batch`` with ``ckpt_path`` decodes
    the text of the in-memory trained model."""
    from slam_llm_tpu_torch.config import load_run_config
    from slam_llm_tpu_torch.inference.generate import strip_after_eos
    from slam_llm_tpu_torch.pipeline import finetune, inference_batch
    from slam_llm_tpu_torch.pipeline.common import build_model_and_data, materialize_params
    from slam_llm_tpu_torch.registry import get_custom_dataset_factory
    from slam_llm_tpu_torch.utils.checkpoint import load_trainable

    monkeypatch.setitem(tspatial_ast.SPATIAL_AST_PRESETS, "spatialast-narrow-test",
                        lambda: tspatial_ast.SpatialASTConfig(d_model=32, n_heads=2, n_layers=2))
    over = synth.write_seld_corpus(str(tmp_path / "seld"), n=4, n_eval=2, n_reverbs=2)
    common = ["--config", "examples/seld_spatialsoundqa/conf/seld_spatialast_llama.yaml",
              "++model_config.llm_name=tiny-test", "++model_config.encoder_config=spatialast-narrow-test",
              "++model_config.encoder_dim=32", "++model_config.qformer_layers=1", "++model_config.qformer_dim=32",
              "++model_config.qformer_heads=2", "++train_config.freeze_encoder=false",
              *(f"++dataset_config.{k}={v}" for k, v in over.items())]
    cfg = load_run_config(common + [
        "++train_config.batch_size_training=2", "++train_config.max_steps_per_epoch=2",
        "++train_config.num_epochs=1", "++train_config.warmup_steps=1", "++train_config.lr=1e-3",
        "++train_config.run_validation=false", "++train_config.frozen_dtype=float32", "++train_config.log_interval=1",
        f"++train_config.output_dir={tmp_path / 'out'}"])
    res = finetune.main(cfg, device="cpu")
    trainer = res["trainer"]
    assert len(res["steps"]) == 2 and trainer.model.cfg.freeze_encoder is False
    fresh, _, _ = build_model_and_data(cfg, split="train", device="cpu")
    materialize_params(fresh, cfg)
    init = dict(fresh.named_parameters())
    encoder = [n for n in trainer.trainable if n.startswith("encoder.")]
    assert len(encoder) == len(list(fresh.encoder.parameters()))
    assert all(not torch.equal(trainer.trainable[n], init[n]) for n in encoder)
    saved = load_trainable(res["checkpoints"][-1])
    assert set(saved) == set(trainer.trainable)
    assert all(torch.equal(saved[n], p.detach()) for n, p in trainer.trainable.items())

    dec = load_run_config(common + [
        f"++ckpt_path={res['checkpoints'][-1]}", f"++decode_config.decode_log={tmp_path / 'decode'}",
        "++decode_config.max_new_tokens=4", "++decode_config.num_beams=2", "++train_config.val_batch_size=2"])
    out = inference_batch.main(dec, device="cpu")
    tokenizer = ByteTokenizer()
    dataset = get_custom_dataset_factory(dec.dataset_config)(dec.dataset_config, tokenizer,
                                                             dec.dataset_config.test_split)
    gen = Generator(trainer.model.eval(), inference_batch.generation_config(dec, tokenizer))
    mine = []
    for batch in inference_batch.decode_loader(dec, dataset):
        toks = strip_after_eos(gen.generate({k: v for k, v in batch.items() if isinstance(v, np.ndarray)}),
                               tokenizer.eos_token_id, tokenizer.pad_token_id)
        mine += [f"{key}\t{tokenizer.decode(t)}\n" for key, t in zip(batch["keys"], toks)]
    with open(out["pred"], encoding="utf-8", newline="") as f:
        assert out["n"] == 2 and f.read() == "".join(mine)
