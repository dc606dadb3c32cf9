"""The VSR recipe's pieces in the port against the JAX package, on the CPU
(tiny widths, numpy-seeded inputs).

* ``logfbank_psf`` and ``stacked_logfbank`` within 1e-5 relative of the JAX
  functions;
* ``VideoFrontend`` and ``AVHubertEncoder`` (video only, audio only, audio +
  video, a ragged frame mask) against the JAX modules in f32, the same
  parameters through ``utils.convert``, within 1e-4 relative; the
  converters of both packages on one fairseq-layout file written by
  ``tools/synth_checkpoint.write_avhubert``, and the encoder-file dispatch;
  ``encoder_to_flax`` inverting ``encoder_from_flax`` (the Conv3d stem);
* the dataset's items and batches equal to the JAX dataset's on ``.avi``
  files written with OpenCV from seeded frames (the training crop and flip
  under the seeded rng, the centre crop, audio + video);
* the tiny VSR slice (AV-HuBERT, linear ds 5, the tiny LLM, f32): the loss
  and projector gradients against ``jax.value_and_grad`` within 1e-5
  relative, beam-4 tokens identical to the JAX ``Generator``;
* a VSR batch's RTF seconds (the JAX pipeline's are nan), and the VSR
  recipe's ``file:`` spec resolved in a fresh interpreter without importing
  the JAX package or jax.
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

from slam_llm_tpu.data import avhubert_dataset as jds_mod
from slam_llm_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from slam_llm_tpu.inference.generate import GenerationConfig as JGenerationConfig
from slam_llm_tpu.inference.generate import Generator as JGenerator
from slam_llm_tpu.models import avhubert as javhubert
from slam_llm_tpu.models.llm import LLMConfig as JLLMConfig
from slam_llm_tpu.models.projector import ProjectorConfig as JProjectorConfig
from slam_llm_tpu.models.slam_model import SLAMConfig as JSLAMConfig
from slam_llm_tpu.models.slam_model import SLAMModel as JSLAMModel
from slam_llm_tpu.ops import fbank as jfbank
from slam_llm_tpu.train.optimizer import merge_params as j_merge
from slam_llm_tpu.train.optimizer import partition_params as j_partition
from slam_llm_tpu_torch.config import RunConfig
from slam_llm_tpu_torch.data import avhubert_dataset as tds_mod
from slam_llm_tpu_torch.data.tokenizer import ByteTokenizer
from slam_llm_tpu_torch.inference.generate import GenerationConfig, Generator
from slam_llm_tpu_torch.models import avhubert as tavhubert
from slam_llm_tpu_torch.models import llm as tllm
from slam_llm_tpu_torch.models import projector as tproj
from slam_llm_tpu_torch.models import slam_model as tslam
from slam_llm_tpu_torch.ops import fbank as tfbank
from slam_llm_tpu_torch.tools import synth_checkpoint as synth
from slam_llm_tpu_torch.train.optimizer import partition_params
from slam_llm_tpu_torch.utils import hf_loader
from slam_llm_tpu_torch.utils.convert import encoder_from_flax, encoder_to_flax, from_flax_params, trainable_to_flax
from test_torch_music_spatial import _close, _configs, _conv, _flat, _same, _seeded

cv2 = pytest.importorskip("cv2")

REPO = Path(__file__).resolve().parent.parent
VSR_RECIPE = REPO / "examples" / "vsr_LRS3" / "conf" / "vsr_avhubert_vicuna.yaml"
EOS, PAD = 257, 258  # ByteTokenizer's


# ---------------------------------------------------------------------------
# the audio features
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [16000, 37123, 300])  # a second, a ragged length, shorter than one window
def test_logfbank_psf_and_stacked_logfbank_match_jax(n):
    x = (np.random.default_rng(n).standard_normal(n) * 0.1).astype(np.float32)
    got, want = tfbank.logfbank_psf(x * 32768.0), jfbank.logfbank_psf(x * 32768.0)
    assert got.dtype == np.float32 and got.shape == want.shape and got.shape[1] == 26
    _close(got, want)
    got, want = tavhubert.stacked_logfbank(x), javhubert.stacked_logfbank(x)
    assert got.shape == want.shape and got.shape[1] == 104
    _close(got, want)


# ---------------------------------------------------------------------------
# the encoder and the converters
# ---------------------------------------------------------------------------


def _jcfg():
    return dataclasses.replace(javhubert.AVHubertConfig.tiny_test(), dtype=jnp.float32)


def _inputs(t=7, hw=24, b=2):
    rng = np.random.default_rng(0)
    video = rng.standard_normal((b, t, hw, hw)).astype(np.float32)
    feats = rng.standard_normal((b, t, 16)).astype(np.float32)
    mask = np.ones((b, t), np.int32)
    mask[1, t - 2:] = 0
    return video, feats, mask


@pytest.fixture(scope="module")
def encoder_pair():
    jcfg = _jcfg()
    video, feats, mask = _inputs()
    jm = javhubert.AVHubertEncoder(jcfg)
    params = _seeded(jm.init(jax.random.PRNGKey(0), jnp.asarray(video), jnp.asarray(feats), jnp.asarray(mask))
                     ["params"], seed=3)
    tm = tavhubert.AVHubertEncoder(_conv(tavhubert.AVHubertConfig, jcfg))
    tm.load_state_dict(encoder_from_flax(params, "av_hubert"))
    return jm, params, tm


@pytest.mark.parametrize("modal", ["video", "audio", "audio_video", "audio_video_unmasked"])
def test_encoder_matches_jax(encoder_pair, modal):
    """The missing modality is zeros in both; the ragged row's padded frames
    are zeroed before the positional conv and masked as keys."""
    jm, params, tm = encoder_pair
    video, feats, mask = _inputs()
    args = (video if "video" in modal else None, feats if "audio" in modal else None,
            None if modal.endswith("unmasked") else mask)
    want, want_mask = jm.apply({"params": params}, *(None if a is None else jnp.asarray(a) for a in args))
    with torch.no_grad():
        got, got_mask = tm(*(None if a is None else torch.from_numpy(a) for a in args))
    assert got.shape == (2, 7, 32) and got.dtype == torch.float32
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    _close(got.numpy(), np.asarray(want), rel=1e-4)


def test_video_frontend_matches_jax(encoder_pair):
    """The Conv3d stem, the -inf padded max-pool, time folded into the batch,
    the four ResNet stages and the spatial mean, at an odd frame size."""
    _, params, tm = encoder_pair
    video = _inputs(t=3, hw=29)[0]
    want = javhubert.VideoFrontend(_jcfg()).apply({"params": params["video_frontend"]}, jnp.asarray(video))
    with torch.no_grad():
        got = tm.video_frontend(torch.from_numpy(video))
    assert got.shape == (2, 3, 16)
    _close(got.numpy(), np.asarray(want), rel=1e-4)


def test_encoder_to_flax_inverts_encoder_from_flax(encoder_pair):
    _, params, _ = encoder_pair
    back = _flat(encoder_to_flax(encoder_from_flax(params, "av_hubert"), "av_hubert"))
    want = _flat(params)
    assert back.keys() == want.keys() and back["video_frontend/stem/kernel"].shape == (5, 7, 7, 1, 2)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_convert_avhubert_fairseq_matches_jax_converter(tmp_path):
    """One fairseq-layout file (unfolded BatchNorms, a weight-normed
    positional conv) through both converters: equal tensors, and equal
    encoder outputs; the encoder-file dispatch loads it into a model."""
    cfg = dataclasses.replace(tavhubert.AVHubertConfig.tiny_test(), dtype=torch.float32)
    path = tmp_path / "avhubert.pt"
    synth.write_avhubert(str(path), cfg, seed=7)
    sd = hf_loader.load_torch_checkpoint(str(path))
    got = tavhubert.convert_avhubert_fairseq(sd, cfg)
    jparams = javhubert.convert_avhubert_fairseq({"model": sd}, _jcfg())
    want = encoder_from_flax(jparams, "av_hubert")
    assert got.keys() == want.keys() == tavhubert.AVHubertEncoder(cfg).state_dict().keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    enc = hf_loader.overlay_(tavhubert.AVHubertEncoder(cfg), hf_loader.convert_encoder_checkpoint(
        str(path), "av_hubert", cfg))
    assert torch.equal(enc.layers[1].attention.k_proj.weight, sd["encoder.layers.1.self_attn.k_proj.weight"])
    video, feats, mask = _inputs()
    want_out = javhubert.AVHubertEncoder(_jcfg()).apply({"params": jparams}, jnp.asarray(video), None,
                                                        jnp.asarray(mask))[0]
    with torch.no_grad():
        got_out = enc(torch.from_numpy(video), None, torch.from_numpy(mask))[0]
    _close(got_out.numpy(), np.asarray(want_out), rel=1e-4)


# ---------------------------------------------------------------------------
# the dataset
# ---------------------------------------------------------------------------


def _video_corpus(tmp_path, n=4):
    """``n`` seeded 96 x 96 MJPG clips of 9-15 frames, each with a wav of
    its length at 25 fps (a little longer for clip 1, so the audio features
    are cut), and a jsonl manifest."""
    rows = []
    for i in range(n):
        rng = np.random.default_rng(i)
        frames = 9 + 2 * i
        path = str(tmp_path / f"v{i}.avi")
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 25, (96, 96))
        for _ in range(frames):
            w.write(np.clip(rng.integers(0, 255, (96, 96, 3)), 0, 255).astype(np.uint8))
        w.release()
        wav = str(tmp_path / f"a{i}.wav")
        synth.write_wav(wav, 0.2 * rng.standard_normal(640 * frames + 1600 * (i == 1)), 16000)
        rows.append({"key": f"v{i}", "video": path, "source": wav, "target": f"lips {i}"})
    manifest = tmp_path / "vsr.jsonl"
    manifest.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return str(manifest)


@pytest.mark.parametrize("split,modal,inference", [("train", "video", False), ("test", "video", True),
                                                    ("train", "audio_video", False)])
def test_dataset_items_and_batches_match_jax(tmp_path, split, modal, inference):
    manifest = _video_corpus(tmp_path)
    jc, tc = _configs(dataset="avhubert_dataset", train_data_path=manifest, val_data_path=manifest, modal=modal,
                      prompt=None, encoder_projector_ds_rate=5, inference_mode=inference)
    tds = tds_mod.get_avhubert_dataset(tc, ByteTokenizer(), split)
    jds = jds_mod.get_avhubert_dataset(jc, JByteTokenizer(), split)
    assert tds.prompt == tds_mod.DEFAULT_VSR_PROMPT
    titems, jitems = [tds[i] for i in range(4)], [jds[i] for i in range(4)]
    for a, b in zip(titems, jitems):
        _same(a, b)
    assert titems[3]["visual"].shape == (15, 88, 88)
    if modal == "audio_video":
        assert titems[1]["audio_feats"].shape == (11, 104)
    _same(tds.collator(titems[:3]), jds.collator(jitems[:3]))
    centre = [tds_mod.load_video_gray(str(tmp_path / f"v{i}.avi"))[: len(titems[i]["visual"])] for i in range(4)]
    assert all(np.array_equal(a["visual"], c) for a, c in zip(titems, centre)) == (split != "train")


def test_registry_resolves_the_vsr_dataset():
    from slam_llm_tpu_torch.registry import get_custom_dataset_factory

    cfg = RunConfig().dataset_config
    cfg.dataset = "avhubert_dataset"
    assert get_custom_dataset_factory(cfg) is tds_mod.get_avhubert_dataset
    cfg.file = "slam_llm_tpu.data.avhubert_dataset:get_avhubert_dataset"
    assert get_custom_dataset_factory(cfg) is tds_mod.get_avhubert_dataset
    cfg.file = "slam_llm_tpu.data.s2s_dataset:get_speech_dataset"
    with pytest.raises(NotImplementedError, match="not ported"):
        get_custom_dataset_factory(cfg)


_PROBE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from slam_llm_tpu_torch.config import load_run_config
from slam_llm_tpu_torch.registry import get_custom_dataset_factory

cfg = load_run_config(["--config", sys.argv[2]])
factory = get_custom_dataset_factory(cfg.dataset_config)
print(json.dumps({"spec": cfg.dataset_config.file, "factory": f"{factory.__module__}:{factory.__name__}",
                  "jax": "jax" in sys.modules,
                  "slam_llm_tpu": sorted(m for m in sys.modules if m.split(".")[0] == "slam_llm_tpu")}))
"""


def test_vsr_recipe_spec_resolves_to_the_port_without_jax():
    """The recipe names ``slam_llm_tpu.data.avhubert_dataset``; a fresh
    interpreter resolves it to the port's module and never imports the
    JAX package or jax (the card's host has neither)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE, str(REPO), str(VSR_RECIPE)], capture_output=True, text=True,
                         env=env, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "spec": "slam_llm_tpu.data.avhubert_dataset:get_avhubert_dataset",
        "factory": "slam_llm_tpu_torch.data.avhubert_dataset:get_avhubert_dataset", "jax": False,
        "slam_llm_tpu": []}


def test_vsr_batch_seconds_count_the_video_frames():
    """A VSR decode batch carries only ``visual_mask``: its RTF counts the
    valid frames at 25 fps (the JAX pipeline's RTF is nan: it has no video
    branch)."""
    from slam_llm_tpu_torch.pipeline.inference_batch import batch_audio_seconds

    mask = np.zeros((3, 150), np.int32)
    for i, t in enumerate((150, 75, 51)):
        mask[i, :t] = 1
    batch = {"input_ids": np.zeros((3, 5)), "visual": np.zeros((3, 150, 88, 88), np.float32), "visual_mask": mask}
    assert batch_audio_seconds(batch) == pytest.approx((150 + 75 + 51) / 25.0)


# ---------------------------------------------------------------------------
# the tiny VSR slice
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vsr_slice(tmp_path_factory):
    """The recipe's pieces at tiny width in f32 (avhubert-tiny-test, linear
    ds 5, the tiny LLM with the byte tokenizer's 259 ids), everything frozen
    but the projector; a training batch of three clips (88 x 88 crops, 9-13
    frames) from the port's dataset."""
    tmp = tmp_path_factory.mktemp("vsr")
    manifest = _video_corpus(tmp, n=3)
    _, tc = _configs(train_data_path=manifest, val_data_path=manifest, modal="video", prompt="Read the lips. ",
                     encoder_projector_ds_rate=5)
    ds = tds_mod.get_avhubert_dataset(tc, ByteTokenizer(), "train")
    batch = ds.collator([ds[i] for i in range(3)])
    llm = dataclasses.replace(JLLMConfig.tiny_test(vocab_size=259), lora_rank=0, dtype=jnp.float32)
    enc = _jcfg()
    proj = JProjectorConfig(encoder_dim=enc.d_model, llm_dim=llm.d_model, ds_rate=5, hidden_dim=32,
                            dtype=jnp.float32)
    jcfg = JSLAMConfig(llm=llm, encoder_name="av_hubert", encoder=enc, projector="linear", projector_cfg=proj,
                       freeze_encoder=True, freeze_llm=True)
    tcfg = tslam.SLAMConfig(
        llm=dataclasses.replace(_conv(tllm.LLMConfig, llm), remat=False), encoder_name="av_hubert",
        encoder=_conv(tavhubert.AVHubertConfig, enc), projector="linear",
        projector_cfg=_conv(tproj.ProjectorConfig, proj), freeze_encoder=True, freeze_llm=True)
    # flax creates audio_proj only when it sees audio features: init with them, run video only
    jbatch = {k: jnp.asarray(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
    jbatch["audio_feats"] = jnp.zeros((*batch["visual"].shape[:2], enc.audio_feat_dim), jnp.float32)
    params = _seeded(JSLAMModel(jcfg).init(jax.random.PRNGKey(0), jbatch, method="init_all")["params"], seed=5)
    tm = tslam.SLAMModel(tcfg).eval()
    tm.load_state_dict(from_flax_params(params, tcfg))
    return jcfg, params, tm, {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


def test_vsr_slice_loss_and_projector_grads_match_jax(vsr_slice):
    jcfg, params, tm, batch = vsr_slice
    assert batch["visual"].shape == (3, 13, 88, 88) and batch["visual_mask"].sum(1).tolist() == [9, 11, 13]
    trainable, frozen = j_partition(params, jcfg)

    def loss_fn(tr):
        out = JSLAMModel(jcfg).apply({"params": j_merge(tr, frozen)}, {k: jnp.asarray(v) for k, v in batch.items()})
        return out["loss"], out["acc"]

    (jl, ja), jg = jax.value_and_grad(loss_fn, has_aux=True)(trainable)
    tr, _ = partition_params(tm, tm.cfg)
    assert tr and all(n.startswith("encoder_projector.") for n in tr)
    out = tm({k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(out["loss"], list(tr.values()))
    np.testing.assert_allclose(float(out["loss"].detach()), float(jl), rtol=1e-5)
    assert float(out["acc"]) == float(ja)
    got, want = _flat(trainable_to_flax(dict(zip(tr.keys(), grads)))), _flat(jg)
    assert set(got) == set(want)
    for key, g in got.items():
        _close(g, want[key])


def test_vsr_slice_beam_tokens_identical_to_jax(vsr_slice):
    """The ``visual`` / ``visual_mask`` keys reach the encoder through the
    port's ``Generator`` as through the JAX one."""
    jcfg, params, tm, batch = vsr_slice
    kw = dict(max_new_tokens=6, num_beams=4, eos_token_id=EOS, pad_token_id=PAD)
    dec = {k: v for k, v in batch.items() if k != "labels"}
    want = JGenerator(JSLAMModel(jcfg), JGenerationConfig(**kw)).generate({"params": params}, dec)
    got = Generator(tm, GenerationConfig(**kw)).generate(dec)
    assert got.shape == want.shape == (3, 6)
    np.testing.assert_array_equal(got, want)
