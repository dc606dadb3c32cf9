"""The WavLM recipe's pieces in the port against the JAX package, on the CPU.

``asr_wavlm_vicuna`` (WavLM-large, a linear projector, vicuna-7b with the
int8 base and the bf16 backward) at tiny widths:

* ``relative_position_buckets`` and ``feature_lengths`` equal the JAX
  package's;
* the port's ``WavLMEncoder`` against the JAX one on the same numpy-seeded
  parameters (``utils.convert.flax_to_state_dict``), ragged masks: f32 within
  1e-5 (rel-pos bias on and off, group norm + post-LN, layer norm + pre-LN,
  ``deep_norm`` with ``gate_from_query``), bf16 within cosine 0.999;
* ``convert_wavlm`` / ``convert_hubert_fairseq`` and the encoder dispatch
  on tiny HF ``WavLMModel`` / ``HubertModel`` checkpoints written by
  ``transformers``, at ``tests/test_wavlm_parity.py``'s tolerances, with both
  weight-norm key forms, and ``tools/synth_checkpoint.write_wavlm``'s
  directory read by ``transformers``;
* a tiny SLAMModel (wavlm + linear + a tiny LLM with the int8 base, the
  bf16 backward, frozen LLM): loss, accuracy and projector gradients against
  ``jax.value_and_grad`` (encoder gradients too when the encoder trains),
  greedy and beam-4 tokens identical to the JAX ``Generator`` on a raw-audio
  batch, and the reference's slot convention at a 160,000-sample utterance;
* ``pipeline.finetune`` -> ``pipeline.inference_batch`` with ``ckpt_path`` and
  ``input_type: raw`` against the JAX pipelines, the raw-audio RTF, and the
  recipes' configs (``asr_wavlm_vicuna``, ``sec_emotion2vec_vicuna``).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from slam_llm_tpu.inference.generate import GenerationConfig as JGenerationConfig
from slam_llm_tpu.inference.generate import Generator as JGenerator
from slam_llm_tpu.models import wavlm as jwavlm
from slam_llm_tpu.models.llm import LLMConfig as JLLMConfig
from slam_llm_tpu.models.projector import ProjectorConfig as JProjectorConfig
from slam_llm_tpu.models.slam_model import SLAMConfig as JSLAMConfig
from slam_llm_tpu.models.slam_model import SLAMModel as JSLAMModel
from slam_llm_tpu.train.optimizer import merge_params as j_merge
from slam_llm_tpu.train.optimizer import partition_params as j_partition
from slam_llm_tpu_torch.inference.generate import GenerationConfig, Generator
from slam_llm_tpu_torch.models import llm as tllm
from slam_llm_tpu_torch.models import projector as tproj
from slam_llm_tpu_torch.models import slam_model as tslam
from slam_llm_tpu_torch.models import wavlm as twavlm
from slam_llm_tpu_torch.train.optimizer import partition_params
from slam_llm_tpu_torch.utils import hf_loader
from slam_llm_tpu_torch.utils.convert import flax_to_state_dict, from_flax_params, trainable_to_flax

REPO = Path(__file__).resolve().parent.parent
EOS, PAD = 2, 0


def _seeded(tree, seed):
    """Every float leaf of a flax parameter tree redrawn from a numpy
    generator: normal with std 1/sqrt(fan_in) for kernels and tables, around
    1 for LayerNorm scales and the gate constants, small for biases. The int8
    base (``kernel_q`` and its scales) keeps its init."""
    rng = np.random.default_rng(seed)

    def draw(key, x):
        shape = np.shape(x)
        if key.startswith("kernel_") and key != "kernel":
            return np.asarray(x)
        if key in ("scale", "gn_scale", "gru_rel_pos_const"):
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if key in ("bias", "gn_bias"):
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else draw(k, v) for k, v in node.items()}

    return walk(nn.meta.unbox(tree))


def _port_enc_cfg(jcfg, dtype=torch.float32):
    names = {f.name for f in dataclasses.fields(twavlm.WavLMConfig)} - {"dtype"}
    return twavlm.WavLMConfig(**{n: getattr(jcfg, n) for n in names}, dtype=dtype)


# the published 320x conv stack at tiny widths (10 s of audio -> 499 frames),
# for the tests that feed the speech dataset's buckets of 3-10 s
NARROW = dict(d_model=32, n_heads=2, n_layers=2, ffn_dim=64, conv_dim=(8,) * 7, conv_pos=16, conv_pos_groups=2,
              num_buckets=32, max_distance=50)


@pytest.fixture
def narrow_preset(monkeypatch):
    """``wavlm-narrow-test`` (NARROW) in both packages' preset tables."""
    monkeypatch.setitem(twavlm.WAVLM_PRESETS, "wavlm-narrow-test", lambda: twavlm.WavLMConfig(**NARROW))
    monkeypatch.setitem(jwavlm.WAVLM_PRESETS, "wavlm-narrow-test", lambda: jwavlm.WavLMConfig(**NARROW))


def _audio(b=2, s=2000, seed=0):
    """Waveforms of ``s`` samples; row i > 0 padded from 1300 - 300 (i - 1)."""
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((b, s)) * 0.1).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    for i in range(1, b):
        mask[i, 1300 - 300 * (i - 1):] = 0
        audio[i, 1300 - 300 * (i - 1):] = 0.0
    return audio, mask


# ---------------------------------------------------------------------------
# host helpers and the encoder alone
# ---------------------------------------------------------------------------


def test_buckets_and_feature_lengths_equal_jax():
    for t, nb, md in ((1, 32, 50), (37, 32, 50), (199, 320, 800), (499, 320, 800)):
        np.testing.assert_array_equal(twavlm.relative_position_buckets(t, nb, md),
                                      jwavlm.relative_position_buckets(t, nb, md))
    for preset in ("wavlm-large", "wavlm-tiny-test"):
        tcfg, jcfg = twavlm.WAVLM_PRESETS[preset](), jwavlm.WAVLM_PRESETS[preset]()
        for n in (320, 400, 1000, 16000, 159999, 160000, 480000):
            assert twavlm.feature_lengths(n, tcfg) == jwavlm.feature_lengths(n, jcfg)
        lengths = np.array([400, 16000, 160000])
        np.testing.assert_array_equal(twavlm.feature_lengths(torch.from_numpy(lengths), tcfg).numpy(),
                                      np.asarray(jwavlm.feature_lengths(jnp.asarray(lengths), jcfg)))
    assert twavlm.feature_lengths(160000, twavlm.WavLMConfig.wavlm_large()) == 499


ENCODERS = {
    "wavlm_base_group_postln": {},
    "hubert_no_rel_bias": {"rel_bias": False},
    "wavlm_large_layer_preln": {"feat_extract_norm": "layer", "do_stable_layer_norm": True},
    "deep_norm_gate_from_query": {"deep_norm": True, "gate_from_query": True},
}


def _encoder_pair(kw, dtype=torch.float32, jdtype=jnp.float32, seed=1):
    jcfg = dataclasses.replace(jwavlm.WavLMConfig.tiny_test(), dtype=jdtype, **kw)
    audio, mask = _audio(3)
    enc = jwavlm.WavLMEncoder(jcfg)
    params = _seeded(enc.init(jax.random.PRNGKey(0), jnp.asarray(audio), jnp.asarray(mask))["params"], seed)
    te = twavlm.WavLMEncoder(_port_enc_cfg(jcfg, dtype)).eval()
    te.load_state_dict(flax_to_state_dict(params))
    return enc, params, te, audio, mask


@pytest.mark.parametrize("name", list(ENCODERS))
def test_encoder_matches_jax_f32(name):
    """f32: the port's output within 1e-5 of the JAX encoder's at every frame
    (padded frames included), the output masks equal, ragged masks."""
    enc, params, te, audio, mask = _encoder_pair(ENCODERS[name])
    want, want_mask = enc.apply({"params": params}, jnp.asarray(audio), jnp.asarray(mask))
    with torch.no_grad():
        got, got_mask = te(torch.from_numpy(audio), torch.from_numpy(mask))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert got_mask.dtype == torch.int32 and got.shape == (3, 199, 32)
    assert int(got_mask[2].sum()) < int(got_mask[1].sum()) < int(got_mask[0].sum())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # without a mask: every frame valid, the rel-pos bias alone
    want, _ = enc.apply({"params": params}, jnp.asarray(audio))
    with torch.no_grad():
        got, got_mask = te(torch.from_numpy(audio))
    assert bool((got_mask == 1).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["wavlm_base_group_postln", "wavlm_large_layer_preln"])
def test_encoder_matches_jax_bf16(name):
    """bf16 compute on both sides: cosine >= 0.999 at every valid frame."""
    enc, params, te, audio, mask = _encoder_pair(ENCODERS[name], torch.bfloat16, jnp.bfloat16)
    want, want_mask = enc.apply({"params": params}, jnp.asarray(audio), jnp.asarray(mask))
    with torch.no_grad():
        got, _ = te(torch.from_numpy(audio), torch.from_numpy(mask))
    live = np.asarray(want_mask).astype(bool)
    g, w = got.float().numpy()[live], np.asarray(want, np.float32)[live]
    cos = (g * w).sum(-1) / (np.linalg.norm(g, axis=-1) * np.linalg.norm(w, axis=-1))
    assert got.dtype == torch.bfloat16 and cos.min() >= 0.999


# ---------------------------------------------------------------------------
# HF checkpoints
# ---------------------------------------------------------------------------


def _tiny_hf_kwargs(**kw):
    return {**dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
                   conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2), num_conv_pos_embeddings=16,
                   num_conv_pos_embedding_groups=2, do_stable_layer_norm=False, feat_extract_norm="group",
                   hidden_dropout=0.0, attention_dropout=0.0, feat_proj_dropout=0.0, layerdrop=0.0,
                   activation_dropout=0.0), **kw}


def _port_tiny(rel_bias=True, stable=False, norm="group"):
    return twavlm.WavLMConfig(d_model=32, n_heads=2, n_layers=2, ffn_dim=64, conv_dim=(16, 16), conv_kernel=(10, 3),
                              conv_stride=(5, 2), conv_pos=16, conv_pos_groups=2, num_buckets=32, max_distance=50,
                              rel_bias=rel_bias, do_stable_layer_norm=stable, feat_extract_norm=norm,
                              dtype=torch.float32)


def _hf_model(kind, seed, **kw):
    from transformers import HubertConfig, HubertModel, WavLMConfig, WavLMModel

    torch.manual_seed(seed)
    if kind == "hubert":
        return HubertModel(HubertConfig(**_tiny_hf_kwargs(**kw))).eval()
    return WavLMModel(WavLMConfig(**_tiny_hf_kwargs(**kw), num_buckets=32, max_bucket_distance=50)).eval()


def _run_port(cfg, sd, audio):
    enc = twavlm.WavLMEncoder(cfg).eval()
    hf_loader.overlay_(enc, sd)
    with torch.no_grad():
        return enc(torch.from_numpy(audio))[0].numpy()


def _weight_g_form(sd):
    """The pre-parametrization weight-norm names (``weight_g`` / ``weight_v``)."""
    return {k.replace("parametrizations.weight.original0", "weight_g")
             .replace("parametrizations.weight.original1", "weight_v"): v for k, v in sd.items()}


@pytest.mark.parametrize("kind,stable", [("wavlm", False), ("wavlm", True), ("hubert", False)])
def test_convert_matches_hf(tmp_path, kind, stable):
    """An HF directory through ``convert_encoder_checkpoint`` (the port's own
    safetensors reader) against HF's ``last_hidden_state``, and the same
    state dict with the positional conv's weight norm under either key form."""
    kw = dict(do_stable_layer_norm=True, feat_extract_norm="layer") if stable else {}
    hf = _hf_model(kind, seed=int(stable) + 2 * (kind == "hubert"), **kw)
    hf.save_pretrained(tmp_path, safe_serialization=True)
    audio, _ = _audio(2, 2000, seed=5)
    with torch.no_grad():
        ref = hf(torch.from_numpy(audio)).last_hidden_state.numpy()
    cfg = _port_tiny(rel_bias=kind == "wavlm", stable=stable, norm="layer" if stable else "group")
    sd = hf_loader.convert_encoder_checkpoint(str(tmp_path), kind, cfg)
    got = _run_port(cfg, sd, audio)
    np.testing.assert_allclose(got, ref, atol=5e-4, rtol=1e-3)
    state = hf.state_dict()
    forms = {"original": state, "weight_g": _weight_g_form(state)}
    assert {any(k.endswith(s) for k in f) for f, s in zip(forms.values(), ("original0", "weight_g"))} == {True}
    for form in forms.values():
        folded = twavlm.convert_wavlm(form, cfg)
        assert torch.equal(folded["pos_conv.conv.weight"], sd["pos_conv.conv.weight"])
        np.testing.assert_allclose(_run_port(cfg, folded, audio), ref, atol=5e-4, rtol=1e-3)


def test_hubert_fairseq_checkpoint_matches_hf(tmp_path):
    """A fairseq-schema HuBERT file (``{"model": sd}`` with its pretraining
    heads) through ``convert_encoder_checkpoint``, against HF."""
    from test_wavlm_parity import _hf_to_fairseq_schema

    hf = _hf_model("hubert", seed=3)
    audio, _ = _audio(2, 2000, seed=6)
    with torch.no_grad():
        ref = hf(torch.from_numpy(audio)).last_hidden_state.numpy()
    fairseq = {k: torch.from_numpy(np.asarray(v)) for k, v in
               _hf_to_fairseq_schema({k: v.numpy() for k, v in hf.state_dict().items()}).items()}
    torch.save({"model": fairseq, "cfg": {"task": "hubert_pretraining"}}, tmp_path / "hubert.pt")
    cfg = _port_tiny(rel_bias=False)
    sd = hf_loader.convert_encoder_checkpoint(str(tmp_path / "hubert.pt"), "hubert", cfg)
    np.testing.assert_allclose(_run_port(cfg, sd, audio), ref, atol=5e-4, rtol=1e-3)
    with pytest.raises(ValueError, match="cannot load an HF directory"):
        hf_loader.convert_encoder_checkpoint(str(tmp_path), "emotion2vec", cfg)


@pytest.mark.parametrize("preset", ["wavlm-tiny-test", "hubert-tiny"])
def test_synth_wavlm_directory_reads_in_transformers(tmp_path, preset):
    """``write_wavlm`` writes an HF directory (bf16, the positional conv as
    ``weight_g`` / ``weight_v``) that transformers loads as ``WavLMModel`` /
    ``HubertModel``; the port's loader folds the same weights and gives HF's
    output in f32, and the CLI's ``--encoder`` writes a preset's directory."""
    from transformers import AutoModel

    from slam_llm_tpu_torch.tools import synth_checkpoint as synth
    from slam_llm_tpu_torch.utils.safetensors_io import load_file

    cfg = dataclasses.replace(twavlm.WavLMConfig.tiny_test(rel_bias=preset.startswith("wavlm")), dtype=torch.float32)
    written = synth.write_wavlm(str(tmp_path), cfg, seed=3)
    raw = load_file(str(tmp_path / "model.safetensors"))
    assert written > 0 and {t.dtype for t in raw.values()} == {torch.bfloat16}
    assert any(k.endswith("pos_conv_embed.conv.weight_g") for k in raw)
    ref_model = AutoModel.from_pretrained(str(tmp_path), dtype=torch.float32).eval()
    assert type(ref_model).__name__ == ("WavLMModel" if cfg.rel_bias else "HubertModel")
    audio, _ = _audio(2, 2000, seed=7)
    with torch.no_grad():
        ref = ref_model(torch.from_numpy(audio)).last_hidden_state.numpy()
    sd = hf_loader.convert_encoder_checkpoint(str(tmp_path), "wavlm" if cfg.rel_bias else "hubert", cfg)
    np.testing.assert_allclose(_run_port(cfg, sd, audio), ref, atol=5e-4, rtol=1e-3)
    out = synth.main([str(tmp_path / "cli"), "--llm", "none", "--encoder", "wavlm-tiny-test", "--device", "cpu"])
    assert (tmp_path / "cli" / "wavlm" / "config.json").is_file() and set(out) == {"encoder"}


# ---------------------------------------------------------------------------
# the tiny SLAM model
# ---------------------------------------------------------------------------


def _jax_cfg(freeze_encoder=True, base_quant="int8", dtype=jnp.float32):
    llm = dataclasses.replace(JLLMConfig.tiny_test(), lora_rank=0, dtype=dtype, base_quant=base_quant,
                              base_quant_bwd="bf16")
    enc = dataclasses.replace(jwavlm.WavLMConfig.tiny_test(), dtype=dtype)
    proj = JProjectorConfig(encoder_dim=enc.d_model, llm_dim=llm.d_model, ds_rate=5, hidden_dim=32, dtype=dtype)
    return JSLAMConfig(llm=llm, encoder_name="wavlm", encoder=enc, projector="linear", projector_cfg=proj,
                       freeze_encoder=freeze_encoder, freeze_llm=True)


def _port_cfg(jcfg):
    def conv(cls, obj):
        names = {f.name for f in dataclasses.fields(cls)} - {"dtype", "param_dtype"}
        return cls(**{n: getattr(obj, n) for n in names if hasattr(obj, n)}, dtype=torch.float32)

    return tslam.SLAMConfig(
        llm=dataclasses.replace(conv(tllm.LLMConfig, jcfg.llm), remat=False), encoder_name="wavlm",
        encoder=_port_enc_cfg(jcfg.encoder), projector="linear",
        projector_cfg=conv(tproj.ProjectorConfig, jcfg.projector_cfg),
        freeze_encoder=jcfg.freeze_encoder, freeze_llm=jcfg.freeze_llm,
    )


def _batch():
    """Two rows, row 0 left-padded by 3: 12 audio pseudo-tokens (-1), then
    text; labels on the text after its first two tokens; row 1's waveform
    padded from sample 1300."""
    rng = np.random.default_rng(0)
    b, t, n_audio = 2, 24, 12
    ids = rng.integers(3, 250, (b, t)).astype(np.int64)
    attn = np.ones((b, t), np.int32)
    modality = np.zeros((b, t), np.int32)
    labels = ids.copy()
    attn[0, :3] = 0
    ids[0, :3] = PAD
    for row, start in ((0, 3), (1, 0)):
        ids[row, start:start + n_audio] = -1
        modality[row, start:start + n_audio] = 1
        labels[row, :start + n_audio + 2] = -100
    audio, mask = _audio(b, 2000, seed=1)
    return {"input_ids": ids, "attention_mask": attn, "modality_mask": modality, "labels": labels,
            "audio": audio, "audio_mask": mask}


def _pair(jcfg):
    """Seeded JAX parameters of the tiny wavlm SLAMModel and the port model holding the same."""
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    params = _seeded(JSLAMModel(jcfg).init(jax.random.PRNGKey(0), batch, method="init_all")["params"], seed=5)
    tcfg = _port_cfg(jcfg)
    tm = tslam.SLAMModel(tcfg).eval()
    tm.load_state_dict(from_flax_params(params, tcfg))
    return params, tm


@pytest.fixture(scope="module")
def pair():
    return _pair(_jax_cfg())


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("freeze_encoder,base_quant", [(True, "int8"), (False, "int8"), (False, "none")])
def test_loss_and_grads_match_jax(freeze_encoder, base_quant):
    """f32, the LLM frozen: loss within 1e-5 relative, accuracy equal, and
    every trainable gradient (the projector's, and with
    ``freeze_encoder=false`` each encoder tensor's) against
    ``jax.value_and_grad``: within 1e-4 of its largest entry with a float
    base; within 1e-2 relative L2 with the int8 base, whose bf16 backward
    rounds dy to bf16 on both sides, so the two forwards' f32 round-off
    flips bf16 ulps (2^-8) of dy. A key projection's bias, whose gradient is
    0 in exact arithmetic (the softmax cancels it), is held to round-off
    against its query bias's gradient instead."""
    jcfg = _jax_cfg(freeze_encoder, base_quant)
    params, tm = _pair(jcfg)
    trainable, frozen = j_partition(params, jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in _batch().items()}

    def loss_fn(tr):
        out = JSLAMModel(jcfg).apply({"params": j_merge(tr, frozen)}, jbatch)
        return out["loss"], out["acc"]

    (jl, ja), jg = jax.value_and_grad(loss_fn, has_aux=True)(trainable)
    tr, _ = partition_params(tm, tm.cfg)
    out = tm({k: torch.from_numpy(v) for k, v in _batch().items()})
    grads = torch.autograd.grad(out["loss"], list(tr.values()))
    np.testing.assert_allclose(float(out["loss"].detach()), float(jl), rtol=1e-5)
    assert float(out["acc"]) == float(ja)
    got, want = _flat(trainable_to_flax(dict(zip(tr.keys(), grads)))), _flat(jg)
    assert set(got) == set(want)
    n_encoder = sum(k.startswith("encoder/") for k in got)
    assert n_encoder == (0 if freeze_encoder else len(_flat(params["encoder"])))
    for key, g in got.items():
        w = want[key]
        assert g.shape == w.shape, key
        if key.endswith("k_proj/bias"):
            ref = np.linalg.norm(want[key.replace("k_proj", "q_proj")])
            assert max(np.linalg.norm(g), np.linalg.norm(w)) <= 1e-5 * ref, key
        elif base_quant == "int8":
            assert np.linalg.norm(g - w) <= 1e-2 * np.linalg.norm(w), key
        else:
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), key


@pytest.mark.parametrize("num_beams", [1, 4])
def test_tokens_identical_to_jax(pair, num_beams):
    """Greedy and beam 4 on the raw-audio batch: the port's Generator keeps
    ``audio`` / ``audio_mask`` and decodes the JAX Generator's tokens."""
    params, tm = pair
    kw = dict(max_new_tokens=8, num_beams=num_beams, eos_token_id=EOS, pad_token_id=PAD)
    batch = {k: v for k, v in _batch().items() if k != "labels"}
    want = JGenerator(JSLAMModel(_jax_cfg()), JGenerationConfig(**kw)).generate({"params": params}, batch)
    got = Generator(tm, GenerationConfig(**kw)).generate(batch)
    assert got.shape == want.shape == (2, 8)
    np.testing.assert_array_equal(got, want)


def test_surplus_audio_slot_is_a_zero_embedding(tmp_path):
    """The reference's slot convention at the published conv stack: the
    dataset reserves ``len // 320 // 5`` = 100 slots for a 160,000-sample
    utterance, the encoder gives ``feature_lengths(160000) // 5`` = 99
    projected frames, and the surplus slot is a zero embedding; the spliced
    embeddings equal the JAX package's (f32)."""
    from helpers import write_wav

    from slam_llm_tpu_torch.config import RunConfig
    from slam_llm_tpu_torch.data.speech_dataset import get_speech_dataset
    from slam_llm_tpu_torch.data.tokenizer import ByteTokenizer

    enc_kw = {**NARROW, "n_layers": 1}
    jcfg = _jax_cfg()  # an LLM vocabulary that covers the byte tokenizer's ids
    jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm, vocab_size=512),
                               encoder=jwavlm.WavLMConfig(**enc_kw, dtype=jnp.float32))
    write_wav(tmp_path / "a.wav", seconds=10.0)
    (tmp_path / "m.jsonl").write_text(f'{{"key": "a", "source": "{tmp_path / "a.wav"}", "target": "x"}}\n')
    dc = RunConfig().dataset_config
    dc.train_data_path = dc.val_data_path = str(tmp_path / "m.jsonl")
    dc.input_type, dc.normalize = "raw", True
    ds = get_speech_dataset(dc, ByteTokenizer(), "train")
    batch = ds.collator([ds[0]])
    assert ds[0]["audio_length"] == 100 and batch["audio"].shape == (1, 160000)
    assert twavlm.feature_lengths(160000, _port_enc_cfg(jcfg.encoder)) // 5 == 99
    jb = {k: jnp.asarray(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
    params = _seeded(JSLAMModel(jcfg).init(jax.random.PRNGKey(0), jb, method="init_all")["params"], seed=8)
    want, _ = JSLAMModel(jcfg).apply({"params": params}, jb, method="forward_embeds")
    tcfg = _port_cfg(jcfg)
    tm = tslam.SLAMModel(tcfg).eval()
    tm.load_state_dict(from_flax_params(params, tcfg))
    with torch.no_grad():
        got, _ = tm.forward_embeds({k: torch.from_numpy(v) for k, v in batch.items() if isinstance(v, np.ndarray)})
    slots = np.flatnonzero(batch["modality_mask"][0])
    assert len(slots) == 100
    assert bool((got[0, slots[99]] == 0).all()) and bool((got[0, slots[:99]].abs().sum(-1) > 0).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


def test_raw_audio_seconds_count_the_waveform_mask():
    """The RTF's audio seconds of a batch with neither the collator's sum nor
    a mel mask come from the raw waveform's mask at 16 kHz."""
    from slam_llm_tpu_torch.pipeline.inference_batch import batch_audio_seconds

    mask = np.zeros((2, 48000), np.int32)
    mask[0, :32000], mask[1, :8000] = 1, 1
    assert batch_audio_seconds({"audio": np.zeros((2, 48000), np.float32), "audio_mask": mask}) == 2.5
    assert batch_audio_seconds({"audio_mask": mask, "audio_seconds": 3.0}) == 3.0
    assert batch_audio_seconds({"audio_mel_mask": np.ones((1, 300), np.int32)}) == 3.0


def test_finetune_then_decode_raw_audio_matches_jax(tmp_path, narrow_preset):
    """``input_type: raw`` through both entry points at tiny size, from HF
    directories (a tiny Llama with its tokenizer.json, a tiny WavLM with the
    published conv stack): the
    port's ``pipeline.finetune`` trains the projector for 2 steps and writes
    ``model.pt``; the port's ``pipeline.inference_batch`` with ``ckpt_path``
    decodes (beam 4) the text the JAX pipeline decodes from the same HF
    directories and the port's ``model.msgpack``; both count the same audio
    seconds."""
    from helpers import make_corpus, tiny_run_config
    from test_torch_tokenizer import build_llama_tokenizer
    from test_torch_weights_pipeline import _f32
    from test_torch_weights_pipeline import _port_cfg as _pipeline_cfg
    from transformers import LlamaConfig, LlamaForCausalLM

    from slam_llm_tpu.models import slam_model as jslam
    from slam_llm_tpu.pipeline import inference_batch as jinference_batch
    from slam_llm_tpu_torch.pipeline import finetune, inference_batch
    from slam_llm_tpu_torch.utils.checkpoint import load_trainable, save_trainable_msgpack

    vocab = build_llama_tokenizer(tmp_path / "llm")
    torch.manual_seed(0)
    LlamaForCausalLM(LlamaConfig(
        vocab_size=vocab, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, rms_norm_eps=1e-5, rope_theta=10000.0, max_position_embeddings=256,
        initializer_range=0.2, tie_word_embeddings=False)).save_pretrained(tmp_path / "llm", safe_serialization=True)
    _hf_model("wavlm", seed=4, conv_dim=(8,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
              conv_stride=(5, 2, 2, 2, 2, 2, 2)).save_pretrained(tmp_path / "wavlm", safe_serialization=True)
    manifest = make_corpus(tmp_path, n=4)
    overrides = {
        "model_config.llm_path": str(tmp_path / "llm"), "model_config.encoder_path": str(tmp_path / "wavlm"),
        "model_config.encoder_name": "wavlm", "model_config.encoder_config": "wavlm-narrow-test",
        "dataset_config.input_type": "raw", "dataset_config.normalize": True,
        "train_config.freeze_llm": True, "train_config.freeze_encoder": True, "train_config.use_peft": False,
        "train_config.shard.base_quant": "int8", "train_config.shard.base_quant_bwd": "bf16",
        "decode_config.max_new_tokens": 6, "decode_config.num_beams": 4,
    }
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tslam, "build_slam_config", _f32(tslam.build_slam_config, torch.float32))
        mp.setattr(jslam, "build_slam_config", _f32(jslam.build_slam_config, jnp.float32))
        res = finetune.main(_pipeline_cfg(manifest, **overrides, **{
            "train_config.max_steps_per_epoch": 2, "train_config.output_dir": str(tmp_path / "out"),
            "train_config.lr": 1e-2, "train_config.warmup_steps": 1, "train_config.log_interval": 1,
            "train_config.run_validation": False}),
            device="cpu")
        assert len(res["steps"]) == 2 and all(np.isfinite(s["loss"]) for s in res["steps"])
        trained = res["trainer"].trainable
        assert trained and all(n.startswith("encoder_projector.") for n in trained)
        ckpt = res["checkpoints"][-1]
        save_trainable_msgpack(str(tmp_path / "model.msgpack"), load_trainable(ckpt))
        ours = inference_batch.main(_pipeline_cfg(manifest, **overrides, **{
            "ckpt_path": ckpt, "decode_config.decode_log": str(tmp_path / "port")}), device="cpu")
        theirs = jinference_batch.main(tiny_run_config(manifest, **overrides, **{
            "ckpt_path": str(tmp_path / "model.msgpack"), "decode_config.decode_log": str(tmp_path / "jax")}))
    pred = open(ours["pred"], encoding="utf-8").read()
    assert ours["n"] == theirs["n"] == 4 and any(line.split("\t", 1)[1] for line in pred.splitlines())
    assert pred == open(theirs["pred"], encoding="utf-8").read()
    assert open(ours["gt"]).read() == open(theirs["gt"]).read()
    assert ours["audio_seconds"] > 0 and np.isfinite(ours["rtf"])


def _recipe(path):
    from slam_llm_tpu_torch.config import load_run_config

    return load_run_config(["--config", str(REPO / "examples" / path)])


def test_build_slam_config_takes_the_wavlm_recipes():
    """``asr_wavlm_vicuna.yaml`` (WavLM-large + linear + vicuna-7b, int8
    base, bf16 backward) and ``sec_emotion2vec_vicuna.yaml`` (emotion2vec-base
    + Q-Former + vicuna-7b) build as the JAX package builds them; the raw
    encoders' default presets are JAX's."""
    from slam_llm_tpu.models.slam_model import build_slam_config as j_build

    for path, preset, projector in (("asr_librispeech/conf/asr_wavlm_vicuna.yaml", "wavlm-large", "linear"),
                                    ("sec_emotioncaps/conf/sec_emotion2vec_vicuna.yaml", "emotion2vec-base",
                                     "q-former")):
        cfg = _recipe(path)
        got, want = (build(cfg.train_config, cfg.model_config) for build in (tslam.build_slam_config, j_build))
        assert got.encoder == _port_enc_cfg(jwavlm.WAVLM_PRESETS[preset](), torch.bfloat16)
        assert got.encoder == _port_enc_cfg(want.encoder, torch.bfloat16) and got.projector == projector
        for name in ("encoder_dim", "llm_dim", "ds_rate", "query_len", "qformer_layers"):
            assert getattr(got.projector_cfg, name) == getattr(want.projector_cfg, name), name
        for name in ("d_model", "n_layers", "n_heads", "ffn_dim", "base_quant", "base_quant_bwd"):
            assert getattr(got.llm, name) == getattr(want.llm, name), name
        assert cfg.dataset_config.input_type == "raw" and cfg.dataset_config.normalize
        model = tslam.SLAMModel(got, device="meta")
        assert isinstance(model.encoder, twavlm.WavLMEncoder)
    assert (got.llm.base_quant, got.llm.base_quant_bwd) == ("none", "bf16")
    asr = _recipe("asr_librispeech/conf/asr_wavlm_vicuna.yaml")
    asr_cfg = tslam.build_slam_config(asr.train_config, asr.model_config)
    assert (asr_cfg.llm.base_quant, asr_cfg.llm.base_quant_bwd, asr_cfg.llm.lora_rank) == ("int8", "bf16", 0)
    for name, preset in (("wavlm", "wavlm-base"), ("hubert", "wavlm-base"), ("emotion2vec", "emotion2vec-base")):
        mc = dataclasses.replace(asr.model_config, encoder_name=name, encoder_config=None)
        assert tslam.build_slam_config(asr.train_config, mc).encoder == _port_enc_cfg(
            j_build(asr.train_config, mc).encoder, torch.bfloat16)
        assert tslam.build_slam_config(asr.train_config, mc).encoder.d_model == twavlm.WAVLM_PRESETS[preset]().d_model


def test_profile_train_builds_the_wavlm_recipe(tmp_path, narrow_preset):
    """``tools/profile_train.py --recipe wavlm`` at tiny widths on the CPU:
    the recipe's model (a WavLM encoder, the linear projector, the int8 base
    with the bf16 backward, the synthetic 32000-entry tokenizer) takes a
    training step on the recipe's synthetic corpus, and the kernel-family
    split reads the profile (no CUDA kernel on the CPU); an unknown recipe
    is refused."""
    from torch.profiler import ProfilerActivity, profile

    from slam_llm_tpu_torch.tools import profile_train
    from slam_llm_tpu_torch.train.state import Trainer

    recipe, overrides = profile_train.split_recipe(["--recipe", "wavlm", "++model_config.encoder_config=wavlm-narrow-test",
                                                    "++model_config.llm_name=tiny-test"])
    cfg, model, tok, dataset, n = profile_train.build_recipe(recipe, overrides, tmp_path, device="cpu")
    c = model.cfg
    assert isinstance(model.encoder, twavlm.WavLMEncoder) and c.encoder.rel_bias and n == 16
    assert (c.llm.base_quant, c.llm.base_quant_bwd, c.llm.lora_rank, tok.vocab_size) == ("int8", "bf16", 0, 32000)
    trainer = Trainer(model, c, cfg.train_config).state_from_params()
    batch = trainer.put_batch(dataset.collator([dataset[i] for i in (0, n - 1)]))
    assert batch["audio"].shape == (2, 160000)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        m = trainer.train_step(batch)
    assert np.isfinite(float(m["loss"])) and profile_train.split_by_family(prof) == {}
    assert set(trainer.trainable) == {n for n, _ in model.named_parameters() if n.startswith("encoder_projector.")}
    with pytest.raises(SystemExit, match="recipe"):
        profile_train.split_recipe(["--recipe", "whisper"])
