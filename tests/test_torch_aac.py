"""The audio-captioning recipes' pieces in the port against the JAX package, on the CPU.

``aac_eat_vicuna`` / ``slam_aac`` (EAT-base, a linear projector, vicuna-7b
in bf16, SLAM-AAC with LoRA on q / v) and the BEATs encoder at tiny widths;
inputs from numpy seeds. The Kaldi fbank, the caption metrics and SPICE are
held against the JAX package in ``tests/test_torch_host.py``.

* ``AudioDatasetJsonl`` items and collated batches equal the JAX dataset's,
  for EAT (fixed length with the seeded random crop, and ragged) and BEATs,
  in train and inference mode, an unreadable clip included; without a
  prompt the port uses the captioning prompt;
* ``sincos_2d_positions`` and ``beats_patch_mask`` exactly equal; the
  port's ``ViTEncoder`` / ``BEATsEncoder`` against the JAX modules on the
  same numpy-seeded parameters, ragged masks: f32 within 1e-5 relative L2,
  bf16 within 2e-2 relative L2;
* ``convert_eat_fairseq`` (the fused qkv) and ``convert_beats`` (both
  weight-norm key forms, with and without the gate keys) give the JAX
  converters' outputs; the JAX ``convert_encoder_checkpoint`` reads
  ``tools/synth_checkpoint``'s ``write_eat`` / ``write_beats`` files;
* tiny EAT and BEATs SLAMModels (linear projector, the tiny LLM in a float
  base), with and without LoRA: loss and gradients against
  ``jax.value_and_grad``, greedy and beam-4 tokens identical to the JAX
  ``Generator``; the slot convention (surplus audio slots are zero
  embeddings) at the published 16 x 16 patching for one EAT and two BEATs
  lengths;
* ``pipeline.finetune`` -> ``pipeline.inference_batch`` with ``ckpt_path``
  -> ``utils.caption_metrics`` against the JAX pipeline, in f32; the
  recipes' configs; ``tools/synth_checkpoint`` and ``tools/profile_train
  --recipe aac`` built on the CPU.
"""

import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from helpers import make_corpus, tiny_run_config, write_wav
from test_torch_wavlm import _flat, _seeded

from slam_llm_tpu.config import RunConfig as JRunConfig
from slam_llm_tpu.data import audio_dataset as jaudio_dataset
from slam_llm_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from slam_llm_tpu.inference.generate import GenerationConfig as JGenerationConfig
from slam_llm_tpu.inference.generate import Generator as JGenerator
from slam_llm_tpu.models import beats as jbeats
from slam_llm_tpu.models import vit as jvit
from slam_llm_tpu.models.llm import LLMConfig as JLLMConfig
from slam_llm_tpu.models.projector import ProjectorConfig as JProjectorConfig
from slam_llm_tpu.models.slam_model import SLAMConfig as JSLAMConfig
from slam_llm_tpu.models.slam_model import SLAMModel as JSLAMModel
from slam_llm_tpu.train.optimizer import merge_params as j_merge
from slam_llm_tpu.train.optimizer import partition_params as j_partition
from slam_llm_tpu_torch.config import RunConfig
from slam_llm_tpu_torch.data import audio_dataset as taudio_dataset
from slam_llm_tpu_torch.data.tokenizer import ByteTokenizer
from slam_llm_tpu_torch.inference.generate import GenerationConfig, Generator
from slam_llm_tpu_torch.models import beats as tbeats
from slam_llm_tpu_torch.models import llm as tllm
from slam_llm_tpu_torch.models import projector as tproj
from slam_llm_tpu_torch.models import slam_model as tslam
from slam_llm_tpu_torch.models import vit as tvit
from slam_llm_tpu_torch.train.optimizer import partition_params
from slam_llm_tpu_torch.utils import hf_loader
from slam_llm_tpu_torch.utils.convert import flax_to_state_dict, from_flax_params, trainable_to_flax

REPO = Path(__file__).resolve().parent.parent
EOS, PAD = 2, 0
JAX_ENC = {"eat": (jvit.ViTEncoder, jvit.ViTEncoderConfig), "beats": (jbeats.BEATsEncoder, jbeats.BEATsEncoderConfig)}
PORT_ENC = {"eat": (tvit.ViTEncoder, tvit.ViTEncoderConfig), "beats": (tbeats.BEATsEncoder, tbeats.BEATsEncoderConfig)}
# the published 16 x 16 patching over 128 mel bins at tiny widths
NARROW = {"eat": dict(d_model=32, n_heads=2, n_layers=1),
          "beats": dict(patch_embed_dim=16, d_model=32, n_heads=2, n_layers=1, ffn_dim=64, num_buckets=32,
                        max_distance=64, conv_pos=16, conv_pos_groups=2)}


def _port_enc_cfg(kind, jcfg, dtype=torch.float32):
    cls = PORT_ENC[kind][1]
    names = {f.name for f in dataclasses.fields(cls)} - {"dtype"}
    return cls(**{n: getattr(jcfg, n) for n in names if hasattr(jcfg, n)}, dtype=dtype)


def _jax_enc_cfg(kind, dtype=jnp.float32, **kw):
    base = JAX_ENC[kind][1].tiny_test() if not kw else JAX_ENC[kind][1](**kw)
    return dataclasses.replace(base, dtype=dtype)


def _fbank(b=3, t=40, f=16, seed=0):
    """Seeded fbank rows; row 1 padded from frame 30, row 2 from frame 13."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, f)).astype(np.float32)
    mask = np.ones((b, t), np.int32)
    for row, n in ((1, 30), (2, 13)):
        if row < b:
            mask[row, n:] = 0
            x[row, n:] = 0.0
    return x, mask


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# the dataset
# ---------------------------------------------------------------------------


def _dataset_config(mod, manifest, **kw):
    cfg = mod.RunConfig().dataset_config
    cfg.dataset = "audio_dataset"
    cfg.train_data_path = cfg.val_data_path = str(manifest)
    cfg.prompt = "Describe the audio."
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _assert_batches_equal(a: dict, b: dict, port_only=("audio_seconds",)):
    """Equal, but for the keys only the port carries (the true clip
    seconds for the RTF)."""
    assert a.keys() - set(port_only) == b.keys()
    for k in b:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("kw,split", [
    ({"encoder_name": "eat", "target_length": 32, "random_crop": True}, "train"),
    ({"encoder_name": "eat", "target_length": 32, "random_crop": True, "inference_mode": True}, "test"),
    ({"encoder_name": "eat", "fixed_length": False, "seed": 3}, "train"),
    ({"encoder_name": "beats", "fbank_mean": 15.41663, "fbank_std": 6.55582}, "train"),
    ({"encoder_name": "beats", "inference_mode": True, "fix_length_audio": 4}, "test"),
])
def test_audio_dataset_gives_the_jax_items_and_batches(tmp_path, kw, split):
    """Items (fbank, slots, ids, labels) and collated batches equal the JAX
    dataset's, through the port's registry, an unreadable clip (1 s of
    silence) included; the crop's generator is seeded from ``seed + 555``
    with one child per item, so both crop the same frames."""
    from slam_llm_tpu.registry import get_custom_dataset_factory as j_factory
    from slam_llm_tpu_torch.registry import get_custom_dataset_factory

    manifest = make_corpus(tmp_path, n=5)
    with open(manifest, "a") as f:
        f.write(json.dumps({"key": "broken", "source": str(tmp_path / "missing.wav"), "target": "silence"}) + "\n")
    tcfg, jcfg = _dataset_config(sys.modules[RunConfig.__module__], manifest, **kw), _dataset_config(
        sys.modules[JRunConfig.__module__], manifest, **kw)
    got = get_custom_dataset_factory(tcfg)(tcfg, ByteTokenizer(), split)
    want = j_factory(jcfg)(jcfg, JByteTokenizer(), split)
    assert isinstance(got, taudio_dataset.AudioDatasetJsonl) and len(got) == len(want) == 6
    assert tcfg.input_type == "mel"  # the bypass of the parent's assert leaves the config as it was
    items = [(got[i], want[i]) for i in range(6)]
    for a, b in items:
        _assert_batches_equal(a, b)
    assert items[5][0]["audio_mel"].shape[0] == (32 if kw.get("target_length") else 98 if kw["encoder_name"] ==
                                                 "beats" else 112)  # the silent second
    for rows in ([0], [1, 5], [4, 0, 3]):
        _assert_batches_equal(got.collator([got[i] for i in rows]), want.collator([want[i] for i in rows]))
    if kw.get("inference_mode"):
        assert (got[0]["input_ids"][: got[0]["audio_length"]] == -1).all()


def test_audio_dataset_slots_crop_and_default_prompt(tmp_path):
    """The slot counts (EAT: T // 2 + 1 with the CLS, BEATs: (T + 1) // 2,
    then // ds_rate), the crop on the train split only, and the captioning
    prompt for a config without one (the JAX package gives it the speech
    dataset's ASR prompt: the same items otherwise)."""
    write_wav(tmp_path / "a.wav", seconds=3.015)  # 300 fbank frames
    (tmp_path / "m.jsonl").write_text(json.dumps({"key": "a", "source": str(tmp_path / "a.wav"), "target": "x"}) + "\n")
    tok = ByteTokenizer()
    for name, fixed, slots, frames in (("eat", False, 30, 304), ("eat", True, 102, 1024), ("beats", False, 30, 300)):
        cfg = _dataset_config(sys.modules[RunConfig.__module__], tmp_path / "m.jsonl", encoder_name=name,
                              fixed_length=fixed)
        item = taudio_dataset.AudioDatasetJsonl(cfg, tok, "train")[0]
        assert (item["audio_length"], item["audio_mel"].shape) == (slots, (frames, 128)), name
    cfg = _dataset_config(sys.modules[RunConfig.__module__], tmp_path / "m.jsonl", target_length=64, random_crop=True)
    assert taudio_dataset.AudioDatasetJsonl(cfg, tok, "train").random_crop
    assert not taudio_dataset.AudioDatasetJsonl(cfg, tok, "test").random_crop
    cfg.prompt = None
    jcfg = _dataset_config(sys.modules[JRunConfig.__module__], tmp_path / "m.jsonl", target_length=64, prompt=None)
    got, want = taudio_dataset.AudioDatasetJsonl(cfg, tok, "test"), jaudio_dataset.AudioDatasetJsonl(
        jcfg, JByteTokenizer(), "test")
    assert got.prompt == taudio_dataset.DEFAULT_AAC_PROMPT == jaudio_dataset.DEFAULT_AAC_PROMPT
    assert want.prompt != got.prompt and cfg.prompt is None
    want.prompt = got.prompt
    _assert_batches_equal(got[0], want[0])


# ---------------------------------------------------------------------------
# the encoders
# ---------------------------------------------------------------------------


def test_positions_and_patch_mask_equal_jax():
    for grid in ((64, 8, 768), (3, 4, 32), (1, 1, 8)):
        assert np.array_equal(tvit.sincos_2d_positions(*grid), jvit.sincos_2d_positions(*grid))
    rng = np.random.default_rng(0)
    for t, n in ((998, 496), (300, 144), (40, 40), (17, 8)):
        mask = (rng.random((3, t)) < 0.7).astype(np.int32)
        mask[0] = 1
        mask[1, t // 3:] = 0
        want = np.asarray(jbeats.beats_patch_mask(jnp.asarray(mask), n))
        got = tbeats.beats_patch_mask(torch.from_numpy(mask), n)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_position_tables_are_made_once_on_the_device_they_are_used_on():
    """The sin-cos table and the rel-pos bucket table are built once per
    shape, on the device and in the dtype the forward asks for, so a
    forward never copies them from the host."""
    from slam_llm_tpu_torch.models import wavlm as twavlm

    cpu = torch.device("cpu")
    table = tvit._positions(64, 8, 32, cpu, torch.bfloat16)
    assert tvit._positions(64, 8, 32, cpu, torch.bfloat16) is table
    assert table.dtype == torch.bfloat16 and table.device == cpu
    assert torch.equal(table, torch.from_numpy(jvit.sincos_2d_positions(64, 8, 32)).bfloat16())
    buckets = twavlm._buckets(37, 32, 64, cpu)
    assert twavlm._buckets(37, 32, 64, cpu) is buckets and buckets.dtype == torch.int64
    assert np.array_equal(buckets.numpy(), twavlm.relative_position_buckets(37, 32, 64))


def _encoder_pair(kind, dtype=torch.float32, jdtype=jnp.float32, seed=1):
    jcfg = _jax_enc_cfg(kind, jdtype)
    fb, mask = _fbank()
    enc = JAX_ENC[kind][0](jcfg)
    params = _seeded(enc.init(jax.random.PRNGKey(0), jnp.asarray(fb), jnp.asarray(mask))["params"], seed)
    te = PORT_ENC[kind][0](_port_enc_cfg(kind, jcfg, dtype)).eval()
    te.load_state_dict(flax_to_state_dict(params))
    return enc, params, te, fb, mask


@pytest.mark.parametrize("kind", ["eat", "beats"])
def test_encoder_matches_jax(kind):
    """f32 within 1e-5 relative L2 at every token (padding included), with a
    ragged mask and without one, the masks equal; bf16 on both sides within
    2e-2 relative L2 over the valid tokens."""
    enc, params, te, fb, mask = _encoder_pair(kind)
    for m in (mask, None):
        want, want_mask = enc.apply({"params": params}, jnp.asarray(fb), None if m is None else jnp.asarray(m))
        with torch.no_grad():
            got, got_mask = te(torch.from_numpy(fb), None if m is None else torch.from_numpy(m))
        assert got.shape == want.shape == ((3, 41, 32) if kind == "eat" else (3, 40, 32))
        assert got_mask.dtype == torch.int32 and np.array_equal(got_mask.numpy(), np.asarray(want_mask))
        assert _rel_l2(got.numpy(), np.asarray(want)) <= 1e-5
    assert int(got_mask.sum()) == got_mask.numel()  # no mask: every token valid
    enc, params, te, fb, mask = _encoder_pair(kind, torch.bfloat16, jnp.bfloat16)
    want, want_mask = enc.apply({"params": params}, jnp.asarray(fb), jnp.asarray(mask))
    with torch.no_grad():
        got, _ = te(torch.from_numpy(fb), torch.from_numpy(mask))
    live = np.asarray(want_mask).astype(bool)
    assert got.dtype == torch.bfloat16
    assert _rel_l2(got.float().numpy()[live], np.asarray(want, np.float32)[live]) <= 2e-2


# ---------------------------------------------------------------------------
# checkpoints in the reference's layouts
# ---------------------------------------------------------------------------


def _eat_state_dict(cfg, seed=0):
    """A random data2vec2-layout EAT state dict (the fused qkv), with a
    decoder tensor the converters skip."""
    g = torch.Generator().manual_seed(seed)
    d, p, hid = cfg.d_model, cfg.patch_size, int(cfg.d_model * cfg.mlp_ratio)

    def r(*shape, std=0.2, mean=0.0):
        return torch.randn(shape, generator=g) * std + mean

    pre = "modality_encoders.IMAGE."
    sd = {pre + "local_encoder.proj.weight": r(d, 1, p, p), pre + "local_encoder.proj.bias": r(d),
          pre + "extra_tokens": r(1, 1, d), "norm.weight": r(d, mean=1.0), "norm.bias": r(d),
          pre + "decoder.proj.weight": r(4, d)}
    for i in range(cfg.n_layers):
        q = f"blocks.{i}."
        sd.update({q + "norm1.weight": r(d, mean=1.0), q + "norm1.bias": r(d), q + "norm2.weight": r(d, mean=1.0),
                   q + "norm2.bias": r(d), q + "attn.qkv.weight": r(3 * d, d), q + "attn.qkv.bias": r(3 * d),
                   q + "attn.proj.weight": r(d, d), q + "attn.proj.bias": r(d), q + "mlp.fc1.weight": r(hid, d),
                   q + "mlp.fc1.bias": r(hid), q + "mlp.fc2.weight": r(d, hid), q + "mlp.fc2.bias": r(d)})
    return sd


def _beats_state_dict(cfg, seed=0, form="parametrizations", gates=True):
    g = torch.Generator().manual_seed(seed)
    d, pe, p, k = cfg.d_model, cfg.patch_embed_dim, cfg.patch_size, cfg.conv_pos

    def r(*shape, std=0.2, mean=0.0):
        return torch.randn(shape, generator=g) * std + mean

    sd = {"patch_embedding.weight": r(pe, 1, p, p), "layer_norm.weight": r(pe, mean=1.0), "layer_norm.bias": r(pe),
          "post_extract_proj.weight": r(d, pe), "post_extract_proj.bias": r(d), "encoder.pos_conv.0.bias": r(d),
          "encoder.layer_norm.weight": r(d, mean=1.0), "encoder.layer_norm.bias": r(d)}
    gain, v = r(1, 1, k, mean=1.0), r(d, d // cfg.conv_pos_groups, k)
    base = "encoder.pos_conv.0."
    if form == "parametrizations":
        sd[base + "parametrizations.weight.original0"], sd[base + "parametrizations.weight.original1"] = gain, v
    else:
        sd[base + "weight_g"], sd[base + "weight_v"] = gain, v
    rel = r(cfg.num_buckets, cfg.n_heads)
    for i in range(cfg.n_layers):
        q = f"encoder.layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{q}self_attn.{name}.weight"], sd[f"{q}self_attn.{name}.bias"] = r(d, d), r(d)
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            sd[f"{q}{ln}.weight"], sd[f"{q}{ln}.bias"] = r(d, mean=1.0), r(d)
        sd[q + "fc1.weight"], sd[q + "fc1.bias"] = r(cfg.ffn_dim, d), r(cfg.ffn_dim)
        sd[q + "fc2.weight"], sd[q + "fc2.bias"] = r(d, cfg.ffn_dim), r(d)
        if gates:
            sd[q + "self_attn.grep_linear.weight"], sd[q + "self_attn.grep_linear.bias"] = r(8, d // cfg.n_heads), r(8)
            sd[q + "self_attn.grep_a"] = r(1, cfg.n_heads, 1, 1, mean=1.0)
            sd[q + "self_attn.relative_attention_bias.weight"] = rel
    return sd


def _run_both(kind, jcfg, jtree, port_sd, fb, mask):
    """The JAX encoder with ``jtree`` merged into its init, and the port's
    with ``port_sd`` overlaid on the same init (what a checkpoint lacks keeps
    the JAX model's values)."""
    enc = JAX_ENC[kind][0](jcfg)
    init = enc.init(jax.random.PRNGKey(0), jnp.asarray(fb), jnp.asarray(mask))["params"]
    tree = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(init))
    te = PORT_ENC[kind][0](_port_enc_cfg(kind, jcfg)).eval()
    te.load_state_dict(flax_to_state_dict(tree))
    _merge(tree, jtree)
    want, _ = enc.apply({"params": tree}, jnp.asarray(fb), jnp.asarray(mask))
    hf_loader.overlay_(te, port_sd)
    with torch.no_grad():
        got, _ = te(torch.from_numpy(fb), torch.from_numpy(mask))
    return got.numpy(), np.asarray(want)


def _merge(dst: dict, src: dict):
    for k, v in src.items():
        if isinstance(v, dict):
            _merge(dst[k], v)
        else:
            assert np.shape(dst[k]) == np.shape(v), k
            dst[k] = np.asarray(v, np.float32)


@pytest.mark.parametrize("kind,kw", [("eat", {}), ("beats", {"form": "parametrizations"}),
                                     ("beats", {"form": "weight_g", "gates": False})])
def test_converters_give_the_jax_converters_outputs(kind, kw):
    """Random checkpoints in the reference's layouts through the port's and
    the JAX converters: the same encoder outputs in f32 (the fused qkv
    split; the positional conv's weight norm folded from either key form;
    a checkpoint without the gate keys keeps the model's own)."""
    jcfg = _jax_enc_cfg(kind)
    tcfg = _port_enc_cfg(kind, jcfg)
    fb, mask = _fbank(seed=4)
    if kind == "eat":
        sd = _eat_state_dict(tcfg)
        jtree = jvit.convert_eat_fairseq({"model": {k: v.numpy() for k, v in sd.items()}}, jcfg)
        port_sd = tvit.convert_eat_fairseq({"model": sd}, tcfg)
        assert torch.equal(port_sd["blocks.1.k_proj.weight"], sd["blocks.1.attn.qkv.weight"][32:64])
    else:
        sd = _beats_state_dict(tcfg, **kw)
        jtree = jbeats.convert_beats({k: v.numpy() for k, v in sd.items()}, jcfg)
        port_sd = tbeats.convert_beats(sd, tcfg)
        assert ("transformer.layers.0.attention.gru_rel_pos_const" in port_sd) == kw.get("gates", True)
    got, want = _run_both(kind, jcfg, jtree, port_sd, fb, mask)
    assert _rel_l2(got, want) <= 1e-5


@pytest.mark.parametrize("kind", ["eat", "beats"])
def test_jax_loader_reads_the_synthetic_files(tmp_path, kind):
    """``write_eat`` / ``write_beats`` files (``{"model": sd}`` / ``{"cfg":
    {...}, "model": sd}``, f32, plain dicts) read by the JAX package's
    ``convert_encoder_checkpoint`` and by the port's give the same encoder."""
    from slam_llm_tpu.utils import hf_loader as j_hf_loader
    from slam_llm_tpu_torch.tools import synth_checkpoint as synth

    jcfg = _jax_enc_cfg(kind)
    tcfg = _port_enc_cfg(kind, jcfg)
    path = tmp_path / f"{kind}.pt"
    (synth.write_eat if kind == "eat" else synth.write_beats)(str(path), tcfg, seed=2, device="cpu")
    raw = torch.load(path, weights_only=True)
    assert {t.dtype for t in raw["model"].values()} == {torch.float32}
    assert kind == "eat" or raw["cfg"]["encoder_layers"] == tcfg.n_layers
    fb, mask = _fbank(seed=6)
    got, want = _run_both(kind, jcfg, j_hf_loader.convert_encoder_checkpoint(str(path), kind, jcfg),
                          hf_loader.convert_encoder_checkpoint(str(path), kind, tcfg), fb, mask)
    assert _rel_l2(got, want) <= 1e-5
    with pytest.raises(ValueError, match="cannot load an HF directory"):
        hf_loader.convert_encoder_checkpoint(str(tmp_path), kind, tcfg)


# ---------------------------------------------------------------------------
# the tiny SLAM models
# ---------------------------------------------------------------------------


def _jax_cfg(kind, lora, enc=None):
    dtype = jnp.float32
    llm = dataclasses.replace(JLLMConfig.tiny_test(), dtype=dtype, lora_rank=4 if lora else 0,
                              lora_targets=("q_proj", "v_proj"))
    enc = enc or _jax_enc_cfg(kind)
    proj = JProjectorConfig(encoder_dim=enc.d_model, llm_dim=llm.d_model, ds_rate=5, hidden_dim=32, dtype=dtype)
    return JSLAMConfig(llm=llm, encoder_name=kind, encoder=enc, projector="linear", projector_cfg=proj,
                       freeze_encoder=True, freeze_llm=True)


def _port_cfg(jcfg):
    def conv(cls, obj):
        names = {f.name for f in dataclasses.fields(cls)} - {"dtype", "param_dtype"}
        return cls(**{n: getattr(obj, n) for n in names if hasattr(obj, n)}, dtype=torch.float32)

    return tslam.SLAMConfig(
        llm=dataclasses.replace(conv(tllm.LLMConfig, jcfg.llm), remat=False), encoder_name=jcfg.encoder_name,
        encoder=_port_enc_cfg(jcfg.encoder_name, jcfg.encoder), projector="linear",
        projector_cfg=conv(tproj.ProjectorConfig, jcfg.projector_cfg),
        freeze_encoder=jcfg.freeze_encoder, freeze_llm=jcfg.freeze_llm,
    )


def _batch():
    """Two rows, row 0 left-padded by 3: 8 audio pseudo-tokens (-1), then
    text; labels on the text after its first two tokens; row 1's fbank
    padded from frame 30."""
    rng = np.random.default_rng(0)
    b, t, n_audio = 2, 20, 8
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
    fb, mask = _fbank(b=2, seed=1)
    return {"input_ids": ids, "attention_mask": attn, "modality_mask": modality, "labels": labels,
            "audio_mel": fb, "audio_mel_mask": mask}


def _pair(jcfg, batch=None, seed=5):
    batch = _batch() if batch is None else batch
    jb = {k: jnp.asarray(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
    params = _seeded(JSLAMModel(jcfg).init(jax.random.PRNGKey(0), jb, method="init_all")["params"], seed=seed)
    tcfg = _port_cfg(jcfg)
    tm = tslam.SLAMModel(tcfg).eval()
    tm.load_state_dict(from_flax_params(params, tcfg))
    return params, tm


@pytest.mark.parametrize("kind,lora", [("eat", False), ("eat", True), ("beats", False), ("beats", True)])
def test_loss_grads_and_tokens_match_jax(kind, lora):
    """f32, the encoder and LLM frozen: loss within 1e-5 relative, accuracy
    equal, every trainable gradient (the projector's, and the LoRA factors'
    on q / v) within 1e-4 of its largest entry of ``jax.value_and_grad``'s;
    greedy and beam-4 tokens identical to the JAX ``Generator``."""
    jcfg = _jax_cfg(kind, lora)
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
    assert set(got) == set(want) and sum("lora" in k for k in got) == (4 if lora else 0)  # stacked over the layers
    for key, g in got.items():
        assert g.shape == want[key].shape and np.abs(g - want[key]).max() <= 1e-4 * np.abs(want[key]).max(), key
    batch = {k: v for k, v in _batch().items() if k != "labels"}
    for num_beams in (1, 4):
        kw = dict(max_new_tokens=6, num_beams=num_beams, eos_token_id=EOS, pad_token_id=PAD)
        want_tokens = JGenerator(JSLAMModel(jcfg), JGenerationConfig(**kw)).generate({"params": params}, batch)
        got_tokens = Generator(tm, GenerationConfig(**kw)).generate(batch)
        assert got_tokens.shape == (2, 6)
        np.testing.assert_array_equal(got_tokens, want_tokens)


@pytest.mark.parametrize("kind,seconds,fixed,slots,frames", [
    ("eat", 3.015, False, 30, 30),  # 300 fbank frames -> 304 -> 19 x 8 + CLS = 153 tokens
    ("beats", 3.015, False, 30, 28),  # 300 frames -> 30 slots; 18 x 8 = 144 features -> 28 frames
    ("beats", 10.0, False, 99, 99),  # 998 frames -> 99 slots; 62 x 8 = 496 features -> 99 frames
])
def test_slot_convention_matches_jax(tmp_path, kind, seconds, fixed, slots, frames):
    """The reference's slot convention at the published 16 x 16 patching:
    the dataset reserves ``slots`` audio slots, the encoder gives ``frames``
    projected frames, and the slots past them are zero embeddings; the
    spliced embeddings equal the JAX package's (f32)."""
    from slam_llm_tpu_torch.data.audio_dataset import get_audio_dataset

    jcfg = _jax_cfg(kind, False, _jax_enc_cfg(kind, **NARROW[kind]))
    jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm, vocab_size=512))
    write_wav(tmp_path / "a.wav", seconds=seconds)
    (tmp_path / "m.jsonl").write_text(json.dumps({"key": "a", "source": str(tmp_path / "a.wav"), "target": "x"}) + "\n")
    dc = _dataset_config(sys.modules[RunConfig.__module__], tmp_path / "m.jsonl", encoder_name=kind,
                         fixed_length=fixed)
    ds = get_audio_dataset(dc, ByteTokenizer(), "train")
    batch = ds.collator([ds[0]])
    params, tm = _pair(jcfg, batch, seed=8)
    want, _ = JSLAMModel(jcfg).apply({"params": params}, {k: jnp.asarray(v) for k, v in batch.items()
                                                           if isinstance(v, np.ndarray)}, method="forward_embeds")
    with torch.no_grad():
        got, _ = tm.forward_embeds({k: torch.from_numpy(v) for k, v in batch.items() if isinstance(v, np.ndarray)})
        enc, _ = tm.encode({k: torch.from_numpy(v) for k, v in batch.items() if isinstance(v, np.ndarray)})
    at = np.flatnonzero(batch["modality_mask"][0])
    assert len(at) == slots and enc.shape[1] == frames
    assert bool((got[0, at[frames:]] == 0).all()) and bool((got[0, at[:frames]].abs().sum(-1) > 0).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


def _recipe(path, *extra):
    from slam_llm_tpu_torch.config import load_run_config

    return load_run_config(["--config", str(REPO / "examples" / path), *extra])


def test_build_slam_config_takes_the_aac_recipes():
    """``aac_eat_vicuna.yaml`` and ``slam_aac_eat_vicuna.yaml`` build as the
    JAX package builds them (EAT-base, linear ds 5, vicuna-7b with a bf16
    base, SLAM-AAC's LoRA r8 on q / v); ``encoder_name=beats`` takes
    BEATs-iter3; the default presets are JAX's."""
    from slam_llm_tpu.models.slam_model import build_slam_config as j_build

    for path, lora in (("aac_audiocaps/conf/aac_eat_vicuna.yaml", 0), ("slam_aac/conf/slam_aac_eat_vicuna.yaml", 8)):
        for extra, kind, preset in (((), "eat", "eat-base"),
                                    (("++model_config.encoder_name=beats", "++model_config.encoder_config=null"),
                                     "beats", "beats-iter3")):
            cfg = _recipe(path, *extra)
            got, want = (build(cfg.train_config, cfg.model_config) for build in (tslam.build_slam_config, j_build))
            assert got.encoder == _port_enc_cfg(kind, JAX_ENC[kind][1](), torch.bfloat16)
            assert got.encoder == _port_enc_cfg(kind, want.encoder, torch.bfloat16)
            for name in ("encoder_dim", "llm_dim", "ds_rate"):
                assert getattr(got.projector_cfg, name) == getattr(want.projector_cfg, name), name
            for name in ("d_model", "n_layers", "n_heads", "base_quant", "lora_rank", "lora_targets"):
                assert getattr(got.llm, name) == getattr(want.llm, name), name
            assert (got.llm.base_quant, got.llm.lora_rank, got.projector) == ("none", lora, "linear")
            model = tslam.SLAMModel(got, device="meta")
            assert isinstance(model.encoder, PORT_ENC[kind][0]), preset
        assert cfg.dataset_config.dataset == "audio_dataset"


def test_finetune_then_decode_and_score_matches_jax(tmp_path):
    """SLAM-AAC at tiny size through both entry points, in f32, from files
    in the reference's layouts (a tiny HF Llama with its tokenizer.json, an
    EAT file from ``write_eat``): the port's ``pipeline.finetune`` trains the
    projector and the LoRA factors for 2 steps (fixed length, random crop)
    and writes ``model.pt``; the port's ``pipeline.inference_batch`` with
    ``ckpt_path`` decodes (beam 4) the text the JAX pipeline decodes from the
    same files and the port's ``model.msgpack``; the RTF counts the clips'
    true seconds; the port's ``caption_metrics`` scores the logs as
    JAX's."""
    from test_torch_tokenizer import build_llama_tokenizer
    from test_torch_weights_pipeline import _f32
    from test_torch_weights_pipeline import _port_cfg as _pipeline_cfg
    from transformers import LlamaConfig, LlamaForCausalLM

    from slam_llm_tpu.models import slam_model as jslam
    from slam_llm_tpu.pipeline import inference_batch as jinference_batch
    from slam_llm_tpu.utils import caption_metrics as jcaption
    from slam_llm_tpu_torch.pipeline import finetune, inference_batch
    from slam_llm_tpu_torch.tools.synth_checkpoint import write_eat
    from slam_llm_tpu_torch.utils import caption_metrics as tcaption
    from slam_llm_tpu_torch.utils.checkpoint import load_trainable, save_trainable_msgpack

    vocab = build_llama_tokenizer(tmp_path / "llm")
    torch.manual_seed(0)
    LlamaForCausalLM(LlamaConfig(
        vocab_size=vocab, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, rms_norm_eps=1e-5, rope_theta=10000.0, max_position_embeddings=256,
        initializer_range=0.2, tie_word_embeddings=False)).save_pretrained(tmp_path / "llm", safe_serialization=True)
    write_eat(str(tmp_path / "eat.pt"), tvit.ViTEncoderConfig.tiny_test(), seed=3, device="cpu")
    manifest = make_corpus(tmp_path, n=4, targets=["a dog barks", "rain falls on a roof"])
    overrides = {
        "model_config.llm_path": str(tmp_path / "llm"), "model_config.encoder_path": str(tmp_path / "eat.pt"),
        "model_config.encoder_name": "eat", "model_config.encoder_config": "eat-tiny-test",
        "dataset_config.dataset": "audio_dataset", "dataset_config.encoder_name": "eat",
        "dataset_config.target_length": 48, "dataset_config.random_crop": True,
        "dataset_config.prompt": "Describe the audio.",
        "train_config.freeze_llm": True, "train_config.freeze_encoder": True, "train_config.use_peft": True,
        "train_config.peft_config.r": 4, "decode_config.max_new_tokens": 6, "decode_config.num_beams": 4,
    }
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tslam, "build_slam_config", _f32(tslam.build_slam_config, torch.float32))
        mp.setattr(jslam, "build_slam_config", _f32(jslam.build_slam_config, jnp.float32))
        res = finetune.main(_pipeline_cfg(manifest, **overrides, **{
            "train_config.max_steps_per_epoch": 2, "train_config.output_dir": str(tmp_path / "out"),
            "train_config.lr": 1e-2, "train_config.warmup_steps": 1, "train_config.log_interval": 1,
            "train_config.run_validation": False}), device="cpu")
        assert len(res["steps"]) == 2 and all(np.isfinite(s["loss"]) for s in res["steps"])
        trained = res["trainer"].trainable
        assert {n.split(".")[0] for n in trained} == {"encoder_projector", "llm"}
        assert sum(n.endswith((".lora_a", ".lora_b")) for n in trained) == 8
        ckpt = res["checkpoints"][-1]
        save_trainable_msgpack(str(tmp_path / "model.msgpack"), load_trainable(ckpt))
        ours = inference_batch.main(_pipeline_cfg(manifest, **overrides, **{
            "ckpt_path": ckpt, "decode_config.decode_log": str(tmp_path / "port")}), device="cpu")
        theirs = jinference_batch.main(tiny_run_config(manifest, **overrides, **{
            "ckpt_path": str(tmp_path / "model.msgpack"), "decode_config.decode_log": str(tmp_path / "jax")}))
    pred = open(ours["pred"], encoding="utf-8").read()
    # a barely trained model's text may hold line breaks: the logs are compared whole
    assert ours["n"] == theirs["n"] == 4 and len(pred) > len("utt0\t\n") * 4
    assert pred == open(theirs["pred"], encoding="utf-8").read()
    assert open(ours["gt"]).read() == open(theirs["gt"]).read()
    # the RTF counts the clips' true seconds (0.5, 0.6, 0.7, 0.5), not the 48 fixed fbank frames a clip
    assert ours["audio_seconds"] == pytest.approx(2.3) and np.isfinite(ours["rtf"])
    assert tcaption.main(ours["gt"], ours["pred"]) == jcaption.main(theirs["gt"], theirs["pred"])


def test_entry_points_refuse_cuda_without_a_gpu(tmp_path):
    """``--device cuda`` (every entry point's default, ``synth_checkpoint``'s
    included) raises without a GPU: no CPU fallback."""
    from slam_llm_tpu_torch.pipeline import finetune, inference_batch
    from slam_llm_tpu_torch.tools import synth_checkpoint as synth

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    recipe = str(REPO / "examples" / "slam_aac" / "conf" / "slam_aac_eat_vicuna.yaml")
    for main in (finetune.main_cli, inference_batch.main_cli):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--config", recipe, "--device", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        synth.main([str(tmp_path), "--llm", "none", "--encoder", "eat-tiny-test"])
    assert synth.main([str(tmp_path), "--llm", "none", "--encoder", "beats-tiny-test", "--device", "cpu"])["encoder"]
    assert (tmp_path / "beats.pt").is_file()


def test_profile_train_builds_the_aac_recipe(tmp_path, monkeypatch):
    """``tools/profile_train.py --recipe aac`` at tiny widths on the CPU: the
    recipe's model (EAT with the published patching, the linear projector,
    a bf16-base LLM, the synthetic 32000-entry tokenizer) takes a training
    step on the recipe's fixed-length batch, and the kernel-family split
    reads the profile (no CUDA kernel on the CPU); ``tools/profile_decode.py``
    builds its test split."""
    from torch.profiler import ProfilerActivity, profile

    from slam_llm_tpu_torch.tools import profile_train
    from slam_llm_tpu_torch.train.state import Trainer

    monkeypatch.setitem(tvit.VIT_PRESETS, "eat-narrow-test", lambda: tvit.ViTEncoderConfig(**NARROW["eat"]))
    recipe, overrides = profile_train.split_recipe(["--recipe", "aac", "++model_config.encoder_config=eat-narrow-test",
                                                    "++model_config.llm_name=tiny-test"])
    cfg, model, tok, dataset, n = profile_train.build_recipe(recipe, overrides, tmp_path, device="cpu")
    c = model.cfg
    assert isinstance(model.encoder, tvit.ViTEncoder) and n == 16 and cfg.dataset_config.dataset == "audio_dataset"
    assert (c.llm.base_quant, c.llm.lora_rank, tok.vocab_size) == ("none", 0, 32000)
    trainer = Trainer(model, c, cfg.train_config).state_from_params()
    batch = trainer.put_batch(dataset.collator([dataset[i] for i in (0, n - 1)]))
    assert batch["audio_mel"].shape == (2, 1024, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        m = trainer.train_step(batch)
    assert np.isfinite(float(m["loss"])) and profile_train.split_by_family(prof) == {}
    assert set(trainer.trainable) == {n for n, _ in model.named_parameters() if n.startswith("encoder_projector.")}
    # tools/profile_decode.py builds the same recipe's test split
    cfg, _, _, dataset, _ = profile_train.build_recipe(recipe, overrides, tmp_path / "decode", device="cpu",
                                                       split="test")
    assert cfg.dataset_config.inference_mode and (dataset[0]["input_ids"][:102] == -1).all()
