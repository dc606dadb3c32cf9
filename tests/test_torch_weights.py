"""The port's weights path against the JAX package, ``transformers``,
``safetensors`` and ``flax`` on the CPU, at a tiny size.

* the safetensors reader / writer against the ``safetensors`` package (every
  supported dtype, bf16, two shards, ``__metadata__``), and the msgpack codec
  against ``flax.serialization`` both ways;
* ``convert_llama`` / ``convert_whisper_encoder`` against the JAX converters
  (through ``utils.convert``), bit-exact in f32, and the int8 base quantized
  at load bit-equal to the reference's ``quantize_int8_np``;
* the loaded port modules against ``LlamaForCausalLM`` and
  ``WhisperModel.encoder`` (f32, atol 3e-4, rtol 1e-3);
* trainable checkpoints: the JAX ``model.msgpack`` into the port (f32 logits
  within 1e-5 of JAX's), the port's ``model.msgpack`` into JAX, ``model.pt``
  bit-exact, and the loaders' errors;
* ``export_llama`` read back by ``LlamaForCausalLM.from_pretrained``;
* a fresh interpreter that loads all of it imports no HF package, msgpack,
  flax or jax.
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

from slam_llm_tpu.models.llm import LLMConfig as JLLMConfig
from slam_llm_tpu.models.projector import ProjectorConfig as JProjectorConfig
from slam_llm_tpu.models.slam_model import SLAMConfig as JSLAMConfig
from slam_llm_tpu.models.slam_model import SLAMModel as JSLAMModel
from slam_llm_tpu.models.whisper import WhisperEncoderConfig as JWhisperConfig
from slam_llm_tpu.ops.quant import quantize_int8_np
from slam_llm_tpu.train.optimizer import partition_params as j_partition
from slam_llm_tpu_torch.models import llm as tllm
from slam_llm_tpu_torch.models import projector as tproj
from slam_llm_tpu_torch.models import slam_model as tslam
from slam_llm_tpu_torch.models import whisper as twhisper
from slam_llm_tpu_torch.utils import checkpoint as tckpt
from slam_llm_tpu_torch.utils import hf_loader, msgpack_codec, safetensors_io
from slam_llm_tpu_torch.utils.convert import flax_to_state_dict, from_flax_params

REPO = Path(__file__).resolve().parent.parent
LLAMA = dict(vocab_size=128, d_model=64, n_layers=3, n_heads=4, n_kv_heads=2, head_dim=16, ffn_dim=96, rms_eps=1e-5)
WHISPER = dict(n_mels=16, d_model=32, n_heads=2, n_layers=2, max_source_positions=50)


@pytest.fixture(scope="module")
def hf_llama(tmp_path_factory):
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    model = LlamaForCausalLM(LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=3, num_attention_heads=4,
        num_key_value_heads=2, rms_norm_eps=1e-5, rope_theta=10000.0, max_position_embeddings=128,
        tie_word_embeddings=False)).eval()
    d = tmp_path_factory.mktemp("hf_llama")
    model.save_pretrained(d, safe_serialization=True)
    return model, d


@pytest.fixture(scope="module")
def hf_whisper(tmp_path_factory):
    from transformers import WhisperConfig, WhisperModel

    torch.manual_seed(0)
    model = WhisperModel(WhisperConfig(
        vocab_size=64, num_mel_bins=16, d_model=32, encoder_layers=2, encoder_attention_heads=2,
        encoder_ffn_dim=128, decoder_layers=1, decoder_attention_heads=2, decoder_ffn_dim=64,
        max_source_positions=50, pad_token_id=0, bos_token_id=1, eos_token_id=2, decoder_start_token_id=1,
        suppress_tokens=None, begin_suppress_tokens=None)).eval()
    d = tmp_path_factory.mktemp("hf_whisper")
    model.save_pretrained(d, safe_serialization=True)
    return model, d


def _port_llm(**kw):
    return tllm.CausalLM(tllm.LLMConfig(**{**LLAMA, "dtype": torch.float32, "remat": False, **kw})).eval()


# ---------------------------------------------------------------------------
# formats
# ---------------------------------------------------------------------------


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "f32": torch.randn(3, 5, generator=g), "f16": torch.randn(7, generator=g).half(),
        "bf16": torch.randn(2, 3, 4, generator=g).bfloat16(), "i8": torch.randint(-128, 128, (9,), dtype=torch.int8),
        "i32": torch.randint(-2**31, 2**31 - 1, (2, 2), dtype=torch.int32),
        "i64": torch.randint(-2**40, 2**40, (3,), dtype=torch.int64), "bool": torch.rand(5, generator=g) > 0.5,
        "scalar": torch.tensor(1.5), "empty": torch.zeros(0, 4),
    }


def test_safetensors_reader_and_writer_match_the_package(tmp_path):
    from safetensors import safe_open
    from safetensors.torch import load_file, save_file

    ts = _tensors()
    save_file(ts, str(tmp_path / "ref.safetensors"), metadata={"format": "pt", "note": "x"})
    got = safetensors_io.load_file(str(tmp_path / "ref.safetensors"))
    assert set(got) == set(ts)
    for k, v in ts.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k

    n = safetensors_io.save_file(ts, str(tmp_path / "port.safetensors"), metadata={"format": "pt"})
    assert n == os.path.getsize(tmp_path / "port.safetensors")
    back = load_file(str(tmp_path / "port.safetensors"))
    for k, v in ts.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    with safe_open(str(tmp_path / "port.safetensors"), "pt") as f:
        assert f.metadata() == {"format": "pt"}

    # two shards in one directory, as an HF checkpoint ships them
    shards = tmp_path / "sharded"
    shards.mkdir()
    save_file({k: ts[k] for k in ("f32", "bf16")}, str(shards / "model-00001-of-00002.safetensors"))
    safetensors_io.save_file({k: ts[k] for k in ("i8", "f16")}, str(shards / "model-00002-of-00002.safetensors"))
    sd = hf_loader.load_hf_state_dict(str(shards))
    assert set(sd) == {"f32", "bf16", "i8", "f16"} and sd["bf16"].dtype == torch.bfloat16
    assert all(torch.equal(sd[k], ts[k]) for k in sd)

    save_file({"u8": torch.arange(4, dtype=torch.uint8)}, str(tmp_path / "u8.safetensors"))
    with pytest.raises(ValueError, match="U8"):
        safetensors_io.load_file(str(tmp_path / "u8.safetensors"))


def test_torch_bin_checkpoints_load(tmp_path):
    ts = {"w": torch.randn(3, 4), "b": torch.randn(4).bfloat16()}
    torch.save({"state_dict": ts}, tmp_path / "pytorch_model.bin")
    sd = hf_loader.load_hf_state_dict(str(tmp_path))
    assert set(sd) == {"w", "b"} and all(torch.equal(sd[k], ts[k]) for k in ts)


def test_msgpack_codec_matches_flax_both_ways(monkeypatch):
    from flax import serialization

    rng = np.random.default_rng(0)
    tree = {"a": {"kernel": rng.standard_normal((3, 4)).astype(np.float32)},
            "bf16": np.asarray(jnp.asarray(rng.standard_normal(5), jnp.bfloat16)),
            "f32": np.float32(1.5), "i8": np.int8(-3), "i64": np.arange(6, dtype=np.int64).reshape(2, 3),
            "bool": np.array([True, False]), "empty": np.zeros((0, 2), np.float32),
            "big": rng.standard_normal(40).astype(np.float32)}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)  # "big" goes out chunked
    monkeypatch.setattr(msgpack_codec, "MAX_CHUNK_SIZE", 64)
    blob = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    got = msgpack_codec.restore(blob)
    for k in ("i64", "bool", "empty", "big"):
        assert torch.equal(got[k], torch.from_numpy(tree[k])), k
    assert torch.equal(got["a"]["kernel"], torch.from_numpy(tree["a"]["kernel"]))
    assert got["bf16"].dtype == torch.bfloat16
    assert torch.equal(got["bf16"].float(), torch.from_numpy(tree["bf16"].astype(np.float32)))
    assert got["f32"].dim() == 0 and got["f32"].dtype == torch.float32 and got["f32"].item() == 1.5
    assert got["i8"].dtype == torch.int8 and got["i8"].item() == -3

    ours = {"a": {"kernel": torch.from_numpy(tree["a"]["kernel"])}, "bf16": got["bf16"], "f32": np.float32(1.5),
            "i8": np.int8(-3), "big": torch.from_numpy(tree["big"]), "plain": [1, -1, -40, 300, 2**40, 1.25, "s" * 40, None,
                                                                              True, b"xy"]}
    back = serialization.msgpack_restore(msgpack_codec.serialize(ours))
    assert np.array_equal(back["a"]["kernel"], tree["a"]["kernel"]) and np.array_equal(back["big"], tree["big"])
    assert back["bf16"].dtype == tree["bf16"].dtype and np.array_equal(back["bf16"], tree["bf16"])
    assert type(back["f32"]) is np.float32 and back["f32"] == 1.5 and back["i8"] == np.int8(-3)
    assert back["plain"] == ours["plain"]
    import msgpack  # plain objects encode byte for byte as msgpack does

    assert msgpack_codec.packb(ours["plain"]) == msgpack.packb(ours["plain"], use_bin_type=True)


# ---------------------------------------------------------------------------
# HF converters and loaded modules
# ---------------------------------------------------------------------------


def test_convert_llama_matches_the_jax_converter(hf_llama):
    from slam_llm_tpu.utils import hf_loader as jloader

    _, d = hf_llama
    cfg = tllm.LLMConfig(**LLAMA)
    ours = hf_loader.convert_llama(hf_loader.load_hf_state_dict(str(d)), cfg)
    theirs = flax_to_state_dict(jloader.convert_llama(jloader.load_hf_state_dict(str(d)), JLLMConfig(**LLAMA)))
    assert set(ours) == set(theirs)
    for k in ours:
        assert torch.equal(ours[k].float(), theirs[k]), k


def test_convert_whisper_matches_the_jax_converter(hf_whisper):
    from slam_llm_tpu.utils import hf_loader as jloader

    _, d = hf_whisper
    ours = hf_loader.convert_whisper_encoder(hf_loader.load_hf_state_dict(str(d)), twhisper.WhisperEncoderConfig(**WHISPER))
    theirs = flax_to_state_dict(jloader.convert_whisper_encoder(jloader.load_hf_state_dict(str(d)),
                                                                JWhisperConfig(**WHISPER)))
    assert set(ours) == set(theirs)
    for k in ours:
        assert torch.equal(ours[k].float(), theirs[k]), k


def test_int8_base_is_quantized_at_load_bit_equal_to_the_reference(hf_llama):
    from slam_llm_tpu.utils import hf_loader as jloader

    _, d = hf_llama
    llm = _port_llm(base_quant="int8", base_quant_bwd="int8_rot")
    hf_loader.overlay_(llm, hf_loader.convert_llama(hf_loader.load_hf_state_dict(str(d)), llm.cfg))
    jtree = jloader.convert_llama(jloader.load_hf_state_dict(str(d)), JLLMConfig(**LLAMA))["decoder"]["layers"]
    n = 0
    for group, names in (("attn", ("q_proj", "k_proj", "v_proj", "o_proj")), ("mlp", ("gate_proj", "up_proj", "down_proj"))):
        for name in names:
            q, s = quantize_int8_np(jtree[group][name]["kernel"])  # (L, in, out) over in
            for i, layer in enumerate(llm.layers):
                mod = getattr(getattr(layer, group), name)
                assert np.array_equal(mod.kernel_q.numpy(), q[i].T) and np.array_equal(mod.kernel_scale.numpy(), s[i])
                n += 1
    assert n == 21


def test_llama_logits_match_transformers(hf_llama):
    model_t, d = hf_llama
    llm = _port_llm()
    hf_loader.overlay_(llm, hf_loader.convert_llama(hf_loader.load_hf_state_dict(str(d)), llm.cfg))
    ids = np.array([[1, 5, 9, 22, 77, 3, 8, 100], [4, 4, 90, 127, 0, 15, 33, 2]], dtype=np.int64)
    with torch.no_grad():
        ref = model_t(torch.from_numpy(ids)).logits.numpy()
        got = llm(llm.embed(torch.from_numpy(ids)), torch.ones(ids.shape, dtype=torch.int32)).numpy()
    np.testing.assert_allclose(got, ref, atol=3e-4, rtol=1e-3)


def test_whisper_encoder_matches_transformers(hf_whisper):
    model_t, d = hf_whisper
    enc = twhisper.WhisperEncoder(twhisper.WhisperEncoderConfig(**WHISPER, dtype=torch.float32, mask_padding=False))
    sd = hf_loader.load_hf_state_dict(str(d))
    assert any("embed_positions" in k for k in sd) and any(k.startswith("decoder.") for k in sd)  # ignored, not loaded
    hf_loader.overlay_(enc, hf_loader.convert_whisper_encoder(sd, enc.cfg))
    mel = np.random.default_rng(0).standard_normal((1, 100, 16)).astype(np.float32)  # 2 * max_source_positions
    with torch.no_grad():
        ref = model_t.encoder(torch.from_numpy(mel).transpose(1, 2)).last_hidden_state.numpy()
        got, _ = enc(torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-4, rtol=1e-3)


# ---------------------------------------------------------------------------
# trainable checkpoints
# ---------------------------------------------------------------------------


def _jax_cfg():
    llm = dataclasses.replace(JLLMConfig.tiny_test(), lora_rank=4, dtype=jnp.float32, base_quant="int8")
    enc = dataclasses.replace(JWhisperConfig.tiny_test(), dtype=jnp.float32)
    proj = JProjectorConfig(encoder_dim=enc.d_model, llm_dim=llm.d_model, ds_rate=5, hidden_dim=32, dtype=jnp.float32)
    return JSLAMConfig(llm=llm, encoder_name="whisper", encoder=enc, projector="linear", projector_cfg=proj)


def _port_cfg(jcfg):
    def conv(cls, obj):
        names = {f.name for f in dataclasses.fields(cls)} - {"dtype", "param_dtype"}
        return cls(**{n: getattr(obj, n) for n in names if hasattr(obj, n)}, dtype=torch.float32)

    return tslam.SLAMConfig(llm=conv(tllm.LLMConfig, jcfg.llm), encoder_name="whisper",
                            encoder=conv(twhisper.WhisperEncoderConfig, jcfg.encoder), projector="linear",
                            projector_cfg=conv(tproj.ProjectorConfig, jcfg.projector_cfg))


def _batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 250, (2, 20)).astype(np.int64)
    ids[:, :6] = -1
    modality = np.zeros((2, 20), np.int32)
    modality[:, :6] = 1
    return {"input_ids": ids, "attention_mask": np.ones((2, 20), np.int32), "modality_mask": modality,
            "audio_mel": rng.standard_normal((2, 64, 8)).astype(np.float32), "audio_mel_mask": np.ones((2, 64), np.int32)}


@pytest.fixture(scope="module")
def jax_model():
    """The JAX tiny sandwich (int8 base, LoRA r4) in f32: its base params,
    and a trained-looking copy whose projector and LoRA factors are redrawn."""
    jcfg = _jax_cfg()
    variables = JSLAMModel(jcfg).init(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in _batch().items()},
                                      method="init_all")
    base = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(variables["params"]))
    rng = np.random.default_rng(1)
    trained = jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.standard_normal(x.shape) * 0.3).astype(np.float32)
        if any(getattr(k, "key", None) in ("lora_a", "lora_b", "encoder_projector") for k in p) else x, base)
    return jcfg, base, trained


def _prefill(model, params, batch):
    from slam_llm_tpu.models.llm import init_kv_cache as j_init_kv_cache

    b, t = batch["input_ids"].shape
    if params is not None:
        logits, _ = model.apply({"params": params}, {k: jnp.asarray(v) for k, v in batch.items()},
                                j_init_kv_cache(model.cfg.llm, b, t + 1, gen_start=t), method="prefill")
        return np.asarray(logits)
    with torch.inference_mode():
        logits, _ = model.prefill({k: torch.from_numpy(v) for k, v in batch.items()},
                                  tllm.init_kv_cache(model.cfg.llm, b, t + 1, gen_start=t))
    return logits.numpy()


def _port_from(jcfg, params):
    tcfg = _port_cfg(jcfg)
    tm = tslam.SLAMModel(tcfg).eval()
    tm.load_state_dict(from_flax_params(params, tcfg))
    return tm


def test_jax_model_msgpack_loads_into_the_port(jax_model, tmp_path):
    from slam_llm_tpu.utils.checkpoint import save_trainable as j_save_trainable

    jcfg, base, trained = jax_model
    j_save_trainable(str(tmp_path / "model.msgpack"), j_partition(trained, jcfg)[0])
    tm = _port_from(jcfg, base)
    assert tckpt.resolve_trainable(str(tmp_path)) == str(tmp_path / "model.msgpack")
    tckpt.load_trainable_into(tm, str(tmp_path))
    assert all(p.dtype == torch.float32 for n, p in tm.named_parameters() if "lora" in n or "projector" in n)
    expected = _port_from(jcfg, trained).state_dict()
    for name, t in tm.state_dict().items():
        assert torch.equal(t, expected[name]), name
    batch = _batch()
    np.testing.assert_allclose(_prefill(tm, None, batch), _prefill(JSLAMModel(jcfg), trained, batch), atol=1e-5, rtol=0)


def test_port_msgpack_loads_into_jax(jax_model, tmp_path):
    from slam_llm_tpu.utils.checkpoint import load_trainable_into as j_load_trainable_into

    jcfg, base, trained = jax_model
    tm = _port_from(jcfg, trained)
    trainable = {n: p for n, p in tm.named_parameters() if "lora" in n or "projector" in n}
    tckpt.save_trainable_msgpack(str(tmp_path / "model.msgpack"), trainable)
    loaded, want = _flat(j_load_trainable_into(base, str(tmp_path / "model.msgpack"))), _flat(trained)
    assert set(loaded) == set(want)
    for key, x in want.items():
        assert loaded[key].dtype == x.dtype and np.array_equal(loaded[key], x), key


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


def test_model_pt_round_trip_is_bit_exact(jax_model, tmp_path):
    jcfg, base, trained = jax_model
    src = _port_from(jcfg, trained)
    trainable = {n: p for n, p in src.named_parameters() if "lora" in n or "projector" in n}
    tckpt.save_trainable(str(tmp_path / "ck" / "model.pt"), trainable)
    tckpt.save_trainable_msgpack(str(tmp_path / "ck" / "model.msgpack"), trainable)
    dst = _port_from(jcfg, base)
    tckpt.load_trainable_into(dst, str(tmp_path / "ck"))  # model.pt wins over model.msgpack
    assert tckpt.resolve_trainable(str(tmp_path / "ck")).endswith("model.pt")
    for name, t in src.state_dict().items():
        assert torch.equal(t, dst.state_dict()[name]), name


def test_loaders_raise_on_unknown_keys_wrong_shapes_and_missing_paths(jax_model, tmp_path, hf_llama):
    jcfg, base, _ = jax_model
    tm = _port_from(jcfg, base)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    lora = "llm.layers.0.attn.q_proj.lora_a"
    torch.save({lora: torch.ones(4, 64), "llm.nowhere.weight": torch.ones(2)}, tmp_path / "unknown.pt")
    with pytest.raises(KeyError, match="nowhere"):
        tckpt.load_trainable_into(tm, str(tmp_path / "unknown.pt"))
    torch.save({lora: torch.ones(4, 63)}, tmp_path / "shape.pt")
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.load_trainable_into(tm, str(tmp_path / "shape.pt"))
    assert all(torch.equal(v, tm.state_dict()[k]) for k, v in before.items())  # a failed load changes nothing
    for missing in (tmp_path / "none", tmp_path / "none.pt"):
        with pytest.raises(FileNotFoundError):
            tckpt.load_trainable_into(tm, str(missing))
    with pytest.raises(FileNotFoundError, match="neither"):
        tckpt.resolve_trainable(str(tmp_path))
    mc = type("MC", (), {"llm_path": str(tmp_path / "no_llm"), "encoder_path": None, "encoder_name": "whisper"})()
    with pytest.raises(FileNotFoundError, match="llm_path"):
        hf_loader.load_pretrained_into(tm, mc)
    with pytest.raises(FileNotFoundError, match="encoder_path"):
        hf_loader.convert_encoder_checkpoint(str(tmp_path / "no_enc"), "whisper", None)
    # a family the reference loads from a file and the port does not yet;
    # a directory of a family that has no directory converter
    torch.save({"model": {}}, tmp_path / "beats_tokenizer.pt")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        hf_loader.convert_encoder_checkpoint(str(tmp_path / "beats_tokenizer.pt"), "beats_tokenizer", None)
    with pytest.raises(ValueError, match="cannot load an HF directory"):
        hf_loader.convert_encoder_checkpoint(str(tmp_path), "beats", None)
    with pytest.raises(FileNotFoundError, match="no safetensors"):
        hf_loader.load_hf_state_dict(str(tmp_path / "none"))
    llm = _port_llm(n_layers=2, vocab_size=120)  # the checkpoint has 128 rows
    with pytest.raises(ValueError, match="embed_tokens"):
        hf_loader.overlay_(llm, hf_loader.convert_llama(hf_loader.load_hf_state_dict(str(hf_llama[1])), llm.cfg))
    with pytest.raises(KeyError, match="layers.3"):
        hf_loader.convert_llama(hf_loader.load_hf_state_dict(str(hf_llama[1])), tllm.LLMConfig(**{**LLAMA, "n_layers": 4}))
    assert tckpt.latest_checkpoint(str(tmp_path / "none")) is None
    for e, s in ((1, 9), (2, 3), (1, 12)):
        (tmp_path / "runs" / f"m_epoch_{e}_step_{s}").mkdir(parents=True)
    assert tckpt.latest_checkpoint(str(tmp_path / "runs")).endswith("m_epoch_2_step_3")


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


def test_clap_file_loads_through_the_encoder_dispatch(tmp_path):
    """A ``write_clap`` file (an ASE ``{"model": sd}``) through
    ``convert_encoder_checkpoint`` with ``encoder_name: clap``: the same
    tensors as ``convert_ase_torch_state`` on the file's state dict, and the
    JAX package's dispatch reads the same file."""
    from slam_llm_tpu.models import clap as jclap
    from slam_llm_tpu.utils import hf_loader as j_hf_loader
    from slam_llm_tpu_torch.models import clap as tclap
    from slam_llm_tpu_torch.tools import synth_checkpoint as synth
    from slam_llm_tpu_torch.utils.convert import clap_from_flax

    cfg = tclap.CLAPConfig.tiny_test()
    path = str(tmp_path / "clap.pt")
    synth.write_clap(path, cfg, seed=2)
    got = hf_loader.convert_encoder_checkpoint(path, "clap", cfg)
    want = tclap.convert_ase_torch_state(hf_loader.load_torch_checkpoint(path), cfg)
    assert got.keys() == want.keys() == tclap.CLAP(cfg).state_dict().keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    j_params = j_hf_loader.convert_encoder_checkpoint(path, "clap", jclap.CLAPConfig.tiny_test())
    from_jax = clap_from_flax(j_params["params"], cfg)
    assert from_jax.keys() == got.keys()
    for k, v in from_jax.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)


def test_export_llama_loads_back_in_transformers(hf_llama, tmp_path):
    from transformers import LlamaForCausalLM

    from slam_llm_tpu_torch.utils.hf_export import export_llama

    _, d = hf_llama
    llm = _port_llm(lora_rank=4, lora_alpha=8.0, lora_targets=("q_proj", "v_proj", "down_proj"))
    hf_loader.overlay_(llm, hf_loader.convert_llama(hf_loader.load_hf_state_dict(str(d)), llm.cfg))
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in llm.named_parameters():
            if "lora" in name:
                p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    export_llama(llm, str(tmp_path / "export"))
    cfg = json.loads((tmp_path / "export" / "config.json").read_text())
    assert cfg["num_hidden_layers"] == 3 and cfg["torch_dtype"] == "float32"
    model_t = LlamaForCausalLM.from_pretrained(str(tmp_path / "export")).eval()
    ids = np.array([[1, 5, 9, 22, 77, 3, 8, 100]], dtype=np.int64)
    with torch.no_grad():
        ref = model_t(torch.from_numpy(ids)).logits.numpy()
        got = llm(llm.embed(torch.from_numpy(ids)), torch.ones(ids.shape, dtype=torch.int32)).numpy()
    np.testing.assert_allclose(got, ref, atol=3e-4, rtol=1e-3)


def test_export_of_an_int8_base_merges_lora_into_the_dequantized_weight(hf_llama, tmp_path):
    from slam_llm_tpu_torch.ops.quant import dequantize_int8
    from slam_llm_tpu_torch.utils.hf_export import export_llama

    llm = _port_llm(lora_rank=4, lora_alpha=32.0, base_quant="int8")
    hf_loader.overlay_(llm, hf_loader.convert_llama(hf_loader.load_hf_state_dict(str(hf_llama[1])), llm.cfg))
    with torch.no_grad():
        for name, p in llm.named_parameters():
            if "lora" in name:
                p.normal_(0.0, 0.2)
    export_llama(llm, str(tmp_path))
    sd = safetensors_io.load_file(str(tmp_path / "model.safetensors"))
    assert all(t.dtype == torch.float32 for t in sd.values()) and len(sd) == 3 + 9 * 3
    q = llm.layers[1].attn.q_proj
    want = dequantize_int8(q.kernel_q, q.kernel_scale, contract_axis=-1) + (q.lora_b @ q.lora_a) * (32.0 / 4)
    assert torch.equal(sd["model.layers.1.self_attn.q_proj.weight"], want)
    k = llm.layers[1].attn.k_proj
    assert torch.equal(sd["model.layers.1.self_attn.k_proj.weight"], dequantize_int8(k.kernel_q, k.kernel_scale, -1))


# ---------------------------------------------------------------------------
# the card's host has none of transformers, safetensors, msgpack, flax, jax
# ---------------------------------------------------------------------------

_PROBE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
llm_dir, tok_dir, msgpack_path = sys.argv[2:5]
from slam_llm_tpu_torch.data.tokenizer import load_tokenizer
from slam_llm_tpu_torch.utils import checkpoint, hf_export, hf_loader, textnorm, wer
from slam_llm_tpu_torch.pipeline import finetune, inference, inference_batch
from slam_llm_tpu_torch.tools import synth_checkpoint
sd = hf_loader.load_hf_state_dict(llm_dir)
tok = load_tokenizer(tok_dir)
trainable = checkpoint.load_trainable(msgpack_path)
res = wer.compute_wer_lists([textnorm.EnglishTextNormalizer()("Hello, World!")], ["hello world"])
banned = ("transformers", "tokenizers", "safetensors", "msgpack", "flax", "jax", "slam_llm_tpu")
print(json.dumps({"tensors": len(sd), "ids": tok.encode("hello world"), "trainable": len(trainable), "wer": res.wer,
                  "imported": sorted(m for m in sys.modules if m.split(".")[0] in banned)}))
"""


def test_weights_path_imports_no_hf_package_msgpack_flax_or_jax(hf_llama, jax_model, tmp_path):
    from slam_llm_tpu.utils.checkpoint import save_trainable as j_save_trainable
    from transformers import AutoTokenizer

    from test_torch_tokenizer import build_llama_tokenizer

    jcfg, _, trained = jax_model
    j_save_trainable(str(tmp_path / "model.msgpack"), j_partition(trained, jcfg)[0])
    build_llama_tokenizer(tmp_path / "tok")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE, str(REPO), str(hf_llama[1]), str(tmp_path / "tok"),
                          str(tmp_path / "model.msgpack")], capture_output=True, text=True, env=env, timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["imported"] == [] and got["wer"] == 0.0
    assert got["tensors"] == 3 * 9 + 3 and got["trainable"] == 4 + 2 * 2 * 2
    assert got["ids"] == AutoTokenizer.from_pretrained(str(tmp_path / "tok")).encode("hello world")
