"""The ST recipe's model pieces in the port against the JAX package, on the CPU.

The Q-Former and conv1d projectors take the same numpy-seeded parameters
through ``utils.convert`` and agree in f32. A tiny SLAMModel in the recipe's
shape (whisper encoder, Q-Former, a qwen2-shaped LLM with q/k/v biases, RoPE
theta 1e6 and 7 query heads over 1 kv head, so G = 7) agrees with the JAX
``SLAMModel`` in f32: logits and loss within 1e-5 relative, every Q-Former
gradient within 1e-4 relative L2 of ``jax.value_and_grad``, greedy and
beam-4 tokens identical to the JAX ``Generator``. Its trainable checkpoint
crosses between the packages both ways as ``model.msgpack``, and a 128-mel
whisper checkpoint (whisper-large-v3's frontend) written by ``transformers``
loads through the port's HF loader.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from slam_llm_tpu.inference.generate import GenerationConfig as JGenerationConfig
from slam_llm_tpu.inference.generate import Generator as JGenerator
from slam_llm_tpu.models import projector as jproj
from slam_llm_tpu.models.llm import LLMConfig as JLLMConfig
from slam_llm_tpu.models.slam_model import SLAMConfig as JSLAMConfig
from slam_llm_tpu.models.slam_model import SLAMModel as JSLAMModel
from slam_llm_tpu.models.whisper import WhisperEncoderConfig as JWhisperConfig
from slam_llm_tpu.train.optimizer import merge_params as j_merge
from slam_llm_tpu.train.optimizer import partition_params as j_partition
from slam_llm_tpu_torch.inference.generate import GenerationConfig, Generator
from slam_llm_tpu_torch.models import llm as tllm
from slam_llm_tpu_torch.models import projector as tproj
from slam_llm_tpu_torch.models import slam_model as tslam
from slam_llm_tpu_torch.models import whisper as twhisper
from slam_llm_tpu_torch.train.optimizer import partition_params
from slam_llm_tpu_torch.utils import checkpoint as tckpt
from slam_llm_tpu_torch.utils import hf_loader
from slam_llm_tpu_torch.utils.convert import flax_to_state_dict, from_flax_params, trainable_to_flax

EOS, PAD = 2, 0
N_QUERY = 8


def _seeded(tree, seed):
    """Every leaf of a flax parameter tree redrawn from a numpy generator:
    normal with std 1/sqrt(fan_in) for kernels and the queries, around 1
    for LayerNorm scales, small for biases."""
    rng = np.random.default_rng(seed)

    def draw(key, x):
        shape = np.shape(x)
        if key == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if key == "bias":
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else draw(k, v) for k, v in node.items()}

    return walk(nn.meta.unbox(tree))


# ---------------------------------------------------------------------------
# the projectors alone
# ---------------------------------------------------------------------------


PROJ = dict(encoder_dim=32, llm_dim=48, ds_rate=5, hidden_dim=40, query_len=N_QUERY, qformer_layers=2,
            qformer_dim=32, qformer_heads=2)


@pytest.mark.parametrize("kind", ["q-former", "cov1d-linear"])
def test_projector_matches_jax(kind):
    """f32: the same seeded parameters through ``flax_to_state_dict`` give
    outputs within 1e-5 of the JAX projector's largest entry, an encoder
    mask with padding included (the Q-Former's cross-attention bias)."""
    jcfg = jproj.ProjectorConfig(**PROJ, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 37, 32)).astype(np.float32)
    mask = np.ones((2, 37), np.int32)
    mask[1, 21:] = 0
    jm = jproj.build_projector(kind, jcfg)
    args = (jnp.asarray(x), jnp.asarray(mask)) if kind == "q-former" else (jnp.asarray(x),)
    params = _seeded(jm.init(jax.random.PRNGKey(0), *args)["params"], seed=3)
    want = np.asarray(jm.apply({"params": params}, *args))
    tm = tproj.build_projector(kind, tproj.ProjectorConfig(**PROJ, dtype=torch.float32))
    tm.load_state_dict(flax_to_state_dict(params))
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in ((x, mask) if kind == "q-former" else (x,)))).numpy()
    assert got.shape == want.shape == ((2, N_QUERY, 48) if kind == "q-former" else (2, 7, 48))
    assert tproj.post_projector_length(37, kind, tm.cfg) == got.shape[1]
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ---------------------------------------------------------------------------
# the tiny ST model
# ---------------------------------------------------------------------------


def _jax_cfg(projector="q-former"):
    # qwen2's shape at a tiny width: q/k/v biases, theta 1e6, G = 7
    llm = dataclasses.replace(JLLMConfig.tiny_test(), n_heads=7, n_kv_heads=1, head_dim=16, qkv_bias=True,
                              rope_theta=1e6, rms_eps=1e-6, dtype=jnp.float32)
    enc = dataclasses.replace(JWhisperConfig.tiny_test(), dtype=jnp.float32)
    proj = jproj.ProjectorConfig(**{**PROJ, "encoder_dim": enc.d_model, "llm_dim": llm.d_model},
                                 dtype=jnp.float32)
    return JSLAMConfig(llm=llm, encoder_name="whisper", encoder=enc, projector=projector, projector_cfg=proj,
                       freeze_encoder=True, freeze_llm=True)


def _port_cfg(jcfg):
    def conv(cls, obj):
        names = {f.name for f in dataclasses.fields(cls)} - {"dtype", "param_dtype"}
        return cls(**{n: getattr(obj, n) for n in names if hasattr(obj, n)}, dtype=torch.float32)

    return tslam.SLAMConfig(
        llm=dataclasses.replace(conv(tllm.LLMConfig, jcfg.llm), remat=False), encoder_name="whisper",
        encoder=conv(twhisper.WhisperEncoderConfig, jcfg.encoder), projector=jcfg.projector,
        projector_cfg=conv(tproj.ProjectorConfig, jcfg.projector_cfg),
        freeze_encoder=jcfg.freeze_encoder, freeze_llm=jcfg.freeze_llm,
    )


def _batch():
    """Two rows, row 0 left-padded by 3: N_QUERY audio pseudo-tokens (-1),
    then text; labels on the text after its first two tokens; row 1's mel
    padded from frame 100 (the Q-Former's cross-attention mask)."""
    rng = np.random.default_rng(0)
    b, t = 2, 22
    ids = rng.integers(3, 250, (b, t)).astype(np.int64)
    attn = np.ones((b, t), np.int32)
    modality = np.zeros((b, t), np.int32)
    labels = ids.copy()
    attn[0, :3] = 0
    ids[0, :3] = PAD
    for row, start in ((0, 3), (1, 0)):
        ids[row, start:start + N_QUERY] = -1
        modality[row, start:start + N_QUERY] = 1
        labels[row, :start + N_QUERY + 2] = -100
    mel_mask = np.ones((b, 128), np.int32)
    mel_mask[1, 100:] = 0
    return {"input_ids": ids, "attention_mask": attn, "modality_mask": modality, "labels": labels,
            "audio_mel": rng.standard_normal((b, 128, 8)).astype(np.float32), "audio_mel_mask": mel_mask}


@pytest.fixture(scope="module")
def st_pair():
    """(JAX config, seeded JAX params, the port model holding the same)."""
    jcfg = _jax_cfg()
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    params = _seeded(JSLAMModel(jcfg).init(jax.random.PRNGKey(0), batch, method="init_all")["params"], seed=5)
    tcfg = _port_cfg(jcfg)
    tm = tslam.SLAMModel(tcfg)
    tm.load_state_dict(from_flax_params(params, tcfg))
    return jcfg, params, tm


def _tbatch():
    return {k: torch.from_numpy(v) for k, v in _batch().items()}


def test_st_logits_loss_and_accuracy_match_jax(st_pair):
    jcfg, params, tm = st_pair
    out = JSLAMModel(jcfg).apply({"params": params}, {k: jnp.asarray(v) for k, v in _batch().items()},
                                 return_logits=True)
    with torch.no_grad():
        got = tm.eval()(_tbatch(), return_logits=True)
        fused = tm(_tbatch())
    want = np.asarray(out["logits"])
    live = _batch()["attention_mask"].astype(bool)
    assert np.abs(got["logits"].numpy()[live] - want[live]).max() <= 1e-5 * np.abs(want[live]).max()
    np.testing.assert_allclose(float(got["loss"]), float(out["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(fused["loss"]), float(out["loss"]), rtol=1e-5)
    assert float(got["acc"]) == float(out["acc"]) == float(fused["acc"])


def test_st_qformer_grads_match_jax(st_pair):
    """Only the Q-Former trains (the recipe freezes the encoder and the LLM);
    each of its gradients within 1e-4 relative L2 of jax.value_and_grad,
    the gradient having come back through the frozen LLM. The key
    projections' biases, whose gradient is 0 in exact arithmetic, are held
    to round-off on both sides instead."""
    jcfg, params, tm = st_pair
    trainable, frozen = j_partition(params, jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in _batch().items()}

    def loss_fn(tr):
        return JSLAMModel(jcfg).apply({"params": j_merge(tr, frozen)}, jbatch)["loss"]

    jl, jg = jax.value_and_grad(loss_fn)(trainable)
    tr, _ = partition_params(tm, tm.cfg)
    assert tr and all(n.startswith("encoder_projector.") for n in tr)
    out = tm.eval()(_tbatch())
    grads = torch.autograd.grad(out["loss"], list(tr.values()))
    np.testing.assert_allclose(float(out["loss"].detach()), float(jl), rtol=1e-5)
    got = trainable_to_flax(dict(zip(tr.keys(), grads)))["encoder_projector"]
    want = jg["encoder_projector"]
    flat_got, flat_want = (
        {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
         for path, x in jax.tree_util.tree_leaves_with_path(tree)} for tree in (got, want))
    # query, linear, norm, and per block 8 attention denses, 3 LayerNorms, fc1 / fc2 (kernel + bias each)
    assert set(flat_got) == set(flat_want) and len(flat_got) == 1 + 2 + 2 + 2 * (8 * 2 + 3 * 2 + 2 * 2)
    scale = max(np.linalg.norm(w) for w in flat_want.values())
    for key, g in flat_got.items():
        w = flat_want[key]
        if key.endswith("k_proj/bias"):
            # a key bias shifts every score of a query by one constant, which
            # the softmax cancels: its true gradient is 0, both sides round-off
            assert max(np.linalg.norm(g), np.linalg.norm(w)) <= 1e-6 * scale, key
            continue
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w), key


@pytest.mark.parametrize("num_beams", [1, 4])
def test_st_tokens_identical_to_jax(st_pair, num_beams):
    jcfg, params, tm = st_pair
    kw = dict(max_new_tokens=8, num_beams=num_beams, eos_token_id=EOS, pad_token_id=PAD)
    batch = {k: v for k, v in _batch().items() if k != "labels"}
    want = JGenerator(JSLAMModel(jcfg), JGenerationConfig(**kw)).generate({"params": params}, batch)
    got = Generator(tm.eval(), GenerationConfig(**kw)).generate(batch)
    assert got.shape == want.shape == (2, 8)
    np.testing.assert_array_equal(got, want)


def test_qformer_msgpack_crosses_both_ways(st_pair, tmp_path):
    """The Q-Former trained by either package decodes in the other: the
    port's ``model.msgpack`` loads into the JAX parameters bit-equal, and
    the JAX one into the port."""
    from slam_llm_tpu.utils.checkpoint import load_trainable_into as j_load_trainable_into
    from slam_llm_tpu.utils.checkpoint import save_trainable as j_save_trainable

    jcfg, params, tm = st_pair
    base = _seeded(params, seed=9)  # other weights everywhere, the Q-Former's included
    tr = {n: p for n, p in tm.named_parameters() if n.startswith("encoder_projector.")}
    tckpt.save_trainable_msgpack(str(tmp_path / "port" / "model.msgpack"), tr)
    loaded = j_load_trainable_into(base, str(tmp_path / "port" / "model.msgpack"))
    want_tr = j_partition(params, jcfg)[0]["encoder_projector"]
    for path, x in jax.tree_util.tree_leaves_with_path(want_tr):
        node = loaded["encoder_projector"]
        for k in path:
            node = node[k.key]
        assert np.array_equal(np.asarray(node), np.asarray(x)), path
    j_save_trainable(str(tmp_path / "jax" / "model.msgpack"), j_partition(params, jcfg)[0])
    fresh = tslam.SLAMModel(tm.cfg)
    fresh.load_state_dict(from_flax_params(base, tm.cfg))
    tckpt.load_trainable_into(fresh, str(tmp_path / "jax"))
    sd = fresh.state_dict()
    for name, t in tm.state_dict().items():
        if name.startswith("encoder_projector."):
            assert sd[name].dtype == torch.float32 and torch.equal(sd[name], t), name


def test_cov1d_slam_model_matches_jax():
    """The conv1d projector inside the model: the projected mask is the
    linear projector's, the loss the JAX package's within 1e-5."""
    jcfg = _jax_cfg("cov1d-linear")
    jbatch = {k: jnp.asarray(v) for k, v in _batch().items()}
    params = _seeded(JSLAMModel(jcfg).init(jax.random.PRNGKey(0), jbatch, method="init_all")["params"], seed=7)
    want = JSLAMModel(jcfg).apply({"params": params}, jbatch)
    tcfg = _port_cfg(jcfg)
    tm = tslam.SLAMModel(tcfg).eval()
    tm.load_state_dict(from_flax_params(params, tcfg))
    with torch.no_grad():
        got = tm(_tbatch())
        proj, mask = tm.encode(_tbatch())
    jproj_out, jmask = JSLAMModel(jcfg).apply({"params": params}, jbatch, method="encode")
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert np.abs(proj.numpy() - np.asarray(jproj_out)).max() <= 1e-5 * np.abs(np.asarray(jproj_out)).max()
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)


def test_build_slam_config_takes_the_st_recipe():
    """The recipe's YAML through the port's config loader: whisper-large-v3
    (128 mels), the Q-Former with 80 queries and 8 layers, qwen2-7b, as the
    JAX package builds them."""
    from pathlib import Path

    from slam_llm_tpu.models.slam_model import build_slam_config as j_build
    from slam_llm_tpu_torch.config import load_run_config

    recipe = Path(__file__).resolve().parent.parent / "examples" / "st_covost2" / "conf" / "st_whisper_qwen.yaml"
    cfg = load_run_config(["--config", str(recipe)])
    got, want = tslam.build_slam_config(cfg.train_config, cfg.model_config), j_build(cfg.train_config,
                                                                                      cfg.model_config)
    assert got.projector == want.projector == "q-former"
    for name in ("encoder_dim", "llm_dim", "query_len", "qformer_layers", "qformer_dim", "qformer_heads"):
        assert getattr(got.projector_cfg, name) == getattr(want.projector_cfg, name), name
    assert (got.projector_cfg.query_len, got.projector_cfg.qformer_layers) == (80, 8)
    assert got.encoder.n_mels == want.encoder.n_mels == 128 and got.encoder.n_layers == 32
    for name in ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads", "head_dim", "ffn_dim", "rope_theta",
                 "qkv_bias", "tied_embeddings"):
        assert getattr(got.llm, name) == getattr(want.llm, name), name
    assert cfg.dataset_config.mel_size == 128 and cfg.dataset_config.fix_length_audio == 80
    model = tslam.SLAMModel(got, device="meta")
    trainable = sum(p.numel() for n, p in model.named_parameters() if n.startswith("encoder_projector."))
    assert 80e6 < trainable < 90e6  # ~85 M: 8 blocks of ~10.2 M, the queries and the 768 -> 3584 head
    assert model.llm.lm_head.weight.shape == (152064, 3584)


def test_whisper_128_mel_checkpoint_loads_through_the_hf_loader(tmp_path):
    """A 128-mel whisper (whisper-large-v3's frontend) saved by transformers:
    the port's loader takes its (d, 128, 3) conv1, and the encoder's output
    equals transformers' on a 128-mel input."""
    from transformers import WhisperConfig, WhisperModel

    torch.manual_seed(0)
    ref = WhisperModel(WhisperConfig(
        vocab_size=64, num_mel_bins=128, d_model=32, encoder_layers=2, encoder_attention_heads=2,
        encoder_ffn_dim=128, decoder_layers=1, decoder_attention_heads=2, decoder_ffn_dim=64,
        max_source_positions=50, pad_token_id=0, bos_token_id=1, eos_token_id=2, decoder_start_token_id=1,
        suppress_tokens=None, begin_suppress_tokens=None)).eval()
    ref.save_pretrained(tmp_path, safe_serialization=True)
    enc = twhisper.WhisperEncoder(twhisper.WhisperEncoderConfig(
        n_mels=128, d_model=32, n_heads=2, n_layers=2, max_source_positions=50, dtype=torch.float32,
        mask_padding=False))
    sd = hf_loader.convert_encoder_checkpoint(str(tmp_path), "whisper", enc.cfg)
    assert sd["conv1.weight"].shape == (32, 128, 3)
    hf_loader.overlay_(enc, sd)
    mel = np.random.default_rng(0).standard_normal((1, 100, 128)).astype(np.float32)
    with torch.no_grad():
        want = ref.encoder(torch.from_numpy(mel).transpose(1, 2)).last_hidden_state.numpy()
        got, _ = enc(torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), want, atol=3e-4, rtol=1e-3)


def test_dataset_mel_size_128_reaches_the_frontend(tmp_path):
    """``mel_size: 128`` and ``fix_length_audio: 80`` through the port's
    speech dataset: a (3000, 128) log-mel equal to the JAX dataset's, and 80
    audio pseudo-token slots."""
    from helpers import make_corpus

    from slam_llm_tpu.config import RunConfig as JRunConfig
    from slam_llm_tpu.data.speech_dataset import get_speech_dataset as j_dataset
    from slam_llm_tpu_torch.config import RunConfig
    from slam_llm_tpu_torch.data.speech_dataset import get_speech_dataset
    from slam_llm_tpu_torch.data.tokenizer import ByteTokenizer

    manifest = make_corpus(tmp_path, n=1)
    items = []
    for cfg_cls, factory in ((RunConfig, get_speech_dataset), (JRunConfig, j_dataset)):
        dc = cfg_cls().dataset_config
        dc.train_data_path = dc.val_data_path = str(manifest)
        dc.mel_size, dc.fix_length_audio = 128, 80
        items.append(factory(dc, ByteTokenizer(), "train")[0])
    got, want = items
    assert got["audio_mel"].shape == (3000, 128)
    np.testing.assert_array_equal(got["audio_mel"], want["audio_mel"])
    assert got["audio_length"] == 80 and int((got["input_ids"][:80] == 0).sum()) == 80
    np.testing.assert_array_equal(got["labels"], want["labels"])


def test_qwen2_directory_from_synth_checkpoint_matches_transformers(tmp_path):
    """``tools/synth_checkpoint.write_llama`` at a qwen2 shape (q/k/v biases,
    theta 1e6, G = 7, an untied head) writes a directory that transformers
    reads as Qwen2; the port's HF loader gives the same logits in f32."""
    from transformers import AutoModelForCausalLM

    from slam_llm_tpu_torch.tools.synth_checkpoint import write_llama

    cfg = tllm.LLMConfig(vocab_size=300, d_model=112, n_layers=2, n_heads=7, n_kv_heads=1, head_dim=16, ffn_dim=96,
                         rope_theta=1e6, rms_eps=1e-6, qkv_bias=True, dtype=torch.float32, remat=False)
    write_llama(str(tmp_path), cfg, seed=2)
    ref = AutoModelForCausalLM.from_pretrained(str(tmp_path), torch_dtype=torch.float32).eval()
    assert type(ref).__name__ == "Qwen2ForCausalLM"
    llm = tllm.CausalLM(cfg).eval()
    hf_loader.overlay_(llm, hf_loader.convert_llama(hf_loader.load_hf_state_dict(str(tmp_path)), cfg))
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 300, (2, 11)))
    with torch.no_grad():
        want = ref(ids).logits.numpy()
        got = llm(llm.embed(ids), torch.ones(ids.shape, dtype=torch.int32)).numpy()
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=1e-3)
