"""VALL-E X and its EnCodec decoder in the port against the JAX package, on the CPU.

One set of weights (a tiny JAX ``VALLE``) goes into both packages through
``utils.convert.flax_to_state_dict``. In f32 the loss and its parts agree
within 1e-5 relative and every gradient within 1e-5 of the model's largest
gradient entry (the key biases' gradients are zero up to rounding); in bf16
the loss within 2e-2. Greedy AR decode (top_k 1), the NAR fill and
``synthesize`` give equal codes; the dataset's items, batches and NAR
stages are equal; the EnCodec decode is within 1e-5 of the JAX decoder's
from the same converted parameters and from one HF-layout state dict
through both converters; checkpoints pass between the packages in both
directions; ``pipeline.finetune`` -> ``pipeline.inference_vallex`` writes a
non-silent wav; the training loop logs a batch that carries no
``input_ids``.
"""

import dataclasses
import json
import wave
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from slam_llm_tpu.data import vallex_dataset as jds_mod
from slam_llm_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from slam_llm_tpu.models import encodec as jenc
from slam_llm_tpu.models import vallex as jv
from slam_llm_tpu.pipeline import inference_vallex as jinf
from slam_llm_tpu_torch.data import vallex_dataset as tds_mod
from slam_llm_tpu_torch.data.tokenizer import ByteTokenizer
from slam_llm_tpu_torch.models import encodec as tenc
from slam_llm_tpu_torch.models import vallex as tv
from slam_llm_tpu_torch.ops.torch_port import to_device
from slam_llm_tpu_torch.pipeline import inference_vallex as tinf
from slam_llm_tpu_torch.utils.convert import flax_to_state_dict

B, TT, TA = 3, 8, 12


def _batch():
    rng = np.random.default_rng(0)
    tm = np.zeros((B, TT), np.int32)
    am = np.zeros((B, TA), np.int32)
    for i, (nt, na) in enumerate(((8, 12), (5, 7), (3, 10))):  # text padded inside the row, one full audio row
        tm[i, :nt], am[i, :na] = 1, 1
    return {"text_ids": rng.integers(0, 32, (B, TT)) * tm, "text_mask": tm,
            "audio_ids": rng.integers(0, 16, (B, 4, TA)) * am[:, None], "audio_mask": am,
            "nar_stage": np.array([1, 3, 2], np.int32)}


@pytest.fixture(scope="module")
def models():
    """The tiny JAX VALLE in f32 and the port's VALLE with its weights."""
    jcfg = dataclasses.replace(jv.VallexConfig.tiny_test(), dtype=jnp.float32)
    jm = jv.VALLE(jcfg)
    batch = _batch()
    params = nn.meta.unbox(jm.init(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()},
                                   method="init_all")["params"])
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = tv.VALLE(dataclasses.replace(tv.VallexConfig.tiny_test(), dtype=torch.float32))
    tm.load_state_dict(flax_to_state_dict(params))
    return jm, params, tm.eval(), batch


def test_loss_and_every_gradient_match_jax_in_f32(models):
    jm, params, tm, batch = models

    def loss(p):
        out = jm.apply({"params": p}, {k: jnp.asarray(v) for k, v in batch.items()})
        return out["loss"], out

    (_, jout), jgrad = jax.value_and_grad(loss, has_aux=True)(params)
    for p in tm.parameters():
        p.requires_grad_(True)
    out = tm({k: torch.as_tensor(v) for k, v in batch.items()})
    grads = dict(zip([n for n, _ in tm.named_parameters()], torch.autograd.grad(out["loss"], list(tm.parameters()))))
    for p in tm.parameters():
        p.requires_grad_(False)
    for key in ("loss", "ar_loss", "nar_loss", "acc"):
        np.testing.assert_allclose(float(out[key]), float(jout[key]), rtol=1e-5, err_msg=key)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jgrad))
    assert set(want) == set(grads)
    scale = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        err = float((grads[name] - w).abs().max())
        assert err <= 1e-5 * scale, (name, err, scale)
    assert float(want["nar_decoder.layers.0.norm1.mod.weight"].abs().max()) > 1e-3 * scale  # AdaLN's mod trains


def test_bf16_loss_matches_jax_within_2e_2(models):
    _, params, _, batch = models
    jm = jv.VALLE(jv.VallexConfig.tiny_test())
    want = jm.apply({"params": params}, {k: jnp.asarray(v) for k, v in batch.items()})
    tm = tv.VALLE(tv.VallexConfig.tiny_test())
    tm.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        got = tm({k: torch.as_tensor(v) for k, v in batch.items()})
    for key in ("loss", "ar_loss", "nar_loss"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=2e-2, err_msg=key)


def test_greedy_ar_and_nar_tokens_match_jax(models):
    jm, params, tm, batch = models
    prompt0 = batch["audio_ids"][:, 0, :4]
    plen = np.array([4, 3, 4], np.int32)
    ja = np.asarray(jm.apply({"params": params}, jnp.asarray(batch["text_ids"]), jnp.asarray(batch["text_mask"]),
                             jnp.asarray(prompt0), jnp.asarray(plen), 6, jax.random.PRNGKey(0), 1, method="infer_ar"))
    ta = tm.infer_ar(torch.as_tensor(batch["text_ids"]), torch.as_tensor(batch["text_mask"]), torch.as_tensor(prompt0),
                     torch.as_tensor(plen).long(), 6, torch.Generator().manual_seed(3), top_k=1)
    np.testing.assert_array_equal(ta.numpy(), ja)
    full = np.zeros((B, 4, 10), np.int64)
    full[:, 0] = ja
    full[:, 1:, :4] = batch["audio_ids"][:, 1:, :4]
    mask = np.ones((B, 10), np.int32)
    jn = jm.apply({"params": params}, jnp.asarray(batch["text_ids"]), jnp.asarray(batch["text_mask"]),
                  jnp.asarray(full), jnp.asarray(mask), jnp.asarray(plen), method="infer_nar")
    tn = tm.infer_nar(torch.as_tensor(batch["text_ids"]), torch.as_tensor(batch["text_mask"]), torch.as_tensor(full),
                      torch.as_tensor(mask), torch.as_tensor(plen).long())
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert np.array_equal(tn.numpy()[0, 1:, :4], full[0, 1:, :4])  # the prompt keeps its codes


def _synth_both(jm, params, tm, **kw):
    rng = np.random.default_rng(7)
    prompt_codes = rng.integers(0, 16, (4, 5))
    p_ids, t_ids = jinf.text_to_ids("hello", None, 32), jinf.text_to_ids("a longer target", None, 32)
    jcodes, jn = jinf.synthesize(jm, {"params": params}, p_ids, t_ids, prompt_codes, max_new=8, top_k=1,
                                 rng=jax.random.PRNGKey(1))
    tcodes, tn = tinf.synthesize(tm, tinf.text_to_ids("hello", None, 32), tinf.text_to_ids("a longer target", None, 32),
                                 prompt_codes, max_new=8, top_k=1, generator=torch.Generator().manual_seed(1), **kw)
    return jcodes, jn, tcodes, tn


def test_synthesize_gives_the_jax_codes(models):
    jm, params, tm, _ = models
    stats = {}
    jcodes, jn, tcodes, tn = _synth_both(jm, params, tm, stats=stats)
    assert tn == jn > 0 and np.array_equal(tcodes, np.asarray(jcodes))
    assert stats["ar_steps"] == min(8, tn + 1) and stats["ar_s"] > 0 and stats["nar_s"] > 0


def test_checkpoints_pass_between_the_packages(models, tmp_path):
    """The port's ``model.msgpack`` read by the JAX pipeline's loader, and the
    JAX package's ``model.msgpack`` read by the port's: equal greedy codes."""
    from slam_llm_tpu.utils.checkpoint import load_trainable as j_load
    from slam_llm_tpu.utils.checkpoint import save_trainable as j_save
    from slam_llm_tpu_torch.utils.checkpoint import save_trainable, save_trainable_msgpack

    jm, params, tm, _ = models
    save_trainable_msgpack(str(tmp_path / "port" / "model.msgpack"), dict(tm.named_parameters()))
    jparams = jinf._unflatten(j_load(str(tmp_path / "port" / "model.msgpack")))
    assert jax.tree_util.tree_structure(jparams) == jax.tree_util.tree_structure(params)
    j_save(str(tmp_path / "jax" / "model.msgpack"), params)
    save_trainable(str(tmp_path / "pt" / "model.pt"), dict(tm.named_parameters()))
    want = np.asarray(_synth_both(jm, params, tm)[0])
    for d in ("jax", "pt"):  # the preset computes in bf16: compare in f32
        loaded = tinf.load_vallex(str(tmp_path / d), "vallex-tiny-test", "cpu")
        f32 = tv.VALLE(dataclasses.replace(loaded.cfg, dtype=torch.float32)).eval()
        f32.load_state_dict(loaded.state_dict())
        np.testing.assert_array_equal(_synth_both(jm, params, f32)[2], want)
    np.testing.assert_array_equal(np.asarray(_synth_both(jm, jparams, tm)[0]), want)
    save_trainable(str(tmp_path / "part" / "model.pt"), {"ar_head.weight": tm.ar_head.weight})
    with pytest.raises(KeyError, match="lacks"):
        tinf.load_vallex(str(tmp_path / "part"), "vallex-tiny-test", "cpu")


@pytest.mark.parametrize("phonemes,tokenizer,n_rows", [("str", None, 4), ("str", "byte", 4), ("ids", None, 1),
                                                       ("ids", None, 2)])
def test_dataset_items_batches_and_stages_match_jax(tmp_path, phonemes, tokenizer, n_rows):
    rng = np.random.default_rng(0)
    rows = []
    for i in range(6):
        t = int(rng.integers(5, 140))
        audio = rng.integers(0, 1024, (n_rows, t)).tolist() if n_rows > 1 else rng.integers(0, 1024, t).tolist()
        ph = "hello world é"[: 4 + i] if phonemes == "str" else rng.integers(0, 900, 10 + 9 * i).tolist()
        rows.append({"key": f"u{i}", "phonemes": ph, "audio_tokens": audio})
    path = tmp_path / "train.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    cfg = SimpleNamespace(train_data_path=str(path), val_data_path=str(path), code_layer=4, text_vocabsize=-1, seed=3,
                          train_split="train", text_buckets=[16, 32, 64], audio_token_buckets=[32, 64, 128])
    jds = jds_mod.VallexDatasetJsonl(cfg, JByteTokenizer() if tokenizer else None, "train")
    tds = tds_mod.VallexDatasetJsonl(cfg, ByteTokenizer() if tokenizer else None, "train")
    assert len(tds) == len(jds) == 6
    for i in range(6):
        a, b = tds[i], jds[i]
        assert a.keys() == b.keys() and a["key"] == b["key"] and tds.sort_key(i) == jds.sort_key(i)
        assert all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in ("text_ids", "audio_ids"))
    for rows_ in ((0, 1, 2), (3, 4, 5), (0, 5), (1, 2, 3, 4)):  # the stages come from one generator, in turn
        a, b = tds.collator([tds[i] for i in rows_]), jds.collator([jds[i] for i in rows_])
        assert a.keys() == b.keys() and a["keys"] == b["keys"]
        for k in ("text_ids", "text_mask", "audio_ids", "audio_mask", "nar_stage"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_seeded_init_and_a_codebook_count_that_does_not_fit():
    """``materialize_params`` draws VALLE's embeddings with std 0.02 (the
    reference's initializer; the generic rule gives 1) and the denses with
    std 1/sqrt(fan_in); a batch whose codebooks are not the model's raises
    with the setting to change (the recipe leaves ``code_layer`` at 3)."""
    from slam_llm_tpu_torch.config import RunConfig
    from slam_llm_tpu_torch.pipeline.common import materialize_params

    cfg = RunConfig()
    model = tv.VALLE(dataclasses.replace(tv.VallexConfig.tiny_test(), d_model=64, n_heads=4))
    materialize_params(model, cfg)
    for name in ("text_embedding", "audio_embedding_3", "nar_stage_embedding"):
        assert abs(float(getattr(model, name).weight.std()) - 0.02) < 0.004, name
    assert abs(float(model.ar_decoder.layers[0].fc1.weight.std()) - 64 ** -0.5) < 0.01
    batch = {k: torch.as_tensor(v) for k, v in _batch().items()}
    batch["audio_ids"] = batch["audio_ids"][:, :3]
    with pytest.raises(ValueError, match="code_layer=4"):
        model(batch)


def test_factory_registry_and_presets():
    from slam_llm_tpu_torch.config import RunConfig
    from slam_llm_tpu_torch.models.slam_model import model_factory
    from slam_llm_tpu_torch.registry import get_custom_dataset_factory

    cfg = RunConfig()
    cfg.dataset_config.dataset = "vallex_dataset"
    assert get_custom_dataset_factory(cfg.dataset_config) is tds_mod.get_vallex_dataset
    cfg.model_config.llm_name = "vallex-tiny-test"
    model, tok = model_factory(cfg.train_config, cfg.model_config, device="meta")
    assert isinstance(model, tv.VALLE) and model.cfg == tv.VallexConfig.tiny_test() and isinstance(tok, ByteTokenizer)
    cfg.model_config.llm_name = "vallex"
    assert model_factory(cfg.train_config, cfg.model_config, device="meta")[0].cfg == tv.VallexConfig.base_24l()
    assert (tv.VallexConfig.base_24l().d_model, tv.VallexConfig.base_24l().ar_layers) == (1024, 24)
    cfg.model_config.llm_name = "vallex-huge"
    with pytest.raises(ValueError, match="unknown vallex preset"):
        model_factory(cfg.train_config, cfg.model_config, device="meta")


# ---------------------------------------------------------------------------
# EnCodec
# ---------------------------------------------------------------------------


def test_encodec_decode_matches_jax_from_converted_params_and_one_state_dict(tmp_path):
    from slam_llm_tpu_torch.tools.synth_checkpoint import encodec_state_dict, write_encodec

    jcfg, tcfg = jenc.EncodecConfig.tiny_test(), tenc.EncodecConfig.tiny_test()
    codes = np.random.default_rng(1).integers(0, 32, (2, 3, 9))
    params = jenc.init_encodec_params(np.random.default_rng(0), jcfg)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, params, tenc.init_encodec_params(np.random.default_rng(0), tcfg)))
    for t in (1, 2, 9):  # shorter than the causal pads, and longer
        want = jenc.encodec_decode(params, codes[:, :, :t], jcfg)
        got = tenc.encodec_decode(to_device(params, "cpu"), codes[:, :, :t], tcfg)
        assert got.shape == want.shape == (2, t * tcfg.frame_stride)
        np.testing.assert_allclose(got, want, atol=1e-5 * float(np.abs(want).max()))
    sd = encodec_state_dict(tcfg, seed=2)
    want = jenc.encodec_decode(jenc.convert_encodec_torch_state(sd, jcfg), codes, jcfg)
    got = tenc.encodec_decode(to_device(tenc.convert_encodec_torch_state(sd, tcfg), "cpu"), codes, tcfg)
    np.testing.assert_allclose(got, want, atol=1e-5 * float(np.abs(want).max()))
    write_encodec(str(tmp_path / "enc"), tcfg, seed=2)
    for path in (tmp_path / "enc" / "model.safetensors",):
        loaded = tenc.load_encodec_checkpoint(str(path), tcfg)
        np.testing.assert_allclose(tenc.encodec_decode(to_device(loaded, "cpu"), codes, tcfg), got, atol=0)
        jl = jenc.load_encodec_checkpoint(str(path), jcfg)
        np.testing.assert_allclose(jenc.encodec_decode(jl, codes, jcfg), want, atol=1e-7)
    # the converted form as msgpack, both ways; strides and pads stay ints
    tenc.save_encodec_params(str(tmp_path / "t.msgpack"), tenc.convert_encodec_torch_state(sd, tcfg))
    jenc.save_encodec_params(str(tmp_path / "j.msgpack"), jenc.convert_encodec_torch_state(sd, jcfg))
    np.testing.assert_allclose(jenc.encodec_decode(jenc.load_encodec_checkpoint(str(tmp_path / "t.msgpack"), jcfg),
                                                   codes, jcfg), want, atol=0)
    back = tenc.load_encodec_checkpoint(str(tmp_path / "j.msgpack"), tcfg)
    assert type(back["decoder"]["blocks"][0]["stride"]) is int and type(back["decoder"]["in_pad"]) is int
    np.testing.assert_allclose(tenc.encodec_decode(to_device(back, "cpu"), codes, tcfg), got, atol=0)


def test_encodec_24khz_widths(tmp_path):
    from slam_llm_tpu_torch.tools.synth_checkpoint import encodec_state_dict

    cfg = tenc.EncodecConfig.encodec_24khz()
    sd = encodec_state_dict(dataclasses.replace(cfg, num_quantizers=2))
    params = tenc.convert_encodec_torch_state(sd, cfg)
    assert params["codebooks"].shape == (2, 1024, 128) and params["decoder"]["in_conv_w"].shape == (512, 128, 7)
    assert [b["up_w"].shape for b in params["decoder"]["blocks"]] == [(256, 512, 16), (128, 256, 10), (64, 128, 8),
                                                                      (32, 64, 4)]
    wav = tenc.encodec_decode(to_device(params, "cpu"), np.zeros((1, 2, 3), np.int64), cfg)
    assert wav.shape == (1, 3 * 320) and cfg.frame_stride == 320 and np.isfinite(wav).all()


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


class _Recording:
    def __init__(self):
        self.step, self.device = 0, torch.device("cpu")

    def put_batch(self, batch):
        return batch

    def train_step(self, batch):
        return {"loss": torch.tensor(1.0)}


def test_the_loop_logs_a_batch_without_input_ids():
    """A VALL-E X batch (text / audio ids and masks, no ``input_ids``)
    through a logged step: the shape is the first array's, the tokens the
    two masks'."""
    from slam_llm_tpu_torch.train.loop import train

    batch = {k: v for k, v in _batch().items()}
    batch["keys"] = ["a", "b", "c"]
    tc = SimpleNamespace(num_epochs=1, max_steps_per_epoch=0, log_interval=1, run_validation=False, save_model=False,
                         validation_interval=10**6)
    res = train(_Recording(), [batch, batch], train_config=tc)
    assert [s["shape"] for s in res["steps"]] == [(B, TT)] * 2
    assert res["steps"][0]["tokens"] == int(batch["text_mask"].sum() + batch["audio_mask"].sum()) == 16 + 29


def test_finetune_then_inference_writes_a_wav(tmp_path):
    from slam_llm_tpu_torch.config import load_run_config
    from slam_llm_tpu_torch.pipeline import finetune
    from slam_llm_tpu_torch.tools.synth_checkpoint import write_encodec, write_vallex_corpus

    corpus = write_vallex_corpus(str(tmp_path / "train.jsonl"), 8, frames=(6, 12), text_len=(4, 9), n_codebooks=4,
                                 audio_vocab=16, text_vocab=32)
    cfg = load_run_config([
        "--config", "examples/vallex/conf/vallex_tts.yaml", "++model_config.llm_name=vallex-tiny-test",
        f"++dataset_config.train_data_path={corpus}", f"++dataset_config.val_data_path={corpus}",
        "++dataset_config.code_layer=4", "++dataset_config.text_vocabsize=32",
        "++dataset_config.text_buckets=[16]", "++dataset_config.audio_token_buckets=[16]",
        "++train_config.batch_size_training=4", "++train_config.val_batch_size=4", "++train_config.lr=1e-3",
        "++train_config.warmup_steps=1", "++train_config.num_epochs=2", "++train_config.log_interval=1",
        f"++train_config.output_dir={tmp_path / 'out'}",
    ])
    res = finetune.main(cfg, device="cpu")
    trainer = res["trainer"]
    assert len(res["steps"]) == 4 and all(np.isfinite(s["loss"]) for s in res["steps"])
    assert {s["shape"] for s in res["steps"]} == {(4, 16)} and res["checkpoints"]
    assert set(trainer.trainable) == {n for n, _ in trainer.model.named_parameters()} and not trainer.frozen
    assert all(p.dtype == torch.float32 for p in trainer.trainable.values())
    write_encodec(str(tmp_path / "enc"), tenc.EncodecConfig.tiny_test(), seed=1)
    np.save(tmp_path / "prompt.npy", np.random.default_rng(2).integers(0, 16, (4, 6)))
    out = tinf.main(["--ckpt_path", res["checkpoints"][-1], "--llm_name", "vallex-tiny-test",
                     "--codec_path", str(tmp_path / "enc" / "model.safetensors"), "--prompt_text", "hello",
                     "--prompt_codes", str(tmp_path / "prompt.npy"), "--target_text", "hello world",
                     "--save_path", str(tmp_path / "tts.wav"), "--max_new", "24", "--top_k", "8", "--device", "cpu"])
    with wave.open(str(tmp_path / "tts.wav"), "rb") as f:
        pcm = np.frombuffer(f.readframes(f.getnframes()), np.int16)
        assert f.getframerate() == 24000
    assert pcm.size == out["samples"] == out["frames"] * 8 > 0 and np.abs(pcm).max() > 0
