"""The weights slice end to end on the CPU, against the JAX package.

Tiny random HF directories, written by ``transformers``' ``save_pretrained``
at the tiny-test widths: a Llama (with the Llama-layout ``tokenizer.json``
that ``test_torch_tokenizer.py`` builds with ``tokenizers``) and a whisper
model. Both packages run in f32 (their ``build_slam_config`` is wrapped to
set the compute dtype; neither package's files change), with the recipe's
int8 base and LoRA on q / v:

* the port's ``pipeline.finetune`` trains 2 steps from the HF directories
  and writes ``model.pt``;
* the port's ``pipeline.inference_batch`` decodes with ``ckpt_path`` set to
  that checkpoint directory, and JAX's with the same HF directories and the
  port's ``model.msgpack`` of the same tensors: the decoded text is
  identical, greedy and beam 4;
* the port's ``compute_wer_files`` scores the logs as JAX's does;
* the port's ``pipeline.inference`` REPL, fed one wav line, prints what
  JAX's REPL prints;
* the trainer derives the int8 backward buffers and the int8 CE head from
  the loaded weights;
* the port's ``wer`` / ``textnorm`` against JAX's on ``test_wer.py``'s cases
  and seeded random word lists.
"""

import dataclasses
import io
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_corpus, tiny_run_config
from test_torch_tokenizer import build_llama_tokenizer

from slam_llm_tpu.models import slam_model as jslam
from slam_llm_tpu.utils import textnorm as jtextnorm
from slam_llm_tpu.utils import wer as jwer
from slam_llm_tpu_torch.config import RunConfig, set_by_path
from slam_llm_tpu_torch.models import slam_model as tslam
from slam_llm_tpu_torch.utils import textnorm as ttextnorm
from slam_llm_tpu_torch.utils import wer as twer

OVERRIDES = {
    "train_config.use_peft": True, "train_config.freeze_llm": True, "train_config.freeze_encoder": True,
    "train_config.shard.base_quant": "int8", "train_config.peft_config.r": 4, "decode_config.max_new_tokens": 6,
}


def _f32(build, dtype):
    def wrapped(train_config, model_config):
        sc = build(train_config, model_config)
        return dataclasses.replace(
            sc, llm=dataclasses.replace(sc.llm, dtype=dtype), encoder=dataclasses.replace(sc.encoder, dtype=dtype),
            projector_cfg=dataclasses.replace(sc.projector_cfg, dtype=dtype))
    return wrapped


def _port_cfg(manifest, **overrides):
    cfg = RunConfig()
    for key, value in {"model_config.llm_name": "tiny-test", "model_config.encoder_name": "whisper",
                       "model_config.encoder_config": "whisper-tiny-test", "model_config.encoder_projector": "linear",
                       "model_config.encoder_projector_ds_rate": 5, "dataset_config.train_data_path": str(manifest),
                       "dataset_config.val_data_path": str(manifest), "dataset_config.mel_size": 8,
                       "dataset_config.input_type": "mel", "train_config.batch_size_training": 2,
                       "train_config.val_batch_size": 2, "train_config.warmup_steps": 2,
                       "train_config.total_steps": 20, "train_config.shard.dp": -1, **overrides}.items():
        set_by_path(cfg, key, value)
    return cfg


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """HF directories, a corpus, and the port's 2-step finetune from them."""
    from transformers import LlamaConfig, LlamaForCausalLM, WhisperConfig, WhisperModel

    from slam_llm_tpu_torch.pipeline import finetune
    from slam_llm_tpu_torch.utils.checkpoint import load_trainable, save_trainable_msgpack

    tmp = tmp_path_factory.mktemp("weights_pipeline")
    vocab = build_llama_tokenizer(tmp / "llm")
    torch.manual_seed(0)
    LlamaForCausalLM(LlamaConfig(
        vocab_size=vocab, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, rms_norm_eps=1e-5, rope_theta=10000.0, max_position_embeddings=256,
        initializer_range=0.2, tie_word_embeddings=False)).save_pretrained(tmp / "llm", safe_serialization=True)
    WhisperModel(WhisperConfig(
        vocab_size=64, num_mel_bins=8, d_model=32, encoder_layers=2, encoder_attention_heads=2,
        encoder_ffn_dim=128, decoder_layers=1, decoder_attention_heads=2, decoder_ffn_dim=64,
        max_source_positions=64, pad_token_id=0, bos_token_id=1, eos_token_id=2, decoder_start_token_id=1,
        suppress_tokens=None, begin_suppress_tokens=None)).save_pretrained(tmp / "whisper", safe_serialization=True)
    manifest = make_corpus(tmp, n=4)
    paths = {"model_config.llm_path": str(tmp / "llm"), "model_config.encoder_path": str(tmp / "whisper")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tslam, "build_slam_config", _f32(tslam.build_slam_config, torch.float32))
        res = finetune.main(_port_cfg(manifest, **OVERRIDES, **paths, **{
            "train_config.max_steps_per_epoch": 2, "train_config.output_dir": str(tmp / "out"),
            "train_config.lr": 1e-2, "train_config.warmup_steps": 1, "train_config.log_interval": 1}), device="cpu")
    ckpt = res["checkpoints"][-1]
    save_trainable_msgpack(str(tmp / "model.msgpack"), load_trainable(ckpt))
    return {"tmp": tmp, "manifest": manifest, "paths": paths, "ckpt": ckpt, "result": res}


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(tslam, "build_slam_config", _f32(tslam.build_slam_config, torch.float32))
    monkeypatch.setattr(jslam, "build_slam_config", _f32(jslam.build_slam_config, jnp.float32))


def test_finetune_from_hf_dirs_loads_trains_and_saves(run):
    from safetensors.torch import load_file

    res = run["result"]
    assert len(res["steps"]) == 2 and all(np.isfinite(s["loss"]) for s in res["steps"])
    model = res["trainer"].model
    hf = load_file(str(run["tmp"] / "llm" / "model.safetensors"))
    # the trainer stores the frozen f32 tensors in frozen_dtype (bf16)
    assert torch.equal(model.llm.embed_tokens.weight, hf["model.embed_tokens.weight"].bfloat16())
    assert torch.equal(model.llm.layers[1].post_attn_norm.scale,
                       hf["model.layers.1.post_attention_layernorm.weight"].bfloat16())
    saved = torch.load(f"{run['ckpt']}/model.pt", weights_only=True)
    assert {n for n in saved if "lora_b" in n} and all(saved[n].abs().max() > 0 for n in saved if "lora_b" in n)


@pytest.mark.parametrize("num_beams", [1, 4])
def test_decoded_text_matches_jax(run, f32, num_beams):
    from slam_llm_tpu.pipeline import inference_batch as jinference_batch
    from slam_llm_tpu_torch.pipeline import inference_batch

    tmp, decode = run["tmp"], {"decode_config.num_beams": num_beams}
    ours = inference_batch.main(_port_cfg(run["manifest"], **OVERRIDES, **run["paths"], **decode, **{
        "ckpt_path": run["ckpt"], "decode_config.decode_log": str(tmp / f"port{num_beams}")}), device="cpu")
    theirs = jinference_batch.main(tiny_run_config(run["manifest"], **OVERRIDES, **run["paths"], **decode, **{
        "ckpt_path": str(tmp / "model.msgpack"), "decode_config.decode_log": str(tmp / f"jax{num_beams}")}))
    pred = open(ours["pred"], encoding="utf-8").read()
    assert ours["n"] == theirs["n"] == 4
    assert pred == open(theirs["pred"], encoding="utf-8").read()
    assert open(ours["gt"]).read() == open(theirs["gt"]).read()
    assert any(line.split("\t", 1)[1] for line in pred.splitlines())  # something was decoded

    res = twer.compute_wer_files(ours["gt"], ours["pred"], str(tmp / f"port{num_beams}_detail"))
    ref = jwer.compute_wer_files(theirs["gt"], theirs["pred"], str(tmp / f"jax{num_beams}_detail"))
    assert vars(res) == vars(ref) and res.summary() == ref.summary()
    assert res.words == res.subs + res.dels + sum(
        c["cor"] for c in (twer.align(h.split()[1:], r.split()[1:])[0]
                           for r, h in zip(open(ours["gt"]).read().splitlines(), pred.splitlines())))
    assert open(tmp / f"port{num_beams}_detail").read() == open(tmp / f"jax{num_beams}_detail").read()


def test_repl_prints_what_jax_prints(run, f32, monkeypatch, capsys):
    from slam_llm_tpu.pipeline import inference as jinference
    from slam_llm_tpu_torch.pipeline import inference

    line = f"{run['tmp'] / 'utt1.wav'}\n\n"
    out = io.StringIO()
    texts = inference.main(_port_cfg(run["manifest"], **OVERRIDES, **run["paths"], ckpt_path=run["ckpt"]),
                           device="cpu", lines=io.StringIO(line), out=out)
    monkeypatch.setattr(sys, "stdin", io.StringIO(line))
    capsys.readouterr()
    jinference.main(tiny_run_config(run["manifest"], **OVERRIDES, **run["paths"],
                                    ckpt_path=str(run["tmp"] / "model.msgpack")))
    assert len(texts) == 1 and out.getvalue() == capsys.readouterr().out


def test_trainer_derives_int8_buffers_from_the_loaded_weights(run):
    from safetensors.torch import load_file

    from slam_llm_tpu_torch.ops.quant import quantize_int8, rotated_pair
    from slam_llm_tpu_torch.pipeline.common import materialize_params
    from slam_llm_tpu_torch.train.state import Trainer

    cfg = _port_cfg(run["manifest"], **OVERRIDES, **run["paths"], **{
        "train_config.shard.base_quant_bwd": "int8_rot", "train_config.shard.ce_quant": "int8"})
    model, _ = tslam.model_factory(cfg.train_config, cfg.model_config, device="cpu")
    materialize_params(model, cfg)
    Trainer(model, model.cfg, cfg.train_config).state_from_params()
    hf = load_file(str(run["tmp"] / "llm" / "model.safetensors"))
    for i, layer in enumerate(model.llm.layers):
        for name in ("q_proj", "down_proj"):
            mod = getattr(layer.attn if name == "q_proj" else layer.mlp, name)
            q, s = quantize_int8(hf[f"model.layers.{i}.{'self_attn' if name == 'q_proj' else 'mlp'}.{name}.weight"],
                                 contract_axis=-1)
            assert torch.equal(mod.kernel_q, q) and torch.equal(mod.kernel_scale, s)
            qr, sr = rotated_pair(q, s)
            assert torch.equal(mod.kernel_qr, qr) and torch.equal(mod.kernel_scale_r, sr)
            assert mod.kernel_qr.abs().sum() > 0
    q, s = quantize_int8(hf["lm_head.weight"].to(torch.bfloat16), contract_axis=-1)
    assert torch.equal(model.llm.head_q, q) and torch.equal(model.llm.head_scale, s)


def test_missing_checkpoint_paths_raise(run, tmp_path):
    from slam_llm_tpu_torch.pipeline import inference_batch

    for key in ("model_config.llm_path", "model_config.encoder_path", "ckpt_path"):
        cfg = _port_cfg(run["manifest"], **OVERRIDES, **{**run["paths"], key: str(tmp_path / "missing"),
                                                         "decode_config.decode_log": str(tmp_path / "d")})
        with pytest.raises(FileNotFoundError, match="missing"):
            inference_batch.main(cfg, device="cpu")


WER_CASES = [
    (["the cat sat", "hello world"], ["the cat sat", "hello word"]), (["a b"], ["a b"]),
    (["the quick brown fox", "hello there"], ["the quik brown fox", "hello there"]),
    (["a b c d"], ["a x c"]), ([""], ["extra words"]), (["only ref"], [""]),
]
NORM_CASES = [
    "Hello, World!", "it's Mr. Smith's dog", "[noise] the cat (laughs) sat", "I won't go", "twenty five dollars",
    "one hundred and two", "three thousand four hundred", "one day", "hahahahahahahaha", "nineteen ninety nine",
    "agent zero zero seven", "rooms one and two", "seventeen seventy six", "five hundred sixty", "It costs 5.",
    "3.14 is pi", "won’t go", "$5", "$25.50 please", "That is fine.", "the cat " * 10,
]


def test_wer_and_textnorm_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    words = "the a cat sat on mat dog ran hello world quick brown fox".split()
    cases = WER_CASES + [([" ".join(rng.choice(words, rng.integers(0, 12))) for _ in range(8)],
                          [" ".join(rng.choice(words, rng.integers(0, 12))) for _ in range(8)]) for _ in range(20)]
    for refs, hyps in cases:
        assert vars(twer.compute_wer_lists(refs, hyps)) == vars(jwer.compute_wer_lists(refs, hyps))
        for r, h in zip(refs, hyps):
            assert twer.align(h.split(), r.split()) == jwer.align(h.split(), r.split())
    (tmp_path / "gt").write_text("".join(f"utt{i}\t{r}\n" for i, r in enumerate(cases[-1][0])) + "extra\tx\n")
    (tmp_path / "pred").write_text("".join(f"utt{i}\t{h}\n" for i, h in enumerate(cases[-1][1][:-1])))
    ours = twer.compute_wer_files(str(tmp_path / "gt"), str(tmp_path / "pred"), str(tmp_path / "d_port"))
    theirs = jwer.compute_wer_files(str(tmp_path / "gt"), str(tmp_path / "pred"), str(tmp_path / "d_jax"))
    assert vars(ours) == vars(theirs) and (tmp_path / "d_port").read_text() == (tmp_path / "d_jax").read_text()

    tn, jn = ttextnorm.EnglishTextNormalizer(), jtextnorm.EnglishTextNormalizer()
    for s in NORM_CASES:
        assert tn(s) == jn(s), s
        assert ttextnorm.reduce_repeated_words(s) == jtextnorm.reduce_repeated_words(s)
        assert ttextnorm.basic_normalize(s) == jtextnorm.basic_normalize(s)
    (tmp_path / "raw").write_text("".join(f"utt{i} {s}\n" for i, s in enumerate(NORM_CASES)))
    for squash in (False, True):
        ttextnorm.normalize_file(str(tmp_path / "raw"), str(tmp_path / "t"), squash_repeats=squash)
        jtextnorm.normalize_file(str(tmp_path / "raw"), str(tmp_path / "j"), squash_repeats=squash)
        assert (tmp_path / "t").read_text() == (tmp_path / "j").read_text()
