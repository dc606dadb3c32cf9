"""The ported batch-decode slice against the JAX package, end to end on the CPU.

One set of weights (the JAX tiny flagship sandwich: whisper-tiny-test encoder,
linear projector, tiny LoRA LLM with an int8 base, LoRA B made nonzero) goes
into both packages through ``utils.convert.from_flax_params``. In f32 the
prefill logits agree within 1e-4 relative and greedy and beam-4 tokens are
identical; in bf16 the prefill logits keep a cosine of at least 0.99.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from __graft_entry__ import _flagship_cfg
from slam_llm_tpu.inference.generate import GenerationConfig as JGenerationConfig
from slam_llm_tpu.inference.generate import Generator as JGenerator
from slam_llm_tpu.models.llm import init_kv_cache as j_init_kv_cache
from slam_llm_tpu.models.slam_model import SLAMModel as JSLAMModel
from slam_llm_tpu_torch.inference.generate import GenerationConfig, Generator
from slam_llm_tpu_torch.models import llm as tllm
from slam_llm_tpu_torch.models import projector as tproj
from slam_llm_tpu_torch.models import slam_model as tslam
from slam_llm_tpu_torch.models import whisper as twhisper
from slam_llm_tpu_torch.utils.convert import from_flax_params

REPO = Path(__file__).resolve().parent.parent
EOS, PAD = 2, 0


def _jax_cfg(dtype):
    cfg = _flagship_cfg(tiny=True)
    # the recipe's int8 base with its int8_rot backward (whose extra weight
    # copy the converter drops)
    llm = dataclasses.replace(cfg.llm, dtype=dtype, base_quant="int8", base_quant_bwd="int8_rot")
    return dataclasses.replace(
        cfg, llm=llm, encoder=dataclasses.replace(cfg.encoder, dtype=dtype),
        projector_cfg=dataclasses.replace(cfg.projector_cfg, dtype=dtype),
    )


def _port_cfg(jcfg, dtype):
    def conv(cls, obj):
        names = {f.name for f in dataclasses.fields(cls)} - {"dtype", "param_dtype"}
        return cls(**{n: getattr(obj, n) for n in names if hasattr(obj, n)}, dtype=dtype)

    return tslam.SLAMConfig(
        llm=conv(tllm.LLMConfig, jcfg.llm), encoder_name="whisper",
        encoder=conv(twhisper.WhisperEncoderConfig, jcfg.encoder), projector="linear",
        projector_cfg=conv(tproj.ProjectorConfig, jcfg.projector_cfg),
    )


def _batch():
    """Two rows: row 0 left-padded by 3; 12 audio pseudo-tokens (-1) then text."""
    rng = np.random.default_rng(0)
    b, t, n_audio = 2, 24, 12
    ids = rng.integers(3, 250, (b, t)).astype(np.int64)
    attn = np.ones((b, t), np.int32)
    modality = np.zeros((b, t), np.int32)
    attn[0, :3] = 0
    ids[0, :3] = PAD
    for row, start in ((0, 3), (1, 0)):
        ids[row, start : start + n_audio] = -1
        modality[row, start : start + n_audio] = 1
    mel_mask = np.ones((b, 128), np.int32)
    mel_mask[1, 100:] = 0
    return {
        "input_ids": ids, "attention_mask": attn, "modality_mask": modality,
        "audio_mel": rng.standard_normal((b, 128, 8)).astype(np.float32), "audio_mel_mask": mel_mask,
    }


def _nonzero_lora(params, seed=1):
    rng = np.random.default_rng(seed)

    def walk(node):
        return {
            k: walk(v) if isinstance(v, dict)
            else (rng.standard_normal(np.shape(v)) * 0.3).astype(np.float32) if k == "lora_b"
            else np.asarray(v)
            for k, v in node.items()
        }

    return walk(params)


@pytest.fixture(scope="module")
def jax_params():
    jcfg = _jax_cfg(jnp.float32)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    variables = JSLAMModel(jcfg).init(jax.random.PRNGKey(0), batch, method="init_all")
    return _nonzero_lora(nn.meta.unbox(variables["params"]))


def _pair(jax_params, jdtype, tdtype):
    jcfg = _jax_cfg(jdtype)
    tcfg = _port_cfg(jcfg, tdtype)
    tm = tslam.SLAMModel(tcfg).eval()
    tm.load_state_dict(from_flax_params(jax_params, tcfg))
    return JSLAMModel(jcfg), {"params": jax_params}, tm


def _prefill_logits(jm, jp, tm):
    batch = _batch()
    b, t = batch["input_ids"].shape
    jcache = j_init_kv_cache(jm.cfg.llm, b, t + 4, gen_start=t)
    jlogits, _ = jm.apply(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcache, method="prefill")
    tcache = tllm.init_kv_cache(tm.cfg.llm, b, t + 4, gen_start=t)
    with torch.inference_mode():
        tlogits, _ = tm.prefill({k: torch.from_numpy(v) for k, v in batch.items()}, tcache)
    return np.asarray(jlogits, np.float32), tlogits.float().numpy(), batch["attention_mask"].astype(bool)


def test_slice_prefill_logits_fp32(jax_params):
    jlogits, tlogits, _ = _prefill_logits(*_pair(jax_params, jnp.float32, torch.float32))
    err = np.abs(tlogits - jlogits).max() / np.abs(jlogits).max()
    assert err <= 1e-4, err


def test_slice_prefill_logits_bf16_cosine(jax_params):
    jlogits, tlogits, live = _prefill_logits(*_pair(jax_params, jnp.bfloat16, torch.bfloat16))
    j, t = jlogits[live], tlogits[live]
    cos = (j * t).sum(-1) / (np.linalg.norm(j, axis=-1) * np.linalg.norm(t, axis=-1))
    assert cos.min() >= 0.99, cos.min()


@pytest.mark.parametrize(
    "num_beams,repetition_penalty,length_penalty",
    [(1, 1.0, 1.0), (1, 1.3, 1.0), (4, 1.0, 1.0), (4, 1.2, 0.8)],
)
def test_slice_tokens_identical_to_jax(jax_params, num_beams, repetition_penalty, length_penalty):
    """f32 greedy and beam-4 decode: token-identical to the JAX Generator."""
    jm, jp, tm = _pair(jax_params, jnp.float32, torch.float32)
    kw = dict(max_new_tokens=10, num_beams=num_beams, repetition_penalty=repetition_penalty,
              length_penalty=length_penalty, eos_token_id=EOS, pad_token_id=PAD)
    batch = _batch()
    want = JGenerator(jm, JGenerationConfig(**kw)).generate(jp, batch)
    got = Generator(tm, GenerationConfig(**kw)).generate(batch)
    assert got.shape == want.shape == (2, 10)
    np.testing.assert_array_equal(got, want)


def test_sampling_masks_and_penalty_match_jax():
    from slam_llm_tpu.inference import generate as jgen
    from slam_llm_tpu_torch.inference import generate as tgen

    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 50)).astype(np.float32) * 3
    counts = rng.integers(0, 2, (3, 50)).astype(np.int32)
    for want, got in (
        (jgen._mask_top_k(jnp.asarray(logits), 7), tgen._mask_top_k(torch.from_numpy(logits), 7)),
        (jgen._mask_top_p(jnp.asarray(logits), 0.8), tgen._mask_top_p(torch.from_numpy(logits), 0.8)),
        (jgen._apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(counts), 1.3),
         tgen._apply_repetition_penalty(torch.from_numpy(logits), torch.from_numpy(counts), 1.3)),
    ):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampling_decode_is_seeded_and_stays_in_top_k(jax_params):
    _, _, tm = _pair(jax_params, jnp.float32, torch.float32)
    gen = Generator(tm, GenerationConfig(max_new_tokens=6, num_beams=1, do_sample=True, top_k=3,
                                         temperature=0.7, eos_token_id=EOS, pad_token_id=PAD))
    a = gen.generate(_batch(), generator=torch.Generator().manual_seed(5))
    b = gen.generate(_batch(), generator=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(a, b)
    # the first token comes from the prefill logits: it is one of their top 3
    jm, jp, _ = _pair(jax_params, jnp.float32, torch.float32)
    _, tlogits, _ = _prefill_logits(jm, jp, tm)
    top3 = np.argsort(-tlogits[:, -1], axis=-1)[:, :3]
    assert all(a[i, 0] in top3[i] for i in range(2))


def test_from_flax_params_checks_layer_count(jax_params):
    tcfg = _port_cfg(_jax_cfg(jnp.float32), torch.float32)
    bad = dataclasses.replace(tcfg, llm=dataclasses.replace(tcfg.llm, n_layers=3))
    with pytest.raises(ValueError, match="decoder layers"):
        from_flax_params(jax_params, bad)


# ---- pipeline ----------------------------------------------------------------


def _tiny_cfg(tmp_path, n=4):
    from helpers import make_corpus, tiny_run_config

    manifest = make_corpus(tmp_path, n=n)
    return tiny_run_config(manifest, **{
        "decode_config.decode_log": str(tmp_path / "decode"),
        "decode_config.max_new_tokens": 6,
        "train_config.use_peft": True,
        "train_config.shard.base_quant": "int8",
    })


def test_inference_batch_cpu_writes_decode_logs(tmp_path):
    from slam_llm_tpu_torch.pipeline import inference_batch

    res = inference_batch.main(_tiny_cfg(tmp_path), device="cpu")
    preds = Path(res["pred"]).read_text().splitlines()
    gts = Path(res["gt"]).read_text().splitlines()
    assert res["n"] == 4 and len(preds) == len(gts) == 4
    assert [p.split("\t")[0] for p in preds] == [g.split("\t")[0] for g in gts]
    assert gts[0].split("\t")[1].startswith("hello world")
    assert res["decode_steps"] > 0 and res["prefill_s"] > 0


def test_cli_refuses_cuda_without_a_gpu():
    from slam_llm_tpu_torch.pipeline import inference_batch

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        inference_batch.main_cli(["--device", "cuda"])


def test_unported_parts_raise(tmp_path):
    from slam_llm_tpu_torch.pipeline.common import materialize_params

    cfg = _tiny_cfg(tmp_path, n=2)
    with pytest.raises(ValueError, match="unknown encoder"):  # as the JAX package
        tslam.build_slam_config(cfg.train_config, dataclasses.replace(cfg.model_config, encoder_name="vallex"))
    # the q-former and conv1d projectors are ported: they build
    for kind, cls in (("q-former", tproj.ProjectorQFormer), ("cov1d-linear", tproj.ProjectorConv1d)):
        sc = tslam.build_slam_config(cfg.train_config, dataclasses.replace(cfg.model_config, encoder_projector=kind))
        assert isinstance(tslam.SLAMModel(sc).encoder_projector, cls)
    # the training modes ported since build their model, with the buffers
    # their backward reads; an undefined mode or a TPU-only knob raises
    for key, val, buffer in (("base_quant_bwd", "int8_sr", "kernel_qt"), ("base_quant_bwd", "int8_rot_otf", None),
                             ("ce_quant", "int8_sr", "head_qt")):
        tc = dataclasses.replace(cfg.train_config, shard=dataclasses.replace(cfg.train_config.shard, **{key: val}))
        sc = tslam.build_slam_config(tc, cfg.model_config)
        assert getattr(sc.llm, key) == val
        names = {n.rsplit(".", 1)[-1] for n, _ in tslam.SLAMModel(sc).named_buffers()}
        assert (buffer in names) if buffer else not names & {"kernel_qr", "kernel_qt", "head_qt"}
    tc = dataclasses.replace(cfg.train_config, shard=dataclasses.replace(cfg.train_config.shard, base_quant_bwd="int4"))
    with pytest.raises(ValueError, match="base_quant_bwd"):
        tslam.build_slam_config(tc, cfg.model_config)
    # bwd_pretranspose: a plain base keeps kernel_t buffers, the int8 base
    # refuses it as the JAX package's dense does
    for base_quant in ("none", "int8"):
        tc = dataclasses.replace(cfg.train_config, shard=dataclasses.replace(
            cfg.train_config.shard, bwd_pretranspose=True, base_quant=base_quant))
        sc = tslam.build_slam_config(tc, cfg.model_config)
        assert sc.llm.bwd_pretranspose
        if base_quant == "int8":
            with pytest.raises(ValueError, match="exclusive"):
                tslam.SLAMModel(sc)
        else:
            names = {n.rsplit(".", 1)[-1] for n, _ in tslam.SLAMModel(sc).named_buffers()}
            assert "kernel_t" in names
    tslam.build_slam_config(dataclasses.replace(cfg.train_config, frozen_dtype="float32"), cfg.model_config)
    from slam_llm_tpu_torch.ops.kernels.rowquant import rowquant

    q, s = rowquant(torch.ones(2, 8), fold=torch.full((8,), 2.0))
    assert torch.equal(q, torch.full((2, 8), 127, dtype=torch.int8)) and torch.allclose(s, torch.full((2, 1), 2 / 127))
    with pytest.raises(ValueError, match="mutually exclusive"):
        rowquant(torch.ones(2, 8), fold=torch.ones(8), rotate=True)
    # ckpt_path: a missing checkpoint raises, an existing one loads
    from slam_llm_tpu_torch.utils.checkpoint import save_trainable

    model, _ = tslam.model_factory(cfg.train_config, cfg.model_config)
    cfg.ckpt_path = str(tmp_path / "ckpt")
    with pytest.raises(FileNotFoundError, match="ckpt"):
        materialize_params(model, cfg)
    trained = {n: torch.full_like(p, 0.5) for n, p in model.named_parameters() if "encoder_projector" in n}
    save_trainable(str(tmp_path / "ckpt" / "model.pt"), trained)
    materialize_params(model, cfg)
    params = dict(model.named_parameters())
    assert trained and all(torch.equal(params[n], t) for n, t in trained.items())


_PROBE = r"""
import json, sys, tempfile, pkgutil, importlib
from pathlib import Path
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/tests"]
import slam_llm_tpu_torch
from helpers import make_corpus
from slam_llm_tpu_torch.config import RunConfig, set_by_path


def tiny_run_config(manifest, **overrides):
    # tests/helpers.py's tiny config, built with the port's own config module
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


from slam_llm_tpu_torch.pipeline import inference_batch
tmp = Path(tempfile.mkdtemp())
cfg = tiny_run_config(make_corpus(tmp, n=2), **{"decode_config.decode_log": str(tmp / "d"),
    "decode_config.max_new_tokens": 3, "train_config.shard.base_quant": "int8"})
res = inference_batch.main(cfg, device="cpu")
from slam_llm_tpu_torch.pipeline import finetune
train = finetune.main(tiny_run_config(make_corpus(tmp, n=2), **{
    "train_config.use_peft": True, "train_config.freeze_encoder": True, "train_config.freeze_llm": True,
    "train_config.shard.base_quant": "int8", "train_config.shard.base_quant_bwd": "int8_rot",
    "train_config.max_steps_per_epoch": 1, "train_config.log_interval": 1,
    "train_config.output_dir": str(tmp / "out")}), device="cpu")
# the ST recipe's pieces: a qwen2-layout ByteLevel tokenizer, a Q-Former
# model's forward and backward, BLEU over the decode logs
from slam_llm_tpu_torch.tools.synth_checkpoint import write_qwen2_tokenizer
from slam_llm_tpu_torch.data.tokenizer import load_tokenizer
from slam_llm_tpu_torch.tools import eval_werbleu
write_qwen2_tokenizer(str(tmp / "qwen2"), 400, corpus=["Übersetze die Sprache ins Deutsche."])
tok = load_tokenizer(str(tmp / "qwen2"))
assert tok.decode(tok.encode("Grüße 👋 <|im_end|>"), skip_special_tokens=False) == "Grüße 👋 <|im_end|>"
st = finetune.main(tiny_run_config(make_corpus(tmp, n=2), **{
    "model_config.encoder_projector": "q-former", "model_config.query_len": 4, "model_config.qformer_layers": 1,
    "model_config.qformer_dim": 32, "model_config.qformer_heads": 2, "dataset_config.fix_length_audio": 4,
    "train_config.max_steps_per_epoch": 1, "train_config.log_interval": 1, "train_config.run_validation": False,
    "train_config.output_dir": str(tmp / "st")}), device="cpu")
bleu = eval_werbleu.main(["--pred", res["pred"], "--gt", res["gt"]])
# the WavLM recipe's pieces: an HF WavLM directory written and read by the
# port, and a raw-audio decode through it (the published 320x conv stack at
# tiny widths)
from slam_llm_tpu_torch.models import wavlm
from slam_llm_tpu_torch.tools.synth_checkpoint import write_wavlm
narrow = wavlm.WavLMConfig(d_model=32, n_heads=2, n_layers=1, ffn_dim=64, conv_dim=(8,) * 7, conv_pos=16,
                           conv_pos_groups=2, num_buckets=32, max_distance=50)
wavlm.WAVLM_PRESETS["wavlm-narrow-test"] = lambda: narrow
write_wavlm(str(tmp / "wavlm"), narrow, seed=1)
raw = inference_batch.main(tiny_run_config(make_corpus(tmp, n=2), **{
    "model_config.encoder_name": "wavlm", "model_config.encoder_config": "wavlm-narrow-test",
    "model_config.encoder_path": str(tmp / "wavlm"), "dataset_config.input_type": "raw",
    "decode_config.decode_log": str(tmp / "w"), "decode_config.max_new_tokens": 3,
    "train_config.shard.base_quant": "int8"}), device="cpu")
# the AAC recipes' pieces: an EAT file in the data2vec2 layout, a fixed-length
# fbank decode through the audio dataset, the caption metrics over its logs
import contextlib, io
from slam_llm_tpu_torch.models import vit
from slam_llm_tpu_torch.tools.synth_checkpoint import write_eat
from slam_llm_tpu_torch.utils import caption_metrics
write_eat(str(tmp / "eat.pt"), vit.ViTEncoderConfig.tiny_test(), seed=1)
aac = inference_batch.main(tiny_run_config(make_corpus(tmp, n=2), **{
    "model_config.encoder_name": "eat", "model_config.encoder_config": "eat-tiny-test",
    "model_config.encoder_path": str(tmp / "eat.pt"), "dataset_config.dataset": "audio_dataset",
    "dataset_config.target_length": 64, "decode_config.decode_log": str(tmp / "a"),
    "decode_config.max_new_tokens": 3}), device="cpu")
with contextlib.redirect_stdout(io.StringIO()):
    scores = caption_metrics.main(aac["gt"], aac["pred"])
# the CLAP recipes' pieces: a CLAP file reranking the AAC decode's lines,
# FENSE from an SBERT directory and an echecker, DRCap's store and retrieval
import torch
from slam_llm_tpu_torch.models import bert, clap
from slam_llm_tpu_torch.tools import synth_checkpoint as synth
from slam_llm_tpu_torch.utils import clap_refine, drcap, fense
ccfg = clap.CLAPConfig.tiny_test()
synth.write_clap(str(tmp / "clap" / "clap.pt"), ccfg, seed=1)
synth.write_bert_vocab(str(tmp / "clap" / "vocab.txt"), ccfg.bert.vocab_size)
sel = clap_refine.clap_refine_with_model([aac["pred"]], str(tmp / "clap" / "clap.pt"), str(tmp / "train.jsonl"),
                                         str(tmp / "refined"), cfg=ccfg, device="cpu")
bcfg = bert.BertConfig(vocab_size=200, d_model=32, n_layers=1, n_heads=2, ffn_dim=64, max_positions=64)
synth.write_sbert(str(tmp / "sbert"), bcfg, seed=2)
synth.write_echecker(str(tmp / "echecker.ckpt"), bcfg, seed=3)
fense_score = fense.FenseScorer(str(tmp / "sbert"), str(tmp / "echecker.ckpt"), device="cpu").score(
    list(sel.values()), [[t] for t in sel.values()])
model, tok = clap.load_clap(str(tmp / "clap" / "clap.pt"), ccfg, "cpu"), fense.WordPieceTokenizer(
    str(tmp / "clap" / "vocab.txt"))
store = drcap.encode_captions(["a dog barks", "rain falls"], lambda i, m: model.encode_text(
    torch.from_numpy(i), torch.from_numpy(m)), tok)
near = drcap.retrieve_topk(drcap.projection_decode(store, store, 0.07), store, ["a dog barks", "rain falls"], k=1)
for mod in pkgutil.walk_packages(slam_llm_tpu_torch.__path__, "slam_llm_tpu_torch."):
    importlib.import_module(mod.name)
print(json.dumps({"n": res["n"] + raw["n"] + aac["n"], "steps": len(train["steps"]) + len(st["steps"]),
                  "clap": len(sel) == 2 and -1 <= fense_score <= 1 and len(near) == 2,
                  "bleu": "bleu" in bleu[-1] and "spider" in scores,
                  "jax": "jax" in sys.modules, "flax": "flax" in sys.modules,
                  "hf": sorted(m for m in ("tokenizers", "transformers", "regex", "sacrebleu") if m in sys.modules),
                  "slam_llm_tpu": sorted(m for m in sys.modules if m == "slam_llm_tpu" or m.startswith("slam_llm_tpu."))}))
"""


def test_port_runs_without_importing_jax():
    """The decode slice, a training step through the finetune CLI, the ST
    recipe's pieces (a qwen2-layout ByteLevel tokenizer, a Q-Former training
    step, BLEU over the decode logs), the WavLM recipe's (an HF WavLM
    directory written and loaded, a raw-audio decode), the AAC recipes' (an
    EAT file written and loaded, an fbank decode through the audio dataset,
    the caption metrics), the CLAP recipes' (a CLAP file written and loaded
    by ``clap_refine_with_model`` over the AAC decode, FENSE from an SBERT
    directory and an echecker, DRCap's store and retrieval) and every module
    of the package (``models/{clap,htsat,bert,cnn14}``, ``utils/{fense,
    clap_refine,drcap}`` among them), in a
    fresh interpreter with a config from the port's own ``config`` module:
    neither jax nor flax nor any module of the JAX package is ever imported
    (this test process has all three), nor tokenizers, transformers, regex
    or sacrebleu."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, str(REPO)], capture_output=True, text=True, env=env,
        timeout=300, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "n": 6, "steps": 2, "clap": True, "bleu": True, "jax": False, "flax": False, "hf": [], "slam_llm_tpu": []}


def test_port_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax)\b", re.M)
    files = sorted((REPO / "slam_llm_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    assert [str(f) for f in files if pattern.search(f.read_text())] == []


def test_chip_smoke_reaches_the_host_modules_only_through_the_port():
    """No file of the port, and not chip_smoke.py, imports a module of the
    JAX package: config, registry, data, audio and logging are the port's own
    copies (``tests/test_torch_host.py`` holds them against the originals)."""
    pattern = re.compile(r"^\s*(import|from)\s+slam_llm_tpu(\.|\s|$)", re.M)
    files = [REPO / "chip_smoke.py", *sorted((REPO / "slam_llm_tpu_torch").rglob("*.py"))]
    assert len(files) > 30
    assert [str(f) for f in files if pattern.search(f.read_text())] == []