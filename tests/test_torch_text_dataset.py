"""The text-only slice of the port against the JAX package, on the CPU.

``data/text_dataset.py`` items and batches (train and inference) and
``data/concatenator.py`` blocks equal the JAX modules' bit for bit. A tiny
Qwen2-shaped LLM (q / k / v biases, RoPE theta 1e6, LoRA r4 on q / v) on the
int8 base with the deterministic int8 backward and the int8 CE head,
``encoder_name: null``: two port ``Trainer`` steps meet the JAX ``Trainer``
within 1e-5 (f32, frozen tensors kept in f32: loss, grad norm and every LoRA
tensor), the loss of the trainer's bf16-stored frozen tensors equals the JAX
model's within 1e-6, greedy and beam-4 tokens equal the JAX ``Generator``'s,
and ``pipeline.finetune`` -> ``pipeline.inference_batch`` runs the recipe end
to end. The 152064-wide f32 dlog of Qwen2-7B's int8 CE head takes K2's
long-row path.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from test_torch_train import _leaves

from slam_llm_tpu.config import DataConfig as JDatasetConfig
from slam_llm_tpu.config import TrainConfig
from slam_llm_tpu.data import concatenator as jconcat
from slam_llm_tpu.data import text_dataset as jtext
from slam_llm_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from slam_llm_tpu.inference.generate import GenerationConfig as JGenerationConfig
from slam_llm_tpu.inference.generate import Generator as JGenerator
from slam_llm_tpu.models.llm import LLMConfig as JLLMConfig
from slam_llm_tpu.models.projector import ProjectorConfig as JProjectorConfig
from slam_llm_tpu.models.slam_model import SLAMConfig as JSLAMConfig
from slam_llm_tpu.models.slam_model import SLAMModel as JSLAMModel
from slam_llm_tpu.train.optimizer import merge_params as j_merge
from slam_llm_tpu.train.optimizer import partition_params as j_partition
from slam_llm_tpu_torch.config import DataConfig as DatasetConfig, RunConfig, set_by_path
from slam_llm_tpu_torch.data import concatenator as tconcat
from slam_llm_tpu_torch.data import text_dataset as ttext
from slam_llm_tpu_torch.data.tokenizer import ByteTokenizer
from slam_llm_tpu_torch.inference.generate import GenerationConfig, Generator
from slam_llm_tpu_torch.models import llm as tllm
from slam_llm_tpu_torch.models import projector as tproj
from slam_llm_tpu_torch.models import slam_model as tslam
from slam_llm_tpu_torch.train.state import Trainer
from slam_llm_tpu_torch.utils.convert import from_flax_params, trainable_to_flax

ROWS = [
    {"key": "a", "instruct": "  Translate to German: good morning.  ", "target": "Guten Morgen."},
    {"key": "b", "source_text": "Summarize: the cat sat on the mat all day long", "target": "A cat sat."},
    {"key": "c", "target": "no instruction at all"},
    {"key": "d", "instruct": "Count to five.", "target": 12345},
    {"key": "e", "instruct": "Übersetze: 今天天气很好", "target": "Heute ist schönes Wetter."},
]


def _manifest(tmp_path):
    path = tmp_path / "text.jsonl"
    path.write_text("".join(json.dumps(r, ensure_ascii=False) + "\n" for r in ROWS), encoding="utf-8")
    return path


def _datasets(tmp_path, inference: bool, buckets=None):
    manifest = _manifest(tmp_path)
    out = []
    for cls, get, tok in ((DatasetConfig, ttext.get_text_dataset, ByteTokenizer()),
                          (JDatasetConfig, jtext.get_text_dataset, JByteTokenizer())):
        cfg = cls()
        cfg.train_data_path = cfg.val_data_path = str(manifest)
        cfg.inference_mode = inference
        if buckets is not None:
            cfg.text_buckets = buckets
        out.append(get(cfg, tok, "train" if not inference else "val"))
    return out


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("inference", [False, True])
def test_items_and_batches_bit_equal_to_jax(tmp_path, inference):
    """Items (prompt template, ``IGNORE_INDEX`` over the prompt, eos) and
    collated batches (the bucket, right / left padding, ``keys`` /
    ``targets`` in inference) equal the JAX module's; a row past the last
    bucket doubles it."""
    tds, jds = _datasets(tmp_path, inference)
    assert len(tds) == len(jds) == len(ROWS)
    titems, jitems = [tds[i] for i in range(len(ROWS))], [jds[i] for i in range(len(ROWS))]
    for a, b in zip(titems, jitems):
        _same(a, b)
    assert ("labels" in titems[0]) != inference
    for n in (2, len(ROWS)):
        _same(tds.collator(titems[:n]), jds.collator(jitems[:n]))
    small_t, small_j = _datasets(tmp_path, inference, buckets=[16, 32])
    tb = small_t.collator([small_t[i] for i in range(len(ROWS))])
    _same(tb, small_j.collator([small_j[i] for i in range(len(ROWS))]))
    longest = max(len(small_t[i]["input_ids"]) for i in range(len(ROWS)))
    assert 128 < longest <= tb["input_ids"].shape[1] == 256  # 32 doubled three times
    if inference:
        assert tb["keys"] == [r["key"] for r in ROWS] and tb["attention_mask"][:, -1].all()


def test_concat_blocks_bit_equal_to_jax(tmp_path):
    """Greedy packing into chunk-size blocks, the tail dropped, and the
    stacked batch: the JAX module's, for two chunk sizes."""
    tds, jds = _datasets(tmp_path, False)
    for chunk in (16, 37):
        tc, jc = tconcat.ConcatDataset(tds, chunk), jconcat.ConcatDataset(jds, chunk)
        assert len(tc) == len(jc) > 2
        for i in range(len(tc)):
            _same(tc[i], jc[i])
            assert tc[i]["input_ids"].shape == (chunk,) and tc.sort_key(i) == chunk
        _same(tc.collator([tc[0], tc[1]]), jc.collator([jc[0], jc[1]]))


# ---- the text-only model -------------------------------------------------------------

PAD, EOS = 0, 2


def _jax_cfg(bwd="int8"):
    llm = dataclasses.replace(JLLMConfig.tiny_test(), lora_rank=4, lora_dropout=0.0, dtype=jnp.float32,
                              qkv_bias=True, rope_theta=1e6, base_quant="int8", base_quant_bwd=bwd, ce_quant="int8")
    proj = JProjectorConfig(encoder_dim=16, llm_dim=llm.d_model, ds_rate=5, hidden_dim=32, dtype=jnp.float32)
    return JSLAMConfig(llm=llm, encoder_name=None, encoder=None, projector="linear", projector_cfg=proj,
                       freeze_encoder=True, freeze_llm=True)


def _port_cfg(jcfg):
    def conv(cls, obj):
        names = {f.name for f in dataclasses.fields(cls)} - {"dtype", "param_dtype"}
        return cls(**{n: getattr(obj, n) for n in names if hasattr(obj, n)}, dtype=torch.float32)

    return tslam.SLAMConfig(llm=conv(tllm.LLMConfig, jcfg.llm), encoder_name=None, encoder=None,
                            projector="linear", projector_cfg=conv(tproj.ProjectorConfig, jcfg.projector_cfg),
                            freeze_encoder=True, freeze_llm=True)


def _batch(inference: bool = False):
    """Two text rows from the text dataset's layout (no audio): row 1 padded
    (on the right in training, on the left in inference), labels after a
    6-token prompt."""
    rng = np.random.default_rng(0)
    b, t = 2, 24
    ids = rng.integers(3, 250, (b, t)).astype(np.int64)
    attn = np.ones((b, t), np.int32)
    pad = slice(0, 5) if inference else slice(20, t)
    attn[1, pad], ids[1, pad] = 0, PAD
    out = {"input_ids": ids, "attention_mask": attn, "modality_mask": np.zeros((b, t), np.int32)}
    if not inference:
        labels = ids.copy()
        labels[:, :6] = -100
        labels[1, pad] = -100
        out["labels"] = labels
    return out


@pytest.fixture(scope="module")
def params():
    """The JAX init of the text-only model (no projector leaves: its init
    never reaches the projector), every lora_b drawn nonzero."""
    jcfg = _jax_cfg()
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    p = nn.meta.unbox(JSLAMModel(jcfg).init(jax.random.PRNGKey(0), jb, method="init_all")["params"])
    rng = np.random.default_rng(1)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict)
                else (rng.standard_normal(np.shape(v)) * 0.3).astype(np.float32) if k == "lora_b"
                else np.asarray(v) for k, v in node.items()}

    return walk(p)


def _port_model(jcfg, params):
    tcfg = _port_cfg(jcfg)
    tm = tslam.SLAMModel(tcfg)
    missing, unexpected = tm.load_state_dict(from_flax_params(params, tcfg), strict=False)
    assert not unexpected and all(m.startswith("encoder_projector.") for m in missing)
    return tcfg, tm


def _train_config(frozen_dtype):
    tc = TrainConfig()
    tc.use_peft, tc.lr, tc.warmup_steps, tc.total_steps, tc.seed = True, 1e-3, 1, 10, 0
    tc.peft_config.lora_dropout = 0.0
    tc.frozen_dtype = frozen_dtype
    return tc


def _tbatch(inference=False):
    return {k: torch.from_numpy(v) for k, v in _batch(inference).items()}


def test_trainer_steps_match_jax(params):
    """f32 with the frozen tensors in f32: two steps (the first at lr 0)
    of the port's Trainer against the JAX Trainer: loss and grad norm within
    1e-5 relative, each LoRA tensor within 1e-5 of its norm after each step;
    the projector, which a text batch never reaches, stays as it was (no
    gradient, no weight decay)."""
    from slam_llm_tpu.parallel import make_mesh
    from slam_llm_tpu.train.state import build_trainer

    jcfg, tc = _jax_cfg(), _train_config("float32")
    mesh = make_mesh(dp=1, fsdp=1, tp=1, devices=jax.devices()[:1])
    jt = build_trainer(JSLAMModel(jcfg), jcfg, tc, mesh)
    state = jt.state_from_params(jax.tree_util.tree_map(jnp.asarray, params))
    with mesh:
        db = jt.put_batch(_batch())
    tcfg, tm = _port_model(jcfg, params)
    trainer = Trainer(tm, tcfg, tc).state_from_params()
    projector = {n: p.detach().clone() for n, p in trainer.trainable.items() if n.startswith("encoder_projector.")}
    for i in range(2):
        with mesh:
            state, m = jt.train_step(state, db, jax.random.PRNGKey(i))
        tmet = trainer.train_step(_tbatch())
        np.testing.assert_allclose(float(tmet["loss"]), float(m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(m["grad_norm"]), rtol=1e-5)
        want = _leaves(state["trainable"])
        lora = {n: p for n, p in trainer.trainable.items() if not n.startswith("encoder_projector.")}
        got = _leaves(trainable_to_flax(lora))
        assert set(got) == set(want) and len(got) == 4
        for path, g in got.items():
            w = want[path]
            assert np.linalg.norm(g - w) <= 1e-5 * np.linalg.norm(w), (i, path)
    assert projector and all(torch.equal(trainer.trainable[n], before) for n, before in projector.items())


def test_bf16_frozen_loss_equals_the_jax_model(params):
    """With the frozen tensors stored in bf16 (the trainer's default), the
    port's loss equals the JAX model's on the JAX trainer's stored tree
    (kernel scales kept f32) within 1e-6. (The JAX Trainer's jitted step
    reads 9e-6 off its own model here, which the test above avoids.)"""
    from slam_llm_tpu.parallel import make_mesh
    from slam_llm_tpu.train.state import build_trainer

    jcfg, tc = _jax_cfg(), _train_config("bfloat16")
    jt = build_trainer(JSLAMModel(jcfg), jcfg, tc, make_mesh(dp=1, fsdp=1, tp=1, devices=jax.devices()[:1]))
    tr, fr = j_partition(jax.tree_util.tree_map(jnp.asarray, params), jcfg)
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    want = float(JSLAMModel(jcfg).apply({"params": j_merge(tr, jt._cast_frozen(fr))}, jb)["loss"])
    tcfg, tm = _port_model(jcfg, params)
    Trainer(tm, tcfg, tc).state_from_params()
    assert {p.dtype for n, p in tm.named_parameters() if not p.requires_grad} == {torch.bfloat16}
    with torch.no_grad():
        got = float(tm(_tbatch())["loss"])
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("num_beams", [1, 4])
def test_tokens_match_the_jax_generator(params, num_beams):
    """f32 greedy and beam-4 decode of a left-padded text batch: the JAX
    Generator's tokens."""
    jcfg = _jax_cfg()
    _, tm = _port_model(jcfg, params)
    kw = dict(max_new_tokens=8, num_beams=num_beams, eos_token_id=EOS, pad_token_id=PAD)
    want = JGenerator(JSLAMModel(jcfg), JGenerationConfig(**kw)).generate({"params": params}, _batch(True))
    got = Generator(tm.eval(), GenerationConfig(**kw)).generate(_batch(True))
    assert got.shape == want.shape == (2, 8)
    np.testing.assert_array_equal(got, want)


def test_text_recipe_trains_and_decodes_end_to_end(tmp_path):
    """``dataset: text_dataset`` with ``encoder_name: null`` through
    ``pipeline.finetune`` (the int8 base, int8 backward and int8 CE head,
    2 steps, a validation, ``model.pt``) and ``pipeline.inference_batch``
    from that checkpoint (beam 4): a decoded line per key, and the
    reference text in the ``_gt`` file."""
    from slam_llm_tpu_torch.pipeline import finetune, inference_batch

    manifest = _manifest(tmp_path)
    cfg = RunConfig()
    for k, v in {"model_config.llm_name": "tiny-test", "model_config.encoder_name": None,
                 "dataset_config.dataset": "text_dataset", "dataset_config.train_data_path": str(manifest),
                 "dataset_config.val_data_path": str(manifest), "train_config.batch_size_training": 2,
                 "train_config.val_batch_size": 2, "train_config.use_peft": True, "train_config.freeze_llm": True,
                 "train_config.max_steps_per_epoch": 2, "train_config.log_interval": 1,
                 "train_config.shard.base_quant": "int8", "train_config.shard.base_quant_bwd": "int8",
                 "train_config.shard.ce_quant": "int8", "train_config.output_dir": str(tmp_path / "out"),
                 "train_config.model_name": "text", "train_config.num_epochs": 1}.items():
        set_by_path(cfg, k, v)
    res = finetune.main(cfg, device="cpu")
    assert len(res["steps"]) == 2 and all(np.isfinite(s["loss"]) for s in res["steps"])
    assert np.isfinite(res["final_val"]["loss"])
    trainer = res["trainer"]
    assert trainer.model.encoder is None and trainer.model.llm.head_q.abs().sum() > 0
    cfg.ckpt_path = res["checkpoints"][-1]
    cfg.decode_config.decode_log = str(tmp_path / "decode")
    cfg.decode_config.max_new_tokens = 6
    cfg.decode_config.num_beams = 4
    out = inference_batch.main(cfg, device="cpu")
    assert out["n"] == len(ROWS) and out["audio_seconds"] == 0.0
    pred = (tmp_path / "decode_pred").read_text(encoding="utf-8").splitlines()
    gt = (tmp_path / "decode_gt").read_text(encoding="utf-8").splitlines()
    assert sorted(line.split("\t")[0] for line in pred) == [r["key"] for r in ROWS]
    assert "a\tGuten Morgen." in gt and "d\t12345" in gt


def test_qwen2_dlog_takes_the_long_row_path():
    """The int8 CE head's f32 dlog at Qwen2-7B's 152064-row vocabulary is
    longer than one K2 block holds: the planner sends it down the long-row
    path (``units`` 0), at the fold's widths too."""
    from slam_llm_tpu_torch.ops.kernels.rowquant import MAX_K, plan_rowquant

    v = tllm.LLMConfig.qwen2_7b().vocab_size
    assert v == 152064 > MAX_K
    for fold in (False, True):
        assert plan_rowquant(8 * 64, v, elem_bytes=4, fold=fold).units == 0
    assert plan_rowquant(8 * 256, 18944).units > 0  # Qwen2-7B's widest activation row fits a block
