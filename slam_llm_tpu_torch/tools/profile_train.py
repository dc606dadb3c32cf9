"""Where the recipe's training step goes on the card: one step under
``torch.profiler``, its device time split by kernel family, the unprofiled
step time, and the fused cross-entropy alone.

    python -m slam_llm_tpu_torch.tools.profile_train [--recipe st | wavlm | aac | drcap | vallex] [++key=value ...]   # from the repo root, on a GPU

Builds the recipe of ``chip_smoke.py`` (asr_whisper_tinyllama.yaml, full
width, random weights from the recipe's seed: frozen whisper-small, trained
projector, TinyLlama-1.1B int8 base with LoRA r8 on q / v and the int8_rot
backward, remat with dots_flash_saveable; ``++`` overrides as the finetune
CLI takes them, e.g. ``++train_config.shard.base_quant_bwd=int8_sr``) on its
synthetic corpus, or with ``--recipe st`` phase 8's speech-translation
recipe (st_whisper_qwen.yaml: frozen whisper-large-v3 and Qwen2-7B, the
trained Q-Former, its synthetic qwen2 tokenizer and corpus), or with
``--recipe wavlm`` phase 9's asr_wavlm_vicuna.yaml (frozen WavLM-large and
vicuna-7b in the int8 base with the bf16 backward, the trained linear
projector, a synthetic 32000-entry Llama tokenizer; seeded random weights),
or with ``--recipe aac`` phase 10's aac_eat_vicuna.yaml (frozen EAT-base
and vicuna-7b in bf16, the trained linear projector, the same tokenizer,
fixed-length 1024-frame fbank; seeded random weights), or with
``--recipe drcap`` phase 11's drcap.yaml (no encoder, the trained
1024 -> 4096 linear projector, frozen vicuna-7b in bf16, the same
tokenizer; one latent frame a row, with three retrieved captions in the
prompt: the manifest's rows go through ``utils.drcap.augment_manifest_with_rag``
over the synthetic caption store, whose latents are seeded random unit
vectors, since a profile needs their shape and not a CLAP), or with
``--recipe vallex`` phase 17's vallex_tts.yaml (VALL-E X base_24l, every
tensor trained, a synthetic 8-codebook corpus in the (64, 512) buckets),
takes the first training batch of the recipe's size, runs warm-up steps,
then profiles one step. Kernel families: K3 the s8 GEMM, K4 the flash
backward, K1 the flash forward, K2 rowquant (both kernels), cuBLAS GEMMs
(encoder, LoRA, head), and the rest (elementwise, reductions, copies: the
glue). ``--recipe wavlm`` and ``aac`` add the frozen encoder's forward
alone, split the same way; ``wavlm`` also the plain biased attention of its
layers (the dense (B, H, T, T) rel-pos bias, which no kernel takes) as a
row of its own. The full ``key_averages`` tables go to
``profile_train_step.txt`` and ``profile_fused_ce.txt`` in the output
directory of ``tools/profile_decode.py``.
"""

from __future__ import annotations

import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from slam_llm_tpu_torch.tools.profile_decode import _device_us, report

FAMILIES = (  # (family, substrings of the kernel name), first match wins
    ("K3 int8_matmul", ("int8_matmul_",)),
    ("K4 flash_bwd", ("flash_bwd_",)),
    ("K1 flash_fwd", ("flash_fwd_",)),
    ("K2 rowquant", ("rowquant",)),
    ("cuBLAS GEMM", ("gemm", "xmma", "cutlass", "nvjet", "Kernel2")),
)


def split_by_family(prof) -> dict:
    out = defaultdict(float)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or _device_us(e) <= 0:
            continue
        fam = next((f for f, keys in FAMILIES if any(k in e.key for k in keys)), "glue (elementwise, reductions, copies)")
        out[fam] += _device_us(e) / 1000
    return dict(out)


RECIPES = ("asr", "st", "wavlm", "aac", "drcap", "vallex")


def split_recipe(argv) -> tuple:
    """``--recipe <name>`` (default ``asr``) off the front of an argument list."""
    argv = list(argv)
    if argv[:1] == ["--recipe"]:
        if len(argv) < 2 or argv[1] not in RECIPES:
            raise SystemExit(f"--recipe takes one of {RECIPES}")
        return argv[1], argv[2:]
    return "asr", argv


def build_recipe(recipe: str, overrides, tmp: Path, device="cuda", split: str = "train"):
    """The recipe's run config, model (materialized) and dataset of
    ``split`` on ``device``, with the synthetic corpus and tokenizer
    ``chip_smoke.py`` uses for it written under ``tmp``."""
    import chip_smoke as cs
    from slam_llm_tpu_torch.pipeline import finetune
    from slam_llm_tpu_torch.pipeline.common import build_model_and_data, materialize_params
    from slam_llm_tpu_torch.tools.synth_checkpoint import QWEN2_BPE, write_qwen2_tokenizer, write_tokenizer

    factory = "++model_config.file=chip_smoke:synth_tokenizer_factory"
    targets = None
    if recipe == "st":
        write_qwen2_tokenizer(str(tmp / "qwen2"), QWEN2_BPE, corpus=cs.ST_TARGETS)
        cs._synth_tokenizer_dir = str(tmp / "qwen2")
        head, targets = ["--config", str(cs.ST_RECIPE), factory], cs.ST_TARGETS
    elif recipe in ("wavlm", "aac", "drcap"):
        write_tokenizer(str(tmp / "tokenizer"), 32000)
        cs._synth_tokenizer_dir = str(tmp / "tokenizer")
        head = ["--config", str({"wavlm": cs.W_RECIPE, "aac": cs.AAC_RECIPE, "drcap": cs.DRCAP_RECIPE}[recipe]), factory]
        targets = cs.AAC_CAPTIONS if recipe == "aac" else None
    elif recipe == "vallex":
        head = ["--config", str(cs.VX_RECIPE), "++dataset_config.code_layer=8"]
    else:
        head = ["--config", str(cs.RECIPE)]
    n = finetune.load_run_config(head + list(overrides)).train_config.batch_size_training
    if recipe == "drcap":
        corpus, latents = _drcap_corpus(tmp, n, split)
    elif recipe == "vallex":
        from slam_llm_tpu_torch.tools.synth_checkpoint import write_vallex_corpus

        corpus = write_vallex_corpus(str(tmp / f"{split}.jsonl"), n, frames=cs.VX_FRAMES[512], text_len=(40, cs.VX_TT))
    else:
        corpus = cs.write_corpus(tmp, n=n, name=split, targets=targets)
    cfg = finetune.load_run_config(head + [f"++dataset_config.train_data_path={corpus}",
                                           f"++dataset_config.val_data_path={corpus}", *overrides])
    if split != "train":
        cfg.dataset_config.inference_mode = True
    model, tokenizer, dataset = build_model_and_data(cfg, split=getattr(cfg.dataset_config, f"{split}_split"),
                                                     device=device)
    materialize_params(model, cfg)
    if recipe == "drcap":
        from slam_llm_tpu_torch.utils.drcap import LatentCaptionDataset

        dataset = LatentCaptionDataset(dataset, latents)
    return cfg, model, tokenizer, dataset, n


def _drcap_corpus(tmp: Path, n: int, split: str):
    """``n`` clips whose targets are captions of the synthetic store, with
    their 3 most similar captions (themselves excluded) from seeded random
    unit latents; returns the RAG manifest and the rows' latents."""
    import numpy as np

    import chip_smoke as cs
    from slam_llm_tpu_torch.utils.drcap import augment_manifest_with_rag

    captions = cs.drcap_captions()
    support = np.random.default_rng(0).standard_normal((len(captions), 1024)).astype(np.float32)
    support /= np.linalg.norm(support, axis=1, keepdims=True)
    index = {c: i for i, c in enumerate(captions)}
    targets = [captions[(7 * i) % len(captions)] for i in range(n)]
    clips = cs.write_corpus(tmp, n=n, name=f"{split}_clips", targets=targets)
    rag = tmp / f"{split}.jsonl"
    augment_manifest_with_rag(str(clips), str(rag), captions, support,
                              lambda texts: support[[index[t] for t in texts]], k=3)
    return rag, support[[index[t] for t in targets]]


def main(argv=(), steps: int = 3) -> None:
    import chip_smoke as cs
    from slam_llm_tpu_torch.ops.fused_ce import fused_linear_ce
    from slam_llm_tpu_torch.train.state import Trainer

    recipe, overrides = split_recipe(argv)
    smi = cs.setup()
    cs.build()
    tmp = Path(tempfile.mkdtemp(prefix="profile_train_"))
    cfg, model, _, dataset, n = build_recipe(recipe, overrides, tmp)
    trainer = Trainer(model, model.cfg, cfg.train_config).state_from_params()
    batch = trainer.put_batch(dataset.collator([dataset[i] for i in range(n)]))
    first = next(v for v in batch.values() if v.ndim)
    print(f"batch {tuple(first.shape)}", flush=True)
    for _ in range(2):  # warm-up
        trainer.train_step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        m = trainer.train_step(batch)
    float(m["loss"])
    step_ms = 1000 * (time.perf_counter() - t0) / steps
    print(f"unprofiled step {step_ms:.1f} ms (mean of {steps}), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    counters = {n: c for n, c in cs.kernel_counters().items() if n in cs.K2_KERNELS}
    before = {n: c.launches for n, c in counters.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m = trainer.train_step(batch)
        float(m["loss"])
        wall = time.perf_counter() - t0
    report(prof, wall, "train_step")
    fams = split_by_family(prof)
    total = sum(fams.values())
    for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:45s} {ms:9.2f} ms  {100 * ms / total:5.1f} %", flush=True)
    print(f"K2 launches in the profiled step: { {n: c.launches - before[n] for n, c in counters.items()} }", flush=True)
    if recipe in ("wavlm", "aac"):
        encoder_rows(trainer, batch, step_ms)
    if recipe == "vallex":  # no LLM head, no fused CE
        print(smi)
        return

    # the fused CE alone, at the step's shape (hidden of the trunk, frozen head)
    b, t = batch["input_ids"].shape
    llm = model.llm
    hidden = torch.randn(b, t - 1, llm.cfg.d_model, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    labels = batch["labels"][:, 1:]
    for _ in range(2):
        fused_linear_ce(hidden, llm.lm_head.weight, labels, chunk=llm.cfg.ce_chunk, kernel_needs_grad=False)[0].backward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fused_linear_ce(hidden, llm.lm_head.weight, labels, chunk=llm.cfg.ce_chunk, kernel_needs_grad=False)[0].backward()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(prof, wall, "fused_ce")
    print(smi)


def encoder_rows(trainer, batch, step_ms: float) -> None:
    """The frozen encoder's forward (and the projector's) alone, split by
    kernel family, and for WavLM's rel-pos presets the plain biased
    attention of one of its layers by CUDA-graph replay, times the layers,
    as rows of their own."""
    import chip_smoke as cs

    biased = getattr(trainer.model.encoder.cfg, "rel_bias", False)

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.model.encode(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(prof, wall, "encoder_forward")
    fams = split_by_family(prof)
    if biased:
        times = cs.wavlm_encoder_times(trainer, batch)
    else:
        with torch.no_grad():
            times = dict(encoder_ms=cs.event_ms(lambda: trainer.model.encode(batch), reps=3))
    layers = trainer.model.encoder.cfg.n_layers
    print(f"encoder + projector forward: {times['encoder_ms']:.2f} ms by CUDA events, "
          f"{times['encoder_ms'] / step_ms:.3f} of the unprofiled step", flush=True)
    for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
        print(f"  encoder {fam:37s} {ms:9.2f} ms", flush=True)
    if not biased:
        return
    print(f"  plain biased attention {times['shape']}: {times['attn_ms']:.4f} ms a layer, "
          f"{times['attn_ms'] * layers:.2f} ms over {layers} layers (SDPA with the same additive mask "
          f"{times['sdpa_ms']:.4f} ms a layer)", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
