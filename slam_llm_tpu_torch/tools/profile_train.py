"""Where the recipe's training step goes on the card: one step under
``torch.profiler``, its device time split by kernel family, the unprofiled
step time, and the fused cross-entropy alone.

    python -m slam_llm_tpu_torch.tools.profile_train [--recipe st] [++key=value ...]   # from the repo root, on a GPU

Builds the recipe of ``chip_smoke.py`` (asr_whisper_tinyllama.yaml, full
width, random weights from the recipe's seed: frozen whisper-small, trained
projector, TinyLlama-1.1B int8 base with LoRA r8 on q / v and the int8_rot
backward, remat with dots_flash_saveable; ``++`` overrides as the finetune
CLI takes them, e.g. ``++train_config.shard.base_quant_bwd=int8_sr``) on its
synthetic corpus, or with ``--recipe st`` phase 8's speech-translation
recipe (st_whisper_qwen.yaml: frozen whisper-large-v3 and Qwen2-7B, the
trained Q-Former, its synthetic qwen2 tokenizer and corpus), takes the first
training batch of the recipe's size, runs warm-up steps, then profiles one
step. Kernel families: K3 the s8
GEMM, K4 the flash backward, K1 the flash forward, K2 rowquant (both
kernels), cuBLAS GEMMs (encoder, LoRA, head), and the rest (elementwise,
reductions, copies: the glue). The full ``key_averages`` tables go to
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


def main(overrides=(), steps: int = 3) -> None:
    import chip_smoke as cs
    from slam_llm_tpu_torch.ops.fused_ce import fused_linear_ce
    from slam_llm_tpu_torch.pipeline import finetune
    from slam_llm_tpu_torch.pipeline.common import build_model_and_data, materialize_params
    from slam_llm_tpu_torch.tools.synth_checkpoint import QWEN2_BPE, write_qwen2_tokenizer
    from slam_llm_tpu_torch.train.state import Trainer

    overrides = list(overrides)
    st = overrides[:2] == ["--recipe", "st"]
    if st:
        overrides = overrides[2:]
    smi = cs.setup()
    cs.build()
    tmp = Path(tempfile.mkdtemp(prefix="profile_train_"))
    if st:
        write_qwen2_tokenizer(str(tmp / "qwen2"), QWEN2_BPE, corpus=cs.ST_TARGETS)
        cs._st_tokenizer_dir = str(tmp / "qwen2")
        head = ["--config", str(cs.ST_RECIPE), "++model_config.file=chip_smoke:st_model_factory"]
    else:
        head = ["--config", str(cs.RECIPE)]
    n = finetune.load_run_config(head + overrides).train_config.batch_size_training
    corpus = cs.write_corpus(tmp, n=n, name="train", targets=cs.ST_TARGETS if st else None)
    cfg = finetune.load_run_config(head + [f"++dataset_config.train_data_path={corpus}", *overrides])
    model, _, dataset = build_model_and_data(cfg, split=cfg.dataset_config.train_split, device="cuda")
    materialize_params(model, cfg)
    trainer = Trainer(model, model.cfg, cfg.train_config).state_from_params()
    batch = trainer.put_batch(dataset.collator([dataset[i] for i in range(n)]))
    print(f"batch {tuple(batch['input_ids'].shape)}, {int(batch['attention_mask'].sum())} attended tokens", flush=True)
    for _ in range(2):  # warm-up
        trainer.train_step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        m = trainer.train_step(batch)
    float(m["loss"])
    print(f"unprofiled step {1000 * (time.perf_counter() - t0) / steps:.1f} ms (mean of {steps}), "
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


if __name__ == "__main__":
    main(sys.argv[1:])
