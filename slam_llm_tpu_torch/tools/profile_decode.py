"""Where the recipe's decode time goes on the card: prefill and beam decode
under ``torch.profiler``, the unprofiled decode step, and the host cost of one
K2 / K3 wrapper call beside its device time.

    python -m slam_llm_tpu_torch.tools.profile_decode [--recipe st | wavlm | aac | drcap]   # from the repo root, on a GPU

Builds the recipe of ``chip_smoke.py`` (asr_whisper_tinyllama.yaml, full width,
random weights from the recipe's seed; or, with ``--recipe``, phase 8's,
9's, 10's or 11's (DRCap's) recipe, as ``tools/profile_train.py`` builds them) on its
synthetic corpus, takes the first batch of 8, and prints for each profiled
region its wall time, the summed device-kernel time, their ratio (the busy
share) and the top kernels by device time. The full ``key_averages`` tables
go to ``chiprun_out/profile_*.txt``.
"""

from __future__ import annotations

import json
import tempfile
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

OUT = Path("chiprun_out")


def _device_us(e) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, attr):
            return getattr(e, attr)
    return 0.0


def report(prof, wall_s: float, name: str) -> None:
    evs = sorted((e for e in prof.key_averages() if _device_us(e) > 0), key=_device_us, reverse=True)
    total_us = sum(_device_us(e) for e in evs if e.device_type == torch.autograd.DeviceType.CUDA)
    lines = [f"== {name}: wall {wall_s * 1000:.2f} ms, device kernel time {total_us / 1000:.2f} ms, "
             f"busy share {total_us / 1e6 / wall_s:.3f}"]
    lines += [f"  {_device_us(e) / 1000:9.3f} ms  {e.count:7d}x  {e.key[:110]}" for e in evs[:25]]
    txt = "\n".join(lines)
    print(txt, flush=True)
    OUT.mkdir(exist_ok=True)
    (OUT / f"profile_{name}.txt").write_text(txt + "\n\n" + prof.key_averages().table(row_limit=60))


def wrapper_cost(calls: int = 500) -> None:
    """Host enqueue time of one eager wrapper call against the kernel's
    device time (CUDA-graph replay of 50 calls) at the decode shape."""
    from slam_llm_tpu_torch.ops.kernels.rowquant import rowquant
    from slam_llm_tpu_torch.ops.quant import int8_matmul

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(32, 2048, generator=gen, device="cuda").bfloat16()
    xq, xs = rowquant(x)
    wq = torch.randint(-127, 128, (2048, 2048), generator=gen, device="cuda", dtype=torch.int8)
    ws = torch.rand(2048, generator=gen, device="cuda")
    for name, fn in (("rowquant(32, 2048)", lambda: rowquant(x)),
                     ("int8_matmul(32, 2048 -> 2048)", lambda: int8_matmul(xq, wq, xs, ws))):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host = (time.perf_counter() - t0) / calls
        torch.cuda.synchronize()
        graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
            with torch.cuda.graph(graph):
                for _ in range(50):
                    fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        print(f"{name}: host enqueue {host * 1e6:.1f} us/call, "
              f"device {a.elapsed_time(b) * 1000 / 50:.1f} us/call", flush=True)


def main(argv=()) -> None:
    import chip_smoke as cs
    from slam_llm_tpu_torch.inference.generate import _BATCH_KEYS, GenerationConfig, Generator
    from slam_llm_tpu_torch.models.llm import init_kv_cache
    from slam_llm_tpu_torch.pipeline.inference_batch import decode_loader
    from slam_llm_tpu_torch.tools.profile_train import build_recipe, split_recipe

    recipe, overrides = split_recipe(argv)
    smi = cs.setup()
    cs.build()
    tmp = Path(tempfile.mkdtemp(prefix="profile_decode_"))
    cfg, model, tok, dataset, _ = build_recipe(recipe, overrides, tmp, split="test")
    model.eval()
    batch = {k: v for k, v in next(iter(decode_loader(cfg, dataset))).items() if k in _BATCH_KEYS}

    gen = Generator(model, GenerationConfig(max_new_tokens=24, num_beams=4, eos_token_id=tok.eos_token_id,
                                            pad_token_id=tok.pad_token_id))
    gen.generate(batch, max_new_tokens=4)  # warm-up
    torch.cuda.synchronize()

    tb = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    b, t = tb["input_ids"].shape
    with torch.inference_mode():
        for _ in range(2):
            model.prefill(tb, init_kv_cache(model.cfg.llm, b, t + 200, gen_start=t, device="cuda"))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.prefill(tb, init_kv_cache(model.cfg.llm, b, t + 200, gen_start=t, device="cuda"))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    report(prof, wall, "prefill_b8")

    # 24 new tokens: one prefill and 23 beam steps
    gen.stats.update(prefill_s=0.0, decode_s=0.0, decode_steps=0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gen.generate(batch)
        wall = time.perf_counter() - t0
    print(json.dumps(gen.stats))
    report(prof, wall, "beam_generate_24")

    gen.stats.update(prefill_s=0.0, decode_s=0.0, decode_steps=0)
    gen.generate(batch, max_new_tokens=64)
    print(f"unprofiled beam decode {1000 * gen.stats['decode_s'] / gen.stats['decode_steps']:.2f} ms/step "
          f"{json.dumps(gen.stats)}", flush=True)
    wrapper_cost()
    print(smi)


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
