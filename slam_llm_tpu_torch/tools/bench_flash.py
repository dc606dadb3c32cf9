"""K1 and K4 per call at the shapes of ``chip_smoke.py`` phase 3, their f32
routes (K1 f32, K4 f32) at phase 3's f32 shapes, for an A/B of two trees on
one card.

    python -m slam_llm_tpu_torch.tools.bench_flash [repeats]   # from a checkout's root, on a GPU

Times the flash forward and backward kernels by CUDA-graph replay
(``chip_smoke.time_ms``) ``repeats`` times (default 3) and prints one JSON
line: the card's name and power limit, per shape the times in ms, and the
device microseconds of one call by kernel (``torch.profiler``). It
uses only the wrappers' public signatures and ``chip_smoke``'s helpers, so
the same file runs against an older checkout of the port: copy it into that
tree and run it from that tree's root, in turns with this one.
"""

from __future__ import annotations

import json
import re
import sys

import torch

K1_CASES = [  # (name, B, T, H, Hkv, D, causal, padding, fused rope), phase 3's
    ("whisper", 8, 1500, 12, 12, 64, False, "right", False),
    ("prefill", 8, 512, 32, 4, 64, True, "none", False),
    ("training, fused RoPE", 16, 512, 32, 4, 64, True, "left", True),
    ("prefill, left-padded", 8, 448, 32, 4, 64, True, "left", False),
    ("head_dim 128", 2, 512, 32, 32, 128, True, "left", False),
]
K4_CASES = [
    ("training, fused RoPE", 16, 512, 32, 4, 64, True, "both", True),
    ("whisper-like", 2, 1500, 12, 12, 64, False, "right", False),
]
# the f32 routes on f32 tensors (name, B, T, H, Hkv, D, causal, padding),
# phase 3's: Spatial-AST-base's 3 CLS + 512 patches
K1_F32_CASES = [
    ("Spatial-AST training batch", 16, 515, 12, 12, 64, False, "none"),
    ("Spatial-AST decode batch", 8, 515, 12, 12, 64, False, "none"),
    ("right-padded", 8, 515, 12, 12, 64, False, "right"),
    ("causal, left-padded", 4, 515, 12, 12, 64, True, "left"),
    ("GQA, head_dim 128, causal", 2, 256, 8, 2, 128, True, "right"),
]
K4_F32_CASES = [K1_F32_CASES[i] for i in (0, 2, 3, 4)]
ROPE_THETA = 1e4  # TinyLlama's, for the fused-RoPE cases


def by_kernel(fn) -> dict:
    """Device microseconds of one call, by kernel name (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        name = re.search(r"flash_\w+", e.key)
        if us > 0 and name:
            out[name.group(0)] = round(out.get(name.group(0), 0.0) + us, 2)
    return out


def main(repeats: int = 3) -> dict:
    import chip_smoke as cs
    from slam_llm_tpu_torch.ops.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd

    smi = cs.setup()
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {"card": smi, "K1": {}, "K4": {}, "K1 f32": {}, "K4 f32": {}}
    f32_cases = (("K1 f32", K1_F32_CASES), ("K4 f32", K4_F32_CASES))
    for kind, cases in (("K1", K1_CASES), ("K4", K4_CASES), *(
            (kind, [(*c, False) for c in cases]) for kind, cases in f32_cases)):
        dtype = torch.float32 if kind.endswith("f32") else torch.bfloat16
        for name, b, t, h, hkv, d, causal, pad, fused in cases:
            q = torch.randn(b, t, h, d, generator=gen, device="cuda").to(dtype)
            k = torch.randn(b, t, hkv, d, generator=gen, device="cuda").to(dtype)
            v = torch.randn(b, t, hkv, d, generator=gen, device="cuda").to(dtype)
            mask = cs._padding_mask(b, t, pad)
            rope = cs._rope_for(mask, d, ROPE_THETA) if fused else None
            if kind.startswith("K1"):
                def fn():
                    flash_attention_fwd(q, k, v, mask, causal, rope=rope)
            else:
                dout = torch.randn(b, t, h, d, generator=gen, device="cuda").to(dtype)
                out, lse = flash_attention_fwd(q, k, v, mask, causal, rope=rope)

                def fn():
                    flash_attention_bwd(q, k, v, mask, out, lse, dout, causal, rope=rope)
            key = f"{name} {(b, t, h, hkv, d)}"
            res[kind][key] = [round(cs.time_ms(fn), 5) for _ in range(repeats)]
            res.setdefault("by_kernel_us", {})[f"{kind} {key}"] = by_kernel(fn)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 3)
