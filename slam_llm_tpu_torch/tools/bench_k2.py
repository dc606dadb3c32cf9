"""K2 (rowquant) per call at the shapes of ``chip_smoke.py`` phase 3 and at
qwen2's f32 dlog rows (K = 152064, the kernel's long-row path), for an A/B
of two trees on one card, and the design points of this tree's kernel.

    python -m slam_llm_tpu_torch.tools.bench_k2 [repeats]            # from a checkout's root, on a GPU
    python -m slam_llm_tpu_torch.tools.bench_k2 [repeats] --design   # this tree only

Times every K2 shape of phase 3 by CUDA-graph replay (``chip_smoke.time_ms``)
``repeats`` times (default 3) and prints one JSON line: the card's name and
power limit, and per shape the times in ms, the bound (bytes at the card's
memory rate), the share of it, and the plain twin's (``rowquant_ref``) time.
The default mode calls only the wrappers' public signatures, the twin and
``chip_smoke``'s helpers, so the same file runs against an older checkout of
the port: copy it into that tree and run it from that tree's root, in turns
with this one.

``--design`` adds, for this tree's kernel: each shape under other plans
than ``plan_rowquant``'s (rows per group, threads, units per thread), and
the rotation without stochastic rounding and stochastic rounding without
the rotation.
"""

from __future__ import annotations

import json
import sys

import torch

# (name, M, K, dtype, seed, rotate, fold): phase 3's K2 shapes, then qwen2's dlog
SHAPES = [
    ("det", 4096, 2048, "bf16", None, False, False),
    ("det", 4096, 5632, "bf16", None, False, False),
    ("det", 32, 2048, "bf16", None, False, False),
    ("det", 32, 5632, "bf16", None, False, False),
    ("det", 8192, 2048, "bf16", None, False, False),
    ("det", 8192, 5632, "bf16", None, False, False),
    ("det", 3584, 2048, "bf16", None, False, False),
    ("det", 1337, 5632, "bf16", None, False, False),
    ("rot+SR", 8192, 2048, "bf16", 1234567, True, False),
    ("rot+SR", 8192, 256, "bf16", 7, True, False),
    ("rot+SR", 8192, 5632, "bf16", 2**32 - 1, True, False),
    ("rot", 37, 2048, "bf16", None, True, False),
    ("SR", 37, 2048, "bf16", 99, False, False),
    ("fold", 8192, 2048, "bf16", None, False, True),
    ("fold SR", 8192, 2048, "bf16", 977, False, True),
    ("fold", 8192, 5632, "bf16", None, False, True),
    ("fold SR", 8192, 5632, "bf16", 977, False, True),
    ("fold", 8192, 256, "bf16", None, False, True),
    ("fold SR", 8192, 256, "bf16", 977, False, True),
    ("fold SR", 1024, 32000, "f32", 2**32 - 5, False, True),
    ("fold", 1024, 32000, "f32", None, False, True),
    ("fold SR", 37, 2056, "bf16", 3, False, True),
    ("fold SR", 64, 152064, "f32", 2**32 - 5, False, True),
    ("fold", 64, 152064, "f32", None, False, True),
]


def inputs(m, k, dtype, fold, gen):
    x = (torch.randn(m, k, generator=gen, device="cuda") * 1e-2).to(
        torch.float32 if dtype == "f32" else torch.bfloat16)
    f = torch.rand(k, generator=gen, device="cuda") * 0.02 + 1e-4 if fold else None
    return x, f


def key(name, m, k, dtype):
    return f"{name} ({m}, {k}) {dtype}"


def bound_ms(x, f) -> float:
    import chip_smoke as cs

    m, k = x.shape
    return cs.bound(0, cs.nbytes(x, f) + m * k + 4 * m, cs.BF16_FLOPS)[0]


def design(gen, repeats: int) -> dict:
    """Other plans than the planner's, and the rotation / SR variants."""
    import chip_smoke as cs
    from slam_llm_tpu_torch.kernels.build import sm_count
    from slam_llm_tpu_torch.ops.kernels.rowquant import (
        MAX_VALUES,
        ONE_ROW_UNITS,
        RowquantPlan,
        _launch,
        plan_rowquant,
        rowquant_ref,
        unit_elems,
    )

    out = {}
    for name, m, k, dtype, seed, rotate, fold in SHAPES:
        if m < 1024 or k > 32768:
            continue
        x, f = inputs(m, k, dtype, fold, gen)
        base = plan_rowquant(m, k, x.element_size(), rotate, fold, sm_count(0), seed is not None)
        unit = unit_elems(x.element_size(), rotate)
        alts = {base}
        for rows in (1, 2, 4, 8, 16):
            for threads in (64, 128, 256, 512):
                units = -(-rows * (k // unit) // threads)
                if units * unit <= MAX_VALUES and (units <= ONE_ROW_UNITS or rows == 1) \
                        and threads * (units - 1) * unit < rows * k:
                    alts.add(RowquantPlan(threads, rows, units, base.fold_smem))
        ref = rowquant_ref(x, f, seed=seed, rotate=rotate)
        rows = []
        for plan in sorted(alts):
            got = _launch(x, f, seed, rotate, plan)
            exact = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
            ms = cs.time_ms(lambda: _launch(x, f, seed, rotate, plan))
            rows.append(dict(plan=list(plan), ms=round(ms, 5), exact=exact, planner=plan == base))
        out[key(name, m, k, dtype)] = sorted(rows, key=lambda r: r["ms"])
    variants = {}
    for m, k, seed, rotate in ((8192, 2048, 1234567, True), (8192, 2048, None, True), (8192, 2048, 1234567, False),
                               (8192, 5632, 2**32 - 1, True), (8192, 5632, None, True), (8192, 5632, 7, False),
                               (8192, 2048, None, False)):
        x, _ = inputs(m, k, "bf16", False, gen)
        variants[f"({m}, {k}) seed={seed} rotate={rotate}"] = [
            round(cs.time_ms(lambda: _launch(x, None, seed, rotate)), 5) for _ in range(repeats)]
    return {"plans": out, "variants": variants}


def main(argv) -> dict:
    import chip_smoke as cs
    from slam_llm_tpu_torch.ops.kernels.rowquant import rowquant, rowquant_ref

    repeats = int(argv[0]) if argv and argv[0].isdigit() else 3
    smi = cs.setup()
    cs.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {"card": smi, "K2": {}}
    for name, m, k, dtype, seed, rotate, fold in SHAPES:
        x, f = inputs(m, k, dtype, fold, gen)
        ms = [cs.time_ms(lambda: rowquant(x, f, seed=seed, rotate=rotate)) for _ in range(repeats)]
        b = bound_ms(x, f)
        res["K2"][key(name, m, k, dtype)] = dict(ms=[round(t, 5) for t in ms], bound_ms=round(b, 5),
                                                 share=round(b / min(ms), 3))
        res["K2"][key(name, m, k, dtype)]["plain_ms"] = round(
            cs.time_ms(lambda: rowquant_ref(x, f, seed=seed, rotate=rotate)), 5)
    if "--design" in argv:
        res.update(design(gen, repeats))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
