"""K3 (the s8 GEMM, ``csrc/int8_matmul.cu``) at the slices' shapes: the
planner's plan and its alternatives against the f64 twin, and their device
times beside the bound and the library products.

    python -m slam_llm_tpu_torch.tools.bench_k3 [--check-only]    # from the repo root, on a GPU

For each shape (M, K -> N) it prints the plan ``plan_int8_matmul`` picks, the
max bf16 ulp and the f32 exactness against ``int8_matmul_ref``, whether two
runs are bit-identical, and, unless ``--check-only``, the device time of the
plan and of the other split counts (up to 16 on the split-K path, also with
16-row tiles, 4 on the wgmma path; keyed "<tile rows>x<splits>"), the bound (int8 operations
at 1,979 TOP/s or bytes at 3.35 TB/s, the larger), ``torch._int_mm`` (M > 16,
s32 out, no epilogue) and the bf16 cuBLAS product. At decode M (8, 32) every
timed call reads its own copy of the weight, cold in L2, as a decode step
does. Results also go to ``bench_k3.json`` in the output directory of
``tools/profile_decode.py``.
"""

from __future__ import annotations

import itertools
import json
import sys

import torch

INT8_OPS = 1979e12  # the H100 SXM's dense int8 rate, op/s
HBM = 3.35e12  # bytes/s

SHAPES = [  # (M, K, N)
    (8, 2048, 2048), (8, 2048, 5632), (8, 5632, 2048), (8, 2048, 256),
    (32, 2048, 2048), (32, 2048, 5632), (32, 5632, 2048), (32, 2048, 256),
    (4096, 2048, 2048), (4096, 2048, 5632), (4096, 5632, 2048), (4096, 2048, 256),
    (8192, 2048, 2048), (8192, 256, 2048), (8192, 5632, 2048), (8192, 2048, 5632),
    (1024, 32000, 2048), (1024, 2048, 32000), (64, 32000, 2048),
]
EDGES = [(m, 48, 40) for m in (1, 16, 17, 64, 65, 127, 128)] + [(300, 5632, 2048), (129, 2064, 264)]
EDGES += [(100, 5632, 2048)]


def bound_ms(m: int, k: int, n: int, out_bytes: int = 2) -> tuple:
    """(least time in ms, "operations" or "bytes") for one product with its epilogue."""
    ops = 2.0 * m * n * k
    nbytes = m * k + n * k + 4 * (m + n) + out_bytes * m * n
    t_ops, t_bytes = ops / INT8_OPS, nbytes / HBM
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


def operands(m: int, k: int, n: int, gen):
    xq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
    xs = torch.rand(m, generator=gen, device="cuda") * 0.05 + 1e-3
    ws = torch.rand(n, generator=gen, device="cuda") * 0.01 + 1e-4
    return xq, wq, xs, ws


def check(m: int, k: int, n: int, gen, plan=None) -> dict:
    """Max bf16 ulp, f32 exactness and run-to-run identity of one plan."""
    from slam_llm_tpu_torch.ops.quant import int8_matmul, int8_matmul_ref

    xq, wq, xs, ws = operands(m, k, n, gen)
    out = int8_matmul(xq, wq, xs, ws, torch.bfloat16, plan=plan)
    again = int8_matmul(xq, wq, xs, ws, torch.bfloat16, plan=plan)
    out32 = int8_matmul(xq, wq, xs, ws, torch.float32, plan=plan)
    torch.cuda.synchronize()
    ref = int8_matmul_ref(xq, wq, xs, ws, torch.bfloat16)
    ulp = (out.view(torch.int16).int() - ref.view(torch.int16).int()).abs().max().item()
    return dict(ulp=ulp, f32_exact=bool(torch.equal(out32, int8_matmul_ref(xq, wq, xs, ws, torch.float32))),
                deterministic=bool(torch.equal(out, again)))


def alternatives(m: int, k: int, n: int, sms: int):
    from slam_llm_tpu_torch.ops.quant import K_SLICE, SPLITK_MAX_SPLITS, Int8Plan, _divisors, plan_int8_matmul

    plan = plan_int8_matmul(m, n, k, sms)
    tiles = [plan.tile] + ([(16,) + plan.tile[1:]] if plan.path == "splitk" and plan.tile[0] > 16 else [])
    for tile in tiles:
        for d in _divisors(-(-k // K_SLICE)):
            if d <= (SPLITK_MAX_SPLITS if plan.path == "splitk" else 4) and (tile, d) != (plan.tile, plan.splits):
                yield Int8Plan(plan.path, tile, d)


def main(argv) -> int:
    import chip_smoke as cs
    from slam_llm_tpu_torch.kernels.build import sm_count
    from slam_llm_tpu_torch.ops.quant import int8_matmul, plan_int8_matmul

    smi = cs.setup()
    cs.build()
    sms = sm_count(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, failed = [], []
    for m, k, n in EDGES + SHAPES:
        plan = plan_int8_matmul(m, n, k, sms)
        res = check(m, k, n, gen)
        row = dict(m=m, k=k, n=n, path=plan.path, tile=plan.tile, splits=plan.splits, **res)
        alts = list(alternatives(m, k, n, sms))
        for alt in alts:
            r = check(m, k, n, gen, alt)
            if not (r["ulp"] <= 1 and r["f32_exact"] and r["deterministic"]):
                failed.append((m, k, n, alt.splits, r))
        if not (res["ulp"] <= 1 and res["f32_exact"] and res["deterministic"]):
            failed.append((m, k, n, res))
        if "--check-only" not in argv and (m, k, n) in SHAPES:
            xq, wq, xs, ws = operands(m, k, n, gen)
            # decode M: every call meets its weight cold in L2, as a decode step does
            row["cold_weights"] = m <= 32
            wqs = cs.cold(wq) if m <= 32 else itertools.repeat(wq)
            row["ms"] = cs.time_ms(lambda: int8_matmul(xq, next(wqs), xs, ws))
            row["bound_ms"], row["bound_by"] = bound_ms(m, k, n)
            row["share"] = row["bound_ms"] / row["ms"]
            row["others"] = {f"{alt.tile[0]}x{alt.splits}": cs.time_ms(lambda: int8_matmul(xq, next(wqs), xs, ws, plan=alt))
                             for alt in alts}
            xb = xq.bfloat16()
            wbs = cs.cold(wq.bfloat16()) if m <= 32 else itertools.repeat(wq.bfloat16())
            row["bf16_ms"] = cs.time_ms(lambda: xb @ next(wbs).T)
            row["int_mm_ms"] = cs.time_ms(lambda: torch._int_mm(xq, next(wqs).t())) if m > 16 else None
        rows.append(row)
        print(json.dumps(row), flush=True)
    from slam_llm_tpu_torch.tools.profile_decode import OUT

    OUT.mkdir(exist_ok=True)
    (OUT / "bench_k3.json").write_text(json.dumps(dict(card=smi, rows=rows), indent=1))
    print(smi)
    if failed:
        print(f"FAILED: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
