"""K1 f32 and K4 f32 at head_dim 192 / 256 on their two f32 routes, for one
card: the CUDA-core FMA kernels that take these widths
(``csrc/flash_attention_f32.cu`` / ``_bwd_f32.cu``, namespace ``fma``) and
the panel route's FMA kernels (``csrc/flash_attention_wide.cu``), which take
any D % 64 == 0 but run only above 256 on the main path.

    python -m slam_llm_tpu_torch.tools.bench_panel_f32 [repeats]   # from a checkout's root, on a GPU

At ``chip_smoke.py``'s f32 D 192 / 256 rows (phase 3's ``ROUTES_F32_CASES``)
it times each call by CUDA-graph replay (``chip_smoke.time_ms``) in the
order FMA, panels, panels, FMA, ``repeats`` times (default 2), checks that
the two routes agree (forward within 2e-5 of the largest entry, backward by
``bwd_f32_error``) and prints one JSON line: the card's name and power
limit, and per shape and kernel the times in ms of both routes.
"""

from __future__ import annotations

import json
import sys

import torch


def main(repeats: int = 2) -> dict:
    import chip_smoke as cs
    from slam_llm_tpu_torch.ops.kernels import flash_attention as fa

    smi = cs.setup()
    cs.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {"card": smi, "K1 f32": {}, "K4 f32": {}}
    for name, b, t, h, hkv, d, causal, pad, theta in cs.ROUTES_F32_CASES:
        if d not in (192, 256):
            continue
        tq, tk = cs._tq_tk(t)
        q = torch.randn(b, tq, h, d, generator=gen, device="cuda")
        k, v = (torch.randn(b, tk, hkv, d, generator=gen, device="cuda") for _ in range(2))
        dout = torch.randn(b, tq, h, d, generator=gen, device="cuda")
        mask = cs._padding_mask(b, tk, pad)
        rope = cs._rope_for(mask, d, theta) if theta else None
        out, lse = fa.flash_attention_fwd_f32(q, k, v, mask, causal, rope=rope)
        p_out, p_lse = fa.flash_attention_fwd_wide_f32(q, k, v, mask, causal, rope=rope)
        fwd_err = ((p_out - out).abs().max() / out.abs().max()).item()
        want = fa.flash_attention_bwd_f32(q, k, v, mask, out, lse, dout, causal, rope=rope)
        got = fa.flash_attention_bwd_wide_f32(q, k, v, mask, out, lse, dout, causal, rope=rope)
        bwd_err = fa.bwd_f32_error(got, want, q, k, v, dout)
        if not (fwd_err <= 2e-5 and bwd_err <= 2e-5):
            raise AssertionError(f"{name}: the panel route against the FMA route: forward {fwd_err}, "
                                 f"backward {bwd_err} (limit 2e-5)")
        routes = {
            "K1 f32": (lambda: fa.flash_attention_fwd_f32(q, k, v, mask, causal, rope=rope),
                       lambda: fa.flash_attention_fwd_wide_f32(q, k, v, mask, causal, rope=rope)),
            "K4 f32": (lambda: fa.flash_attention_bwd_f32(q, k, v, mask, out, lse, dout, causal, rope=rope),
                       lambda: fa.flash_attention_bwd_wide_f32(q, k, v, mask, out, lse, dout, causal, rope=rope)),
        }
        key = f"{name} {(b, t, h, hkv, d)}"
        for kind, (fma, panels) in routes.items():
            times = {"fma": [], "panels": []}
            for _ in range(repeats):
                for route, fn in (("fma", fma), ("panels", panels), ("panels", panels), ("fma", fma)):
                    times[route].append(round(cs.time_ms(fn, reps=3), 5))
            res[kind][key] = dict(times, agreement=fwd_err if kind == "K1 f32" else bwd_err)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
