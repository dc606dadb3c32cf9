"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. setup   -- card name and power limit, versions, TF32 off, CUDA required;
  2. build   -- compile the port's CUDA kernels (csrc/*.cu) for sm_90a;
  3. kernels -- each kernel against its plain PyTorch twin on the card, with
                its time beside the twin's: at the shapes the batch-decode
                path launches (prompt bucket T = 512, so M = 4096 rows at
                prefill and 32 beam rows at decode), plus ragged,
                left-padded and D = 128 cases the path does not reach;
  4. slice   -- the recipe examples/asr_librispeech/conf/asr_whisper_tinyllama.yaml
                through slam_llm_tpu_torch.pipeline.inference_batch on 16
                synthetic utterances (whisper-small, TinyLlama-1.1B int8 base,
                beam 4, 200 new tokens, random weights from the recipe's
                seed), with kernel launch counts, a prefill-logit check
                against the CPU plain path, and throughput.

Prints one JSON line of kernel results before the last line, and as the last
line {"ok": true, "device": {...}}. Exits non-zero, printing no result, when
anything fails or no CUDA device is present.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
RECIPE = ROOT / "examples" / "asr_librispeech" / "conf" / "asr_whisper_tinyllama.yaml"


def log(*args):
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------


def setup() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    try:
        import yaml  # noqa: F401

        has_yaml = True
    except ImportError:
        has_yaml = False
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"yaml {'present' if has_yaml else 'missing'} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def build() -> None:
    from slam_llm_tpu_torch.kernels import build as kb

    t0 = time.perf_counter()
    path = kb.build()
    kb.library()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {kb.build_seconds if kb.build_seconds is not None else 'cached'} s)")
    log_file = path.with_suffix(".log")
    if log_file.exists():
        for line in log_file.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("  " + line.strip())


# ---------------------------------------------------------------------------
# phase 3: kernels vs their plain twins
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int = 10) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph, the
    replay timed with CUDA events (median of three). Without the graph, a
    call shorter than its host-side launch (~35 us for a ctypes wrapper)
    would time the host instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    times = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    return float(np.median(times))


def host_ms(fn, calls: int = 50) -> float:
    """Wall time per eager call, launch cost included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1000 * (time.perf_counter() - t0) / calls


def check_flash(gen) -> dict:
    from slam_llm_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_fwd,
        flash_attention_ref,
    )

    dev = "cuda"
    cases = [
        # (name, B, T, H, Hkv, D, causal, padding)
        ("whisper-small self-attn", 8, 1500, 12, 12, 64, False, "right"),
        ("tinyllama prefill, the slice's bucket", 8, 512, 32, 4, 64, True, "none"),
        ("tinyllama prefill, left-padded", 8, 448, 32, 4, 64, True, "left"),
        ("head_dim 128", 2, 512, 32, 32, 128, True, "left"),
    ]
    worst, first = 0.0, None
    for name, b, t, h, hkv, d, causal, pad in cases:
        q = torch.randn(b, t, h, d, generator=gen, device=dev).bfloat16()
        k = torch.randn(b, t, hkv, d, generator=gen, device=dev).bfloat16()
        v = torch.randn(b, t, hkv, d, generator=gen, device=dev).bfloat16()
        mask = torch.ones(b, t, dtype=torch.int32, device=dev)
        for i in range(b):
            n_pad = (i * 37) % (t // 3)
            if pad == "right":
                mask[i, t - n_pad:] = 0
            elif pad == "left":
                mask[i, :n_pad] = 0
        out, lse = flash_attention_fwd(q, k, v, mask, causal)
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_ref(q.float(), k.float(), v.float(), mask, causal)
        if causal:
            live = torch.ones(b, t, dtype=torch.bool, device=dev)
            live &= mask.cumsum(1) > 0  # left padding + causal: rows before the first key are dead
        else:
            live = (mask.sum(1, keepdim=True) > 0).expand(b, t)
        err = (out.float() - ref).abs().max().item()
        lse_err = (lse - ref_lse)[live].abs().max().item()
        dead = out[~live]
        dead_ok = bool((dead == 0).all().item()) if dead.numel() else True
        n_dead = int((~live).sum().item())
        ms = time_ms(lambda: flash_attention_fwd(q, k, v, mask, causal))
        plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, mask, causal), reps=3)
        log(f"[K1] {name} {(b, t, h, hkv, d)} causal={causal}: max|out-ref| {err:.3e} "
            f"max|lse-ref| {lse_err:.3e} dead rows {n_dead} all-zero {dead_ok} | "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        if not (err <= 2e-2 and lse_err <= 1e-3 and dead_ok):
            raise AssertionError(f"K1 {name}: out err {err} (tol 2e-2), lse err {lse_err} "
                                 f"(tol 1e-3), dead rows zero {dead_ok}")
        worst = max(worst, err)
        if first is None:
            first = dict(ms=ms, plain_ms=plain_ms, at=f"{name} {(b, t, h, hkv, d)}")
    return dict(max_abs_err=worst, **first)


def check_rowquant(gen) -> dict:
    from slam_llm_tpu_torch.ops.kernels.rowquant import rowquant, rowquant_ref

    dev = "cuda"
    worst, first = 0.0, None
    # prefill (M = 4096) and beam decode (M = 32) shapes first, then others
    for m, k in ((4096, 2048), (4096, 5632), (32, 2048), (32, 5632), (3584, 2048), (1337, 5632),
                 (3, 2056)):
        x = torch.randn(m, k, generator=gen, device=dev) * 3
        x[0] = 0.0  # all-zero row
        # exact .5 ties after scaling: amax 127 gives s == 1, so x/s == x
        x[1] = torch.arange(k, device=dev).remainder(254).sub(127).float() + 0.5
        x[1, 0] = 127.0
        x = x.bfloat16()
        q, s = rowquant(x)
        torch.cuda.synchronize()
        rq, rs = rowquant_ref(x)
        exact = bool(torch.equal(q, rq) and torch.equal(s, rs))
        err = (q.int() - rq.int()).abs().max().item()
        ms = time_ms(lambda: rowquant(x))
        plain_ms = time_ms(lambda: rowquant_ref(x))
        log(f"[K2] ({m}, {k}) bf16: bit-exact {exact} | kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"| eager call with launch {host_ms(lambda: rowquant(x)):.4f} ms")
        if not exact:
            raise AssertionError(f"K2 ({m}, {k}) not bit-exact: max |q - ref| {err}")
        worst = max(worst, float(err))
        if first is None:
            first = dict(ms=ms, plain_ms=plain_ms, at=f"({m}, {k}) bf16")
    return dict(max_abs_err=worst, **first)


def check_int8_matmul(gen) -> dict:
    from slam_llm_tpu_torch.ops.quant import int8_matmul, int8_matmul_ref

    dev = "cuda"
    worst, first = 0.0, None
    for m in (4096, 32, 8, 3584):
        for k, f in ((2048, 2048), (2048, 256), (2048, 5632), (5632, 2048)):
            xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
            wq = torch.randint(-127, 128, (f, k), generator=gen, device=dev, dtype=torch.int8)
            xs = torch.rand(m, generator=gen, device=dev) * 0.05 + 1e-3
            ws = torch.rand(f, generator=gen, device=dev) * 0.01 + 1e-4
            out = int8_matmul(xq, wq, xs, ws, torch.bfloat16)
            torch.cuda.synchronize()
            ref = int8_matmul_ref(xq, wq, xs, ws, torch.bfloat16)
            ulp = (out.view(torch.int16).int() - ref.view(torch.int16).int()).abs().max().item()
            err = (out.float() - ref.float()).abs().max().item()
            ms = time_ms(lambda: int8_matmul(xq, wq, xs, ws, torch.bfloat16))
            plain_ms = time_ms(lambda: int8_matmul_ref(xq, wq, xs, ws, torch.bfloat16), reps=3)
            xb, wb = xq.bfloat16(), wq.bfloat16()
            bf16_ms = time_ms(lambda: xb @ wb.T)
            log(f"[K3] M={m} K={k} F={f}: max ulp {ulp} max abs {err:.3e} | kernel {ms:.4f} ms "
                f"plain(f64) {plain_ms:.4f} ms bf16 matmul {bf16_ms:.4f} ms | eager call with launch "
                f"{host_ms(lambda: int8_matmul(xq, wq, xs, ws, torch.bfloat16)):.4f} ms")
            if ulp > 1:
                raise AssertionError(f"K3 M={m} K={k} F={f}: {ulp} bf16 ulps from the reference")
            worst = max(worst, err)
            if m == 4096 and k == 2048 and f == 5632:
                first = dict(ms=ms, plain_ms=plain_ms, at=f"M={m} K={k} F={f}")
    return dict(max_abs_err=worst, **first)


def check_kernels() -> list:
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = [
        dict(name="flash_attention_fwd", route="cuda",
             source="slam_llm_tpu_torch/csrc/flash_attention.cu",
             replaces="slam_llm_tpu/ops/kernels/flash_attention.py:522", **check_flash(gen)),
        dict(name="rowquant", route="cuda", source="slam_llm_tpu_torch/csrc/rowquant.cu",
             replaces="slam_llm_tpu/ops/kernels/rowquant.py:186", **check_rowquant(gen)),
        dict(name="int8_matmul", route="cuda", source="slam_llm_tpu_torch/csrc/int8_matmul.cu",
             replaces="slam_llm_tpu/ops/quant.py:116", **check_int8_matmul(gen)),
    ]
    torch.cuda.synchronize()
    return results


# ---------------------------------------------------------------------------
# phase 4: the batch-decode slice
# ---------------------------------------------------------------------------


def write_corpus(root: Path, n: int = 16, seed: int = 0) -> Path:
    """n synthetic 16 kHz wavs of 2-10 s (tone + noise) and a jsonl manifest."""
    import wave

    rng = np.random.default_rng(seed)
    manifest = root / "test.jsonl"
    with open(manifest, "w") as f:
        for i in range(n):
            seconds = 2.0 + 8.0 * i / (n - 1)
            t = np.arange(int(seconds * 16000)) / 16000
            x = 0.3 * np.sin(2 * np.pi * (200 + 50 * i) * t) + 0.02 * rng.standard_normal(t.size)
            path = root / f"utt{i}.wav"
            with wave.open(str(path), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes((x * 32767).astype("<i2").tobytes())
            f.write(json.dumps({"key": f"utt{i}", "source": str(path), "target": f"utterance {i}"}) + "\n")
    return manifest


def kernel_counters():
    from slam_llm_tpu_torch.ops import quant
    from slam_llm_tpu_torch.ops.kernels import flash_attention, rowquant

    return {
        "flash_attention_fwd": flash_attention.flash_attention_fwd,
        "rowquant": rowquant.rowquant,
        "int8_matmul": quant.int8_matmul,
    }


def check_prefill_against_cpu(cfg) -> None:
    """Prefill logits of the first batch on the card (finite), and of its
    first utterance against the CPU plain path with the same weights and dtype."""
    from slam_llm_tpu_torch.models.llm import init_kv_cache
    from slam_llm_tpu_torch.pipeline.common import build_model_and_data, materialize_params
    from slam_llm_tpu_torch.pipeline.inference_batch import decode_loader

    model, _, dataset = build_model_and_data(cfg, split=cfg.dataset_config.test_split, device="cuda")
    materialize_params(model.eval(), cfg)
    batch = next(iter(decode_loader(cfg, dataset)))
    keys = ("input_ids", "attention_mask", "modality_mask", "audio_mel", "audio_mel_mask")

    def run(m, rows, device):
        b = {k: torch.as_tensor(batch[k][rows]).to(device) for k in keys}
        bsz, t = b["input_ids"].shape
        cache = init_kv_cache(m.cfg.llm, bsz, t + 1, gen_start=t, device=device)
        with torch.inference_mode():
            logits, _ = m.prefill(b, cache)
        return logits.float().cpu(), b["attention_mask"].bool().cpu()

    logits, _ = run(model, slice(None), "cuda")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite prefill logits on the card")
    log(f"[slice] prefill logits {tuple(logits.shape)} finite")
    gpu, mask = run(model, slice(0, 1), "cuda")
    t0 = time.perf_counter()
    cpu, _ = run(model.to("cpu"), slice(0, 1), "cpu")
    cpu_s = time.perf_counter() - t0
    g, c = gpu[mask], cpu[mask]  # (valid positions, V)
    cos = torch.nn.functional.cosine_similarity(g, c, dim=-1)
    agree = (g.argmax(-1) == c.argmax(-1)).float().mean().item()
    log(f"[slice] utterance 0 prefill logits, card vs CPU plain path ({cpu_s:.1f} s on CPU): "
        f"min cosine {cos.min().item():.5f} mean {cos.mean().item():.5f} argmax agreement {agree:.4f} "
        f"max |diff| {(g - c).abs().max().item():.4f}")
    if cos.min().item() < 0.99:
        raise AssertionError(f"prefill logits cosine {cos.min().item()} < 0.99 against the CPU path")


def run_slice() -> None:
    from slam_llm_tpu_torch.pipeline import inference_batch

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    manifest = write_corpus(tmp)
    cfg = inference_batch.load_run_config([
        "--config", str(RECIPE),
        f"++dataset_config.train_data_path={manifest}",
        f"++dataset_config.val_data_path={manifest}",
        f"++decode_config.decode_log={tmp / 'decode'}",
    ])
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = inference_batch.main(cfg, device="cuda")
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    preds = Path(res["pred"]).read_text().splitlines()
    log(f"[slice] {res['n']} utterances, {len(preds)} pred lines, launches {launches}")
    log(f"[slice] wall {wall:.2f} s (model build + init + decode), decode loop {res['seconds']:.2f} s, "
        f"prefill {1000 * res['prefill_s'] / res['calls']:.1f} ms/batch, "
        f"decode {1000 * res['decode_s'] / max(res['decode_steps'], 1):.2f} ms/step over "
        f"{res['decode_steps']} steps, {res['generated_tokens']} tokens, "
        f"{res['generated_tokens'] / res['seconds']:.1f} tokens/s, RTF {res['rtf']:.4f} "
        f"({res['audio_seconds']:.1f} s of audio), peak memory {peak / 2**30:.2f} GiB")
    print("\n".join(preds[:3]))
    if res["n"] != 16 or len(preds) != 16:
        raise AssertionError(f"expected 16 decoded utterances, got {res['n']} / {len(preds)} lines")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    check_prefill_against_cpu(cfg)
    return launches


def main() -> int:
    setup()
    build()
    results = check_kernels()
    launches = run_slice()
    for r in results:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
