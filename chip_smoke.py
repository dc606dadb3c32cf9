"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. setup   -- card name and power limit, versions, TF32 off, CUDA required;
  2. build   -- compile the port's CUDA kernels (csrc/*.cu, one nvcc per
                source, in parallel) for sm_90a;
  3. kernels -- first the wgmma operand layouts K1 and K4 rest on, on one
                tile each; then each kernel against its plain PyTorch twin on
                the card, with
                its time beside the twin's, its bound (operations or bytes at
                the card's peak) and share of it, and the library call that
                computes the same function where there is one (SDPA forward
                and backward; torch._int_mm and bf16 cuBLAS for K3, with the
                weight cold in L2 at decode M) or, for fused-RoPE and
                left-padded flash calls, the nearest one, labelled as such
                (SDPA on q / k rotated beforehand with the equivalent boolean
                mask), at the shapes the two paths
                launch: K1 flash forward (whisper-small; TinyLlama prefill;
                the training path with fused RoPE), K1's f32 route
                (Spatial-AST-base's (16 / 8, 515, 12/12, 64), ragged,
                causal, D = 128; within 2e-5 of the f32 twin, the twin under
                single-pass TF32 beside it), K4 flash backward (the
                training shape (16, 512, 32/4, 64) with fused RoPE, and a
                whisper-like shape), K4's f32 route (Spatial-AST-base's
                training shape (16, 515, 12/12, 64), ragged, causal
                left-padded, GQA D = 128 causal; within 2e-5 of the f32
                twin's largest entry, deterministic, SDPA's f32 backward
                beside it), K2 rowquant (deterministic, and rotate +
                stochastic rounding at the int8_rot dy shapes, bit-exact; fold,
                deterministic and stochastic, at the int8_sr dy shapes and the
                int8 CE head's f32 dlog, bit-exact), K3 s8 GEMM (prefill,
                decode, dx and transposed-weight dx shapes, the planner's
                wgmma or split-K plan for each, run-to-run identical, and the
                f32 epilogue of the int8 CE head's logits, bit-exact), plus
                ragged, left-padded and D = 128 cases; phases 14-15 add K1 at
                AV-HuBERT-large's (8, 50 / 100 / 150, 16/16, 64), at
                whisper-large-v3's unpadded (42 / 21, 500 / 496, 20/20, 64)
                and K1 / K4 at vicuna-7b's and Qwen2-7B's batches there;
  4. decode  -- the recipe examples/asr_librispeech/conf/asr_whisper_tinyllama.yaml
                through slam_llm_tpu_torch.pipeline.inference_batch on 16
                synthetic utterances (whisper-small, TinyLlama-1.1B int8 base,
                beam 4, 200 new tokens, random weights from the recipe's
                seed), with kernel launch counts (K3's split-K path must
                run), a prefill-logit check
                against the CPU plain path, and throughput;
  5. train   -- the same recipe through slam_llm_tpu_torch.pipeline.finetune
                (frozen whisper-small, trained projector, TinyLlama-1.1B int8
                base with LoRA r8 on q/v, int8_rot backward, batch 16) for a
                few steps on synthetic utterances, with validation and the
                trainable-only checkpoint, with the recipe's activation
                checkpointing (remat, dots_flash_saveable); step time,
                throughput, peak memory and launches per kernel, and the same
                step time and peak memory from a short run with remat off;
                then the trainable gradients of one utterance on the card
                against the CPU plain path;
  6. modes   -- the same recipe through pipeline.finetune with the int8_sr
                backward, the int8_sr CE head, anyprecision, gradient
                accumulation 2, full-state checkpoints and the validation
                decode of one wav: 8 micro-steps, a resume from the
                checkpoint for 2 more, and the card-vs-CPU gradient check;
  7. weights -- the recipe from pretrained-shaped weights: whisper-small and
                TinyLlama-1.1B written as random bf16 HF directories (with a
                32000-entry Llama tokenizer.json) by tools/synth_checkpoint;
                pipeline.finetune from them (batch 16, int8_rot, remat,
                model.pt); the loaded int8 base, embedding and norms against
                the written tensors and the derived int8_rot buffers;
                pipeline.inference_batch with ckpt_path on 16 utterances,
                whose trainable tensors equal the trained ones and whose
                decoded text equals the in-memory trained model's; the port's
                WER over the logs; export_llama read back and a merged q_proj
                checked;
  8. st      -- the speech-translation recipe
                examples/st_covost2/conf/st_whisper_qwen.yaml at full width
                (whisper-large-v3, the Q-Former with 80 queries and 8 layers,
                Qwen2-7B in bf16; random weights from the recipe's seed and a
                qwen2-layout ByteLevel tokenizer written by
                tools/synth_checkpoint): pipeline.finetune for 4 steps of 8
                utterances with the recipe's remat (every Q-Former tensor
                moved, every encoder and LLM tensor bit-unchanged);
                pipeline.inference_batch with ckpt_path (16 utterances, beam
                4) against the in-memory trained model's decode; BLEU through
                tools/eval_werbleu; the prefill logits and every Q-Former
                gradient of one utterance against the CPU plain path at 2 LLM
                and 2 encoder layers;
  9. wavlm   -- the WavLM recipe examples/asr_librispeech/conf/asr_wavlm_vicuna.yaml
                at full width (WavLM-large written as a random bf16 HF
                directory by tools/synth_checkpoint and loaded through
                encoder_path, the linear projector, vicuna-7b's seeded random
                init in the int8 base with the bf16 backward, a synthetic
                32000-entry Llama tokenizer): pipeline.finetune for 4 steps of
                16 utterances (the projector moves; the encoder, the int8
                base, its scales, the embedding, the head and the norms stay
                bit-unchanged; K2 / K3 launch at 4096 and 11008 wide, K4 once
                a layer a step); pipeline.inference_batch with ckpt_path
                (beam 4, batches of 8) against the in-memory trained model's
                decode, RTF from the raw audio_mask, WER; the prefill logits
                and projector gradients of one utterance against the CPU
                plain path at 2 LLM and 2 encoder layers; and the whole
                WavLM-large, hubert-large and emotion2vec-base encoders on two
                ragged utterances against the CPU f32 plain path (K1 once a
                layer for the last two, whose attention takes no rel-pos
                bias; these runs count on the wavlm path);
 10. aac     -- aac_eat_vicuna and SLAM-AAC (EAT-base + linear + vicuna-7b in
                bf16, LoRA r8 for SLAM-AAC) through both entry points at full
                width (run_aac);
 11. clap    -- the CLAP recipes at full width (run_clap): HTSAT-base +
                BERT-base CLAP from a reference-layout file; SLAM-AAC's decode
                of phase 10's clips with 4 candidates a key, reranked by
                utils.clap_refine and scored with the caption metrics and
                FENSE; DRCap (drcap.yaml: CLAP latents + linear + vicuna-7b):
                a caption store, a RAG manifest, training steps through the
                trainer's step (K1 = K4 = 32 a step, K2 = K3 = 0), the decode
                from projection-decoded audio latents; the card against the
                CPU for the whole CLAP and for DRCap at 2 LLM layers.
 12. music_spatial -- three recipes with vicuna-7b in bf16, each through
                pipeline.finetune (4 steps of 16: the projector moves, the
                encoder and LLM stay bit-unchanged, K1 / K4 once a layer a
                step, K2 = K3 = 0) and pipeline.inference_batch with ckpt_path
                (beam 4, batches of 8, 32 tokens) against the in-memory
                decode, the card vs the CPU at 2 + 2 layers, the loss within
                1 % (run_music_spatial):
                SELD (seld_spatialast_llama: Spatial-AST-base f32 from a
                BAT-layout file, its 12 layers on K1's f32 route, the
                64-query Q-Former, on spatialised 10 s clips; the whole
                encoder against the CPU f32 path, cosine >= 0.99999); MC
                (mc_musicfm_vicuna: MusicFM-MSD bf16, linear ds 5, on 10 s
                crops of 24 kHz clips; the whole MusicFM against the CPU,
                cosine >= 0.999); SEC (sec_emotion2vec_vicuna on raw 16 kHz
                audio, then 2 steps of its E-chat variant from one dialog
                TSV, validating on its 10 %).
 13. seld_encoder -- SELD with ++train_config.freeze_encoder=false on phase
                12's Spatial-AST-base file and corpus (run_seld_encoder):
                pipeline.finetune for 4 steps of 16 (every Spatial-AST and
                Q-Former tensor moves, vicuna-7b stays bit-unchanged, K1's
                and K4's f32 routes 12 times a step), the encoder's forward
                + backward share of the step, pipeline.inference_batch with
                encoder_path then ckpt_path against the in-memory decode,
                and the card vs the CPU at 2 + 2 layers (loss within 1 %,
                every encoder tensor's gradient; the Q-Former's logged).
 14. vsr     -- vsr_avhubert_vicuna at full width (run_vsr): a random
                AV-HuBERT-large file in fairseq's layout through encoder_path
                (BatchNorms folded at load), the recipe's own file: spec,
                which the registry resolves to the port's dataset; the card's
                host has no OpenCV, so the dataset's video reader is replaced
                in-process by one of seeded .npy frames (the crop, flip and
                normalization stay the port's); video-only 2-6 s clips;
                pipeline.finetune for 4 steps of 8 (the projector moves, the
                encoder and vicuna-7b bf16 stay bit-unchanged, K1 56 / K4 32
                a step), pipeline.inference_batch with ckpt_path (beam 4)
                against the in-memory decode, the RTF from visual_mask at 25
                fps, the card vs the CPU at 2 + 2 layers; the whole
                AV-HuBERT-large on two ragged clips, video only and audio +
                video, against the CPU f32 path (cosine >= 0.999).
 15. large_scale -- aispeech_large_scale at full width (run_large_scale):
                whisper-large-v3 (128 mels, unpadded) + linear + Qwen2-7B bf16
                on a wav-ark corpus with hotword prompt pools; the refusal of
                pipeline.finetune for the iterable dataset (as in the JAX
                package); the batcher's first two 42 x 192 batches through the
                trainer's step at accumulation 2, twice (the first update's
                lr is 0), the first 21 x 192 eval batch through the
                Generator, the card vs the CPU at 2 + 2 layers; then
                contextual_wavlm_vicuna and mala_wavlm_vicuna at 2 + 2 layers
                of WavLM-large + vicuna-7b on the raw-audio batches: a step,
                a decode, the card vs the CPU.

Prints one JSON line of kernel results before the last line, and as the last
line {"ok": true, "device": {...}}. Exits non-zero, printing no result, when
anything fails or no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import itertools
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
            if any(w in line for w in ("registers", "spill", "Compiling entry", "warning")):
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


# the H100 SXM's published dense peaks (the card's power limit is logged in phase 1)
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12  # f32 FMA on the CUDA cores
TF32X3_FLOPS = 495e12 / 3  # f32-accurate products as 3-pass split TF32 on the tensor cores (the f32 routes)
INT8_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12


L2_BYTES = 50 * 2**20


def cold(t: torch.Tensor):
    """Copies of ``t`` visited in turn, enough of them that a call finds its
    copy evicted from the 50 MB L2: the way a decode step meets each layer's
    weight once. Pass ``next(it)`` inside the timed function."""
    n = max(2, -(-(L2_BYTES + (16 << 20)) // nbytes(t)))
    return itertools.cycle([t.clone() for _ in range(n)])


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(ops: float, moved: int, rate: float):
    """(least time in ms, what bounds it): the operations at the card's peak
    ``rate`` for their type, or the bytes moved (each input read once, each
    output written once) at its memory rate, the larger."""
    t_ops, t_bytes = ops / rate, moved / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def event_ms(fn, reps: int = 10) -> float:
    """Device time per call of a library call that a CUDA graph cannot hold
    (an autograd backward): CUDA events around ``reps`` eager calls, median
    of three, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def attended_pairs(mask, causal: bool) -> int:
    """(query, key) pairs the attention computes for this key mask: every
    query against each live key, or only keys at or before it when causal."""
    live = mask.bool()
    t = mask.shape[1]
    if causal:
        return int((live * torch.arange(t, 0, -1, device=mask.device)).sum().item())
    return int(live.sum().item()) * t


def _padding_mask(b, t, pad, dev="cuda"):
    mask = torch.ones(b, t, dtype=torch.int32, device=dev)
    for i in range(b):
        n_pad = (i * 37) % max(1, t // 3)
        if pad in ("right", "both"):
            mask[i, t - n_pad // (2 if pad == "both" else 1):] = 0
        if pad in ("left", "both"):
            mask[i, :n_pad] = 0
    return mask


def _rope_for(mask, d, theta):
    from slam_llm_tpu_torch.models.layers import rope_tables

    return rope_tables((mask.long().cumsum(1) - 1).clamp_min(0), d, theta)


# the library call nearest to a fused-RoPE or left-padded flash call: SDPA on
# q / k rotated beforehand, with the equivalent boolean (key mask x causal)
# mask; it is not the same function on the same inputs, so it is reported
# beside library_ms, never as it
NEAR = "SDPA, RoPE applied before, boolean mask"


def _r(x):
    return x if x is None else round(x, 4)


def _bool_mask(mask, causal: bool):
    t = mask.shape[1]
    valid = mask.bool()[:, None, None, :]
    if causal:
        valid = valid & torch.ones(t, t, dtype=torch.bool, device=mask.device).tril()
    return valid


def check_wgmma_layouts(gen) -> None:
    """The operand layouts K1 and K4 rest on, on one tile each (the card
    tests' probe): S = Q K^T from K-major panels, O = bf16(S) V with S as
    the register fragment and V MN-major."""
    from slam_llm_tpu_torch.kernels.build import check, library, stream_ptr

    for d, n in ((64, 64), (64, 128), (128, 64), (128, 128)):
        q, k, v = (torch.randn(r, d, generator=gen, device="cuda").bfloat16() for r in (64, n, n))
        s, o = torch.empty(64, n, device="cuda"), torch.empty(64, d, device="cuda")
        check(library().slam_wgmma_probe(q.data_ptr(), k.data_ptr(), v.data_ptr(), s.data_ptr(), o.data_ptr(),
                                         d, n, stream_ptr(q)), "wgmma probe")
        torch.cuda.synchronize()
        want_s = q.float() @ k.float().T
        want_o = s.bfloat16().float() @ v.float()
        es = ((s - want_s).abs().max() / want_s.abs().max()).item()
        eo = ((o - want_o).abs().max() / want_o.abs().max()).item()
        log(f"[wgmma layouts] D={d} N={n}: S rel err {es:.2e}, O rel err {eo:.2e}")
        if not (es <= 1e-3 and eo <= 1e-4):
            raise AssertionError(f"wgmma layout probe D={d} N={n}: S {es}, O {eo}")


def check_flash(gen) -> dict:
    from slam_llm_tpu_torch.ops.kernels.flash_attention import (
        apply_rope_tables,
        flash_attention_fwd,
        flash_attention_ref,
    )

    dev = "cuda"
    cases = [
        # (name, B, T, H, Hkv, D, causal, padding, fused RoPE's theta or 0)
        ("whisper-small self-attn", 8, 1500, 12, 12, 64, False, "right", 0),
        ("tinyllama prefill, the slice's bucket", 8, 512, 32, 4, 64, True, "none", 0),
        ("tinyllama training, fused RoPE, left-padded", 16, 512, 32, 4, 64, True, "left", 1e4),
        ("tinyllama prefill, left-padded", 8, 448, 32, 4, 64, True, "left", 0),
        ("head_dim 128", 2, 512, 32, 32, 128, True, "left", 0),
        # the ST recipe: whisper-large-v3's encoder (30 s of mel, unpadded),
        # the Q-Former's self-attention, qwen2-7b's training and prefill
        ("whisper-large-v3 self-attn", 8, 1500, 20, 20, 64, False, "none", 0),
        ("Q-Former self-attn", 8, 80, 12, 12, 64, False, "none", 0),
        ("qwen2-7b training, fused RoPE theta 1e6, left-padded", 8, ST_T, 28, 4, 128, True, "left", 1e6),
        ("qwen2-7b prefill, left-padded", 8, ST_PREFILL_T, 28, 4, 128, True, "left", 0),
        # the WavLM recipe: vicuna-7b's training and prefill, and the encoders
        # whose attention takes no rel-pos bias (phase 9's encoder check: two
        # utterances of a 10 s bucket, 160,000 samples -> 499 frames)
        *(("vicuna-7b training, fused RoPE theta 1e4, left-padded", 16, t, 32, 32, 128, True, "left", 1e4)
          for t in W_TRAIN_T),
        *(("vicuna-7b prefill, left-padded", 8, t, 32, 32, 128, True, "left", 0) for t in W_PREFILL_T),
        ("hubert-large encoder, right-padded", 2, W_ENC_T, 16, 16, 64, False, "right", 0),
        ("emotion2vec-base encoder, right-padded", 2, W_ENC_T, 12, 12, 64, False, "right", 0),
        # the AAC recipes: EAT-base at the fixed 1024-frame length (64 x 8
        # patches + CLS) in a training and a decode batch, and vicuna-7b's
        # training step at aac_eat_vicuna's text bucket
        ("EAT-base encoder, training batch", 16, AAC_ENC_T, 12, 12, 64, False, "none", 0),
        ("EAT-base encoder, decode batch", 8, AAC_ENC_T, 12, 12, 64, False, "none", 0),
        ("vicuna-7b training (aac), fused RoPE theta 1e4, left-padded", 16, AAC_TRAIN_T, 32, 32, 128, True, "left",
         1e4),
        # phase 12: MusicFM-MSD's attention over 251 frames (a training and a
        # decode batch), the 64-query Q-Former's self-attention (SELD, SEC)
        ("MusicFM-MSD encoder, training batch, right-padded", 16, MC_ENC_T, 16, 16, 64, False, "right", 0),
        ("MusicFM-MSD encoder, decode batch", 8, MC_ENC_T, 16, 16, 64, False, "none", 0),
        ("Q-Former self-attn, 64 queries, training batch", 16, 64, 12, 12, 64, False, "none", 0),
        ("Q-Former self-attn, 64 queries, decode batch", 8, 64, 12, 12, 64, False, "none", 0),
        # SEC: emotion2vec-base over 10 s / 6 s buckets (499 / 299 frames), and
        # the E-chat variant's vicuna-7b step at its 512-token bucket
        ("emotion2vec-base encoder, training batch, right-padded", 16, W_ENC_T, 12, 12, 64, False, "right", 0),
        ("emotion2vec-base encoder, decode batch, right-padded", 8, 299, 12, 12, 64, False, "right", 0),
        ("vicuna-7b training (E-chat), fused RoPE theta 1e4, left-padded", 16, ECHAT_T, 32, 32, 128, True, "left",
         1e4),
        # phase 14: AV-HuBERT-large over 2, 4 and 6 s clips (25 fps) in batches of 8, and vicuna-7b's training
        # step and prefill at the VSR batches' text bucket
        *(("AV-HuBERT-large encoder, right-padded", VSR_BATCH, t, 16, 16, 64, False, "right", 0) for t in VSR_FRAMES),
        ("vicuna-7b training (vsr), fused RoPE theta 1e4, left-padded", VSR_BATCH, VSR_T, 32, 32, 128, True, "left",
         1e4),
        ("vicuna-7b prefill (vsr), left-padded", VSR_BATCH, VSR_T, 32, 32, 128, True, "left", 0),
        # phase 15: the batcher's batches: whisper-large-v3 over the unpadded mel of a train (42) and an eval
        # (21) batch, Qwen2-7B's training step and prefill at their bucket, and vicuna-7b's (contextual /
        # MaLa-ASR) on the raw-audio batches
        *(("whisper-large-v3 (aispeech), unpadded mel, right-padded", b, t, 20, 20, 64, False, "right", 0)
          for b, t in LS_ENC_SHAPES),
        *(("qwen2-7b training (aispeech), fused RoPE theta 1e6, left-padded", b, t, 28, 4, 128, True, "left", 1e6)
          for b, t in sorted(LS_TRAIN_SHAPES)),
        *(("qwen2-7b prefill (aispeech), left-padded", b, t, 28, 4, 128, True, "left", 0)
          for b, t in sorted(LS_EVAL_SHAPES)),
        ("vicuna-7b training (contextual, mala), fused RoPE theta 1e4, left-padded", *CTX_TRAIN_SHAPE, 32, 32, 128,
         True, "left", 1e4),
        ("vicuna-7b prefill (contextual, mala), left-padded", *CTX_EVAL_SHAPE, 32, 32, 128, True, "left", 0),
    ]
    worst, rows = 0.0, []
    for name, b, t, h, hkv, d, causal, pad, theta in cases:
        fused = theta > 0
        q = torch.randn(b, t, h, d, generator=gen, device=dev).bfloat16()
        k = torch.randn(b, t, hkv, d, generator=gen, device=dev).bfloat16()
        v = torch.randn(b, t, hkv, d, generator=gen, device=dev).bfloat16()
        mask = _padding_mask(b, t, pad)
        rope = _rope_for(mask, d, theta) if fused else None
        out, lse = flash_attention_fwd(q, k, v, mask, causal, rope=rope)
        torch.cuda.synchronize()
        # the twin sees q / k rotated as the kernel rotates them (f32, one bf16 rounding)
        qr, kr = (apply_rope_tables(x, *rope) for x in (q, k)) if fused else (q, k)
        ref, ref_lse = flash_attention_ref(qr.float(), kr.float(), v.float(), mask, causal)
        if causal:
            live = mask.cumsum(1) > 0  # left padding + causal: rows before the first key are dead
        else:
            live = (mask.sum(1, keepdim=True) > 0).expand(b, t)
        err = (out.float() - ref).abs().max().item()
        lse_err = (lse - ref_lse)[live].abs().max().item()
        dead = out[~live]
        dead_ok = bool((dead == 0).all().item()) if dead.numel() else True
        n_dead = int((~live).sum().item())
        ms = time_ms(lambda: flash_attention_fwd(q, k, v, mask, causal, rope=rope))
        plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, mask, causal, rope=rope), reps=3)
        bound_ms, bound_by = bound(4 * h * d * attended_pairs(mask, causal),
                                   nbytes(q, k, v, mask, out, lse, *(rope or ())), BF16_FLOPS)
        library_ms = near_ms = None
        if pad in ("none", "right") and not fused:  # SDPA computes the same function
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            sdpa_mask = None if pad == "none" else mask[:, None, None, :].bool()
            library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=sdpa_mask, is_causal=causal and sdpa_mask is None, enable_gqa=h != hkv))
        else:  # a near yardstick only: RoPE applied before, the equivalent boolean mask
            qt, kt, vt = (x.transpose(1, 2) for x in (qr, kr, v))
            near_mask = _bool_mask(mask, causal)
            near_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=near_mask, enable_gqa=h != hkv))
        log(f"[K1] {name} {(b, t, h, hkv, d)} causal={causal}: max|out-ref| {err:.3e} "
            f"max|lse-ref| {lse_err:.3e} dead rows {n_dead} all-zero {dead_ok} | "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}) share "
            f"{bound_ms / ms:.3f} SDPA {_r(library_ms)} ms | {NEAR}: {_r(near_ms)} ms")
        if not (err <= 2e-2 and lse_err <= 1e-3 and dead_ok):
            raise AssertionError(f"K1 {name}: out err {err} (tol 2e-2), lse err {lse_err} "
                                 f"(tol 1e-3), dead rows zero {dead_ok}")
        worst = max(worst, err)
        rows.append(dict(at=f"{name} {(b, t, h, hkv, d)}", ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=library_ms, near_library_ms=near_ms))
    return dict(max_abs_err=worst, **{k: v for k, v in rows[0].items() if k != "near_library_ms"},
                near_library=NEAR, cases=rows)


# the edges of the f32 routes' tiles: 128 / 64 query rows and 64 / 32 keys
# (K1 f32, dq), 64 keys and 32 / 16 queries (dk / dv) at D = 64 / 128, and
# a single position: (B, T, H, Hkv, D, causal, padding)
F32_EDGES = [
    (2, 127, 4, 4, 64, True, "right"), (2, 128, 4, 2, 64, False, "right"), (2, 129, 4, 4, 64, True, "none"),
    (3, 1, 4, 4, 64, False, "none"), (2, 129, 4, 4, 128, False, "right"), (3, 97, 6, 3, 128, True, "left"),
]


def check_flash_f32(gen) -> dict:
    """K1's f32 route (csrc/flash_attention_f32.cu) against the f32 twin on
    the same f32 unit-normal inputs on the card (TF32 off): out within 2e-5
    abs, live-row lse within 1e-4, rows with no visible key exactly 0; the
    twin under single-pass TF32 beside it, for the margin the route exists
    for; then the edges of its tiles (``F32_EDGES``), held alone. Bound: the
    operations at the 165 TFLOP/s of 3xTF32, with the 67 TFLOP/s of f32 FMA
    (the route's bound before it ran on the tensor cores) beside it."""
    from slam_llm_tpu_torch.ops.kernels.flash_attention import flash_attention_fwd, flash_attention_ref

    dev = "cuda"
    cases = [
        # (name, B, T, H, Hkv, D, causal, padding)
        ("Spatial-AST-base encoder, training batch", 16, SA_T, 12, 12, 64, False, "none"),
        ("Spatial-AST-base encoder, decode batch", 8, SA_T, 12, 12, 64, False, "none"),
        ("ragged keys, right-padded", 8, SA_T, 12, 12, 64, False, "right"),
        ("causal, left-padded", 4, SA_T, 12, 12, 64, True, "left"),
        ("GQA, head_dim 128, causal", 2, 256, 8, 2, 128, True, "right"),
    ]
    worst, rows = 0.0, []
    for name, b, t, h, hkv, d, causal, pad in cases:
        q = torch.randn(b, t, h, d, generator=gen, device=dev)
        k = torch.randn(b, t, hkv, d, generator=gen, device=dev)
        v = torch.randn(b, t, hkv, d, generator=gen, device=dev)
        mask = _padding_mask(b, t, pad)
        out, lse = flash_attention_fwd(q, k, v, mask, causal)
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_ref(q, k, v, mask, causal)
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32, _ = flash_attention_ref(q, k, v, mask, causal)
        torch.backends.cuda.matmul.allow_tf32 = False
        live = mask.cumsum(1) > 0 if causal else (mask.sum(1, keepdim=True) > 0).expand(b, t)
        err = (out - ref).abs().max().item()
        tf32_err = (tf32 - ref).abs().max().item()
        lse_err = (lse - ref_lse)[live].abs().max().item()
        dead = out[~live]
        dead_ok = bool((dead == 0).all().item()) if dead.numel() else True
        ms = time_ms(lambda: flash_attention_fwd(q, k, v, mask, causal))
        plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, mask, causal), reps=3)
        ops, moved = 4 * h * d * attended_pairs(mask, causal), nbytes(q, k, v, mask, out, lse)
        bound_ms, bound_by = bound(ops, moved, TF32X3_FLOPS)
        fma_ms = bound(ops, moved, FP32_FLOPS)[0]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = near_ms = None
        if pad in ("none", "right") and not causal:  # SDPA computes the same function, in f32
            sdpa_mask = None if pad == "none" else mask[:, None, None, :].bool()
            library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=sdpa_mask, enable_gqa=h != hkv))
        else:
            near_mask = _bool_mask(mask, causal)
            near_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=near_mask, enable_gqa=h != hkv))
        log(f"[K1 f32] {name} {(b, t, h, hkv, d)} causal={causal}: max|out-ref| {err:.3e} (the twin under "
            f"single-pass TF32: {tf32_err:.3e}) max|lse-ref| {lse_err:.3e} dead rows {int((~live).sum())} all-zero "
            f"{dead_ok} | kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}, 3xTF32) "
            f"share {bound_ms / ms:.3f}, f32 FMA bound {fma_ms:.4f} ms share {fma_ms / ms:.3f} SDPA f32 "
            f"{_r(library_ms)} ms | SDPA f32, boolean mask (near): {_r(near_ms)} ms")
        if not (err <= 2e-5 and lse_err <= 1e-4 and dead_ok):
            raise AssertionError(f"K1 f32 {name}: out err {err} (tol 2e-5), lse err {lse_err} (tol 1e-4), dead rows "
                                 f"zero {dead_ok}")
        worst = max(worst, err)
        rows.append(dict(at=f"{name} {(b, t, h, hkv, d)}", ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=library_ms, near_library_ms=near_ms,
                         tf32_err=tf32_err))
    for b, t, h, hkv, d, causal, pad in F32_EDGES:
        q, k, v = (torch.randn(b, t, n, d, generator=gen, device=dev) for n in (h, hkv, hkv))
        mask = _padding_mask(b, t, pad)
        out, lse = flash_attention_fwd(q, k, v, mask, causal)
        ref, ref_lse = flash_attention_ref(q, k, v, mask, causal)
        live = mask.cumsum(1) > 0 if causal else (mask.sum(1, keepdim=True) > 0).expand(b, t)
        err, lse_err = (out - ref).abs().max().item(), (lse - ref_lse)[live].abs().max().item()
        if not (err <= 2e-5 and lse_err <= 1e-4 and bool((out[~live] == 0).all())):
            raise AssertionError(f"K1 f32 edge {(b, t, h, hkv, d, causal, pad)}: out err {err}, lse err {lse_err}")
        worst = max(worst, err)
    log(f"[K1 f32] {len(F32_EDGES)} tile edges {[c[1:5] for c in F32_EDGES]}: max|out-ref| within 2e-5")
    return dict(max_abs_err=worst, **{k: v for k, v in rows[0].items() if k not in ("near_library_ms", "tf32_err")},
                near_library="SDPA f32, boolean mask", cases=rows)


def check_flash_bwd(gen) -> dict:
    """K4 against the f32 twin on the kernel's own inputs (q / k rotated in
    bf16 as the kernel rotates them, dq / dk counter-rotated in f32)."""
    from slam_llm_tpu_torch.ops.kernels.flash_attention import (
        apply_rope_tables,
        flash_attention_bwd,
        flash_attention_bwd_ref,
        flash_attention_fwd,
    )

    dev = "cuda"
    cases = [
        # (name, B, T, H, Hkv, D, causal, padding, fused RoPE's theta or 0)
        ("tinyllama training, fused RoPE, left + right padded", 16, 512, 32, 4, 64, True, "both", 1e4),
        ("whisper-like, not causal, right-padded", 2, 1500, 12, 12, 64, False, "right", 0),
        ("qwen2-7b training, fused RoPE theta 1e6, left-padded", 8, ST_T, 28, 4, 128, True, "left", 1e6),
        ("Q-Former self-attn", 8, 80, 12, 12, 64, False, "none", 0),
        *(("vicuna-7b training, fused RoPE theta 1e4, left-padded", 16, t, 32, 32, 128, True, "left", 1e4)
          for t in W_TRAIN_T),
        ("vicuna-7b training (aac), fused RoPE theta 1e4, left-padded", 16, AAC_TRAIN_T, 32, 32, 128, True, "left",
         1e4),
        ("Q-Former self-attn, 64 queries (SELD, SEC training)", 16, 64, 12, 12, 64, False, "none", 0),
        ("vicuna-7b training (E-chat), fused RoPE theta 1e4, left-padded", 16, ECHAT_T, 32, 32, 128, True, "left",
         1e4),
        # phases 14-15: the trained LLMs at the VSR batches, the batcher's Qwen2-7B batches and the contextual /
        # MaLa-ASR raw-audio batches (the encoders are frozen)
        ("vicuna-7b training (vsr), fused RoPE theta 1e4, left-padded", VSR_BATCH, VSR_T, 32, 32, 128, True, "left",
         1e4),
        *(("qwen2-7b training (aispeech), fused RoPE theta 1e6, left-padded", b, t, 28, 4, 128, True, "left", 1e6)
          for b, t in sorted(LS_TRAIN_SHAPES)),
        ("vicuna-7b training (contextual, mala), fused RoPE theta 1e4, left-padded", *CTX_TRAIN_SHAPE, 32, 32, 128,
         True, "left", 1e4),
    ]
    worst, rows = 0.0, []
    for name, b, t, h, hkv, d, causal, pad, theta in cases:
        fused = theta > 0
        q = torch.randn(b, t, h, d, generator=gen, device=dev).bfloat16()
        k = torch.randn(b, t, hkv, d, generator=gen, device=dev).bfloat16()
        v = torch.randn(b, t, hkv, d, generator=gen, device=dev).bfloat16()
        dout = torch.randn(b, t, h, d, generator=gen, device=dev).bfloat16()
        mask = _padding_mask(b, t, pad)
        rope = _rope_for(mask, d, theta) if fused else None
        out, lse = flash_attention_fwd(q, k, v, mask, causal, rope=rope)
        got = flash_attention_bwd(q, k, v, mask, out, lse, dout, causal, rope=rope)
        torch.cuda.synchronize()
        qr, kr = (apply_rope_tables(x, *rope) for x in (q, k)) if fused else (q, k)
        args32 = (qr.float(), kr.float(), v.float(), mask, out.float(), lse, dout.float(), causal)
        want = flash_attention_bwd_ref(*args32)
        if fused:
            want = (apply_rope_tables(want[0], *rope, inverse=True),
                    apply_rope_tables(want[1], *rope, inverse=True), want[2])
        rel = [((g.float() - w).norm() / w.norm()).item() for g, w in zip(got, want)]
        err = max((g.float() - w).abs().max().item() for g, w in zip(got, want))
        dead = (mask.cumsum(1) == 0) if causal else torch.zeros_like(mask, dtype=torch.bool)
        dead_ok = bool((got[0][dead] == 0).all().item()) if bool(dead.any()) else True
        again = flash_attention_bwd(q, k, v, mask, out, lse, dout, causal, rope=rope)
        deterministic = all(torch.equal(a, g) for a, g in zip(again, got))
        ms = time_ms(lambda: flash_attention_bwd(q, k, v, mask, out, lse, dout, causal, rope=rope))
        plain_ms = time_ms(lambda: flash_attention_bwd_ref(*args32), reps=3)
        bound_ms, bound_by = bound(10 * h * d * attended_pairs(mask, causal),
                                   nbytes(q, k, v, mask, out, lse, dout, *got, *(rope or ())), BF16_FLOPS)
        # SDPA's backward computes the same gradients where there is no fused
        # RoPE and no causal left padding; else it is the near yardstick
        same = not causal and not fused
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in ((q, k, v) if same else (qr, kr, v)))
        ref_out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=_bool_mask(mask, causal), enable_gqa=h != hkv)
        dout_t = dout.transpose(1, 2)
        sdpa_bwd = event_ms(lambda: torch.autograd.grad(ref_out, (qt, kt, vt), dout_t, retain_graph=True))
        library_ms, near_ms = (sdpa_bwd, None) if same else (None, sdpa_bwd)
        del ref_out
        log(f"[K4] {name} {(b, t, h, hkv, d)}: rel L2 dq {rel[0]:.3e} dk {rel[1]:.3e} dv {rel[2]:.3e} "
            f"max abs {err:.3e}, dead rows {int(dead.sum())} dq zero {dead_ok}, deterministic "
            f"{deterministic} | kernel {ms:.4f} ms plain f32 {plain_ms:.4f} ms bound {bound_ms:.4f} ms "
            f"({bound_by}) share {bound_ms / ms:.3f} SDPA backward {_r(library_ms)} ms | {NEAR} "
            f"(backward): {_r(near_ms)} ms")
        if not (max(rel) <= 2e-2 and dead_ok and deterministic):
            raise AssertionError(f"K4 {name}: rel L2 {rel} (tol 2e-2), dead dq zero {dead_ok}, "
                                 f"deterministic {deterministic}")
        worst = max(worst, err)
        rows.append(dict(at=f"{name} {(b, t, h, hkv, d)}", ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=library_ms, near_library_ms=near_ms, max_rel_l2=max(rel)))
    return dict(max_abs_err=worst, **{k: v for k, v in rows[0].items() if k != "near_library_ms"},
                near_library=NEAR + " (backward)", cases=rows)


def check_flash_bwd_f32(gen) -> dict:
    """K4's f32 route (csrc/flash_attention_bwd_f32.cu) against the f32 twin
    on the kernel's own inputs (K1 f32's out and lse; TF32 off): dq, dk, dv
    each within 2e-5 of the twin's largest entry, dq exactly 0 on rows with
    no visible key, the same bits on a second run; the twin under
    single-pass TF32 beside it; then ``F32_EDGES``, held alone. Bound: five
    products at the 165 TFLOP/s of 3xTF32, the 67 TFLOP/s of f32 FMA beside
    it. Library: SDPA's f32 backward (autograd of SDPA on the f32
    tensors with the boolean mask); with causal left padding its dead rows
    differ, so it is the near yardstick there."""
    from slam_llm_tpu_torch.ops.kernels.flash_attention import (
        bwd_f32_error,
        flash_attention_bwd,
        flash_attention_bwd_f32,
        flash_attention_bwd_ref,
        flash_attention_fwd,
    )

    dev = "cuda"
    cases = [
        # (name, B, T, H, Hkv, D, causal, padding)
        ("Spatial-AST-base encoder, training batch", 16, SA_T, 12, 12, 64, False, "none"),
        ("ragged keys, right-padded", 8, SA_T, 12, 12, 64, False, "right"),
        ("causal, left-padded", 4, SA_T, 12, 12, 64, True, "left"),
        ("GQA, head_dim 128, causal", 2, 256, 8, 2, 128, True, "right"),
    ]

    worst, rows = 0.0, []
    for name, b, t, h, hkv, d, causal, pad in cases:
        q = torch.randn(b, t, h, d, generator=gen, device=dev)
        k = torch.randn(b, t, hkv, d, generator=gen, device=dev)
        v = torch.randn(b, t, hkv, d, generator=gen, device=dev)
        dout = torch.randn(b, t, h, d, generator=gen, device=dev)
        mask = _padding_mask(b, t, pad)
        out, lse = flash_attention_fwd(q, k, v, mask, causal)
        args = (q, k, v, mask, out, lse, dout, causal)
        got = flash_attention_bwd(*args)
        torch.cuda.synchronize()
        want = flash_attention_bwd_ref(*args)
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32 = flash_attention_bwd_ref(*args)
        torch.backends.cuda.matmul.allow_tf32 = False
        err, tf32_err = (bwd_f32_error(x, want, q, k, v, dout) for x in (got, tf32))
        abs_err = max((g - w).abs().max().item() for g, w in zip(got, want))
        dead = (mask.cumsum(1) == 0) if causal else (mask.sum(1, keepdim=True) == 0).expand(b, t)
        dead_ok = bool((got[0][dead] == 0).all().item()) if bool(dead.any()) else True
        again = flash_attention_bwd(*args)
        deterministic = all(torch.equal(a, g) for a, g in zip(again, got))
        ms = time_ms(lambda: flash_attention_bwd_f32(*args))
        plain_ms = time_ms(lambda: flash_attention_bwd_ref(*args), reps=3)
        ops, moved = 10 * h * d * attended_pairs(mask, causal), nbytes(q, k, v, mask, out, lse, dout, *got)
        bound_ms, bound_by = bound(ops, moved, TF32X3_FLOPS)
        fma_ms = bound(ops, moved, FP32_FLOPS)[0]
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        ref_out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=_bool_mask(mask, causal), enable_gqa=h != hkv)
        dout_t = dout.transpose(1, 2)
        sdpa_bwd = event_ms(lambda: torch.autograd.grad(ref_out, (qt, kt, vt), dout_t, retain_graph=True))
        library_ms, near_ms = (None, sdpa_bwd) if causal and pad == "left" else (sdpa_bwd, None)
        del ref_out
        log(f"[K4 f32] {name} {(b, t, h, hkv, d)} causal={causal}: max|g-ref| / max|ref| over dq, dk, dv {err:.3e} "
            f"(the twin under single-pass TF32: {tf32_err:.3e}), max abs {abs_err:.3e}, dead rows {int(dead.sum())} "
            f"dq zero {dead_ok}, deterministic {deterministic} | kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
            f"{bound_ms:.4f} ms ({bound_by}, 3xTF32) share {bound_ms / ms:.3f}, f32 FMA bound {fma_ms:.4f} ms share "
            f"{fma_ms / ms:.3f} SDPA f32 backward {_r(library_ms)} ms | SDPA f32 backward, boolean mask (near): "
            f"{_r(near_ms)} ms | {SMI}")
        if not (err <= 2e-5 and dead_ok and deterministic):
            raise AssertionError(f"K4 f32 {name}: error {err} of the twin's largest entry (tol 2e-5), dead dq zero "
                                 f"{dead_ok}, deterministic {deterministic}")
        worst = max(worst, abs_err)
        rows.append(dict(at=f"{name} {(b, t, h, hkv, d)}", ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=library_ms, near_library_ms=near_ms,
                         rel_err=err, tf32_rel_err=tf32_err))
    for b, t, h, hkv, d, causal, pad in F32_EDGES:
        q, k, v = (torch.randn(b, t, n, d, generator=gen, device=dev) for n in (h, hkv, hkv))
        dout = torch.randn(b, t, h, d, generator=gen, device=dev)
        mask = _padding_mask(b, t, pad)
        args = (q, k, v, mask, *flash_attention_fwd(q, k, v, mask, causal), dout, causal)
        got, want = flash_attention_bwd(*args), flash_attention_bwd_ref(*args)
        err = bwd_f32_error(got, want, q, k, v, dout)  # at T = 1 dq / dk against the cancellation's round-off
        dead = (mask.cumsum(1) == 0) if causal else (mask.sum(1, keepdim=True) == 0).expand(b, t)
        again = flash_attention_bwd(*args)
        if not (err <= 2e-5 and bool((got[0][dead] == 0).all()) and all(map(torch.equal, again, got))):
            raise AssertionError(f"K4 f32 edge {(b, t, h, hkv, d, causal, pad)}: error {err} (tol 2e-5), or dead dq "
                                 f"not zero, or not deterministic")
        worst = max(worst, max((g - w).abs().max().item() for g, w in zip(got, want)))
    log(f"[K4 f32] {len(F32_EDGES)} tile edges {[c[1:5] for c in F32_EDGES]}: within 2e-5 of the twin's largest "
        f"entry, dead dq zero, deterministic")
    return dict(max_abs_err=worst, **{k: v for k, v in rows[0].items() if k not in ("near_library_ms", "tf32_rel_err")},
                near_library="SDPA f32 backward, boolean mask", cases=rows)


def _k2_case(at: str, ms: float, plain_ms: float, bound_ms: float) -> dict:
    return dict(at=at, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, share=bound_ms / ms)


def check_rowquant(gen) -> dict:
    from slam_llm_tpu_torch.ops.kernels.rowquant import rowquant, rowquant_ref

    dev = "cuda"
    worst, first, rows = 0.0, None, []
    # prefill (M = 4096), beam decode (M = 32) and training (M = 8192) shapes first, then others
    # then vicuna-7b's rows (phase 9): training M = 16 x T, prefill M = 8 x T, beam M = 32
    vicuna = [(m, k) for m in sorted({16 * t for t in W_TRAIN_T} | {8 * t for t in W_PREFILL_T} | {32}, reverse=True)
              for k in (4096, 11008)]
    for m, k in ((4096, 2048), (4096, 5632), (32, 2048), (32, 5632), (8192, 2048), (8192, 5632), (3584, 2048),
                 (1337, 5632), (3, 2056), *vicuna):
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
        bound_ms, bound_by = bound(0, nbytes(x, q, s), BF16_FLOPS)
        log(f"[K2] ({m}, {k}) bf16: bit-exact {exact} | kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"bound {bound_ms:.4f} ms ({bound_by}) share {bound_ms / ms:.3f} library none "
            f"| eager call with launch {host_ms(lambda: rowquant(x)):.4f} ms")
        if not exact:
            raise AssertionError(f"K2 ({m}, {k}) not bit-exact: max |q - ref| {err}")
        worst = max(worst, float(err))
        rows.append(_k2_case(f"({m}, {k}) bf16", ms, plain_ms, bound_ms))
        if first is None:
            first = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                         at=f"({m}, {k}) bf16")
    return dict(max_abs_err=worst, **first, cases=rows)


def check_rowquant_rot_sr(gen) -> dict:
    """K2's rotate + stochastic-rounding kernel at the int8_rot dy shapes of
    the training step (M = 16 x 512 rows; F = 2048, 256, 5632), bit-exact
    against the twin's Philox stream and butterfly order."""
    from slam_llm_tpu_torch.ops.kernels.rowquant import rowquant, rowquant_ref

    dev = "cuda"
    worst, first, rows = 0.0, None, []
    for m, k, seed, rotate in ((8192, 2048, 1234567, True), (8192, 256, 7, True), (8192, 5632, 2**32 - 1, True),
                               (37, 2048, None, True), (37, 2048, 99, False)):
        x = torch.randn(m, k, generator=gen, device=dev) * 1e-3
        x[0] = 0.0  # all-zero row
        x[1, 5] = 2.0  # one large outlier
        x = x.bfloat16()
        q, s = rowquant(x, seed=seed, rotate=rotate)
        torch.cuda.synchronize()
        rq, rs = rowquant_ref(x, seed=seed, rotate=rotate)
        exact = bool(torch.equal(q, rq) and torch.equal(s, rs))
        err = (q.int() - rq.int()).abs().max().item()
        ms = time_ms(lambda: rowquant(x, seed=seed, rotate=rotate))
        plain_ms = time_ms(lambda: rowquant_ref(x, seed=seed, rotate=rotate), reps=3)
        bound_ms, bound_by = bound(0, nbytes(x, q, s), BF16_FLOPS)
        log(f"[K2 rot/SR] ({m}, {k}) seed={seed} rotate={rotate}: bit-exact {exact} | kernel {ms:.4f} ms "
            f"plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}) share {bound_ms / ms:.3f} library none")
        if not exact:
            raise AssertionError(f"K2 rot/SR ({m}, {k}) not bit-exact: max |q - ref| {err}")
        worst = max(worst, float(err))
        rows.append(_k2_case(f"({m}, {k}) seed={seed} rotate={rotate}", ms, plain_ms, bound_ms))
        if first is None:
            first = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                         at=f"({m}, {k}) rotate + SR")
    return dict(max_abs_err=worst, **first, cases=rows)


def check_rowquant_fold(gen) -> dict:
    """K2's fold kernels, deterministic and stochastic rounding, bit-exact
    against the twin: the int8_sr / int8 dy shapes of the training step
    (M = 16 x 512, bf16, a fold of f32 weight scales) and the int8 CE
    head's f32 dlog (16 x 64 rows of 32000)."""
    from slam_llm_tpu_torch.ops.kernels.rowquant import rowquant, rowquant_ref

    dev = "cuda"
    worst, first, rows = 0.0, None, []
    cases = [(8192, k, dt, seed) for k in (2048, 5632, 256) for dt in (torch.bfloat16,) for seed in (None, 977)]
    cases += [(1024, 32000, torch.float32, 2**32 - 5), (1024, 32000, torch.float32, None), (37, 2056, torch.bfloat16, 3)]
    for m, k, dt, seed in cases:
        x = torch.randn(m, k, generator=gen, device=dev) * 1e-2
        x[0] = 0.0  # all-zero row
        x[1, 5] = 3.0  # one large outlier
        x = x.to(dt)
        fold = torch.rand(k, generator=gen, device=dev) * 0.02 + 1e-4
        q, s = rowquant(x, fold, seed=seed)
        torch.cuda.synchronize()
        rq, rs = rowquant_ref(x, fold, seed=seed)
        exact = bool(torch.equal(q, rq) and torch.equal(s, rs))
        err = (q.int() - rq.int()).abs().max().item()
        ms = time_ms(lambda: rowquant(x, fold, seed=seed))
        plain_ms = time_ms(lambda: rowquant_ref(x, fold, seed=seed), reps=3)
        bound_ms, bound_by = bound(0, nbytes(x, fold, q, s), BF16_FLOPS)
        name = f"({m}, {k}) {str(dt).split('.')[-1]} {'SR' if seed is not None else 'deterministic'}"
        log(f"[K2 fold] {name}: bit-exact {exact} | kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
            f"{bound_ms:.4f} ms ({bound_by}) share {bound_ms / ms:.3f} library none")
        if not exact:
            raise AssertionError(f"K2 fold {name} not bit-exact: max |q - ref| {err}")
        worst = max(worst, float(err))
        rows.append(_k2_case(name, ms, plain_ms, bound_ms))
        if first is None and seed is not None:
            first = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None, at=name)
    return dict(max_abs_err=worst, variants=["deterministic", "stochastic rounding", "bf16 input", "f32 input"],
                **first, cases=rows)


def _k3_line(xq, wqs, out, plan, ms: float) -> tuple:
    """K3's bound and library product for one call: (bound_ms, bound_by,
    torch._int_mm ms or None). ``wqs`` yields the weight (or its cold
    copies, in turn). ``_int_mm`` is the s8 product with s32 output and no
    epilogue; cuBLAS takes it only for M > 16."""
    m, k = xq.shape
    wq = next(wqs)
    bound_ms, bound_by = bound(2.0 * m * k * wq.shape[0], nbytes(xq, wq, out) + 4 * (m + wq.shape[0]), INT8_OPS)
    int_mm = time_ms(lambda: torch._int_mm(xq, next(wqs).t())) if m > 16 else None
    log(f"      {plan.path} tile {plan.tile} splits {plan.splits}: bound {bound_ms:.4f} ms ({bound_by}) share "
        f"{bound_ms / ms:.3f} | torch._int_mm {int_mm if int_mm is None else round(int_mm, 4)} ms")
    return bound_ms, bound_by, int_mm


def check_int8_matmul_f32(gen) -> dict:
    """K3's f32 epilogue at the int8 CE head's logits, (1024, 2048 -> 32000),
    and at an f32 dx shape: bit-exact against the f64 twin."""
    from slam_llm_tpu_torch.kernels.build import sm_count
    from slam_llm_tpu_torch.ops.quant import int8_matmul, int8_matmul_ref, plan_int8_matmul

    dev = "cuda"
    worst, first = 0.0, None
    for m, k, f in ((1024, 2048, 32000), (1024, 32000, 2048), (37, 48, 40)):
        xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        wq = torch.randint(-127, 128, (f, k), generator=gen, device=dev, dtype=torch.int8)
        xs = torch.rand(m, generator=gen, device=dev) * 0.05 + 1e-3
        ws = torch.rand(f, generator=gen, device=dev) * 0.01 + 1e-4
        out = int8_matmul(xq, wq, xs, ws, torch.float32)
        torch.cuda.synchronize()
        ref = int8_matmul_ref(xq, wq, xs, ws, torch.float32)
        exact = bool(torch.equal(out, ref))
        err = (out - ref).abs().max().item()
        ms = time_ms(lambda: int8_matmul(xq, wq, xs, ws, torch.float32))
        plain_ms = time_ms(lambda: int8_matmul_ref(xq, wq, xs, ws, torch.float32), reps=3)
        xb, wb = xq.bfloat16(), wq.bfloat16()
        bf16_ms = time_ms(lambda: torch.mm(xb, wb.T, out_dtype=torch.float32))
        log(f"[K3 f32] M={m} K={k} F={f}: bit-exact {exact} max abs {err:.3e} | kernel {ms:.4f} ms "
            f"plain(f64) {plain_ms:.4f} ms bf16 matmul (f32 out) {bf16_ms:.4f} ms")
        bound_ms, bound_by, int_mm = _k3_line(xq, itertools.repeat(wq), out, plan_int8_matmul(m, f, k, sm_count(0)),
                                              ms)
        if not exact:
            raise AssertionError(f"K3 f32 M={m} K={k} F={f}: max |out - ref| {err}")
        worst = max(worst, err)
        if first is None:
            first = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=int_mm,
                         bf16_ms=bf16_ms, at=f"M={m} K={k} F={f} f32 out")
    return dict(max_abs_err=worst, **first)


def check_int8_matmul(gen) -> dict:
    """K3 with the bf16 epilogue at the paths' shapes (the planner's plan
    for each), within one bf16 ulp of the f64 twin and bit-identical on a
    second run; its time beside the bound, ``torch._int_mm`` and the bf16
    cuBLAS product of the same shape, which reads twice the weight bytes."""
    from slam_llm_tpu_torch.kernels.build import sm_count
    from slam_llm_tpu_torch.ops.quant import int8_matmul, int8_matmul_ref, plan_int8_matmul

    dev = "cuda"
    worst, first = 0.0, None
    # (M, Kc, N): the forward's (K, F) at prefill / decode M, then the int8_rot
    # dx products of the training step, z (M, F) x wr_q (K, F)
    shapes = [(m, kc, n) for m in (4096, 32, 8, 3584)
              for kc, n in ((2048, 2048), (2048, 256), (2048, 5632), (5632, 2048))]
    shapes += [(8192, kc, n) for kc, n in ((2048, 2048), (256, 2048), (5632, 2048), (2048, 5632))]
    # the int8_sr / int8 dx against the stored transpose kernel_qt, and the
    # int8_sr CE head's dx, z (1024, 32000) x head_qt (2048, 32000), and that
    # of one utterance's 64-row chunk (phase 6's gradient check: split-K)
    shapes += [(1024, 32000, 2048), (64, 32000, 2048)]
    # vicuna-7b's int8 base (phase 9): q / k / v / o, gate / up and down at
    # training, prefill and beam M
    shapes += [(m, kc, n) for m in sorted({16 * t for t in W_TRAIN_T} | {8 * t for t in W_PREFILL_T} | {32},
                                          reverse=True)
               for kc, n in ((4096, 4096), (4096, 11008), (11008, 4096))]
    for m, k, f in shapes:
        xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        wq = torch.randint(-127, 128, (f, k), generator=gen, device=dev, dtype=torch.int8)
        xs = torch.rand(m, generator=gen, device=dev) * 0.05 + 1e-3
        ws = torch.rand(f, generator=gen, device=dev) * 0.01 + 1e-4
        out = int8_matmul(xq, wq, xs, ws, torch.bfloat16)
        again = int8_matmul(xq, wq, xs, ws, torch.bfloat16)
        torch.cuda.synchronize()
        ref = int8_matmul_ref(xq, wq, xs, ws, torch.bfloat16)
        ulp = (out.view(torch.int16).int() - ref.view(torch.int16).int()).abs().max().item()
        deterministic = bool(torch.equal(out, again))
        err = (out.float() - ref.float()).abs().max().item()
        # decode M: each call meets its weight cold, as a decode step does; the
        # bf16 product and torch._int_mm are timed the same way
        wqs = cold(wq) if m <= 32 else itertools.repeat(wq)
        ms = time_ms(lambda: int8_matmul(xq, next(wqs), xs, ws, torch.bfloat16))
        plain_ms = time_ms(lambda: int8_matmul_ref(xq, wq, xs, ws, torch.bfloat16), reps=3)
        xb, wb = xq.bfloat16(), wq.bfloat16()
        wbs = cold(wb) if m <= 32 else itertools.repeat(wb)
        bf16_ms = time_ms(lambda: xb @ next(wbs).T)
        log(f"[K3] M={m} K={k} F={f}: max ulp {ulp} max abs {err:.3e} run-to-run identical {deterministic} | "
            f"kernel {ms:.4f} ms plain(f64) {plain_ms:.4f} ms bf16 matmul {bf16_ms:.4f} ms"
            f"{' (weights cold in L2)' if m <= 32 else ''} | eager call with launch "
            f"{host_ms(lambda: int8_matmul(xq, wq, xs, ws, torch.bfloat16)):.4f} ms")
        bound_ms, bound_by, int_mm = _k3_line(xq, wqs, out, plan_int8_matmul(m, f, k, sm_count(0)), ms)
        if ulp > 1 or not deterministic:
            raise AssertionError(f"K3 M={m} K={k} F={f}: {ulp} bf16 ulps from the reference, "
                                 f"run-to-run identical {deterministic}")
        worst = max(worst, err)
        if m == 4096 and k == 2048 and f == 5632:
            first = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=int_mm,
                         bf16_ms=bf16_ms, at=f"M={m} K={k} F={f}")
    return dict(max_abs_err=worst, **first)


KERNELS = [
    # name, source, the TPU kernel it replaces
    ("flash_attention_fwd", "slam_llm_tpu_torch/csrc/flash_attention.cu",
     "slam_llm_tpu/ops/kernels/flash_attention.py:562"),
    ("flash_attention_fwd_f32", "slam_llm_tpu_torch/csrc/flash_attention_f32.cu",
     "slam_llm_tpu/ops/kernels/flash_attention.py:562"),
    ("flash_attention_bwd", "slam_llm_tpu_torch/csrc/flash_attention_bwd.cu",
     "slam_llm_tpu/ops/kernels/flash_attention.py:1201"),
    ("flash_attention_bwd_f32", "slam_llm_tpu_torch/csrc/flash_attention_bwd_f32.cu",
     "slam_llm_tpu/ops/kernels/flash_attention.py:1201"),
    ("rowquant", "slam_llm_tpu_torch/csrc/rowquant.cu", "slam_llm_tpu/ops/kernels/rowquant.py:226"),
    ("rowquant_rot_sr", "slam_llm_tpu_torch/csrc/rowquant.cu", "slam_llm_tpu/ops/kernels/rowquant.py:222"),
    ("rowquant_fold", "slam_llm_tpu_torch/csrc/rowquant.cu", "slam_llm_tpu/ops/kernels/rowquant.py:222"),
    ("int8_matmul", "slam_llm_tpu_torch/csrc/int8_matmul.cu", "slam_llm_tpu/ops/quant.py:103"),
    ("int8_matmul_f32", "slam_llm_tpu_torch/csrc/int8_matmul.cu", "slam_llm_tpu/ops/fused_ce.py:115"),
]


def check_kernels() -> list:
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_wgmma_layouts(gen)
    checks = {
        "flash_attention_fwd": check_flash, "flash_attention_fwd_f32": check_flash_f32,
        "flash_attention_bwd": check_flash_bwd, "flash_attention_bwd_f32": check_flash_bwd_f32,
        "rowquant": check_rowquant, "rowquant_rot_sr": check_rowquant_rot_sr,
        "rowquant_fold": check_rowquant_fold, "int8_matmul": check_int8_matmul,
        "int8_matmul_f32": check_int8_matmul_f32,
    }
    results = [dict(name=name, route="cuda", source=src, replaces=rep, **checks[name](gen))
               for name, src, rep in KERNELS]
    torch.cuda.synchronize()
    return results


# ---------------------------------------------------------------------------
# phase 4: the batch-decode slice
# ---------------------------------------------------------------------------


def _corpus_samples(i: int, n: int) -> int:
    return int((2.0 + 8.0 * i / (n - 1)) * 16000)


def corpus_seconds(n: int) -> float:
    """The seconds of audio ``write_corpus`` writes for ``n`` clips."""
    return sum(_corpus_samples(i, n) for i in range(n)) / 16000


def write_corpus(root: Path, n: int = 16, seed: int = 0, name: str = "test", targets=None) -> Path:
    """n synthetic 16 kHz wavs of 2-10 s (tone + noise) and a jsonl manifest;
    the targets are ``targets`` in turn, else "utterance i"."""
    import wave

    rng = np.random.default_rng(seed)
    manifest = root / f"{name}.jsonl"
    with open(manifest, "w") as f:
        for i in range(n):
            t = np.arange(_corpus_samples(i, n)) / 16000
            x = 0.3 * np.sin(2 * np.pi * (200 + 50 * (i % 16)) * t) + 0.02 * rng.standard_normal(t.size)
            path = root / f"{name}_utt{i}.wav"
            with wave.open(str(path), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes((x * 32767).astype("<i2").tobytes())
            target = targets[i % len(targets)] if targets else f"utterance {i}"
            f.write(json.dumps({"key": f"utt{i}", "source": str(path), "target": target}, ensure_ascii=False) + "\n")
    return manifest


RECIPE_LAYERS = 22  # TinyLlama-1.1B's decoder layers

# the kernels decode runs; K3's beam steps (M = 32) take its split-K path
DECODE_PATH = ("flash_attention_fwd", "rowquant", "int8_matmul", "int8_matmul/splitk")


def kernel_counters():
    from slam_llm_tpu_torch.ops import quant
    from slam_llm_tpu_torch.ops.kernels import flash_attention, rowquant

    return {
        "flash_attention_fwd": flash_attention.flash_attention_fwd,
        "flash_attention_fwd_f32": flash_attention.flash_attention_fwd_f32,
        "flash_attention_bwd": flash_attention.flash_attention_bwd,
        "flash_attention_bwd_f32": flash_attention.flash_attention_bwd_f32,
        "rowquant": rowquant.rowquant,
        "rowquant_rot_sr": rowquant.rowquant_rot_sr,
        "rowquant_fold": rowquant.rowquant_fold,
        "int8_matmul": quant.int8_matmul,
        "int8_matmul_f32": quant.int8_matmul_f32,
        # K3's code paths, over both epilogues
        "int8_matmul/wgmma": quant.K3_PATHS["wgmma"],
        "int8_matmul/splitk": quant.K3_PATHS["splitk"],
    }


# the launches by width (K2: row width; K3: (K, F)) of the last run_counted run
WIDTHS = {}


def run_counted(fn):
    """``fn()`` with every kernel's launch count set to 0 just before; returns
    (its result, the counts just after), and leaves the K2 / K3 launches by
    width of the run in ``WIDTHS``."""
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
        if hasattr(c, "widths"):
            c.widths.clear()
    out = fn()
    torch.cuda.synchronize()
    WIDTHS.clear()
    WIDTHS.update({name: dict(c.widths) for name, c in counters.items() if hasattr(c, "widths")})
    return out, {name: c.launches for name, c in counters.items()}


def check_prefill_against_cpu(cfg) -> None:
    """Prefill logits of the first batch on the card (finite), and of its
    first utterance against the CPU plain path with the same weights and dtype."""
    from slam_llm_tpu_torch.pipeline.common import build_model_and_data, materialize_params
    from slam_llm_tpu_torch.pipeline.inference_batch import decode_loader

    model, _, dataset = build_model_and_data(cfg, split=cfg.dataset_config.test_split, device="cuda")
    materialize_params(model.eval(), cfg)
    compare_prefill(model, next(iter(decode_loader(cfg, dataset))), "slice")


def compare_prefill(model, batch, label: str) -> None:
    """The prefill logits of ``batch`` on the card (finite), and of its first
    utterance against the CPU plain path with the same weights and dtype
    (cosine >= 0.99 at every valid position); ``model`` ends on the CPU."""
    from slam_llm_tpu_torch.models.llm import init_kv_cache

    keys = [k for k in ("input_ids", "attention_mask", "modality_mask", "audio_mel", "audio_mel_mask", "audio",
                        "audio_mask", "audio_binaural", "visual", "visual_mask", "audio_feats") if k in batch]

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
    log(f"[{label}] prefill logits {tuple(logits.shape)} finite")
    del logits
    gpu, mask = run(model, slice(0, 1), "cuda")
    t0 = time.perf_counter()
    cpu, _ = run(model.to("cpu"), slice(0, 1), "cpu")
    cpu_s = time.perf_counter() - t0
    g, c = gpu[mask], cpu[mask]  # (valid positions, V)
    cos = torch.nn.functional.cosine_similarity(g, c, dim=-1)
    agree = (g.argmax(-1) == c.argmax(-1)).float().mean().item()
    log(f"[{label}] utterance 0 prefill logits, card vs CPU plain path ({cpu_s:.1f} s on CPU): "
        f"min cosine {cos.min().item():.5f} mean {cos.mean().item():.5f} argmax agreement {agree:.4f} "
        f"max |diff| {(g - c).abs().max().item():.4f}")
    if cos.min().item() < 0.99:
        raise AssertionError(f"prefill logits cosine {cos.min().item()} < 0.99 against the CPU path")


def run_slice() -> dict:
    from slam_llm_tpu_torch.pipeline import inference_batch

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    manifest = write_corpus(tmp)
    cfg = inference_batch.load_run_config([
        "--config", str(RECIPE),
        f"++dataset_config.train_data_path={manifest}",
        f"++dataset_config.val_data_path={manifest}",
        f"++decode_config.decode_log={tmp / 'decode'}",
    ])
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, launches = run_counted(lambda: inference_batch.main(cfg, device="cuda"))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    preds = Path(res["pred"]).read_text().splitlines()
    log(f"[slice] {res['n']} utterances, {len(preds)} pred lines, launches {launches}")
    log(f"[slice] wall {wall:.2f} s (model build + init + decode), decode loop {res['seconds']:.2f} s, "
        f"prefill {1000 * res['prefill_s'] / res['calls']:.1f} ms/batch, "
        f"decode {1000 * res['decode_s'] / max(res['decode_steps'], 1):.2f} ms/step over "
        f"{res['decode_steps']} steps, {res['generated_tokens']} tokens, "
        f"{res['generated_tokens'] / res['seconds']:.1f} tokens/s, RTF {res['rtf']:.4f} "
        f"({res['audio_seconds']:.1f} s of audio), peak memory {peak / 2**30:.2f} GiB "
        f"({base / 2**30:.2f} GiB in use before the phase)")
    print("\n".join(preds[:3]))
    if res["n"] != 16 or len(preds) != 16:
        raise AssertionError(f"expected 16 decoded utterances, got {res['n']} / {len(preds)} lines")
    missing = [name for name in DECODE_PATH if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the decode path: {missing}")
    forwards = res["calls"] + res["decode_steps"]  # one prefill per batch, then the beam steps
    log(f"[slice] K2 deterministic {launches['rowquant']} launches over {res['calls']} prefills and "
        f"{res['decode_steps']} beam steps: {launches['rowquant'] / forwards / RECIPE_LAYERS:.2f} per layer per "
        f"forward (q / k / v share one, gate / up one)")
    check_prefill_against_cpu(cfg)
    return launches


# ---------------------------------------------------------------------------
# phase 5: the training slice
# ---------------------------------------------------------------------------

TRAIN_STEPS = 8  # the first two are warm-up; step time is the mean of the rest
NO_REMAT_STEPS = 6  # the short run with activation checkpointing off


def _train_cfg(tmp: Path, steps: int, *extra: str):
    from slam_llm_tpu_torch.pipeline import finetune

    return finetune.load_run_config([
        "--config", str(RECIPE),
        f"++dataset_config.train_data_path={write_corpus(tmp, n=16 * steps, name='train')}",
        f"++dataset_config.val_data_path={write_corpus(tmp, n=8, seed=1, name='val')}",
        f"++train_config.max_steps_per_epoch={steps}",
        "++train_config.log_interval=1",
        f"++train_config.output_dir={tmp / 'out'}",
        *extra,
    ])


def _finetune(cfg, label: str):
    """``pipeline.finetune.main`` on the card with the launch counts and the
    peak memory of the run; logs every step and the step time of steps 3 on."""
    from slam_llm_tpu_torch.pipeline import finetune

    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, launches = run_counted(lambda: finetune.main(cfg, device="cuda"))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps = res["steps"]
    for s in steps:
        log(f"[{label}] step {s['step']}: loss {s['loss']:.5f} acc {s['acc']:.4f} grad_norm {s['grad_norm']:.5e} "
            f"lr {s['lr']:.3e} | {1000 * s['seconds']:.1f} ms, batch {s['shape']}, {s['tokens']} tokens")
    timed = steps[2:] or steps
    step_s = float(np.mean([s["seconds"] for s in timed]))
    b, t = steps[-1]["shape"]
    tokens = float(np.mean([s["tokens"] for s in timed]))
    log(f"[{label}] {len(steps)} steps of batch {b} x T {t}: step {1000 * step_s:.1f} ms (mean of steps "
        f"{timed[0]['step']}-{timed[-1]['step']}), {b / step_s:.2f} utt/s, {tokens / step_s:.0f} attended tokens/s "
        f"({b * t / step_s:.0f} padded), peak memory {peak / 2**30:.2f} GiB ({base / 2**30:.2f} GiB in use "
        f"before the run, so {(peak - base) / 2**30:.2f} GiB of its own), wall {wall:.1f} s (build, init, steps, "
        f"validation, checkpoint); validation {res.get('final_val')}")
    log(f"[{label}] launches {launches}")
    if not all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) for s in steps):
        raise AssertionError(f"{label}: non-finite loss or gradient norm")
    return res, launches, dict(step_ms=1000 * step_s, peak_gib=peak / 2**30, own_peak_gib=(peak - base) / 2**30)


K2_KERNELS = ("rowquant", "rowquant_rot_sr", "rowquant_fold")


def k2_per_step(trainer, dataset, launches: dict, n_steps: int, label: str) -> dict:
    """K2 in the training step: launches per step of the phase's run (which
    includes its validation), and the launches and device ms of one forward
    + backward of 16 utterances under ``torch.profiler``, with seeds set,
    none drawn, and no update; the quant seeds and the train / eval mode
    are put back afterwards, so the trainer's state is left as it was."""
    from torch.profiler import ProfilerActivity, profile

    from slam_llm_tpu_torch.tools.profile_train import split_by_family

    batch = trainer.put_batch(dataset.collator([dataset[i] for i in range(16)]))
    params = list(trainer.trainable.values())
    seeds = [m.quant_seed for m in trainer.sr_modules] + ([trainer.model.llm.ce_seed] if trainer.ce_sr else [])
    training = trainer.model.training
    trainer.set_quant_seeds([12345] * len(seeds))
    trainer.model.eval()

    def fwd_bwd():
        out = trainer.model(batch)
        torch.autograd.grad(out["loss"], params, allow_unused=True)

    fwd_bwd()
    torch.cuda.synchronize()
    counters = kernel_counters()
    before = {n: counters[n].launches for n in K2_KERNELS}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fwd_bwd()
        torch.cuda.synchronize()
    one = {n: counters[n].launches - before[n] for n in K2_KERNELS}
    trainer.set_quant_seeds(seeds)
    trainer.model.train(training)
    ms = split_by_family(prof).get("K2 rowquant", 0.0)
    log(f"[{label}] K2 per step: {ms:.2f} ms of device time and launches {one} in one forward + backward of "
        f"16 utterances ({one['rowquant'] / RECIPE_LAYERS:.2f} deterministic per layer); over the run "
        f"{ {n: round(launches[n] / n_steps, 1) for n in K2_KERNELS} } per step, validation included")
    return dict(ms=ms, launches=one)


def _check_moved(trainer, cfg, steps: int):
    """Every trainable tensor moved away from the seeded init."""
    from slam_llm_tpu_torch.pipeline.common import build_model_and_data, materialize_params

    fresh, _, dataset = build_model_and_data(cfg, split=cfg.dataset_config.train_split, device="cuda")
    materialize_params(fresh, cfg)
    init = dict(fresh.named_parameters())
    unchanged = [n for n, p in trainer.trainable.items() if torch.equal(p.float(), init[n].float())]
    log(f"[train] {len(trainer.trainable)} trainable tensors, unchanged after {steps} steps: {len(unchanged)}")
    if unchanged:
        raise AssertionError(f"trainable tensors unchanged by training: {unchanged[:5]}")
    return dataset


TRAIN_PATH = ("flash_attention_fwd", "flash_attention_bwd", "rowquant", "rowquant_rot_sr", "int8_matmul",
              "int8_matmul/wgmma")


def run_training() -> dict:
    """The recipe's training step through ``pipeline.finetune.main``, as
    shipped (the int8_rot backward, remat with dots_flash_saveable), on
    TRAIN_STEPS x 16 synthetic utterances, validation on 8, a trainable-only
    checkpoint; the same for NO_REMAT_STEPS with remat off, for its step
    time and peak memory; then the gradient check against the CPU plain
    path."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    cfg = _train_cfg(tmp, TRAIN_STEPS)
    if not (cfg.train_config.shard.remat and cfg.train_config.shard.remat_policy == "dots_flash_saveable"):
        raise AssertionError("the recipe no longer ships remat with dots_flash_saveable")
    res, launches, remat_on = _finetune(cfg, "train")
    trainer, steps = res["trainer"], res["steps"]
    if len(steps) != TRAIN_STEPS:
        raise AssertionError(f"expected {TRAIN_STEPS} training steps, got {len(steps)}")
    missing = [name for name in TRAIN_PATH if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the training path: {missing}")
    log(f"[train] per step K4 {launches['flash_attention_bwd'] / len(steps):.0f}, K1 "
        f"{launches['flash_attention_fwd'] / len(steps):.1f} (the encoder's 12, 22 LLM layers, validation; no "
        f"recompute under dots_flash_saveable), K2 rot/SR {launches['rowquant_rot_sr'] / len(steps):.0f}")
    ckpt = Path(res["checkpoints"][-1]) / "model.pt"
    if not ckpt.is_file():
        raise AssertionError(f"checkpoint missing: {ckpt}")
    log(f"[train] checkpoint {ckpt} ({ckpt.stat().st_size / 2**20:.1f} MiB)")
    dataset = _check_moved(trainer, cfg, len(steps))
    k2_per_step(trainer, dataset, launches, len(steps), "train")
    del res
    tmp_off = Path(tempfile.mkdtemp(prefix="chip_smoke_noremat_"))
    res_off, _, remat_off = _finetune(_train_cfg(tmp_off, NO_REMAT_STEPS, "++train_config.shard.remat=false",
                                                 "++train_config.run_validation=false",
                                                 "++train_config.save_model=false"), "train remat=false")
    if res_off["trainer"].model.cfg.llm.remat:
        raise AssertionError("remat=false did not reach the model")
    del res_off
    log(f"[train] remat on (dots_flash_saveable) vs off: step {remat_on['step_ms']:.1f} vs {remat_off['step_ms']:.1f} "
        f"ms, the run's own peak {remat_on['own_peak_gib']:.2f} vs {remat_off['own_peak_gib']:.2f} GiB")
    check_train_grads_against_cpu(trainer, dataset, "train")
    return launches


MODES_STEPS = 8  # micro-steps before the checkpoint; then 2 more from the resumed state
MODES_PATH = ("flash_attention_fwd", "flash_attention_bwd", "rowquant", "rowquant_fold", "int8_matmul",
              "int8_matmul_f32", "int8_matmul/wgmma")


def run_training_modes() -> dict:
    """Phase 6: the recipe at full width with the int8_sr backward and CE
    head, anyprecision, gradient accumulation 2, full-state checkpoints and
    the validation decode; then a resume and the gradient check."""
    import wave

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_modes_"))
    probe = tmp / "probe.wav"
    t = np.arange(3 * 16000) / 16000
    with wave.open(str(probe), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((0.3 * np.sin(2 * np.pi * 330 * t) * 32767).astype("<i2").tobytes())
    modes = ["++train_config.shard.base_quant_bwd=int8_sr", "++train_config.shard.ce_quant=int8_sr",
             "++train_config.shard.remat_policy=dots_flash_saveable", "++train_config.optimizer=anyprecision",
             "++train_config.gradient_accumulation_steps=2", "++train_config.save_optimizer=true",
             "++train_config.run_test_during_validation=true",
             f"++train_config.run_test_during_validation_file={probe}", "++decode_config.max_new_tokens=32",
             f"++train_config.validation_interval={MODES_STEPS}"]
    cfg = _train_cfg(tmp, MODES_STEPS, *modes)
    res, launches, stats = _finetune(cfg, "modes")
    trainer, steps = res["trainer"], res["steps"]
    opt = trainer.optimizer
    log(f"[modes] optimizer {type(opt).__name__}({type(opt.inner).__name__}): {opt.inner.count} inner updates in "
        f"{trainer.step} micro-steps; validation decode {res['decoded']}")
    if len(steps) != MODES_STEPS or trainer.step != MODES_STEPS or opt.inner.count != MODES_STEPS // 2:
        raise AssertionError(f"modes: {len(steps)} steps, step {trainer.step}, {opt.inner.count} inner updates")
    if not res["decoded"] or not all(isinstance(x, str) for x in res["decoded"]):
        raise AssertionError(f"modes: no validation decode ({res['decoded']})")
    missing = [name for name in MODES_PATH if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the int8_sr training path: {missing}")
    ckpt = Path(res["checkpoints"][-1])
    if not (ckpt / "full_state.pt").is_file():
        raise AssertionError(f"no full state in {ckpt}")
    del res, trainer
    cfg2 = _train_cfg(Path(tempfile.mkdtemp(prefix="chip_smoke_resume_")), MODES_STEPS, *modes,
                      f"++train_config.resume_from={ckpt}", "++train_config.max_steps_per_epoch=2")
    res2, launches2, _ = _finetune(cfg2, "modes resumed")
    trainer2 = res2["trainer"]
    if [s["step"] for s in res2["steps"]] != [MODES_STEPS + 1, MODES_STEPS + 2] \
            or trainer2.optimizer.inner.count != MODES_STEPS // 2 + 1:
        raise AssertionError(f"resume: steps {[s['step'] for s in res2['steps']]}, "
                             f"{trainer2.optimizer.inner.count} inner updates")
    log(f"[modes] resumed from {ckpt} at step {MODES_STEPS}: steps {[s['step'] for s in res2['steps']]}, "
        f"{trainer2.optimizer.inner.count} inner updates")
    dataset = _check_moved(trainer2, cfg2, trainer2.step)
    k2_per_step(trainer2, dataset, {k: launches[k] + launches2[k] for k in launches}, MODES_STEPS + 2, "modes")
    check_train_grads_against_cpu(trainer2, dataset, "modes")
    return {k: launches[k] + launches2[k] for k in launches}


@contextlib.contextmanager
def cpu_attention_on_twins():
    """CPU attention that the card runs on K1 / K4 (no dense bias) goes
    through their plain twins (``flash_attention`` on CPU tensors) instead
    of the model's plain attention: K4's twin rounds P and dS to bf16
    before its products, as K4 does, so a CPU gradient carries the
    kernel's own rounding (the leak of a near-uniform attention's dS rows
    into its query / key gradients)."""
    from slam_llm_tpu_torch.models import layers
    from slam_llm_tpu_torch.ops.kernels.flash_attention import flash_attention

    plain = layers._xla_attention

    def twins(q, k, v, bias, kv_mask=None, causal=False):
        if bias is not None or q.is_cuda or (causal and q.shape[1] != k.shape[1]):
            return plain(q, k, v, bias, kv_mask, causal)
        mask = kv_mask.to(torch.int32) if kv_mask is not None else torch.ones(k.shape[:2], dtype=torch.int32)
        return flash_attention(q, k, v, mask, causal)

    layers._xla_attention = twins
    try:
        yield
    finally:
        layers._xla_attention = plain


def check_train_grads_against_cpu(trainer, dataset, label: str, key_bias_limit: float = 5e-2,
                                  gate: str = "") -> tuple:
    """The trainable gradients of one utterance, card vs CPU plain path: the
    trained weights with LoRA B redrawn nonzero (so every LoRA factor gets a
    gradient), the run's backward modes with the same stochastic-rounding
    seeds on both sides, remat as configured, dropout off. Cosine >= 0.99
    for every tensor with a gradient; a key projection's bias (the
    Q-Former's), whose gradient is 0 in exact arithmetic, within
    ``key_bias_limit`` of its query bias's gradient norm on both sides.
    The gate holds the tensors whose names start with ``gate`` (all by
    default); the others' worst is logged. Returns the loss on the card and
    on the CPU."""
    model = trainer.model
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        for mod in model.modules():
            if getattr(mod, "lora_rank", 0):
                mod.lora_b.normal_(0.0, 0.02, generator=gen)
    batch = dataset.collator([dataset[0]])
    names = list(trainer.trainable)
    seeds = trainer.draw_quant_seeds()

    def grads(device):
        b = {k: torch.as_tensor(v).to(device) for k, v in batch.items() if isinstance(v, np.ndarray)}
        trainer.set_quant_seeds(seeds)
        model.eval()
        params = dict(model.named_parameters())
        out = model(b)
        g = torch.autograd.grad(out["loss"], [params[n] for n in names])
        return float(out["loss"].detach()), [x.float().cpu() for x in g], tuple(b["input_ids"].shape)

    loss_gpu, g_gpu, shape = grads("cuda")
    model.to("cpu")
    t0 = time.perf_counter()
    loss_cpu, g_cpu, _ = grads("cpu")
    cpu_s = time.perf_counter() - t0
    grads = dict(zip(names, zip(g_gpu, g_cpu)))
    # a key projection's bias shifts every score of a query by one constant,
    # which the softmax cancels: its gradient is 0 in exact arithmetic, so
    # both sides are round-off, held against the query bias's gradient
    key_bias = {n: (a.norm().item(), c.norm().item(), grads[n.replace("k_proj", "q_proj")][1].norm().item())
                for n, (a, c) in grads.items() if n.endswith("k_proj.bias")}
    key_bias = {n: (a / q, c / q) for n, (a, c, q) in key_bias.items()}
    cos = {n: torch.nn.functional.cosine_similarity(a.flatten(), c.flatten(), dim=0).item()
           for n, (a, c) in grads.items() if c.abs().max() > 0 and n not in key_bias}
    worst = min(cos, key=cos.get)
    log(f"[{label}] gradient check, one utterance {shape}, {model.cfg.llm.n_layers} layers, card vs CPU plain "
        f"path ({cpu_s:.1f} s on CPU): loss {loss_gpu:.5f} vs {loss_cpu:.5f}; {len(cos)} of "
        f"{len(names) - len(key_bias)} tensors with a gradient, min cosine {cos[worst]:.5f} ({worst}), mean "
        f"{np.mean(list(cos.values())):.5f}" + (f"; {len(key_bias)} key-projection biases (gradient 0 in exact "
                                               f"arithmetic): largest |g| / |g of the query bias| "
                                               f"{max(a for a, _ in key_bias.values()):.2e} card, "
                                               f"{max(c for _, c in key_bias.values()):.2e} CPU (limit "
                                               f"{key_bias_limit:g})" if key_bias else ""))
    if gate:
        outside = {n: c for n, c in cos.items() if not n.startswith(gate)}
        cos = {n: c for n, c in cos.items() if n.startswith(gate)}
        key_bias = {n: ac for n, ac in key_bias.items() if n.startswith(gate)}
        names = [n for n in names if n.startswith(gate)]
        worst = min(cos, key=cos.get)
        log(f"[{label}] the gate holds the {len(names)} {gate}* tensors: min cosine {cos[worst]:.5f} ({worst}), "
            f"largest key-bias ratio {max((max(ac) for ac in key_bias.values()), default=0.0):.2e}; outside it the "
            f"worst is {min(outside.values()):.5f} ({min(outside, key=outside.get)})")
    worst_key_bias = max((max(ac) for ac in key_bias.values()), default=0.0)
    if len(cos) + len(key_bias) != len(names) or cos[worst] < 0.99 or worst_key_bias > key_bias_limit:
        raise AssertionError(f"gradient check: min cosine {cos[worst]} (< 0.99), zero gradients "
                             f"({len(names) - len(cos) - len(key_bias)}) or a key bias's gradient above round-off "
                             f"({worst_key_bias})")
    return loss_gpu, loss_cpu


# ---------------------------------------------------------------------------
# phase 7: the weights path
# ---------------------------------------------------------------------------

WEIGHTS_STEPS = 4
WEIGHTS_NEW_TOKENS = 32  # decode length of the reload check (a random model rarely stops early)
WEIGHTS_PATH = ("flash_attention_fwd", "flash_attention_bwd", "rowquant", "rowquant_rot_sr", "int8_matmul")


def write_weights(tmp: Path) -> dict:
    """(a) whisper-small and TinyLlama-1.1B as random bf16 HF directories and
    a 32000-entry tokenizer, with the port's own writer."""
    from slam_llm_tpu_torch.models.llm import LLMConfig
    from slam_llm_tpu_torch.models.whisper import WhisperEncoderConfig
    from slam_llm_tpu_torch.tools import synth_checkpoint as synth

    t0 = time.perf_counter()
    llm = synth.write_llama(str(tmp / "llm"), LLMConfig.tinyllama_1_1b(), seed=0, device="cuda")
    t1 = time.perf_counter()
    tok = synth.write_tokenizer(str(tmp / "llm"), 32000, seed=0)
    t2 = time.perf_counter()
    enc = synth.write_whisper(str(tmp / "whisper"), WhisperEncoderConfig.small(), seed=1, device="cuda")
    t3 = time.perf_counter()
    log(f"[weights] wrote TinyLlama-1.1B bf16 ({llm / 1e9:.3f} GB, 2 shards) in {t1 - t0:.2f} s, the tokenizer "
        f"({tok / 1e6:.2f} MB, 32000 entries) in {t2 - t1:.2f} s, whisper-small bf16 ({enc / 1e9:.3f} GB) in "
        f"{t3 - t2:.2f} s")
    return {"llm_path": str(tmp / "llm"), "encoder_path": str(tmp / "whisper")}


def check_loaded_base(model, paths: dict, layers=(0, 11, 21)) -> None:
    """(c) the int8 base of a few layers equals quantize_int8 (on the CPU) of
    the written bf16 weights; the embedding and norms equal the written
    tensors bit for bit; kernel_qr / kernel_scale_r equal what
    quantize_base_params derives from the loaded pair."""
    from slam_llm_tpu_torch.ops.quant import quantize_int8, rotated_pair
    from slam_llm_tpu_torch.utils.hf_loader import load_hf_state_dict

    sd = load_hf_state_dict(paths["llm_path"])
    llm = model.llm
    if not torch.equal(llm.embed_tokens.weight.cpu(), sd["model.embed_tokens.weight"]):
        raise AssertionError("loaded embedding differs from the written one")
    if not torch.equal(llm.final_norm.scale.float().cpu(), sd["model.norm.weight"].float()):
        raise AssertionError("loaded final norm differs from the written one")
    n = 0
    for i in layers:
        layer, src = llm.layers[i], f"model.layers.{i}."
        for norm, hf in ((layer.input_norm, "input_layernorm"), (layer.post_attn_norm, "post_attention_layernorm")):
            if not torch.equal(norm.scale.float().cpu(), sd[f"{src}{hf}.weight"].float()):
                raise AssertionError(f"layer {i} {hf} differs from the written one")
        for group, hf_group, names in (("attn", "self_attn", ("q_proj", "k_proj", "v_proj", "o_proj")),
                                       ("mlp", "mlp", ("gate_proj", "up_proj", "down_proj"))):
            for name in names:
                mod = getattr(getattr(layer, group), name)
                q, s = quantize_int8(sd[f"{src}{hf_group}.{name}.weight"], contract_axis=-1)
                if not (torch.equal(mod.kernel_q.cpu(), q) and torch.equal(mod.kernel_scale.cpu(), s)):
                    raise AssertionError(f"layer {i} {name}: kernel_q / kernel_scale differ from quantize_int8 of "
                                         "the written weight")
                qr, sr = rotated_pair(mod.kernel_q, mod.kernel_scale)
                if not (torch.equal(mod.kernel_qr, qr) and torch.equal(mod.kernel_scale_r, sr)):
                    raise AssertionError(f"layer {i} {name}: kernel_qr / kernel_scale_r not derived from the loaded base")
                n += 1
    log(f"[weights] loaded base checked on layers {layers}: {n} int8 denses equal quantize_int8 (CPU) of the "
        f"written bf16 weights, their int8_rot pairs derived from them; embedding and {2 * len(layers) + 1} norms "
        f"bit-equal to the written tensors")


def dataset_of(cfg, tokenizer, split: str):
    """The run's dataset of ``split``, through the registry as the entry
    points build it."""
    from slam_llm_tpu_torch.registry import get_custom_dataset_factory

    return get_custom_dataset_factory(cfg.dataset_config)(cfg.dataset_config, tokenizer, split)


def decode_texts(model, tokenizer, cfg) -> list:
    """Decode the test split with ``model`` as inference_batch does (its
    loader, generation config and text), for the in-memory comparison."""
    from slam_llm_tpu_torch.inference.generate import Generator, strip_after_eos
    from slam_llm_tpu_torch.pipeline.inference_batch import decode_loader, generation_config

    cfg.dataset_config.inference_mode = True
    dataset = dataset_of(cfg, tokenizer, cfg.dataset_config.test_split)
    gen = Generator(model.eval(), generation_config(cfg, tokenizer))
    lines = []
    for batch in decode_loader(cfg, dataset):
        tokens = strip_after_eos(gen.generate({k: v for k, v in batch.items() if isinstance(v, np.ndarray)}),
                                 tokenizer.eos_token_id, tokenizer.pad_token_id)
        lines += [f"{key}\t{tokenizer.decode(tokens[i])}" for i, key in enumerate(batch["keys"])]
    return lines


def check_wer(res, label: str = "weights") -> None:
    """(e) the port's WER over the decode logs: its %WER line, which must
    parse back to its own counts, and ref words = sub + del + hits."""
    import re

    from slam_llm_tpu_torch.utils.wer import align, compute_wer_files, read_trn

    detail = res["pred"] + "_wer"
    wer = compute_wer_files(res["gt"], res["pred"], detail)
    refs, hyps = read_trn(res["gt"]), read_trn(res["pred"])
    hits = sum(align(hyps[k], refs[k])[0]["cor"] for k in refs if k in hyps)
    line = wer.summary().splitlines()[0]
    log(f"[{label}] {line} (hits {hits}) over {wer.sentences} utterances")
    m = re.fullmatch(r"%WER (\S+) \[ (\d+) / (\d+), (\d+) ins, (\d+) del, (\d+) sub \]", line)
    text = Path(detail).read_text()
    if (not m or float(m.group(1)) != wer.wer or [int(x) for x in m.groups()[1:]] != [
            wer.errors, wer.words, wer.ins, wer.dels, wer.subs] or line not in text):
        raise AssertionError(f"the %WER line does not parse back: {line!r}")
    if wer.words != wer.subs + wer.dels + hits or wer.sentences != 16:
        raise AssertionError(f"WER counts: {wer.words} ref words vs {wer.subs} sub + {wer.dels} del + {hits} hits, "
                             f"{wer.sentences} utterances")


def check_export(trainer, tmp: Path) -> None:
    """(f) export_llama of the trained model, read back with the port's
    reader; layer 0's and the last layer's merged q_proj against dequant +
    B A * alpha / r (computed on the CPU), within bf16 rounding; the export
    is removed afterwards."""
    import shutil

    from slam_llm_tpu_torch.ops.quant import dequantize_int8
    from slam_llm_tpu_torch.utils.hf_export import export_llama
    from slam_llm_tpu_torch.utils.safetensors_io import load_file

    llm = trainer.model.llm
    out = tmp / "export"
    t0 = time.perf_counter()
    export_llama(llm, str(out))
    secs = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in out.iterdir())
    sd = load_file(str(out / "model.safetensors"))
    c = llm.cfg
    for i in (0, c.n_layers - 1):
        q = llm.layers[i].attn.q_proj
        want = dequantize_int8(q.kernel_q.cpu(), q.kernel_scale.cpu(), contract_axis=-1) + (
            q.lora_b.detach().cpu().float() @ q.lora_a.detach().cpu().float()) * (c.lora_alpha / c.lora_rank)
        got = sd[f"model.layers.{i}.self_attn.q_proj.weight"]
        err = (got - want).abs().max().item()
        if got.dtype != torch.float32 or err > 2 ** -8 * want.abs().max().item():
            raise AssertionError(f"exported layer {i} q_proj: max |merged - (dequant + B A alpha/r)| = {err}")
        log(f"[weights] export layer {i} q_proj: max |merged - (dequant + B A alpha/r)| {err:.3e} "
            f"(LoRA delta max {(want - dequantize_int8(q.kernel_q.cpu(), q.kernel_scale.cpu(), -1)).abs().max():.3e})")
    if len(sd) != 3 + 9 * c.n_layers:
        raise AssertionError(f"export holds {len(sd)} tensors")
    del sd
    shutil.rmtree(out)
    log(f"[weights] export_llama wrote {size / 1e9:.3f} GB of f32 in {secs:.2f} s; removed after the check")


def run_weights() -> dict:
    """Phase 7: write pretrained-shaped HF directories, train from them, and
    decode, score and export the trained model."""
    import shutil

    from slam_llm_tpu_torch.pipeline import inference_batch
    from slam_llm_tpu_torch.pipeline.common import build_model_and_data, materialize_params
    from slam_llm_tpu_torch.utils.checkpoint import load_trainable

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_weights_"))
    paths = write_weights(tmp)
    hf = [f"++model_config.llm_path={paths['llm_path']}", f"++model_config.encoder_path={paths['encoder_path']}"]
    # a short warm-up, so that 4 steps move LoRA B far enough for the reload and export checks to see it
    cfg = _train_cfg(tmp, WEIGHTS_STEPS, *hf, "++train_config.run_validation=false", "++train_config.warmup_steps=2",
                     "++train_config.lr=1e-3")
    if cfg.train_config.shard.base_quant_bwd != "int8_rot" or not cfg.train_config.shard.remat:
        raise AssertionError("the recipe no longer ships the int8_rot backward with remat")
    res, launches, stats = _finetune(cfg, "weights")
    trainer = res["trainer"]
    log(f"[weights] finetune from the HF directories: materialized in {res['load_seconds']:.2f} s, step "
        f"{stats['step_ms']:.1f} ms, peak memory {stats['peak_gib']:.2f} GiB")
    if len(res["steps"]) != WEIGHTS_STEPS or not res["checkpoints"]:
        raise AssertionError(f"weights: {len(res['steps'])} steps, checkpoints {res['checkpoints']}")
    ckpt = res["checkpoints"][-1]
    check_loaded_base(trainer.model, paths)
    saved = load_trainable(ckpt)
    if set(saved) != set(trainer.trainable) or not all(torch.equal(saved[n], p.detach().cpu())
                                                        for n, p in trainer.trainable.items()):
        raise AssertionError("model.pt differs from the trained tensors")

    dec = inference_batch.load_run_config([
        "--config", str(RECIPE), *hf, f"++ckpt_path={ckpt}",
        f"++dataset_config.val_data_path={write_corpus(tmp, n=16, seed=2, name='test')}",
        f"++decode_config.decode_log={tmp / 'decode'}", f"++decode_config.max_new_tokens={WEIGHTS_NEW_TOKENS}",
    ])
    (out, dec_launches) = run_counted(lambda: inference_batch.main(dec, device="cuda"))
    log(f"[weights] inference_batch with ckpt_path: {out['n']} utterances, weights materialized in "
        f"{out['load_seconds']:.2f} s, decode {out['seconds']:.2f} s, {out['generated_tokens']} tokens, "
        f"RTF {out['rtf']:.4f} ({out['audio_seconds']:.1f} s of audio); launches {dec_launches}")
    model, tokenizer, _ = build_model_and_data(dec, split=dec.dataset_config.test_split, device="cuda")
    t0 = time.perf_counter()
    materialize_params(model.eval(), dec)
    log(f"[weights] a fresh model materialized (random init, HF overlay with quantize-at-load, model.pt) in "
        f"{time.perf_counter() - t0:.2f} s")
    params = dict(model.named_parameters())
    bad = [n for n, p in trainer.trainable.items() if not torch.equal(params[n], p)]
    if bad:
        raise AssertionError(f"reloaded trainable tensors differ from the trained ones: {bad[:5]}")
    del model, params
    preds = Path(out["pred"]).read_text().splitlines()
    mine = decode_texts(trainer.model, tokenizer, dec)
    same = sum(a == b for a, b in zip(preds, mine))
    log(f"[weights] {len(trainer.trainable)} trainable tensors reloaded bit-equal; decoded text of the entry point "
        f"vs the in-memory trained model: {same} / {len(preds)} lines identical")
    print("\n".join(preds[:3]))
    if len(preds) != 16 or preds != mine:
        raise AssertionError("the reloaded model's decode differs from the in-memory trained model's")
    check_wer(out)
    check_export(trainer, tmp)
    del res, trainer
    shutil.rmtree(tmp)
    total = {k: launches[k] + dec_launches[k] for k in launches}
    missing = [name for name in WEIGHTS_PATH if total[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the weights path: {missing}")
    return total


# ---------------------------------------------------------------------------
# phase 8: the speech-translation recipe (whisper-large-v3 + Q-Former + Qwen2-7B)
# ---------------------------------------------------------------------------

ST_RECIPE = ROOT / "examples" / "st_covost2" / "conf" / "st_whisper_qwen.yaml"
ST_STEPS = 4
ST_NEW_TOKENS = 32  # decode length (a random model rarely emits EOS)
ST_DECODE_BATCH = 8
ST_LAYERS = 2  # LLM and encoder depth of the card-vs-CPU checks
ST_PATH = ("flash_attention_fwd", "flash_attention_bwd")
# made-up CoT-ST targets, "<transcript> <|de|> <translation>"
ST_PAIRS = [
    ("the weather is nice today", "das Wetter ist heute schön"),
    ("where is the train station", "wo ist der Bahnhof"),
    ("i would like a cup of coffee", "ich hätte gern eine Tasse Kaffee"),
    ("the children are playing in the garden", "die Kinder spielen im Garten"),
    ("we are going to the museum tomorrow", "wir gehen morgen ins Museum"),
    ("this book is very interesting", "dieses Buch ist sehr interessant"),
    ("can you help me please", "können Sie mir bitte helfen"),
    ("the meeting starts at nine o'clock", "die Besprechung beginnt um neun Uhr"),
]
ST_TARGETS = [f"{en} <|de|> {de}" for en, de in ST_PAIRS]
# the text buckets of a training batch (80 query slots, the prompt, a target,
# EOS) and of a decode batch (no target), which phase 3 times K1 / K4 at
ST_T, ST_PREFILL_T = 192, 128

# the directory of the synthetic tokenizer, set by run_st and run_wavlm
_synth_tokenizer_dir = None


def synth_tokenizer_factory(train_config, model_config, device=None, **kwargs):
    """The port's model factory with the tokenizer read from the synthetic
    tokenizer directory (phase 8's qwen2 one, phase 9's Llama one), its
    model config otherwise untouched: the LLM's weights are the seeded
    random init that ``materialize_params`` draws (no 15 GB Qwen2 or 13 GB
    vicuna directory is written). A recipe reaches it as
    ``++model_config.file=__main__:synth_tokenizer_factory``."""
    import dataclasses

    from slam_llm_tpu_torch.models.slam_model import model_factory

    return model_factory(train_config, dataclasses.replace(model_config, llm_path=_synth_tokenizer_dir), device=device,
                         **kwargs)


def _st_config(loader, *extra):
    return loader(["--config", str(ST_RECIPE), "++model_config.file=__main__:synth_tokenizer_factory", *extra])


def check_projector_trained(trainer, cfg, label: str, lora: bool = False, trained=("encoder_projector.",)) -> None:
    """Every parameter under the ``trained`` prefixes (the projector by
    default; the encoder's too when it trains) and, with ``lora``, every
    LoRA factor is trainable, an f32 master, and moved from the seeded init;
    every other tensor of the state dict (encoder and LLM weights, an int8
    base and its scales, norms) is bit-equal to a freshly materialized
    model's, in the dtype the trainer stores it in."""
    from slam_llm_tpu_torch.pipeline.common import build_model_and_data, materialize_params

    fresh, _, _ = build_model_and_data(cfg, split=cfg.dataset_config.train_split, device="cuda")
    materialize_params(fresh, cfg)
    init = fresh.state_dict()
    factors = {n for n in trainer.trainable if n.endswith((".lora_a", ".lora_b"))}
    under = {n for n, _ in trainer.model.named_parameters() if n.startswith(trained)}
    if (not trainer.trainable or bool(factors) != lora or set(trainer.trainable) - factors != under
            or any(p.dtype != torch.float32 for p in trainer.trainable.values())):
        raise AssertionError(f"{label}: the recipe trains {', '.join(trained)}{' and LoRA' if lora else ''} in f32, "
                             f"not {sorted(set(trainer.trainable) ^ under)[:5]}")
    unmoved = [n for n, p in trainer.trainable.items() if torch.equal(p, init[n].to(p.dtype))]
    state = trainer.model.state_dict()
    changed = [n for n, t in state.items() if n not in trainer.trainable and not torch.equal(t, init[n].to(t.dtype))]
    n_train = sum(p.numel() for p in trainer.trainable.values())
    n_other = sum(t.numel() for n, t in state.items() if n not in trainer.trainable)
    log(f"[{label}] {len(trainer.trainable)} trained tensors ({', '.join(trained)}"
        f"{' and LoRA' if lora else ''}; {n_train / 1e6:.1f} M parameters, {len(factors)} LoRA factors), unmoved: "
        f"{len(unmoved)}; {len(state) - len(trainer.trainable)} other state tensors ({n_other / 1e9:.3f} G "
        f"elements: encoder, LLM, int8 base, scales, norms), changed: {len(changed)}")
    del fresh, init
    if unmoved or changed:
        raise AssertionError(f"{label}: trained tensors unmoved {unmoved[:5]}, frozen tensors changed {changed[:5]}")


def st_bleu(out) -> dict:
    """``tools/eval_werbleu.py`` over the decode logs: its printed lines, the
    BLEU line parsed back."""
    import contextlib
    import io

    from slam_llm_tpu_torch.tools import eval_werbleu

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        eval_werbleu.main(["--pred", out["pred"], "--gt", out["gt"]])
    printed = [json.loads(line) for line in buf.getvalue().splitlines()]
    bleu = [line for line in printed if "bleu" in line]
    wer = [line for line in printed if "wer" in line]
    if len(bleu) != 1 or bleu[0]["count"] != out["n"] or not 0.0 <= bleu[0]["bleu"] <= 100.0 or not wer:
        raise AssertionError(f"eval_werbleu printed {printed}")
    log(f"[st] eval_werbleu: {json.dumps(wer[0])} {json.dumps(bleu[0])} (a {ST_STEPS}-step random model: no target)")
    return bleu[0]


def check_reduced_against_cpu(trainer, cfg, prefill_batch, train_ds, label: str, layers: int = 2,
                              key_bias_limit: float = 5e-2, gate: str = "") -> tuple:
    """The recipe's trained model cut to ``layers`` LLM and encoder layers
    at its full widths (a 7B f32 model on the host is neither quick nor
    small; a model without an encoder keeps none): the bf16 prefill logits
    of ``prefill_batch``'s first utterance and every trainable gradient of
    one utterance of ``train_ds``, card vs CPU plain path (the gradient gate
    on the tensors named ``gate``*, all by default). Returns the utterance's
    loss on the card and on the CPU."""
    import dataclasses

    from slam_llm_tpu_torch.models.slam_model import SLAMModel
    from slam_llm_tpu_torch.train.state import Trainer

    big = trainer.model.cfg
    small_cfg = dataclasses.replace(big, llm=dataclasses.replace(big.llm, n_layers=layers),
                                    encoder=big.encoder and dataclasses.replace(big.encoder, n_layers=layers))
    small = SLAMModel(small_cfg, device="cuda")
    trained = trainer.model.state_dict()
    with torch.no_grad():
        for n, p in small.state_dict(keep_vars=True).items():
            if n not in trained or trained[n].shape != p.shape:
                raise AssertionError(f"{label}: the cut model's {n} {tuple(p.shape)} is not the recipe's "
                                     f"{tuple(trained[n].shape) if n in trained else 'missing'}")
            p.copy_(trained[n])
    small_trainer = Trainer(small, small_cfg, cfg.train_config).state_from_params()
    encoder = f"{layers} of {big.encoder.n_layers} encoder layers" if big.encoder else "no encoder"
    log(f"[{label}] card vs CPU at {layers} of {big.llm.n_layers} LLM layers and {encoder} (full widths, the "
        f"recipe's trained model cut to those layers)")
    compare_prefill(small.eval(), prefill_batch, label)
    small.to("cuda")
    return check_train_grads_against_cpu(small_trainer, train_ds, label, key_bias_limit, gate)


def run_st() -> dict:
    """Phase 8: the ST recipe at full width: pipeline.finetune for ST_STEPS
    steps of the recipe's batch 8 (the Q-Former alone trains, the gradient
    coming back through the frozen Qwen2-7B), the reload through
    pipeline.inference_batch with ckpt_path against the in-memory model's
    decode, BLEU, and the card-vs-CPU checks at reduced depth."""
    global _synth_tokenizer_dir
    import shutil

    from slam_llm_tpu_torch.data.tokenizer import load_tokenizer
    from slam_llm_tpu_torch.pipeline import finetune, inference_batch
    from slam_llm_tpu_torch.pipeline.inference_batch import decode_loader
    from slam_llm_tpu_torch.tools.synth_checkpoint import QWEN2_BPE, write_qwen2_tokenizer
    from slam_llm_tpu_torch.utils.checkpoint import load_trainable

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_st_"))
    t0 = time.perf_counter()
    size = write_qwen2_tokenizer(str(tmp / "qwen2"), QWEN2_BPE, seed=0, corpus=ST_TARGETS)
    _synth_tokenizer_dir = str(tmp / "qwen2")
    tokenizer = load_tokenizer(_synth_tokenizer_dir)
    log(f"[st] wrote a qwen2-layout ByteLevel tokenizer ({size / 1e6:.2f} MB, {tokenizer.vocab_size} tokens) and read "
        f"it back in {time.perf_counter() - t0:.2f} s; bos {tokenizer.bos_token_id} eos {tokenizer.eos_token_id} "
        f"pad {tokenizer.pad_token_id}")
    # a 2-step warm-up at the recipe's lr, so 4 steps move every Q-Former tensor
    cfg = _st_config(
        finetune.load_run_config,
        f"++dataset_config.train_data_path={write_corpus(tmp, n=8 * ST_STEPS, name='train', targets=ST_TARGETS)}",
        f"++dataset_config.val_data_path={write_corpus(tmp, n=8, seed=1, name='val', targets=ST_TARGETS)}",
        f"++train_config.max_steps_per_epoch={ST_STEPS}", "++train_config.log_interval=1",
        "++train_config.run_validation=false", "++train_config.warmup_steps=2",
        f"++train_config.output_dir={tmp / 'out'}",
    )
    mc, dc, sh = cfg.model_config, cfg.dataset_config, cfg.train_config.shard
    if (mc.encoder_projector, mc.query_len, mc.qformer_layers, mc.encoder_config, mc.llm_name, dc.mel_size,
            dc.fix_length_audio, cfg.train_config.batch_size_training, sh.remat) != (
            "q-former", 80, 8, "whisper-large-v3", "qwen2-7b", 128, 80, 8, True):
        raise AssertionError(f"the ST recipe changed: {mc} {dc}")
    res, launches, stats = _finetune(cfg, "st")
    trainer = res["trainer"]
    c = trainer.model.cfg
    log(f"[st] model: whisper-large-v3 ({c.encoder.n_layers} layers, {c.encoder.n_mels} mels) + Q-Former "
        f"({c.projector_cfg.query_len} queries, {c.projector_cfg.qformer_layers} layers, {c.projector_cfg.qformer_dim} "
        f"wide) + qwen2-7b ({c.llm.n_layers} layers, {c.llm.n_heads} / {c.llm.n_kv_heads} heads, vocab "
        f"{c.llm.vocab_size}), bf16, remat {c.llm.remat_policy}; materialized in {res['load_seconds']:.2f} s; step "
        f"{stats['step_ms']:.1f} ms, peak memory {stats['peak_gib']:.2f} GiB; per step K1 "
        f"{launches['flash_attention_fwd'] / ST_STEPS:.0f} K4 {launches['flash_attention_bwd'] / ST_STEPS:.0f}")
    if len(res["steps"]) != ST_STEPS or not res["checkpoints"]:
        raise AssertionError(f"st: {len(res['steps'])} steps, checkpoints {res['checkpoints']}")
    if {s["shape"][1] for s in res["steps"]} != {ST_T}:
        raise AssertionError(f"the training batches' T is not the T = {ST_T} phase 3 checks K1 / K4 at")
    check_projector_trained(trainer, cfg, "st")
    ckpt = res["checkpoints"][-1]
    saved = load_trainable(ckpt)
    if set(saved) != set(trainer.trainable) or not all(torch.equal(saved[n], p.detach().cpu())
                                                        for n, p in trainer.trainable.items()):
        raise AssertionError("model.pt differs from the trained Q-Former")

    dec = _st_config(
        inference_batch.load_run_config, f"++ckpt_path={ckpt}",
        f"++dataset_config.val_data_path={write_corpus(tmp, n=16, seed=2, name='test', targets=ST_TARGETS)}",
        f"++decode_config.decode_log={tmp / 'decode'}", f"++decode_config.max_new_tokens={ST_NEW_TOKENS}",
        f"++train_config.val_batch_size={ST_DECODE_BATCH}",
    )
    out, dec_launches = run_counted(lambda: inference_batch.main(dec, device="cuda"))
    prefill_t = {len(b["input_ids"][0]) for b in decode_loader(dec, dataset_of(dec, tokenizer,
                                                                               dec.dataset_config.test_split))}
    if prefill_t != {ST_PREFILL_T}:
        raise AssertionError(f"the decode batches' T is {prefill_t}, not the T = {ST_PREFILL_T} phase 3 checks K1 at")
    log(f"[st] inference_batch with ckpt_path: {out['n']} utterances in batches of {ST_DECODE_BATCH}, beam "
        f"{dec.decode_config.num_beams}, {ST_NEW_TOKENS} new tokens at most (a random model rarely emits EOS); "
        f"materialized in {out['load_seconds']:.2f} s; decode {out['seconds']:.2f} s, prefill "
        f"{1000 * out['prefill_s'] / out['calls']:.1f} ms/batch, "
        f"{1000 * out['decode_s'] / max(out['decode_steps'], 1):.2f} ms/beam step over {out['decode_steps']} steps, "
        f"{out['generated_tokens']} tokens, RTF {out['rtf']:.4f} "
        f"({out['audio_seconds']:.1f} s of audio); launches {dec_launches}")
    # a random model's text may hold line breaks: the log is compared whole, as written
    with open(out["pred"], encoding="utf-8", newline="") as f:
        text = f.read()
    mine = decode_texts(trainer.model, tokenizer, dec)
    same = sum(f"{line}\n" in text for line in mine)
    log(f"[st] decoded text of the entry point vs the in-memory trained model: {same} / {len(mine)} utterances "
        f"identical")
    print("\n".join(repr(line) for line in mine[:3]))
    if len(mine) != 16 or text != "".join(f"{line}\n" for line in mine):
        raise AssertionError("the reloaded ST model's decode differs from the in-memory trained model's")
    st_bleu(out)
    test = dataset_of(dec, tokenizer, dec.dataset_config.test_split)
    check_reduced_against_cpu(trainer, cfg, next(iter(decode_loader(dec, test))),
                              dataset_of(cfg, tokenizer, cfg.dataset_config.train_split), "st", ST_LAYERS)
    del res, trainer
    shutil.rmtree(tmp)
    total = {k: launches[k] + dec_launches[k] for k in launches}
    missing = [name for name in ST_PATH if total[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the ST path: {missing}")
    return total


# ---------------------------------------------------------------------------
# phase 9: the WavLM recipe (WavLM-large + linear + vicuna-7b, int8 base, bf16 backward)
# ---------------------------------------------------------------------------

W_RECIPE = ROOT / "examples" / "asr_librispeech" / "conf" / "asr_wavlm_vicuna.yaml"
W_STEPS = 4
W_NEW_TOKENS = 32  # decode length (a random model rarely emits EOS)
W_LAYERS = 2  # LLM and encoder depth of the card-vs-CPU checks
# the text buckets of the training batches (up to 100 audio slots, the
# prompt, a target, EOS) and of a decode batch (no target), and the encoder
# frames of a 10 s bucket (160,000 samples), which phase 3 times the kernels at
W_TRAIN_T, W_PREFILL_T, W_ENC_T = (192, 128), (128, 192), 499
W_PATH = ("flash_attention_fwd", "flash_attention_bwd", "rowquant", "int8_matmul", "int8_matmul/wgmma",
          "int8_matmul/splitk")
# vicuna-7b's K2 rows and K3 (K, F) products
W_WIDTHS = {"rowquant": {4096, 11008}, "int8_matmul": {(4096, 4096), (4096, 11008), (11008, 4096)}}
SMI = ""  # the card's name and power limit, set by main


def _wavlm_config(loader, *extra):
    return loader(["--config", str(W_RECIPE), "++model_config.file=__main__:synth_tokenizer_factory", *extra])


def check_wavlm_loaded(model, enc_dir: str) -> None:
    """The loaded encoder equal to the written directory's tensors, and the
    folded positional conv against ``g * v / ||v||`` computed on the card."""
    from slam_llm_tpu_torch.utils.hf_loader import load_hf_state_dict

    sd = load_hf_state_dict(enc_dir)
    enc, n = model.encoder, 0
    last = len(enc.cfg.conv_dim) - 1
    checks = [(enc.feature_extractor.conv_0.weight, "feature_extractor.conv_layers.0.conv.weight"),
              (getattr(enc.feature_extractor, f"ln_{last}").scale,
               f"feature_extractor.conv_layers.{last}.layer_norm.weight"),
              (enc.fp_proj.weight, "feature_projection.projection.weight"),
              (enc.encoder_ln.bias, "encoder.layer_norm.bias"),
              (enc.rel_attn_embed, "encoder.layers.0.attention.rel_attn_embed.weight")]
    for i in sorted({0, enc.cfg.n_layers // 2, enc.cfg.n_layers - 1}):
        layer, src = enc.layers[i], f"encoder.layers.{i}."
        checks += [(layer.attention.q_proj.weight, src + "attention.q_proj.weight"),
                   (layer.attention.out_proj.bias, src + "attention.out_proj.bias"),
                   (layer.attention.gru_rel_pos_linear.weight, src + "attention.gru_rel_pos_linear.weight"),
                   (layer.attention.gru_rel_pos_const, src + "attention.gru_rel_pos_const"),
                   (layer.fc2.weight, src + "feed_forward.output_dense.weight"),
                   (layer.final_layer_norm.scale, src + "final_layer_norm.weight")]
    for got, name in checks:
        if not torch.equal(got.detach().cpu(), sd[name].to(got.dtype)):
            raise AssertionError(f"loaded encoder tensor differs from the written {name}")
        n += 1
    base = "encoder.pos_conv_embed.conv."
    g, v = sd[base + "weight_g"].cuda().float(), sd[base + "weight_v"].cuda().float()
    want = g * v / v.square().sum(dim=(0, 1), keepdim=True).sqrt()
    w = enc.pos_conv.conv.weight
    rel = ((w.float() - want).abs().max() / want.abs().max()).item()
    same = (w == want.to(w.dtype)).float().mean().item()
    log(f"[wavlm] loaded encoder: {n} tensors bit-equal to the written ones; the folded positional conv "
        f"{tuple(w.shape)} against g * v / ||v|| on the card: max rel diff {rel:.2e}, {100 * same:.3f} % identical "
        f"in {w.dtype}")
    if rel > 2 ** -8:
        raise AssertionError(f"the folded positional conv differs from g * v / ||v|| by {rel}")


def check_encoder_against_cpu(label: str, enc, inputs: tuple, expect_k1: bool, min_cos: float = 0.99,
                              kernel: str = "flash_attention_fwd") -> dict:
    """A whole encoder on the card (in its dtype) against the CPU f32 plain
    path on the same weights: the last hidden state's cosine >= ``min_cos``
    at every valid frame, the masks equal; ``kernel`` (K1, or K1's f32
    route) once per layer where the attention takes a key mask (no rel-pos
    bias), never with the bias. Returns the launch counts of the card run."""
    import dataclasses

    with torch.no_grad():
        (out, out_mask), launches = run_counted(lambda: enc(*(None if x is None else x.cuda() for x in inputs)))
        cpu = type(enc)(dataclasses.replace(enc.cfg, dtype=torch.float32)).eval()
        cpu.load_state_dict({k: v.float().cpu() for k, v in enc.state_dict().items()})
        t0 = time.perf_counter()
        ref, ref_mask = cpu(*inputs)
        cpu_s = time.perf_counter() - t0
    live = ref_mask.bool()
    cos = torch.nn.functional.cosine_similarity(out.float().cpu()[live], ref[live], dim=-1)
    k1 = launches[kernel]
    log(f"{label} ({enc.cfg.n_layers} layers, d {enc.cfg.d_model}, {enc.cfg.n_heads} heads, rel-pos bias "
        f"{not expect_k1}) on inputs of {[None if x is None else tuple(x.shape) for x in inputs]}, frames "
        f"{live.sum(1).tolist()} of "
        f"{live.shape[1]}: card "
        f"{enc.cfg.dtype} vs CPU f32 plain path ({cpu_s:.1f} s on CPU): min cosine {cos.min().item():.6f} mean "
        f"{cos.mean().item():.6f}; {kernel} launches {k1}")
    if not (torch.equal(out_mask.cpu(), ref_mask) and bool(torch.isfinite(out).all()) and cos.min().item() >= min_cos):
        raise AssertionError(f"{label}: masks equal {torch.equal(out_mask.cpu(), ref_mask)}, cosine {cos.min().item()} "
                             f"(limit {min_cos})")
    if k1 != (enc.cfg.n_layers if expect_k1 else 0):
        raise AssertionError(f"{label}: {k1} {kernel} launches for {enc.cfg.n_layers} layers (expected: {expect_k1})")
    del cpu
    return launches


def wavlm_encoder_times(trainer, batch) -> dict:
    """The frozen encoder (and the projector) forward of one training batch,
    by CUDA events, and the plain biased attention of one of its layers at
    that batch's shape (CUDA-graph replay), beside SDPA with the same
    additive f32 mask (the library call that computes the same function on
    rows with a live key)."""
    model = trainer.model
    with torch.no_grad():
        enc_ms = event_ms(lambda: model.encode(batch), reps=3)
    c = model.encoder.cfg
    shape = (batch["audio"].shape[0], W_ENC_T, c.n_heads, c.d_model // c.n_heads)
    return dict(encoder_ms=enc_ms, **biased_attention_times(*shape), shape=shape)


def biased_attention_times(b: int, t: int, h: int, d: int) -> dict:
    """The plain attention under a dense (B, H, T, T) f32 bias (row 1's last
    keys padded) by CUDA-graph replay, beside SDPA with the same additive
    mask (the library call that computes the same function on rows with a
    live key)."""
    from slam_llm_tpu_torch.models.layers import mha_attention

    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(b, t, h, d, generator=gen, device="cuda").bfloat16() for _ in range(3))
    bias = torch.randn(b, h, t, t, generator=gen, device="cuda")
    bias[1, :, :, t - 100:] = -0.7 * torch.finfo(torch.float32).max  # a padded row's keys
    attn_ms = time_ms(lambda: mha_attention(q, k, v, bias=bias), reps=3)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias.bfloat16()))
    return dict(attn_ms=attn_ms, sdpa_ms=sdpa_ms)


def run_wavlm() -> dict:
    """Phase 9: asr_wavlm_vicuna at full width: a random bf16 WavLM-large
    HF directory (tools/synth_checkpoint) through ``encoder_path`` and
    vicuna-7b's seeded random init in the int8 base; pipeline.finetune for
    W_STEPS steps of 16 utterances (the projector trains, the bf16 dx goes
    back through 32 frozen int8 layers), pipeline.inference_batch with
    ckpt_path against the in-memory trained model's decode, WER, and the
    card-vs-CPU checks: prefill logits and projector gradients at W_LAYERS
    LLM and encoder layers, and the whole WavLM-large, hubert-large and
    emotion2vec-base encoders on two ragged utterances."""
    global _synth_tokenizer_dir
    import shutil

    from slam_llm_tpu_torch.data.tokenizer import load_tokenizer
    from slam_llm_tpu_torch.models.wavlm import WAVLM_PRESETS, WavLMEncoder
    from slam_llm_tpu_torch.pipeline import finetune, inference_batch
    from slam_llm_tpu_torch.pipeline.common import init_params_
    from slam_llm_tpu_torch.pipeline.inference_batch import decode_loader
    from slam_llm_tpu_torch.tools import synth_checkpoint as synth
    from slam_llm_tpu_torch.utils.checkpoint import load_trainable

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_wavlm_"))
    t0 = time.perf_counter()
    enc_bytes = synth.write_wavlm(str(tmp / "wavlm"), WAVLM_PRESETS["wavlm-large"](), seed=1, device="cuda")
    t1 = time.perf_counter()
    tok_bytes = synth.write_tokenizer(str(tmp / "tokenizer"), 32000, seed=0)
    _synth_tokenizer_dir = str(tmp / "tokenizer")
    tokenizer = load_tokenizer(_synth_tokenizer_dir)
    log(f"[wavlm] wrote WavLM-large bf16 ({enc_bytes / 1e9:.3f} GB, positional conv as weight_g / weight_v) in "
        f"{t1 - t0:.2f} s and a 32000-entry Llama tokenizer ({tok_bytes / 1e6:.2f} MB) in {time.perf_counter() - t1:.2f} s")
    enc_path = f"++model_config.encoder_path={tmp / 'wavlm'}"
    cfg = _wavlm_config(
        finetune.load_run_config, enc_path,
        f"++dataset_config.train_data_path={write_corpus(tmp, n=16 * W_STEPS, name='train')}",
        f"++dataset_config.val_data_path={write_corpus(tmp, n=8, seed=1, name='val')}",
        f"++train_config.max_steps_per_epoch={W_STEPS}", "++train_config.log_interval=1",
        "++train_config.run_validation=false", "++train_config.warmup_steps=2", "++train_config.num_epochs=1",
        f"++train_config.output_dir={tmp / 'out'}",
    )
    mc, dc, tc = cfg.model_config, cfg.dataset_config, cfg.train_config
    if (mc.encoder_name, mc.encoder_config, mc.encoder_projector, mc.llm_name, dc.input_type, dc.normalize,
            tc.batch_size_training, tc.freeze_encoder, tc.freeze_llm, tc.use_peft, tc.shard.base_quant,
            tc.shard.base_quant_bwd) != ("wavlm", "wavlm-large", "linear", "vicuna-7b", "raw", True, 16, True, True,
                                         False, "int8", "bf16"):
        raise AssertionError(f"the WavLM recipe changed: {mc} {dc} {tc}")
    res, launches, stats = _finetune(cfg, "wavlm")
    trainer = res["trainer"]
    c = trainer.model.cfg
    steps = len(res["steps"])
    log(f"[wavlm] model: WavLM-large ({c.encoder.n_layers} layers, d {c.encoder.d_model}, {c.encoder.n_heads} heads, "
        f"{c.encoder.num_buckets} buckets) + linear (ds 5) + vicuna-7b ({c.llm.n_layers} layers, int8 base, "
        f"{c.llm.base_quant_bwd} backward, remat {c.llm.remat_policy}); materialized in {res['load_seconds']:.2f} s; "
        f"step {stats['step_ms']:.1f} ms, {16 / stats['step_ms'] * 1000:.2f} utt/s, peak memory {stats['peak_gib']:.2f} "
        f"GiB ({stats['own_peak_gib']:.2f} of its own); per step K1 {launches['flash_attention_fwd'] / steps:.0f} K4 "
        f"{launches['flash_attention_bwd'] / steps:.0f} K2 {launches['rowquant'] / steps:.0f} K3 "
        f"{launches['int8_matmul'] / steps:.0f} | {SMI}")
    if steps != W_STEPS or not res["checkpoints"]:
        raise AssertionError(f"wavlm: {steps} steps, checkpoints {res['checkpoints']}")
    if {s["shape"][1] for s in res["steps"]} != set(W_TRAIN_T):
        raise AssertionError(f"the training batches' T are not the T = {W_TRAIN_T} phase 3 checks the kernels at")
    if launches["flash_attention_bwd"] != c.llm.n_layers * steps:
        raise AssertionError(f"K4 launched {launches['flash_attention_bwd']} times in {steps} steps of "
                             f"{c.llm.n_layers} layers")
    widths = {"rowquant": set(WIDTHS["rowquant"]), "int8_matmul": set(WIDTHS["int8_matmul"])}
    log(f"[wavlm] launches by width in the training run: K2 {dict(WIDTHS['rowquant'])} K3 {dict(WIDTHS['int8_matmul'])}")
    if not all(W_WIDTHS[k] <= widths[k] for k in W_WIDTHS):
        raise AssertionError(f"K2 / K3 did not launch at vicuna-7b's widths: {widths}")
    check_projector_trained(trainer, cfg, "wavlm")
    check_wavlm_loaded(trainer.model, str(tmp / "wavlm"))
    ckpt = res["checkpoints"][-1]
    saved = load_trainable(ckpt)
    if set(saved) != set(trainer.trainable) or not all(torch.equal(saved[n], p.detach().cpu())
                                                        for n, p in trainer.trainable.items()):
        raise AssertionError("model.pt differs from the trained projector")
    train_ds = dataset_of(cfg, tokenizer, cfg.dataset_config.train_split)
    batch16 = trainer.put_batch(train_ds.collator([train_ds[i] for i in range(48, 64)]))
    enc_times = wavlm_encoder_times(trainer, batch16)
    log(f"[wavlm] encoder + projector forward of a training batch {tuple(batch16['audio'].shape)}: "
        f"{enc_times['encoder_ms']:.2f} ms, {enc_times['encoder_ms'] / stats['step_ms']:.3f} of the step; plain biased "
        f"attention {enc_times['shape']} (the dense (B, H, T, T) rel-pos bias): {enc_times['attn_ms']:.4f} ms a layer, "
        f"{enc_times['attn_ms'] * c.encoder.n_layers:.2f} ms over {c.encoder.n_layers} layers; SDPA with the same "
        f"additive mask {enc_times['sdpa_ms']:.4f} ms | {SMI}")
    del batch16

    dec = _wavlm_config(
        inference_batch.load_run_config, enc_path, f"++ckpt_path={ckpt}",
        f"++dataset_config.val_data_path={write_corpus(tmp, n=16, seed=2, name='test')}",
        f"++decode_config.decode_log={tmp / 'decode'}", f"++decode_config.max_new_tokens={W_NEW_TOKENS}",
    )
    out, dec_launches = run_counted(lambda: inference_batch.main(dec, device="cuda"))
    test_ds = dataset_of(dec, tokenizer, dec.dataset_config.test_split)
    batches = list(decode_loader(dec, test_ds))
    raw_s = sum(float(b["audio_mask"].sum()) for b in batches) / 16000
    log(f"[wavlm] inference_batch with ckpt_path: {out['n']} utterances in batches of {dec.train_config.val_batch_size}"
        f" (T {[b['input_ids'].shape[1] for b in batches]}, audio {[b['audio'].shape[1] for b in batches]} samples), "
        f"beam {dec.decode_config.num_beams}, {W_NEW_TOKENS} new tokens at most; materialized in "
        f"{out['load_seconds']:.2f} s; decode {out['seconds']:.2f} s, prefill "
        f"{1000 * out['prefill_s'] / out['calls']:.1f} ms/batch, "
        f"{1000 * out['decode_s'] / max(out['decode_steps'], 1):.2f} ms/beam step over {out['decode_steps']} steps, "
        f"{out['generated_tokens']} tokens, RTF {out['rtf']:.4f} ({out['audio_seconds']:.3f} s of audio; the raw "
        f"audio_mask counts {raw_s:.3f} s); launches {dec_launches} | {SMI}")
    if abs(raw_s - out["audio_seconds"]) > 1e-6 * raw_s:
        raise AssertionError(f"RTF audio seconds {out['audio_seconds']} differ from the raw audio_mask's {raw_s}")
    if {b["input_ids"].shape[1] for b in batches} != set(W_PREFILL_T):
        raise AssertionError(f"the decode batches' T are not the T = {W_PREFILL_T} phase 3 checks K1 at")
    preds = Path(out["pred"]).read_text().splitlines()
    mine = decode_texts(trainer.model, tokenizer, dec)
    same = sum(a == b for a, b in zip(preds, mine))
    log(f"[wavlm] decoded text of the entry point vs the in-memory trained model: {same} / {len(mine)} lines identical")
    print("\n".join(preds[:3]))
    if len(preds) != 16 or preds != mine:
        raise AssertionError("the reloaded WavLM model's decode differs from the in-memory trained model's")
    check_wer(out, "wavlm")

    check_reduced_against_cpu(trainer, cfg, batches[-1], train_ds, "wavlm", W_LAYERS)

    # whole encoders on two ragged utterances (10 s and 4.1 s of one 160,000-sample bucket)
    two = test_ds.collator([test_ds[15], test_ds[4]])
    audio, mask = torch.from_numpy(two["audio"]), torch.from_numpy(two["audio_mask"])
    enc_launches = check_encoder_against_cpu("[wavlm] wavlm-large (the loaded directory)", trainer.model.encoder,
                                             (audio, mask), expect_k1=False)
    del res, trainer
    gen = torch.Generator(device="cuda").manual_seed(4)
    for preset in ("hubert-large", "emotion2vec-base"):
        enc = init_params_(WavLMEncoder(WAVLM_PRESETS[preset](), device="cuda").eval(), gen)
        got = check_encoder_against_cpu(f"[wavlm] {preset} (random init)", enc, (audio, mask), expect_k1=True)
        enc_launches = {k: enc_launches[k] + got[k] for k in enc_launches}
        del enc
    shutil.rmtree(tmp)
    total = {k: launches[k] + dec_launches[k] + enc_launches[k] for k in launches}
    missing = [name for name in W_PATH if total[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the WavLM path: {missing}")
    return total


# ---------------------------------------------------------------------------
# phase 10: the audio-captioning recipes (EAT-base + linear + vicuna-7b in
# bf16; SLAM-AAC adds LoRA r8 on q / v)
# ---------------------------------------------------------------------------

AAC_RECIPE = ROOT / "examples" / "aac_audiocaps" / "conf" / "aac_eat_vicuna.yaml"
SLAM_AAC_RECIPE = ROOT / "examples" / "slam_aac" / "conf" / "slam_aac_eat_vicuna.yaml"
AAC_STEPS = 4
# LoRA B starts at 0 and step 0's lr is 0 under warmup, so LoRA A first
# receives a gradient at step 2 (the third)
SLAM_AAC_STEPS = 3
AAC_NEW_TOKENS = 32  # decode length (a random model rarely emits EOS)
AAC_DECODE_BATCH = 8
AAC_LAYERS = 2  # LLM and encoder depth of the card-vs-CPU checks
AAC_PATH = ("flash_attention_fwd", "flash_attention_bwd")
AAC_BYPASSED = ("rowquant", "rowquant_rot_sr", "rowquant_fold", "int8_matmul", "int8_matmul_f32")  # no int8 base
# made-up captions in the AudioCaps style
AAC_CAPTIONS = [
    "a dog barks while cars pass by on a wet road",
    "rain falls steadily on a metal roof",
    "a man speaks and a crowd laughs in the distance",
    "birds chirp as wind blows through the trees",
    "a train horn sounds as the train passes",
    "water runs from a faucet into a sink",
    "an engine idles and then revs up loudly",
    "people talk over music in a busy restaurant",
]
# EAT-base's tokens at the recipes' fixed 1024 frames (64 x 8 patches + CLS),
# and the text buckets of the training batches (102 audio slots, the prompt,
# a caption, EOS): aac_eat_vicuna's long prompt, SLAM-AAC's default one
AAC_ENC_T, AAC_TRAIN_T, SLAM_AAC_T = 513, 256, 192


def _recipe_config(recipe, loader, *extra):
    return loader(["--config", str(recipe), "++model_config.file=__main__:synth_tokenizer_factory", *extra])


def check_eat_loaded(model, path: Path) -> None:
    """The loaded EAT-base equal to the written data2vec2 file's tensors,
    the fused qkv split into q / k / v."""
    from slam_llm_tpu_torch.utils.hf_loader import load_torch_checkpoint

    sd = load_torch_checkpoint(str(path))
    enc = model.encoder
    d, n = enc.cfg.d_model, enc.cfg.n_layers
    pre = "modality_encoders.IMAGE."
    checks = [(enc.patch_embed.weight, sd[pre + "local_encoder.proj.weight"]),
              (enc.patch_embed.bias, sd[pre + "local_encoder.proj.bias"]),
              (enc.cls_token, sd[pre + "extra_tokens"].reshape(enc.cls_token.shape)),
              (enc.norm.scale, sd["norm.weight"])]
    for i in sorted({0, n // 2, n - 1}):
        blk, src = enc.blocks[i], f"blocks.{i}."
        qkv_w, qkv_b = sd[src + "attn.qkv.weight"], sd[src + "attn.qkv.bias"]
        checks += [(blk.q_proj.weight, qkv_w[:d]), (blk.k_proj.weight, qkv_w[d:2 * d]),
                   (blk.v_proj.weight, qkv_w[2 * d:]), (blk.k_proj.bias, qkv_b[d:2 * d]),
                   (blk.proj.weight, sd[src + "attn.proj.weight"]), (blk.fc2.bias, sd[src + "mlp.fc2.bias"]),
                   (blk.norm1.scale, sd[src + "norm1.weight"])]
    for got, want in checks:
        if not torch.equal(got.detach().cpu(), want.to(got.dtype)):
            raise AssertionError(f"a loaded EAT tensor {tuple(got.shape)} differs from the written one")
    log(f"[aac] loaded EAT-base: {len(checks)} tensors bit-equal to the written data2vec2 file's (the fused qkv split "
        f"into q / k / v)")


def run_aac() -> dict:
    """Phase 10: aac_eat_vicuna and SLAM-AAC at full width: a random f32
    EAT-base file in the data2vec2 layout (tools/synth_checkpoint) through
    ``encoder_path`` and vicuna-7b's seeded random init in bf16;
    pipeline.finetune for AAC_STEPS steps of 16 fixed-length clips (the
    projector trains, the gradient going back through 32 frozen bf16
    layers), SLAM-AAC for SLAM_AAC_STEPS (LoRA r8 on q / v too),
    pipeline.inference_batch with SLAM-AAC's ckpt_path against the
    in-memory trained model's decode, the caption metrics, the card-vs-CPU
    checks at AAC_LAYERS LLM and encoder layers, and the whole EAT-base and
    BEATs-iter3 encoders on two ragged clips. Returns the launch counts and
    what phase 11 reuses: the directory (which it removes), the EAT file's
    override, SLAM-AAC's checkpoint and the test clips' manifest."""
    global _synth_tokenizer_dir
    import contextlib
    import io

    from slam_llm_tpu_torch.data.tokenizer import load_tokenizer
    from slam_llm_tpu_torch.models.beats import BEATS_PRESETS, BEATsEncoder
    from slam_llm_tpu_torch.models.vit import VIT_PRESETS
    from slam_llm_tpu_torch.pipeline import finetune, inference_batch
    from slam_llm_tpu_torch.pipeline.common import init_params_
    from slam_llm_tpu_torch.pipeline.inference_batch import decode_loader
    from slam_llm_tpu_torch.tools import synth_checkpoint as synth
    from slam_llm_tpu_torch.utils import caption_metrics
    from slam_llm_tpu_torch.utils.checkpoint import load_trainable

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_aac_"))
    eat_path = tmp / "eat.pt"
    t0 = time.perf_counter()
    enc_bytes = synth.write_eat(str(eat_path), VIT_PRESETS["eat-base"](), seed=1, device="cuda")
    t1 = time.perf_counter()
    tok_bytes = synth.write_tokenizer(str(tmp / "tokenizer"), 32000, seed=0)
    _synth_tokenizer_dir = str(tmp / "tokenizer")
    tokenizer = load_tokenizer(_synth_tokenizer_dir)
    log(f"[aac] wrote EAT-base f32 in the data2vec2 layout ({enc_bytes / 1e9:.3f} GB, torch.save) in {t1 - t0:.2f} s "
        f"and a 32000-entry Llama tokenizer ({tok_bytes / 1e6:.2f} MB) in {time.perf_counter() - t1:.2f} s")
    enc_path = f"++model_config.encoder_path={eat_path}"
    common = (enc_path, "++train_config.log_interval=1", "++train_config.run_validation=false",
              "++train_config.warmup_steps=2", "++train_config.num_epochs=1")
    cfg = _recipe_config(
        AAC_RECIPE, finetune.load_run_config, *common,
        f"++dataset_config.train_data_path={write_corpus(tmp, n=16 * AAC_STEPS, name='train', targets=AAC_CAPTIONS)}",
        f"++dataset_config.val_data_path={write_corpus(tmp, n=8, seed=1, name='val', targets=AAC_CAPTIONS)}",
        f"++train_config.max_steps_per_epoch={AAC_STEPS}", f"++train_config.output_dir={tmp / 'out'}",
    )
    mc, dc, tc = cfg.model_config, cfg.dataset_config, cfg.train_config
    if (mc.encoder_name, mc.encoder_config, mc.encoder_projector, mc.encoder_projector_ds_rate, mc.llm_name,
            dc.dataset, dc.encoder_name, dc.fixed_length, dc.target_length, dc.random_crop, tc.batch_size_training,
            tc.freeze_encoder, tc.freeze_llm, tc.use_peft, tc.shard.base_quant) != (
            "eat", "eat-base", "linear", 5, "vicuna-7b", "audio_dataset", "eat", True, 1024, True, 16, True, True,
            False, "none"):
        raise AssertionError(f"the AAC recipe changed: {mc} {dc} {tc}")
    res, launches, stats = _finetune(cfg, "aac")
    trainer = res["trainer"]
    c = trainer.model.cfg
    steps = len(res["steps"])
    k1_step = c.encoder.n_layers + c.llm.n_layers  # the frozen encoder's forward, the LLM's (flash is saved)
    log(f"[aac] model: EAT-base ({c.encoder.n_layers} layers, d {c.encoder.d_model}, {c.encoder.n_heads} heads, "
        f"{AAC_ENC_T} tokens) + linear (ds {c.projector_cfg.ds_rate}) + vicuna-7b ({c.llm.n_layers} layers, "
        f"{c.llm.n_heads} / {c.llm.n_kv_heads} heads, base {c.llm.base_quant}, remat {c.llm.remat_policy}); "
        f"materialized in {res['load_seconds']:.2f} s; step {stats['step_ms']:.1f} ms, "
        f"{16 / stats['step_ms'] * 1000:.2f} utt/s, peak memory {stats['peak_gib']:.2f} GiB "
        f"({stats['own_peak_gib']:.2f} of its own); per step K1 {launches['flash_attention_fwd'] / steps:.0f} "
        f"K4 {launches['flash_attention_bwd'] / steps:.0f} K2 {launches['rowquant'] / steps:.0f} "
        f"K3 {launches['int8_matmul'] / steps:.0f} | {SMI}")
    if steps != AAC_STEPS or not res["checkpoints"]:
        raise AssertionError(f"aac: {steps} steps, checkpoints {res['checkpoints']}")
    if {s["shape"] for s in res["steps"]} != {(16, AAC_TRAIN_T)}:
        raise AssertionError(f"the training batches are not the (16, {AAC_TRAIN_T}) phase 3 checks K1 / K4 at")
    if (launches["flash_attention_fwd"], launches["flash_attention_bwd"]) != (k1_step * steps, c.llm.n_layers * steps):
        raise AssertionError(f"K1 / K4 launched {launches['flash_attention_fwd']} / {launches['flash_attention_bwd']} "
                             f"times in {steps} steps, not {k1_step} / {c.llm.n_layers} a step")
    if any(launches[k] for k in AAC_BYPASSED):
        raise AssertionError(f"K2 / K3 launched on the bf16 base: { {k: launches[k] for k in AAC_BYPASSED} }")
    check_projector_trained(trainer, cfg, "aac")
    check_eat_loaded(trainer.model, eat_path)
    saved = load_trainable(res["checkpoints"][-1])
    if set(saved) != set(trainer.trainable) or not all(torch.equal(saved[n], p.detach().cpu())
                                                        for n, p in trainer.trainable.items()):
        raise AssertionError("model.pt differs from the trained projector")
    train_ds = dataset_of(cfg, tokenizer, cfg.dataset_config.train_split)
    batch16 = trainer.put_batch(train_ds.collator([train_ds[i] for i in range(16)]))
    with torch.no_grad():
        enc_ms = event_ms(lambda: trainer.model.encode(batch16), reps=3)
    log(f"[aac] EAT-base + projector forward of a training batch {tuple(batch16['audio_mel'].shape)}: {enc_ms:.2f} ms "
        f"by CUDA events, {enc_ms / stats['step_ms']:.3f} of the step | {SMI}")
    del batch16, res, trainer, train_ds
    torch.cuda.empty_cache()

    # SLAM-AAC: the same model with LoRA r8 on q / v over the bf16 base
    slam_train = write_corpus(tmp, n=16 * SLAM_AAC_STEPS, name="slam_train", targets=AAC_CAPTIONS)
    cfg2 = _recipe_config(
        SLAM_AAC_RECIPE, finetune.load_run_config, *common, f"++dataset_config.train_data_path={slam_train}",
        f"++dataset_config.val_data_path={write_corpus(tmp, n=8, seed=1, name='val', targets=AAC_CAPTIONS)}",
        f"++train_config.max_steps_per_epoch={SLAM_AAC_STEPS}", f"++train_config.output_dir={tmp / 'slam_out'}",
    )
    tc2, pc = cfg2.train_config, cfg2.train_config.peft_config
    if (tc2.use_peft, pc.r, tuple(pc.target_modules), tc2.shard.base_quant, tc2.batch_size_training) != (
            True, 8, ("q_proj", "v_proj"), "none", 16):
        raise AssertionError(f"the SLAM-AAC recipe changed: {tc2}")
    res2, launches2, stats2 = _finetune(cfg2, "slam_aac")
    trainer2 = res2["trainer"]
    steps2 = len(res2["steps"])
    log(f"[slam_aac] LoRA r{pc.r} on {list(pc.target_modules)} over the bf16 vicuna-7b: step "
        f"{stats2['step_ms']:.1f} ms, {16 / stats2['step_ms'] * 1000:.2f} utt/s, peak memory "
        f"{stats2['peak_gib']:.2f} GiB ({stats2['own_peak_gib']:.2f} of its own); per step K1 {launches2['flash_attention_fwd'] / steps2:.0f} "
        f"K4 {launches2['flash_attention_bwd'] / steps2:.0f} | {SMI}")
    if steps2 != SLAM_AAC_STEPS or {s["shape"] for s in res2["steps"]} != {(16, SLAM_AAC_T)}:
        raise AssertionError(f"slam_aac: steps {[s['shape'] for s in res2['steps']]}")
    if any(launches2[k] for k in AAC_BYPASSED) or (launches2["flash_attention_fwd"], launches2["flash_attention_bwd"]) != (
            k1_step * steps2, c.llm.n_layers * steps2):
        raise AssertionError(f"slam_aac launches {launches2}, not K1 {k1_step} / K4 {c.llm.n_layers} a step")
    check_projector_trained(trainer2, cfg2, "slam_aac", lora=True)
    ckpt = res2["checkpoints"][-1]
    saved = load_trainable(ckpt)
    if set(saved) != set(trainer2.trainable) or not all(torch.equal(saved[n], p.detach().cpu())
                                                         for n, p in trainer2.trainable.items()):
        raise AssertionError("model.pt differs from the trained projector and LoRA factors")

    test_manifest = write_corpus(tmp, n=16, seed=2, name="test", targets=AAC_CAPTIONS)
    dec = _recipe_config(
        SLAM_AAC_RECIPE, inference_batch.load_run_config, enc_path, f"++ckpt_path={ckpt}",
        f"++dataset_config.val_data_path={test_manifest}", f"++decode_config.decode_log={tmp / 'decode'}",
        f"++decode_config.max_new_tokens={AAC_NEW_TOKENS}", f"++train_config.val_batch_size={AAC_DECODE_BATCH}",
    )
    out, dec_launches = run_counted(lambda: inference_batch.main(dec, device="cuda"))
    test_ds = dataset_of(dec, tokenizer, dec.dataset_config.test_split)
    batches = list(decode_loader(dec, test_ds))
    log(f"[slam_aac] inference_batch with ckpt_path: {out['n']} clips in batches of {AAC_DECODE_BATCH} (T "
        f"{[b['input_ids'].shape[1] for b in batches]}, fbank {batches[0]['audio_mel'].shape[1:]}), beam "
        f"{dec.decode_config.num_beams}, {AAC_NEW_TOKENS} new tokens at most; materialized in "
        f"{out['load_seconds']:.2f} s; decode {out['seconds']:.2f} s, prefill "
        f"{1000 * out['prefill_s'] / out['calls']:.1f} ms/batch, "
        f"{1000 * out['decode_s'] / max(out['decode_steps'], 1):.2f} ms/beam step over {out['decode_steps']} steps, "
        f"{out['generated_tokens']} tokens, RTF {out['rtf']:.4f} ({out['audio_seconds']:.2f} s of audio: the clips' "
        f"true seconds, not the 10.24 s of fbank each is padded to); launches {dec_launches} | {SMI}")
    if abs(out["audio_seconds"] - corpus_seconds(16)) > 1e-6 or {b["input_ids"].shape[1] for b in batches} != {
            SLAM_AAC_T}:
        raise AssertionError(f"decode: {out['audio_seconds']} s of audio, not the clips' {corpus_seconds(16)}; "
                             f"T {[b['input_ids'].shape for b in batches]}")
    # a random model's text may hold line breaks: the log is compared whole, as written
    with open(out["pred"], encoding="utf-8", newline="") as f:
        text = f.read()
    mine = decode_texts(trainer2.model, tokenizer, dec)
    log(f"[slam_aac] decoded text of the entry point vs the in-memory trained model: "
        f"{sum(f'{line}' + chr(10) in text for line in mine)} / {len(mine)} clips identical")
    print("\n".join(repr(line) for line in mine[:3]))
    if len(mine) != 16 or text != "".join(f"{line}\n" for line in mine):
        raise AssertionError("the reloaded SLAM-AAC model's decode differs from the in-memory trained model's")
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):  # the CLI's JSON line, parsed back
        metrics = caption_metrics.main(out["gt"], out["pred"])
    log(f"[slam_aac] utils.caption_metrics over the decode logs in {time.perf_counter() - t0:.2f} s on the host: "
        f"{json.dumps(metrics)} (a {SLAM_AAC_STEPS}-step random model: no target)")
    if (json.loads(buf.getvalue()) != metrics or set(metrics) != {
            "bleu_1", "bleu_4", "rouge_l", "meteor", "cider", "spice", "spider"} or not all(
            np.isfinite(v) for v in metrics.values())):
        raise AssertionError(f"caption metrics {metrics}, printed {buf.getvalue()!r}")
    check_reduced_against_cpu(trainer2, cfg2, batches[0], dataset_of(cfg2, tokenizer, cfg2.dataset_config.train_split),
                              "slam_aac", AAC_LAYERS)

    # the whole encoders on two ragged clips (fixed_length: false), 10 s and 4.1 s
    def two_clips(*extra):
        ragged = _recipe_config(AAC_RECIPE, inference_batch.load_run_config, "++dataset_config.fixed_length=false",
                             f"++dataset_config.val_data_path={test_manifest}", *extra)
        ragged.dataset_config.inference_mode = True
        ds = dataset_of(ragged, tokenizer, ragged.dataset_config.test_split)
        two = ds.collator([ds[15], ds[4]])
        return torch.from_numpy(two["audio_mel"]), torch.from_numpy(two["audio_mel_mask"])

    mel, mask = two_clips()
    enc_launches = check_encoder_against_cpu("[aac] EAT-base (the loaded file)", trainer2.model.encoder, (mel, mask),
                                             expect_k1=True)
    del res2, trainer2
    torch.cuda.empty_cache()
    mel, mask = two_clips("++dataset_config.encoder_name=beats", "++dataset_config.fbank_mean=15.41663",
                          "++dataset_config.fbank_std=6.55582")
    beats = init_params_(BEATsEncoder(BEATS_PRESETS["beats-iter3"](), device="cuda").eval(),
                         torch.Generator(device="cuda").manual_seed(4))
    got = check_encoder_against_cpu("[aac] BEATs-iter3 (random init)", beats, (mel, mask), expect_k1=False)
    enc_launches = {k: enc_launches[k] + got[k] for k in enc_launches}
    bc = beats.cfg
    n_feat = (mel.shape[1] // bc.patch_size) * (bc.n_mels // bc.patch_size)
    with torch.no_grad():
        beats_ms = event_ms(lambda: beats(mel.cuda(), mask.cuda()), reps=3)
    times = biased_attention_times(2, n_feat, bc.n_heads, bc.d_model // bc.n_heads)
    log(f"[aac] BEATs-iter3 forward of {tuple(mel.shape)}: {beats_ms:.2f} ms by CUDA events; plain biased attention "
        f"{(2, n_feat, bc.n_heads, bc.d_model // bc.n_heads)} (the dense (B, H, T, T) rel-pos bias): "
        f"{times['attn_ms']:.4f} ms a layer, {times['attn_ms'] * bc.n_layers:.2f} ms over {bc.n_layers} layers; SDPA "
        f"with the same additive mask {times['sdpa_ms']:.4f} ms | {SMI}")
    del beats
    total = {k: launches[k] + launches2[k] + dec_launches[k] + enc_launches[k] for k in launches}
    missing = [name for name in AAC_PATH if total[name] == 0]
    if missing or any(total[k] for k in AAC_BYPASSED):
        raise AssertionError(f"kernels never launched on the AAC path: {missing}; K2 / K3 launched: "
                             f"{ {k: total[k] for k in AAC_BYPASSED} }")
    log(f"[aac] phase 10 in {time.perf_counter() - t_phase:.1f} s")
    # phase 11 decodes the same clips with the same files; it removes tmp
    return total, dict(tmp=tmp, enc_path=enc_path, ckpt=ckpt, test_manifest=test_manifest)


# ---------------------------------------------------------------------------
# phase 11: CLAP (HTSAT-base + BERT-base) with CLAP-Refine and FENSE on
# SLAM-AAC's decode, and DRCap (CLAP latents + linear + vicuna-7b in bf16)
# ---------------------------------------------------------------------------

DRCAP_RECIPE = ROOT / "examples" / "drcap_zeroshot_aac" / "conf" / "drcap.yaml"
DRCAP_STEPS = 3
DRCAP_SUPPORT = 512  # captions in the support store
DRCAP_DECODE = 8  # clips decoded
DRCAP_LAYERS = 2  # LLM depth of the card-vs-CPU check
REFINE_BEAMS = 4  # num_return_sequences of SLAM-AAC's decode, the candidates CLAP-Refine picks from
# a random model's text has no spaces, so BERT's WordPiece splits it letter
# by letter: longer candidates would fill its 64 pieces with their shared
# prefix and leave CLAP-Refine only ties
REFINE_NEW_TOKENS = 8
CLAP_PATH = ("flash_attention_fwd", "flash_attention_bwd")
_SUBJECTS = ("a dog", "a man", "a woman", "a child", "birds", "a car", "a train", "rain", "wind", "water",
             "an engine", "people", "a crowd", "a bell", "a cat", "thunder")
_ACTIONS = ("barks", "speaks softly", "sings", "chirp", "passes by", "falls steadily", "blows hard", "runs",
            "idles", "talk", "cheers", "rings twice", "meows", "rumbles", "hums", "whistles")
_PLACES = ("in the distance", "on a busy street", "near a river", "inside a small room", "in the rain",
           "on a metal roof", "at night", "in a park", "over loud music", "while cars pass", "by the sea",
           "in a forest", "in a kitchen", "on a train platform", "behind a door", "under a bridge")


def drcap_captions(n: int = DRCAP_SUPPORT, seed: int = 0) -> list:
    """``n`` distinct made-up captions in the AudioCaps style."""
    rng = np.random.default_rng(seed)
    out = {}
    while len(out) < n:
        s, a, p = (int(rng.integers(16)) for _ in range(3))
        out.setdefault(f"{_SUBJECTS[s]} {_ACTIONS[a]} {_PLACES[p]}")
    return list(out)


def _drcap_config(loader, *extra):
    return loader(["--config", str(DRCAP_RECIPE), "++model_config.file=__main__:synth_tokenizer_factory", *extra])


def _clap_vs_cpu(model, mels, texts, tok, cands, selection) -> None:
    """The whole CLAP on the card against a CPU f32 copy: ``encode_audio`` of
    the first 2 clips and ``encode_text`` of 4 captions, cosine >= 0.999 a
    row; and the CLAP-Refine choice of every key whose top-2 similarity
    margin on the CPU exceeds 1e-4 equal to the card's ``selection``."""
    from slam_llm_tpu_torch.models.clap import CLAP, embed_texts

    cpu = CLAP(model.cfg, device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    t0 = time.perf_counter()
    with torch.inference_mode():
        two = torch.from_numpy(np.stack(list(mels.values())[:2]))
        ca = torch.nn.functional.cosine_similarity(model.encode_audio(two.cuda()).cpu(), cpu.encode_audio(two), dim=-1)
        ct = torch.nn.functional.cosine_similarity(torch.from_numpy(embed_texts(model, tok, texts[:4])),
                                                   torch.from_numpy(embed_texts(cpu, tok, texts[:4])), dim=-1)
        za = cpu.encode_audio(torch.from_numpy(np.stack([mels[k] for k in cands]))).numpy()
    agree, kept = 0, 0
    for i, (key, options) in enumerate(cands.items()):
        sims = embed_texts(cpu, tok, options) @ za[i]
        top = np.sort(sims)
        if top[-1] - top[-2] > 1e-4:
            kept += 1
            agree += selection[key] == options[int(np.argmax(sims))]
    cpu_s = time.perf_counter() - t0
    log(f"[clap] CLAP-base card vs CPU f32 ({cpu_s:.1f} s on CPU): encode_audio of 2 clips min cosine "
        f"{ca.min().item():.6f}, encode_text of 4 captions min cosine {ct.min().item():.6f}; CLAP-Refine choice "
        f"equal on {agree} of the {kept} keys (of {len(cands)}) whose top-2 margin exceeds 1e-4")
    if ca.min().item() < 0.999 or ct.min().item() < 0.999 or agree != kept:
        raise AssertionError(f"CLAP card vs CPU: audio cosine {ca.min().item()}, text {ct.min().item()}, refine "
                             f"choice equal on {agree} of {kept} keys")


def clap_speed_rows(model, one, ids, mask) -> dict:
    """The plain attention of BERT-base (the candidates' batch, 12 heads of
    64, the -1e9 key mask) and of HTSAT-base's first stage (one clip: 64
    windows of 64 tokens, 4 heads of 24, the bias table and the shift mask)
    in f32 as ``models/bert.py`` / ``models/htsat.py`` compute it, beside
    SDPA with the same additive mask (CUDA-graph replay); and the whole
    CLAP encoders in f32 beside bf16 autocast (CUDA events)."""
    from slam_llm_tpu_torch.models.htsat import relative_position_index, shift_attn_mask

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for name, (b, t, h, d), bias in (
            ("bert", (ids.shape[0], ids.shape[1], 12, 64),
             torch.where(mask[:, None, None, :] > 0, 0.0, -1e9).float()),
            ("htsat", (64, 64, 4, 24),
             (torch.randn(225, 4, generator=gen, device="cuda")[torch.from_numpy(relative_position_index(8).reshape(
                 -1)).cuda()].reshape(64, 64, 4).permute(2, 0, 1)[None]
              + torch.from_numpy(shift_attn_mask(64, 64, 8, 4)).cuda()[:, None]))):
        q, k, v = (torch.randn(b, h, t, d, generator=gen, device="cuda") for _ in range(3))

        def plain():
            probs = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k) / d ** 0.5 + bias, dim=-1)
            return torch.einsum("bhqk,bhkd->bhqd", probs, v)

        out[f"{name}_plain_ms"], out[f"{name}_sdpa_ms"] = time_ms(plain), time_ms(lambda: sdpa(q, k, v, attn_mask=bias))
        out[f"{name}_shape"] = (b, t, h, d)
    with torch.inference_mode():
        for tower, fn in (("audio", lambda: model.encode_audio(one)), ("text", lambda: model.encode_text(ids, mask))):
            out[f"{tower}_f32_ms"] = event_ms(fn, reps=5)
            with torch.autocast("cuda", dtype=torch.bfloat16):
                out[f"{tower}_bf16_ms"] = event_ms(fn, reps=5)
    return out


def run_clap(aac: dict) -> dict:
    """Phase 11: full-width CLAP (HTSAT-base + BERT-base-uncased, 1024 wide,
    f32) from a reference-layout ASE file, and FENSE's SBERT / echecker, all
    written by tools/synth_checkpoint. (a) SLAM-AAC's decode of phase 10's
    clips with ``num_return_sequences`` 4 through pipeline.inference_batch,
    reranked by ``utils.clap_refine.clap_refine_with_model`` and scored with
    the caption metrics, FENSE included. (b) DRCap (drcap.yaml): a support
    store of DRCAP_SUPPORT captions, a RAG manifest, DRCAP_STEPS training
    steps of 16 text latents through the trainer's step (the projector
    trains; the gradient crosses the frozen bf16 vicuna-7b), then the decode
    of DRCAP_DECODE clips: CLAP audio latent -> projection decode onto the
    store -> the top 3 captions in the prompt -> beam 4. The card-vs-CPU
    checks: the whole CLAP, and DRCap at DRCAP_LAYERS LLM layers."""
    import shutil

    from slam_llm_tpu_torch.data.tokenizer import load_tokenizer
    from slam_llm_tpu_torch.inference.generate import Generator
    from slam_llm_tpu_torch.models.clap import CLAPConfig, embed_texts, load_clap
    from slam_llm_tpu_torch.pipeline import finetune, inference_batch
    from slam_llm_tpu_torch.pipeline.common import build_model_and_data, materialize_params
    from slam_llm_tpu_torch.tools import synth_checkpoint as synth
    from slam_llm_tpu_torch.train.state import Trainer
    from slam_llm_tpu_torch.utils import caption_metrics, clap_refine, drcap
    from slam_llm_tpu_torch.utils.fense import FenseScorer, WordPieceTokenizer

    t_phase = time.perf_counter()
    tmp, cfg = aac["tmp"], CLAPConfig()
    captions = drcap_captions()
    words = captions + AAC_CAPTIONS
    t0 = time.perf_counter()
    sizes = dict(clap=synth.write_clap(str(tmp / "clap" / "clap.pt"), cfg, seed=7, device="cuda"),
                 vocab=synth.write_bert_vocab(str(tmp / "clap" / "vocab.txt"), cfg.bert.vocab_size, words=words),
                 sbert=synth.write_sbert(str(tmp / "sbert"), seed=8, device="cuda", words=words),
                 echecker=synth.write_echecker(str(tmp / "echecker.ckpt"), seed=9, device="cuda"))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = load_clap(str(tmp / "clap" / "clap.pt"), cfg, "cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    tok = WordPieceTokenizer(str(tmp / "clap" / "vocab.txt"))
    n_bytes = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    log(f"[clap] wrote the ASE file (HTSAT-base {cfg.htsat.depths} x {cfg.htsat.embed_dim}, BERT-base, embed "
        f"{cfg.embed_dim}), a {cfg.bert.vocab_size}-line vocab.txt, the SBERT directory and the echecker ({sizes} "
        f"bytes) in {write_s:.2f} s; loaded CLAP on the card through convert_ase_torch_state in {load_s:.2f} s: "
        f"{n_bytes / 1e9:.3f} GB of f32 parameters")

    # (a) SLAM-AAC's candidates, CLAP-Refine, the caption metrics with FENSE
    dec = _recipe_config(
        SLAM_AAC_RECIPE, inference_batch.load_run_config, aac["enc_path"], f"++ckpt_path={aac['ckpt']}",
        f"++dataset_config.val_data_path={aac['test_manifest']}", f"++decode_config.decode_log={tmp / 'refine'}",
        f"++decode_config.max_new_tokens={REFINE_NEW_TOKENS}", f"++train_config.val_batch_size={AAC_DECODE_BATCH}",
        f"++decode_config.num_return_sequences={REFINE_BEAMS}",
    )
    out, launches_a = run_counted(lambda: inference_batch.main(dec, device="cuda"))
    cands = clap_refine.read_candidates([out["pred"]])
    log(f"[clap] SLAM-AAC inference_batch, beam {dec.decode_config.num_beams} with num_return_sequences "
        f"{REFINE_BEAMS}: {out['n']} clips, {sum(map(len, cands.values()))} candidate lines; decode "
        f"{out['seconds']:.2f} s, prefill {1000 * out['prefill_s'] / out['calls']:.1f} ms/batch, "
        f"{1000 * out['decode_s'] / max(out['decode_steps'], 1):.2f} ms/beam step, RTF {out['rtf']:.4f} over "
        f"{out['audio_seconds']:.2f} s of audio (the clips' true seconds); launches {launches_a} | {SMI}")
    if out["n"] != 16 or sorted(map(len, cands.values())) != [REFINE_BEAMS] * 16:
        raise AssertionError(f"{out['n']} clips, candidates a key {sorted(map(len, cands.values()))}")
    if abs(out["audio_seconds"] - corpus_seconds(16)) > 1e-6:
        raise AssertionError(f"the RTF counts {out['audio_seconds']} s, not the clips' {corpus_seconds(16)}")
    t0 = time.perf_counter()
    selection = clap_refine.clap_refine_with_model([out["pred"]], str(tmp / "clap" / "clap.pt"),
                                                   str(aac["test_manifest"]), str(tmp / "refined"), cfg=cfg,
                                                   device="cuda")
    refine_s = time.perf_counter() - t0
    if set(selection) != set(cands) or any(selection[k] not in cands[k] for k in cands):
        raise AssertionError("a refined caption is not one of its key's candidates")
    changed = sum(selection[k] != cands[k][0] for k in cands)
    distinct = sum(len({tuple(tok.encode(t)) for t in options}) > 1 for options in cands.values())
    mels = {k: clap_refine.clip_mel(src, cfg) for k, src in clap_refine.read_manifest(str(aac["test_manifest"])).items()}
    one = torch.from_numpy(mels["utt0"])[None].cuda()
    texts = [t for options in cands.values() for t in options]
    ids, mask = (torch.from_numpy(x).cuda() for x in tok.batch(texts))
    with torch.inference_mode():
        audio_ms = event_ms(lambda: model.encode_audio(one), reps=5)
        text_ms = event_ms(lambda: model.encode_text(ids, mask), reps=5) / len(texts)
    scorer = FenseScorer(str(tmp / "sbert"), str(tmp / "echecker.ckpt"), device="cuda")
    gts = caption_metrics._read_log(out["gt"])
    refs, chosen = [gts[k] for k in selection], list(selection.values())
    t0 = time.perf_counter()
    fense = scorer.score(chosen, refs)
    fense_ms = 1000 * (time.perf_counter() - t0)
    metrics = caption_metrics.compute_caption_metrics(chosen, refs, fense_embed_fn=scorer.embed,
                                                      fense_fluency_fn=scorer.fluency_errors)
    log(f"[clap] CLAP-Refine: {len(selection)} keys reranked in {refine_s:.2f} s (load included), {distinct} with "
        f"candidates that differ in BERT's word pieces, {changed} picked another candidate than the beam's best; CLAP-base audio embed {audio_ms:.2f} ms a clip "
        f"{tuple(one.shape)}, text embed {text_ms:.3f} ms a candidate ({len(texts)} in one batch {tuple(ids.shape)}), "
        f"by CUDA events; FENSE over {len(chosen)} captions {fense_ms:.1f} ms wall (SBERT {scorer.sbert.cfg.d_model} "
        f"wide x {scorer.sbert.cfg.n_layers}, echecker {scorer.echecker.cfg.d_model} x "
        f"{scorer.echecker.cfg.n_layers}) | {SMI}")
    log(f"[clap] caption metrics of the refined captions (random weights: no target): {json.dumps(metrics)}")
    rows = clap_speed_rows(model, one, ids, mask)
    log(f"[clap] plain attention vs SDPA (f32, the same additive mask, graph replay): BERT-base "
        f"{rows['bert_shape']} {rows['bert_plain_ms']:.4f} vs {rows['bert_sdpa_ms']:.4f} ms a layer; HTSAT-base stage "
        f"0 windows {rows['htsat_shape']} {rows['htsat_plain_ms']:.4f} vs {rows['htsat_sdpa_ms']:.4f} ms a block; "
        f"CLAP f32 vs bf16 autocast (CUDA events): encode_audio of one clip {rows['audio_f32_ms']:.2f} vs "
        f"{rows['audio_bf16_ms']:.2f} ms, encode_text of {len(texts)} candidates {rows['text_f32_ms']:.2f} vs "
        f"{rows['text_bf16_ms']:.2f} ms | {SMI}")
    if not ("fense" in metrics and abs(metrics["fense"] - round(fense, 4)) < 1e-4
            and all(np.isfinite(v) for v in metrics.values())):
        raise AssertionError(f"caption metrics {metrics}, FENSE {fense}")
    _clap_vs_cpu(model, mels, texts, tok, cands, selection)
    del scorer
    torch.cuda.empty_cache()

    # (b) DRCap: the support store, the RAG manifest, training on text latents
    def embed(texts_):
        return embed_texts(model, tok, texts_)

    t0 = time.perf_counter()
    with torch.inference_mode():
        support = drcap.encode_captions(captions, lambda i, m: model.encode_text(
            torch.from_numpy(i).cuda(), torch.from_numpy(m).cuda()), tok)
    store_s = time.perf_counter() - t0
    drcap.save_support(str(tmp / "support"), captions, support)
    captions, support = drcap.load_support(str(tmp / "support"))
    targets = [captions[(7 * i) % DRCAP_SUPPORT] for i in range(16 * DRCAP_STEPS)]
    train = write_corpus(tmp, n=16 * DRCAP_STEPS, name="drcap_train", targets=targets)
    drcap.augment_manifest_with_rag(str(train), str(tmp / "drcap_rag.jsonl"), captions, support, embed, k=3)
    rag = [json.loads(line) for line in open(tmp / "drcap_rag.jsonl")]
    if any(len(r["similar_captions"]) != 3 or r["target"] in r["similar_captions"] for r in rag):
        raise AssertionError("a RAG row lacks 3 similar captions or retrieved its own")
    cfg_b = _drcap_config(
        finetune.load_run_config, f"++dataset_config.train_data_path={tmp / 'drcap_rag.jsonl'}",
        f"++dataset_config.val_data_path={tmp / 'drcap_rag.jsonl'}", "++train_config.warmup_steps=2",
    )
    mc, dc, tc = cfg_b.model_config, cfg_b.dataset_config, cfg_b.train_config
    if (mc.encoder_name, mc.encoder_dim, mc.encoder_projector, mc.encoder_projector_ds_rate, mc.llm_name,
            dc.dataset, dc.fix_length_audio, tc.batch_size_training, tc.freeze_llm, tc.use_peft, tc.shard.base_quant,
            cfg_b.decode_config.num_beams, cfg_b.decode_config.max_new_tokens) != (
            None, cfg.embed_dim, "linear", 1, "vicuna-7b", "speech_dataset", 1, 16, True, False, "none", 4, 64):
        raise AssertionError(f"the DRCap recipe changed: {mc} {dc} {tc}")
    t0 = time.perf_counter()
    llm_model, llm_tok, ds = build_model_and_data(cfg_b, split="train", device="cuda")
    materialize_params(llm_model, cfg_b)
    build_s = time.perf_counter() - t0
    trainer = Trainer(llm_model, llm_model.cfg, tc).state_from_params()
    train_ds = drcap.LatentCaptionDataset(ds, embed([r["target"] for r in rag]))
    batches = [trainer.put_batch(train_ds.collator([train_ds[i] for i in range(16 * s, 16 * s + 16)]))
               for s in range(DRCAP_STEPS)]
    shapes = {tuple(b["input_ids"].shape) for b in batches} | {tuple(b["audio_mel"].shape) for b in batches}
    if len(shapes) != 2 or (16, 1, cfg.embed_dim) not in shapes or not any((16, t) in shapes for t in W_TRAIN_T):
        raise AssertionError(f"DRCap's batches {shapes} are not at a T phase 3 checks K1 / K4 at ({W_TRAIN_T})")
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    def steps():
        times, losses = [], []
        for b in batches:
            t0 = time.perf_counter()
            m = trainer.train_step(b)
            losses.append(float(m["loss"]))  # waits for the step
            times.append(time.perf_counter() - t0)
        return times, losses

    (times, losses), launches_b = run_counted(steps)
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.mean(times[1:]))
    n_layers = llm_model.cfg.llm.n_layers
    log(f"[drcap] support store of {len(captions)} captions embedded in {store_s:.2f} s; RAG manifest of {len(rag)} "
        f"rows (k 3, itself excluded); vicuna-7b built and materialized in {build_s:.2f} s; {DRCAP_STEPS} steps of "
        f"batch {tuple(batches[0]['input_ids'].shape)}: losses {[round(x, 5) for x in losses]}, step {1000 * step_s:.1f} ms (mean of "
        f"steps 2-{DRCAP_STEPS}), {16 / step_s:.2f} utt/s, peak memory {peak / 2**30:.2f} GiB "
        f"({(peak - base) / 2**30:.2f} of its own); per step K1 {launches_b['flash_attention_fwd'] / DRCAP_STEPS:.0f} "
        f"K4 {launches_b['flash_attention_bwd'] / DRCAP_STEPS:.0f} K2 {launches_b['rowquant'] / DRCAP_STEPS:.0f} "
        f"K3 {launches_b['int8_matmul'] / DRCAP_STEPS:.0f} | {SMI}")
    if not all(np.isfinite(losses)) or (launches_b["flash_attention_fwd"], launches_b["flash_attention_bwd"]) != (
            n_layers * DRCAP_STEPS, n_layers * DRCAP_STEPS) or any(launches_b[k] for k in AAC_BYPASSED):
        raise AssertionError(f"DRCap training: losses {losses}, launches {launches_b} (K1 = K4 = {n_layers} a step, "
                             f"K2 = K3 = 0)")
    check_projector_trained(trainer, cfg_b, "drcap")

    # (b) DRCap's decode: audio latent -> projection decode -> retrieval -> beam 4
    keys = [f"utt{i}" for i in range(DRCAP_DECODE)]
    sources = clap_refine.read_manifest(str(aac["test_manifest"]))
    t0 = time.perf_counter()
    with torch.inference_mode():
        za = model.encode_audio(torch.from_numpy(np.stack([mels[k] for k in keys])).cuda()).cpu().numpy()
    latents = drcap.projection_decode(za, support, 0.07)
    similar = drcap.retrieve_topk(latents, support, captions, k=3)
    retrieve_s = time.perf_counter() - t0
    with open(tmp / "drcap_test.jsonl", "w") as f:
        for key, sims in zip(keys, similar):
            f.write(json.dumps({"key": key, "source": sources[key], "target": "", "similar_captions": sims}) + "\n")
    dec_b = _drcap_config(inference_batch.load_run_config, f"++dataset_config.val_data_path={tmp / 'drcap_test.jsonl'}")
    dec_b.dataset_config.inference_mode = True
    test_ds = drcap.LatentCaptionDataset(dataset_of(dec_b, llm_tok, dec_b.dataset_config.test_split), latents)
    batch = test_ds.collator([test_ds[i] for i in range(DRCAP_DECODE)])
    if batch["input_ids"].shape[1] not in W_PREFILL_T:
        raise AssertionError(f"DRCap's prefill T {batch['input_ids'].shape[1]} is not one phase 3 checks ({W_PREFILL_T})")
    gen = Generator(trainer.model.eval(), inference_batch.generation_config(dec_b, llm_tok))
    arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    t0 = time.perf_counter()
    tokens, launches_d = run_counted(lambda: gen.generate(arrays))
    gen_s = time.perf_counter() - t0
    st = gen.stats
    lines = [llm_tok.decode(t) for t in inference_batch.strip_after_eos(tokens, llm_tok.eos_token_id,
                                                                       llm_tok.pad_token_id)]
    log(f"[drcap] decode of {DRCAP_DECODE} clips (prefill T {batch['input_ids'].shape[1]}, beam "
        f"{dec_b.decode_config.num_beams}, {dec_b.decode_config.max_new_tokens} new tokens at most): CLAP audio "
        f"latents + projection decode (temp 0.07) + top-3 retrieval {1000 * retrieve_s:.1f} ms, generate "
        f"{gen_s:.2f} s (prefill {1000 * st['prefill_s']:.1f} ms, {1000 * st['decode_s'] / max(st['decode_steps'], 1):.2f}"
        f" ms/beam step over {st['decode_steps']} steps); RTF {gen_s / batch['audio_seconds']:.4f} (generate alone), "
        f"{(gen_s + retrieve_s) / batch['audio_seconds']:.4f} (with CLAP and retrieval) over "
        f"{batch['audio_seconds']:.2f} s of audio; launches {launches_d} | {SMI}")
    print("\n".join(repr(line) for line in lines[:3]))
    if tokens.shape[0] != DRCAP_DECODE or launches_d["flash_attention_fwd"] == 0 or any(
            launches_d[k] for k in AAC_BYPASSED):
        raise AssertionError(f"DRCap decode: {tokens.shape} tokens, launches {launches_d}")
    check_reduced_against_cpu(trainer, cfg_b, batch, train_ds, "drcap", DRCAP_LAYERS)
    del trainer, llm_model, model, gen
    torch.cuda.empty_cache()
    shutil.rmtree(tmp)
    total = {k: launches_a[k] + launches_b[k] + launches_d[k] for k in launches_a}
    missing = [name for name in CLAP_PATH if total[name] == 0]
    if missing or any(total[k] for k in AAC_BYPASSED):
        raise AssertionError(f"kernels never launched on the CLAP path: {missing}; K2 / K3 launched: "
                             f"{ {k: total[k] for k in AAC_BYPASSED} }")
    log(f"[clap] phase 11 in {time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# phase 12: SELD (Spatial-AST-base in f32 + Q-Former), music captioning
# (MusicFM-MSD + linear) and SEC (emotion2vec-base + Q-Former, then the
# E-chat dialogs), each with vicuna-7b in bf16
# ---------------------------------------------------------------------------

SELD_RECIPE = ROOT / "examples" / "seld_spatialsoundqa" / "conf" / "seld_spatialast_llama.yaml"
MC_RECIPE = ROOT / "examples" / "mc_musiccaps" / "conf" / "mc_musicfm_vicuna.yaml"
SEC_RECIPE = ROOT / "examples" / "sec_emotioncaps" / "conf" / "sec_emotion2vec_vicuna.yaml"
MS_STEPS = 4
ECHAT_STEPS = 2
MS_NEW_TOKENS = 32  # decode length (a random model rarely emits EOS)
MS_DECODE_BATCH = 8
MS_LAYERS = 2  # LLM and encoder depth of the card-vs-CPU checks
# a Q-Former key bias's gradient / its query bias's, both sides: under near-uniform attention
# K4's bf16 dS leaves about a tenth (SELD on an H100), a dS without delta above 1
MS_KEY_BIAS_LIMIT = 0.3
SA_T = 515  # Spatial-AST's tokens: 3 CLS + 64 x 8 patches of the 1024-frame resize
MC_ENC_T = 251  # MusicFM's frames for a 10 s crop: 1001 mel frames / 4
ECHAT_T = 512  # the E-chat variant's text bucket (its long default prompt)
SEC_CAPTIONS = ["the speaker sounds happy and excited", "a calm, neutral voice", "the woman speaks with sadness",
                "an angry man raises his voice", "she sounds surprised and pleased", "a tired and bored tone"]


def _recipe_phase(label: str, recipe: Path, tmp: Path, tokenizer, train_args: tuple, test_args: tuple,
                  batch: int = 16, audio_seconds: float = None, text_t: tuple = None):
    """One phase-12 / 13 / 14 recipe through both entry points at full width:
    pipeline.finetune for MS_STEPS steps of ``batch`` (the projector trains, and
    the encoder where ``train_args`` unfreeze it; the rest and the bf16
    vicuna-7b stay bit-unchanged; K1 / K4 launch once a layer a step, K1's
    f32 route once a Spatial-AST layer and K4's too when it trains, K2 = K3
    = 0), the encoder's share of the step, pipeline.inference_batch with
    ckpt_path (beam 4, batches of 8) against the in-memory trained model's
    decode, and the card-vs-CPU checks at MS_LAYERS LLM and encoder layers
    (the loss within 1 %; the gradient gate on the encoder's tensors when it
    trains, on every tensor otherwise); ``audio_seconds`` and ``text_t``,
    where given, the seconds the decode's RTF must count and the text
    buckets phase 3 checks the batches at. Returns the trainer, the launches of
    both runs and the test dataset."""
    from slam_llm_tpu_torch.pipeline import finetune, inference_batch
    from slam_llm_tpu_torch.pipeline.inference_batch import decode_loader
    from slam_llm_tpu_torch.utils.checkpoint import load_trainable

    t_phase = time.perf_counter()
    cfg = _recipe_config(recipe, finetune.load_run_config, *train_args, "++train_config.log_interval=1",
                         "++train_config.run_validation=false", "++train_config.warmup_steps=2",
                         "++train_config.num_epochs=1", f"++train_config.max_steps_per_epoch={MS_STEPS}",
                         f"++train_config.output_dir={tmp / 'out'}")
    tc = cfg.train_config
    if (cfg.model_config.llm_name, tc.batch_size_training, tc.freeze_llm, tc.use_peft,
            tc.shard.base_quant) != ("vicuna-7b", batch, True, False, "none"):
        raise AssertionError(f"the {label} recipe changed: {cfg.model_config} {tc}")
    res, launches, stats = _finetune(cfg, label)
    trainer = res["trainer"]
    c = trainer.model.cfg
    steps = len(res["steps"])
    qformer = c.projector_cfg.qformer_layers if c.projector == "q-former" else 0
    f32 = c.encoder_name == "spatial_ast"
    enc_trains = not c.freeze_encoder
    bf16_enc, f32_enc = (0, c.encoder.n_layers) if f32 else (c.encoder.n_layers, 0)
    per_step = {"flash_attention_fwd": bf16_enc + qformer + c.llm.n_layers,
                "flash_attention_fwd_f32": f32_enc,
                "flash_attention_bwd": bf16_enc * enc_trains + qformer + c.llm.n_layers,
                "flash_attention_bwd_f32": f32_enc * enc_trains}
    log(f"[{label}] model: {c.encoder_name} ({c.encoder.n_layers} layers, d {c.encoder.d_model}, "
        f"{c.encoder.n_heads} heads, {c.encoder.dtype}) + {c.projector} + vicuna-7b ({c.llm.n_layers} layers, base "
        f"{c.llm.base_quant}, remat {c.llm.remat_policy if c.llm.remat else 'off'}); materialized in "
        f"{res['load_seconds']:.2f} s; step {stats['step_ms']:.1f} ms, {batch / stats['step_ms'] * 1000:.2f} utt/s, peak "
        f"memory {stats['peak_gib']:.2f} GiB ({stats['own_peak_gib']:.2f} of its own); per step "
        f"{ {k: launches[k] / steps for k in per_step} } | {SMI}")
    if steps != MS_STEPS or not res["checkpoints"]:
        raise AssertionError(f"{label}: {steps} steps, checkpoints {res['checkpoints']}")
    if {k: launches[k] for k in per_step} != {k: v * steps for k, v in per_step.items()}:
        raise AssertionError(f"{label}: launches {launches}, not {per_step} a step")
    check_projector_trained(trainer, cfg, label, trained=("encoder_projector.",) + ("encoder.",) * enc_trains)
    saved = load_trainable(res["checkpoints"][-1])
    if set(saved) != set(trainer.trainable) or not all(torch.equal(saved[n], p.detach().cpu())
                                                        for n, p in trainer.trainable.items()):
        raise AssertionError(f"{label}: model.pt differs from the trained tensors")
    train_ds = dataset_of(cfg, tokenizer, cfg.dataset_config.train_split)
    train_batch = trainer.put_batch(train_ds.collator([train_ds[i] for i in range(batch)]))
    with torch.no_grad():
        enc_ms = event_ms(lambda: trainer.model.encode(train_batch), reps=3)
    audio_key = next(k for k in ("audio_binaural", "audio_mel", "audio", "visual") if k in train_batch)
    log(f"[{label}] encoder + projector forward of a training batch {audio_key} {tuple(train_batch[audio_key].shape)}: "
        f"{enc_ms:.2f} ms by CUDA events, {enc_ms / stats['step_ms']:.3f} of the step | {SMI}")
    if enc_trains:  # forward + backward to the encoder's and the projector's tensors, a random cotangent
        params = [p for n, p in trainer.model.named_parameters() if n.startswith("encoder")]
        gen = torch.Generator(device="cuda").manual_seed(3)

        def enc_fwd_bwd():
            h = trainer.model.encode(train_batch)[0]
            torch.autograd.grad(h, params, torch.randn(h.shape, generator=gen, device="cuda", dtype=h.dtype))

        fb_ms = event_ms(enc_fwd_bwd, reps=3)
        log(f"[{label}] encoder + projector forward + backward of that batch: {fb_ms:.2f} ms by CUDA events, "
            f"{fb_ms / stats['step_ms']:.3f} of the step | {SMI}")
    del train_batch

    dec = _recipe_config(recipe, inference_batch.load_run_config, *test_args, f"++ckpt_path={res['checkpoints'][-1]}",
                         f"++decode_config.decode_log={tmp / 'decode'}",
                         f"++decode_config.max_new_tokens={MS_NEW_TOKENS}",
                         f"++train_config.val_batch_size={MS_DECODE_BATCH}")
    out, dec_launches = run_counted(lambda: inference_batch.main(dec, device="cuda"))
    test_ds = dataset_of(dec, tokenizer, dec.dataset_config.test_split)
    batches = list(decode_loader(dec, test_ds))
    log(f"[{label}] inference_batch with ckpt_path: {out['n']} inputs in batches of {MS_DECODE_BATCH} (T "
        f"{[b['input_ids'].shape[1] for b in batches]}), beam {dec.decode_config.num_beams}, {MS_NEW_TOKENS} new "
        f"tokens at most; materialized in {out['load_seconds']:.2f} s; decode {out['seconds']:.2f} s, prefill "
        f"{1000 * out['prefill_s'] / out['calls']:.1f} ms/batch, "
        f"{1000 * out['decode_s'] / max(out['decode_steps'], 1):.2f} ms/beam step over {out['decode_steps']} steps, "
        f"{out['generated_tokens']} tokens, RTF {out['rtf']:.4f} ({out['audio_seconds']:.2f} s of audio); launches "
        f"{ {k: dec_launches[k] for k in per_step} } | {SMI}")
    if dec_launches["flash_attention_fwd_f32"] != f32_enc * len(batches) or dec_launches["flash_attention_bwd_f32"]:
        raise AssertionError(f"{label}: K1 / K4 f32 launched {dec_launches['flash_attention_fwd_f32']} / "
                             f"{dec_launches['flash_attention_bwd_f32']} times over {len(batches)} prefills of "
                             f"{c.encoder.n_layers} layers")
    if any(launches[k] + dec_launches[k] for k in AAC_BYPASSED):
        raise AssertionError(f"{label}: K2 / K3 launched on the bf16 base: "
                             f"{ {k: launches[k] + dec_launches[k] for k in AAC_BYPASSED} }")
    seen_t = {s["shape"][1] for s in res["steps"]} | {b["input_ids"].shape[1] for b in batches}
    if text_t is not None and not seen_t <= set(text_t):
        raise AssertionError(f"{label}: batches at T {seen_t}, phase 3 checks {text_t}")
    if not np.isfinite(out["rtf"]) or (audio_seconds is not None and abs(out["audio_seconds"] - audio_seconds) > 1e-6):
        raise AssertionError(f"{label}: RTF {out['rtf']} over {out['audio_seconds']} s of audio (expected "
                             f"{audio_seconds})")
    if c.encoder.dtype == torch.float32 and not enc_trains:
        # the trainer re-stored the frozen f32 encoder in frozen_dtype (bf16), as the JAX package's trainer
        # does, and inference_batch builds it in f32: the in-memory model gets the f32 encoder back
        from slam_llm_tpu_torch.utils.hf_loader import convert_encoder_checkpoint, overlay_

        overlay_(trainer.model.encoder.float(),
                 convert_encoder_checkpoint(cfg.model_config.encoder_path, c.encoder_name, c.encoder))
    # a random model's text may hold line breaks: the log is compared whole, as written
    with open(out["pred"], encoding="utf-8", newline="") as f:
        text = f.read()
    mine = decode_texts(trainer.model, tokenizer, dec)
    log(f"[{label}] decoded text of the entry point vs the in-memory trained model: "
        f"{sum(f'{line}' + chr(10) in text for line in mine)} / {len(mine)} identical")
    print("\n".join(repr(line) for line in mine[:2]))
    if len(mine) != len(test_ds) or text != "".join(f"{line}\n" for line in mine):
        raise AssertionError(f"{label}: the reloaded model's decode differs from the in-memory trained model's")
    # the Q-Former's later blocks attend near-uniformly, where K4's bf16 dS
    # is most of a query / key gradient: the CPU side rounds as K4 does. With
    # the encoder trained they attend more uniformly still (ROADMAP Queue 3):
    # the gate then holds the encoder's gradients and logs the Q-Former's
    with cpu_attention_on_twins():
        loss_gpu, loss_cpu = check_reduced_against_cpu(trainer, cfg, batches[0], train_ds, label, MS_LAYERS,
                                                       MS_KEY_BIAS_LIMIT, gate="encoder." if enc_trains else "")
    if not abs(loss_gpu - loss_cpu) <= 1e-2 * abs(loss_cpu):
        raise AssertionError(f"{label}: loss {loss_gpu} on the card, {loss_cpu} on the CPU")
    log(f"[{label}] the recipe in {time.perf_counter() - t_phase:.1f} s")
    return trainer, {k: launches[k] + dec_launches[k] for k in launches}, test_ds


def _ms_tokenizer(tmp: Path):
    global _synth_tokenizer_dir
    from slam_llm_tpu_torch.data.tokenizer import load_tokenizer
    from slam_llm_tpu_torch.tools import synth_checkpoint as synth

    synth.write_tokenizer(str(tmp / "tokenizer"), 32000, seed=0)
    _synth_tokenizer_dir = str(tmp / "tokenizer")
    return load_tokenizer(_synth_tokenizer_dir)


def run_seld() -> tuple:
    """seld_spatialast_llama: a random Spatial-AST-base file in BAT's layout
    through ``encoder_path`` (f32, so its 12 layers run K1's f32 route),
    the 64-query Q-Former, vicuna-7b in bf16, on spatialised 10 s clips
    (synthetic 32 kHz clips convolved with 2-channel IRs, SpatialSoundQA's
    manifests); the whole Spatial-AST-base against the CPU f32 plain path.
    Returns the launches and the files (directory, file, corpus overrides)
    that phase 13 reuses and removes."""
    from slam_llm_tpu_torch.models.spatial_ast import SPATIAL_AST_PRESETS, SpatialASTEncoder
    from slam_llm_tpu_torch.tools import synth_checkpoint as synth
    from slam_llm_tpu_torch.utils.hf_loader import convert_encoder_checkpoint, load_torch_checkpoint, overlay_

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_seld_"))
    t0 = time.perf_counter()
    cfg_sa = SPATIAL_AST_PRESETS["spatialast-base"]()
    sa_path = tmp / "spatial_ast.pt"
    sa_bytes = synth.write_spatial_ast(str(sa_path), cfg_sa, seed=1, device="cuda")
    over = synth.write_seld_corpus(str(tmp / "seld"), n=16 * MS_STEPS, n_eval=16, seed=0)
    tokenizer = _ms_tokenizer(tmp)
    log(f"[seld] wrote Spatial-AST-base f32 in BAT's layout ({sa_bytes / 1e9:.3f} GB), a SpatialSoundQA-shaped corpus "
        f"(32 kHz clips of 4-12 s, 2-channel IRs, {16 * MS_STEPS} train / 16 test items) and the tokenizer in "
        f"{time.perf_counter() - t0:.2f} s")
    args = (f"++model_config.encoder_path={sa_path}", *(f"++dataset_config.{k}={v}" for k, v in over.items()))
    trainer, launches, test_ds = _recipe_phase("seld", SELD_RECIPE, tmp, tokenizer, args, args)
    if trainer.model.cfg.encoder.dtype != torch.float32 or trainer.model.cfg.projector_cfg.query_len != 64:
        raise AssertionError(f"the SELD recipe changed: {trainer.model.cfg}")
    del trainer
    torch.cuda.empty_cache()
    # the whole encoder in f32 from the file, TF32 off on the card (phase 1) and on the CPU
    sa = SpatialASTEncoder(cfg_sa, device="cuda").eval()
    overlay_(sa, convert_encoder_checkpoint(str(sa_path), "spatial_ast", cfg_sa))
    sd = load_torch_checkpoint(str(sa_path))
    d, last = cfg_sa.d_model, cfg_sa.n_layers - 1
    for got, want in ((sa.blocks[last].k_proj.weight, sd[f"blocks.{last}.attn.qkv.weight"][d:2 * d]),
                      (sa.pos_embed, sd["pos_embed"][0, 1:]), (sa.bn_var, sd["bn.running_var"])):
        if not torch.equal(got.detach().cpu(), want):
            raise AssertionError("a loaded Spatial-AST tensor differs from the file's")
    two = test_ds.collator([test_ds[0], test_ds[3]])
    feats = torch.from_numpy(two["audio_binaural"])
    log(f"[seld] TF32: matmul {torch.backends.cuda.matmul.allow_tf32}, cuDNN {torch.backends.cudnn.allow_tf32}")
    check_encoder_against_cpu("[seld] Spatial-AST-base f32 (the BAT-layout file)", sa, (feats,), expect_k1=True,
                              min_cos=0.99999, kernel="flash_attention_fwd_f32")
    with torch.no_grad():
        sa_ms = event_ms(lambda: sa(feats.cuda()), reps=3)
    log(f"[seld] Spatial-AST-base f32 forward of {tuple(feats.shape)}: {sa_ms:.2f} ms by CUDA events | {SMI}")
    del sa
    return launches, dict(tmp=tmp, args=args)


def run_mc() -> dict:
    """mc_musicfm_vicuna: MusicFM-MSD in bf16 from its seeded init (neither
    package converts MusicFM's checkpoint), the linear projector at ds 5,
    vicuna-7b in bf16, on 10 s crops of 8-14 s 24 kHz clips; the whole
    MusicFM against the CPU f32 plain path on two clips, one shorter than
    10 s (zero-padded)."""
    import shutil

    from slam_llm_tpu_torch.tools import synth_checkpoint as synth

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mc_"))
    t0 = time.perf_counter()
    train = synth.write_music_corpus(str(tmp / "music"), n=16 * MS_STEPS, seed=0, name="train")
    test = synth.write_music_corpus(str(tmp / "music"), n=16, seed=2, name="test", seconds=(6.0, 14.0))
    tokenizer = _ms_tokenizer(tmp)
    log(f"[mc] wrote 24 kHz clips ({16 * MS_STEPS} train of 8-14 s, 16 test of 6-14 s) and the tokenizer in "
        f"{time.perf_counter() - t0:.2f} s")
    trainer, launches, test_ds = _recipe_phase(
        "mc", MC_RECIPE, tmp, tokenizer, (f"++dataset_config.train_data_path={train}",),
        (f"++dataset_config.val_data_path={test}",))
    enc = trainer.model.encoder
    if (enc.cfg.d_model, enc.cfg.n_layers, trainer.model.cfg.projector_cfg.ds_rate) != (1024, 12, 5):
        raise AssertionError(f"the MC recipe changed: {trainer.model.cfg}")
    two = test_ds.collator([test_ds[0], test_ds[15]])  # 6 s (zero-padded to 10 s) and 14 s (cut)
    mel, mask = torch.from_numpy(two["audio_mel"]), torch.from_numpy(two["audio_mel_mask"])
    check_encoder_against_cpu("[mc] MusicFM-MSD bf16 (seeded init)", enc, (mel, mask), expect_k1=True, min_cos=0.999)
    del trainer, enc
    shutil.rmtree(tmp)
    return launches


def run_sec() -> dict:
    """sec_emotion2vec_vicuna: emotion2vec-base from its seeded init, the
    64-query Q-Former, vicuna-7b in bf16, on raw 16 kHz audio; then its
    E-chat variant: pipeline.finetune for ECHAT_STEPS steps from one dialog
    TSV (``dataset: echat_dataset``, ``data_path``), validating on its
    positional 10 %."""
    import shutil

    from slam_llm_tpu_torch.pipeline import finetune
    from slam_llm_tpu_torch.tools import synth_checkpoint as synth

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_sec_"))
    tokenizer = _ms_tokenizer(tmp)
    train = write_corpus(tmp, n=16 * MS_STEPS, name="train", targets=SEC_CAPTIONS)
    test = write_corpus(tmp, n=16, seed=2, name="test", targets=SEC_CAPTIONS)
    trainer, launches, _ = _recipe_phase(
        "sec", SEC_RECIPE, tmp, tokenizer, (f"++dataset_config.train_data_path={train}",),
        (f"++dataset_config.val_data_path={test}",))
    if (trainer.model.cfg.encoder_name, trainer.model.cfg.projector_cfg.query_len) != ("emotion2vec", 64):
        raise AssertionError(f"the SEC recipe changed: {trainer.model.cfg}")
    del trainer
    torch.cuda.empty_cache()
    tsv = synth.write_echat_corpus(str(tmp / "echat"), n_dialogs=24, seed=3)
    cfg = _recipe_config(SEC_RECIPE, finetune.load_run_config, "++dataset_config.dataset=echat_dataset",
                         f"++dataset_config.data_path={tsv}", "++dataset_config.prompt=null",
                         "++train_config.log_interval=1", "++train_config.warmup_steps=1", "++train_config.num_epochs=1",
                         f"++train_config.max_steps_per_epoch={ECHAT_STEPS}", "++train_config.save_model=false",
                         f"++train_config.output_dir={tmp / 'echat_out'}")
    res, echat_launches, echat_stats = _finetune(cfg, "sec echat")
    train_ds = dataset_of(cfg, tokenizer, cfg.dataset_config.train_split)
    val_ds = dataset_of(cfg, tokenizer, "validation")
    log(f"[sec echat] {len(train_ds)} train / {len(val_ds)} validation turn pairs from one TSV of 24 dialogs; "
        f"{len(res['steps'])} steps of batch {res['steps'][-1]['shape']}, step {echat_stats['step_ms']:.1f} ms; "
        f"validation {res.get('final_val')} | {SMI}")
    if (len(res["steps"]) != ECHAT_STEPS or {s["shape"][1] for s in res["steps"]} != {ECHAT_T}
            or not res.get("final_val") or not len(val_ds)
            or any(echat_launches[k] for k in AAC_BYPASSED)):
        raise AssertionError(f"sec echat: steps {len(res['steps'])}, validation {res.get('final_val')}, "
                             f"launches {echat_launches}")
    del res
    shutil.rmtree(tmp)
    return {k: launches[k] + echat_launches[k] for k in launches}


def run_music_spatial() -> tuple:
    """Phase 12: the SELD, MC and SEC recipes, each through both entry points;
    a recipe's launches are its training and decode runs' (the whole-encoder
    checks against the CPU count their own). Returns them and SELD's files."""
    t0 = time.perf_counter()
    paths = {}
    paths["seld"], seld_files = run_seld()
    torch.cuda.empty_cache()
    for name, fn in (("mc", run_mc), ("sec", run_sec)):
        paths[name] = fn()
        torch.cuda.empty_cache()
    log(f"[music_spatial] phase 12 in {time.perf_counter() - t0:.1f} s")
    return paths, seld_files


# ---------------------------------------------------------------------------
# phase 13: SELD with its Spatial-AST encoder unfrozen
# ---------------------------------------------------------------------------


def run_seld_encoder(seld_files: dict) -> dict:
    """Phase 13: seld_spatialast_llama with ``++train_config.freeze_encoder=false``
    on phase 12's Spatial-AST-base file and corpus, through ``_recipe_phase``:
    Spatial-AST-base f32 and the Q-Former train (every encoder tensor
    moves, the BatchNorm statistics too, as in the JAX package), K1's and
    K4's f32 routes once a Spatial-AST layer a step, vicuna-7b bf16
    bit-unchanged, the encoder's forward + backward share of the step, the
    decode from encoder_path then ckpt_path against the in-memory one, and
    the card vs the CPU gated on the encoder's gradients. Removes the
    files."""
    import shutil

    t0 = time.perf_counter()
    tmp, args = seld_files["tmp"], seld_files["args"]
    tokenizer = _ms_tokenizer(tmp)
    trainer, launches, _ = _recipe_phase("seld_encoder", SELD_RECIPE, tmp / "seld_encoder", tokenizer,
                                         (*args, "++train_config.freeze_encoder=false"), args)
    del trainer
    shutil.rmtree(tmp)
    log(f"[seld_encoder] phase 13 in {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 14: VSR (AV-HuBERT-large, video only, + linear + vicuna-7b in bf16)
# ---------------------------------------------------------------------------

VSR_RECIPE = ROOT / "examples" / "vsr_LRS3" / "conf" / "vsr_avhubert_vicuna.yaml"
VSR_STEPS = 4
VSR_BATCH = 8  # the recipe's batch_size_training and val_batch_size
VSR_FRAMES = (50, 100, 150)  # the clips' lengths in turn: 2, 4 and 6 s at 25 fps
VSR_T = 128  # the text bucket of the training and decode batches (up to 30 audio slots, the prompt, a target)
VSR_TARGETS = ["bin blue at f two now", "lay green with d nine soon", "place red by k four please",
               "set white in p zero again", "we should meet at the station", "she read the letter twice"]


def write_video_corpus(root: Path, n: int, seed: int, name: str) -> Path:
    """``n`` seeded clips in the layout of LRS3's lip crops: (T, 96, 96) uint8
    grey frames (a mouth-like dark ellipse opening and closing over a noisy
    face) saved as ``.npy``, T from VSR_FRAMES in turn, each with a 16 kHz
    wav of its length (for ``modal: audio_video``), and a jsonl manifest."""
    from slam_llm_tpu_torch.tools.synth_checkpoint import write_wav

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:96, :96].astype(np.float32)
    manifest = root / f"{name}.jsonl"
    with open(manifest, "w") as f:
        for i in range(n):
            t = VSR_FRAMES[i % len(VSR_FRAMES)]
            opening = 6 + 5 * np.sin(2 * np.pi * np.arange(t) / (8 + i % 5))[:, None, None]
            mouth = ((xx - 48) / 22) ** 2 + ((yy - 60) / opening) ** 2 < 1
            frames = 150 + 20 * rng.standard_normal((t, 96, 96)) - 90 * mouth
            video = root / f"{name}_v{i}.npy"
            np.save(video, np.clip(frames, 0, 255).astype(np.uint8))
            wav = root / f"{name}_a{i}.wav"
            write_wav(str(wav), 0.2 * np.sin(2 * np.pi * (180 + 20 * i) * np.arange(640 * t) / 16000)
                      + 0.02 * rng.standard_normal(640 * t), 16000)
            row = {"key": f"{name}{i}", "video": str(video), "source": str(wav),
                   "target": VSR_TARGETS[i % len(VSR_TARGETS)]}
            f.write(json.dumps(row) + "\n")
    return manifest


def read_npy_video(path: str, train: bool = False, rng=None) -> np.ndarray:
    """``avhubert_dataset.load_video_gray`` for this phase's clips: the card's
    host has no OpenCV, so the frames come from ``.npy``; the crop, flip and
    normalization are the port's ``crop_and_normalize``."""
    from slam_llm_tpu_torch.data.avhubert_dataset import crop_and_normalize

    return crop_and_normalize(np.load(path), train, rng)


def check_avhubert_loaded(enc, path: Path) -> None:
    """The loaded AV-HuBERT-large against the written fairseq file: the
    transformer tensors bit-equal (in the stored dtype), the stem's folded
    BatchNorm against ``w * g / sqrt(var + 1e-5)`` computed on the card."""
    from slam_llm_tpu_torch.utils.hf_loader import load_torch_checkpoint

    sd = load_torch_checkpoint(str(path))
    last = enc.cfg.n_layers - 1
    checks = [(enc.layers[last].attention.k_proj.weight, sd[f"encoder.layers.{last}.self_attn.k_proj.weight"]),
              (enc.layers[0].fc1.bias, sd["encoder.layers.0.fc1.bias"]),
              (enc.post_proj.weight, sd["post_extract_proj.weight"]),
              (enc.audio_proj.weight, sd["feature_extractor_audio.proj.weight"]),
              (enc.video_frontend.layer3_1.prelu2, sd["feature_extractor_video.resnet.trunk.layer4.1.relu2.weight"])]
    for got, want in checks:
        if not torch.equal(got.detach().cpu(), want.to(got.dtype)):
            raise AssertionError(f"a loaded AV-HuBERT tensor {tuple(got.shape)} differs from the written one")
    res = "feature_extractor_video.resnet.frontend3D."
    scale = sd[res + "1.weight"].cuda() / (sd[res + "1.running_var"].cuda() + 1e-5).sqrt()
    want = sd[res + "0.weight"].cuda() * scale[:, None, None, None, None]
    w = enc.video_frontend.stem.weight
    rel = ((w.float() - want).abs().max() / want.abs().max()).item()
    log(f"[vsr] loaded AV-HuBERT-large: {len(checks)} tensors bit-equal to the fairseq file's; the stem {tuple(w.shape)} "
        f"with its BatchNorm folded against w * g / sqrt(var + eps) on the card: max rel diff {rel:.2e} ({w.dtype})")
    if rel > 2 ** -8:
        raise AssertionError(f"the folded stem differs from the file's conv and BatchNorm by {rel}")


def run_vsr() -> dict:
    """Phase 14: vsr_avhubert_vicuna at full width through both entry points
    (``_recipe_phase``): a random AV-HuBERT-large file in fairseq's layout
    (tools/synth_checkpoint.write_avhubert) through ``encoder_path``, its
    BatchNorms folded at load; the recipe's own ``file:`` spec
    (``slam_llm_tpu.data.avhubert_dataset``), which the registry resolves to
    the port's module; video-only 2-6 s clips; pipeline.finetune for
    VSR_STEPS steps of 8 (K1 once an encoder and LLM layer, K4 once an LLM
    layer a step), pipeline.inference_batch with ckpt_path (beam 4) against
    the in-memory decode, the RTF from ``visual_mask``, the card vs the CPU
    at 2 + 2 layers; then the whole AV-HuBERT-large on two ragged clips,
    video only and audio + video, against the CPU f32 path."""
    import shutil

    from slam_llm_tpu_torch.data import avhubert_dataset
    from slam_llm_tpu_torch.models.avhubert import AVHUBERT_PRESETS
    from slam_llm_tpu_torch.pipeline import inference_batch
    from slam_llm_tpu_torch.tools import synth_checkpoint as synth

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_vsr_"))
    avhubert_dataset.load_video_gray = read_npy_video
    log("[vsr] the card's host has no OpenCV: avhubert_dataset.load_video_gray is replaced in this process by a "
        "reader of the clips' seeded (T, 96, 96) uint8 .npy frames; the 88 x 88 crop, the flip and the "
        "(0.421, 0.165) normalization are the port's crop_and_normalize")
    t0 = time.perf_counter()
    cfg_av = AVHUBERT_PRESETS["avhubert-large"]()
    av_path = tmp / "avhubert.pt"
    av_bytes = synth.write_avhubert(str(av_path), cfg_av, seed=1, device="cuda")
    train = write_video_corpus(tmp, VSR_BATCH * VSR_STEPS, seed=0, name="train")
    test = write_video_corpus(tmp, 16, seed=2, name="test")
    tokenizer = _ms_tokenizer(tmp)
    log(f"[vsr] wrote AV-HuBERT-large f32 in fairseq's layout ({av_bytes / 1e9:.3f} GB, BatchNorms unfolded, the "
        f"positional conv as weight_g / weight_v), {VSR_BATCH * VSR_STEPS} train / 16 test clips of "
        f"{VSR_FRAMES} frames and the tokenizer in {time.perf_counter() - t0:.2f} s")
    enc_path = f"++model_config.encoder_path={av_path}"
    trainer, launches, test_ds = _recipe_phase(
        "vsr", VSR_RECIPE, tmp, tokenizer, (enc_path, f"++dataset_config.train_data_path={train}"),
        (enc_path, f"++dataset_config.val_data_path={test}"), batch=VSR_BATCH,
        audio_seconds=sum(VSR_FRAMES[i % len(VSR_FRAMES)] for i in range(16)) / 25, text_t=(VSR_T,))
    c = trainer.model.cfg
    if (c.encoder_name, c.encoder.n_layers, c.encoder.d_model, c.projector, c.projector_cfg.ds_rate,
            type(test_ds).__module__) != ("av_hubert", 24, 1024, "linear", 5, "slam_llm_tpu_torch.data.avhubert_dataset"):
        raise AssertionError(f"the VSR recipe changed: {c}, dataset {type(test_ds)}")
    check_avhubert_loaded(trainer.model.encoder, av_path)

    # the whole encoder, video only and audio + video, on a 2 s and a 6 s clip
    over = _recipe_config(VSR_RECIPE, inference_batch.load_run_config, f"++dataset_config.val_data_path={test}",
                          "++dataset_config.modal=audio_video")
    over.dataset_config.inference_mode = True
    av_ds = dataset_of(over, tokenizer, over.dataset_config.test_split)
    two = av_ds.collator([av_ds[0], av_ds[2]])
    visual, feats, mask = (torch.from_numpy(two[k]) for k in ("visual", "audio_feats", "visual_mask"))
    enc = trainer.model.encoder
    enc_launches = check_encoder_against_cpu("[vsr] AV-HuBERT-large bf16, video only", enc, (visual, None, mask),
                                             expect_k1=True, min_cos=0.999)
    got = check_encoder_against_cpu("[vsr] AV-HuBERT-large bf16, audio + video", enc, (visual, feats, mask),
                                    expect_k1=True, min_cos=0.999)
    enc_launches = {k: enc_launches[k] + got[k] for k in enc_launches}
    del trainer, enc
    shutil.rmtree(tmp)
    log(f"[vsr] phase 14 in {time.perf_counter() - t_phase:.1f} s")
    return {k: launches[k] + enc_launches[k] for k in launches}


# ---------------------------------------------------------------------------
# phase 15: the large-scale dataset: aispeech_large_scale (whisper-large-v3 +
# linear + Qwen2-7B in bf16) on TokenBudgetBatcher batches, then the
# contextual and MaLa-ASR recipes (WavLM-large + vicuna-7b) at 2 + 2 layers
# ---------------------------------------------------------------------------

LS_RECIPE = ROOT / "examples" / "aispeech_asr" / "conf" / "aispeech_large_scale.yaml"
CTX_RECIPE = ROOT / "examples" / "contextual_asr" / "conf" / "contextual_wavlm_vicuna.yaml"
MALA_RECIPE = ROOT / "examples" / "mala_asr_slidespeech" / "conf" / "mala_wavlm_vicuna.yaml"
LS_UTTS, LS_EVAL_UTTS = 96, 24  # the train corpus fills the 192 bucket's 42 twice
LS_NEW_TOKENS = 32
# the batches the batcher makes of these corpora (ids; whisper-large-v3's frames are half the mel's), which phase 3
# checks K1 / K4 at
LS_TRAIN_SHAPES, LS_EVAL_SHAPES = {(42, 192)}, {(21, 192)}
LS_ENC_SHAPES = ((42, 500), (42, 496), (21, 500))  # the first two train batches' 1000 / 991 mel frames, the eval one's
# contextual / MaLa-ASR's first raw-audio train batch (bucket 192, its padding overrunning to 384) and eval batch
CTX_TRAIN_SHAPE, CTX_EVAL_SHAPE = (21, 384), (21, 192)
LS_LAYERS = 2  # LLM and encoder depth of the card-vs-CPU checks and of the WavLM recipes
LS_PROMPTS = [("asr", "Transcribe speech to text. "), ("asr", "Write down what is said. "),
              ("hotword", "Transcribe speech to text. The hotwords are {}. "),
              ("hotword", "Transcribe the speech, which may name {}. ")]
LS_NAMES = ["Marguerite", "Athos", "Porthos", "Aramis", "Dartagnan", "Richelieu", "Milady", "Rochefort",
            "Buckingham", "Constance", "Planchet", "Treville", "Bonacieux", "Ketty", "Mousqueton", "Grimaud"]
LS_WORDS = ["the", "king", "sent", "a", "letter", "to", "queen", "and", "rode", "north", "at", "dawn", "with",
            "his", "friends", "river", "castle", "night", "sword", "horse"]


def write_large_corpus(root: Path, n: int, seed: int) -> Path:
    """``root`` as the large-scale dataset reads it: ``n`` seeded 2-10 s
    utterances (tone + noise) in one wav ark written by the port's
    ``data.kaldi_ark.write_wav_ark``; ``multitask.jsonl`` rows with their
    ark rspecifiers, two thirds of them ``hotword`` tasks whose biasing
    list ``utils.hotword_filter.filter_hotwords`` picks from LS_NAMES for
    the transcript; ``multiprompt.jsonl`` with a pool of two prompts a task."""
    from slam_llm_tpu_torch.data.kaldi_ark import write_wav_ark
    from slam_llm_tpu_torch.utils.hotword_filter import build_ngram_index, filter_hotwords

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    index = build_ngram_index(LS_NAMES)
    waves, rows = {}, []
    for i in range(n):
        samples = int(16000 * (2.0 + 8.0 * ((i * 7) % n) / (n - 1)))
        t = np.arange(samples) / 16000
        waves[f"utt{i}"] = (0.3 * np.sin(2 * np.pi * (150 + 13 * (i % 29)) * t)
                            + 0.02 * rng.standard_normal(samples)).astype(np.float32)
        words = [LS_WORDS[j] for j in rng.integers(0, len(LS_WORDS), 3 + i % 5)]
        words.insert(int(rng.integers(0, len(words))), LS_NAMES[i % len(LS_NAMES)])
        rows.append({"key": f"utt{i}", "task": "asr" if i % 3 == 0 else "hotword", "target": " ".join(words)})
        if rows[-1]["task"] == "hotword":
            rows[-1]["hotword"] = ", ".join(filter_hotwords(rows[-1]["target"], LS_NAMES, word_num=3,
                                                            ngram_index=index))
    specs = write_wav_ark(str(root / "audio.ark"), waves)
    with open(root / "multitask.jsonl", "w") as f:
        for row, spec in zip(rows, specs):
            f.write(json.dumps({**row, "path": spec}) + "\n")
    with open(root / "multiprompt.jsonl", "w") as f:
        for task, prompt in LS_PROMPTS:
            f.write(json.dumps({"task": task, "prompt": prompt}) + "\n")
    return root


class BatcherItems:
    """A ``TokenBudgetBatcher``'s utterances as a map-style view for the
    card-vs-CPU gradient check: ``items[i]`` and ``collator(samples)``,
    padded to the bucket the batcher gives their longest."""

    def __init__(self, batcher, n: int):
        from slam_llm_tpu_torch.data.speech_dataset import bucketize

        self.batcher, self.items = batcher, list(itertools.islice(iter(batcher.dataset), n))
        self.bucketize = bucketize

    def __getitem__(self, i: int) -> dict:
        return self.items[i]

    def collator(self, samples: list) -> dict:
        bucket = self.bucketize(max(len(s["input_ids"]) for s in samples), self.batcher.buckets)
        return self.batcher._collate(samples, bucket)


def run_aispeech(tmp: Path) -> tuple:
    """aispeech_large_scale at full width: the recipe's own batcher (8192
    tokens a training batch, 4096 an eval batch, buckets 192-768, the mel
    not padded to 30 s). ``pipeline.finetune`` refuses the iterable dataset
    (as the JAX package's does), so its first two batches go through the
    trainer's step at the recipe's gradient accumulation 2, twice (the
    first update's lr is 0 under warmup); the first eval batch decodes
    through the Generator (beam 4); the card against the CPU at 2 + 2
    layers. Returns the launches and the train corpus."""
    global _synth_tokenizer_dir
    from slam_llm_tpu_torch.data.tokenizer import load_tokenizer
    from slam_llm_tpu_torch.inference.generate import Generator
    from slam_llm_tpu_torch.pipeline import finetune, inference_batch
    from slam_llm_tpu_torch.pipeline.common import build_model_and_data, materialize_params
    from slam_llm_tpu_torch.tools.synth_checkpoint import QWEN2_BPE, write_qwen2_tokenizer
    from slam_llm_tpu_torch.train.state import Trainer

    t0 = time.perf_counter()
    train, val = write_large_corpus(tmp / "train", LS_UTTS, seed=0), write_large_corpus(tmp / "eval", LS_EVAL_UTTS,
                                                                                       seed=1)
    write_qwen2_tokenizer(str(tmp / "qwen2"), QWEN2_BPE, seed=0,
                          corpus=[" ".join(LS_WORDS + LS_NAMES)] + [p for _, p in LS_PROMPTS])
    _synth_tokenizer_dir = str(tmp / "qwen2")
    tokenizer = load_tokenizer(_synth_tokenizer_dir)
    log(f"[large_scale] wrote {LS_UTTS} train / {LS_EVAL_UTTS} eval utterances of 2-10 s in wav arks, their "
        f"multitask / multiprompt manifests (hotword lists from utils.hotword_filter) and a qwen2-layout tokenizer in "
        f"{time.perf_counter() - t0:.2f} s")
    args = (f"++dataset_config.train_data_path={train}", f"++dataset_config.val_data_path={val}",
            f"++train_config.output_dir={tmp / 'out'}", "++train_config.warmup_steps=1")
    cfg = _recipe_config(LS_RECIPE, finetune.load_run_config, *args)
    mc, dc, tc = cfg.model_config, cfg.dataset_config, cfg.train_config
    if (mc.llm_name, mc.encoder_config, mc.encoder_projector, mc.encoder_projector_ds_rate, dc.dataset, dc.mel_size,
            dc.pad_or_trim, dc.train_max_frame_length, dc.eval_max_frame_length, list(dc.text_buckets),
            tc.gradient_accumulation_steps, tc.shard.remat, tc.freeze_llm, tc.shard.base_quant) != (
            "qwen2-7b", "whisper-large-v3", "linear", 5, "speech_dataset_large", 128, False, 8192, 4096,
            [192, 256, 384, 512, 768], 2, True, True, "none"):
        raise AssertionError(f"the aispeech recipe changed: {mc} {dc} {tc}")
    try:
        finetune.main(cfg, device="cuda")
    except TypeError as e:  # the loader takes map-style datasets, in both packages
        refusal = str(e)
    else:
        raise AssertionError("pipeline.finetune ran the iterable TokenBudgetBatcher")
    log(f"[large_scale] pipeline.finetune refused the iterable dataset, as the JAX package's does: {refusal}")
    if "TokenBudgetBatcher" not in refusal:
        raise AssertionError(f"pipeline.finetune refused the iterable dataset with {refusal!r}")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model, _, batcher = build_model_and_data(cfg, split="train", device="cuda")
    materialize_params(model, cfg)
    trainer = Trainer(model, model.cfg, tc).state_from_params()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = list(itertools.islice(iter(batcher), 2))
    host_s = time.perf_counter() - t0
    batches = [trainer.put_batch(b) for b in host]
    shapes = [(tuple(b["input_ids"].shape), tuple(b["audio_mel"].shape)) for b in batches]
    log(f"[large_scale] Qwen2-7B + whisper-large-v3 built and materialized in {build_s:.2f} s; the batcher's first two "
        f"train batches (ids, mel) {shapes} in {host_s:.2f} s of host time (ark reads, mel, tokens, collation)")
    if [(s[0][0], (s[1][1] + 1) // 2) for s in shapes] != list(LS_ENC_SHAPES[:2]) or any(
            s[0] not in LS_TRAIN_SHAPES for s in shapes):
        raise AssertionError(f"the train batches {shapes} are not the shapes phase 3 checks K1 / K4 at "
                             f"({LS_TRAIN_SHAPES}, encoder {LS_ENC_SHAPES[:2]})")
    proj = {n: p.detach().clone() for n, p in trainer.trainable.items()}
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    def steps():
        times, losses, moved = [], [], []
        for b in batches + batches:
            t = time.perf_counter()
            m = trainer.train_step(b)
            losses.append(float(m["loss"]))  # waits for the micro-step
            times.append(time.perf_counter() - t)
            moved.append(any(not torch.equal(p, proj[n]) for n, p in trainer.trainable.items()))
        return times, losses, moved

    (times, losses, moved), launches = run_counted(steps)
    peak = torch.cuda.max_memory_allocated()
    c = model.cfg
    per = {"flash_attention_fwd": c.encoder.n_layers + c.llm.n_layers, "flash_attention_bwd": c.llm.n_layers}
    utts = sum(b["input_ids"].shape[0] for b in batches)
    step_s = sum(times[2:])
    log(f"[large_scale] 4 micro-steps (2 updates at accumulation {tc.gradient_accumulation_steps}): losses "
        f"{[round(x, 5) for x in losses]}, micro-step times {[round(1000 * x, 1) for x in times]} ms; the second "
        f"update {1000 * step_s:.1f} ms for {utts} utterances ({utts / step_s:.2f} utt/s); trainable tensors moved "
        f"after each micro-step {moved}; peak memory {peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} of its own); "
        f"per micro-step K1 {launches['flash_attention_fwd'] / 4:.0f} K4 {launches['flash_attention_bwd'] / 4:.0f} "
        f"| {SMI}")
    if not all(np.isfinite(losses)) or moved != [False, False, False, True] or \
            {k: launches[k] for k in per} != {k: 4 * v for k, v in per.items()} or \
            any(launches[k] for k in AAC_BYPASSED):
        raise AssertionError(f"large_scale training: losses {losses}, moved {moved}, launches {launches}")
    check_projector_trained(trainer, cfg, "large_scale")

    dec = _recipe_config(LS_RECIPE, inference_batch.load_run_config, *args,
                         f"++decode_config.max_new_tokens={LS_NEW_TOKENS}")
    dec.dataset_config.inference_mode = True
    eval_batch = next(iter(dataset_of(dec, tokenizer, dec.dataset_config.test_split)))
    gen = Generator(trainer.model.eval(), inference_batch.generation_config(dec, tokenizer))
    arrays = {k: v for k, v in eval_batch.items() if isinstance(v, np.ndarray)}
    t0 = time.perf_counter()
    tokens, dec_launches = run_counted(lambda: gen.generate(arrays))
    gen_s = time.perf_counter() - t0
    st, seconds = gen.stats, inference_batch.batch_audio_seconds(eval_batch)
    lines = [tokenizer.decode(t) for t in inference_batch.strip_after_eos(tokens, tokenizer.eos_token_id,
                                                                         tokenizer.pad_token_id)]
    log(f"[large_scale] eval batch (budget {dec.dataset_config.eval_max_frame_length}) {arrays['input_ids'].shape} ids, "
        f"mel {arrays['audio_mel'].shape}: beam {dec.decode_config.num_beams}, {LS_NEW_TOKENS} new tokens at most, "
        f"{gen_s:.2f} s (prefill {1000 * st['prefill_s']:.1f} ms, "
        f"{1000 * st['decode_s'] / max(st['decode_steps'], 1):.2f} ms/beam step over {st['decode_steps']} steps), "
        f"RTF {gen_s / seconds:.4f} over {seconds:.2f} s of audio (the unpadded mel mask); launches {dec_launches} "
        f"| {SMI}")
    print("\n".join(repr(line) for line in lines[:2]))
    if tuple(arrays["input_ids"].shape) not in LS_EVAL_SHAPES or (
            arrays["audio_mel"].shape[0], (arrays["audio_mel"].shape[1] + 1) // 2) != LS_ENC_SHAPES[2] or \
            dec_launches["flash_attention_fwd"] == 0 or any(
            dec_launches[k] for k in AAC_BYPASSED):
        raise AssertionError(f"large_scale decode: batch {arrays['input_ids'].shape} (phase 3: {LS_EVAL_SHAPES}), "
                             f"launches {dec_launches}")
    items = BatcherItems(batcher, 1)
    loss_gpu, loss_cpu = check_reduced_against_cpu(trainer, cfg, eval_batch, items, "large_scale", LS_LAYERS)
    if not abs(loss_gpu - loss_cpu) <= 1e-2 * abs(loss_cpu):
        raise AssertionError(f"large_scale: loss {loss_gpu} on the card, {loss_cpu} on the CPU")
    del trainer, model, gen, batches
    torch.cuda.empty_cache()
    return {k: launches[k] + dec_launches[k] for k in launches}, train


def run_wavlm_large_scale(label: str, recipe: Path, corpus: Path, tmp: Path) -> dict:
    """contextual_wavlm_vicuna or mala_wavlm_vicuna on the batcher's raw-audio
    batches at LS_LAYERS LLM and encoder layers of their full widths
    (WavLM-large + vicuna-7b, seeded random init; the full-width model is
    phase 9's): one training step, one beam-4 decode of an eval batch, and
    the card against the CPU."""
    import dataclasses

    from slam_llm_tpu_torch.inference.generate import Generator
    from slam_llm_tpu_torch.models.slam_model import SLAMModel, build_slam_config
    from slam_llm_tpu_torch.pipeline import finetune, inference_batch
    from slam_llm_tpu_torch.pipeline.common import init_params_
    from slam_llm_tpu_torch.train.state import Trainer

    tokenizer = _ms_tokenizer(tmp)
    cfg = _recipe_config(recipe, finetune.load_run_config, f"++dataset_config.train_data_path={corpus}",
                         f"++dataset_config.val_data_path={corpus}", "++train_config.warmup_steps=1")
    mc, dc = cfg.model_config, cfg.dataset_config
    if (mc.encoder_config, mc.llm_name, dc.dataset, dc.input_type, dc.normalize) != (
            "wavlm-large", "vicuna-7b", "speech_dataset_large", "raw", True):
        raise AssertionError(f"the {label} recipe changed: {mc} {dc}")
    big = build_slam_config(cfg.train_config, mc)
    small = dataclasses.replace(big, llm=dataclasses.replace(big.llm, n_layers=LS_LAYERS),
                                encoder=dataclasses.replace(big.encoder, n_layers=LS_LAYERS))
    model = init_params_(SLAMModel(small, device="cuda"), torch.Generator(device="cuda").manual_seed(5))
    trainer = Trainer(model, small, cfg.train_config).state_from_params()
    batcher = dataset_of(cfg, tokenizer, "train")
    batch = trainer.put_batch(next(iter(batcher)))
    t0 = time.perf_counter()
    m, launches = run_counted(lambda: trainer.train_step(batch))
    step_s = time.perf_counter() - t0
    dec = _recipe_config(recipe, inference_batch.load_run_config, f"++dataset_config.val_data_path={corpus}",
                         f"++decode_config.max_new_tokens={LS_NEW_TOKENS}")
    dec.dataset_config.inference_mode = True
    eval_batch = next(iter(dataset_of(dec, tokenizer, dec.dataset_config.test_split)))
    gen = Generator(model.eval(), inference_batch.generation_config(dec, tokenizer))
    arrays = {k: v for k, v in eval_batch.items() if isinstance(v, np.ndarray)}
    tokens, dec_launches = run_counted(lambda: gen.generate(arrays))
    log(f"[{label}] {LS_LAYERS} + {LS_LAYERS} layers of WavLM-large + vicuna-7b: one step on the batcher's first "
        f"batch {tuple(batch['input_ids'].shape)} ids, audio {tuple(batch['audio'].shape)}: loss "
        f"{float(m['loss']):.5f}, {1000 * step_s:.1f} ms (the first: allocation included), launches "
        f"K1 {launches['flash_attention_fwd']} K4 {launches['flash_attention_bwd']}; decode of an eval batch "
        f"{arrays['input_ids'].shape} (beam {dec.decode_config.num_beams}): {tokens.shape} tokens, launches K1 "
        f"{dec_launches['flash_attention_fwd']} | {SMI}")
    if not np.isfinite(float(m["loss"])) or (launches["flash_attention_fwd"], launches["flash_attention_bwd"]) != (
            LS_LAYERS, LS_LAYERS) or dec_launches["flash_attention_fwd"] == 0 or (
            tuple(batch["input_ids"].shape), arrays["input_ids"].shape) != (CTX_TRAIN_SHAPE, CTX_EVAL_SHAPE):
        raise AssertionError(f"{label}: loss {m['loss']}, launches {launches} / {dec_launches}")
    loss_gpu, loss_cpu = check_reduced_against_cpu(trainer, cfg, eval_batch, BatcherItems(batcher, 1), label,
                                                   LS_LAYERS)
    if not abs(loss_gpu - loss_cpu) <= 1e-2 * abs(loss_cpu):
        raise AssertionError(f"{label}: loss {loss_gpu} on the card, {loss_cpu} on the CPU")
    del trainer, model, gen
    torch.cuda.empty_cache()
    return {k: launches[k] + dec_launches[k] for k in launches}


def run_large_scale() -> dict:
    """Phase 15: aispeech_large_scale at full width (``run_aispeech``), then
    contextual_wavlm_vicuna and mala_wavlm_vicuna at LS_LAYERS + LS_LAYERS
    layers on the same corpus's raw-audio batches."""
    import shutil

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_large_"))
    launches, corpus = run_aispeech(tmp)
    for label, recipe in (("contextual", CTX_RECIPE), ("mala", MALA_RECIPE)):
        got = run_wavlm_large_scale(label, recipe, corpus, tmp / label)
        launches = {k: launches[k] + got[k] for k in launches}
    shutil.rmtree(tmp)
    log(f"[large_scale] phase 15 in {time.perf_counter() - t_phase:.1f} s")
    return launches


def main() -> int:
    global SMI
    t0 = time.perf_counter()
    SMI = setup()
    build()
    results = check_kernels()
    decode = run_slice()
    train = run_training()
    modes = run_training_modes()
    weights = run_weights()
    st = run_st()
    wavlm = run_wavlm()
    aac, aac_files = run_aac()
    clap = run_clap(aac_files)
    music_spatial, seld_files = run_music_spatial()
    seld_encoder = run_seld_encoder(seld_files)
    vsr = run_vsr()
    large_scale = run_large_scale()
    paths = {"decode": decode, "train": train, "train_int8_sr": modes, "weights": weights, "st": st,
             "wavlm": wavlm, "aac": aac, "clap": clap, **music_spatial, "seld_encoder": seld_encoder, "vsr": vsr,
             "large_scale": large_scale}
    for r in results:
        r["launches_by_path"] = {path: counts[r["name"]] for path, counts in paths.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        if r["name"].startswith("int8_matmul"):  # the code paths count both epilogues together
            r["launches_by_code_path"] = {p: {path: counts[f"int8_matmul/{p}"] for path, counts in paths.items()}
                                          for p in ("wgmma", "splitk")}
    log(f"[chip_smoke] phases 1-15 in {time.perf_counter() - t0:.1f} s | {SMI}")
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
