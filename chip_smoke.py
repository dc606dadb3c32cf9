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
                phase 16 adds K1 at the S2S prefill (1, 362, 28/4, 128),
                rotated before and fused, and K1 / K4 at S2S's training
                batches (8, 512 / 768 / 1024 / 1536, 28/4, 128) with fused
                RoPE theta 1e6, left-padded; phase 17 adds K1 / K4 at
                VALL-E X's (16, 577 / 1089, 16/16, 64) causal and (16, 576 /
                1088) non-causal with a hole inside the key rows, and K1 at
                its AR decode step (1, 364); last, a structured call at
                head_dim 80 takes the plain path (no kernel, equal to the
                plain twin) and one at 256 raises;
  4. decode  -- the recipe examples/asr_librispeech/conf/asr_whisper_tinyllama.yaml
                through slam_llm_tpu_torch.pipeline.inference_batch on 16
                synthetic utterances (whisper-small, TinyLlama-1.1B int8 base,
                beam 4, 8 new tokens, random weights from the recipe's
                seed), with kernel launch counts (K3's split-K path must
                run), a prefill-logit check against the CPU plain path
                (the model cut to 2 + 2 layers), and throughput;
  5. train   -- the same recipe through slam_llm_tpu_torch.pipeline.finetune
                (frozen whisper-small, trained projector, TinyLlama-1.1B int8
                base with LoRA r8 on q/v, int8_rot backward, batch 16) for a
                few steps on synthetic utterances, with validation and the
                trainable-only checkpoint, with the recipe's activation
                checkpointing (remat, dots_flash_saveable); step time,
                throughput, peak memory and launches per kernel, and the same
                step time and peak memory from a short run with remat off;
                then the trainable gradients of one utterance on the card
                against the CPU plain path, the trained model cut to 2 + 2
                layers;
  6. modes   -- the same recipe through pipeline.finetune with the int8_sr
                backward, the int8_sr CE head, anyprecision, gradient
                accumulation 2, full-state checkpoints and the validation
                decode of one wav: 8 micro-steps, a resume from the
                checkpoint for 2 more, and the card-vs-CPU gradient check
                at 2 + 2 layers;
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
                (beam 4, batches of 8, 8 tokens) against the in-memory
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
 16. s2s     -- s2s_qwen.yaml (SLAM-Omni) through its own file: specs, which
                the registry maps to the port (run_s2s): the batch decode of
                2 questions of 2-12 s through pipeline.generate_s2s at full
                width (whisper-small, linear ds 5, Qwen2-7B 28 layers bf16,
                group decode over code_layer 3, 48 of the recipe's 360 new
                tokens, seeded random init), vocoded by the CosyVoice flow +
                HiFT at
                CosyVoice-300M's widths from written flow.pt / hift.pt (a
                waveform of the expected length for every utterance, K1 12 +
                28 an utterance); online rounds through S2SSession.run_round
                (a text round, two wav rounds threading the history); the
                first 32 greedy text and audio tokens at 2 layers in f32
                equal on the card and the CPU; both vocoders at full width
                against the CPU (SNAC snac_24khz from a written file);
                stream_round at code_layer 7 with SNAC at 2 layers; the
                recipe's training through pipeline.finetune at 2 layers of
                Qwen2-7B's widths (batch 8, one step in each of the 512 /
                1024 / 1536 buckets, K1 14 / K4 2 a step; the embedding, the
                head, the group-decode adapter and the projector move;
                model.pt read back), the loss card vs CPU within 1e-2, and
                two steps each with the TTS adapter and with
                train_audio_embed_only (the text rows of the head stay).
 17. vallex  -- vallex_tts.yaml (VALL-E X) at full width (run_vallex): base_24l
                (24 AR + 24 NAR layers, d 1024, 16 heads, 8 codebooks,
                seeded random init, every tensor trained) through
                pipeline.finetune on synthetic 8-codebook corpora in the 512
                and 1024 audio buckets (K1 = K4 = 48 a step; the text's
                padding is a hole inside the key rows, which phase 3 checks
                K1 / K4 at), model.pt read back; pipeline.inference_vallex
                with that checkpoint and a random EnCodec-24kHz written by
                tools/synth_checkpoint (AR ms a step, NAR ms, codec ms, RTF,
                the wav); the card vs the CPU at 2 + 2 layers (the loss and
                every gradient in bf16; the greedy codes in f32, K1's f32
                route, not counted on the path); EnCodec card vs CPU in f32
                (relative L2 1e-3, which cuDNN's TF32 must exceed).
 18. peft    -- asr_whisper_tinyllama.yaml at full width with
                peft_method=prefix, then llama_adapter (run_peft):
                pipeline.finetune for 4 steps of 16 (the projector and the new
                leaves move, everything else stays), inference_batch with the
                checkpoint (beam 4) against the in-memory decode, the card vs
                the CPU at 2 + 2 layers; under prefix-tuning the LLM's
                attention is the plain path (K1 only in the encoder, no K4).
 19. distributed -- the sharded path (run_distributed): `python -m
                torch.distributed.run --standalone --nproc_per_node=1
                chip_smoke.py --distributed-job <json>`, a subprocess with a
                timeout, runs at world size 1 on NCCL, FSDP2 over the
                ("dp", "fsdp") mesh: (a) the ASR recipe through
                pipeline.finetune as phase 5 runs it (8 steps of 16, int8
                base, LoRA, remat), its losses, grad norms and model.pt
                within 1e-6 relative of phase 5's (bit-equality logged);
                (b) s2s_qwen at 2 layers of Qwen2-7B's widths, the whole LLM
                trained, against phase 16's steps; (c) inference_batch, line
                for line against phase 4's decode; every module's parameters
                plain and contiguous when it computes; the launches count on
                the `distributed` path. With two or more cards, (a) at
                fsdp=2 (with four, also fsdp=4 and dp=2 x fsdp=2) against (a)
                (run_multi_card); otherwise a line says why not.
 20. tensor parallel -- every family split over shard.tp
                (run_tensor_parallel): phase 3 already held K1 / K4 at a tp
                rank's heads (TinyLlama, vicuna-7b, Qwen2-7B at tp = 2 and 4;
                VALL-E X at tp = 2 and 4; the Q-Former, EAT, emotion2vec,
                MusicFM, AV-HuBERT, HuBERT and, on the f32 routes,
                Spatial-AST at tp = 2),
                K2's absmax and given-scale passes (bit-equal to the columns
                of a whole-row K2 run) and K3's s32 mode and epilogue
                (bit-equal to the fused bf16 / f32 path) at a rank's widths;
                (b) whether gloo runs all_reduce SUM / MAX (f32, int32,
                int64), all_gather and FSDP2's all_gather_into_tensor (bf16,
                f32, uint8) on CUDA tensors; where it does, two torchrun
                ranks on this card over gloo: the ASR recipe (whisper, the
                projector and the LLM split) through pipeline.finetune at
                shard.tp=2, phase 5's first step of 16 (the loss within one
                bf16 rounding, the grad norm within 1e-2), inference_batch
                at tp=2 line for line against phase 4's first 8, s2s_qwen at
                2 layers of Qwen2-7B's widths at tp=2 against phase 19 (b)'s
                first step (its heads split over the vocabulary: no rank
                gathers more than one CE chunk of logits), generate_s2s at
                tp=2 against world size 1; then the decodes sharded over
                fsdp=2: inference_batch on phase 4's 16 utterances (a batch
                a rank) line for line phase 4's, generate_s2s against world
                size 1, each rank's decode steps and its own last useful
                steps, every module computing with plain, contiguous
                parameters; then the other families (run_tp_families) at 2 +
                2 layers, against world size 1 run here: SELD with
                Spatial-AST trained and VALL-E X, a training step each
                (losses within one bf16 rounding, grad norms within 1e-2),
                and the SEC decode (emotion2vec and the Q-Former split) line
                for line; the launches count on the `tensor_parallel` path.
                (c) with two or more cards (NCCL) the ASR recipe at tp=2,
                with four also tp=4, fsdp=2 x tp=2, s2s_qwen at Qwen2-7B's
                full 28 layers at tp=4 and fsdp=2 x tp=2 (run_multi_card_tp),
                the decodes at fsdp=4 and fsdp=2 x tp=2 against one card,
                s2s_qwen's at 28 layers at fsdp=4 (run_multi_card_decode),
                vallex_tts at base_24l at tp=4 and fsdp=2 x tp=2 and
                asr_wavlm_vicuna at tp=4 (run_families_tp); otherwise a line
                says why not.
 21. text    -- runs after phase 15, before phase 16 (run_text): the
                text-only recipe (dataset text_dataset, encoder_name null,
                the byte tokenizer) on Qwen2-7B at full width and depth
                (seeded random weights, the int8 base with the int8_rot
                backward and the int8 CE head, LoRA r8 on q / v) through
                pipeline.finetune (4 steps of 8 in the 256 bucket: LoRA
                moves, the unreached projector does not) and
                pipeline.inference_batch with ckpt_path (beam 4, 8 tokens)
                line for line against the in-memory decode; the int8_rot
                backward by its statistics and the deterministic int8
                backward against the CPU plain path at 2 layers (cosine >=
                0.99, the loss within 1e-2); shard.bwd_pretranspose on
                TinyLlama-1.1B with a bf16 base, with and without (losses
                within 2^-8, LoRA gradients cosine >= 0.999); the BEATs
                tokenizer's extract_labels at beats_iter3's widths (K1 at
                (4, 496, 12/12, 64)) against its CPU plain path (>= 99 % of
                the labels, features cosine >= 0.999); the perplexity CLI
                on a random TinyLlama-1.1B directory it writes, card vs CPU
                within 1e-2. Phase 3 holds K1 / K4 at (8, 256, 28/4, 128)
                with fused RoPE theta 1e6 and K1 at (4, 496, 12/12, 64), K2
                at rows 3584 / 18944 wide (deterministic, rotate + SR, fold)
                and the (512, 152064) f32 dlog, K3 at Qwen2-7B's separate
                projections, MLP and dx at M = 2048 and beam M = 32 (cold
                weights), and the CE head's f32 logits (512, 3584 -> 152064).
 22. routes -- the flash kernels' last routes on the paths that reach them
                (run_routes, after phase 21): (a) models.llm.CausalLM at
                TinyLlama-1.1B's widths in f32, 22 layers, LoRA r8 on q / v,
                two AdamW steps of 8 x 512 left-padded rows (K1 f32 and K4
                f32 with fused RoPE once a layer) and a prefill, the card
                against the CPU at 2 layers with TF32 off (loss within 1e-5
                relative, LoRA gradients cosine >= 0.9999); (b) a head_dim-
                256 decoder at gemma-2b's widths (bf16, 18 layers, 8 heads
                over 1, tied embeddings), two steps (K1 / K4 at D 256 with
                fused RoPE), a prefill and 7 decode steps through the KV
                cache, the card against the CPU at 2 layers (loss 1e-2,
                cosine 0.99); (c) layers.mha_attention with gradients at Tq
                != Tk, keys right-padded, bf16 and f32, 256 queries over 1500
                keys and back at whisper-small's heads and one case at D 256,
                against the twins (K4 within 2.4e-3 relative L2, the f32
                routes 2e-5 of the twin's largest entry). Phase 3 holds the
                four kernels at these shapes (and D 192 at (4, 1024, 16/2,
                192) with fused RoPE), under the path key "routes".

Prints one JSON line of kernel results before the last line, and as the last
line {"ok": true, "device": {...}}. Exits non-zero, printing no result, when
anything fails or no CUDA device is present.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import datetime
import functools
import itertools
import json
import logging
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
RECIPE = ROOT / "examples" / "asr_librispeech" / "conf" / "asr_whisper_tinyllama.yaml"


def log(*args):
    print(*args, flush=True)


# The CPU side of the card-vs-CPU checks (a bf16 model on the host runs at a
# few hundred GFLOP/s: about a quarter of the whole run) runs on one worker
# thread beside the phases after its own; phase 19 starts once every one has
# passed. The card side of each check runs in the main thread, so the launch
# counts and the card's memory stay the phases' own.
CPU_SIDE_THREADS = 6  # intra-op threads of the worker: the card's host has 8 cores, the phases keep the rest
_CPU_SIDE = {"pool": None, "pending": []}


def on_cpu(label: str, fn) -> None:
    """Queue ``fn`` (the CPU side of a check, with its log and its gate) on
    the worker thread; ``cpu_checks_done`` waits for it and raises its
    failure."""
    if _CPU_SIDE["pool"] is None:
        _CPU_SIDE["pool"] = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="cpu_side", initializer=torch.set_num_threads, initargs=(CPU_SIDE_THREADS,))
    _CPU_SIDE["pending"].append((label, _CPU_SIDE["pool"].submit(fn)))


def cpu_checks_done() -> None:
    """Waits for every queued CPU side, in order; raises the first failure."""
    t0 = time.perf_counter()
    pending, _CPU_SIDE["pending"] = _CPU_SIDE["pending"], []
    for label, fut in pending:
        try:
            fut.result()
        except Exception as e:
            raise AssertionError(f"the card-vs-CPU check of {label} failed: {type(e).__name__}: {e}") from e
    log(f"[cpu side] {len(pending)} card-vs-CPU checks passed; phase 19 waited {time.perf_counter() - t0:.1f} s for "
        f"them")


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


def attended_pairs(mask, causal: bool, tq: int = None) -> int:
    """(query, key) pairs the attention computes for this key mask: every
    one of the ``tq`` queries (Tk by default) against each live key, or only
    keys at or before it when causal."""
    live = mask.bool()
    t = mask.shape[1]
    if causal:
        return int((live * torch.arange(t, 0, -1, device=mask.device)).sum().item())
    return int(live.sum().item()) * (t if tq is None else tq)


def _tq_tk(t):
    """A case's T: one length (self-attention) or (Tq, Tk)."""
    return t if isinstance(t, tuple) else (t, t)


def _padding_mask(b, t, pad, dev="cuda"):
    """Key masks: ``none``, ``right``, ``left``, ``both``; ``hole<tt>``,
    VALL-E X's ``[text valid | text pad | audio valid | audio pad]`` over a
    text bucket of ``tt`` (``vallex_mask``); ``tail<n>``, the first ``n``
    keys valid (an AR decode step's)."""
    if pad.startswith("hole"):
        return vallex_mask(b, int(pad[4:]), t - int(pad[4:]), dev)
    if pad.startswith("tail"):
        mask = torch.zeros(b, t, dtype=torch.int32, device=dev)
        mask[:, :int(pad[4:])] = 1
        return mask
    mask = torch.ones(b, t, dtype=torch.int32, device=dev)
    for i in range(b):
        n_pad = (i * 37) % max(1, t // 3)
        if pad in ("right", "both"):
            mask[i, t - n_pad // (2 if pad == "both" else 1):] = 0
        if pad in ("left", "both"):
            mask[i, :n_pad] = 0
    return mask


def vallex_mask(b, tt, ta, dev="cuda"):
    """VALL-E X's key mask over [text ; audio]: each row's text padded to the
    bucket ``tt`` leaves a hole inside the row, placed differently in each
    row so that the holes cross the key tiles in different places."""
    mask = torch.zeros(b, tt + ta, dtype=torch.int32, device=dev)
    for i in range(b):
        nt, na = tt - (i * 13) % (tt // 2), ta - (i * 97) % (ta // 2)
        mask[i, :nt] = 1
        mask[i, tt:tt + na] = 1
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
        # phase 16: S2S on Qwen2-7B: the batch decode's prefill of one utterance (rotated before K1, as prefill
        # runs it; fused at the same shape, as the training path runs it); the training step and the TTS
        # adapter's blocks at each of the recipe's text buckets (whisper-small's K1 is the first row's kernel)
        ("qwen2-7b prefill (s2s)", 1, S2S_PREFILL_T, 28, 4, 128, True, "none", 0),
        ("qwen2-7b prefill shape (s2s), fused RoPE theta 1e6", 1, S2S_PREFILL_T, 28, 4, 128, True, "none", 1e6),
        *(("qwen2-7b training (s2s), fused RoPE theta 1e6, left-padded", S2S_BATCH, t, 28, 4, 128, True, "left", 1e6)
          for t in S2S_TRAIN_T),
        # phase 17: VALL-E X (base_24l, 16 / 16 heads, D = 64) at the training buckets: the AR stack causal over
        # [text ; audio + the end-of-audio column], the NAR stack not causal, the text's padding a hole in the
        # key row; the AR decode step's whole re-forward over [text ; prompt + max_new]
        *(("VALL-E X AR training, causal, text-padding hole", VX_BATCH, VX_TT + ta + 1, 16, 16, 64, True,
           f"hole{VX_TT}", 0) for ta in VX_TA),
        *(("VALL-E X NAR training, text-padding hole", VX_BATCH, VX_TT + ta, 16, 16, 64, False, f"hole{VX_TT}", 0)
          for ta in VX_TA),
        ("VALL-E X AR decode step, causal", 1, VX_DECODE_T, 16, 16, 64, True, f"tail{VX_DECODE_T // 2}", 0),
        # phase 20: a tensor-parallel rank's heads (H / tp, Hkv / tp) at tp = 2 and 4
        *TP_K1_CASES,
        *TP_FAMILY_K1_CASES,
        # phase 21: the text-only Qwen2-7B step (its 256 bucket) and the BEATs tokenizer's trunk (10 s clips)
        ("qwen2-7b text-only training, fused RoPE theta 1e6, left-padded", TEXT_BATCH, TEXT_T, 28, 4, 128, True,
         "left", 1e6),
        ("BEATs tokenizer trunk, right-padded", BT_CLIPS, BT_PATCHES, 12, 12, 64, False, "right", 0),
        # phase 22: the head_dim-256 decoder's training (fused RoPE) and prefill (rotated before K1), head_dim
        # 192, and the op at Tq != Tk (T is (Tq, Tk))
        *ROUTES_K1_CASES,
    ]
    worst, rows = 0.0, []
    for name, b, t, h, hkv, d, causal, pad, theta in cases:
        fused = theta > 0
        tq, tk = _tq_tk(t)
        q = torch.randn(b, tq, h, d, generator=gen, device=dev).bfloat16()
        k = torch.randn(b, tk, hkv, d, generator=gen, device=dev).bfloat16()
        v = torch.randn(b, tk, hkv, d, generator=gen, device=dev).bfloat16()
        mask = _padding_mask(b, tk, pad)
        rope = _rope_for(mask, d, theta) if fused else None
        out, lse = flash_attention_fwd(q, k, v, mask, causal, rope=rope)
        torch.cuda.synchronize()
        # the twin sees q / k rotated as the kernel rotates them (f32, one bf16 rounding)
        qr, kr = (apply_rope_tables(x, *rope) for x in (q, k)) if fused else (q, k)
        ref, ref_lse = flash_attention_ref(qr.float(), kr.float(), v.float(), mask, causal)
        if causal:
            live = mask.cumsum(1) > 0  # left padding + causal: rows before the first key are dead
        else:
            live = (mask.sum(1, keepdim=True) > 0).expand(b, tq)
        err = (out.float() - ref).abs().max().item()
        lse_err = (lse - ref_lse)[live].abs().max().item()
        dead = out[~live]
        dead_ok = bool((dead == 0).all().item()) if dead.numel() else True
        n_dead = int((~live).sum().item())
        ms = time_ms(lambda: flash_attention_fwd(q, k, v, mask, causal, rope=rope))
        plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, mask, causal, rope=rope), reps=3)
        bound_ms, bound_by = bound(4 * h * d * attended_pairs(mask, causal, tq),
                                   nbytes(q, k, v, mask, out, lse, *(rope or ())), BF16_FLOPS)
        library_ms = near_ms = None
        if pad in ("none", "right") and not fused:  # SDPA computes the same function
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            sdpa_mask = None if pad == "none" else mask[:, None, None, :].bool()
            library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=sdpa_mask, is_causal=causal and sdpa_mask is None, enable_gqa=h != hkv))
        elif pad.startswith(("hole", "tail")) and not fused:  # every row sees its first key: the same function
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            sdpa_mask = _bool_mask(mask, causal)
            library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=sdpa_mask, enable_gqa=h != hkv))
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
    from slam_llm_tpu_torch.ops.kernels.flash_attention import (
        apply_rope_tables,
        flash_attention_fwd,
        flash_attention_ref,
    )

    dev = "cuda"
    cases = [
        # (name, B, T, H, Hkv, D, causal, padding)
        ("Spatial-AST-base encoder, training batch", 16, SA_T, 12, 12, 64, False, "none"),
        ("Spatial-AST-base encoder, decode batch", 8, SA_T, 12, 12, 64, False, "none"),
        ("ragged keys, right-padded", 8, SA_T, 12, 12, 64, False, "right"),
        ("causal, left-padded", 4, SA_T, 12, 12, 64, True, "left"),
        ("GQA, head_dim 128, causal", 2, 256, 8, 2, 128, True, "right"),
        *TP_FAMILY_F32_CASES,
        # phase 22: the f32 decoder's training (fused RoPE) and prefill (rotated before K1 f32), head_dim 192 /
        # 256 (the f32 FMA kernel), and the op at Tq != Tk; (.., padding, fused RoPE's theta)
        *ROUTES_F32_CASES,
    ]
    worst, rows = 0.0, []
    for name, b, t, h, hkv, d, causal, pad, *theta in cases:
        fused = bool(theta) and theta[0] > 0
        tq, tk = _tq_tk(t)
        q = torch.randn(b, tq, h, d, generator=gen, device=dev)
        k = torch.randn(b, tk, hkv, d, generator=gen, device=dev)
        v = torch.randn(b, tk, hkv, d, generator=gen, device=dev)
        mask = _padding_mask(b, tk, pad)
        rope = _rope_for(mask, d, theta[0]) if fused else None
        out, lse = flash_attention_fwd(q, k, v, mask, causal, rope=rope)
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_ref(q, k, v, mask, causal, rope=rope)
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32, _ = flash_attention_ref(q, k, v, mask, causal, rope=rope)
        torch.backends.cuda.matmul.allow_tf32 = False
        live = mask.cumsum(1) > 0 if causal else (mask.sum(1, keepdim=True) > 0).expand(b, tq)
        err = (out - ref).abs().max().item()
        tf32_err = (tf32 - ref).abs().max().item()
        lse_err = (lse - ref_lse)[live].abs().max().item()
        dead = out[~live]
        dead_ok = bool((dead == 0).all().item()) if dead.numel() else True
        ms = time_ms(lambda: flash_attention_fwd(q, k, v, mask, causal, rope=rope))
        plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, mask, causal, rope=rope), reps=3)
        ops, moved = 4 * h * d * attended_pairs(mask, causal, tq), nbytes(q, k, v, mask, out, lse, *(rope or ()))
        # D 64 / 128 run 3xTF32 on the tensor cores, D 192 / 256 f32 FMA on the CUDA cores
        bound_ms, bound_by = bound(ops, moved, TF32X3_FLOPS if d <= 128 else FP32_FLOPS)
        fma_ms = bound(ops, moved, FP32_FLOPS)[0]
        if fused:
            q, k = (apply_rope_tables(x, *rope) for x in (q, k))  # the near yardstick's operands
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = near_ms = None
        if pad in ("none", "right") and not causal and not fused:  # SDPA computes the same function, in f32
            sdpa_mask = None if pad == "none" else mask[:, None, None, :].bool()
            library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=sdpa_mask, enable_gqa=h != hkv))
        else:
            near_mask = _bool_mask(mask, causal)
            near_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=near_mask, enable_gqa=h != hkv))
        log(f"[K1 f32] {name} {(b, t, h, hkv, d)} causal={causal}: max|out-ref| {err:.3e} (the twin under "
            f"single-pass TF32: {tf32_err:.3e}) max|lse-ref| {lse_err:.3e} dead rows {int((~live).sum())} all-zero "
            f"{dead_ok} | kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}, "
            f"{'3xTF32' if d <= 128 else 'f32 FMA'}) share {bound_ms / ms:.3f}, f32 FMA bound {fma_ms:.4f} ms share "
            f"{fma_ms / ms:.3f} SDPA f32 "
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
        # phase 16: S2S's Qwen2-7B training step (and TTS adapter blocks) at each of the recipe's text buckets
        *(("qwen2-7b training (s2s), fused RoPE theta 1e6, left-padded", S2S_BATCH, t, 28, 4, 128, True, "left", 1e6)
          for t in S2S_TRAIN_T),
        # phase 17: VALL-E X's AR and NAR stacks at the training buckets, the text's padding a hole in the key row
        *(("VALL-E X AR training, causal, text-padding hole", VX_BATCH, VX_TT + ta + 1, 16, 16, 64, True,
           f"hole{VX_TT}", 0) for ta in VX_TA),
        *(("VALL-E X NAR training, text-padding hole", VX_BATCH, VX_TT + ta, 16, 16, 64, False, f"hole{VX_TT}", 0)
          for ta in VX_TA),
        # phase 20: a tensor-parallel rank's heads at the training shapes
        *(c for c in TP_K1_CASES if "training" in c[0]),
        *TP_FAMILY_K4_CASES,
        # phase 21: the text-only Qwen2-7B step
        ("qwen2-7b text-only training, fused RoPE theta 1e6, left-padded", TEXT_BATCH, TEXT_T, 28, 4, 128, True,
         "left", 1e6),
        # phase 22: the head_dim-256 decoder's step, head_dim 192, the op at Tq != Tk (held to 2.4e-3)
        *ROUTES_K4_CASES,
    ]
    worst, rows = 0.0, []
    for case in cases:
        name, b, t, h, hkv, d, causal, pad, theta = case
        fused = theta > 0
        tq, tk = _tq_tk(t)
        q = torch.randn(b, tq, h, d, generator=gen, device=dev).bfloat16()
        k = torch.randn(b, tk, hkv, d, generator=gen, device=dev).bfloat16()
        v = torch.randn(b, tk, hkv, d, generator=gen, device=dev).bfloat16()
        dout = torch.randn(b, tq, h, d, generator=gen, device=dev).bfloat16()
        mask = _padding_mask(b, tk, pad)
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
        if causal:
            dead = mask.cumsum(1) == 0
        else:
            dead = (mask.sum(1, keepdim=True) == 0).expand(b, tq)
        dead_ok = bool((got[0][dead] == 0).all().item()) if bool(dead.any()) else True
        again = flash_attention_bwd(q, k, v, mask, out, lse, dout, causal, rope=rope)
        deterministic = all(torch.equal(a, g) for a, g in zip(again, got))
        ms = time_ms(lambda: flash_attention_bwd(q, k, v, mask, out, lse, dout, causal, rope=rope))
        plain_ms = time_ms(lambda: flash_attention_bwd_ref(*args32), reps=3)
        bound_ms, bound_by = bound(10 * h * d * attended_pairs(mask, causal, tq),
                                   nbytes(q, k, v, mask, out, lse, dout, *got, *(rope or ())), BF16_FLOPS)
        # SDPA's backward computes the same gradients where there is no fused
        # RoPE and no causal left padding (VALL-E X's rows all see their
        # first key); else it is the near yardstick
        same = not fused and (not causal or pad.startswith("hole"))
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
        tol = K4_ROUTES_REL_L2 if case in ROUTES_K4_CASES else 2e-2
        if not (max(rel) <= tol and dead_ok and deterministic):
            raise AssertionError(f"K4 {name}: rel L2 {rel} (tol {tol}), dead dq zero {dead_ok}, "
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
        apply_rope_tables,
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
        *TP_FAMILY_F32_CASES,
        # phase 22: the f32 decoder's step (fused RoPE), head_dim 192 / 256 (the f32 FMA kernels), the op at
        # Tq != Tk; (.., padding, fused RoPE's theta)
        *(c for c in ROUTES_F32_CASES if "prefill" not in c[0]),
    ]

    worst, rows = 0.0, []
    for name, b, t, h, hkv, d, causal, pad, *theta in cases:
        fused = bool(theta) and theta[0] > 0
        tq, tk = _tq_tk(t)
        q = torch.randn(b, tq, h, d, generator=gen, device=dev)
        k = torch.randn(b, tk, hkv, d, generator=gen, device=dev)
        v = torch.randn(b, tk, hkv, d, generator=gen, device=dev)
        dout = torch.randn(b, tq, h, d, generator=gen, device=dev)
        mask = _padding_mask(b, tk, pad)
        rope = _rope_for(mask, d, theta[0]) if fused else None
        out, lse = flash_attention_fwd(q, k, v, mask, causal, rope=rope)
        args = (q, k, v, mask, out, lse, dout, causal)
        got = flash_attention_bwd(*args, rope=rope)
        torch.cuda.synchronize()
        want = flash_attention_bwd_ref(*args, rope=rope)
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32 = flash_attention_bwd_ref(*args, rope=rope)
        torch.backends.cuda.matmul.allow_tf32 = False
        err, tf32_err = (bwd_f32_error(x, want, q, k, v, dout) for x in (got, tf32))
        abs_err = max((g - w).abs().max().item() for g, w in zip(got, want))
        dead = (mask.cumsum(1) == 0) if causal else (mask.sum(1, keepdim=True) == 0).expand(b, tq)
        dead_ok = bool((got[0][dead] == 0).all().item()) if bool(dead.any()) else True
        again = flash_attention_bwd(*args, rope=rope)
        deterministic = all(torch.equal(a, g) for a, g in zip(again, got))
        ms = time_ms(lambda: flash_attention_bwd_f32(*args, rope=rope))
        plain_ms = time_ms(lambda: flash_attention_bwd_ref(*args, rope=rope), reps=3)
        ops = 10 * h * d * attended_pairs(mask, causal, tq)
        moved = nbytes(q, k, v, mask, out, lse, dout, *got, *(rope or ()))
        bound_ms, bound_by = bound(ops, moved, TF32X3_FLOPS if d <= 128 else FP32_FLOPS)
        fma_ms = bound(ops, moved, FP32_FLOPS)[0]
        qr, kr = (apply_rope_tables(x, *rope) for x in (q, k)) if fused else (q, k)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (qr, kr, v))
        ref_out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=_bool_mask(mask, causal), enable_gqa=h != hkv)
        dout_t = dout.transpose(1, 2)
        sdpa_bwd = event_ms(lambda: torch.autograd.grad(ref_out, (qt, kt, vt), dout_t, retain_graph=True))
        near = fused or (causal and pad == "left")
        library_ms, near_ms = (None, sdpa_bwd) if near else (sdpa_bwd, None)
        del ref_out
        log(f"[K4 f32] {name} {(b, t, h, hkv, d)} causal={causal}: max|g-ref| / max|ref| over dq, dk, dv {err:.3e} "
            f"(the twin under single-pass TF32: {tf32_err:.3e}), max abs {abs_err:.3e}, dead rows {int(dead.sum())} "
            f"dq zero {dead_ok}, deterministic {deterministic} | kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
            f"{bound_ms:.4f} ms ({bound_by}, {'3xTF32' if d <= 128 else 'f32 FMA'}) share {bound_ms / ms:.3f}, "
            f"f32 FMA bound {fma_ms:.4f} ms share "
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


def check_flash_panels(gen, f32: bool, backward: bool) -> dict:
    """The panel route above head_dim 256 (csrc/flash_attention_wide.cu) at
    phase 22's shapes (``PANEL_CASES``), one of its four kernels: K1 or K4,
    bf16 or f32, each against the f32 twin on the kernel's own inputs (q / k
    rotated in the inputs' dtype as the kernel rotates them; K4 on K1's out
    and lse). K1: bf16 out within 2e-2 abs and live-row lse within 1e-3,
    f32 out within 2e-5 of the twin's largest entry and lse within 1e-4; K4:
    bf16 dq / dk / dv within K4_PANEL_REL_L2 relative L2, f32 within 2e-5
    of the twin's largest entry (``bwd_f32_error``); rows with no visible
    key 0, K4 the same bits twice. Bound: 4 (K1) / 10 (K4) operations a
    visible pair and head_dim at the data type's peak (bf16's tensor cores,
    f32's FMA). Library: SDPA (its backward for K4) where it computes the
    same function (no fused RoPE, no causal left padding), else the near
    yardstick."""
    from slam_llm_tpu_torch.ops.kernels import flash_attention as fa

    dt = torch.float32 if f32 else torch.bfloat16
    kernel = getattr(fa, f"flash_attention_{'bwd' if backward else 'fwd'}_wide{'_f32' if f32 else ''}")
    label = f"[{'K4' if backward else 'K1'}{' f32' if f32 else ''} panels]"
    worst, rows = 0.0, []
    for name, b, t, h, hkv, d, causal, pad, theta in PANEL_CASES:
        fused = theta > 0
        tq, tk = _tq_tk(t)
        q = torch.randn(b, tq, h, d, generator=gen, device="cuda").to(dt)
        k, v = (torch.randn(b, tk, hkv, d, generator=gen, device="cuda").to(dt) for _ in range(2))
        dout = torch.randn(b, tq, h, d, generator=gen, device="cuda").to(dt)
        mask = _padding_mask(b, tk, pad)
        rope = _rope_for(mask, d, theta) if fused else None
        out, lse = fa.flash_attention_fwd(q, k, v, mask, causal, rope=rope)
        qr, kr = (fa.apply_rope_tables(x, *rope) for x in (q, k)) if fused else (q, k)
        live = mask.cumsum(1) > 0 if causal else (mask.sum(1, keepdim=True) > 0).expand(b, tq)
        if backward:
            args = (q, k, v, mask, out, lse, dout, causal)
            got = kernel(*args, rope=rope)
            torch.cuda.synchronize()
            args32 = (qr.float(), kr.float(), v.float(), mask, out.float(), lse, dout.float(), causal)
            want = fa.flash_attention_bwd_ref(*args32)
            if fused:
                want = (fa.apply_rope_tables(want[0], *rope, inverse=True),
                        fa.apply_rope_tables(want[1], *rope, inverse=True), want[2])
            if f32:
                err, tol, what = fa.bwd_f32_error(got, want, q, k, v, dout), 2e-5, "of the twin's largest entry"
            else:
                err = max(((g.float() - w).norm() / w.norm()).item() for g, w in zip(got, want))
                tol, what = K4_PANEL_REL_L2, "relative L2"
            abs_err = max((g.float() - w).abs().max().item() for g, w in zip(got, want))
            again = kernel(*args, rope=rope)
            ok = all(torch.equal(a, g) for a, g in zip(again, got)) and bool((got[0][~live] == 0).all())
            lse_err = 0.0
            ms = time_ms(lambda: kernel(*args, rope=rope), reps=3)
            plain_ms = time_ms(lambda: fa.flash_attention_bwd_ref(*args32), reps=3)
            ops, moved = 10 * h * d * attended_pairs(mask, causal, tq), nbytes(*args[:7], *got, *(rope or ()))
        else:
            out, lse = kernel(q, k, v, mask, causal, rope=rope)
            torch.cuda.synchronize()
            ref, ref_lse = fa.flash_attention_ref(qr.float(), kr.float(), v.float(), mask, causal)
            if f32:
                err, tol, what = (out - ref).abs().max().item() / ref.abs().max().item(), 2e-5, "of the largest"
            else:
                err, tol, what = (out.float() - ref).abs().max().item(), 2e-2, "abs"
            abs_err = (out.float() - ref).abs().max().item()
            lse_err = (lse - ref_lse)[live].abs().max().item()
            ok = lse_err <= (1e-4 if f32 else 1e-3) and bool((out[~live] == 0).all())
            ms = time_ms(lambda: kernel(q, k, v, mask, causal, rope=rope), reps=3)
            plain_ms = time_ms(lambda: fa.flash_attention_ref(q, k, v, mask, causal, rope=rope), reps=3)
            ops, moved = 4 * h * d * attended_pairs(mask, causal, tq), nbytes(q, k, v, mask, out, lse, *(rope or ()))
        bound_ms, bound_by = bound(ops, moved, FP32_FLOPS if f32 else BF16_FLOPS)
        same = not fused and not (causal and pad == "left")
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(backward) for x in (qr, kr, v))
        sdpa_mask = _bool_mask(mask, causal)
        if backward:
            ref_out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=sdpa_mask,
                                                                       enable_gqa=h != hkv)
            dout_t = dout.transpose(1, 2)
            sdpa_ms = event_ms(lambda: torch.autograd.grad(ref_out, (qt, kt, vt), dout_t, retain_graph=True), reps=3)
            del ref_out
        else:
            sdpa_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=sdpa_mask, enable_gqa=h != hkv), reps=3)
        library_ms, near_ms = (sdpa_ms, None) if same else (None, sdpa_ms)
        log(f"{label} {name} {(b, t, h, hkv, d)} causal={causal}: error {err:.3e} {what} (limit {tol:.0e}), live-row "
            f"lse {lse_err:.3e}, dead rows {int((~live).sum())} zero / deterministic {ok} | kernel {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}, {'f32 FMA' if f32 else 'bf16'}) share "
            f"{bound_ms / ms:.4f} SDPA {_r(library_ms)} ms | near: {_r(near_ms)} ms | {SMI}")
        if not (err <= tol and ok):
            raise AssertionError(f"{label} {name}: error {err} (limit {tol}), dead rows / determinism / lse {ok}")
        worst = max(worst, abs_err)
        rows.append(dict(at=f"{name} {(b, t, h, hkv, d)}", ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=library_ms, near_library_ms=near_ms, error=err, limit=tol))
    first = {k: v for k, v in rows[0].items() if k not in ("near_library_ms", "error", "limit")}
    return dict(max_abs_err=worst, **first, error_is=what, near_library=NEAR, cases=rows)


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
    # phase 21: Qwen2-7B's rows 3584 / 18944 wide at the text batch's M and beam M, the int8 CE head's hidden
    # (a chunk of 8 x 64 rows)
    qwen2 = [(m, k) for m in (TEXT_M, 32) for k in (3584, 18944)] + [(TEXT_BATCH * 64, 3584)]
    for m, k in ((4096, 2048), (4096, 5632), (32, 2048), (32, 5632), (8192, 2048), (8192, 5632), (3584, 2048),
                 (1337, 5632), (3, 2056), *vicuna, *qwen2):
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
    # phase 21: the int8_rot dy of Qwen2-7B's denses at the text batch's M (F = 3584, 512, 18944)
    qwen2 = [(TEXT_M, f, 31 + f, True) for f in (3584, 512, 18944)]
    for m, k, seed, rotate in ((8192, 2048, 1234567, True), (8192, 256, 7, True), (8192, 5632, 2**32 - 1, True),
                               (37, 2048, None, True), (37, 2048, 99, False), *qwen2):
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
    # phase 21: Qwen2-7B's deterministic int8 dy (its card-vs-CPU check) and the 152064-wide f32 dlog of a CE
    # chunk (8 x 64 rows), the long-row path
    cases += [(TEXT_M, k, torch.bfloat16, None) for k in (3584, 512, 18944)]
    cases += [(TEXT_BATCH * 64, 152064, torch.float32, seed) for seed in (None, 2**31 + 7)]
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
    # phase 21: Qwen2-7B's int8 CE head, the logits of a chunk (8 x 64 rows, 3584 -> 152064)
    for m, k, f in ((1024, 2048, 32000), (1024, 32000, 2048), (37, 48, 40), (TEXT_BATCH * 64, 3584, 152064)):
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
    # phase 21: Qwen2-7B's separate projections (q / o 3584 -> 3584, k / v 3584 -> 512), gate / up and down at
    # the text batch's M and at beam M (weights cold), and the int8_rot dx of k / v (512 -> 3584; the others'
    # dx shapes are the forward ones)
    shapes += [(m, kc, n) for m in (TEXT_M, 32) for kc, n in ((3584, 3584), (3584, 512), (3584, 18944), (18944, 3584))]
    shapes += [(TEXT_M, 512, 3584)]
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


# phase 20: a tensor-parallel rank's shapes. K1 / K4 at H / tp query and
# Hkv / tp key / value heads (TinyLlama 32 / 4, vicuna-7b 32 / 32, Qwen2-7B
# 28 / 4) at tp = 2 and 4, training (fused RoPE) and prefill
TP_SIZES = (2, 4)
TP_K1_CASES = [case for tp in TP_SIZES for case in (
    (f"tinyllama training at tp={tp}, fused RoPE, left-padded", 16, 512, 32 // tp, 4 // tp, 64, True, "left", 1e4),
    (f"tinyllama prefill at tp={tp}", 8, 512, 32 // tp, 4 // tp, 64, True, "none", 0),
    (f"vicuna-7b training at tp={tp}, fused RoPE theta 1e4, left-padded", 16, 192, 32 // tp, 32 // tp, 128, True,
     "left", 1e4),
    (f"vicuna-7b prefill at tp={tp}, left-padded", 8, 192, 32 // tp, 32 // tp, 128, True, "left", 0),
    (f"qwen2-7b training (s2s) at tp={tp}, fused RoPE theta 1e6, left-padded", 8, 1536, 28 // tp, 4 // tp, 128, True,
     "left", 1e6),
    (f"qwen2-7b prefill at tp={tp}, left-padded", 8, 128, 28 // tp, 4 // tp, 128, True, "left", 0),
    # the whisper encoder split over tp: whisper-small's heads a rank, the slice's decode batch
    (f"whisper-small self-attn at tp={tp}", 8, 1500, 12 // tp, 12 // tp, 64, False, "right", 0),
)]
# K2's row-split passes and K3's s32 mode at a rank's widths: (label, M, K
# of the rank's columns, the whole row's K, dtype, fold, rotation block)
TP_K2_CASES = [
    # the row-parallel forward's activations (o_proj / down_proj inputs), deterministic
    *((f"tinyllama o_proj input at tp={tp}", 8192, 2048 // tp, 2048, "bf16", False, 0) for tp in TP_SIZES),
    *((f"tinyllama down_proj input at tp={tp}", 8192, 5632 // tp, 5632, "bf16", False, 0) for tp in TP_SIZES),
    ("vicuna-7b down_proj input at tp=2", 3072, 5504, 11008, "bf16", False, 0),
    ("qwen2-7b down_proj input at tp=4", 12288, 4736, 18944, "bf16", False, 0),
    # the column-parallel int8_rot dx: dy rotated by the whole row's block 256 (whole blocks a rank)
    ("tinyllama q_proj dy at tp=2, rotated", 8192, 1024, 2048, "bf16", False, 256),
    ("tinyllama gate / up dy at tp=2, rotated", 8192, 2816, 5632, "bf16", False, 256),
    ("tinyllama q_proj dy at tp=4, rotated", 8192, 512, 2048, "bf16", False, 256),
    # the column-parallel int8_sr dx (fold) and the vocab-parallel int8_sr CE head's f32 dlog
    ("tinyllama gate / up dy at tp=4, fold", 8192, 1408, 5632, "bf16", True, 0),
    ("vicuna-7b gate / up dy at tp=4, fold", 3072, 2752, 11008, "bf16", True, 0),
    ("CE head dlog at tp=2, f32 fold", 1024, 16000, 32000, "f32", True, 0),
]
# (label, M, K of the rank, F): row-parallel products x_q (M, K / tp) x
# w_q (F, K / tp), and the column-parallel dx z (M, F / tp) x w (K, F / tp)
TP_K3_CASES = [
    *((f"tinyllama o_proj at tp={tp}", 8192, 2048 // tp, 2048) for tp in TP_SIZES),
    *((f"tinyllama down_proj at tp={tp}", 8192, 5632 // tp, 2048) for tp in TP_SIZES),
    ("tinyllama gate / up dx at tp=2", 8192, 2816, 2048),
    ("tinyllama k / v dx at tp=2", 8192, 128, 2048),
    ("vicuna-7b down_proj at tp=2", 3072, 5504, 4096),
    ("vicuna-7b o_proj at tp=4", 3072, 1024, 4096),
    ("qwen2-7b down_proj at tp=4", 12288, 4736, 3584),
    ("qwen2-7b o_proj at tp=2", 12288, 1792, 3584),
    ("CE head dx at tp=2 (split K)", 1024, 16000, 2048),
    ("tinyllama o_proj at tp=2, beam decode M", 32, 1024, 2048),
]


def _tp_k2_inputs(gen, m, k, k_whole, dt, fold, block):
    """A whole row's x (M, K_whole), its fold, and this rank's first column
    (the last rank's: the largest Philox offset)."""
    x = torch.randn(m, k_whole, generator=gen, device="cuda") * (1e-2 if dt == "f32" else 1.0)
    x[0] = 0.0  # an all-zero row
    x[1, 3] = 40.0  # an outlier the other columns' scale must follow
    x = x.float() if dt == "f32" else x.bfloat16()
    f = torch.rand(k_whole, generator=gen, device="cuda") * 0.02 + 1e-4 if fold else None
    return x, f, k_whole - k


def check_rowquant_absmax(gen) -> dict:
    """K2's absmax pass at a tensor-parallel rank's widths, bit-exact
    against the twin; the MAX over the ranks' slices equals the whole row's
    absmax (every rank's slice is checked)."""
    from slam_llm_tpu_torch.ops.kernels.rowquant import rowquant_absmax, rowquant_absmax_ref

    first, rows = None, []
    for label, m, k, k_whole, dt, fold, block in TP_K2_CASES:
        x, f, off = _tp_k2_inputs(gen, m, k, k_whole, dt, fold, block)
        parts = [rowquant_absmax(x[:, a:a + k].contiguous(), None if f is None else f[a:a + k].contiguous(),
                                 rotate_block=block) for a in range(0, k_whole, k)]
        whole = rowquant_absmax_ref(x, f, rotate_block=block)
        torch.cuda.synchronize()
        xs, fs = x[:, off:].contiguous(), None if f is None else f[off:].contiguous()
        exact = torch.equal(parts[-1], rowquant_absmax_ref(xs, fs, rotate_block=block)) and \
            torch.equal(torch.stack(parts).amax(0), whole)
        ms = time_ms(lambda: rowquant_absmax(xs, fs, rotate_block=block))
        plain_ms = time_ms(lambda: rowquant_absmax_ref(xs, fs, rotate_block=block), reps=3)
        lib_ms = None if block or fs is not None else time_ms(lambda: torch.amax(xs.abs(), dim=-1))
        bound_ms, bound_by = bound(0, nbytes(xs, fs) + 4 * m, BF16_FLOPS)
        log(f"[K2 absmax] {label} ({m}, {k}) of {k_whole} {dt} fold={fold} block={block}: bit-exact {exact} | "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}) share "
            f"{bound_ms / ms:.3f} amax(abs) {_r(lib_ms)} ms")
        if not exact:
            raise AssertionError(f"K2 absmax {label}: not bit-exact")
        rows.append(dict(at=label, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=lib_ms))
        if first is None:
            first = rows[-1]
    return dict(max_abs_err=0.0, **first, cases=rows)


def check_rowquant_scaled(gen) -> dict:
    """K2's given-scale pass at a rank's widths: the last rank's columns
    quantized with the whole row's scale and its Philox offset, bit-equal to
    those columns of K2's whole-row run (where K2 takes the row) and to the
    twin; at offset 0 with the row's own scale, equal to K2."""
    from slam_llm_tpu_torch.ops.kernels.rowquant import (
        row_scale,
        rowquant,
        rowquant_absmax_ref,
        rowquant_scaled,
        rowquant_scaled_ref,
    )

    first, rows = None, []
    for label, m, k, k_whole, dt, fold, block in TP_K2_CASES:
        x, f, off = _tp_k2_inputs(gen, m, k, k_whole, dt, fold, block)
        seed = None if "input" in label else 2**32 - 3
        s = row_scale(rowquant_absmax_ref(x, f, rotate_block=block))
        xs, fs = x[:, off:].contiguous(), None if f is None else f[off:].contiguous()
        q = rowquant_scaled(xs, s, fs, seed=seed, col_offset=off, rotate_block=block)
        torch.cuda.synchronize()
        exact = torch.equal(q, rowquant_scaled_ref(xs, s, fs, seed=seed, col_offset=off, rotate_block=block))
        if block in (0, 256):  # K2 itself takes the whole row
            qw, sw = rowquant(x, f, seed=seed, rotate=bool(block))
            exact = exact and torch.equal(q, qw[:, off:]) and torch.equal(sw.reshape(-1), s)
        ms = time_ms(lambda: rowquant_scaled(xs, s, fs, seed=seed, col_offset=off, rotate_block=block))
        plain_ms = time_ms(lambda: rowquant_scaled_ref(xs, s, fs, seed=seed, col_offset=off, rotate_block=block),
                           reps=3)
        bound_ms, bound_by = bound(0, nbytes(xs, fs, s, q), BF16_FLOPS)
        log(f"[K2 scaled] {label} ({m}, {k}) at column {off} of {k_whole} {dt} fold={fold} block={block} "
            f"seed={seed}: bit-equal to the whole row's columns and the twin {exact} | kernel {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}) share {bound_ms / ms:.3f} library none")
        if not exact:
            raise AssertionError(f"K2 scaled {label}: not bit-equal")
        rows.append(dict(at=label, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
        if first is None:
            first = rows[-1]
    return dict(max_abs_err=0.0, **first, cases=rows)


def check_int8_matmul_s32(gen) -> dict:
    """K3's s32 mode at a rank's products, bit-exact against the f64 twin
    and against ``torch._int_mm`` (the same function); the epilogue check
    below holds it against the fused bf16 path."""
    from slam_llm_tpu_torch.kernels.build import sm_count
    from slam_llm_tpu_torch.ops.quant import int8_matmul_s32, int8_matmul_s32_ref, plan_int8_matmul

    first, rows = None, []
    for label, m, k, f in TP_K3_CASES:
        xq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
        wq = torch.randint(-127, 128, (f, k), generator=gen, device="cuda", dtype=torch.int8)
        acc = int8_matmul_s32(xq, wq)
        torch.cuda.synchronize()
        exact = torch.equal(acc, int8_matmul_s32_ref(xq, wq))
        plan = plan_int8_matmul(m, f, k, sm_count(0))
        wqs = cold(wq) if m <= 32 else itertools.repeat(wq)
        ms = time_ms(lambda: int8_matmul_s32(xq, next(wqs)))
        plain_ms = time_ms(lambda: int8_matmul_s32_ref(xq, wq), reps=3)
        lib_ms = time_ms(lambda: torch._int_mm(xq, next(wqs).t())) if m > 16 else None
        if m > 16:
            exact = exact and torch.equal(acc, torch._int_mm(xq, wq.t()))
        bound_ms, bound_by = bound(2.0 * m * k * f, nbytes(xq, wq, acc), INT8_OPS)
        log(f"[K3 s32] {label} M={m} K={k} F={f} ({plan.path}, splits {plan.splits}): bit-exact {exact} | kernel "
            f"{ms:.4f} ms plain(f64) {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}) share "
            f"{bound_ms / ms:.3f} torch._int_mm {_r(lib_ms)} ms{' (weights cold in L2)' if m <= 32 else ''}")
        if not exact:
            raise AssertionError(f"K3 s32 {label}: not bit-exact")
        rows.append(dict(at=label, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms))
        if first is None:
            first = rows[-1]
    return dict(max_abs_err=0.0, **first, cases=rows)


def check_int8_epilogue(gen) -> dict:
    """The scale epilogue of an s32 product at a rank's output shapes, bf16
    and f32: bit-equal to K3's fused epilogue on the same sums and to the
    twin."""
    from slam_llm_tpu_torch.ops.quant import int8_epilogue, int8_epilogue_ref, int8_matmul, int8_matmul_s32

    first, rows = None, []
    for label, m, k, f in TP_K3_CASES:
        xq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
        wq = torch.randint(-127, 128, (f, k), generator=gen, device="cuda", dtype=torch.int8)
        xs = torch.rand(m, generator=gen, device="cuda") * 0.05 + 1e-3
        ws = torch.rand(f, generator=gen, device="cuda") * 0.01 + 1e-4
        acc = int8_matmul_s32(xq, wq)
        exact = True
        for dt in (torch.bfloat16, torch.float32):
            out = int8_epilogue(acc, xs, ws, dt)
            exact = exact and torch.equal(out, int8_matmul(xq, wq, xs, ws, dt)) and \
                torch.equal(out, int8_epilogue_ref(acc, xs, ws, dt))
        torch.cuda.synchronize()
        ms = time_ms(lambda: int8_epilogue(acc, xs, ws))
        plain_ms = time_ms(lambda: int8_epilogue_ref(acc, xs, ws, torch.bfloat16))
        bound_ms, bound_by = bound(2.0 * m * f, nbytes(acc, xs, ws) + 2 * m * f, FP32_FLOPS)
        log(f"[K3 epilogue] {label} ({m}, {f}): bit-equal to the fused epilogue (bf16, f32) and the twin {exact} | "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}) share "
            f"{bound_ms / ms:.3f} library none")
        if not exact:
            raise AssertionError(f"K3 epilogue {label}: not bit-equal")
        rows.append(dict(at=label, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
        if first is None:
            first = rows[-1]
    return dict(max_abs_err=0.0, **first, cases=rows)


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
    # the tensor-parallel passes (phase 20): K2's absmax and given-scale passes, K3's s32 mode and its epilogue
    ("rowquant_absmax", "slam_llm_tpu_torch/csrc/rowquant.cu", "slam_llm_tpu/ops/kernels/rowquant.py:226"),
    ("rowquant_scaled", "slam_llm_tpu_torch/csrc/rowquant.cu", "slam_llm_tpu/ops/kernels/rowquant.py:222"),
    ("int8_matmul_s32", "slam_llm_tpu_torch/csrc/int8_matmul.cu", "slam_llm_tpu/ops/quant.py:103"),
    ("int8_epilogue", "slam_llm_tpu_torch/csrc/int8_matmul.cu", "slam_llm_tpu/ops/quant.py:103"),
    # the flash kernels above head_dim 256 (phase 22): K1 / K4 and their f32 routes, D split into panels
    ("flash_attention_fwd_wide", "slam_llm_tpu_torch/csrc/flash_attention_wide.cu",
     "slam_llm_tpu/ops/kernels/flash_attention.py:562"),
    ("flash_attention_fwd_wide_f32", "slam_llm_tpu_torch/csrc/flash_attention_wide.cu",
     "slam_llm_tpu/ops/kernels/flash_attention.py:562"),
    ("flash_attention_bwd_wide", "slam_llm_tpu_torch/csrc/flash_attention_wide.cu",
     "slam_llm_tpu/ops/kernels/flash_attention.py:1201"),
    ("flash_attention_bwd_wide_f32", "slam_llm_tpu_torch/csrc/flash_attention_wide.cu",
     "slam_llm_tpu/ops/kernels/flash_attention.py:1201"),
]


def check_kernels() -> list:
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_wgmma_layouts(gen)
    checks = {
        "flash_attention_fwd": check_flash, "flash_attention_fwd_f32": check_flash_f32,
        "flash_attention_bwd": check_flash_bwd, "flash_attention_bwd_f32": check_flash_bwd_f32,
        "rowquant": check_rowquant, "rowquant_rot_sr": check_rowquant_rot_sr,
        "rowquant_fold": check_rowquant_fold, "int8_matmul": check_int8_matmul,
        "int8_matmul_f32": check_int8_matmul_f32, "rowquant_absmax": check_rowquant_absmax,
        "rowquant_scaled": check_rowquant_scaled, "int8_matmul_s32": check_int8_matmul_s32,
        "int8_epilogue": check_int8_epilogue,
        **{name: functools.partial(check_flash_panels, f32="f32" in name, backward="bwd" in name)
           for name in PANEL_PATH},
    }
    results = [dict(name=name, route="cuda", source=src, replaces=rep, **checks[name](gen))
               for name, src, rep in KERNELS]
    check_head_dims(gen)
    torch.cuda.synchronize()
    return results


def check_head_dims(gen) -> None:
    """A structured attention call on the card at a head_dim the flash
    kernels do not take: D = 80 (D % 64 != 0) runs the plain path, launching
    no kernel, and equals the plain twin and the CPU's plain path; at D =
    256 (Pallas in the JAX package) the same call launches K1 once and
    matches the f32 twin within 2e-2."""
    from slam_llm_tpu_torch.models.layers import _xla_attention, apply_rope_tables, mha_attention, rope_tables
    from slam_llm_tpu_torch.ops.kernels.flash_attention import flash_attention_ref

    b, t, h, hkv, d = 2, 256, 8, 4, 80
    q = torch.randn(b, t, h, d, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(b, t, hkv, d, generator=gen, device="cuda").bfloat16() for _ in range(2))
    mask = _padding_mask(b, t, "left")
    rope = rope_tables((mask.long().cumsum(1) - 1).clamp_min(0), d, 1e4)
    out, launches = run_counted(lambda: mha_attention(q, k, v, kv_mask=mask, causal=True, rope=rope))
    qr, kr = (apply_rope_tables(x, *rope) for x in (q, k))
    twin = _xla_attention(qr, kr, v, None, mask, True)
    cpu = mha_attention(*(x.cpu() for x in (q, k, v)), kv_mask=mask.cpu(), causal=True,
                        rope=tuple(r.cpu() for r in rope))
    err = (out.float().cpu() - cpu.float()).abs().max().item()
    flash = sum(n for name, n in launches.items() if name.startswith("flash"))
    wq = torch.randn(b, t, h, 256, generator=gen, device="cuda").bfloat16()
    wk, wv = (torch.randn(b, t, hkv, 256, generator=gen, device="cuda").bfloat16() for _ in range(2))
    wrope = rope_tables((mask.long().cumsum(1) - 1).clamp_min(0), 256, 1e4)
    wide, wide_launches = run_counted(lambda: mha_attention(wq, wk, wv, kv_mask=mask, causal=True, rope=wrope))
    wref, _ = flash_attention_ref(*(apply_rope_tables(x, *wrope).float() for x in (wq, wk)), wv.float(), mask, True)
    wide_err = (wide.float() - wref).abs().max().item()
    log(f"[head dims] D={d} {(b, t, h, hkv)} causal, fused-RoPE call: flash launches {flash}, equal to the plain twin "
        f"{torch.equal(out, twin)}, max |card - CPU plain| {err:.3e}; the same call at D=256: K1 launches "
        f"{wide_launches['flash_attention_fwd']}, max |out - f32 twin| {wide_err:.3e}")
    if flash or not torch.equal(out, twin) or err > 2e-2:
        raise AssertionError(f"head_dim routing: flash launches {flash}, err {err}")
    if wide_launches["flash_attention_fwd"] != 1 or sum(wide_launches.values()) != 1 or wide_err > 2e-2:
        raise AssertionError(f"head_dim 256: launches {wide_launches}, err {wide_err}")


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
# the decode's new tokens (the recipe's 200, cut: a random model rarely stops early, so each beam step of the
# phase and of phases 19-20, which repeat it, runs to this length; 12 since phase 20 (b) decodes it over fsdp
# on gloo, ~2-3 s a beam step; 8 since phase 21 joined the run)
SLICE_NEW_TOKENS = 8
RECIPE_CHECK_LAYERS = 2  # LLM and encoder depth of phases 4-6's card-vs-CPU checks (full widths)

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
        "rowquant_absmax": rowquant.rowquant_absmax,
        "rowquant_scaled": rowquant.rowquant_scaled,
        "int8_matmul_s32": quant.int8_matmul_s32,
        "int8_epilogue": quant.int8_epilogue,
        "flash_attention_fwd_wide": flash_attention.flash_attention_fwd_wide,
        "flash_attention_fwd_wide_f32": flash_attention.flash_attention_fwd_wide_f32,
        "flash_attention_bwd_wide": flash_attention.flash_attention_bwd_wide,
        "flash_attention_bwd_wide_f32": flash_attention.flash_attention_bwd_wide_f32,
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
    first utterance against the CPU plain path with the same weights and
    dtype, the model cut to RECIPE_CHECK_LAYERS layers."""
    from slam_llm_tpu_torch.pipeline.common import build_model_and_data, materialize_params
    from slam_llm_tpu_torch.pipeline.inference_batch import decode_loader

    model, _, dataset = build_model_and_data(cfg, split=cfg.dataset_config.test_split, device="cuda")
    materialize_params(model.eval(), cfg)
    small, _ = cut_model(model, cfg, RECIPE_CHECK_LAYERS, "slice")
    del model
    cpu_side = compare_prefill(small.eval(), next(iter(decode_loader(cfg, dataset))), "slice")
    small.to("cpu")
    on_cpu("slice", cpu_side)


def compare_prefill(model, batch, label: str):
    """The prefill logits of ``batch`` on the card (finite), and of its first
    utterance; returns the CPU side, to call once ``model`` is on the CPU:
    the same utterance through the CPU plain path with the same weights and
    dtype, cosine >= 0.99 at every valid position."""
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

    def cpu_side():
        t0 = time.perf_counter()
        cpu, _ = run(model, slice(0, 1), "cpu")
        cpu_s = time.perf_counter() - t0
        g, c = gpu[mask], cpu[mask]  # (valid positions, V)
        cos = torch.nn.functional.cosine_similarity(g, c, dim=-1)
        agree = (g.argmax(-1) == c.argmax(-1)).float().mean().item()
        log(f"[{label}] utterance 0 prefill logits, card vs CPU plain path ({cpu_s:.1f} s on CPU): "
            f"min cosine {cos.min().item():.5f} mean {cos.mean().item():.5f} argmax agreement {agree:.4f} "
            f"max |diff| {(g - c).abs().max().item():.4f}")
        if cos.min().item() < 0.99:
            raise AssertionError(f"prefill logits cosine {cos.min().item()} < 0.99 against the CPU path")

    return cpu_side


def run_slice() -> dict:
    from slam_llm_tpu_torch.pipeline import inference_batch

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    manifest = write_corpus(tmp)
    args = ["--config", str(RECIPE), f"++dataset_config.train_data_path={manifest}",
            f"++dataset_config.val_data_path={manifest}", f"++decode_config.max_new_tokens={SLICE_NEW_TOKENS}"]
    cfg = inference_batch.load_run_config([*args, f"++decode_config.decode_log={tmp / 'decode'}"])
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
    PHASE["decode"] = {"args": args, "pred": res["pred"], "seconds": res["seconds"], "peak_gib": peak / 2**30,
                       "step_ms": 1000 * res["decode_s"] / max(res["decode_steps"], 1)}
    return launches


# ---------------------------------------------------------------------------
# phase 5: the training slice
# ---------------------------------------------------------------------------

TRAIN_STEPS = 8  # the first two are warm-up; step time is the mean of the rest
NO_REMAT_STEPS = 6  # the short run with activation checkpointing off


def _train_args(tmp: Path, steps: int, *extra: str) -> list:
    return [
        "--config", str(RECIPE),
        f"++dataset_config.train_data_path={write_corpus(tmp, n=16 * steps, name='train')}",
        f"++dataset_config.val_data_path={write_corpus(tmp, n=8, seed=1, name='val')}",
        f"++train_config.max_steps_per_epoch={steps}",
        "++train_config.log_interval=1",
        f"++train_config.output_dir={tmp / 'out'}",
        *extra,
    ]


def _train_cfg(tmp: Path, steps: int, *extra: str):
    from slam_llm_tpu_torch.pipeline import finetune

    return finetune.load_run_config(_train_args(tmp, steps, *extra))


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
    b, t = steps[-1]["shape"][0], steps[-1]["shape"][-1]  # (B, T), or S2S's (B, streams, T)
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
    from slam_llm_tpu_torch.pipeline import finetune

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    args = _train_args(tmp, TRAIN_STEPS)
    cfg = finetune.load_run_config(args)
    if not (cfg.train_config.shard.remat and cfg.train_config.shard.remat_policy == "dots_flash_saveable"):
        raise AssertionError("the recipe no longer ships remat with dots_flash_saveable")
    res, launches, remat_on = _finetune(cfg, "train")
    trainer, steps = res["trainer"], res["steps"]
    PHASE["train"] = {"args": args, "steps": steps, "checkpoints": res["checkpoints"],
                      "final_val": res.get("final_val"), **remat_on}
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
    check_train_grads_against_cpu(cut_model(trainer.model, cfg, RECIPE_CHECK_LAYERS, "train")[1], dataset, "train")
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
    check_train_grads_against_cpu(cut_model(trainer2.model, cfg2, RECIPE_CHECK_LAYERS, "modes")[1], dataset, "modes")
    return {k: launches[k] + launches2[k] for k in launches}


@contextlib.contextmanager
def cpu_attention_on_twins():
    """CPU attention that the card runs on K1 / K4 (no dense bias) goes
    through their plain twins (``flash_attention`` on CPU tensors) instead
    of the model's plain attention: K4's twin rounds P and dS to bf16
    before its products, as K4 does, so a CPU gradient carries the
    kernel's own rounding (the leak of a near-uniform attention's dS rows
    into its query / key gradients). Only the thread that entered it sees
    the twins (the CPU sides run beside the phases)."""
    from slam_llm_tpu_torch.models import layers
    from slam_llm_tpu_torch.ops.kernels.flash_attention import flash_attention

    plain, owner = layers._xla_attention, threading.get_ident()

    def twins(q, k, v, bias, kv_mask=None, causal=False):
        if (threading.get_ident() != owner or bias is not None or q.is_cuda
                or (causal and q.shape[1] != k.shape[1])):
            return plain(q, k, v, bias, kv_mask, causal)
        mask = kv_mask.to(torch.int32) if kv_mask is not None else torch.ones(k.shape[:2], dtype=torch.int32)
        return flash_attention(q, k, v, mask, causal)

    layers._xla_attention = twins
    try:
        yield
    finally:
        layers._xla_attention = plain


def redraw_adapters(model) -> None:
    """LoRA B and llama-adapter's gates redrawn nonzero (seeded), so every
    LoRA factor and adapter prompt gets a gradient."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        for mod in model.modules():
            if getattr(mod, "lora_rank", 0):
                mod.lora_b.normal_(0.0, 0.02, generator=gen)
            if hasattr(mod, "adaption_gate"):
                mod.adaption_gate.normal_(0.0, 0.5, generator=gen)


def check_train_grads_against_cpu(trainer, dataset, label: str, key_bias_limit: float = 5e-2) -> None:
    """``train_grads_card`` on ``trainer``'s model (a cut copy, which ends on
    the CPU) with its adapters redrawn; its CPU side queued."""
    redraw_adapters(trainer.model)
    cpu_side = train_grads_card(trainer, dataset, label, key_bias_limit)
    trainer.model.to("cpu")
    on_cpu(label, cpu_side)


def train_grads_card(trainer, dataset, label: str, key_bias_limit: float = 5e-2, gate: str = "",
                     loss_rtol: float = None):
    """The trainable gradients of one utterance on the card; returns the CPU
    side, to call once the model is on the CPU: the same through the CPU
    plain path, the run's backward modes with the same stochastic-rounding
    seeds on both sides, remat as configured, dropout off. Cosine >= 0.99
    for every tensor with a gradient; a key projection's bias (the
    Q-Former's), whose gradient is 0 in exact arithmetic, within
    ``key_bias_limit`` of its query bias's gradient norm on both sides.
    The gate holds the tensors whose names start with ``gate`` (all by
    default); the others' worst is logged. With ``loss_rtol``, the losses
    within it, relative."""
    model = trainer.model
    batch = dataset.collator([dataset[0]])
    names = list(trainer.trainable)
    seeds = trainer.draw_quant_seeds()

    def grads(device):
        """(loss, the gradients of ``names``, the batch's shape); a tensor
        the batch never reaches (a text batch's projector) has None."""
        b = {k: torch.as_tensor(v).to(device) for k, v in batch.items() if isinstance(v, np.ndarray)}
        trainer.set_quant_seeds(seeds)
        model.eval()
        params = dict(model.named_parameters())
        out = model(b)
        g = torch.autograd.grad(out["loss"], [params[n] for n in names], allow_unused=True)
        return (float(out["loss"].detach()), [None if x is None else x.float().cpu() for x in g],
                tuple(b["input_ids"].shape))

    loss_gpu, g_gpu, shape = grads("cuda")
    unreached = [n for n, g in zip(names, g_gpu) if g is None]
    if unreached:
        log(f"[{label}] {len(unreached)} trainable tensors the batch does not reach (no gradient): {unreached[:4]}")

    def cpu_side():
        t0 = time.perf_counter()
        loss_cpu, g_cpu, _ = grads("cpu")
        cpu_s = time.perf_counter() - t0
        if [n for n, g in zip(names, g_cpu) if g is None] != unreached:
            raise AssertionError(f"{label}: the card and the CPU reach different trainable tensors")
        pairs = {n: (a, c) for n, a, c in zip(names, g_gpu, g_cpu) if a is not None}
        # a key projection's bias shifts every score of a query by one constant,
        # which the softmax cancels: its gradient is 0 in exact arithmetic, so
        # both sides are round-off, held against the query bias's gradient
        key_bias = {n: (a.norm().item(), c.norm().item(), pairs[n.replace("k_proj", "q_proj")][1].norm().item())
                    for n, (a, c) in pairs.items() if n.endswith("k_proj.bias")}
        key_bias = {n: (a / q, c / q) for n, (a, c, q) in key_bias.items()}
        cos = {n: torch.nn.functional.cosine_similarity(a.flatten(), c.flatten(), dim=0).item()
               for n, (a, c) in pairs.items() if c.abs().max() > 0 and n not in key_bias}
        worst = min(cos, key=cos.get)
        log(f"[{label}] gradient check, one utterance {shape}, {model.cfg.llm.n_layers} layers, card vs CPU plain "
            f"path ({cpu_s:.1f} s on CPU): loss {loss_gpu:.5f} vs {loss_cpu:.5f}; {len(cos)} of "
            f"{len(pairs) - len(key_bias)} tensors with a gradient, min cosine {cos[worst]:.5f} ({worst}), mean "
            f"{np.mean(list(cos.values())):.5f}" + (f"; {len(key_bias)} key-projection biases (gradient 0 in exact "
                                                   f"arithmetic): largest |g| / |g of the query bias| "
                                                   f"{max(a for a, _ in key_bias.values()):.2e} card, "
                                                   f"{max(c for _, c in key_bias.values()):.2e} CPU (limit "
                                                   f"{key_bias_limit:g})" if key_bias else ""))
        held = [n for n in names if n not in unreached]
        if gate:
            outside = {n: c for n, c in cos.items() if not n.startswith(gate)}
            cos = {n: c for n, c in cos.items() if n.startswith(gate)}
            key_bias = {n: ac for n, ac in key_bias.items() if n.startswith(gate)}
            held = [n for n in held if n.startswith(gate)]
            worst = min(cos, key=cos.get)
            log(f"[{label}] the gate holds the {len(held)} {gate}* tensors: min cosine {cos[worst]:.5f} ({worst}), "
                f"largest key-bias ratio {max((max(ac) for ac in key_bias.values()), default=0.0):.2e}; outside it the "
                f"worst is {min(outside.values()):.5f} ({min(outside, key=outside.get)})")
        worst_key_bias = max((max(ac) for ac in key_bias.values()), default=0.0)
        if len(cos) + len(key_bias) != len(held) or cos[worst] < 0.99 or worst_key_bias > key_bias_limit:
            raise AssertionError(f"gradient check: min cosine {cos[worst]} (< 0.99), zero gradients "
                                 f"({len(held) - len(cos) - len(key_bias)}) or a key bias's gradient above round-off "
                                 f"({worst_key_bias})")
        if loss_rtol is not None and not abs(loss_gpu - loss_cpu) <= loss_rtol * abs(loss_cpu):
            raise AssertionError(f"{label}: loss {loss_gpu} on the card, {loss_cpu} on the CPU")

    return cpu_side


# ---------------------------------------------------------------------------
# phase 7: the weights path
# ---------------------------------------------------------------------------

WEIGHTS_STEPS = 4
WEIGHTS_NEW_TOKENS = 8  # the reload check's decode length (32 until phase 21 joined the run, 16 until phase 22)
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
ST_NEW_TOKENS = 8  # decode length (a random model rarely emits EOS; 32 before phase 21, 16 before phase 22)
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


def check_projector_trained(trainer, cfg, label: str, lora: bool = False, trained=("encoder_projector.",),
                            leaves=()) -> None:
    """Every parameter under the ``trained`` prefixes (the projector by
    default; the encoder's too when it trains), every one named ``leaves``
    last (the PEFT tensors) and, with ``lora``, every LoRA factor is
    trainable, an f32 master, and moved from the seeded init;
    every other tensor of the state dict (encoder and LLM weights, an int8
    base and its scales, norms) is bit-equal to a freshly materialized
    model's, in the dtype the trainer stores it in."""
    from slam_llm_tpu_torch.pipeline.common import build_model_and_data, materialize_params

    fresh, _, _ = build_model_and_data(cfg, split=cfg.dataset_config.train_split, device="cuda")
    materialize_params(fresh, cfg)
    init = fresh.state_dict()
    factors = {n for n in trainer.trainable if n.endswith((".lora_a", ".lora_b"))}
    under = {n for n, _ in trainer.model.named_parameters()
             if n.startswith(trained) or (leaves and n.endswith(tuple(leaves)))}
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
                              key_bias_limit: float = 5e-2, gate: str = "", loss_rtol: float = None,
                              twins: bool = False) -> None:
    """The recipe's trained model cut to ``layers`` LLM and encoder layers
    at its full widths (a 7B f32 model on the host is neither quick nor
    small; a model without an encoder keeps none): the bf16 prefill logits
    of ``prefill_batch``'s first utterance and, with the adapters redrawn,
    every trainable gradient of one utterance of ``train_ds``, card vs CPU
    plain path (the gradient gate on the tensors named ``gate``*, all by
    default; with ``loss_rtol``, the utterance's loss on both within it).
    The CPU side is queued, under ``cpu_attention_on_twins`` with
    ``twins``."""
    small, small_trainer = cut_model(trainer.model, cfg, layers, label)
    prefill_cpu = compare_prefill(small.eval(), prefill_batch, label)
    adapters = [n for n, _ in small.named_parameters() if n.endswith(("lora_b", "adaption_gate"))]
    params = dict(small.named_parameters())
    trained = {n: params[n].detach().cpu().clone() for n in adapters}
    redraw_adapters(small)
    redrawn = {n: params[n].detach().cpu().clone() for n in adapters}
    grads_cpu = train_grads_card(small_trainer, train_ds, label, key_bias_limit, gate, loss_rtol)
    small.to("cpu")

    def cpu_side():
        with cpu_attention_on_twins() if twins else contextlib.nullcontext():
            with torch.no_grad():
                for n, t in trained.items():
                    params[n].copy_(t)
            prefill_cpu()
            with torch.no_grad():
                for n, t in redrawn.items():
                    params[n].copy_(t)
            grads_cpu()

    on_cpu(label, cpu_side)


def cut_model(model, cfg, layers: int, label: str, **llm) -> tuple:
    """``model`` cut to its first ``layers`` LLM and encoder layers at its
    full widths, its tensors copied (a model without an encoder keeps
    none), on the card, the LLM config's fields ``llm`` replaced (a
    backward mode); returns it and a Trainer over it."""
    import dataclasses

    from slam_llm_tpu_torch.models.slam_model import SLAMModel
    from slam_llm_tpu_torch.train.state import Trainer

    big = model.cfg
    small_cfg = dataclasses.replace(big, llm=dataclasses.replace(big.llm, n_layers=layers, **llm),
                                    encoder=big.encoder and dataclasses.replace(big.encoder, n_layers=layers))
    small = SLAMModel(small_cfg, device="cuda")
    trained = model.state_dict()
    with torch.no_grad():
        for n, p in small.state_dict(keep_vars=True).items():
            if n not in trained or trained[n].shape != p.shape:
                raise AssertionError(f"{label}: the cut model's {n} {tuple(p.shape)} is not the recipe's "
                                     f"{tuple(trained[n].shape) if n in trained else 'missing'}")
            p.copy_(trained[n])
    encoder = f"{layers} of {big.encoder.n_layers} encoder layers" if big.encoder else "no encoder"
    log(f"[{label}] card vs CPU at {layers} of {big.llm.n_layers} LLM layers and {encoder} (full widths, the "
        f"recipe's model cut to those layers)")
    return small, Trainer(small, small_cfg, cfg.train_config).state_from_params()


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
W_NEW_TOKENS = 8  # decode length (a random model rarely emits EOS; 32 before phase 21, 16 before phase 22)
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
    bias), never with the bias. Returns the launch counts of the card run;
    the CPU side is queued."""
    import dataclasses

    with torch.no_grad():
        (out, out_mask), launches = run_counted(lambda: enc(*(None if x is None else x.cuda() for x in inputs)))
        cpu = type(enc)(dataclasses.replace(enc.cfg, dtype=torch.float32)).eval()
        cpu.load_state_dict({k: v.float().cpu() for k, v in enc.state_dict().items()})
    out, out_mask = out.float().cpu(), out_mask.cpu()
    k1 = launches[kernel]
    if k1 != (enc.cfg.n_layers if expect_k1 else 0):
        raise AssertionError(f"{label}: {k1} {kernel} launches for {enc.cfg.n_layers} layers (expected: {expect_k1})")
    cfg = enc.cfg

    def cpu_side():
        t0 = time.perf_counter()
        with torch.no_grad():
            ref, ref_mask = cpu(*inputs)
        cpu_s = time.perf_counter() - t0
        live = ref_mask.bool()
        cos = torch.nn.functional.cosine_similarity(out[live], ref[live], dim=-1)
        log(f"{label} ({cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads, rel-pos bias "
            f"{not expect_k1}) on inputs of {[None if x is None else tuple(x.shape) for x in inputs]}, frames "
            f"{live.sum(1).tolist()} of {live.shape[1]}: card {cfg.dtype} vs CPU f32 plain path ({cpu_s:.1f} s on "
            f"CPU): min cosine {cos.min().item():.6f} mean {cos.mean().item():.6f}; {kernel} launches {k1}")
        if not (torch.equal(out_mask, ref_mask) and bool(torch.isfinite(out).all()) and cos.min().item() >= min_cos):
            raise AssertionError(f"{label}: masks equal {torch.equal(out_mask, ref_mask)}, cosine "
                                 f"{cos.min().item()} (limit {min_cos})")

    on_cpu(label, cpu_side)
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
AAC_NEW_TOKENS = 8  # decode length (a random model rarely emits EOS; 32 before phase 21, 16 before phase 22)
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
MS_NEW_TOKENS = 8  # decode length (a random model rarely emits EOS; 32 before phase 21, 16 before phase 22)
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
    check_reduced_against_cpu(trainer, cfg, batches[0], train_ds, label, MS_LAYERS, MS_KEY_BIAS_LIMIT,
                              gate="encoder." if enc_trains else "", loss_rtol=1e-2, twins=True)
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
LS_NEW_TOKENS = 8  # 32 until phase 21 joined the run, 16 until phase 22
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
    check_reduced_against_cpu(trainer, cfg, eval_batch, items, "large_scale", LS_LAYERS, loss_rtol=1e-2)
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
    check_reduced_against_cpu(trainer, cfg, eval_batch, BatcherItems(batcher, 1), label, LS_LAYERS, loss_rtol=1e-2)
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


# ---------------------------------------------------------------------------
# phase 16: S2S (SLAM-Omni)
# ---------------------------------------------------------------------------

S2S_RECIPE = ROOT / "examples" / "s2s" / "conf" / "s2s_qwen.yaml"
S2S_TEXT_VOCAB = 151936  # Qwen2's text vocabulary: the recipe's tokenizer's, set where no tokenizer file is at hand
S2S_PREFILL_T = 362  # a batch utterance: the byte tokenizer's 57-token system prompt, 2 markers, 300 audio slots, 3
S2S_BATCH = 8  # the recipe's batch_size_training
S2S_TRAIN_T = (512, 768, 1024, 1536)  # the recipe's text buckets (phase 3's K1 / K4 rows)
S2S_TRAIN_FRAMES = ((100, 140), (420, 640), (700, 1150))  # answers' codec frames: the 512, 1024 and 1536 buckets
S2S_UTTS = 2  # the serving corpus's questions, of 2 and 12 s
S2S_DECODE_TOKENS = 48  # new tokens of the batch decode (the recipe's 360, cut: ~60-90 ms a step at 28 layers)
S2S_LAYERS = 2  # LLM depth of the training run and the card-vs-CPU checks (full widths)
S2S_CPU_TOKENS = 32  # greedy steps compared card vs CPU
S2S_ROUND_TOKENS = 16  # new tokens of the online rounds
S2S_STREAM_TOKENS = 96  # new tokens of the streaming round (4 chunks of the recipe's stride 24)
S2S_ADAPTER_LAYERS = 2  # the TTS adapter's blocks in its training step (6 by default)
S2S_BYPASSED = (*AAC_BYPASSED, "flash_attention_fwd_f32", "flash_attention_bwd_f32")
# SNAC's card-vs-CPU gate, relative L2: random weights drive ~93 % of the
# samples into tanh's saturation, which amplifies f32 rounding, so a max-abs
# gate would read rounding. Phase 16 on an H100 80GB HBM3 at 700 W reads
# ~2.1e-4 for the f32 decode and ~7.2e-2 for its TF32 control.
SNAC_REL_L2 = 1e-3
SNAC_HOP = 2048  # snac_24khz's samples a 7-token frame: 4 finest codes of 512


def write_s2s_corpus(root: Path, name: str, frames, seconds=(2.0, 4.0), seed: int = 0) -> Path:
    """A jsonl of len(frames) questions (16 kHz tone + noise wavs, evenly
    spread over ``seconds``), each answered by a text and a grouped
    CosyVoice stream of ``frames[i]`` frames of 3 codes."""
    import wave

    rng = np.random.default_rng(seed)
    manifest = root / f"{name}.jsonl"
    with open(manifest, "w") as f:
        for i, nf in enumerate(frames):
            sec = seconds[0] + (seconds[1] - seconds[0]) * i / max(len(frames) - 1, 1)
            t = np.arange(int(sec * 16000)) / 16000
            x = 0.3 * np.sin(2 * np.pi * (180 + 40 * i) * t) + 0.02 * rng.standard_normal(t.size)
            wav = root / f"{name}_{i}.wav"
            with wave.open(str(wav), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes((x * 32767).astype("<i2").tobytes())
            f.write(json.dumps({"key": f"{name}{i}", "source_wav": str(wav), "source_text": f"question number {i}",
                                "target_text": f"this is answer number {i}",
                                "target_token": rng.integers(0, 4096, 3 * int(nf)).tolist()}) + "\n")
    return manifest


def _s2s_config(loader, *extra):
    """The recipe with ``extra`` overrides; the text vocabulary is Qwen2's
    (the recipe factory reads it off the model config, which has no such
    key, so it is set in-process)."""
    cfg = loader(["--config", str(S2S_RECIPE), f"++dataset_config.text_vocabsize={S2S_TEXT_VOCAB}", *extra])
    cfg.model_config.text_vocabsize = S2S_TEXT_VOCAB
    return cfg


@contextlib.contextmanager
def qwen2_layers(n: int, dtype=None):
    """``LLMConfig.qwen2_7b`` cut to ``n`` layers at its full widths (in
    ``dtype`` where given), in-process."""
    import dataclasses

    from slam_llm_tpu_torch.models.llm import LLMConfig

    full = LLMConfig.qwen2_7b
    LLMConfig.qwen2_7b = staticmethod(lambda: dataclasses.replace(
        full(), n_layers=n, **({} if dtype is None else {"dtype": dtype})))
    try:
        yield
    finally:
        LLMConfig.qwen2_7b = staticmethod(full)


def s2s_train_args(train, val) -> tuple:
    """The S2S training runs' overrides: one step in each bucket of the
    written corpus (phases 16, 19 and 20)."""
    return (f"++dataset_config.train_data_path={train}", f"++dataset_config.val_data_path={val}",
            "++train_config.max_steps_per_epoch=3", "++train_config.log_interval=1",
            "++train_config.warmup_steps=1")


def _cosyvoice_samples(frames: int) -> int:
    """HiFT's samples for ``frames`` grouped frames of 3 codes (50 codes a
    second -> 22,050 / 256 mel frames a second -> 256 samples a mel frame)."""
    return int(3 * frames / 50 * 22050 / 256) * 256


def run_s2s_serving(tmp: Path) -> tuple:
    """s2s_qwen.yaml's batch decode at full width through
    ``pipeline.generate_s2s`` (whisper-small, linear ds 5, Qwen2-7B 28
    layers, group decode over code_layer 3, seeded random init; CosyVoice
    flow + HiFT at CosyVoice-300M's widths from written flow.pt / hift.pt),
    then online rounds through ``S2SSession.run_round``. Returns the
    launches and the session."""
    from slam_llm_tpu_torch.pipeline import generate_s2s
    from slam_llm_tpu_torch.tools.synth_checkpoint import write_cosyvoice

    corpus = write_s2s_corpus(tmp, "test", [30] * S2S_UTTS, seconds=(2.0, 12.0))
    t0 = time.perf_counter()
    wrote = write_cosyvoice(str(tmp / "cosyvoice"), seed=0, device="cuda")
    log(f"[s2s] wrote {S2S_UTTS} questions of 2-12 s and CosyVoice-300M-shaped flow.pt + hift.pt ({wrote / 2**20:.0f} "
        f"MiB) in {time.perf_counter() - t0:.2f} s")
    cfg = _s2s_config(generate_s2s.load_run_config, "++decode_config.mode=batch",
                      f"++dataset_config.val_data_path={corpus}", f"++decode_config.decode_log={tmp / 'decode'}",
                      "++model_config.codec_decoder_type=CosyVoice", f"++model_config.codec_decoder_path={tmp / 'cosyvoice'}")
    mc, dc, dec, tc = cfg.model_config, cfg.dataset_config, cfg.decode_config, cfg.train_config
    if (mc.file, mc.llm_name, mc.encoder_config, mc.encoder_projector, mc.encoder_projector_ds_rate, dc.file,
            list(dc.text_buckets), dec.max_new_tokens, dec.do_sample, tc.freeze_llm, tc.batch_size_training) != (
            "examples/s2s/model/slam_model_s2s.py:model_factory", "qwen2-7b", "whisper-small", "linear", 5,
            "slam_llm_tpu.data.s2s_dataset:get_s2s_dataset", list(S2S_TRAIN_T), 360, False, False, S2S_BATCH):
        raise AssertionError(f"the s2s recipe changed: {mc} {dc} {dec} {tc}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    session = generate_s2s.S2SSession(cfg, "cuda")
    build_s = time.perf_counter() - t0
    m = session.model
    v = m.cfg.vocab
    shapes = (v.code_layer, v.total_vocabsize, m.llm.embed_tokens.weight.shape[0], m.llm.lm_head.weight.shape[0],
              m.llm.cfg.n_layers, m.encoder.cfg.n_layers, m.group_decode_adapter is not None)
    log(f"[s2s] session built (model, random init, codec loaded) in {build_s:.2f} s: code_layer, vocab, embedding rows, "
        f"head rows, LLM / encoder layers, group decode {shapes}; {sum(p.numel() for p in m.parameters()) / 1e9:.3f} G "
        f"parameters, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    if shapes != (3, 164480, 164480, 156160, 28, 12, True):
        raise AssertionError(f"s2s model {shapes}")
    session.gen.max_new_tokens = S2S_DECODE_TOKENS
    res, launches = run_counted(lambda: generate_s2s.run_batch(session, cfg))
    peak = torch.cuda.max_memory_allocated()
    for u in res["utterances"]:
        log(f"[s2s] {u['key']}: prompt {u['prompt_len']} tokens, prefill {1000 * u['prefill_s']:.1f} ms, "
            f"{u['decode_steps']} decode steps at {1000 * u['decode_s'] / max(u['decode_steps'], 1):.2f} ms, "
            f"{u['audio_frames']} audio frames, codec {1000 * u['codec_s']:.1f} ms, {u['samples']} samples at 22050 Hz")
    steps = sum(u["decode_steps"] for u in res["utterances"])
    log(f"[s2s] batch decode of {res['n']} utterances in {res['seconds']:.2f} s over {res['audio_seconds']:.2f} s of "
        f"question audio: RTF {res['rtf']:.4f}, {steps} decode steps, {3 * steps / res['seconds']:.1f} audio codes/s; "
        f"peak memory {peak / 2**30:.2f} GiB; launches K1 {launches['flash_attention_fwd']} K4 "
        f"{launches['flash_attention_bwd']} | {SMI}")
    print("\n".join(repr(line) for line in Path(res["pred"]).read_text().splitlines()[:2]))
    wrong = [u for u in res["utterances"] if u["prompt_len"] != S2S_PREFILL_T or u["audio_frames"] <= 8
             or u["samples"] != _cosyvoice_samples(u["audio_frames"])
             or (Path(res["wav_dir"]) / f"{u['key']}.wav").stat().st_size != 44 + 2 * u["samples"]]
    if res["n"] != S2S_UTTS or wrong or launches["flash_attention_fwd"] != S2S_UTTS * (12 + 28) or any(
            launches[k] for k in ("flash_attention_bwd", *AAC_BYPASSED)):
        raise AssertionError(f"s2s batch decode: utterances {wrong}, launches {launches}")

    # online rounds on the same session: a text round, then two wav rounds threading the history
    session.gen.max_new_tokens = S2S_ROUND_TOKENS
    wav = str(tmp / "test_1.wav")

    def rounds():
        out = [session.run_round(text_input="Hello, how is the weather today?")]
        out += [session.run_round(wav_path=wav, keep_history=True) for _ in range(2)]
        return out

    t0 = time.perf_counter()
    out, round_launches = run_counted(rounds)
    log(f"[s2s] online rounds ({S2S_ROUND_TOKENS} new tokens at most) in {time.perf_counter() - t0:.2f} s: texts "
        f"{[len(t) for t, _, _ in out]} characters, audio frames {[s.shape[1] for _, _, s in out]}, samples "
        f"{[None if w is None else len(w) for _, w, _ in out]}; history {session.history[:120]!r}")
    if session.history.count("USER: <audio>") != 2 or any(
            w is None or len(w) != _cosyvoice_samples(s.shape[1]) for _, w, s in out):
        raise AssertionError(f"s2s online rounds: history {session.history!r}")
    session.gen.max_new_tokens = dec.max_new_tokens
    return {k: launches[k] + round_launches[k] for k in launches}, session, cfg


def s2s_tokens_against_cpu(session, cfg) -> None:
    """The served model cut to S2S_LAYERS layers (whisper-small whole), in
    f32 on both sides (the card's K1 f32 route, TF32 off): the first
    S2S_CPU_TOKENS greedy text and audio tokens of utterance 0, with the
    recipe's repetition penalties, equal on the card and the CPU. A check,
    not the recipe's path: its launches are logged and stay out of the
    ``s2s`` path's counts."""
    import dataclasses

    from slam_llm_tpu_torch.models.s2s import S2SGenerator, S2SModel
    from slam_llm_tpu_torch.pipeline.generate_s2s import item_batch

    big = session.model.cfg
    f32 = torch.float32
    small_cfg = dataclasses.replace(big, llm=dataclasses.replace(big.llm, n_layers=S2S_LAYERS, dtype=f32),
                                    encoder=dataclasses.replace(big.encoder, dtype=f32),
                                    projector_cfg=dataclasses.replace(big.projector_cfg, dtype=f32))
    small = S2SModel(small_cfg, device="cuda")
    served = session.model.state_dict()
    with torch.no_grad():
        for n, p in small.state_dict(keep_vars=True).items():
            p.copy_(served[n])
    batch = item_batch(dataset_of(cfg, session.tokenizer, "test")[0])
    dc = cfg.decode_config

    def greedy(model):
        gen = S2SGenerator(model.eval(), max_new_tokens=S2S_CPU_TOKENS, text_repetition_penalty=dc.text_repetition_penalty,
                           audio_repetition_penalty=dc.audio_repetition_penalty)
        return gen.generate(batch)

    card, launches = run_counted(lambda: greedy(small))
    small.to("cpu")

    def cpu_side():
        t0 = time.perf_counter()
        cpu = greedy(small)
        cpu_s = time.perf_counter() - t0
        same = (card == cpu).all(axis=(0, 1))
        log(f"[s2s] card vs CPU at {S2S_LAYERS} of 28 layers, f32: the first {S2S_CPU_TOKENS} greedy text + "
            f"{big.vocab.code_layer} audio tokens equal at every step {bool(same.all())} ({cpu_s:.1f} s on the CPU); "
            f"K1 f32 launches {launches['flash_attention_fwd_f32']}; text {card[0, -1, :12].tolist()}")
        if not same.all():
            raise AssertionError(f"s2s greedy tokens differ from step {int(np.argmin(same))}: {card[0]} vs {cpu[0]}")

    on_cpu("s2s greedy tokens", cpu_side)


def s2s_codecs_against_cpu(session, tmp: Path) -> None:
    """Both vocoders at full width, card vs CPU, f32 with TF32 off on both,
    the noise passed in: CosyVoice (HiFT's deterministic source) sample by
    sample on a short clip (45 codes, 77 mel frames: within 1e-3) and by
    the spectral envelope on a longer one (150 codes, 258 mel frames: HiFT's
    phase is an f32 cumsum over the samples, summed in another order on the
    card; within 0.1 dB); SNAC (snac_24khz from a written file) on 60
    frames, by the relative L2 (within SNAC_REL_L2, which the same decode
    with cuDNN's TF32 on must exceed)."""
    from slam_llm_tpu_torch.models.snac import noise_lengths, snac_decode
    from slam_llm_tpu_torch.tools.synth_checkpoint import write_snac
    from slam_llm_tpu_torch.utils.codec_utils import CodecDecoder, snac_streams_to_codebooks

    card = session.codec
    cpu = CodecDecoder.from_cosyvoice_checkpoint(str(tmp / "cosyvoice" / "flow.pt"), str(tmp / "cosyvoice" / "hift.pt"),
                                                 device="cpu")
    rng = np.random.default_rng(5)
    gen = torch.Generator().manual_seed(5)

    def envelope(w):
        spec = torch.stft(torch.from_numpy(w), 1024, 256, window=torch.hann_window(1024), return_complex=True)
        return 20 * torch.log10(spec.abs().mean(-1) + 1e-5)

    def cosyvoice_side(frames, streams, z, a, card_ms):
        def cpu_side():
            t0 = time.perf_counter()
            b = cpu.decode(streams, z=z, hift_noise=False)
            err = float(np.abs(a - b).max())
            env = float((envelope(a) - envelope(b)).abs().max())
            log(f"[s2s] CosyVoice flow + HiFT, {3 * frames} codes -> {len(a)} samples: card {card_ms:.1f} ms, CPU "
                f"{1000 * (time.perf_counter() - t0):.1f} ms; max |card - CPU| {err:.3e} (rms "
                f"{float(np.sqrt(np.mean(a**2))):.4f}), spectral envelope max diff {env:.4f} dB | {SMI}")
            if len(a) != _cosyvoice_samples(frames) or (err > 1e-3 if frames == 15 else env > 0.1):
                raise AssertionError(f"CosyVoice card vs CPU at {3 * frames} codes: {err} / {env} dB")
        return cpu_side

    for frames in (15, 50):
        streams = rng.integers(0, 4096, (3, frames))
        mel = int(3 * frames / 50 * 22050 / 256)
        z = torch.randn((1, 80, mel), generator=gen)
        t0 = time.perf_counter()
        a = card.decode(streams, z=z.cuda(), hift_noise=False)
        on_cpu(f"CosyVoice at {3 * frames} codes", cosyvoice_side(frames, streams, z, a, 1000 * (time.perf_counter() - t0)))

    path = str(tmp / "snac.pt")
    write_snac(path, seed=3, device="cuda")
    snac_card = CodecDecoder.from_snac_checkpoint(path, device="cuda")
    snac_cpu = CodecDecoder.from_snac_checkpoint(path, device="cpu")
    streams = rng.integers(0, 4096, (7, 60 + 7))
    t_frames = snac_streams_to_codebooks(streams)[-1].shape[1]
    noises = [torch.randn((1, 1, n), generator=gen) for n in noise_lengths(t_frames, snac_card.snac_cfg)]
    snac_card.decode(streams, noises=[n.cuda() for n in noises])  # warm-up
    t0 = time.perf_counter()
    a = snac_card.decode(streams, noises=[n.cuda() for n in noises])
    card_ms = 1000 * (time.perf_counter() - t0)
    b = snac_cpu.decode(streams, noises=noises)
    # the control: the same decode with cuDNN's TF32 on, which the gate must refuse
    cbs = [c % snac_card.snac_cfg.codebook_size for c in snac_streams_to_codebooks(streams)]
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        tf32 = snac_decode(snac_card.snac_params, cbs, snac_card.snac_cfg, [n.cuda() for n in noises])[0].cpu().numpy()
    err, rel = float(np.abs(a - b).max()), float(np.linalg.norm(a - b) / np.linalg.norm(b))
    rel_tf32 = float(np.linalg.norm(tf32 - b) / np.linalg.norm(b))
    log(f"[s2s] SNAC snac_24khz, 60 frames -> {len(a)} samples: card {card_ms:.1f} ms; |card - CPU| max {err:.3e}, "
        f"relative L2 {rel:.3e} (limit {SNAC_REL_L2}; the TF32 control {rel_tf32:.3e}, max "
        f"{float(np.abs(tf32 - b).max()):.3e}; {np.mean(np.abs(b) > 0.99):.3f} of the CPU's samples in tanh's "
        f"saturation) | {SMI}")
    if len(a) != 60 * SNAC_HOP or not rel <= SNAC_REL_L2 < rel_tf32:
        raise AssertionError(f"SNAC card vs CPU: {len(a)} samples, relative L2 {rel}, TF32 control {rel_tf32}")


def run_s2s_stream(tmp: Path) -> dict:
    """``S2SSession.stream_round`` at code_layer 7 with SNAC (snac_24khz,
    the file ``s2s_codecs_against_cpu`` wrote) at S2S_LAYERS LLM layers:
    chunks of the recipe's stride, each decoding its newly complete frames
    against the whole history."""
    from slam_llm_tpu_torch.pipeline import generate_s2s

    cfg = _s2s_config(generate_s2s.load_run_config, "++decode_config.mode=online_stream",
                      "++model_config.codec_decoder_type=SNAC", f"++model_config.codec_decoder_path={tmp / 'snac.pt'}",
                      "++dataset_config.code_layer=7", f"++decode_config.max_new_tokens={S2S_STREAM_TOKENS}")
    cfg.model_config.code_layer = 7
    with qwen2_layers(S2S_LAYERS):
        session = generate_s2s.S2SSession(cfg, "cuda")
    stride = cfg.decode_config.stream_stride
    t0 = time.perf_counter()
    chunks, launches = run_counted(lambda: list(session.stream_round(text_input="Tell me about the weather.",
                                                                    stream_stride=stride)))
    samples = [0 if w is None else len(w) for _, w in chunks]
    steps = session.gen.stats["decode_steps"]
    log(f"[s2s] stream round at code_layer 7, {S2S_LAYERS} layers, stride {stride}: {len(chunks)} chunks in "
        f"{time.perf_counter() - t0:.2f} s, {steps} decode steps, samples a chunk {samples}; launches K1 "
        f"{launches['flash_attention_fwd']}")
    if len(chunks) != -(-steps // stride) or not sum(samples) or any(n % SNAC_HOP for n in samples) or \
            launches["flash_attention_fwd"] != S2S_LAYERS:
        raise AssertionError(f"s2s stream: {len(chunks)} chunks over {steps} steps, samples {samples}, {launches}")
    del session
    return launches


def s2s_trick_step(cfg, label: str, batch_items: range, **flags) -> tuple:
    """Two trainer steps (the first's lr is 0 under warmup) on one
    512-bucket batch with ``flags`` set on the model / train configs."""
    import copy

    from slam_llm_tpu_torch.pipeline.common import build_model_and_data, materialize_params
    from slam_llm_tpu_torch.train.state import Trainer

    cfg = copy.deepcopy(cfg)
    for key, val in flags.items():
        section, name = key.split(".")
        setattr(getattr(cfg, section), name, val)
    model, _, ds = build_model_and_data(cfg, split="train", device="cuda")
    materialize_params(model, cfg)
    trainer = Trainer(model, model.cfg, cfg.train_config).state_from_params()
    before = {n: p.detach().clone() for n, p in trainer.trainable.items()}
    batch = trainer.put_batch(ds.collator([ds[i] for i in batch_items]))
    t0 = time.perf_counter()
    metrics, launches = run_counted(lambda: [trainer.train_step(batch) for _ in range(2)])
    log(f"[s2s] {label}: 2 steps of {tuple(batch['input_ids'].shape)} in {time.perf_counter() - t0:.2f} s, losses "
        f"{[round(float(m['loss']), 5) for m in metrics]}; {len(trainer.trainable)} trainable tensors; launches K1 "
        f"{launches['flash_attention_fwd']} K4 {launches['flash_attention_bwd']}")
    return trainer, before, launches


def run_s2s_training(tmp: Path) -> dict:
    """The recipe's training through ``pipeline.finetune`` at S2S_LAYERS
    layers of Qwen2-7B (its widths, whole whisper-small frozen, batch 8):
    one step in each of the 512, 1024 and 1536 buckets, the validation, the
    checkpoint of every trained tensor (model.pt) read back; the loss card
    vs CPU; then two steps each with the TTS adapter and with
    ``train_audio_embed_only`` (over the full-vocabulary head: group
    decode's narrow head takes no mask, as in the JAX package)."""
    from slam_llm_tpu_torch.data.tokenizer import load_tokenizer
    from slam_llm_tpu_torch.pipeline import finetune
    from slam_llm_tpu_torch.utils.checkpoint import load_trainable

    frames = [int(lo + (hi - lo) * i / (S2S_BATCH - 1)) for lo, hi in S2S_TRAIN_FRAMES for i in range(S2S_BATCH)]
    train = write_s2s_corpus(tmp, "train", frames, seed=1)
    val = write_s2s_corpus(tmp, "val", [30] * 4, seed=2)
    args = s2s_train_args
    cfg = _s2s_config(finetune.load_run_config, *args(train, val), f"++train_config.output_dir={tmp / 'out'}")
    with qwen2_layers(S2S_LAYERS):
        res, launches, stats = _finetune(cfg, "s2s")
        trainer = res["trainer"]
        PHASE["s2s"] = {"args": args, "steps": res["steps"], "final_val": res.get("final_val")}
        buckets = sorted(s["shape"][2] for s in res["steps"])
        per_step = {"flash_attention_fwd": 12 + S2S_LAYERS, "flash_attention_bwd": S2S_LAYERS}
        want = {"flash_attention_fwd": 4 * per_step["flash_attention_fwd"], "flash_attention_bwd": 3 * S2S_LAYERS}
        log(f"[s2s] training: buckets {buckets}, launches K1 {launches['flash_attention_fwd']} K4 "
            f"{launches['flash_attention_bwd']} (3 steps of {per_step} and one validation batch) | {SMI}")
        if buckets != [512, 1024, 1536] or any(s["shape"][:2] != (S2S_BATCH, 4) for s in res["steps"]) or \
                {k: launches[k] for k in want} != want or any(launches[k] for k in AAC_BYPASSED):
            raise AssertionError(f"s2s training: steps {res['steps']}, launches {launches}")
        check_projector_trained(trainer, cfg, "s2s", trained=("encoder_projector.", "llm.", "group_decode_adapter."))
        ckpt = Path(res["checkpoints"][-1]) / "model.pt"
        t0 = time.perf_counter()
        saved = load_trainable(str(ckpt))
        same = set(saved) == set(trainer.trainable) and all(
            torch.equal(saved[n], p.detach().cpu()) for n, p in trainer.trainable.items())
        log(f"[s2s] model.pt: {ckpt.stat().st_size / 2**30:.2f} GiB, {len(saved)} tensors (embedding "
            f"{tuple(saved['llm.embed_tokens.weight'].shape)}, head {tuple(saved['llm.lm_head.weight'].shape)}), read "
            f"back in {time.perf_counter() - t0:.2f} s, equal to the trained tensors {same}")
        if not same:
            raise AssertionError("s2s: model.pt does not hold the trained tensors")
        del saved

        # the loss of one 512-bucket utterance, card vs the CPU plain path
        ds = dataset_of(cfg, load_tokenizer(cfg.model_config.llm_path), "train")
        one = ds.collator([ds[0]])
        model = trainer.model.eval()
        with torch.no_grad():
            loss_gpu = float(model(trainer.put_batch(one))["loss"])
        del trainer, res
        model.to("cpu")
        torch.cuda.empty_cache()

        def cpu_side():
            t0 = time.perf_counter()
            with torch.no_grad():
                loss_cpu = float(model({k: torch.as_tensor(x) for k, x in one.items() if isinstance(x, np.ndarray)})
                                 ["loss"])
            log(f"[s2s] loss of one {tuple(one['input_ids'].shape)} utterance at {S2S_LAYERS} layers: card "
                f"{loss_gpu:.6f}, CPU {loss_cpu:.6f} ({time.perf_counter() - t0:.1f} s on the CPU), relative "
                f"{abs(loss_gpu - loss_cpu) / loss_cpu:.2e}")
            if not abs(loss_gpu - loss_cpu) <= 1e-2 * abs(loss_cpu):
                raise AssertionError(f"s2s loss: card {loss_gpu}, CPU {loss_cpu}")

        on_cpu("s2s loss", cpu_side)

        tts, before, tts_launches = s2s_trick_step(cfg, "TTS adapter", range(S2S_BATCH), **{
            "model_config.tts_adapter": True, "model_config.tts_adapter_layers": S2S_ADAPTER_LAYERS})
        adapter = [n for n in tts.trainable if n.startswith(("tts_adapter_", "tts_adapter_ln", "tts_adapter_head"))]
        unmoved = [n for n in adapter if torch.equal(tts.trainable[n], before[n])]
        per = {"flash_attention_fwd": 2 * (12 + S2S_LAYERS + S2S_ADAPTER_LAYERS),
               "flash_attention_bwd": 2 * (S2S_LAYERS + S2S_ADAPTER_LAYERS)}
        if len(adapter) < S2S_ADAPTER_LAYERS * 9 or unmoved or {k: tts_launches[k] for k in per} != per:
            raise AssertionError(f"s2s TTS adapter step: {len(adapter)} adapter tensors, unmoved {unmoved[:3]}, "
                                 f"launches {tts_launches}")
        del tts, before
        torch.cuda.empty_cache()

        emb, before, emb_launches = s2s_trick_step(cfg, "train_audio_embed_only (full-vocabulary head)",
                                                   range(S2S_BATCH), **{"train_config.train_audio_embed_only": True,
                                                                        "model_config.group_decode": False})
        head = emb.trainable["llm.lm_head.weight"]
        ptv = emb.model.cfg.vocab.padded_text_vocabsize
        text_same = torch.equal(head[:ptv], before["llm.lm_head.weight"][:ptv])
        audio_moved = not torch.equal(head[ptv:], before["llm.lm_head.weight"][ptv:])
        log(f"[s2s] train_audio_embed_only: trainable {list(emb.trainable)}, head {tuple(head.shape)}: text rows "
            f"[0, {ptv}) unchanged {text_same}, audio rows moved {audio_moved}")
        if list(emb.trainable) != ["llm.lm_head.weight"] or head.shape[0] != 164480 or not text_same or \
                not audio_moved or emb_launches["flash_attention_bwd"]:
            raise AssertionError(f"s2s train_audio_embed_only: {list(emb.trainable)} {emb_launches}")
        del emb, before, head
        torch.cuda.empty_cache()
    return {k: launches[k] + tts_launches[k] + emb_launches[k] for k in launches}


def run_s2s() -> dict:
    """Phase 16: s2s_qwen.yaml (SLAM-Omni) serving at full width
    (``run_s2s_serving``), the card against the CPU
    (``s2s_tokens_against_cpu``, ``s2s_codecs_against_cpu``), streaming
    (``run_s2s_stream``) and training at reduced depth
    (``run_s2s_training``)."""
    import shutil

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_s2s_"))
    launches, session, cfg = run_s2s_serving(tmp)
    s2s_tokens_against_cpu(session, cfg)
    s2s_codecs_against_cpu(session, tmp)
    del session
    torch.cuda.empty_cache()
    got = run_s2s_stream(tmp)
    launches = {k: launches[k] + got[k] for k in launches}
    torch.cuda.empty_cache()
    got = run_s2s_training(tmp)
    launches = {k: launches[k] + got[k] for k in launches}
    shutil.rmtree(tmp)
    if any(launches[k] for k in S2S_BYPASSED):  # the recipe serves and trains in bf16, with no int8 base
        raise AssertionError(f"the s2s path launched {', '.join(k for k in S2S_BYPASSED if launches[k])}")
    log(f"[s2s] phase 16 in {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 17: VALL-E X (vallex_tts.yaml: AR + NAR codec transformers, EnCodec-24kHz)
# ---------------------------------------------------------------------------

VX_RECIPE = ROOT / "examples" / "vallex" / "conf" / "vallex_tts.yaml"
VX_BATCH = 16  # the recipe's batch_size_training
VX_TT = 64  # the text bucket of the corpus: 40-64 phoneme ids
VX_TA = (512, 1024)  # the audio buckets trained
VX_FRAMES = {512: (300, 512), 1024: (600, 1024)}  # the corpus's codec frames in each bucket (a full row included)
VX_STEPS = {512: 5, 1024: 3}  # training steps in each bucket (step time: the mean from the third on)
VX_PROMPT_FRAMES = 225  # the enrolled prompt: 3 s at 75 frames a second
VX_MAX_NEW = 75  # 1 s of new frames at most
VX_PROMPT_TEXT = "the quick brown fox jumps over "  # 31 characters: the ord fallback's ids
VX_TARGET_TEXT = "a lazy dog rests in the warm sun."  # 33: 64 ids in all
VX_DECODE_T = len(VX_PROMPT_TEXT) + len(VX_TARGET_TEXT) + VX_PROMPT_FRAMES + VX_MAX_NEW  # the AR step's T: 364
VX_LAYERS = 2  # AR and NAR depth of the card-vs-CPU checks (base_24l's widths)
VX_CPU_NEW = 12  # greedy AR steps compared card vs CPU
VX_CPU_PROMPT = 40  # their prompt's frames
VX_BYPASSED = (*AAC_BYPASSED, "flash_attention_fwd_f32", "flash_attention_bwd_f32")  # bf16, no int8 base
ENCODEC_FRAMES = 150  # 2 s of codes decoded card vs CPU
# the f32 decode's gate, which the same decode with cuDNN's TF32 on must exceed: TF32 reads 7.9e-4
# here (the f32 decode 1.2e-6; NVIDIA H100 80GB HBM3), under the 1e-3 that SNAC's gate uses
ENCODEC_REL_L2 = 1e-5
VX_SYNTH_SEEDS = (0, 1)  # one synthesis a seed; the first also warms the card up
# the other families split over tp (phase 20 (b)): a rank's heads at the recipes' shapes, tp = 2 (and 4 for
# VALL-E X, whose four-card runs take it): (name, B, T, H, Hkv, D, causal, padding, fused RoPE's theta or 0)
TP_FAMILY_K1_CASES = [
    *(case for tp in (2, 4) for case in (
        (f"VALL-E X AR training at tp={tp}, causal, text-padding hole", VX_BATCH, VX_TT + VX_TA[0] + 1, 16 // tp,
         16 // tp, 64, True, f"hole{VX_TT}", 0),
        (f"VALL-E X NAR training at tp={tp}, text-padding hole", VX_BATCH, VX_TT + VX_TA[0], 16 // tp, 16 // tp, 64,
         False, f"hole{VX_TT}", 0))),
    ("Q-Former self-attn, 64 queries, training batch at tp=2", 16, 64, 6, 6, 64, False, "none", 0),
    ("EAT-base encoder, training batch at tp=2", 16, AAC_ENC_T, 6, 6, 64, False, "none", 0),
    ("emotion2vec-base encoder, training batch at tp=2, right-padded", 16, W_ENC_T, 6, 6, 64, False, "right", 0),
    ("MusicFM-MSD encoder, training batch at tp=2, right-padded", 16, MC_ENC_T, 8, 8, 64, False, "right", 0),
    ("AV-HuBERT-large encoder at tp=2, right-padded", VSR_BATCH, VSR_FRAMES[-1], 8, 8, 64, False, "right", 0),
    ("hubert-large encoder at tp=2, right-padded", 2, W_ENC_T, 8, 8, 64, False, "right", 0),
]
TP_FAMILY_K4_CASES = [c for c in TP_FAMILY_K1_CASES if c[0].startswith(("VALL-E X", "Q-Former"))]  # what trains
# Spatial-AST-base split at tp=2 (f32: K1 / K4's f32 routes): (name, B, T, H, Hkv, D, causal, padding)
TP_FAMILY_F32_CASES = [("Spatial-AST-base encoder, training batch at tp=2", 16, SA_T, 6, 6, 64, False, "none")]


def _vx_config(tmp: Path, bucket: int, steps: int, *extra):
    from slam_llm_tpu_torch.pipeline import finetune
    from slam_llm_tpu_torch.tools.synth_checkpoint import write_vallex_corpus

    train = write_vallex_corpus(str(tmp / f"train{bucket}.jsonl"), VX_BATCH * steps, frames=VX_FRAMES[bucket],
                                text_len=(40, VX_TT), seed=bucket)
    val = write_vallex_corpus(str(tmp / f"val{bucket}.jsonl"), VX_BATCH, frames=VX_FRAMES[bucket],
                              text_len=(40, VX_TT), seed=bucket + 1)
    return finetune.load_run_config([
        "--config", str(VX_RECIPE), f"++dataset_config.train_data_path={train}",
        f"++dataset_config.val_data_path={val}", "++dataset_config.code_layer=8",
        f"++train_config.max_steps_per_epoch={steps}", "++train_config.log_interval=1",
        f"++train_config.val_batch_size={VX_BATCH}",
        f"++train_config.output_dir={tmp / f'out{bucket}'}", *extra])


def _vx_cut(model, dtype=None, layers: int = VX_LAYERS):
    """The trained VALLE cut to ``layers`` AR and NAR layers at its widths
    (``dtype`` its compute dtype, the model's by default), on the card."""
    import dataclasses

    from slam_llm_tpu_torch.models.vallex import VALLE

    cfg = dataclasses.replace(model.cfg, ar_layers=layers, nar_layers=layers, dtype=dtype or model.cfg.dtype)
    small = VALLE(cfg, device="cuda")
    trained = model.state_dict()
    with torch.no_grad():
        for n, p in small.state_dict(keep_vars=True).items():
            p.copy_(trained[n])
    return small


def vallex_grads_against_cpu(model, dataset) -> None:
    """The trained VALLE cut to VX_LAYERS + VX_LAYERS layers, bf16: the loss and
    every gradient of two utterances of different lengths (a hole in the key
    rows) at NAR stages 7 and 5, card (K1 / K4) vs the CPU's plain path: the
    loss within 1e-2 relative, every gradient's cosine >= 0.99 (the key
    projections' biases, whose gradient is 0 in exact arithmetic, logged
    against the query biases'; the codebooks no stage reads, 0 on both
    sides). A check: its launches stay out of the ``vallex`` path."""
    small = _vx_cut(model)
    batch = dataset.collator([dataset[0], dataset[len(dataset) - 1]])
    batch["nar_stage"] = np.array([7, 5], np.int32)
    names = [n for n, _ in small.named_parameters()]

    def grads(device):
        b = {k: torch.as_tensor(v).to(device) for k, v in batch.items() if isinstance(v, np.ndarray)}
        params = [p.requires_grad_(True) for p in small.parameters()]
        out = small(b)
        g = torch.autograd.grad(out["loss"], params)
        return float(out["loss"].detach()), {n: x.float().cpu() for n, x in zip(names, g)}

    (loss_gpu, g_gpu), launches = run_counted(lambda: grads("cuda"))
    small.to("cpu")
    t0 = time.perf_counter()
    loss_cpu, g_cpu = grads("cpu")
    cpu_s = time.perf_counter() - t0
    key = {n: max(g_gpu[n].norm().item(), g_cpu[n].norm().item()) / g_cpu[n.replace("k_proj", "q_proj")].norm().item()
           for n in names if n.endswith("k_proj.bias")}
    unread = [n for n in names if not g_cpu[n].any() and not g_gpu[n].any()]
    cos = {n: torch.nn.functional.cosine_similarity(g_gpu[n].flatten(), g_cpu[n].flatten(), dim=0).item()
           for n in names if n not in key and n not in unread}
    worst = min(cos, key=cos.get)
    rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    log(f"[vallex] card vs CPU at {VX_LAYERS} + {VX_LAYERS} layers of base_24l, bf16, two utterances "
        f"{tuple(batch['text_ids'].shape)} + {tuple(batch['audio_ids'].shape)} ({cpu_s:.1f} s on the CPU): loss "
        f"{loss_gpu:.6f} vs {loss_cpu:.6f} (relative {rel:.2e}); {len(cos)} gradients, min cosine {cos[worst]:.5f} "
        f"({worst}), mean {np.mean(list(cos.values())):.5f}; {len(key)} key biases (0 in exact arithmetic): largest "
        f"|g| / |g of the query bias| {max(key.values()):.2e}; 0 on both sides: {unread}; K1 {launches['flash_attention_fwd']} K4 "
        f"{launches['flash_attention_bwd']} on the card (a check, not the path)")
    if (rel > 1e-2 or cos[worst] < 0.99 or max(key.values()) > 5e-2 or unread != ["audio_embedding_7.weight"]
            or launches["flash_attention_bwd"] != 2 * VX_LAYERS):
        raise AssertionError(f"vallex card vs CPU: loss {loss_gpu} / {loss_cpu}, min cosine {cos[worst]} ({worst})")
    del small


def vallex_tokens_against_cpu(model) -> None:
    """The trained VALLE cut to VX_LAYERS + VX_LAYERS layers in f32 (K1's f32
    route on the card, TF32 off): ``synthesize``'s greedy codes (top_k 1,
    VX_CPU_NEW AR steps, then the NAR over every codebook) equal on the card
    and the CPU. A check: its launches stay out of the ``vallex`` path."""
    from slam_llm_tpu_torch.pipeline.inference_vallex import synthesize, text_to_ids

    small = _vx_cut(model, torch.float32).eval()
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, 1024, (8, VX_CPU_PROMPT))
    args = (text_to_ids(VX_PROMPT_TEXT, None, 512), text_to_ids(VX_TARGET_TEXT, None, 512), prompt)

    def run():
        # a random model rarely emits end-of-audio: a row that did would end the compare early
        return synthesize(small, *args, max_new=VX_CPU_NEW, top_k=1)

    (card, n_card), launches = run_counted(run)
    small.to("cpu")
    cpu, n_cpu = run()
    same = n_card == n_cpu and np.array_equal(card, cpu)
    log(f"[vallex] card vs CPU at {VX_LAYERS} + {VX_LAYERS} layers in f32: greedy codes of {n_card} / {n_cpu} frames x "
        f"8 codebooks equal {same}; K1 f32 {launches['flash_attention_fwd_f32']} launches (a check, not the path); "
        f"codebook 0 {card[0, :8].tolist()}")
    if not same or launches["flash_attention_fwd_f32"] == 0:
        raise AssertionError(f"vallex greedy codes differ card vs CPU: {card} vs {cpu}")
    del small


def encodec_against_cpu(path: str) -> None:
    """EnCodec-24kHz from ``path`` (write_encodec's), ENCODEC_FRAMES frames
    of 8 codebooks, card vs CPU, f32 with cuDNN's TF32 off on both: the
    relative L2 within ENCODEC_REL_L2, which the same decode on the card
    with cuDNN's TF32 on (the control) must exceed."""
    from slam_llm_tpu_torch.models.encodec import (EncodecConfig, decoder_apply, encodec_decode,
                                                   load_encodec_checkpoint, rvq_decode)
    from slam_llm_tpu_torch.ops.torch_port import to_device

    cfg = EncodecConfig.encodec_24khz()
    host = load_encodec_checkpoint(path, cfg)
    card = to_device(host, "cuda")
    codes = np.random.default_rng(4).integers(0, cfg.codebook_size, (1, 8, ENCODEC_FRAMES))
    encodec_decode(card, codes, cfg)  # warm-up
    t0 = time.perf_counter()
    a = encodec_decode(card, codes, cfg)
    card_ms = 1000 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    b = encodec_decode(to_device(host, "cpu"), codes, cfg)
    cpu_ms = 1000 * (time.perf_counter() - t0)
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        c = torch.as_tensor(codes, device="cuda")
        tf32 = decoder_apply(card, rvq_decode(card, c), cfg)[:, 0].cpu().numpy()
    rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    rel_tf32 = float(np.linalg.norm(tf32 - b) / np.linalg.norm(b))
    log(f"[vallex] EnCodec-24kHz, {ENCODEC_FRAMES} frames x 8 codebooks -> {a.shape[1]} samples: card {card_ms:.1f} ms, "
        f"CPU {cpu_ms:.1f} ms; |card - CPU| max {float(np.abs(a - b).max()):.3e}, relative L2 {rel:.3e} (limit "
        f"{ENCODEC_REL_L2}; the TF32 control {rel_tf32:.3e}); rms {float(np.sqrt(np.mean(b ** 2))):.4f} | {SMI}")
    if a.shape != (1, ENCODEC_FRAMES * 320) or not rel <= ENCODEC_REL_L2 < rel_tf32:
        raise AssertionError(f"EnCodec card vs CPU: {a.shape}, relative L2 {rel}, TF32 control {rel_tf32}")


def run_vallex() -> dict:
    """Phase 17: vallex_tts.yaml at full width (base_24l: 24 AR + 24 NAR
    layers, d 1024, 16 heads, 8 codebooks, seeded random init; every tensor
    trains in f32 masters) through pipeline.finetune on synthetic 8-codebook
    corpora in the 512 and 1024 audio buckets (text bucket 64, so the key
    rows hold the text's padding as a hole): step ms, peak, K1 = K4 = 48 a
    step, model.pt read back; the card vs the CPU at 2 + 2 layers;
    pipeline.inference_vallex.main with the trained checkpoint and a random
    EnCodec-24kHz from tools/synth_checkpoint.write_encodec (a 3 s prompt,
    4 s at most of new frames): AR ms a step, NAR ms, codec ms, RTF, the
    wav; greedy codes card vs CPU in f32 at 2 + 2 layers; EnCodec card vs
    CPU. Returns the launches of the path (the two trainings and the
    synthesis)."""
    import shutil
    import wave

    from slam_llm_tpu_torch.data.tokenizer import load_tokenizer
    from slam_llm_tpu_torch.pipeline import inference_vallex
    from slam_llm_tpu_torch.tools.synth_checkpoint import write_encodec
    from slam_llm_tpu_torch.utils.checkpoint import load_trainable

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_vallex_"))
    launches = None
    for bucket in VX_TA:
        steps = VX_STEPS[bucket]
        extra = () if bucket == VX_TA[0] else ("++train_config.run_validation=false", "++train_config.save_model=false")
        cfg = _vx_config(tmp, bucket, steps, *extra)
        tc = cfg.train_config
        if (cfg.model_config.llm_name, cfg.dataset_config.dataset, tc.batch_size_training, tc.freeze_llm, tc.lr) != (
                "vallex", "vallex_dataset", VX_BATCH, False, 5e-5):
            raise AssertionError(f"the vallex recipe changed: {cfg.model_config} {cfg.dataset_config} {tc}")
        res, got, stats = _finetune(cfg, f"vallex {bucket}")
        trainer = res["trainer"]
        c = trainer.model.cfg
        ds = dataset_of(cfg, load_tokenizer(cfg.model_config.llm_path), "train")
        shapes = {(b["text_ids"].shape, b["audio_ids"].shape) for b in (ds.collator([ds[i] for i in range(j, j + VX_BATCH)])
                                                                         for j in range(0, len(ds), VX_BATCH))}
        layers = c.ar_layers + c.nar_layers
        val_batches = 1 if tc.run_validation else 0
        want = {"flash_attention_fwd": layers * (steps + val_batches), "flash_attention_bwd": layers * steps}
        n_params = sum(p.numel() for p in trainer.trainable.values())
        log(f"[vallex {bucket}] base_24l: {c.ar_layers} AR + {c.nar_layers} NAR layers, d {c.d_model}, {c.n_heads} "
            f"heads, {c.n_codebooks} codebooks, {n_params / 1e9:.3f} G parameters all trained (f32 masters); batches "
            f"{sorted(shapes)}; step {stats['step_ms']:.1f} ms, {VX_BATCH / stats['step_ms'] * 1000:.1f} utt/s, peak "
            f"{stats['peak_gib']:.2f} GiB; launches K1 {got['flash_attention_fwd']} K4 {got['flash_attention_bwd']} "
            f"(want {want}) | {SMI}")
        if (shapes != {((VX_BATCH, VX_TT), (VX_BATCH, 8, bucket))} or len(res["steps"]) != steps
                or {k: got[k] for k in want} != want or any(got[k] for k in VX_BYPASSED)
                or set(trainer.trainable) != {n for n, _ in trainer.model.named_parameters()}):
            raise AssertionError(f"vallex {bucket}: batches {shapes}, steps {len(res['steps'])}, launches {got}")
        launches = got if launches is None else {k: launches[k] + got[k] for k in launches}
        if bucket == VX_TA[0]:
            ckpt = res["checkpoints"][-1]
            t0 = time.perf_counter()
            saved = load_trainable(ckpt)
            same = set(saved) == set(trainer.trainable) and all(
                torch.equal(saved[n], p.detach().cpu()) for n, p in trainer.trainable.items())
            log(f"[vallex] model.pt: {(Path(ckpt) / 'model.pt').stat().st_size / 2**30:.2f} GiB, {len(saved)} tensors, "
                f"read back in {time.perf_counter() - t0:.2f} s, equal to the trained tensors {same}; validation "
                f"{res.get('final_val')}")
            if not same:
                raise AssertionError("vallex: model.pt does not hold the trained tensors")
            del saved
            trainer.model.eval()
            vallex_grads_against_cpu(trainer.model, ds)
            trained = trainer.model
        del res, trainer
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    size = write_encodec(str(tmp / "encodec"), seed=0, device="cuda")
    prompt = np.random.default_rng(8).integers(0, 1024, (8, VX_PROMPT_FRAMES))
    np.save(tmp / "prompt.npy", prompt)
    log(f"[vallex] wrote a random EnCodec-24kHz model.safetensors ({size / 2**20:.1f} MiB) and a {VX_PROMPT_FRAMES}-frame "
        f"8-codebook prompt in {time.perf_counter() - t0:.2f} s")
    totals = {"ar_s": 0.0, "nar_s": 0.0, "codec_s": 0.0, "audio_seconds": 0.0}
    for seed in VX_SYNTH_SEEDS:
        argv = ["--ckpt_path", ckpt, "--llm_name", "vallex", "--codec_path", str(tmp / "encodec" / "model.safetensors"),
                "--prompt_text", VX_PROMPT_TEXT, "--prompt_codes", str(tmp / "prompt.npy"), "--target_text",
                VX_TARGET_TEXT, "--save_path", str(tmp / f"tts{seed}.wav"), "--max_new", str(VX_MAX_NEW), "--seed",
                str(seed), "--device", "cuda"]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, got = run_counted(lambda: inference_vallex.main(argv))
        wall = time.perf_counter() - t0
        with wave.open(out["path"], "rb") as f:
            pcm = np.frombuffer(f.readframes(f.getnframes()), np.int16)
        compute = out["ar_s"] + out["nar_s"] + out["codec_s"]
        want = {"flash_attention_fwd": 24 * out["ar_steps"] + 24 * 7}
        log(f"[vallex] inference_vallex.main, seed {seed}: {out['frames']} frames ({out['audio_seconds']:.2f} s, "
            f"{len(pcm)} samples at 24 kHz, rms {float(np.sqrt(np.mean((pcm / 32767.0) ** 2))):.4f}); AR "
            f"{1000 * out['ar_s'] / out['ar_steps']:.2f} ms a step over {out['ar_steps']} steps at T {VX_DECODE_T} "
            f"({out['ar_s']:.2f} s), NAR {1000 * out['nar_s']:.1f} ms (7 stages), codec {1000 * out['codec_s']:.1f} "
            f"ms; RTF {compute / out['audio_seconds']:.4f} (wall {wall:.2f} s with the model load); peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches K1 {got['flash_attention_fwd']} (want "
            f"{want['flash_attention_fwd']}) | {SMI}")
        if (len(pcm) != out["frames"] * 320 or not np.abs(pcm).max() > 0
                or got["flash_attention_fwd"] != want["flash_attention_fwd"] or any(got[k] for k in VX_BYPASSED)):
            raise AssertionError(f"vallex synthesis: {out}, launches {got}")
        if seed != VX_SYNTH_SEEDS[0]:
            totals = {k: totals[k] + out[k] for k in totals}
        launches = {k: launches[k] + got[k] for k in launches}
    log(f"[vallex] synthesis after the first: {totals['audio_seconds']:.2f} s of audio, AR {totals['ar_s']:.2f} s, NAR "
        f"{totals['nar_s']:.2f} s, codec {totals['codec_s']:.2f} s: RTF "
        f"{(totals['ar_s'] + totals['nar_s'] + totals['codec_s']) / totals['audio_seconds']:.4f} | {SMI}")
    vallex_tokens_against_cpu(trained)
    encodec_against_cpu(str(tmp / "encodec" / "model.safetensors"))
    del trained
    torch.cuda.empty_cache()
    shutil.rmtree(tmp)
    log(f"[vallex] phase 17 in {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 18: prefix-tuning and llama-adapter on the ASR recipe
# ---------------------------------------------------------------------------

PEFT_STEPS = 4
PEFT_DECODE = 8  # utterances decoded, one batch (the recipe's val_batch_size)
PEFT_NEW_TOKENS = 8  # 32 until phase 21 joined the run, 16 until phase 22
# peft_method -> the LLM's trained leaves
PEFT_METHODS = {"prefix": ("prefix_k", "prefix_v"), "llama_adapter": ("adaption_prompt", "adaption_gate")}


def run_peft() -> dict:
    """Phase 18: asr_whisper_tinyllama.yaml at full width (whisper-small,
    TinyLlama-1.1B int8 base with the int8_rot backward, the recipe's remat)
    with ++train_config.peft_config.peft_method=prefix, then llama_adapter:
    pipeline.finetune for PEFT_STEPS steps of 16 (the projector and the new
    leaves move, everything else stays), pipeline.inference_batch with the
    checkpoint (beam 4, PEFT_DECODE utterances) against the in-memory
    decode, and the card vs the CPU at 2 + 2 layers (the gate on the new
    leaves' gradients); first the recipe's own LoRA for PEFT_STEPS steps, the
    step time to compare with in this process (not on the path). Prefix-tuning's LLM attention is the plain path
    (end-aligned causal over the prefix slots): only the encoder launches
    K1, and nothing K4. Returns the launches of both methods' runs."""
    import shutil

    from slam_llm_tpu_torch.data.tokenizer import load_tokenizer
    from slam_llm_tpu_torch.pipeline import inference_batch
    from slam_llm_tpu_torch.pipeline.inference_batch import decode_loader
    from slam_llm_tpu_torch.utils.checkpoint import load_trainable

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_lora_"))
    _, _, lora = _finetune(_train_cfg(tmp, PEFT_STEPS, "++train_config.run_validation=false",
                                      "++train_config.save_model=false"), "peft: lora, the recipe as shipped")
    shutil.rmtree(tmp)
    log(f"[peft] the recipe's LoRA in this process, for reference: step {lora['step_ms']:.1f} ms, peak "
        f"{lora['peak_gib']:.2f} GiB (not on the peft path)")
    total = None
    for method, leaves in PEFT_METHODS.items():
        tmp = Path(tempfile.mkdtemp(prefix=f"chip_smoke_{method}_"))
        label = f"peft {method}"
        cfg = _train_cfg(tmp, PEFT_STEPS, f"++train_config.peft_config.peft_method={method}")
        res, launches, stats = _finetune(cfg, label)
        trainer = res["trainer"]
        llm = trainer.model.cfg.llm
        log(f"[{label}] TinyLlama-1.1B {llm.peft_method}: {llm.prefix_len or llm.adapter_len} "
            f"{'key / value slots' if llm.prefix_len else 'prompt tokens'} a layer, lora rank {llm.lora_rank}; step "
            f"{stats['step_ms']:.1f} ms, peak {stats['peak_gib']:.2f} GiB; per step K1 "
            f"{launches['flash_attention_fwd'] / PEFT_STEPS:.1f} K4 {launches['flash_attention_bwd'] / PEFT_STEPS:.1f} "
            f"K2 {launches['rowquant'] / PEFT_STEPS:.1f} | {SMI}")
        check_projector_trained(trainer, cfg, label, leaves=leaves)
        ckpt = res["checkpoints"][-1]
        saved = load_trainable(ckpt)
        if set(saved) != set(trainer.trainable) or not all(torch.equal(saved[n], p.detach().cpu())
                                                            for n, p in trainer.trainable.items()):
            raise AssertionError(f"{label}: model.pt differs from the trained tensors")
        dec = inference_batch.load_run_config([
            "--config", str(RECIPE), f"++ckpt_path={ckpt}", "++train_config.use_peft=true",
            f"++train_config.peft_config.peft_method={method}",
            f"++dataset_config.val_data_path={write_corpus(tmp, n=PEFT_DECODE, seed=2, name='test')}",
            f"++decode_config.decode_log={tmp / 'decode'}", f"++decode_config.max_new_tokens={PEFT_NEW_TOKENS}"])
        out, dec_launches = run_counted(lambda: inference_batch.main(dec, device="cuda"))
        with open(out["pred"], encoding="utf-8", newline="") as f:
            text = f.read()
        tokenizer = load_tokenizer(cfg.model_config.llm_path)
        mine = decode_texts(trainer.model, tokenizer, dec)
        log(f"[{label}] inference_batch with ckpt_path: {out['n']} utterances, beam {dec.decode_config.num_beams}, "
            f"{PEFT_NEW_TOKENS} new tokens at most: prefill {1000 * out['prefill_s'] / out['calls']:.1f} ms/batch, "
            f"{1000 * out['decode_s'] / max(out['decode_steps'], 1):.2f} ms/beam step over {out['decode_steps']} steps, "
            f"RTF {out['rtf']:.4f}; equal to the in-memory decode {text == ''.join(f'{x}{chr(10)}' for x in mine)}; "
            f"launches K1 {dec_launches['flash_attention_fwd']} K4 {dec_launches['flash_attention_bwd']}")
        if out["n"] != PEFT_DECODE or text != "".join(f"{line}\n" for line in mine):
            raise AssertionError(f"{label}: the reloaded model's decode differs from the in-memory trained model's")
        runs = {k: launches[k] + dec_launches[k] for k in launches}
        enc = trainer.model.cfg.encoder.n_layers
        forwards = PEFT_STEPS + 1 + out["calls"]  # the steps, the validation batch, the decode's prefills
        want = ({"flash_attention_fwd": enc * forwards, "flash_attention_bwd": 0} if llm.prefix_len else
                {"flash_attention_fwd": (enc + llm.n_layers) * forwards, "flash_attention_bwd": llm.n_layers * PEFT_STEPS})
        if {k: runs[k] for k in want} != want or not runs["rowquant"] or not runs["int8_matmul"]:
            raise AssertionError(f"{label}: launches {runs}, want {want}")
        test = dataset_of(dec, tokenizer, dec.dataset_config.test_split)
        check_reduced_against_cpu(trainer, cfg, next(iter(decode_loader(dec, test))),
                                  dataset_of(cfg, tokenizer, cfg.dataset_config.train_split), label, gate="llm.")
        total = runs if total is None else {k: total[k] + runs[k] for k in total}
        del res, trainer
        torch.cuda.empty_cache()
        shutil.rmtree(tmp)
    log(f"[peft] phase 18 in {time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# phase 19: the (dp, fsdp) mesh under torchrun
# ---------------------------------------------------------------------------

# what phases 4, 5 and 16 leave for phase 19 to hold its runs against
PHASE = {}
DIST_LAUNCH_TIMEOUT_S = 300  # the torchrun launch of phase 19, kernels loaded from phase 2's build
DIST_PATH = ("flash_attention_fwd", "flash_attention_bwd", "rowquant", "rowquant_rot_sr", "int8_matmul")
DIST_RTOL = 1e-6  # phase 19 against phases 5 and 16, relative


def _torchrun(nproc: int, job: dict, tmp: Path, timeout: float = DIST_LAUNCH_TIMEOUT_S, env=None,
              root: Path = ROOT) -> dict:
    """``python -m torch.distributed.run --standalone --nproc_per_node=nproc
    chip_smoke.py --distributed-job <job>``, the users' launch, with a
    timeout (and ``env`` added to the children's environment); a non-zero
    exit fails the phase. ``root``: the checkout whose ``chip_smoke.py`` and
    package run (another tree's, for an A/B in one call). Returns rank 0's
    results."""
    job = dict(job, out=str(tmp / f"result_{nproc}.json"))
    path = tmp / f"job_{nproc}.json"
    path.write_text(json.dumps(job))
    script = Path(__file__).resolve() if root == ROOT else Path(root).resolve() / "chip_smoke.py"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={nproc}",
           str(script), "--distributed-job", str(path)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=timeout,
                          env=None if env is None else {**os.environ, **env})
    (tmp / f"torchrun_{nproc}.log").write_text(proc.stdout + proc.stderr)
    for line in proc.stdout.splitlines():
        if line.startswith("[dist"):
            log(line)
    log(f"[distributed] torchrun --nproc_per_node={nproc}: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s")
    if proc.returncode != 0:
        raise AssertionError(f"torchrun --nproc_per_node={nproc} failed ({proc.returncode}):\n"
                             f"{(proc.stdout + proc.stderr)[-6000:]}")
    return json.loads(Path(job["out"]).read_text())


def _plain_param_check():
    """Forward pre-hooks, installed on every module with parameters of its
    own once the trainer has sharded the model, recording any parameter a
    module computes with that is a DTensor or not contiguous: the kernels'
    wrappers must get FSDP2's unsharded plain tensors. They check a run's
    first training step (its forward and the backward's replays) and are
    removed after it, so the timed steps (3 on) carry none."""
    from torch.distributed.tensor import DTensor

    from slam_llm_tpu_torch.train.state import Trainer

    bad, seen, handles = [], [0], []
    original, original_step = Trainer.state_from_params, Trainer.train_step

    def hook(mod, args):
        for name, p in mod.named_parameters(recurse=False):
            seen[0] += 1
            if isinstance(p, DTensor) or not p.is_contiguous():
                bad.append(f"{type(mod).__name__}.{name}")

    def state_from_params(self):
        out = original(self)
        for mod in self.model.modules():
            if any(True for _ in mod.parameters(recurse=False)):
                handles.append(mod.register_forward_pre_hook(hook))
        return out

    def train_step(self, batch):
        try:
            return original_step(self, batch)
        finally:
            for h in handles:
                h.remove()
            handles.clear()

    Trainer.state_from_params, Trainer.train_step = state_from_params, train_step
    _decode_param_check(hook)
    return bad, seen


def _decode_param_check(hook) -> None:
    """``hook`` installed, for the whole decode, on every module with
    parameters of its own of a model that a generator binds under FSDP2
    (the sharded decodes: ``inference.generate.Generator`` and
    ``models.s2s.S2SGenerator``)."""
    from torch.distributed.fsdp import FSDPModule

    from slam_llm_tpu_torch.inference.generate import Generator
    from slam_llm_tpu_torch.models.s2s import S2SGenerator

    for cls in (Generator, S2SGenerator):
        original = cls.__init__

        def init(self, model, *args, _original=original, **kwargs):
            _original(self, model, *args, **kwargs)
            if isinstance(model, FSDPModule):
                for mod in model.modules():
                    if any(True for _ in mod.parameters(recurse=False)):
                        mod.register_forward_pre_hook(hook)

        cls.__init__ = init


@contextlib.contextmanager
def decode_memory(record: dict):
    """Inside, a generator's construction (once the entry point has built,
    filled and sharded the model) records the card's resident GiB, the
    peak so far (the build's) and the largest whole parameter's f32 GiB
    into ``record``, then resets the peak counter: the peak read after the
    run is the decode's own."""
    from slam_llm_tpu_torch.inference.generate import Generator
    from slam_llm_tpu_torch.models.s2s import S2SGenerator

    originals = {cls: cls.__init__ for cls in (Generator, S2SGenerator)}

    def wrap(init):
        def init_and_record(self, model, *args, **kwargs):
            init(self, model, *args, **kwargs)
            # a DTensor's numel is its whole tensor's over FSDP
            record.update(resident_gib=torch.cuda.memory_allocated() / 2**30,
                          build_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                          largest_f32_gib=max(p.numel() for p in model.parameters()) * 4 / 2**30)
            torch.cuda.reset_peak_memory_stats()
        return init_and_record

    for cls, init in originals.items():
        cls.__init__ = wrap(init)
    try:
        yield record
    finally:
        for cls, init in originals.items():
            cls.__init__ = init


def _all_ranks(info: dict) -> list:
    """Every rank's ``info``, in rank order (a collective of every rank)."""
    import torch.distributed as dist

    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, info)
    return got


def _step_peaks() -> dict:
    """``{"steps": [...], "between": [...]}``: each ``Trainer.train_step``
    of this process appends its peak device memory (GiB) to ``steps``, the
    peak counter reset before the step, and the peak since the last reset
    (the build, validation) to ``between``."""
    from slam_llm_tpu_torch.train.state import Trainer

    peaks, original = {"steps": [], "between": []}, Trainer.train_step

    def train_step(self, batch):
        peaks["between"].append(torch.cuda.max_memory_allocated() / 2**30)
        torch.cuda.reset_peak_memory_stats()
        try:
            return original(self, batch)
        finally:
            torch.cuda.synchronize()
            peaks["steps"].append(torch.cuda.max_memory_allocated() / 2**30)

    Trainer.train_step = train_step
    return peaks


# phase 20 (b)'s gap check: the bf16 whisper-small encoder and linear projector at tp=2 against the same
# modules whole differ by summation order only (a few bf16 roundings, relative); a wrong split or a bias
# added twice moves the outputs by about their own size
TP_GAP_RTOL = 2.0 ** -5


def tp_gap(device: str) -> dict:
    """Phase 20 (b), on each rank: asr_whisper_tinyllama.yaml's whisper-small
    encoder and linear projector (bf16, random weights from seed 0) on 8
    random 30 s mels, whole and then split at tp=2 (this rank's shards):
    the split modules' outputs against the whole ones'. No kernel count is
    read here."""
    from slam_llm_tpu_torch.models import projector as tproj
    from slam_llm_tpu_torch.models import whisper as twhisper
    from slam_llm_tpu_torch.parallel.sharding import make_mesh
    from slam_llm_tpu_torch.parallel.tensor_parallel import split_projector, split_whisper, tp_of
    from slam_llm_tpu_torch.pipeline.common import init_params_

    ecfg = twhisper.WhisperEncoderConfig.small()
    pcfg = tproj.ProjectorConfig(encoder_dim=ecfg.d_model, llm_dim=2048, ds_rate=5, hidden_dim=2048)
    enc, proj = twhisper.WhisperEncoder(ecfg, device), tproj.build_projector("linear", pcfg, device)
    gen = torch.Generator(device=device).manual_seed(0)
    init_params_(enc, gen)
    init_params_(proj, gen)
    mel = torch.randn((8, 3000, ecfg.n_mels), generator=gen, device=device)
    mask = torch.ones((8, 3000), dtype=torch.int32, device=device)
    tp = tp_of(make_mesh(dp=1, fsdp=1, tp=2, device_type=torch.device(device).type))

    def run():
        e = enc(mel, mask)[0]
        return e, proj(e)

    def gap(a, b):
        d = (a.float() - b.float())
        return {"max_abs": float(d.abs().max()), "rel": float(torch.linalg.norm(d) / torch.linalg.norm(b.float())),
                "differ": float((a != b).float().mean()), "scale": float(b.float().abs().max())}

    with torch.no_grad():
        whole = run()
        split_whisper(enc, tp)
        split_projector(proj, tp)
        split = run()
    return {"encoder": gap(split[0], whole[0]), "projector": gap(split[1], whole[1]),
            "shape": [list(whole[0].shape), list(whole[1].shape)], "heads": enc.layers[0].attn.n_heads}


def distributed_job(path: str) -> None:
    """One torchrun rank of phase 19: the jobs of ``path`` in turn, each
    through the entry points with the launch counts set to 0 just before
    and read just after; rank 0 writes the results."""
    import torch.distributed as dist

    from slam_llm_tpu_torch.parallel import tensor_parallel
    from slam_llm_tpu_torch.pipeline import finetune, generate_s2s, inference_batch
    from slam_llm_tpu_torch.pipeline.common import maybe_init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    job = json.loads(Path(path).read_text())
    device = "cuda"
    if job.get("backend") == "gloo":  # phase 20 (b): every rank on the one card, gloo between them
        device = "cuda:0"
        torch.cuda.set_device(0)
        torch.zeros(1, device=device)  # the context is up: DeviceMesh keeps this device, not LOCAL_RANK's
        dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=DIST_LAUNCH_TIMEOUT_S))
    if not maybe_init_distributed(device):
        raise RuntimeError("phase 19's job runs under torchrun")
    rank, world = dist.get_rank(), dist.get_world_size()
    if "family" in job:  # phase 20 (b)'s family runs read phase 20's synthetic tokenizer
        global _synth_tokenizer_dir
        _synth_tokenizer_dir = job["family"]["tokenizer_dir"]
    bad, seen = _plain_param_check()
    notes = []  # the split and sharding the entry points log (rank 0's, each once)

    class Notes(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if msg.startswith(("tensor parallel tp=", "sharded decode")) and msg not in notes:
                notes.append(msg)

    logging.getLogger("slam_llm_tpu_torch").addHandler(Notes())
    step_peaks = _step_peaks()
    out = {"world": world, "backend": dist.get_backend(), "launches": {}, "device": torch.cuda.current_device()}

    def train(key: str, cfg):
        torch.cuda.reset_peak_memory_stats()
        tensor_parallel.reset_largest_gather()
        for v in step_peaks.values():
            v.clear()
        t0 = time.perf_counter()
        res, launches = run_counted(lambda: finetune.main(cfg, device=device))
        peak = max([torch.cuda.max_memory_allocated() / 2**30, *step_peaks["steps"], *step_peaks["between"]])
        out[key] = {"steps": [{k: v for k, v in s.items()} for s in res["steps"]],
                    "checkpoints": res["checkpoints"], "final_val": res.get("final_val"),
                    "base_bytes": res["base_bytes"], "peak_gib": peak, "wall_s": time.perf_counter() - t0,
                    "launches": launches, "step_peak_gib": list(step_peaks["steps"]),
                    "largest_gather": tensor_parallel.LARGEST_GATHER["shape"]}
        return launches

    for name in job["run"]:
        t0 = time.perf_counter()
        if name == "probe":  # phase 20 (b): each run goes only where gloo runs its collectives
            out["probe"] = gloo_probe()
            continue
        if "probe" in out and not probe_allows(out["probe"], name):
            continue
        if name == "tp_gap":
            out["tp_gap"] = tp_gap(device)
            continue
        if name == "asr":
            cfg = finetune.load_run_config(job["asr_args"])
            launches = train("asr", cfg)
        elif name == "s2s":
            cfg = _s2s_config(finetune.load_run_config, *job["s2s_args"])
            with qwen2_layers(job.get("s2s_layers", S2S_LAYERS)):
                launches = train("s2s", cfg)
        elif name == "s2s_decode":  # phase 20 (b): generate_s2s's batch mode, its LLM in f32
            cfg = _s2s_config(generate_s2s.load_run_config, *job["s2s_decode_args"])
            with qwen2_layers(S2S_LAYERS, torch.float32):
                res, launches = run_counted(lambda: generate_s2s.main(cfg, device=device))
            out["s2s_decode"] = {"pred": res["pred"], "n": res["n"], "seconds": res["seconds"],
                                 "steps": sum(u["decode_steps"] for u in res["utterances"])}
        elif name.startswith("family_"):  # phase 20 (b): a family's recipe at tp=2 (run_tp_families)
            kind = name[len("family_"):]
            torch.cuda.reset_peak_memory_stats()
            res, launches = family_run(kind, job["family"], Path(job["family_dir"]), device,
                                       ("++train_config.shard.tp=2",))
            out[name] = ({"pred": res["pred"], "n": res["n"], "seconds": res["seconds"]} if kind == "sec" else
                         {"steps": [dict(s) for s in res["steps"]],
                          "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
        elif name == "fsdp_decode":  # inference_batch sharded over fsdp: each rank's steps and its own last
            cfg = inference_batch.load_run_config(job["fsdp_decode_args"])
            torch.cuda.reset_peak_memory_stats()
            with decode_memory({}) as mem:
                res, launches = run_counted(lambda: inference_batch.main(cfg, device=device))
            out["fsdp_decode"] = {"ranks": _all_ranks({
                "pred": res["pred"], "n": res["n"], "seconds": res["seconds"], "steps": res["decode_steps"],
                "useful": res["useful_steps"], "step_ms": 1000 * res["decode_s"] / max(res["decode_steps"], 1),
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30, **mem})}
        elif name == "fsdp_s2s_decode":  # generate_s2s batch mode sharded over fsdp
            cfg = _s2s_config(generate_s2s.load_run_config, *job["fsdp_s2s_decode_args"])
            dtype = {"float32": torch.float32}.get(job.get("s2s_dtype"))
            torch.cuda.reset_peak_memory_stats()
            with qwen2_layers(job.get("s2s_layers", S2S_LAYERS), dtype), decode_memory({}) as mem:
                res, launches = run_counted(lambda: generate_s2s.main(cfg, device=device))
            out["fsdp_s2s_decode"] = {"ranks": _all_ranks({
                "pred": res["pred"], "n": res["n"], "seconds": res["seconds"],
                "steps": [(u["key"], u["decode_steps"], u["useful_steps"]) for u in res["utterances"]],
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30, **mem})}
        else:
            cfg = inference_batch.load_run_config(job["decode_args"])
            res, launches = run_counted(lambda: inference_batch.main(cfg, device=device))
            out["decode"] = {"pred": res["pred"], "n": res["n"], "seconds": res["seconds"]}
        for k, v in launches.items():
            out["launches"][k] = out["launches"].get(k, 0) + v
        out.setdefault("launches_by_run", {})[name] = {k: v for k, v in launches.items() if v}
        if rank == 0:
            print(f"[distributed rank 0/{world}] {name} in {time.perf_counter() - t0:.1f} s, launches "
                  f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    out["plain_params"] = {"checked": seen[0], "dtensor_or_strided": sorted(set(bad))}
    out["notes"] = notes
    if rank == 0:
        Path(job["out"]).write_text(json.dumps(out))
    dist.destroy_process_group()


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _same_run(label: str, got: dict, want: dict, rtol: float, norm_rtol: float = None) -> bool:
    """Phase 19's steps against another run's: losses within ``rtol``
    relative, grad norms within ``norm_rtol`` (``rtol`` by default); True
    where every one is bit-equal."""
    gates = {"loss": rtol, "grad_norm": rtol if norm_rtol is None else norm_rtol}
    diffs = {k: [_rel(g[k], w[k]) for g, w in zip(got["steps"], want["steps"])] for k in gates}
    if len(got["steps"]) != len(want["steps"]) or any(max(diffs[k]) > gates[k] for k in gates):
        raise AssertionError(f"{label}: steps {got['steps']} against {want['steps']}")
    exact = all(g[k] == w[k] for g, w in zip(got["steps"], want["steps"]) for k in gates)
    log(f"[distributed] {label}: {len(got['steps'])} steps, losses {[round(s['loss'], 6) for s in got['steps']]}, "
        f"largest relative difference loss {max(diffs['loss']):.2e} / grad norm {max(diffs['grad_norm']):.2e} "
        f"(gates {gates['loss']:g} / {gates['grad_norm']:g}), bit-equal {exact}")
    return exact


def run_multi_card(one: dict, args: list, tmp: Path) -> None:
    """The ASR run of phase 19 (a) on two cards at ``fsdp=2`` and, with four,
    at ``fsdp=4`` and ``(dp=2, fsdp=2)``, each against (a): the losses within
    one bf16 rounding (a rank's GEMMs see fewer rows), the grad norms within
    1e-2 (each rank's stochastic rounding draws its own noise); a rank's
    step ms, peak and bytes of the int8 base."""
    meshes = [(2, ("++train_config.shard.fsdp=2",))]
    if torch.cuda.device_count() >= 4:
        meshes += [(4, ("++train_config.shard.fsdp=4",)),
                   (4, ("++train_config.shard.dp=2", "++train_config.shard.fsdp=2"))]
    timed = one["steps"][2:]
    one_ms = 1000 * float(np.mean([s["seconds"] for s in timed]))
    for i, (nproc, extra) in enumerate(meshes):
        got = _torchrun(nproc, {"run": ["asr"], "asr_args": [*args, f"++train_config.output_dir={tmp / f'cards_{i}'}",
                                                             *extra]}, tmp)
        label = f"{nproc} cards {' '.join(e.split('.')[-1] for e in extra)}"
        _same_run(f"{label} vs (a)", got["asr"], one, 2.0 ** -8, 1e-2)
        asr = got["asr"]
        step_ms = 1000 * float(np.mean([s["seconds"] for s in asr["steps"][2:]]))
        log(f"[distributed] {label}: step {step_ms:.1f} ms vs (a)'s {one_ms:.1f} ms on one card, rank 0's peak "
            f"{asr['peak_gib']:.2f} GiB vs {one['peak_gib']:.2f}, int8 base {asr['base_bytes'] / 2**20:.1f} MiB a "
            f"rank vs {one['base_bytes'] / 2**20:.1f} | {SMI}")


def run_distributed() -> dict:
    """Phase 19: the sharded path (FSDP2 over the ``(dp, fsdp)`` mesh, NCCL)
    through torchrun at world size 1, which runs every line of it: (a) the
    ASR recipe as phase 5 runs it, its losses, grad norms and model.pt
    against phase 5's; (b) S2S at 2 layers of Qwen2-7B's widths with the
    whole LLM trained, against phase 16's steps; (c) the batch decode,
    line for line against phase 4's. With two or more cards, an ``fsdp=2``
    run of (a) against (a)."""
    from slam_llm_tpu_torch.utils.checkpoint import load_trainable

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_"))
    torch.cuda.empty_cache()
    train, s2s, decode = PHASE["train"], PHASE["s2s"], PHASE["decode"]
    frames = [int(lo + (hi - lo) * i / (S2S_BATCH - 1)) for lo, hi in S2S_TRAIN_FRAMES for i in range(S2S_BATCH)]
    s2s_train = write_s2s_corpus(tmp, "train", frames, seed=1)
    s2s_val = write_s2s_corpus(tmp, "val", [30] * 4, seed=2)
    job = {
        "run": ["asr", "s2s", "decode"],
        "asr_args": [*train["args"], f"++train_config.output_dir={tmp / 'asr'}"],
        "s2s_args": [*s2s["args"](s2s_train, s2s_val), f"++train_config.output_dir={tmp / 's2s'}",
                     "++train_config.save_model=false"],
        "decode_args": [*decode["args"], f"++decode_config.decode_log={tmp / 'decode'}"],
    }
    got = _torchrun(1, job, tmp)
    if got["world"] != 1 or got["backend"] != "nccl":
        raise AssertionError(f"phase 19 ran on {got['world']} ranks over {got['backend']}")
    if got["plain_params"]["dtensor_or_strided"] or not got["plain_params"]["checked"]:
        raise AssertionError(f"kernel inputs: {got['plain_params']}")
    log(f"[distributed] every module computed with FSDP2's unsharded plain, contiguous parameters "
        f"({got['plain_params']['checked']} parameter reads checked)")

    # (a) the ASR recipe against phase 5
    asr = got["asr"]
    exact = _same_run("(a) asr_whisper_tinyllama, 8 steps of 16, NCCL world 1 vs phase 5", asr, train, DIST_RTOL)
    mine = load_trainable(str(Path(asr["checkpoints"][-1]) / "model.pt"))
    ref = load_trainable(str(Path(train["checkpoints"][-1]) / "model.pt"))
    worst = max(float((mine[n] - w).norm() / w.norm().clamp_min(1e-30)) for n, w in ref.items())
    same = set(mine) == set(ref) and all(torch.equal(mine[n], w) for n, w in ref.items())
    log(f"[distributed] (a) model.pt: {len(mine)} whole tensors, largest relative difference {worst:.2e} against "
        f"phase 5's, bit-equal {same}; validation {asr['final_val']} vs {train['final_val']}")
    if set(mine) != set(ref) or worst > DIST_RTOL or any(mine[n].shape != w.shape for n, w in ref.items()):
        raise AssertionError("(a): model.pt differs from phase 5's")
    timed = asr["steps"][2:]
    step_ms = 1000 * float(np.mean([s["seconds"] for s in timed]))
    log(f"[distributed] (a) step ms {[round(1000 * s['seconds'], 1) for s in asr['steps']]} vs phase 5's "
        f"{[round(1000 * s['seconds'], 1) for s in train['steps']]}")
    log(f"[distributed] (a) world size 1 under FSDP2: step {step_ms:.1f} ms vs phase 5's {train['step_ms']:.1f} ms "
        f"({step_ms / train['step_ms'] - 1:+.1%}), peak {asr['peak_gib']:.2f} GiB vs phase 5's run "
        f"{train['peak_gib']:.2f} GiB; int8 base {asr['base_bytes'] / 2**20:.1f} MiB on the rank; "
        f"bit-equal steps {exact} | {SMI}")

    # (b) S2S at 2 layers against phase 16
    _same_run(f"(b) s2s_qwen at {S2S_LAYERS} layers, whole LLM trained, vs phase 16", got["s2s"], s2s, DIST_RTOL)
    PHASE["s2s_dist"] = got["s2s"]  # phase 20 (b) holds its tp=2 steps against these
    s2s_ms = [round(1000 * s["seconds"], 1) for s in got["s2s"]["steps"]]
    log(f"[distributed] (b) step ms {s2s_ms} vs phase 16's {[round(1000 * s['seconds'], 1) for s in s2s['steps']]}, "
        f"peak {got['s2s']['peak_gib']:.2f} GiB | {SMI}")

    # (c) the decode against phase 4
    lines, want = Path(got["decode"]["pred"]).read_text().splitlines(), Path(decode["pred"]).read_text().splitlines()
    log(f"[distributed] (c) inference_batch under torchrun: {len(lines)} lines, equal to phase 4's {lines == want}; "
        f"decode loop {got['decode']['seconds']:.2f} s vs phase 4's {decode['seconds']:.2f} s")
    if lines != want:
        raise AssertionError("(c): the decode under torchrun differs from phase 4's")

    launches = got["launches"]
    missing = [k for k in DIST_PATH if not launches.get(k)]
    if missing:
        raise AssertionError(f"kernels never launched on the distributed path: {missing}")

    if torch.cuda.device_count() >= 2:
        run_multi_card(asr, train["args"], tmp)
    else:
        log(f"[distributed] the two-card fsdp=2 run was not run: this machine has {torch.cuda.device_count()} card "
            "(NCCL refuses two ranks on one device)")
    import shutil

    shutil.rmtree(tmp)
    log(f"[distributed] phase 19 in {time.perf_counter() - t_phase:.1f} s")
    return {k: launches.get(k, 0) for k in kernel_counters()}


# ---------------------------------------------------------------------------
# phase 20: tensor parallelism
# ---------------------------------------------------------------------------

# the kernels a tp=2 step of the ASR recipe runs: K2's row-split passes for
# the row-parallel forward and the column-parallel int8_rot dx (q, gate / up
# hold whole rotation blocks a rank; k / v gather dy and take K2's rotation),
# K3's s32 mode and epilogue for every product that crosses ranks
TP_PATH = ("flash_attention_fwd", "flash_attention_bwd", "rowquant", "rowquant_rot_sr", "rowquant_absmax",
           "rowquant_scaled", "int8_matmul", "int8_matmul_s32", "int8_epilogue")
TP_LOSS_RTOL, TP_NORM_RTOL = 2.0 ** -8, 1e-2  # a tp run against one card's: one bf16 rounding; the grad norm
TP_LAUNCH_TIMEOUT_S = 480  # phase 20's torchrun (b): two ranks through gloo on one card
# (b)'s cut: gloo stages every collective through the host (~13 s a step of 16, ~0.25 s a beam step), so it
# runs phase 5's first step and phase 4's first batch of 8
TP_GLOO_STEPS, TP_GLOO_UTTS = 1, 8
# (b)'s S2S cut: phase 19 (b)'s first step (its corpus; the 1536 bucket comes first), and generate_s2s on
# 2 questions of 4 new tokens (8 until phase 21 joined the run): at tp=2 with the LLM in f32 (a greedy token flips only where the two runs'
# logits round apart, which bf16's rounding of the logits, 2^-5 at their largest, would make likely), and at
# fsdp=2 in the recipe's bf16 (FSDP2 gathers exact copies; a step gathers the 2 layers through the host)
TP_S2S_STEPS, TP_S2S_QUESTIONS, TP_S2S_NEW = 1, 2, 4


# the all-gathers FSDP2 runs in a sharded decode here: a unit whose tensors share
# one dtype gathers in it (whisper's blocks bf16, S2S's f32 LLM), a unit of mixed
# dtypes as bytes (uint8: the int8 base's one-byte carriers with their f32 scales)
FSDP_GATHER_DTYPES = (torch.bfloat16, torch.float32, torch.uint8)


def gloo_probe() -> dict:
    """Whether this process group (gloo) runs the collectives tensor
    parallelism needs on CUDA tensors: all_reduce SUM / MAX of f32, int32
    and int64, and all_gather; and those of a sharded decode:
    all_gather_into_tensor of ``FSDP_GATHER_DTYPES`` and of the int8 base's
    carrier dtype (which FSDP2 gathers inside a uint8 buffer here); each
    checked against its expected value, or the error it raised."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    got = {}
    for dt in (torch.float32, torch.int32, torch.int64):
        for op, want in (("SUM", sum(range(1, world + 1))), ("MAX", world)):
            t = torch.full((1024,), rank + 1, dtype=dt, device="cuda")
            try:
                dist.all_reduce(t, op=getattr(dist.ReduceOp, op))
                got[f"all_reduce {op} {str(dt).split('.')[-1]}"] = bool((t == want).all().item())
            except Exception as e:  # the answer is the error
                got[f"all_reduce {op} {str(dt).split('.')[-1]}"] = f"{type(e).__name__}: {e}"[:200]
    try:
        parts = [torch.empty(16, device="cuda") for _ in range(world)]
        dist.all_gather(parts, torch.full((16,), float(rank), device="cuda"))
        got["all_gather f32"] = all(bool((p == r).all().item()) for r, p in enumerate(parts))
    except Exception as e:
        got["all_gather f32"] = f"{type(e).__name__}: {e}"[:200]
    from slam_llm_tpu_torch.parallel.sharding import INT8_CARRIER

    for dt in (*FSDP_GATHER_DTYPES, INT8_CARRIER):
        key = f"all_gather_into_tensor {str(dt).split('.')[-1]}"
        try:
            part = torch.full((16,), rank + 1, dtype=torch.float32, device="cuda").to(dt)
            whole = torch.empty(16 * world, dtype=dt, device="cuda")
            dist.all_gather_into_tensor(whole, part)
            got[key] = bool((whole.float().reshape(world, 16) == torch.arange(1, world + 1, device="cuda")[:, None])
                            .all().item())
        except Exception as e:
            got[key] = f"{type(e).__name__}: {e}"[:200]
    return got


def probe_allows(probe: dict, run: str) -> bool:
    """Whether the gloo probe's answers let ``run`` go: the sharded decodes
    need FSDP2's all-gathers, the tp runs every tp collective."""
    if run.startswith("fsdp_"):
        return all(probe.get(f"all_gather_into_tensor {str(dt).split('.')[-1]}") is True
                   for dt in FSDP_GATHER_DTYPES)
    return all(v is True for k, v in probe.items() if not k.startswith("all_gather_into_tensor"))


def run_tensor_parallel() -> dict:
    """Phase 20: tensor parallelism (every family split Megatron-style over
    ``shard.tp``). The per-rank kernel rows ran in phase 3. (b) Whether
    gloo runs the tp collectives on CUDA tensors; if it does, two torchrun
    ranks on this one card (gloo): the ASR recipe through
    ``pipeline.finetune`` at ``shard.tp=2``, TP_GLOO_STEPS steps of 16
    against phase 5's (losses and grad norms within ``TP_LOSS_RTOL`` /
    ``TP_NORM_RTOL``), ``pipeline.inference_batch`` at tp=2 line for line
    against phase 4, S2S's steps and decode (``run_s2s_gloo``) and the other
    families (``run_tp_families``).
    (c) With two or more cards (NCCL), the ASR recipe at tp=2, and with
    four at tp=4 and fsdp=2 x tp=2 and ``s2s_qwen.yaml`` at Qwen2-7B's full
    28 layers at tp=4 and fsdp=2 x tp=2."""
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tp_"))
    torch.cuda.empty_cache()
    train, decode = PHASE["train"], PHASE["decode"]
    launches = {}
    manifest = next(a.split("=", 1)[1] for a in decode["args"] if a.startswith("++dataset_config.val_data_path="))
    first = tmp / "first.jsonl"
    first.write_text("".join(Path(manifest).read_text().splitlines(keepends=True)[:TP_GLOO_UTTS]))
    frames = [int(lo + (hi - lo) * i / (S2S_BATCH - 1)) for lo, hi in S2S_TRAIN_FRAMES for i in range(S2S_BATCH)]
    s2s_train = write_s2s_corpus(tmp, "train", frames, seed=1)  # phase 19 (b)'s corpus, written again
    s2s_val = write_s2s_corpus(tmp, "val", [30] * 4, seed=2)
    questions = write_s2s_corpus(tmp, "questions", [30] * TP_S2S_QUESTIONS, seed=3)
    s2s_decode = ["++decode_config.mode=batch", f"++dataset_config.val_data_path={questions}",
                  f"++decode_config.max_new_tokens={TP_S2S_NEW}"]
    family_args, family_one = tp_family_references(tmp / "families")
    job = {"backend": "gloo", "run": ["probe", "tp_gap", "asr", "decode", "s2s", "s2s_decode", "fsdp_decode",
                                      "fsdp_s2s_decode", *FAMILY_RUNS],
           "family": family_args, "family_dir": str(tmp / "families" / "tp2"),
           "asr_args": [*train["args"], f"++train_config.output_dir={tmp / 'asr'}", "++train_config.shard.tp=2",
                        f"++train_config.max_steps_per_epoch={TP_GLOO_STEPS}", "++train_config.run_validation=false"],
           "decode_args": [*decode["args"], f"++decode_config.decode_log={tmp / 'decode'}",
                           f"++dataset_config.val_data_path={first}", "++train_config.shard.tp=2"],
           "s2s_args": [*PHASE["s2s"]["args"](s2s_train, s2s_val), f"++train_config.output_dir={tmp / 's2s'}",
                        "++train_config.save_model=false", "++train_config.run_validation=false",
                        f"++train_config.max_steps_per_epoch={TP_S2S_STEPS}", "++train_config.shard.tp=2"],
           "s2s_decode_args": [*s2s_decode, f"++decode_config.decode_log={tmp / 's2s_tp2'}",
                               "++train_config.shard.tp=2"],
           # the sharded decodes: phase 4's 16 utterances (a batch of 8 a rank), and TP_S2S_QUESTIONS questions
           "fsdp_decode_args": [*decode["args"], f"++decode_config.decode_log={tmp / 'fsdp2'}",
                                "++train_config.shard.fsdp=2"],
           "fsdp_s2s_decode_args": [*s2s_decode, f"++decode_config.decode_log={tmp / 's2s_fsdp2'}",
                                    "++train_config.shard.fsdp=2"]}
    got = _torchrun(2, job, tmp, timeout=TP_LAUNCH_TIMEOUT_S)
    log(f"[tensor parallel] (b) gloo on CUDA tensors (torch {torch.__version__}): {got['probe']}")
    for note in got.get("notes", []):
        log(f"[tensor parallel] (b) rank 0: {note}")
    if "tp_gap" in got:
        g = got["tp_gap"]
        log(f"[tensor parallel] (b) whisper-small + linear projector in bf16, split at tp=2 ({g['heads']} heads a "
            f"rank) against whole, outputs {g['shape']}: encoder {g['encoder']}, projector {g['projector']} "
            f"(max_abs / rel: the difference's largest entry and norm over the whole output's; differ: the share of "
            f"entries not bit-equal; scale: the output's largest entry) | {SMI}")
        if max(g["encoder"]["rel"], g["projector"]["rel"]) > TP_GAP_RTOL:
            raise AssertionError(f"(b): the split whisper / projector differ from whole by more than {TP_GAP_RTOL}")
    if "asr" in got:
        if got["world"] != 2 or got["backend"] != "gloo":
            raise AssertionError(f"phase 20 (b) ran on {got['world']} ranks over {got['backend']}")
        asr = got["asr"]
        exact = _same_run(f"(b) asr_whisper_tinyllama at tp=2 (gloo, two ranks on one card) vs phase 5's first "
                          f"{TP_GLOO_STEPS} steps", asr, {"steps": train["steps"][:TP_GLOO_STEPS]}, TP_LOSS_RTOL,
                          TP_NORM_RTOL)
        log(f"[tensor parallel] (b) step ms {[round(1000 * s['seconds'], 1) for s in asr['steps']]} against phase "
            f"5's {train['step_ms']:.1f} ms (both ranks on one card, their "
            f"collectives through the host: a check of the path, not a speed); rank 0's peak {asr['peak_gib']:.2f} "
            f"GiB vs {train['peak_gib']:.2f}; int8 base {asr['base_bytes'] / 2**20:.1f} MiB a rank; bit-equal {exact} "
            f"| {SMI}")
        lines = Path(got["decode"]["pred"]).read_text().splitlines()
        want = Path(decode["pred"]).read_text().splitlines()[:TP_GLOO_UTTS]
        log(f"[tensor parallel] (b) inference_batch at tp=2, phase 4's first {TP_GLOO_UTTS} utterances: {len(lines)} "
            f"lines, equal to phase 4's {lines == want}; decode loop {got['decode']['seconds']:.2f} s (phase 4's 16 "
            f"utterances: {decode['seconds']:.2f} s)")
        if lines != want:
            raise AssertionError("(b): the tp=2 decode differs from phase 4's")
        run_s2s_gloo(got, tmp / "s2s_one", s2s_decode)
        launches = got["launches"]
        missing = [k for k in TP_PATH if not launches.get(k)]
        log(f"[tensor parallel] (b) launches on rank 0 over the tp path: "
            f"{ {k: launches.get(k, 0) for k in (*TP_PATH, 'flash_attention_fwd_f32')} }")
        if missing:
            raise AssertionError(f"kernels never launched on the tensor-parallel path: {missing}")
    else:
        log("[tensor parallel] (b) not run: gloo does not run every tp collective on CUDA tensors here (above), and "
            "NCCL refuses two ranks on one card")
    if "fsdp_decode" in got:
        check_fsdp_gloo(got, decode, s2s_world1(tmp / "s2s_one_bf16", s2s_decode, dtype=None))
        launches = got["launches"]
    else:
        log("[tensor parallel] (b) the fsdp=2 decodes were not run: gloo does not run FSDP2's all-gathers of "
            f"{[str(dt).split('.')[-1] for dt in FSDP_GATHER_DTYPES]} on CUDA tensors here (above)")
    if all(r in got for r in FAMILY_RUNS):
        check_tp_families(got, family_one)
    else:
        log("[tensor parallel] (b) the other families' tp runs were not run: gloo does not run every tp collective "
            "on CUDA tensors here (above)")
    if torch.cuda.device_count() >= 2:
        run_multi_card_tp(train, tmp)
    else:
        log(f"[tensor parallel] (c) the NCCL runs on two and four cards were not run: this machine has "
            f"{torch.cuda.device_count()} card")
    import shutil

    shutil.rmtree(tmp)
    log(f"[tensor parallel] phase 20 in {time.perf_counter() - t_phase:.1f} s")
    return {k: launches.get(k, 0) for k in kernel_counters()}


# (b)'s other families at tp=2 over gloo on one card, against world size 1 in this process at the same cut:
# each recipe at TP_FAMILY_LAYERS LLM (VALL-E X: AR and NAR), encoder and, for the trained SELD Q-Former,
# Q-Former layers at its full widths, one training step of 16 (the recipe's 8 Q-Former blocks put the grad
# norms 1.2 % apart: blocks 3-7 attend near-uniformly, so their q / k gradients are K4's bf16 rounding, which
# the split reorders; ROADMAP Queue 3); the SEC decode on one batch of TP_FAMILY_UTTS utterances,
# TP_FAMILY_NEW new tokens, its LLM in f32 (as (b)'s S2S decode: a bf16 LLM's reordered sums would flip a
# random model's near-tied tokens)
TP_FAMILY_LAYERS, TP_FAMILY_UTTS, TP_FAMILY_NEW = 2, 8, 8
TP_FAMILY_PATH = ("flash_attention_fwd", "flash_attention_bwd", "flash_attention_fwd_f32", "flash_attention_bwd_f32")


@contextlib.contextmanager
def family_layers(n: int, llm_dtype=None, enc_dtype=None):
    """vicuna-7b, Spatial-AST-base, emotion2vec-base and VALL-E X's
    base_24l (AR and NAR each) cut to ``n`` layers at their full widths,
    vicuna-7b in ``llm_dtype`` and emotion2vec-base in ``enc_dtype`` where
    given, in-process."""
    import dataclasses

    from slam_llm_tpu_torch.models import spatial_ast, vallex, wavlm
    from slam_llm_tpu_torch.models.llm import LLMConfig

    full = LLMConfig.vicuna_7b
    tables = ((spatial_ast.SPATIAL_AST_PRESETS, "spatialast-base", {"n_layers": n}),
              (wavlm.WAVLM_PRESETS, "emotion2vec-base", {"n_layers": n, **({} if enc_dtype is None else
                                                                             {"dtype": enc_dtype})}),
              (vallex.PRESETS, "vallex", {"ar_layers": n, "nar_layers": n}))
    saved = [(table, key, table[key]) for table, key, _ in tables]
    LLMConfig.vicuna_7b = staticmethod(lambda: dataclasses.replace(
        full(), n_layers=n, **({} if llm_dtype is None else {"dtype": llm_dtype})))
    for table, key, kw in tables:
        table[key] = (lambda preset, kw: lambda: dataclasses.replace(preset(), **kw))(table[key], kw)
    try:
        yield
    finally:
        LLMConfig.vicuna_7b = staticmethod(full)
        for table, key, preset in saved:
            table[key] = preset


def tp_family_args(tmp: Path) -> dict:
    """The corpora, the tokenizer and the entry points' arguments of (b)'s
    family runs: SELD with its encoder trained, VALL-E X in the 512 bucket
    (one step of 16 each) and the SEC decode."""
    from slam_llm_tpu_torch.tools import synth_checkpoint as synth

    _ms_tokenizer(tmp)
    over = synth.write_seld_corpus(str(tmp / "seld"), n=16, n_eval=4, seed=0)
    vx_train = synth.write_vallex_corpus(str(tmp / "vx.jsonl"), VX_BATCH, frames=VX_FRAMES[VX_TA[0]],
                                         text_len=(40, VX_TT), seed=VX_TA[0])
    sec_test = write_corpus(tmp, n=TP_FAMILY_UTTS, seed=2, name="sec_test", targets=SEC_CAPTIONS)
    one_step = ("++train_config.log_interval=1", "++train_config.run_validation=false",
                "++train_config.warmup_steps=1", "++train_config.num_epochs=1", "++train_config.max_steps_per_epoch=1",
                "++train_config.save_model=false")
    recipe = ("++model_config.file=__main__:synth_tokenizer_factory",)
    return {
        "tokenizer_dir": _synth_tokenizer_dir,
        "seld_args": ["--config", str(SELD_RECIPE), *recipe, *(f"++dataset_config.{k}={v}" for k, v in over.items()),
                      f"++model_config.qformer_layers={TP_FAMILY_LAYERS}", "++train_config.freeze_encoder=false",
                      *one_step],
        "vallex_args": ["--config", str(VX_RECIPE), f"++dataset_config.train_data_path={vx_train}",
                        "++dataset_config.code_layer=8", *one_step],
        "sec_args": ["--config", str(SEC_RECIPE), *recipe, f"++dataset_config.val_data_path={sec_test}",
                     f"++decode_config.max_new_tokens={TP_FAMILY_NEW}",
                     f"++train_config.val_batch_size={TP_FAMILY_UTTS}"],
    }


def family_run(name: str, args: dict, out_dir: Path, device: str, extra=()):
    """One of (b)'s family runs through its entry point at the cut
    (``family_layers``): ``seld`` / ``vallex`` training, ``sec`` decoding;
    its result and launches."""
    from slam_llm_tpu_torch.pipeline import finetune, inference_batch

    out_dir.mkdir(parents=True, exist_ok=True)
    if name == "sec":
        cfg = inference_batch.load_run_config([*args["sec_args"], f"++decode_config.decode_log={out_dir / 'sec'}",
                                               *extra])
        with family_layers(TP_FAMILY_LAYERS, llm_dtype=torch.float32, enc_dtype=torch.float32):
            return run_counted(lambda: inference_batch.main(cfg, device=device))
    cfg = finetune.load_run_config([*args[f"{name}_args"], f"++train_config.output_dir={out_dir / name}", *extra])
    with family_layers(TP_FAMILY_LAYERS):
        return run_counted(lambda: finetune.main(cfg, device=device))


FAMILY_RUNS = ("family_seld", "family_vallex", "family_sec")


def tp_family_references(tmp: Path) -> tuple:
    """(b)'s family runs at world size 1 in this process: their arguments
    (``tp_family_args``) and results, the references of the tp=2 runs."""
    tmp.mkdir(parents=True, exist_ok=True)
    args = tp_family_args(tmp)
    one = {}
    for name in ("seld", "vallex", "sec"):
        one[name], _ = family_run(name, args, tmp / "one", "cuda")
        torch.cuda.empty_cache()
    return args, one


def check_tp_families(got: dict, one: dict) -> dict:
    """Phase 20 (b), the families split over tp past the LLM and whisper,
    each run at tp=2 over gloo against ``one`` (``tp_family_references``):
    the SELD recipe with Spatial-AST-base trained (f32: K1 / K4's f32
    routes) and the 64-query Q-Former split, and vallex_tts.yaml (base_24l's
    widths), TP_FAMILY_LAYERS + TP_FAMILY_LAYERS layers, one training step
    of 16 each through ``pipeline.finetune``: losses within one bf16
    rounding, grad norms within 1e-2; the SEC recipe's ``inference_batch``
    (emotion2vec-base and the Q-Former split, beam 4), its ``_pred`` line
    for line. Every family is logged before a failure raises. Returns rank
    0's launches of the family runs."""
    failed = []
    for name, label in (("seld", "seld_spatialast_llama, Spatial-AST trained"), ("vallex", "vallex_tts")):
        tp2, ref = got[f"family_{name}"], one[name]
        try:
            exact = _same_run(f"(b) {label} at {TP_FAMILY_LAYERS} + {TP_FAMILY_LAYERS} layers at tp=2 (gloo, two "
                              f"ranks on one card) vs world size 1", tp2, ref, TP_LOSS_RTOL, TP_NORM_RTOL)
        except AssertionError as e:
            failed.append(str(e))
            exact = False
        log(f"[tensor parallel] (b) {label}: step ms {[round(1000 * s['seconds'], 1) for s in tp2['steps']]} at tp=2 "
            f"vs {[round(1000 * s['seconds'], 1) for s in ref['steps']]} at world size 1; rank 0's peak "
            f"{tp2['peak_gib']:.2f} GiB; bit-equal {exact}; launches at tp=2 "
            f"{got['launches_by_run'][f'family_{name}']} | {SMI}")
    sec = got["family_sec"]
    lines, want = (Path(p).read_text().splitlines() for p in (sec["pred"], one["sec"]["pred"]))
    log(f"[tensor parallel] (b) sec_emotion2vec_vicuna inference_batch at tp=2, {TP_FAMILY_LAYERS} + "
        f"{TP_FAMILY_LAYERS} layers, the LLM and emotion2vec in f32: {len(lines)} lines, equal to world size 1's "
        f"{lines == want}; decode {sec['seconds']:.2f} s vs {one['sec']['seconds']:.2f} s")
    if lines != want or len(lines) != TP_FAMILY_UTTS:
        failed.append(f"(b): the SEC decode at tp=2 differs from world size 1's:\n{lines}\n{want}")
    launches = {k: sum(got["launches_by_run"][r].get(k, 0) for r in FAMILY_RUNS) for k in TP_FAMILY_PATH}
    log(f"[tensor parallel] (b) the families' launches on rank 0 over the tp path: {launches}")
    failed += [f"{k} never launched on the families' tensor-parallel path" for k, v in launches.items() if not v]
    if failed:
        raise AssertionError("\n".join(failed))
    return launches


def run_tp_families(tmp: Path) -> dict:
    """Phase 20 (b)'s family runs alone (``check_tp_families``): the world
    size 1 references here, then two gloo ranks on this card."""
    t0 = time.perf_counter()
    args, one = tp_family_references(tmp)
    got = _torchrun(2, {"backend": "gloo", "run": ["probe", *FAMILY_RUNS], "family": args,
                        "family_dir": str(tmp / "tp2")}, tmp, timeout=TP_LAUNCH_TIMEOUT_S)
    if not all(r in got for r in FAMILY_RUNS):
        raise AssertionError(f"(b) the family runs did not run over gloo: probe {got.get('probe')}")
    launches = check_tp_families(got, one)
    log(f"[tensor parallel] (b) the families in {time.perf_counter() - t0:.1f} s")
    return launches


def run_s2s_gloo(got: dict, log_prefix: Path, decode_args: list) -> None:
    """Phase 20 (b)'s S2S runs (``s2s_qwen.yaml`` at S2S_LAYERS layers of
    Qwen2-7B's widths, whole LLM trained, group decode, tp=2 on one card
    over gloo): the training steps against phase 19 (b)'s first
    TP_S2S_STEPS (losses within one bf16 rounding, grad norms within 1e-2),
    the largest tensor a rank gathered (one CE chunk of the head's logits,
    never (B, T, vocabulary)); then ``generate_s2s`` at tp=2, its ``_pred``
    against the same run at world size 1 here (the LLM in f32)."""
    from slam_llm_tpu_torch.models.llm import LLMConfig

    s2s, want = got["s2s"], {"steps": PHASE["s2s_dist"]["steps"][:TP_S2S_STEPS]}
    exact = _same_run(f"(b) s2s_qwen at {S2S_LAYERS} layers at tp=2 (gloo, two ranks on one card) vs phase 19 (b)'s "
                      f"first {TP_S2S_STEPS} steps", s2s, want, TP_LOSS_RTOL, TP_NORM_RTOL)
    gathered = tuple(s2s["largest_gather"] or ())
    log(f"[tensor parallel] (b) s2s steps {[s['shape'] for s in s2s['steps']]}: ms "
        f"{[round(1000 * s['seconds'], 1) for s in s2s['steps']]} vs phase 19 (b)'s "
        f"{[round(1000 * s['seconds'], 1) for s in want['steps']]}, rank 0's peak a step "
        f"{[round(g, 2) for g in s2s['step_peak_gib']]} GiB ({s2s['peak_gib']:.2f} with the build) vs phase 19 (b)'s "
        f"{PHASE['s2s_dist']['peak_gib']:.2f}; the largest tensor a rank gathered {gathered}; bit-equal {exact} "
        f"| {SMI}")
    chunk = LLMConfig.qwen2_7b().ce_chunk  # a rank's CEs gather (B * chunk) rows of logits at a time
    if not gathered or int(np.prod(gathered[:-1])) > S2S_BATCH * chunk:
        raise AssertionError(f"(b) s2s at tp=2 gathered {gathered}: more than one CE chunk of logits")

    one = s2s_world1(log_prefix, decode_args)
    launches = one["launches"]
    tp2 = got["s2s_decode"]
    same = Path(tp2["pred"]).read_text() == Path(one["pred"]).read_text()
    log(f"[tensor parallel] (b) generate_s2s batch, {TP_S2S_QUESTIONS} questions, greedy, {TP_S2S_NEW} new tokens, "
        f"the LLM in f32: tp=2 {tp2['n']} utterances, {tp2['steps']} decode steps in {tp2['seconds']:.2f} s; world "
        f"size 1 {one['n']}, {sum(u['decode_steps'] for u in one['utterances'])} steps in {one['seconds']:.2f} s "
        f"(launches K1 f32 {launches['flash_attention_fwd_f32']}, K1 {launches['flash_attention_fwd']}); _pred equal "
        f"{same}")
    if not same or tp2["n"] != TP_S2S_QUESTIONS or one["n"] != TP_S2S_QUESTIONS:
        raise AssertionError("(b): generate_s2s at tp=2 differs from world size 1:\n"
                             f"{Path(tp2['pred']).read_text()!r}\n{Path(one['pred']).read_text()!r}")


def s2s_world1(log_prefix: Path, decode_args: list, layers: int = S2S_LAYERS, dtype=torch.float32) -> dict:
    """``generate_s2s`` batch mode in this process (world size 1) at
    ``layers`` layers of Qwen2-7B's widths: its results, launches, and the
    decode's peak GiB beside the build's and the resident model's
    (``decode_memory``)."""
    from slam_llm_tpu_torch.pipeline import generate_s2s

    cfg = _s2s_config(generate_s2s.load_run_config, *decode_args, f"++decode_config.decode_log={log_prefix}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with qwen2_layers(layers, dtype), decode_memory({}) as mem:
        one, launches = run_counted(lambda: generate_s2s.main(cfg, device="cuda"))
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()  # the session is gone: its card's memory goes back for the ranks
    return {**one, "launches": launches, "peak_gib": peak, **mem}


def check_fsdp_gloo(got: dict, decode: dict, one_s2s: dict) -> None:
    """Phase 20 (b)'s sharded decodes, two ranks on one card over gloo at
    ``shard.fsdp=2``: inference_batch on phase 4's 16 utterances (rank r
    decodes batch r of 8), its two rank logs in rank order line for line
    phase 4's ``_pred``; generate_s2s batch mode on TP_S2S_QUESTIONS
    questions (bf16), its rank logs against the world-size-1 decode. Each
    rank's decode steps and its own last useful step are
    logged: the ranks step in lockstep, each as long as the longest."""
    fsdp = got["fsdp_decode"]["ranks"]
    lines = [line for rank in fsdp for line in Path(rank["pred"]).read_text().splitlines()]
    want = Path(decode["pred"]).read_text().splitlines()
    for r, rank in enumerate(fsdp):
        log(f"[tensor parallel] (b) inference_batch at fsdp=2, rank {r}: {rank['n']} utterances, {rank['steps']} "
            f"decode steps, its own last useful steps summed {rank['useful']}, {rank['step_ms']:.2f} ms a step, "
            f"decode loop {rank['seconds']:.2f} s; {rank['resident_gib']:.2f} GiB resident once sharded, the "
            f"decode's peak {rank['peak_gib']:.2f} GiB (the build's {rank['build_peak_gib']:.2f}) | {SMI}")
    log(f"[tensor parallel] (b) inference_batch at fsdp=2 (gloo, two ranks on one card): {len(lines)} lines, equal "
        f"to phase 4's {lines == want}; launches {got['launches_by_run']['fsdp_decode']}; parameters computed with "
        f"{got['plain_params']}")
    if lines != want or len({rank["steps"] for rank in fsdp}) != 1:
        raise AssertionError("(b): the fsdp=2 decode differs from phase 4's, or its ranks took different steps")
    missing = [k for k in ("flash_attention_fwd", "rowquant", "int8_matmul")
               if not got["launches_by_run"]["fsdp_decode"].get(k)]
    if missing or got["plain_params"]["dtensor_or_strided"]:
        raise AssertionError(f"(b): the fsdp=2 decode launched no {missing}, or computed with {got['plain_params']}")
    s2s = got["fsdp_s2s_decode"]["ranks"]
    text = "".join(Path(rank["pred"]).read_text() for rank in s2s)
    for r, rank in enumerate(s2s):
        log(f"[tensor parallel] (b) generate_s2s at fsdp=2, rank {r}: (key, decode steps, own useful steps) "
            f"{rank['steps']}, {rank['seconds']:.2f} s; {rank['resident_gib']:.2f} GiB resident, the decode's peak "
            f"{rank['peak_gib']:.2f} GiB (the build's {rank['build_peak_gib']:.2f})")
    log(f"[tensor parallel] (b) generate_s2s batch at fsdp=2, {TP_S2S_QUESTIONS} questions, bf16: _pred "
        f"equal to world size 1's {text == Path(one_s2s['pred']).read_text()}")
    if text != Path(one_s2s["pred"]).read_text() or sum(rank["n"] for rank in s2s) != TP_S2S_QUESTIONS:
        raise AssertionError(f"(b): generate_s2s at fsdp=2 differs from world size 1:\n{text!r}\n"
                             f"{Path(one_s2s['pred']).read_text()!r}")


def run_multi_card_tp(one: dict, tmp: Path) -> None:
    """Phase 20 (c), NCCL one process a card: the ASR recipe at tp=2 (and,
    with four cards, tp=4 and fsdp=2 x tp=2) against phase 5, a rank's step
    ms, peak and bytes of the int8 base; with four cards ``run_s2s_tp``."""
    meshes = [(2, ("++train_config.shard.tp=2",))]
    if torch.cuda.device_count() >= 4:
        meshes += [(4, ("++train_config.shard.tp=4",)),
                   (4, ("++train_config.shard.fsdp=2", "++train_config.shard.tp=2"))]
    one_ms = 1000 * float(np.mean([s["seconds"] for s in one["steps"][2:]]))
    for i, (nproc, extra) in enumerate(meshes):
        args = [*one["args"], f"++train_config.output_dir={tmp / f'tp_{i}'}", *extra]
        got = _torchrun(nproc, {"run": ["asr"], "asr_args": args}, tmp, timeout=TP_LAUNCH_TIMEOUT_S)
        label = f"{nproc} cards {' '.join(e.split('.')[-1] for e in extra)}"
        _same_run(f"(c) {label} vs phase 5", got["asr"], one, TP_LOSS_RTOL, TP_NORM_RTOL)
        asr = got["asr"]
        step_ms = 1000 * float(np.mean([s["seconds"] for s in asr["steps"][2:]]))
        log(f"[tensor parallel] (c) {label}: step {step_ms:.1f} ms vs phase 5's {one_ms:.1f} ms, rank 0's peak "
            f"{asr['peak_gib']:.2f} GiB vs {one['peak_gib']:.2f}, int8 base {asr['base_bytes'] / 2**20:.1f} MiB a rank "
            f"| {SMI}")
    if torch.cuda.device_count() < 4:
        log("[tensor parallel] (c) s2s_qwen.yaml at 28 layers was not run: it needs four cards")
        return
    run_s2s_tp(tmp)
    run_multi_card_decode(PHASE["decode"], tmp)
    run_families_tp(tmp)


BUILD_SLACK_GIB = 1  # (c)'s sharded-build gate: a rank's build peak within its shards, 2 whole f32 tensors and this
VX4_STEPS = 4  # (c)'s VALL-E X steps of 16 in the 512 bucket (step ms: the mean from the third on)
VX_ONE_CARD = (389.5, 31.82)  # one card's step ms and peak GiB at (64, 512): PERF.md section 5's VALL-E X row


def run_families_tp(tmp: Path, parent: Path = None) -> None:
    """Phase 20 (c) with four cards (NCCL, one process a card), the families
    split past the LLM: ``vallex_tts.yaml`` at base_24l in the (64, 512)
    bucket, VX4_STEPS steps of 16 at tp=4 and at fsdp=2 x tp=2, rank 0's
    step ms and peak against one card's (``VX_ONE_CARD``); then
    ``asr_wavlm_vicuna.yaml`` (WavLM-large, the int8 vicuna-7b, the byte
    tokenizer, seeded weights) W_STEPS steps of 16 at tp=4, rank 0's peak
    with WavLM-large split, and with ``parent`` (another checkout's root)
    the same run of that tree in this call, its kernels built first."""
    from slam_llm_tpu_torch.tools.synth_checkpoint import write_vallex_corpus

    tmp.mkdir(parents=True, exist_ok=True)
    train = write_vallex_corpus(str(tmp / "vx4.jsonl"), VX_BATCH * VX4_STEPS, frames=VX_FRAMES[VX_TA[0]],
                                text_len=(40, VX_TT), seed=VX_TA[0])
    common = ("++train_config.log_interval=1", "++train_config.run_validation=false",
              "++train_config.save_model=false", "++train_config.num_epochs=1")
    vx = ["--config", str(VX_RECIPE), f"++dataset_config.train_data_path={train}", "++dataset_config.code_layer=8",
          f"++train_config.max_steps_per_epoch={VX4_STEPS}", f"++train_config.output_dir={tmp / 'vx4'}", *common]
    for extra in (("++train_config.shard.tp=4",), ("++train_config.shard.fsdp=2", "++train_config.shard.tp=2")):
        label = " x ".join(e.split(".")[-1] for e in extra)
        got = _torchrun(4, {"run": ["asr"], "asr_args": [*vx, *extra]}, tmp, timeout=TP_LAUNCH_TIMEOUT_S)["asr"]
        step_ms = 1000 * float(np.mean([s["seconds"] for s in got["steps"][2:]]))
        log(f"[tensor parallel] (c) vallex_tts base_24l (64, 512) on 4 cards at {label}: losses "
            f"{[round(s['loss'], 5) for s in got['steps']]}, step {step_ms:.1f} ms (mean of steps 3-{VX4_STEPS}) vs "
            f"one card's {VX_ONE_CARD[0]} ms, rank 0's peak {got['peak_gib']:.2f} GiB (a step: "
            f"{[round(g, 2) for g in got['step_peak_gib']]}) vs one card's {VX_ONE_CARD[1]} | {SMI}")
        if not all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) for s in got["steps"]):
            raise AssertionError(f"(c) vallex_tts at {label}: non-finite steps {got['steps']}")
    corpus = write_corpus(tmp, n=16 * W_STEPS, name="wavlm4")
    wv = ["--config", str(W_RECIPE), f"++dataset_config.train_data_path={corpus}",
          f"++train_config.max_steps_per_epoch={W_STEPS}", f"++train_config.output_dir={tmp / 'wavlm4'}", *common,
          "++train_config.shard.tp=4"]
    trees = [("this tree", ROOT)] + ([] if parent is None else [("parent", Path(parent))])
    for name, root in trees:
        if root != ROOT:
            subprocess.run([sys.executable, "-c", "from slam_llm_tpu_torch.kernels.build import build; build()"],
                           cwd=root, check=True, timeout=600)
        got = _torchrun(4, {"run": ["asr"], "asr_args": wv}, tmp, timeout=TP_LAUNCH_TIMEOUT_S, root=root)["asr"]
        step_ms = 1000 * float(np.mean([s["seconds"] for s in got["steps"][2:]]))
        log(f"[tensor parallel] (c) asr_wavlm_vicuna on 4 cards at tp=4, {name}: losses "
            f"{[round(s['loss'], 5) for s in got['steps']]}, step {step_ms:.1f} ms, rank 0's peak "
            f"{got['peak_gib']:.2f} GiB (a step: {[round(g, 2) for g in got['step_peak_gib']]}) | {SMI}")


def run_multi_card_decode(decode: dict, tmp: Path) -> None:
    """Phase 20 (c)'s sharded decodes on four cards (NCCL): inference_batch
    of phase 4's 16 utterances at fsdp=4 and at fsdp=2 x tp=2, each rank
    log line for line phase 4's (a data rank past the two batches decodes a
    wrapped one), a beam step's ms at each mesh against one card's; then
    ``s2s_qwen.yaml`` at Qwen2-7B's 28 layers (bf16), generate_s2s batch
    mode at fsdp=4 against this card alone, rank 0's peak GiB against one
    card's."""
    want = Path(decode["pred"]).read_text().splitlines()
    for extra in (("++train_config.shard.fsdp=4",), ("++train_config.shard.fsdp=2", "++train_config.shard.tp=2")):
        label = " x ".join(e.split(".")[-1] for e in extra)
        got = _torchrun(4, {"run": ["fsdp_decode"], "fsdp_decode_args": [
            *decode["args"], f"++decode_config.decode_log={tmp / ('decode_' + label.replace(' x ', '_'))}", *extra]},
            tmp, timeout=TP_LAUNCH_TIMEOUT_S)
        ranks = got["fsdp_decode"]["ranks"]
        writers = {Path(r["pred"]) for r in ranks if r["pred"] != os.devnull}
        merged = {}
        for path in writers:
            merged.update(line.split("\t", 1) for line in path.read_text().splitlines())
        same = [f"{k}\t{merged.get(k)}" for k in (line.split("\t", 1)[0] for line in want)] == want
        log(f"[tensor parallel] (c) inference_batch on 4 cards at {label}: {len(writers)} rank logs, line for line "
            f"phase 4's {same}; a beam step {[round(r['step_ms'], 2) for r in ranks]} ms a rank vs one card's "
            f"{decode['step_ms']:.2f} ms; decode steps {[r['steps'] for r in ranks]}, own useful "
            f"{[r['useful'] for r in ranks]}; rank 0: {ranks[0]['resident_gib']:.2f} GiB resident, the decode's peak "
            f"{ranks[0]['peak_gib']:.2f} (the build's {ranks[0]['build_peak_gib']:.2f}) vs one card's run "
            f"{decode['peak_gib']:.2f} | {SMI}")
        if not same or got["plain_params"]["dtensor_or_strided"]:
            raise AssertionError(f"(c) the decode at {label} differs from phase 4's, or computed with "
                                 f"{got['plain_params']}")
    run_multi_card_s2s_decode(tmp)


def run_multi_card_s2s_decode(tmp: Path) -> None:
    """Phase 20 (c) on four cards: ``s2s_qwen.yaml`` at Qwen2-7B's 28
    layers (bf16), generate_s2s batch mode at fsdp=4 against this card
    alone, rank 0's build peak held to its shards (the sharded build's
    gate) and its peaks against one card's."""
    questions = write_s2s_corpus(tmp, "questions4", [30] * TP_S2S_QUESTIONS, seed=3)
    args = ["++decode_config.mode=batch", f"++dataset_config.val_data_path={questions}",
            f"++decode_config.max_new_tokens={TP_S2S_NEW}"]
    one = s2s_world1(tmp / "s2s28_one", args, layers=28, dtype=None)
    got = _torchrun(4, {"run": ["fsdp_s2s_decode"], "s2s_layers": 28, "fsdp_s2s_decode_args": [
        *args, f"++decode_config.decode_log={tmp / 's2s28_fsdp4'}", "++train_config.shard.fsdp=4"]},
        tmp, timeout=TP_LAUNCH_TIMEOUT_S, env={"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    ranks = got["fsdp_s2s_decode"]["ranks"]
    text = "".join(Path(r["pred"]).read_text() for r in ranks)
    r0 = ranks[0]
    # the sharded build's gate: the rank's shards, two whole tensors in f32 in flight and 1 GiB
    limit = r0["resident_gib"] + 2 * r0["largest_f32_gib"] + BUILD_SLACK_GIB
    log(f"[tensor parallel] (c) s2s_qwen at 28 layers (bf16), generate_s2s batch at fsdp=4 on 4 cards: _pred "
        f"equal to one card's {text == Path(one['pred']).read_text()}; rank 0: {r0['resident_gib']:.2f} GiB "
        f"resident once sharded, the decode's peak {r0['peak_gib']:.2f} GiB, the build's peak "
        f"{r0['build_peak_gib']:.2f} GiB built into its shards (limit {limit:.2f}: resident + 2 x the largest whole "
        f"tensor's {r0['largest_f32_gib']:.2f} GiB in f32 + {BUILD_SLACK_GIB} GiB) vs one card's "
        f"{one['resident_gib']:.2f} / {one['peak_gib']:.2f} ({one['build_peak_gib']:.2f}) GiB; "
        f"{[round(r['seconds'], 2) for r in ranks]} s a rank vs {one['seconds']:.2f} s; steps "
        f"{[r['steps'] for r in ranks]} | {SMI}")
    if text != Path(one["pred"]).read_text():
        raise AssertionError("(c) generate_s2s at fsdp=4 differs from one card's")
    if r0["build_peak_gib"] > limit:
        raise AssertionError(f"(c) generate_s2s at fsdp=4: rank 0's build peaked at {r0['build_peak_gib']:.2f} GiB, "
                             f"above {limit:.2f} GiB")


S2S_TP_BUCKETS = (512, 1536)  # (c)'s buckets: 3 steps of 8 in each, in the loader's order


def run_s2s_tp(tmp: Path) -> None:
    """``s2s_qwen.yaml`` at Qwen2-7B's full 28 layers, the whole LLM trained,
    on four cards at tp=4 and fsdp=2 x tp=2: 3 steps of 8 in each of the
    recipe's 512 and 1536 buckets, a rank's step ms and rank 0's peak a
    step, and the two meshes' losses against each other. No rank holds
    whole logits: the loss reads column windows of its head and adapter
    shards, one CE chunk at a time."""
    spans = {512: S2S_TRAIN_FRAMES[0], 1536: S2S_TRAIN_FRAMES[2]}  # the answers' codec frames of each bucket
    frames = [int(lo + (hi - lo) * i / (3 * S2S_BATCH - 1)) for b in S2S_TP_BUCKETS for lo, hi in [spans[b]]
              for i in range(3 * S2S_BATCH)]
    s2s_train = write_s2s_corpus(tmp, "train", frames, seed=1)
    s2s_val = write_s2s_corpus(tmp, "val", [30] * 4, seed=2)
    args = s2s_train_args(s2s_train, s2s_val)
    runs = {}
    for i, extra in enumerate((("++train_config.shard.tp=4",),
                               ("++train_config.shard.fsdp=2", "++train_config.shard.tp=2"))):
        got = _torchrun(4, {"run": ["s2s"], "s2s_layers": 28, "s2s_args": [
            *args, f"++train_config.output_dir={tmp / f's2s_{i}'}", "++train_config.save_model=false",
            "++train_config.run_validation=false", f"++train_config.max_steps_per_epoch={3 * len(S2S_TP_BUCKETS)}",
            *extra]}, tmp, timeout=TP_LAUNCH_TIMEOUT_S,
            env={"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})  # the whole model is built, then split
        s2s = runs[i] = got["s2s"]
        label = " ".join(e.split(".")[-1] for e in extra)
        for bucket in S2S_TP_BUCKETS:
            mine = [(st, pk) for st, pk in zip(s2s["steps"], s2s["step_peak_gib"]) if st["shape"][2] == bucket]
            log(f"[tensor parallel] (c) s2s_qwen at 28 layers, whole LLM trained, 4 cards {label}, the {bucket} "
                f"bucket: step ms {[round(1000 * st['seconds'], 1) for st, _ in mine]}, losses "
                f"{[round(st['loss'], 5) for st, _ in mine]}, rank 0's peak a step {[round(pk, 2) for _, pk in mine]} "
                f"GiB | {SMI}")
        log(f"[tensor parallel] (c) {label}: buckets in order {[st['shape'][2] for st in s2s['steps']]}, rank 0's "
            f"peak {s2s['peak_gib']:.2f} GiB with the build; the largest tensor a rank gathered "
            f"{s2s['largest_gather']}")
        if sorted(st["shape"][2] for st in s2s["steps"]) != sorted(3 * list(S2S_TP_BUCKETS)):
            raise AssertionError(f"(c) s2s {label}: steps {s2s['steps']}")
    gaps = [_rel(a["loss"], b["loss"]) for a, b in zip(runs[0]["steps"], runs[1]["steps"])]
    log(f"[tensor parallel] (c) tp=4 vs fsdp=2 x tp=2, the same batches: relative loss gaps "
        f"{[f'{g:.2e}' for g in gaps]} (buckets {[st['shape'][2] for st in runs[0]['steps']]})")


# ---------------------------------------------------------------------------
# phase 21: the text-only fine-tune on Qwen2-7B's int8 base, bwd_pretranspose,
# the BEATs tokenizer and the perplexity CLI
# ---------------------------------------------------------------------------

TEXT_LAYERS = 28  # Qwen2-7B's decoder layers: the whole depth
TEXT_STEPS = 4
TEXT_BATCH, TEXT_T = 8, 256  # the batch and its text bucket (every row longer than the 192 bucket)
TEXT_M = TEXT_BATCH * TEXT_T  # the rows of the step's dense products
TEXT_NEW_TOKENS = 8  # 16 until phase 22 joined the run
TEXT_CHECK_LAYERS = 2  # LLM depth of the card-vs-CPU check (full widths)
TEXT_PROMPT = "Answer the instruction."
TEXT_PATH = ("flash_attention_fwd", "flash_attention_bwd", "rowquant", "rowquant_rot_sr", "int8_matmul",
             "int8_matmul_f32", "int8_matmul/wgmma", "int8_matmul/splitk")
TEXT_BYPASSED = ("flash_attention_fwd_f32", "flash_attention_bwd_f32", "rowquant_fold")  # bf16; no int8 / int8_sr dy
BT_CLIPS, BT_PATCHES = 4, 496  # the BEATs tokenizer's check: 10 s clips of 1000 fbank frames, 62 x 8 patches
BT_FRAMES = (1000, 800, 600, 1000)
PPL_TEXTS = ["the quick brown fox jumps over the lazy dog", "speech models read audio and write text",
             "a random model scores every sentence about the same", "one two three four five six seven eight",
             "hello world", "translate this sentence into german please", "x", "the end of the list"]
_EN = ("the", "red", "small", "house", "river", "train", "left", "early", "morning", "with", "three", "old",
       "friends", "who", "talked", "about", "music", "and", "books", "near", "quiet", "lake", "under", "sky")
_DE = ("das", "rote", "kleine", "haus", "fluss", "zug", "fuhr", "frueh", "morgen", "mit", "drei", "alten",
       "freunden", "die", "sprachen", "ueber", "musik", "und", "buecher", "nahe", "stillen", "see", "unter")


def write_text_corpus(root: Path, n: int, seed: int, name: str) -> Path:
    """A jsonl of ``n`` instruction / answer pairs in ASCII words, each
    prompt + answer 160-210 bytes: with the byte tokenizer and the prompt
    template every training row lands in the 256 bucket."""
    rng = np.random.default_rng(seed)
    path = root / f"{name}.jsonl"
    with open(path, "w") as f:
        for i in range(n):
            total = int(rng.integers(160, 211))
            instruct = "Translate into German: " + " ".join(rng.choice(_EN, 40))
            target = " ".join(rng.choice(_DE, 40))
            cut = int(rng.integers(70, 110))
            instruct, target = instruct[:cut].rstrip(), target[:total - cut].rstrip()
            f.write(json.dumps({"key": f"{name}_{i:03d}", "instruct": instruct, "target": target}) + "\n")
    return path


def text_args(tmp: Path, steps: int = TEXT_STEPS, llm: str = "qwen2-7b", *extra: str) -> list:
    """The text-only recipe: ``dataset: text_dataset``, ``encoder_name:
    null``, LoRA r8 on q / v over the int8 base with the int8_rot backward
    and the int8 CE head, batch 8, the byte tokenizer."""
    return [
        f"++model_config.llm_name={llm}", "++model_config.encoder_name=null",
        "++dataset_config.dataset=text_dataset", f"++dataset_config.prompt={TEXT_PROMPT}",
        f"++dataset_config.train_data_path={write_text_corpus(tmp, TEXT_BATCH * steps, 0, 'train')}",
        f"++dataset_config.val_data_path={write_text_corpus(tmp, TEXT_BATCH, 1, 'val')}",
        "++train_config.use_peft=true", "++train_config.freeze_llm=true", "++train_config.peft_config.r=8",
        "++train_config.peft_config.lora_dropout=0.0", "++train_config.shard.base_quant=int8",
        "++train_config.shard.base_quant_bwd=int8_rot", "++train_config.shard.ce_quant=int8",
        f"++train_config.batch_size_training={TEXT_BATCH}", f"++train_config.val_batch_size={TEXT_BATCH}",
        f"++train_config.max_steps_per_epoch={steps}", "++train_config.num_epochs=1", "++train_config.warmup_steps=2",
        "++train_config.lr=1e-3", "++train_config.log_interval=1", f"++train_config.output_dir={tmp / 'out'}",
        "++train_config.model_name=text", *extra,
    ]


def lora_grads(trainer, batch) -> tuple:
    """(loss, the LoRA gradients) of one forward + backward of ``batch`` on
    the card, dropout off, no update."""
    model = trainer.model.eval()
    names = [n for n in trainer.trainable if "lora_" in n]
    params = dict(model.named_parameters())
    out = model(batch)
    grads = torch.autograd.grad(out["loss"], [params[n] for n in names])
    return float(out["loss"].detach()), dict(zip(names, (g.float() for g in grads)))


def _cosines(a: dict, b: dict) -> dict:
    return {n: torch.nn.functional.cosine_similarity(a[n].flatten(), b[n].flatten(), dim=0).item() for n in a}


def rot_sr_statistics(model, cfg, batch) -> None:
    """The int8_rot backward's seeded stochastic rounding, held by its
    statistics at TEXT_CHECK_LAYERS layers on the card: two seeds give two
    different LoRA gradients, each within cosine 0.99 of the deterministic
    int8 backward's and of the bf16 backward's (the exact gradient of the
    int8 forward)."""
    runs = {}
    for mode in ("int8_rot", "int8", "bf16"):
        small, trainer = cut_model(model, cfg, TEXT_CHECK_LAYERS, f"text {mode}", base_quant_bwd=mode)
        tb = trainer.put_batch(batch)
        seeds = [11, 12] if mode == "int8_rot" else [0]
        for seed in seeds:
            trainer.set_quant_seeds([seed] * len(trainer.sr_modules))
            runs[(mode, seed)] = lora_grads(trainer, tb)[1]
        del small, trainer
    a, b, det, exact = runs[("int8_rot", 11)], runs[("int8_rot", 12)], runs[("int8", 0)], runs[("bf16", 0)]
    differ = any(not torch.equal(a[n], b[n]) for n in a)
    worst = min(min(_cosines(g, ref).values()) for g in (a, b) for ref in (det, exact))
    log(f"[text] int8_rot statistics at {TEXT_CHECK_LAYERS} layers: two seeds differ {differ}; min cosine against "
        f"the deterministic int8 and the bf16 backward {worst:.5f} over {len(a)} LoRA tensors (int8 vs bf16 "
        f"{min(_cosines(det, exact).values()):.5f})")
    if not differ or worst < 0.99:
        raise AssertionError(f"int8_rot: seeds differ {differ}, min cosine {worst}")


def check_pretranspose(tmp: Path) -> None:
    """``shard.bwd_pretranspose`` on TinyLlama-1.1B with a bf16 base (LoRA r8
    on q / v, remat as shipped), the same seeded weights with and without
    it on a text batch of 8: losses within one bf16 rounding (2^-8), every
    LoRA gradient within cosine 0.999; every decoder dense's ``kernel_t``
    its weight's transpose. A comparison: its launches count on no path."""
    from slam_llm_tpu_torch.models.layers import DenseGeneralLora
    from slam_llm_tpu_torch.pipeline import finetune
    from slam_llm_tpu_torch.pipeline.common import build_model_and_data, materialize_params
    from slam_llm_tpu_torch.train.state import Trainer

    out = {}
    for flag in (False, True):
        cfg = finetune.load_run_config(text_args(tmp, 1, "tinyllama-1.1b", "++train_config.shard.base_quant=none",
                                                 "++train_config.shard.ce_quant=none",
                                                 f"++train_config.shard.bwd_pretranspose={str(flag).lower()}"))
        model, _, dataset = build_model_and_data(cfg, split="train", device="cuda")
        materialize_params(model, cfg)
        trainer = Trainer(model, model.cfg, cfg.train_config).state_from_params()
        redraw_adapters(model)
        denses = [m for m in model.modules() if isinstance(m, DenseGeneralLora) and hasattr(m, "kernel_t")]
        if flag and (len(denses) != 7 * RECIPE_LAYERS or not all(torch.equal(m.kernel_t, m.weight.t()) for m in denses)):
            raise AssertionError(f"bwd_pretranspose: {len(denses)} denses with kernel_t, not the transposes")
        batch = trainer.put_batch(dataset.collator([dataset[i] for i in range(TEXT_BATCH)]))
        t0 = time.perf_counter()
        out[flag] = (*lora_grads(trainer, batch), time.perf_counter() - t0)
        del model, trainer
        torch.cuda.empty_cache()
    (la, ga, sa), (lb, gb, sb) = out[False], out[True]
    cos = _cosines(ga, gb)
    log(f"[pretranspose] TinyLlama-1.1B bf16 base, batch {TEXT_BATCH}: loss {la:.6f} without, {lb:.6f} with "
        f"({abs(la - lb) / abs(la):.2e} relative); {len(cos)} LoRA gradients, min cosine {min(cos.values()):.6f}; "
        f"forward + backward {sa:.2f} / {sb:.2f} s (first calls)")
    if abs(la - lb) > 2.0**-8 * abs(la) or min(cos.values()) < 0.999:
        raise AssertionError(f"bwd_pretranspose: loss {la} vs {lb}, min cosine {min(cos.values())}")


def check_beats_tokenizer() -> dict:
    """``BEATsTokenizer.extract_labels`` at beats_iter3's widths (seeded
    random weights, bf16, the codebook from ``kmeans_cosine`` of the
    trunk's features on the card) on 4 clips of 10 / 8 / 6 / 10 s of
    normalized fbank: K1 once a layer at (4, 496, 12/12, 64); its CPU plain
    path (the same weights and inputs) queued: at least 99 % of the labels
    agree and the projected features keep cosine >= 0.999 over the valid
    patches."""
    from slam_llm_tpu_torch.models.beats_tokenizer import BEATsTokenizer, BEATsTokenizerConfig, kmeans_cosine, l2norm
    from slam_llm_tpu_torch.pipeline.common import init_params_

    cfg = BEATsTokenizerConfig.beats_iter3()
    model = BEATsTokenizer(cfg, device="cuda").eval()
    init_params_(model, torch.Generator(device="cuda").manual_seed(3))
    gen = torch.Generator(device="cuda").manual_seed(4)
    fbank = torch.randn(BT_CLIPS, max(BT_FRAMES), cfg.trunk.n_mels, generator=gen, device="cuda")
    mask = (torch.arange(max(BT_FRAMES), device="cuda")[None] < torch.tensor(BT_FRAMES, device="cuda")[:, None])
    mask = mask.to(torch.int32)
    with torch.inference_mode():
        # the codebook as the quantizer's kmeans_init makes it: cosine k-means of the trunk's features (a
        # random codebook leaves near-ties that bf16 flips: 97.3 % of the labels agreed in the first run)
        zin, out_mask = model.project(fbank, mask)
        samples = l2norm(zin.float()[out_mask.bool()])
        means, bins = kmeans_cosine(samples, cfg.quant_n, 10, generator=gen)
        model.codebook.copy_(means)
        (labels, (zin, out_mask)), launches = run_counted(
            lambda: (model.extract_labels(fbank, mask), model.project(fbank, mask)))
        t0 = time.perf_counter()
        model.extract_labels(fbank, mask)
        torch.cuda.synchronize()
        ms = 1000 * (time.perf_counter() - t0)
    if tuple(labels.shape) != (BT_CLIPS, BT_PATCHES) or launches["flash_attention_fwd"] != 2 * cfg.trunk.n_layers:
        raise AssertionError(f"BEATs tokenizer: labels {tuple(labels.shape)}, K1 launches "
                             f"{launches['flash_attention_fwd']}")
    log(f"[beats tokenizer] extract_labels {tuple(labels.shape)} of (4, {max(BT_FRAMES)}, 128) fbank on the card, "
        f"{ms:.1f} ms a call (host clock), K1 {launches['flash_attention_fwd'] // 2} a call; "
        f"{int(out_mask.sum())} valid patches; the codebook from k-means of their features on the card "
        f"({int((bins > 0).sum())} of {cfg.quant_n} clusters hold a patch)")
    card = (labels.cpu(), zin.float().cpu(), out_mask.bool().cpu())
    model.to("cpu")

    def cpu_side():
        t0 = time.perf_counter()
        with torch.inference_mode():
            c_labels = model.extract_labels(fbank.cpu(), mask.cpu())
            c_zin, _ = model.project(fbank.cpu(), mask.cpu())
        valid = card[2]
        agree = (card[0] == c_labels)[valid].float().mean().item()
        cos = torch.nn.functional.cosine_similarity(card[1][valid], c_zin.float()[valid], dim=-1)
        log(f"[beats tokenizer] card vs CPU plain path ({time.perf_counter() - t0:.1f} s on CPU): labels agree "
            f"{agree:.4f} of the valid patches (limit 0.99); projected features min cosine {cos.min().item():.5f} "
            f"mean {cos.mean().item():.5f} (limit 0.999)")
        if agree < 0.99 or cos.min().item() < 0.999:
            raise AssertionError(f"BEATs tokenizer: labels agree {agree}, min cosine {cos.min().item()}")

    on_cpu("beats tokenizer", cpu_side)
    return launches


def check_ppl() -> dict:
    """``python -m slam_llm_tpu_torch.utils.ppl`` (its ``main``) on the card
    over a random TinyLlama-1.1B HF directory that the phase writes (K1
    with fused RoPE, once a layer a text); the same on the CPU queued: the
    corpus perplexity within 1e-2 relative."""
    import shutil

    from slam_llm_tpu_torch.models.llm import LLMConfig
    from slam_llm_tpu_torch.tools.synth_checkpoint import write_llama, write_tokenizer
    from slam_llm_tpu_torch.utils import ppl

    llm = Path(tempfile.mkdtemp(prefix="chip_smoke_ppl_"))
    write_llama(str(llm), LLMConfig.tinyllama_1_1b(), seed=5, device="cuda")
    write_tokenizer(str(llm), 32000, seed=5)
    decode_log = llm / "ppl_pred"
    decode_log.write_text("".join(f"utt{i}\t{t}\n" for i, t in enumerate(PPL_TEXTS)))
    argv = [str(decode_log), "--llm", str(llm), "--llm-name", "tinyllama-1.1b"]
    t0 = time.perf_counter()
    card, launches = run_counted(lambda: ppl.main(argv))
    wall = time.perf_counter() - t0
    model, tok = ppl.load_llm(str(llm), "tinyllama-1.1b", "cuda")
    per_card, _ = ppl.ppl_of_texts(model, tok, PPL_TEXTS)
    del model
    log(f"[ppl] the CLI on the card: corpus ppl {card:.4f} over {len(PPL_TEXTS)} texts in {wall:.2f} s (load "
        f"included); K1 {launches['flash_attention_fwd']} launches")
    if not (np.isfinite(card) and launches["flash_attention_fwd"] == RECIPE_LAYERS * len(PPL_TEXTS)):
        raise AssertionError(f"ppl: {card}, K1 launches {launches['flash_attention_fwd']}")

    def cpu_side():
        t0 = time.perf_counter()
        per_cpu, cpu = ppl.ppl_of_texts(*ppl.load_llm(str(llm), "tinyllama-1.1b", "cpu"), PPL_TEXTS)
        worst = max(abs(a - b) / b for a, b in zip(per_card, per_cpu))
        log(f"[ppl] card vs CPU ({time.perf_counter() - t0:.1f} s on CPU): corpus {card:.4f} vs {cpu:.4f} "
            f"({abs(card - cpu) / cpu:.2e} relative), worst text {worst:.2e} (limit 1e-2)")
        shutil.rmtree(llm)
        if abs(card - cpu) > 1e-2 * cpu or worst > 1e-2:
            raise AssertionError(f"ppl: card {card}, CPU {cpu}, worst text {worst}")

    on_cpu("ppl", cpu_side)
    return launches


def run_text() -> tuple:
    """Phase 21: the text-only recipe on Qwen2-7B's int8 base at full width
    (TEXT_LAYERS layers, seeded random weights, the byte tokenizer):
    pipeline.finetune for TEXT_STEPS steps of 8 in the 256 bucket (LoRA
    moves, the projector, which a text batch never reaches, does not),
    pipeline.inference_batch with ckpt_path (beam 4) against the in-memory
    decode; the int8_rot backward by its statistics and the deterministic
    int8 backward against the CPU plain path at TEXT_CHECK_LAYERS layers
    (cosine >= 0.99, the loss within 1e-2); then bwd_pretranspose, the BEATs
    tokenizer and the perplexity CLI. Returns the launches of the text
    path, of the BEATs tokenizer and of the CLI."""
    import shutil

    from slam_llm_tpu_torch.pipeline import finetune, inference_batch

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_text_"))
    args = text_args(tmp)
    cfg = finetune.load_run_config(args)
    with contextlib.ExitStack() as stack:
        if TEXT_LAYERS != 28:
            stack.enter_context(qwen2_layers(TEXT_LAYERS))
        res, launches, stats = _finetune(cfg, "text")
        trainer, steps = res["trainer"], res["steps"]
        shapes = {tuple(s["shape"]) for s in steps}
        if len(steps) != TEXT_STEPS or shapes != {(TEXT_BATCH, TEXT_T)}:
            raise AssertionError(f"text: {len(steps)} steps of {shapes}, not {TEXT_STEPS} of {(TEXT_BATCH, TEXT_T)}")
        llm = trainer.model.llm
        log(f"[text] Qwen2-7B at {llm.cfg.n_layers} layers, d {llm.cfg.d_model}, vocab {llm.cfg.vocab_size}, "
            f"q / k / v biases {llm.layers[0].attn.q_proj.bias is not None}, the int8 base "
            f"{res['base_bytes'] / 1e9:.2f} GB; materialized in {res['load_seconds']:.2f} s; K2 widths "
            f"{sorted(WIDTHS.get('rowquant', {}))}, K3 (K, F) {sorted(WIDTHS.get('int8_matmul', {}))}")
        moved = [n for n, p in trainer.trainable.items() if "lora_" in n]
        if trainer.model.encoder is not None or not moved:
            raise AssertionError("text: an encoder was built, or no LoRA tensor trains")
        ckpt = res["checkpoints"][-1]
        dec = inference_batch.load_run_config([*args, f"++ckpt_path={ckpt}", f"++decode_config.decode_log={tmp / 'decode'}",
                                               f"++decode_config.max_new_tokens={TEXT_NEW_TOKENS}",
                                               "++decode_config.num_beams=4"])
        out, dec_launches = run_counted(lambda: inference_batch.main(dec, device="cuda"))
        preds = Path(out["pred"]).read_text().splitlines()
        from slam_llm_tpu_torch.data.tokenizer import ByteTokenizer

        mine = decode_texts(trainer.model, ByteTokenizer(), dec)
        log(f"[text] inference_batch with ckpt_path: {out['n']} prompts, beam 4, {out['generated_tokens']} tokens in "
            f"{out['seconds']:.2f} s ({1000 * out['decode_s'] / max(out['decode_steps'], 1):.1f} ms a beam step), "
            f"weights materialized in {out['load_seconds']:.2f} s; against the in-memory trained model: "
            f"{sum(a == b for a, b in zip(preds, mine))} / {len(preds)} lines identical; launches {dec_launches}")
        if len(preds) != TEXT_BATCH or preds != mine:
            raise AssertionError("text: the reloaded model's decode differs from the in-memory trained model's")
        dataset = dataset_of(cfg, ByteTokenizer(), "train")
        check = dataset.collator([dataset[i] for i in range(2)])
        rot_sr_statistics(trainer.model, cfg, check)
        small, strainer = cut_model(trainer.model, cfg, TEXT_CHECK_LAYERS, "text", base_quant_bwd="int8")
        del res, trainer
        redraw_adapters(small)
        cpu_side = train_grads_card(strainer, dataset, "text", loss_rtol=1e-2)
        small.to("cpu")
        on_cpu("text", cpu_side)
    torch.cuda.empty_cache()
    total = {k: launches[k] + dec_launches[k] for k in launches}
    missing = [name for name in TEXT_PATH if total[name] == 0]
    if missing or any(total[k] for k in TEXT_BYPASSED):
        raise AssertionError(f"the text path launched {total}")
    check_pretranspose(tmp)
    beats = check_beats_tokenizer()
    ppl_launches = check_ppl()
    shutil.rmtree(tmp)
    return total, beats, ppl_launches



# ---------------------------------------------------------------------------
# phase 22: the flash kernels' last routes on their main paths
# ---------------------------------------------------------------------------

ROUTES_BATCH, ROUTES_T = 8, 512  # the decoders' batch: 8 left-padded rows of 512
ROUTES_STEPS = 2  # training steps of each decoder (forward, backward, one AdamW update)
ROUTES_DECODE_STEPS = 8  # the head_dim-256 decoder's greedy steps through the KV cache
ROUTES_CHECK_LAYERS = 2  # the decoders' depth in the card-vs-CPU checks (full widths)
ROUTES_CROSS = ((256, 1500), (1500, 256))  # (Tq, Tk) of the op: queries over whisper-small's 1500 frames and back
K4_ROUTES_REL_L2 = 2.4e-3  # the new K4 rows' limit against the f32 twin (the older rows keep 2e-2)
ROUTES_PATH = ("flash_attention_fwd", "flash_attention_bwd", "flash_attention_fwd_f32", "flash_attention_bwd_f32")
# the panel route above head_dim 256: its K4 rows' limit against the f32 twin, set before their first card run
# from the bf16 twin's own spread against the f32 twin on the CPU at PANEL_CASES' shapes and the head_dim-512
# decoder's (2.288e-3 to 2.356e-3 relative L2 over dq / dk / dv)
K4_PANEL_REL_L2 = 3e-3
PANEL_PATH = ("flash_attention_fwd_wide", "flash_attention_bwd_wide", "flash_attention_fwd_wide_f32",
              "flash_attention_bwd_wide_f32")
ROUTES_D512_HEADS = 4  # the head_dim-512 decoder: gemma-2b's q width (2048) as 4 heads of 512 over 1 kv head
ROUTES_BYPASSED = ("rowquant", "rowquant_rot_sr", "rowquant_fold", "int8_matmul", "int8_matmul_f32")  # no int8 base

# phase 3's rows for the routes: (name, B, T or (Tq, Tk), H, Hkv, D, causal, padding, fused RoPE's theta or 0)
ROUTES_K1_CASES = [
    ("head_dim 256 decoder training (gemma-2b widths), fused RoPE, 8:1 GQA, left-padded", ROUTES_BATCH, ROUTES_T, 8,
     1, 256, True, "left", 1e4),
    ("head_dim 256 decoder prefill, left-padded", ROUTES_BATCH, ROUTES_T, 8, 1, 256, True, "left", 0),
    ("head_dim 192, fused RoPE, left-padded", 4, 1024, 16, 2, 192, True, "left", 1e4),
    *((f"{tq} queries over {tk} keys (whisper-small's heads), right-padded", ROUTES_BATCH, (tq, tk), 12, 12, 64,
       False, "right", 0) for tq, tk in ROUTES_CROSS),
    ("256 queries over 1500 keys at head_dim 256, 8:1 GQA, right-padded", ROUTES_BATCH, (256, 1500), 8, 1, 256, False,
     "right", 0),
]
ROUTES_K4_CASES = [c for c in ROUTES_K1_CASES if "prefill" not in c[0]]
# phase 3's rows of the panel route, each of its four kernels (bf16 and f32); the first two are the head_dim-512
# decoder's training and prefill shapes (phase 22 (d))
PANEL_CASES = [
    ("head_dim 512 decoder training, fused RoPE, 4:1 GQA, left-padded", ROUTES_BATCH, ROUTES_T, ROUTES_D512_HEADS, 1,
     512, True, "left", 1e4),
    ("head_dim 512 decoder prefill, left-padded", ROUTES_BATCH, ROUTES_T, ROUTES_D512_HEADS, 1, 512, True, "left", 0),
    ("head_dim 512, fused RoPE, 8:1 GQA, left-padded", 4, 1024, 8, 1, 512, True, "left", 1e4),
    ("head_dim 320, causal", 4, 1024, 16, 2, 320, True, "none", 0),
    ("256 queries over 1024 keys at head_dim 384, right-padded", 4, (256, 1024), 8, 2, 384, False, "right", 0),
    ("head_dim 1024", 2, 512, 4, 1, 1024, False, "none", 0),
]
ROUTES_F32_CASES = [
    ("f32 tinyllama training, fused RoPE, left-padded", ROUTES_BATCH, ROUTES_T, 32, 4, 64, True, "left", 1e4),
    ("f32 tinyllama prefill, left-padded", ROUTES_BATCH, ROUTES_T, 32, 4, 64, True, "left", 0),
    ("f32 head_dim 192, fused RoPE, left-padded", 4, 1024, 16, 2, 192, True, "left", 1e4),
    ("f32 head_dim 256, fused RoPE, 8:1 GQA, left-padded", ROUTES_BATCH, ROUTES_T, 8, 1, 256, True, "left", 1e4),
    *((f"f32 {tq} queries over {tk} keys (whisper-small's heads), right-padded", ROUTES_BATCH, (tq, tk), 12, 12, 64,
       False, "right", 0) for tq, tk in ROUTES_CROSS),
    ("f32 256 queries over 1500 keys at head_dim 256, 8:1 GQA, right-padded", ROUTES_BATCH, (256, 1500), 8, 1, 256,
     False, "right", 0),
]


def gemma_2b_widths():
    """An LLMConfig at google/gemma-2b's published widths (config.json:
    vocab 256000, hidden 2048, 18 layers, 8 heads over 1 kv head of 256,
    intermediate 16384, tied embeddings, rope_theta 1e4, rms_norm_eps 1e-6),
    as far as the JAX package's LLMConfig expresses them: the block stays
    its Llama block (SwiGLU, no embedding scale), so this is a head_dim-256
    decoder and not Gemma; bf16, ~2.5 B parameters."""
    from slam_llm_tpu_torch.models.llm import LLMConfig

    return LLMConfig(vocab_size=256000, d_model=2048, n_layers=18, n_heads=8, n_kv_heads=1, head_dim=256,
                     ffn_dim=16384, rope_theta=10000.0, rms_eps=1e-6, tied_embeddings=True)


def text_batch(vocab: int, rows: int, t: int, seed: int, device="cuda"):
    """(ids, mask, labels): seeded token ids, rows left-padded as
    ``_padding_mask`` pads them, the labels the valid tokens past each
    row's first quarter (its prompt)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    ids = torch.randint(3, vocab, (rows, t), generator=gen, device=device)
    mask = _padding_mask(rows, t, "left", dev=device)
    labels = torch.where(mask.bool(), ids, torch.full_like(ids, -100))
    labels[:, :t // 4] = -100
    return ids, mask, labels


def lora_decoder(cfg, layers: int = None, like=None):
    """``models.llm.CausalLM`` at ``cfg`` (LoRA r8 on q / v) on the card:
    seeded random weights, LoRA B redrawn nonzero; with ``like``, its
    first ``layers`` layers copied from that model instead. Returns the
    model and its LoRA factors (requires_grad on)."""
    import dataclasses

    from slam_llm_tpu_torch.models.llm import CausalLM
    from slam_llm_tpu_torch.pipeline.common import init_params_

    cfg = dataclasses.replace(cfg, lora_rank=8, n_layers=layers or cfg.n_layers)
    model = CausalLM(cfg, device="cuda")
    if like is None:
        init_params_(model, torch.Generator(device="cuda").manual_seed(22))
        redraw_adapters(model)
    else:
        keep = {n: p for n, p in like.state_dict().items()
                if not n.startswith("layers.") or int(n.split(".")[1]) < cfg.n_layers}
        model.load_state_dict(keep)
    lora = {n: p for n, p in model.named_parameters() if "lora_" in n}
    for p in lora.values():
        p.requires_grad_(True)
    return model, lora


def lm_grads(model, lora: dict, ids, mask, labels) -> tuple:
    """(loss, the LoRA gradients) of one forward + backward through
    ``loss_and_accuracy`` (the fused CE), remat as configured."""
    loss, _ = model.loss_and_accuracy(model.embed(ids), mask, labels)
    grads = torch.autograd.grad(loss, list(lora.values()))
    return float(loss.detach()), dict(zip(lora, grads))


def train_decoder(model, lora: dict, batch, steps: int, label: str) -> list:
    """``steps`` training steps on the card: loss and gradients, then one
    AdamW update of the LoRA factors (``train.optimizer``); every LoRA
    factor moves. Returns the steps' (loss, seconds)."""
    from slam_llm_tpu_torch.train.optimizer import AdamW

    before = {n: p.detach().clone() for n, p in lora.items()}
    opt = AdamW(list(lora.values()), lambda count: 1e-3)
    out = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = lm_grads(model, lora, *batch)
        opt.step(list(grads.values()))
        torch.cuda.synchronize()
        out.append((loss, time.perf_counter() - t0))
    still = [n for n, p in lora.items() if torch.equal(p, before[n])]
    if still or not all(np.isfinite(loss) for loss, _ in out):
        raise AssertionError(f"{label}: losses {out}, LoRA factors that did not move: {still[:4]}")
    return out


def decoder_against_cpu(model, label: str, layers: int, batch, loss_rtol: float, min_cos: float) -> None:
    """``model`` cut to ``layers`` layers at its full widths: the loss and
    LoRA gradients of ``batch`` on the card, and the CPU side queued: the
    same on the CPU plain path, the loss within ``loss_rtol`` relative and
    every LoRA gradient within cosine ``min_cos``."""
    small, lora = lora_decoder(model.cfg, layers, like=model)
    card_loss, card = lm_grads(small, lora, *batch)
    card = {n: g.float().cpu() for n, g in card.items()}
    small.to("cpu")
    cpu_batch = tuple(x.cpu() for x in batch)

    def cpu_side():
        t0 = time.perf_counter()
        cpu_loss, cpu = lm_grads(small, lora, *cpu_batch)
        cos = _cosines(card, {n: g.float() for n, g in cpu.items()})
        rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
        log(f"[routes] {label} at {layers} layers, card vs CPU plain path ({time.perf_counter() - t0:.1f} s on CPU), "
            f"batch {tuple(batch[0].shape)}: loss {card_loss:.7f} vs {cpu_loss:.7f} ({rel:.2e} relative, limit "
            f"{loss_rtol:.0e}); {len(cos)} LoRA gradients, min cosine {min(cos.values()):.7f} (limit {min_cos})")
        if rel > loss_rtol or min(cos.values()) < min_cos:
            raise AssertionError(f"{label}: loss {card_loss} vs {cpu_loss}, min cosine {min(cos.values())}")

    on_cpu(f"routes {label}", cpu_side)


def routes_f32_decoder() -> dict:
    """(a) ``models.llm.CausalLM`` at TinyLlama-1.1B's widths in f32 (all
    22 layers, LoRA r8 on q / v, no int8 base): two training steps of the
    8 x 512 left-padded batch (K1 f32 and K4 f32 with fused RoPE once a
    layer each), one prefill (K1 f32 on rotated q / k once a layer); the
    card against the CPU at ROUTES_CHECK_LAYERS layers (TF32 off): the loss
    within 1e-5 relative, every LoRA gradient within cosine 0.9999."""
    import dataclasses

    from slam_llm_tpu_torch.models.llm import LLMConfig, init_kv_cache

    cfg = dataclasses.replace(LLMConfig.tinyllama_1_1b(), dtype=torch.float32)
    model, lora = lora_decoder(cfg)
    batch = text_batch(cfg.vocab_size, ROUTES_BATCH, ROUTES_T, 31)
    steps, launches = run_counted(lambda: train_decoder(model, lora, batch, ROUTES_STEPS, "f32 decoder"))
    step_launches = dict(launches)

    def prefill():
        cache = init_kv_cache(cfg, ROUTES_BATCH, ROUTES_T + 1, gen_start=ROUTES_T, device="cuda")
        with torch.inference_mode():
            x, _ = model.prefill_hidden(model.embed(batch[0]), batch[1], cache)
            return model._head(x[:, -1])

    logits, pre = run_counted(prefill)
    launches = {k: launches[k] + pre[k] for k in launches}
    log(f"[routes] (a) f32 TinyLlama-1.1B, {cfg.n_layers} layers, LoRA r8, batch {tuple(batch[0].shape)}: steps "
        f"{[(round(l, 5), round(sec, 3)) for l, sec in steps]} (loss, s); K1 f32 {step_launches['flash_attention_fwd_f32']}"
        f" / K4 f32 {step_launches['flash_attention_bwd_f32']} launches in {ROUTES_STEPS} steps, K1 f32 "
        f"{pre['flash_attention_fwd_f32']} in the prefill; last-position logits {tuple(logits.shape)} finite "
        f"{bool(torch.isfinite(logits).all())}")
    per_step = cfg.n_layers * ROUTES_STEPS
    if (step_launches["flash_attention_fwd_f32"] != per_step or step_launches["flash_attention_bwd_f32"] != per_step
            or pre["flash_attention_fwd_f32"] != cfg.n_layers or not bool(torch.isfinite(logits).all())
            or any(launches[k] for k in ("flash_attention_fwd", "flash_attention_bwd", *ROUTES_BYPASSED))):
        raise AssertionError(f"routes (a): launches {launches}")
    check = tuple(x[:2] for x in batch)  # a full row and a left-padded one
    decoder_against_cpu(model, "(a) f32 decoder", ROUTES_CHECK_LAYERS, check, 1e-5, 0.9999)
    del model, lora
    torch.cuda.empty_cache()
    return launches


def head_dim_512_widths():
    """``gemma_2b_widths`` with the q width (2048) as ROUTES_D512_HEADS heads
    of 512 over 1 kv head: a head_dim-512 decoder, which no model the repo
    supports has (neither package has a preset), at ~2.5 B parameters."""
    import dataclasses

    return dataclasses.replace(gemma_2b_widths(), n_heads=ROUTES_D512_HEADS, head_dim=512)


def routes_head_dim_256() -> dict:
    """(b) ``models.llm.CausalLM`` at gemma-2b's widths (``gemma_2b_widths``,
    bf16, 18 layers, LoRA r8 on q / v): two training steps of the 8 x 512
    left-padded batch (K1 and K4 at D 256 with fused RoPE and 8:1 GQA once
    a layer each), a prefill of the 8 prompts (K1 at D 256 on rotated q /
    k), ROUTES_DECODE_STEPS greedy steps through the KV cache; the card
    against the CPU at ROUTES_CHECK_LAYERS layers: the loss within 1e-2,
    every LoRA gradient within cosine 0.99."""
    return routes_bf16_decoder("(b) head_dim-256", gemma_2b_widths(), 32, "flash_attention_fwd",
                               "flash_attention_bwd", ("flash_attention_fwd_f32", "flash_attention_bwd_f32",
                                                       *PANEL_PATH))


def routes_head_dim_512() -> dict:
    """(d) (b) at head_dim 512 (``head_dim_512_widths``: 4 heads over 1):
    the panel route's K1 and K4 at D 512 with fused RoPE and 4:1 GQA once a
    layer each in the training steps, its K1 in the prefill; held as (b)."""
    return routes_bf16_decoder("(d) head_dim-512", head_dim_512_widths(), 34, "flash_attention_fwd_wide",
                               "flash_attention_bwd_wide", ("flash_attention_fwd", "flash_attention_bwd",
                                                            "flash_attention_fwd_f32", "flash_attention_bwd_f32",
                                                            "flash_attention_fwd_wide_f32",
                                                            "flash_attention_bwd_wide_f32"))


def routes_bf16_decoder(label: str, cfg, seed: int, k1: str, k4: str, idle: tuple) -> dict:
    """A bf16 decoder of phase 22 at ``cfg``'s widths (18 layers, LoRA r8 on
    q / v): two training steps of the 8 x 512 left-padded batch (``k1`` and
    ``k4`` with fused RoPE once a layer each), a prefill of the 8 prompts
    (``k1`` on rotated q / k), ROUTES_DECODE_STEPS greedy steps through the
    KV cache, and none of ``idle`` or ROUTES_BYPASSED; the card against the
    CPU at ROUTES_CHECK_LAYERS layers: the loss within 1e-2, every LoRA
    gradient within cosine 0.99."""
    from slam_llm_tpu_torch.models.llm import init_kv_cache

    t0 = time.perf_counter()
    model, lora = lora_decoder(cfg)
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    batch = text_batch(cfg.vocab_size, ROUTES_BATCH, ROUTES_T, seed)
    steps, launches = run_counted(lambda: train_decoder(model, lora, batch, ROUTES_STEPS, f"{label} decoder"))
    step_launches = dict(launches)
    ids, mask, _ = batch
    t = ids.shape[1]

    def generate():
        cache = init_kv_cache(cfg, ROUTES_BATCH, t + ROUTES_DECODE_STEPS, gen_start=t, device="cuda")
        step_mask = torch.cat([mask, torch.zeros(ROUTES_BATCH, ROUTES_DECODE_STEPS, dtype=mask.dtype,
                                                 device="cuda")], 1)
        pos = mask.sum(1, keepdim=True).long()
        with torch.inference_mode():
            x, cache = model.prefill_hidden(model.embed(ids), mask, cache)
            tok = model._head(x[:, -1:]).argmax(-1)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = [tok]
            for s_ in range(ROUTES_DECODE_STEPS - 1):
                step_mask[:, t + s_] = 1
                logits, cache = model.decode_step(model.embed(tok), cache, t + s_, step_mask, pos + s_)
                tok = logits.argmax(-1)
                out.append(tok)
            torch.cuda.synchronize()
        return torch.cat(out, 1), (time.perf_counter() - t1) / max(ROUTES_DECODE_STEPS - 1, 1)

    (tokens, step_s), gen_launches = run_counted(generate)
    launches = {k: launches[k] + gen_launches[k] for k in launches}
    log(f"[routes] {label} decoder ({cfg.n_heads} heads of {cfg.head_dim} over {cfg.n_kv_heads}): "
        f"{n_params / 1e9:.3f} B parameters (built and drawn in {build_s:.1f} s), batch {tuple(ids.shape)}: steps "
        f"{[(round(l, 5), round(sec, 3)) for l, sec in steps]} (loss, s); {k1} {step_launches[k1]} / "
        f"{k4} {step_launches[k4]} launches in {ROUTES_STEPS} steps; prefill + "
        f"{ROUTES_DECODE_STEPS - 1} decode steps: tokens {tuple(tokens.shape)}, {1000 * step_s:.1f} ms a decode step, "
        f"{k1} {gen_launches[k1]}; first row {tokens[0].tolist()}")
    per_step = cfg.n_layers * ROUTES_STEPS
    if (step_launches[k1] != per_step or step_launches[k4] != per_step or gen_launches[k1] != cfg.n_layers
            or tuple(tokens.shape) != (ROUTES_BATCH, ROUTES_DECODE_STEPS)
            or any(launches[k] for k in (*idle, *ROUTES_BYPASSED))):
        raise AssertionError(f"routes {label}: launches {launches}, tokens {tuple(tokens.shape)}")
    ids_c, mask_c, labels_c = text_batch(cfg.vocab_size, 2, ROUTES_T // 2, seed + 1)
    check = (ids_c[1:], mask_c[1:], labels_c[1:])  # one left-padded row of 256: the CPU's bf16 head is 256000 wide
    decoder_against_cpu(model, f"{label} decoder", ROUTES_CHECK_LAYERS, check, 1e-2, 0.99)
    del model, lora
    torch.cuda.empty_cache()
    return launches


def routes_cross_attention() -> dict:
    """(c) ``layers.mha_attention`` with gradients at Tq != Tk (not causal,
    keys right-padded), in bf16 and f32: 256 queries over 1500 keys and
    1500 over 256 at (8, ., 12/12, 64), and 256 over 1500 at head_dim 256
    (8/1 heads). Each output and gradient against its twin on the kernel's
    own (out, lse): bf16 out within 2e-2 abs, gradients within 2.4e-3
    relative L2; f32 out within 2e-5 abs, gradients within 2e-5 of the
    twin's largest entry (``bwd_f32_error``)."""
    from slam_llm_tpu_torch.models.layers import mha_attention
    from slam_llm_tpu_torch.ops.kernels.flash_attention import (
        bwd_f32_error,
        flash_attention_bwd_ref,
        flash_attention_fwd,
        flash_attention_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(23)
    shapes = [(tq, tk, 12, 12, 64) for tq, tk in ROUTES_CROSS] + [(256, 1500, 8, 1, 256)]
    total = None
    for dt in (torch.bfloat16, torch.float32):
        for tq, tk, h, hkv, d in shapes:
            q = torch.randn(ROUTES_BATCH, tq, h, d, generator=gen, device="cuda").to(dt)
            k, v = (torch.randn(ROUTES_BATCH, tk, hkv, d, generator=gen, device="cuda").to(dt) for _ in range(2))
            dout = torch.randn(ROUTES_BATCH, tq, h, d, generator=gen, device="cuda").to(dt)
            mask = _padding_mask(ROUTES_BATCH, tk, "right")
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]

            def step():
                out = mha_attention(*leaves, kv_mask=mask)
                return out.detach(), torch.autograd.grad(out, leaves, dout)

            (out, got), launches = run_counted(step)
            total = launches if total is None else {n: total[n] + launches[n] for n in total}
            k1, k4 = (("flash_attention_fwd", "flash_attention_bwd") if dt == torch.bfloat16
                      else ("flash_attention_fwd_f32", "flash_attention_bwd_f32"))
            if launches[k1] != 1 or launches[k4] != 1 or sum(launches.values()) != 2:
                raise AssertionError(f"routes (c) {(tq, tk, h, hkv, d)} {dt}: launches {launches}")
            k_out, k_lse = flash_attention_fwd(q, k, v, mask)  # the comparison's (out, lse): not counted
            if dt == torch.float32:
                ref, _ = flash_attention_ref(q, k, v, mask)
                want = flash_attention_bwd_ref(q, k, v, mask, k_out, k_lse, dout)
                out_err, grad_err = (out - ref).abs().max().item(), bwd_f32_error(got, want, q, k, v, dout)
                ok = out_err <= 2e-5 and grad_err <= 2e-5
                what = "of the twin's largest entry"
            else:
                ref, _ = flash_attention_ref(q.float(), k.float(), v.float(), mask)
                want = flash_attention_bwd_ref(q.float(), k.float(), v.float(), mask, k_out.float(), k_lse,
                                               dout.float())
                out_err = (out.float() - ref).abs().max().item()
                grad_err = max(((g.float() - w).norm() / w.norm()).item() for g, w in zip(got, want))
                ok = out_err <= 2e-2 and grad_err <= K4_ROUTES_REL_L2
                what = "relative L2"
            log(f"[routes] (c) mha_attention {str(dt)[6:]} (8, {tq} queries over {tk} keys, {h}/{hkv}, {d}), keys "
                f"right-padded: max|out - twin| {out_err:.3e}, gradients {grad_err:.3e} {what}; {k1} / {k4} once each")
            if not ok:
                raise AssertionError(f"routes (c) {(tq, tk, h, hkv, d)} {dt}: out {out_err}, gradients {grad_err}")
    return total


def routes_panel_op() -> dict:
    """(e) ``layers.mha_attention`` with gradients on the panel route:
    causal f32 with fused RoPE at D 320 and 512 (4:1 GQA, left-padded), bf16
    causal 4:1 GQA at D 384, and 256 queries over 1024 keys at D 512 (keys
    right-padded) in bf16 and f32. Each output and gradient against the
    twin on the kernel's own (out, lse): f32 within 2e-5 (out abs, the
    gradients of the twin's largest entry, ``bwd_f32_error``); bf16 out
    within 2e-2 abs, gradients within K4_PANEL_REL_L2 relative L2."""
    from slam_llm_tpu_torch.models.layers import mha_attention
    from slam_llm_tpu_torch.ops.kernels.flash_attention import (
        apply_rope_tables,
        bwd_f32_error,
        flash_attention_bwd_ref,
        flash_attention_fwd,
        flash_attention_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(26)
    b, h, hkv = ROUTES_BATCH, 4, 1
    cases = [(torch.float32, 320, ROUTES_T, True), (torch.float32, 512, ROUTES_T, True),
             (torch.bfloat16, 384, ROUTES_T, True), (torch.bfloat16, 512, (256, 1024), False),
             (torch.float32, 512, (256, 1024), False)]
    total = None
    for dt, d, t, causal in cases:
        tq, tk = _tq_tk(t)
        q = torch.randn(b, tq, h, d, generator=gen, device="cuda").to(dt)
        k, v = (torch.randn(b, tk, hkv, d, generator=gen, device="cuda").to(dt) for _ in range(2))
        dout = torch.randn(b, tq, h, d, generator=gen, device="cuda").to(dt)
        mask = _padding_mask(b, tk, "left" if causal else "right")
        rope = _rope_for(mask, d, 1e4) if causal and dt == torch.float32 else None
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]

        def step():
            out = mha_attention(*leaves, kv_mask=mask, causal=causal, rope=rope)
            return out.detach(), torch.autograd.grad(out, leaves, dout)

        (out, got), launches = run_counted(step)
        total = launches if total is None else {n: total[n] + launches[n] for n in total}
        k1, k4 = (("flash_attention_fwd_wide", "flash_attention_bwd_wide") if dt == torch.bfloat16
                  else ("flash_attention_fwd_wide_f32", "flash_attention_bwd_wide_f32"))
        if launches[k1] != 1 or launches[k4] != 1 or sum(launches.values()) != 2:
            raise AssertionError(f"routes (e) {(tq, tk, h, hkv, d)} {dt}: launches {launches}")
        k_out, k_lse = flash_attention_fwd(q, k, v, mask, causal, rope=rope)  # the comparison's: not counted
        qr, kr = (apply_rope_tables(x, *rope) for x in (q, k)) if rope is not None else (q, k)
        ref, _ = flash_attention_ref(qr.float(), kr.float(), v.float(), mask, causal)
        want = flash_attention_bwd_ref(qr.float(), kr.float(), v.float(), mask, k_out.float(), k_lse, dout.float(),
                                       causal)
        if rope is not None:
            want = (apply_rope_tables(want[0], *rope, inverse=True), apply_rope_tables(want[1], *rope, inverse=True),
                    want[2])
        out_err = (out.float() - ref).abs().max().item()
        if dt == torch.float32:
            grad_err, what = bwd_f32_error(got, want, q, k, v, dout), "of the twin's largest entry"
            ok = out_err <= 2e-5 and grad_err <= 2e-5
        else:
            grad_err = max(((g.float() - w).norm() / w.norm()).item() for g, w in zip(got, want))
            what, ok = "relative L2", out_err <= 2e-2 and grad_err <= K4_PANEL_REL_L2
        log(f"[routes] (e) mha_attention {str(dt)[6:]} ({b}, {tq} queries over {tk} keys, {h}/{hkv}, {d}) "
            f"causal={causal} fused RoPE={rope is not None}: max|out - twin| {out_err:.3e}, gradients "
            f"{grad_err:.3e} {what}; {k1} / {k4} once each")
        if not ok:
            raise AssertionError(f"routes (e) {(tq, tk, h, hkv, d)} {dt}: out {out_err}, gradients {grad_err}")
    return total


def run_routes() -> tuple:
    """Phase 22: the flash kernels' last routes on the paths that reach
    them: (a) an f32 TinyLlama-1.1B decoder (K1 f32 / K4 f32 with fused
    RoPE), (b) a head_dim-256 decoder at gemma-2b's widths (K1 / K4 at D
    256), (c) ``mha_attention`` at Tq != Tk (K4 and K4 f32 over Tq queries
    and Tk keys), (d) a head_dim-512 decoder (the panel route's K1 / K4),
    (e) ``mha_attention`` on the panel route (its four kernels). Returns
    the launches of the phase and by part."""
    by_part = {"f32_fused_rope": routes_f32_decoder(), "head_dim_256": routes_head_dim_256(),
               "tq_ne_tk": routes_cross_attention(), "head_dim_512": routes_head_dim_512(),
               "panel_op": routes_panel_op()}
    total = {n: sum(part[n] for part in by_part.values()) for n in by_part["f32_fused_rope"]}
    missing = [n for n in (*ROUTES_PATH, *PANEL_PATH) if total[n] == 0]
    if missing:
        raise AssertionError(f"the routes path never launched {missing}")
    return total, by_part


PHASE_SECONDS = {}


def timed(name: str, fn, *args):
    """``fn(*args)``, its wall seconds kept under ``name`` in PHASE_SECONDS."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = round(time.perf_counter() - t0, 1)
    return out


def main() -> int:
    global SMI
    t0 = time.perf_counter()
    SMI = setup()
    timed("build", build)
    results = timed("kernels", check_kernels)
    decode = timed("decode", run_slice)
    train = timed("train", run_training)
    modes = timed("modes", run_training_modes)
    weights = timed("weights", run_weights)
    st = timed("st", run_st)
    wavlm = timed("wavlm", run_wavlm)
    aac, aac_files = timed("aac", run_aac)
    clap = timed("clap", run_clap, aac_files)
    music_spatial, seld_files = timed("music_spatial", run_music_spatial)
    seld_encoder = timed("seld_encoder", run_seld_encoder, seld_files)
    vsr = timed("vsr", run_vsr)
    large_scale = timed("large_scale", run_large_scale)
    # phases 21-22 here: their CPU sides run beside phases 16-18
    text, beats_tokenizer, ppl = timed("text", run_text)
    routes, routes_by_part = timed("routes", run_routes)
    s2s = timed("s2s", run_s2s)
    vallex = timed("vallex", run_vallex)
    peft = timed("peft", run_peft)
    timed("cpu_side", cpu_checks_done)  # phases 19-20 start with the host to themselves
    distributed = timed("distributed", run_distributed)
    tensor_parallel = timed("tensor_parallel", run_tensor_parallel)
    paths = {"decode": decode, "train": train, "train_int8_sr": modes, "weights": weights, "st": st,
             "wavlm": wavlm, "aac": aac, "clap": clap, **music_spatial, "seld_encoder": seld_encoder, "vsr": vsr,
             "large_scale": large_scale, "s2s": s2s,
             "vallex": vallex, "peft": peft, "text": text, "beats_tokenizer": beats_tokenizer, "ppl": ppl,
             "routes": routes, "distributed": distributed, "tensor_parallel": tensor_parallel}
    for r in results:
        r["launches_by_path"] = {path: counts[r["name"]] for path, counts in paths.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        if r["name"].startswith("int8_matmul"):  # the code paths count both epilogues together
            r["launches_by_code_path"] = {p: {path: counts[f"int8_matmul/{p}"] for path, counts in paths.items()}
                                          for p in ("wgmma", "splitk")}
    if not (s2s["flash_attention_fwd"] and s2s["flash_attention_bwd"]):
        raise AssertionError(f"the s2s path launched K1 {s2s['flash_attention_fwd']} / K4 {s2s['flash_attention_bwd']}")
    if not (vallex["flash_attention_fwd"] and vallex["flash_attention_bwd"]) or any(vallex[k] for k in VX_BYPASSED):
        raise AssertionError(f"the vallex path launched {vallex}")
    # each new route of phase 22 launched on its own part of the path: f32 with fused RoPE, D 256, Tq != Tk,
    # the panel route at D 512 and through the op
    want = {"f32_fused_rope": ("flash_attention_fwd_f32", "flash_attention_bwd_f32"),
            "head_dim_256": ("flash_attention_fwd", "flash_attention_bwd"),
            "tq_ne_tk": ("flash_attention_bwd", "flash_attention_bwd_f32"),
            "head_dim_512": ("flash_attention_fwd_wide", "flash_attention_bwd_wide"), "panel_op": PANEL_PATH}
    if any(not routes_by_part[part][n] for part, names in want.items() for n in names):
        raise AssertionError(f"the routes phase launched {routes_by_part}")
    log(f"[chip_smoke] phases 1-22 in {time.perf_counter() - t0:.1f} s, by phase {PHASE_SECONDS} | {SMI}")
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--distributed-job"]:
        distributed_job(sys.argv[2])
        sys.exit(0)
    try:
        sys.exit(main())
    finally:  # a failed phase exits without the queued CPU sides (the running one ends first)
        if _CPU_SIDE["pool"] is not None:
            _CPU_SIDE["pool"].shutdown(wait=False, cancel_futures=True)
