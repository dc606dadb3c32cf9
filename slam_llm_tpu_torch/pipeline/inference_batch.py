"""Batch decode entry point: test split -> generate -> {decode_log}_pred / _gt.

Counterpart of ``slam_llm_tpu/pipeline/inference_batch.py`` with the same
``--config`` + ``++key=value`` surface and the same ``key\\ttext`` TSV logs,
plus ``--device`` (default ``cuda``; asking for CUDA without a GPU raises):

    python -m slam_llm_tpu_torch.pipeline.inference_batch \\
        --config examples/asr_librispeech/conf/asr_whisper_tinyllama.yaml \\
        ++dataset_config.val_data_path=test.jsonl ++decode_config.decode_log=/tmp/decode \\
        ++model_config.llm_path=<hf dir> ++model_config.encoder_path=<hf dir> ++ckpt_path=<checkpoint dir>

Weights come from ``pipeline.common.materialize_params`` (the seeded random
init, the HF directories, then the trainable checkpoint: a directory holding
``model.pt`` or the JAX package's ``model.msgpack``, or either file).
``utils.wer`` scores the ``_pred`` / ``_gt`` logs.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

import numpy as np
import torch

from slam_llm_tpu_torch.config import RunConfig, load_run_config
from slam_llm_tpu_torch.data.loader import build_dataloader
from slam_llm_tpu_torch.inference.generate import GenerationConfig, Generator, strip_after_eos
from slam_llm_tpu_torch.pipeline.common import (
    build_model_and_data,
    materialize_params,
    parse_device,
    resolve_device,
    set_seed,
)
from slam_llm_tpu_torch.utils.logging_utils import setup_logger

VIDEO_FPS = 25.0  # AV-HuBERT's lip videos


def decode_loader(cfg: RunConfig, dataset):
    """The test split in order, ``val_batch_size`` rows per batch; the last
    batch is filled up by wrapping around."""
    return build_dataloader(
        dataset, cfg.train_config.val_batch_size, shuffle=False, drop_last=False,
        num_workers=cfg.dataset_config.num_workers, prefetch=cfg.dataset_config.prefetch,
        ragged_tail="wrap",
    )


def generation_config(cfg: RunConfig, tokenizer) -> GenerationConfig:
    """``decode_config`` with the tokenizer's special ids."""
    dc = cfg.decode_config
    return GenerationConfig(
        max_new_tokens=dc.max_new_tokens,
        num_beams=dc.num_beams,
        num_return_sequences=getattr(dc, "num_return_sequences", 1),
        do_sample=dc.do_sample,
        temperature=dc.temperature,
        top_k=dc.top_k,
        top_p=dc.top_p,
        repetition_penalty=dc.repetition_penalty,
        length_penalty=dc.length_penalty,
        eos_token_id=tokenizer.eos_token_id,
        pad_token_id=tokenizer.pad_token_id,
        bos_token_id=tokenizer.bos_token_id,
    )


def batch_audio_seconds(batch) -> float:
    """Seconds of audio in a batch, for the RTF: the collator's true
    (pre-pad) durations where it summed them, else the valid frames of the
    mel mask (10 ms hop) or of the raw waveform's mask (16 kHz), else the
    binaural feature map's frames (B, 4, frames, mels; 10 ms hop at 32 kHz),
    else the video frames of ``visual_mask`` at 25 fps (the rate
    ``models.avhubert.stacked_logfbank``'s 4-frame stack assumes). The JAX
    pipeline has no video branch, so a VSR decode's RTF is nan there."""
    if "audio_seconds" in batch:
        return float(batch["audio_seconds"])
    if "audio_mel_mask" in batch:
        return float(batch["audio_mel_mask"].sum()) * 0.01
    if "audio_mask" in batch:
        return float(batch["audio_mask"].sum()) / 16000.0
    if "audio_binaural" in batch:
        return float(batch["audio_binaural"].shape[0] * batch["audio_binaural"].shape[2]) * 0.01
    if "visual_mask" in batch:
        return float(batch["visual_mask"].sum()) / VIDEO_FPS
    return 0.0


def main(cfg: RunConfig, device="cuda"):
    """Decode the test split; returns counts, timings and the log paths."""
    dev = resolve_device(device)
    logger = setup_logger("slam_llm_tpu_torch", log_file=cfg.log_config.log_file)
    set_seed(cfg.train_config.seed)
    cfg.dataset_config.inference_mode = True

    model, tokenizer, dataset = build_model_and_data(cfg, split=cfg.dataset_config.test_split, device=dev)
    model.eval()
    t0 = time.perf_counter()
    materialize_params(model, cfg)
    load_s = time.perf_counter() - t0
    loader = decode_loader(cfg, dataset)

    gen_cfg = generation_config(cfg, tokenizer)
    generator = Generator(model, gen_cfg)
    sampler = torch.Generator(device=dev).manual_seed(cfg.train_config.seed)
    nrs = (
        min(max(1, gen_cfg.num_return_sequences), gen_cfg.num_beams)
        if gen_cfg.num_beams > 1 and not gen_cfg.do_sample
        else 1
    )

    pred_path, gt_path = cfg.decode_config.decode_log + "_pred", cfg.decode_config.decode_log + "_gt"
    n, n_tokens, t_total, audio_s = 0, 0, 0.0, 0.0
    with open(pred_path, "w", encoding="utf-8") as f_pred, open(gt_path, "w", encoding="utf-8") as f_gt:
        for batch in loader:
            t0 = time.perf_counter()
            tokens = generator.generate(
                {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}, generator=sampler
            )
            tokens = strip_after_eos(tokens, gen_cfg.eos_token_id, gen_cfg.pad_token_id)
            t_total += time.perf_counter() - t0
            n_tokens += int((tokens != gen_cfg.pad_token_id).sum())
            for i, (key, target) in enumerate(zip(batch["keys"], batch["targets"])):
                for j in range(nrs):
                    f_pred.write(f"{key}\t{tokenizer.decode(tokens[i * nrs + j])}\n")
                f_gt.write(f"{key}\t{target}\n")
                n += 1
            audio_s += batch_audio_seconds(batch)
    rtf = t_total / audio_s if audio_s else float("nan")
    logger.info("decoded %d utts in %.1fs (RTF=%.4f) on %s -> %s (weights materialized in %.2f s)",
                n, t_total, rtf, dev, pred_path, load_s)
    return {
        "n": n, "seconds": t_total, "rtf": rtf, "audio_seconds": audio_s, "load_seconds": load_s,
        "generated_tokens": n_tokens, "pred": pred_path, "gt": gt_path, **generator.stats,
    }


def main_cli(argv: Optional[List[str]] = None):
    argv, device = parse_device(list(sys.argv[1:] if argv is None else argv))
    return main(load_run_config(argv), device=device)


if __name__ == "__main__":
    main_cli()
