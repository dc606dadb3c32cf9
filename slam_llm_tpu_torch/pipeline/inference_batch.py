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

Several cards: ``torchrun --nproc_per_node=N -m
slam_llm_tpu_torch.pipeline.inference_batch ...`` runs one process per card
(NCCL, or gloo with ``--device cpu``), as the reference's multi-host decode
does: each rank holds a whole replica and decodes a rank-strided share of
the batches (the ragged tail wraps around, so every batch is decoded by
some rank), writing ``{decode_log}_pred_rank{r}`` / ``_gt_rank{r}``; the
union of the logs is the one-process decode. With ``shard.tp=N`` the
model is split over tp (``parallel.tensor_parallel``: the decoder LLM, the
encoder's transformer layers, the projector): the batches are
shared out over the data ranks (``world / N``), the N tp ranks of one data
rank decode the same batches in lockstep (they see the same whole logits
and make the same choices), and tp rank 0 writes the data rank's logs
(``_rank{r}`` suffixes only with more than one data rank). With
``shard.fsdp=N`` the model is sharded as the trainer shards it
(``parallel.shard_params`` on the ``(dp, fsdp, tp)`` mesh: FSDP2 over the
data ranks after the tp split), so no rank holds a whole replica: each layer
unit is gathered around its forward only. The data ranks decode their own
batches in lockstep (every stop test is global, ``inference.generate``), and
the wrapped ragged tail gives every rank the same number of batches, so
their gathers pair up. Batch ``bi`` of data rank ``r`` samples from its own
stream, seeded from ``train_config.seed`` and ``bi + r * 100003``, as the
reference folds its key.

    torchrun --nproc_per_node=4 -m slam_llm_tpu_torch.pipeline.inference_batch --config <yaml> \\
        ++train_config.shard.fsdp=2 ++train_config.shard.tp=2 ...
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from slam_llm_tpu_torch.config import RunConfig, load_run_config
from slam_llm_tpu_torch.data.loader import build_dataloader
from slam_llm_tpu_torch.inference.generate import GenerationConfig, Generator, strip_after_eos
from slam_llm_tpu_torch.parallel.sharding import data_rank, data_size, make_mesh
from slam_llm_tpu_torch.pipeline.common import (
    build_model_and_data,
    destroy_process_group,
    materialize_params,
    maybe_init_distributed,
    parse_device,
    resolve_device,
    set_seed,
)
from slam_llm_tpu_torch.utils.logging_utils import setup_logger

VIDEO_FPS = 25.0  # AV-HuBERT's lip videos


def decode_loader(cfg: RunConfig, dataset, num_replicas: int = 1, rank: int = 0):
    """The test split in order, ``val_batch_size`` rows per batch; with
    ``num_replicas`` ranks, rank ``rank``'s every ``num_replicas``-th batch,
    the last round filled up by wrapping around to the first batches."""
    return build_dataloader(
        dataset, cfg.train_config.val_batch_size, shuffle=False, drop_last=False,
        num_workers=cfg.dataset_config.num_workers, prefetch=cfg.dataset_config.prefetch,
        num_replicas=num_replicas, rank=rank, ragged_tail="wrap",
    )


def batch_stream_seed(seed: int, index: int) -> int:
    """The seed of one batch's sampling stream: ``train_config.seed`` mixed
    with ``index`` (the reference's ``fold_in(PRNGKey(seed), index)``)."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint32)[0])


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
    """Decode the test split (this rank's share of it under torchrun);
    returns counts, timings and the log paths."""
    import torch.distributed as dist

    shard = cfg.train_config.shard
    maybe_init_distributed(device)
    dev = resolve_device(device)
    logger = setup_logger("slam_llm_tpu_torch", log_file=cfg.log_config.log_file)
    set_seed(cfg.train_config.seed)
    cfg.dataset_config.inference_mode = True
    world, rank, tp_rank = (dist.get_world_size(), dist.get_rank(), 0) if dist.is_initialized() else (1, 0, 0)
    mesh = None
    if shard.tp > 1 or shard.fsdp > 1:
        if not dist.is_initialized():
            raise ValueError(f"shard.fsdp={shard.fsdp} x shard.tp={shard.tp} needs {shard.fsdp * shard.tp} "
                             "processes or more (torchrun); this is one")
        mesh = make_mesh(dp=-1, fsdp=shard.fsdp, tp=shard.tp, device_type=dev.type)
        world, rank, tp_rank = data_size(mesh), data_rank(mesh), mesh["tp"].get_local_rank()

    model, tokenizer, dataset = build_model_and_data(cfg, split=cfg.dataset_config.test_split, device=dev,
                                                     mesh=mesh)
    model.eval()
    t0 = time.perf_counter()
    # under a mesh: straight into this rank's shards (the tp split, then FSDP2 over the data ranks with fsdp)
    materialize_params(model, cfg, mesh=mesh, device=dev)
    if shard.fsdp > 1:
        logger.info("sharded decode: fsdp=%d x tp=%d, %d data ranks in lockstep", shard.fsdp, shard.tp, world)
    load_s = time.perf_counter() - t0
    loader = decode_loader(cfg, dataset, num_replicas=world, rank=rank)

    gen_cfg = generation_config(cfg, tokenizer)
    generator = Generator(model, gen_cfg, mesh=mesh if shard.fsdp > 1 else None)
    nrs = (
        min(max(1, gen_cfg.num_return_sequences), gen_cfg.num_beams)
        if gen_cfg.num_beams > 1 and not gen_cfg.do_sample
        else 1
    )

    suffix = f"_rank{rank}" if world > 1 else ""
    pred_path = cfg.decode_config.decode_log + "_pred" + suffix
    gt_path = cfg.decode_config.decode_log + "_gt" + suffix
    if tp_rank:  # tp rank 0 writes the data rank's logs
        pred_path = gt_path = os.devnull
    n, n_tokens, t_total, audio_s = 0, 0, 0.0, 0.0
    with open(pred_path, "w", encoding="utf-8") as f_pred, open(gt_path, "w", encoding="utf-8") as f_gt:
        for bi, batch in enumerate(loader):
            t0 = time.perf_counter()
            sampler = torch.Generator(device=dev).manual_seed(
                batch_stream_seed(cfg.train_config.seed, bi + rank * 100003))
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
    try:
        return main(load_run_config(argv), device=device)
    finally:
        destroy_process_group()


if __name__ == "__main__":
    main_cli()
