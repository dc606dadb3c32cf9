"""Training entry point: train split -> steps -> validation -> checkpoint.

Counterpart of ``slam_llm_tpu/pipeline/finetune.py`` with the same
``--config`` + ``++key=value`` surface, plus ``--device`` (default ``cuda``;
asking for CUDA without a GPU raises). One process, one device:

    python -m slam_llm_tpu_torch.pipeline.finetune \\
        --config examples/asr_librispeech/conf/asr_whisper_tinyllama.yaml \\
        ++dataset_config.train_data_path=train.jsonl ++dataset_config.val_data_path=val.jsonl \\
        ++train_config.max_steps_per_epoch=10 ++train_config.output_dir=/tmp/out

Weights come from ``pipeline.common.materialize_params``: the seeded random
init, then the HF checkpoints of ``++model_config.llm_path=<dir>`` /
``++model_config.encoder_path=<dir>``, then the trainable tensors of
``++ckpt_path=<checkpoint dir, model.pt or model.msgpack>``. With
``++train_config.freeze_encoder=false`` the encoder trains as well, in f32
masters, and ``model.pt`` carries it (an f32 encoder's attention then
takes K1's and K4's f32 routes on the card). ``resume_from`` (a
checkpoint directory or its ``full_state.pt``) restores the trainable
tensors, the optimizer state and the step that ``save_optimizer`` wrote;
``run_test_during_validation`` decodes ``run_test_during_validation_file``
greedily after every validation and logs the text.

Several cards: one process per card under torchrun, the mesh from
``train_config.shard`` (``dp`` / ``fsdp`` / ``tp``; ``dp=-1`` takes the rest
of the world), NCCL on ``cuda:LOCAL_RANK`` (gloo with ``--device cpu``):

    torchrun --nproc_per_node=4 -m slam_llm_tpu_torch.pipeline.finetune \\
        --config examples/s2s/conf/s2s_qwen.yaml ++train_config.shard.fsdp=2 \\
        ++train_config.shard.tp=2 ...

Every rank builds the same whole model from ``train_config.seed``, loads the
same checkpoints, and the trainer shards it (``parallel.shard_params``: every
module the reference annotates with ``heads`` / ``mlp`` / ``vocab`` split
over ``tp``, Megatron-style, then FSDP2 over ``dp`` x ``fsdp``); every rank
iterates the same seeded loader, whose ``batch_size_training`` is the global
batch, and keeps its data rank's rows
of each batch (the tp ranks of a data rank share them). Rank 0 logs and
writes the checkpoints, which hold whole tensors. A run without torchrun's
environment is the one-device run; there a mesh of more than one process
raises ``ValueError``. VALL-E X splits over tp as the reference's logical
rules split it (``--config examples/vallex/conf/vallex_tts.yaml
++train_config.shard.tp=2``).
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

from slam_llm_tpu_torch.config import RunConfig, load_run_config
from slam_llm_tpu_torch.data.loader import build_dataloader
from slam_llm_tpu_torch.inference.generate import GenerationConfig, Generator, strip_after_eos
from slam_llm_tpu_torch.parallel.sharding import INT8_BASE_TENSORS, local_part, unsharded
from slam_llm_tpu_torch.pipeline.common import (
    build_mesh,
    destroy_process_group,
    build_model_and_data,
    encode_one,
    materialize_params,
    maybe_init_distributed,
    parse_device,
    resolve_device,
    set_seed,
)
from slam_llm_tpu_torch.registry import get_custom_dataset_factory
from slam_llm_tpu_torch.train.loop import train
from slam_llm_tpu_torch.train.optimizer import count_params
from slam_llm_tpu_torch.train.state import Trainer
from slam_llm_tpu_torch.utils.checkpoint import load_state
from slam_llm_tpu_torch.utils.logging_utils import setup_logger


def build_decode_hook(cfg: RunConfig, model, tokenizer):
    """The reference's ``run_test_during_validation`` hook: greedy decode of
    one wav with ``decode_config.max_new_tokens``; None without a file."""
    tc = cfg.train_config
    if not (tc.run_test_during_validation and tc.run_test_during_validation_file):
        return None
    if cfg.model_config.encoder_name not in (None, "whisper"):
        # the one-wav batch is whisper mel: fail at start-up, not at the first validation
        raise ValueError(
            "run_test_during_validation supports mel (whisper) recipes; encoder "
            f"{cfg.model_config.encoder_name!r} needs its dataset pipeline: decode with "
            "pipeline.inference_batch instead"
        )
    from slam_llm_tpu_torch.data.speech_dataset import DEFAULT_PROMPT

    dc = cfg.decode_config
    gen = Generator(model, GenerationConfig(
        max_new_tokens=dc.max_new_tokens, num_beams=1, eos_token_id=tokenizer.eos_token_id,
        pad_token_id=tokenizer.pad_token_id, bos_token_id=tokenizer.bos_token_id,
    ))
    batch = encode_one(
        tc.run_test_during_validation_file,
        tc.run_test_during_validation_prompt or cfg.dataset_config.prompt or DEFAULT_PROMPT,
        tokenizer, cfg.dataset_config, ds_rate=cfg.model_config.encoder_projector_ds_rate,
    )

    def decode_hook(trainer: Trainer) -> str:
        # every rank decodes the same wav on the gathered model (rank 0 logs it)
        trainer.model.eval()
        with unsharded(trainer.model):
            toks = strip_after_eos(gen.generate(batch), tokenizer.eos_token_id, tokenizer.pad_token_id)
        return tokenizer.decode(toks[0])

    return decode_hook


def main(cfg: RunConfig, device="cuda"):
    """Train on the train split; returns the loop's results (step metrics,
    validations, checkpoint paths) plus the trainer, the seconds that
    ``materialize_params`` took (``load_seconds``) and this rank's bytes of
    the int8 base (``base_bytes``)."""
    maybe_init_distributed(device)
    dev = resolve_device(device)
    logger = setup_logger("slam_llm_tpu_torch", log_file=cfg.log_config.log_file)
    mesh = build_mesh(cfg, dev)
    tc = cfg.train_config
    set_seed(tc.seed)

    model, tokenizer, train_ds = build_model_and_data(cfg, split=cfg.dataset_config.train_split, device=dev,
                                                      mesh=mesh)
    dc = cfg.dataset_config
    # the SELD manifests' {qa_data_root}/{stage}/val.json, or E-chat's 90 / 10 split of one data_path
    has_val_source = dc.val_data_path or getattr(dc, "qa_data_root", None) or getattr(dc, "data_path", None)
    eval_ds = None
    if tc.run_validation and has_val_source:
        eval_ds = get_custom_dataset_factory(cfg.dataset_config)(cfg.dataset_config, tokenizer, "validation")
    train_loader = build_dataloader(
        train_ds, tc.batch_size_training, shuffle=True,
        num_workers=cfg.dataset_config.num_workers, prefetch=cfg.dataset_config.prefetch,
        seed=tc.seed, worker_type=cfg.dataset_config.worker_type,
    )
    eval_loader = (
        build_dataloader(eval_ds, tc.val_batch_size, shuffle=False, drop_last=False)
        if eval_ds is not None else None
    )

    t0 = time.perf_counter()
    # under a mesh: straight into this rank's shards, as the trainer prepares them
    materialize_params(model, cfg, mesh=mesh, device=dev, train=True)
    load_s = time.perf_counter() - t0
    trainer = Trainer(model, model.cfg, tc, mesh=mesh).state_from_params()
    if tc.resume_from:
        logger.info("resuming the full state (trainable tensors, optimizer, step) from %s", tc.resume_from)
        trainer.load_state_dict(load_state(tc.resume_from))
    # the int8 base: buffers on one device, frozen parameters (this rank's shards) under a mesh
    base = [t for name, t in [*model.named_parameters(), *model.named_buffers()]
            if name.rsplit(".", 1)[-1] in INT8_BASE_TENSORS]
    base_bytes = sum(local_part(t).numel() * t.element_size() for t in base)
    logger.info("params: trainable=%.2fM frozen=%.2fM on %s, materialized in %.2f s; the int8 base holds %.1f MB "
                "on this rank%s", count_params(trainer.trainable) / 1e6, count_params(trainer.frozen) / 1e6, dev,
                load_s, base_bytes / 1e6, "" if mesh is None else f" (mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))})")
    results = train(trainer, train_loader, eval_loader, train_config=tc, log_config=cfg.log_config,
                    decode_hook=build_decode_hook(cfg, model, tokenizer))
    logger.info("training done: best_val_loss=%s checkpoints=%s",
                results.get("best_val_loss"), results.get("checkpoints"))
    results["trainer"], results["load_seconds"], results["base_bytes"] = trainer, load_s, base_bytes
    return results


def main_cli(argv: Optional[List[str]] = None):
    argv, device = parse_device(list(sys.argv[1:] if argv is None else argv))
    try:
        return main(load_run_config(argv), device=device)
    finally:
        destroy_process_group()


if __name__ == "__main__":
    main_cli()
