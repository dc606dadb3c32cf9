"""Logging + metrics surface: console/file logger, optional wandb, and a
device-memory tracer (the reference's MemoryTrace, utils/memory_utils.py:13-61,
re-pointed at the CUDA caching allocator's stats + host RSS). Counterpart of
``slam_llm_tpu/utils/logging_utils.py``."""

from __future__ import annotations

import logging
import resource
import time
from typing import Any, Dict, Optional

_FORMAT = "[%(asctime)s][%(name)s][%(levelname)s] - %(message)s"


def setup_logger(name: str = "slam_llm_tpu", log_file: Optional[str] = None, level=logging.INFO):
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    if not logger.handlers:
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(sh)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(fh)
    return logger


class MetricsLogger:
    """rank0-gated scalar logging: console always, wandb when configured
    (reference utils/train_utils.py:120-147 surface: train_inner/*, valid/*)."""

    def __init__(self, log_config, train_config=None):
        self.cfg = log_config
        self.logger = setup_logger(log_file=getattr(log_config, "log_file", None))
        self.wandb = None
        if getattr(log_config, "use_wandb", False):
            try:
                import wandb

                self.wandb = wandb
                wandb.init(
                    dir=log_config.wandb_dir,
                    entity=log_config.wandb_entity_name or None,
                    project=log_config.wandb_project_name,
                    name=log_config.wandb_exp_name,
                    config=None if train_config is None else {"train": str(train_config)},
                )
            except Exception as e:  # wandb optional; never take down training
                self.logger.warning("wandb unavailable: %s", e)
                self.wandb = None

    def log(self, metrics: Dict[str, Any], step: int, prefix: str = "train_inner") -> None:
        flat = {f"{prefix}/{k}": float(v) for k, v in metrics.items()}
        self.logger.info("step %d %s", step, " ".join(f"{k}={v:.5g}" for k, v in flat.items()))
        if self.wandb is not None:
            self.wandb.log(flat, step=step)


class MemoryTrace:
    """Context manager reporting the card's memory peak + host RSS peak per
    epoch (the JAX package's key names; no device keys without a card)."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def stats(self) -> Dict[str, float]:
        import torch

        out: Dict[str, float] = {}
        if torch.cuda.is_available():
            out["hbm_in_use_gb"] = torch.cuda.memory_allocated() / 2**30
            out["hbm_peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
            out["hbm_limit_gb"] = torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory / 2**30
        out["host_rss_peak_gb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        out["elapsed_s"] = time.perf_counter() - self.t0
        return out

    def __exit__(self, *exc):
        return False
