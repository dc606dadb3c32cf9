"""The epoch / step training loop.

Counterpart of ``slam_llm_tpu/train/loop.py``: the epoch loop with a
per-epoch step cap (``max_steps_per_epoch``), metrics every
``log_interval`` steps, validation every ``validation_interval`` steps and
at the end (each followed by ``decode_hook``'s text, the reference's
``run_test_during_validation``), and a checkpoint named
``{model_name}_epoch_{e}_step_{s}`` whenever the validation loss improves
(or once at the end without validation): the trainable tensors in
``model.pt`` and, with ``save_optimizer``, the full state in
``full_state.pt``. Steps count micro-steps under gradient accumulation, as
in the reference. The logger is ``utils/logging_utils.py``'s
``MetricsLogger``. Each epoch sets the sampler's epoch, so the batch order
is drawn anew (``seed + epoch``). With ``log_config.profile_dir``, steps
``[profile_start, profile_start + profile_steps)`` of this run, counted
across epochs, are traced with ``torch.profiler`` (the host, and the card
when the model is on one) into a Chrome trace in that directory.

Under a mesh every rank takes the same steps on the same global batches;
the step metrics and validations are the global batch's (the trainer
all-reduces the sums), every rank runs ``decode_hook`` (on the gathered
model), and rank 0 alone logs, profiles and writes the checkpoints, whose
tensors every rank helps gather whole.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np

from slam_llm_tpu_torch.parallel.sharding import data_size
from slam_llm_tpu_torch.train.state import Trainer
from slam_llm_tpu_torch.utils.checkpoint import save_state, save_trainable
from slam_llm_tpu_torch.utils.logging_utils import MemoryTrace, MetricsLogger, process_rank


def _first_array(batch: Dict) -> np.ndarray:
    """The batch's first array: not every recipe batches on ``input_ids``
    (VALL-E X batches ``text_ids`` / ``audio_ids``)."""
    return next(v for v in batch.values() if isinstance(v, np.ndarray) and v.ndim)


def _batch_size(batch: Dict) -> Dict[str, Any]:
    """The logged shape (the first array's) and the attended tokens: the
    ``attention_mask``'s, else VALL-E X's ``text_mask`` and ``audio_mask``."""
    if "attention_mask" in batch:
        tokens = int(batch["attention_mask"].sum())
    else:
        tokens = int(batch["text_mask"].sum()) + int(batch["audio_mask"].sum())
    return {"shape": tuple(_first_array(batch).shape), "tokens": tokens}


def pad_rows(batch: Dict, n: int) -> Dict:
    """A ragged batch (the eval loader's last) filled up to a multiple of
    ``n`` rows with copies of its last row whose labels are all ignored, so
    it splits over ``n`` ranks and the padding adds no token to any sum."""
    rows = len(_first_array(batch))
    extra = -rows % n
    if not extra:
        return batch
    if "labels" not in batch:
        raise ValueError(f"a batch of {rows} rows without labels cannot be padded to split over {n} ranks")
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.ndim and v.shape[0] == rows:
            tail = np.repeat(v[-1:], extra, axis=0)
            if k == "labels":
                tail = np.full_like(tail, -100)
            v = np.concatenate([v, tail])
        out[k] = v
    return out


def evaluate(trainer: Trainer, eval_loader) -> Dict[str, float]:
    """Batch-size-weighted mean loss and accuracy over the eval loader (each
    batch's loss and accuracy are the whole batch's on every rank)."""
    losses, accs, weights = [], [], []
    for batch in eval_loader:
        rows = batch if trainer.mesh is None else pad_rows(batch, data_size(trainer.mesh))
        m = trainer.eval_step(trainer.put_batch(rows))
        losses.append(float(m["loss"]))
        accs.append(float(m["acc"]))
        weights.append(len(_first_array(batch)))
    if not losses:
        return {"loss": float("inf"), "acc": 0.0, "ppl": float("inf")}
    loss = float(np.average(losses, weights=weights))
    acc = float(np.average(accs, weights=weights))
    return {"loss": loss, "acc": acc, "ppl": float(np.exp(min(loss, 50.0)))}


class _ProfileWindow:
    """The reference's ``jax.profiler`` window with ``torch.profiler``:
    ``before_step(n)`` starts the trace before step ``start`` of the run and
    stops it before step ``start + steps``; ``close()`` stops a trace still
    open when training ends. Each stop writes ``trace_steps_<a>-<b>.json``
    into ``directory`` and logs its path."""

    def __init__(self, log_config, device, logger):
        self.dir = getattr(log_config, "profile_dir", None) if log_config is not None and process_rank() == 0 else None
        self.start = int(getattr(log_config, "profile_start", 3) or 3)
        self.steps = int(getattr(log_config, "profile_steps", 5) or 5)
        self.device, self.logger = device, logger
        self.prof = None
        self.traces = []

    def before_step(self, n: int) -> None:
        if self.dir is None:
            return
        if n == self.start and self.prof is None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
            self.prof = profile(activities=acts)
            self.prof.start()
        elif self.prof is not None and n == self.start + self.steps:
            self.close(n)

    def close(self, n: int) -> None:
        if self.prof is None:
            return
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        path = Path(self.dir) / f"trace_steps_{self.start}-{n}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(path))
        self.prof = None
        self.traces.append(str(path))
        self.logger.info("wrote torch.profiler trace of steps [%d, %d) to %s", self.start, n, path)


def train(trainer: Trainer, train_loader, eval_loader=None, train_config=None, log_config=None,
          decode_hook: Optional[Callable[[Trainer], str]] = None) -> Dict[str, Any]:
    """Returns epoch times, checkpoint paths, the final validation, the best
    validation loss, the texts ``decode_hook`` returned, the profiler traces
    written, and ``steps``: for every logged step its metrics, its wall time
    in seconds (measured when it logs, which waits for the device), the
    shape of the batch's first array and its count of attended tokens."""
    tc = train_config or trainer.train_config
    logger = MetricsLogger(log_config, tc) if log_config is not None else MetricsLogger(
        type("L", (), {"use_wandb": False, "log_file": None})()
    )
    best_val_loss = float("inf")
    results: Dict[str, Any] = {"epoch_times": [], "checkpoints": [], "steps": [], "decoded": []}
    window = _ProfileWindow(log_config, trainer.device, logger.logger)
    steps_seen = 0

    def validate() -> Dict[str, float]:
        val = evaluate(trainer, eval_loader)
        logger.log(val, step, prefix="valid")
        if decode_hook is not None:
            results["decoded"].append(decode_hook(trainer))
            logger.logger.info("validation decode: %s", results["decoded"][-1])
        return val

    step = trainer.step
    last_val = None  # (step, metrics) of the latest mid-epoch validation
    log_interval = getattr(tc, "log_interval", 5)

    for epoch in range(tc.num_epochs):
        with MemoryTrace() as mem:
            t_epoch = time.perf_counter()
            sampler = getattr(train_loader, "sampler", None)
            if hasattr(sampler, "set_epoch"):
                sampler.set_epoch(epoch)
            epoch_steps = 0
            for batch in train_loader:
                window.before_step(steps_seen)
                t0 = time.perf_counter()
                metrics = trainer.train_step(trainer.put_batch(batch))
                step += 1
                steps_seen += 1
                if step % log_interval == 0:
                    metrics = {k: float(v) for k, v in metrics.items()}  # waits for the device
                    results["steps"].append({
                        "step": step, "seconds": time.perf_counter() - t0, **metrics, **_batch_size(batch),
                    })
                    logger.log(metrics, step)
                if tc.run_validation and eval_loader is not None and step % tc.validation_interval == 0:
                    val = validate()
                    last_val = (step, val)
                    if val["loss"] < best_val_loss and tc.save_model:
                        best_val_loss = val["loss"]
                        ckpt = _save_checkpoint(trainer, tc, epoch, step)
                        results["checkpoints"].append(ckpt)
                        logger.logger.info("new best val loss %.4f -> saved %s", val["loss"], ckpt)
                # per-epoch cap, counted from the start of this epoch
                epoch_steps += 1
                if 0 < tc.max_steps_per_epoch <= epoch_steps:
                    break
            results["epoch_times"].append(time.perf_counter() - t_epoch)
            logger.logger.info("epoch %d done in %.1f s %s", epoch, results["epoch_times"][-1], mem.stats())
    window.close(steps_seen)  # the loop ended inside the window
    results["traces"] = window.traces

    # end-of-training validation + final save
    if tc.run_validation and eval_loader is not None:
        if last_val is not None and last_val[0] == step:
            val = last_val[1]  # the last step just validated this state
        else:
            val = validate()
        results["final_val"] = val
        if tc.save_model and (val["loss"] < best_val_loss or not results["checkpoints"]):
            best_val_loss = min(best_val_loss, float(val["loss"]))
            results["checkpoints"].append(_save_checkpoint(trainer, tc, tc.num_epochs - 1, step))
    elif tc.save_model:
        results["checkpoints"].append(_save_checkpoint(trainer, tc, tc.num_epochs - 1, step))
    results["best_val_loss"] = best_val_loss
    return results


def _save_checkpoint(trainer: Trainer, tc, epoch: int, step: int) -> str:
    """Whole tensors (every rank joins the gathers); rank 0 writes."""
    out = Path(tc.output_dir) / f"{tc.model_name}_epoch_{epoch + 1}_step_{step}"
    tensors = trainer.whole_trainable()
    state = trainer.state_dict() if tc.save_optimizer else None
    if process_rank() == 0:
        save_trainable(str(out / "model.pt"), tensors)
        if state is not None:
            save_state(str(out), state)
    return str(out)
