"""Trainable-only checkpoints and full training states.

Counterpart of ``save_trainable`` / ``save_state`` / ``restore_state`` in
``slam_llm_tpu/utils/checkpoint.py``: the trainable tensors (projector, LoRA
factors) of a run, written with ``torch.save`` as ``{name: tensor}`` on the
CPU in ``model.pt``; with ``save_optimizer`` also the reference's full state
(trainable tensors, optimizer state, step) in ``full_state.pt`` beside it.
The reference's ``model.msgpack`` and Orbax formats need flax; interop with
them is ROADMAP Queue 1.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

FULL_STATE = "full_state.pt"


def save_trainable(path: str, tensors: Dict[str, torch.Tensor]) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({name: t.detach().cpu() for name, t in tensors.items()}, path)
    return path


def save_state(ckpt_dir: str, state: Dict) -> str:
    """Write ``state`` (``Trainer.state_dict()``) to ``ckpt_dir/full_state.pt``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, FULL_STATE)
    torch.save(state, path)
    return path


def load_state(path: str) -> Dict:
    """A full state from a checkpoint directory or its ``full_state.pt``
    (as the reference's ``resume_from`` takes the directory or its
    ``full_state``)."""
    if os.path.isdir(path):
        path = os.path.join(path, FULL_STATE)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no full training state at {path} (was the run saved with save_optimizer?)")
    return torch.load(path, map_location="cpu", weights_only=True)
