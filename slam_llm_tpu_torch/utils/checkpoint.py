"""Trainable-only checkpoints.

Counterpart of ``save_trainable`` in ``slam_llm_tpu/utils/checkpoint.py``:
the trainable tensors (projector, LoRA factors) of a run, written with
``torch.save`` as ``{name: tensor}`` on the CPU. The reference's
``model.msgpack`` format needs flax; interop with it is ROADMAP Queue 4.
"""

from __future__ import annotations

import os
from typing import Dict

import torch


def save_trainable(path: str, tensors: Dict[str, torch.Tensor]) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({name: t.detach().cpu() for name, t in tensors.items()}, path)
    return path
