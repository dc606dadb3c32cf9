"""Trainable-only checkpoints and full training states.

Counterpart of ``save_trainable`` / ``load_trainable`` /
``load_trainable_into`` / ``latest_checkpoint`` / ``save_state`` /
``restore_state`` in ``slam_llm_tpu/utils/checkpoint.py``:

* the trainable tensors (projector, LoRA factors) of a run, written with
  ``torch.save`` as ``{name: tensor}`` on the CPU in ``model.pt``;
* the JAX package's ``model.msgpack`` (flat ``encoder_projector/linear1/kernel``
  keys, the LLM's per-layer tensors stacked on a leading layer axis under
  ``llm/decoder/layers``, an unfrozen encoder's tensors in its own flax
  leaves, such as Spatial-AST's HWIO ``down_kernel``), read and written with
  the port's own codec (``utils.msgpack_codec``) and mapped through
  ``utils.convert``, the encoder's tensors by the encoder's own rules
  (``encoder_from_flax`` / ``encoder_to_flax``), so the encoder's name comes
  with the call: a ``SLAMConfig`` or the name itself;
* with ``save_optimizer`` the full state (trainable tensors, optimizer
  state, step) in ``full_state.pt`` beside ``model.pt``. The reference's
  Orbax full state stays JAX-only.

``load_trainable_into`` is the reference's partial load (``load_state_dict``
with ``strict=False``): every tensor in the file overwrites the model's
tensor of that name, the rest keep their values; a name the model lacks
raises ``KeyError``, a shape that differs ``ValueError``. Each value is
copied into the model's own tensor, so the f32 masters stay f32.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Dict, Optional, Union

import torch
from torch import nn

from slam_llm_tpu_torch.utils import msgpack_codec
from slam_llm_tpu_torch.utils.convert import encoder_from_flax, flax_to_state_dict, trainable_to_flax

FULL_STATE = "full_state.pt"
TRAINABLE_PT = "model.pt"
TRAINABLE_MSGPACK = "model.msgpack"


def save_trainable(path: str, tensors: Dict[str, torch.Tensor]) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({name: t.detach().cpu() for name, t in tensors.items()}, path)
    return path


def _encoder_name(encoder) -> Optional[str]:
    """The encoder name of a ``SLAMConfig`` (or of a name, or None)."""
    return encoder if encoder is None or isinstance(encoder, str) else encoder.encoder_name


def save_trainable_msgpack(path: str, tensors: Dict[str, torch.Tensor], encoder: Union[str, object, None] = None
                           ) -> str:
    """The trainable tensors as the JAX package's ``model.msgpack``: flat
    ``/``-joined keys of the flax layout (``utils.convert.trainable_to_flax``,
    ``encoder``'s tensors by its own rules), f32 arrays, which its
    ``load_trainable_into`` accepts."""
    flat: Dict[str, object] = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, prefix + [key])
            else:
                flat["/".join(prefix + [key])] = val

    walk(trainable_to_flax(tensors, _encoder_name(encoder)), [])
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack_codec.serialize(flat))
    return path


def resolve_trainable(path: str) -> str:
    """The trainable checkpoint ``path`` names: a directory's ``model.pt``,
    else its ``model.msgpack``; or a ``.pt`` / ``.msgpack`` file. A path that
    names none raises ``FileNotFoundError``."""
    if os.path.isdir(path):
        for name in (TRAINABLE_PT, TRAINABLE_MSGPACK):
            if os.path.isfile(os.path.join(path, name)):
                return os.path.join(path, name)
        raise FileNotFoundError(f"checkpoint directory {path} holds neither {TRAINABLE_PT} nor {TRAINABLE_MSGPACK}")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no trainable checkpoint at {path} (expected a directory, a .pt or a .msgpack)")
    return path


def load_trainable(path: str, encoder: Union[str, object, None] = None) -> Dict[str, torch.Tensor]:
    """``{state_dict name: CPU tensor}`` of a trainable checkpoint (see
    ``resolve_trainable``): the port's ``model.pt`` as written, or the JAX
    package's ``model.msgpack`` mapped onto the port's names and layouts,
    the ``encoder`` subtree by the rules of ``encoder`` (a ``SLAMConfig`` or
    an encoder name)."""
    path = resolve_trainable(path)
    if path.endswith(".msgpack"):
        with open(path, "rb") as f:
            flat = msgpack_codec.restore(f.read())
        tree: dict = {}
        for key, val in flat.items():
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = val.numpy() if val.dtype != torch.bfloat16 else val.float().numpy()
        out = flax_to_state_dict({k: v for k, v in tree.items() if k != "encoder"})
        if "encoder" in tree:
            enc = encoder_from_flax(tree["encoder"], _encoder_name(encoder))
            out.update({f"encoder.{k}": v for k, v in enc.items()})
        return out
    return torch.load(path, map_location="cpu", weights_only=True)


@torch.no_grad()
def load_trainable_into(model: nn.Module, path: str) -> nn.Module:
    """Partial load of a trainable checkpoint into ``model`` in place (the
    module docstring's semantics). Everything is checked before anything is
    copied, so a failed load leaves the model as it was. A JAX
    ``model.msgpack``'s encoder tensors are mapped by the rules of the
    model's own encoder."""
    saved = checked_trainable(model, path)
    targets = dict(model.state_dict(keep_vars=True))
    for name, val in saved.items():
        targets[name].copy_(val)
    return model


def checked_trainable(model: nn.Module, path: str) -> Dict[str, torch.Tensor]:
    """``load_trainable``'s tensors for ``model``, every name and shape
    checked against the model's (which may lie on ``meta``)."""
    saved = load_trainable(path, getattr(getattr(model, "cfg", None), "encoder_name", None))
    targets = dict(model.state_dict(keep_vars=True))
    unknown = sorted(set(saved) - set(targets))
    if unknown:
        raise KeyError(f"checkpoint keys not found in model: {unknown[:5]}{' ...' if len(unknown) > 5 else ''}")
    for name, val in saved.items():
        if tuple(val.shape) != tuple(targets[name].shape):
            raise ValueError(f"shape mismatch for {name}: {tuple(val.shape)} vs {tuple(targets[name].shape)}")
    return saved


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """The ``*_epoch_{e}_step_{s}`` directory under ``output_dir`` with the
    highest (epoch, step) in its name, not the newest by mtime: best-val
    checkpointing can write an older epoch's directory later, and copies
    scramble mtimes."""
    root = Path(output_dir)
    if not root.exists():
        return None

    def key(p: Path):
        m = re.search(r"_epoch_(\d+)_step_(\d+)", p.name)
        return (int(m.group(1)), int(m.group(2))) if m else (-1, -1)

    candidates = [p for p in root.iterdir() if p.is_dir() and key(p) != (-1, -1)]
    return str(max(candidates, key=key)) if candidates else None


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
