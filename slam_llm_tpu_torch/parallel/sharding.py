"""The (dp, fsdp) mesh on ``torch.distributed``: FSDP2 over the data axes.

Counterpart of ``slam_llm_tpu/parallel/sharding.py``. The reference lays one
GSPMD mesh ``(dp, fsdp, tp)`` over its devices and lets XLA insert the
all-gathers and reduce-scatters; the port runs one process per card and
writes them with FSDP2 (``fully_shard``) on a ``DeviceMesh`` of the same
axes:

* ``make_mesh`` builds the mesh over the process group; ``dp=-1`` absorbs
  ``world // (fsdp * tp)``. A mesh that does not equal the world raises,
  smaller ones included: the reference's silent truncation to the leading
  devices is not copied.
* ``shard_params`` applies ``fully_shard`` over the 2-D ``("dp", "fsdp")``
  sub-mesh (HSDP: replicated over ``dp``, sharded over ``fsdp``, as the
  reference's ``embed -> fsdp`` rule shards every parameter on ``fsdp`` and
  none on ``dp``) to each layer of the model's layer lists, then to the
  root. The int8 base (``kernel_q`` / ``kernel_scale`` and the derived
  ``int8_rot`` / ``int8_sr`` tensors, the ``ce_quant`` head) becomes frozen
  parameters first (the int8 ones carried in a one-byte float dtype), so
  FSDP2 shards it as the reference's ``embed`` axis does. Gradients are summed, not averaged, over the ranks: each rank's
  loss is already its share of the global mean (``token_count``).
* ``shard_batch`` keeps rank ``r``'s rows ``[r B/n, (r+1) B/n)`` of the
  global batch, ``n = dp * fsdp``.
* ``token_count`` is the loss denominator: the count of valid tokens of the
  whole global batch, all-reduced over the data ranks inside
  ``global_loss``, so a rank's loss is its own NLL sum over the global
  count and the ranks' losses sum to the reference's mean.

Tensor parallelism (``tp > 1``) is not ported (ROADMAP Queue 1): with
hand-written kernels it needs a Megatron-style split of every model
family, not a sharding annotation.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

MESH_AXES = ("dp", "fsdp", "tp")

# the int8 base and the int8 CE head: buffers on one device, frozen
# parameters under FSDP2 (which shards parameters and leaves buffers whole)
INT8_BASE_TENSORS = ("kernel_q", "kernel_scale", "kernel_qr", "kernel_scale_r", "kernel_qt",
                     "head_q", "head_scale", "head_qt")
# FSDP2 (torch 2.11) creates every sharded parameter requiring grad, which an
# int8 tensor cannot: the int8 tensors ride as their bytes in a one-byte
# floating dtype of the same shape, which FSDP2 only copies; their readers
# take ``ops.quant.int8_of`` of them
INT8_CARRIER = torch.float8_e4m3fn

TP_NOT_PORTED = ("tensor parallelism (shard.tp > 1) is not ported yet (ROADMAP Queue 1: a Megatron-style "
                 "split of every model family and a vocab-parallel fused CE)")


def mesh_shape(dp: int, fsdp: int, tp: int, world: int) -> Tuple[int, int, int]:
    """``(dp, fsdp, tp)`` with ``dp=-1`` resolved against ``world``
    processes; a mesh that does not equal the world raises ``ValueError``
    (smaller or larger)."""
    if min(fsdp, tp, world) < 1 or dp == 0 or dp < -1:
        raise ValueError(f"mesh dp={dp} fsdp={fsdp} tp={tp}: sizes must be positive (dp may be -1)")
    if dp == -1:
        if world % (fsdp * tp):
            raise ValueError(f"{world} processes not divisible by fsdp*tp={fsdp * tp}")
        dp = world // (fsdp * tp)
    if dp * fsdp * tp != world:
        raise ValueError(f"mesh {dp}x{fsdp}x{tp} != {world} processes")
    return dp, fsdp, tp


def make_mesh(dp: int = -1, fsdp: int = 1, tp: int = 1, device_type: str = "cuda"):
    """The ``(dp, fsdp, tp)`` ``DeviceMesh`` over the initialized process
    group (``tp`` innermost, ``dp`` outermost, as the reference orders its
    axes)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = mesh_shape(dp, fsdp, tp, dist.get_world_size())
    return init_device_mesh(device_type, shape, mesh_dim_names=MESH_AXES)


def data_size(mesh) -> int:
    """``dp * fsdp``: the ranks the batch is split over."""
    return mesh["dp"].size() * mesh["fsdp"].size()


def data_rank(mesh) -> int:
    """This rank's place among the ``dp * fsdp`` batch shards."""
    return mesh["dp"].get_local_rank() * mesh["fsdp"].size() + mesh["fsdp"].get_local_rank()


def replicated(mesh) -> Tuple:
    """The placements of a tensor held whole on every rank of ``mesh``."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * mesh.ndim


def layer_units(model: nn.Module) -> List[nn.Module]:
    """The modules ``shard_params`` shards one by one: the entries of every
    ``nn.ModuleList`` named ``layers`` / ``blocks`` / ``layer`` (or ending in
    ``_layers`` / ``_blocks``) that holds no such list itself: the decoder
    layers, each encoder's blocks, the S2S adapter's blocks."""

    def is_list(name: str, mod: nn.Module) -> bool:
        leaf = name.rsplit(".", 1)[-1]
        return isinstance(mod, nn.ModuleList) and (
            leaf in ("layers", "blocks", "layer") or leaf.endswith(("_layers", "_blocks")))

    lists = [(n, m) for n, m in model.named_modules() if is_list(n, m)]
    units = []
    for name, lst in lists:
        if any(other != name and other.startswith(name + ".") for other, _ in lists):
            continue  # a list of stages that hold the blocks
        units += [m for m in lst if any(True for _ in m.parameters())]
    return units


def int8_base_as_parameters(model: nn.Module) -> None:
    """Re-register the int8 base's buffers (``INT8_BASE_TENSORS``) as frozen
    parameters, in place, so FSDP2 shards them on dim 0; the int8 ones as
    ``INT8_CARRIER`` views of the same bytes. Derive them
    (``ops.quant.quantize_base_params``) first."""
    for mod in model.modules():
        for name in INT8_BASE_TENSORS:
            t = mod._buffers.get(name)
            if t is None:
                continue
            del mod._buffers[name]
            mod._non_persistent_buffers_set.discard(name)
            carried = t.view(INT8_CARRIER) if t.dtype == torch.int8 else t
            mod.register_parameter(name, nn.Parameter(carried, requires_grad=False))


def shard_params(model: nn.Module, mesh) -> nn.Module:
    """``fully_shard`` each layer unit, then the root, over the ``("dp",
    "fsdp")`` sub-mesh; gradients are summed over the data ranks."""
    from torch.distributed.fsdp import FSDPModule, fully_shard

    if mesh["tp"].size() > 1:
        raise NotImplementedError(TP_NOT_PORTED)
    data_mesh = mesh["dp", "fsdp"]
    int8_base_as_parameters(model)
    for unit in layer_units(model):
        fully_shard(unit, mesh=data_mesh)
    fully_shard(model, mesh=data_mesh)
    for mod in model.modules():
        if isinstance(mod, FSDPModule):
            # the default divides by the data ranks; each rank's loss is
            # already its share of the global mean, so the sum is the
            # gradient: a plain SUM (gloo has no PREMUL_SUM), no division
            mod.set_gradient_divide_factor(1.0)
            if hasattr(mod, "set_force_sum_reduction_for_comms"):  # newer FSDP2
                mod.set_force_sum_reduction_for_comms(True)
    return model


def shard_batch(mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """Rank ``r``'s rows ``[r B/n, (r+1) B/n)`` of every array whose leading
    dimension is the batch's ``B`` (the first array's); other entries stay
    whole. ``B`` not divisible by ``n = dp * fsdp`` raises ``ValueError``."""
    n, r = data_size(mesh), data_rank(mesh)
    rows = next(v.shape[0] for v in batch.values() if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim)
    if rows % n:
        raise ValueError(f"global batch of {rows} rows does not split over dp*fsdp={n} ranks")
    per = rows // n
    return {k: v[r * per:(r + 1) * per] if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim and v.shape[0] == rows
            else v for k, v in batch.items()}


# ---- the global loss ----------------------------------------------------------

_LOSS_GROUP: List[Optional[Any]] = [None]


@contextlib.contextmanager
def global_loss(group) -> Iterator[None]:
    """Inside, ``token_count`` sums over ``group``'s ranks (the data ranks)."""
    prev, _LOSS_GROUP[0] = _LOSS_GROUP[0], group
    try:
        yield
    finally:
        _LOSS_GROUP[0] = prev


def token_count(mask: torch.Tensor) -> torch.Tensor:
    """The loss denominator: ``mask``'s sum (f32, at least 1) over the whole
    global batch, all-reduced over the data ranks inside ``global_loss``."""
    n = mask.float().sum()
    if _LOSS_GROUP[0] is not None:
        dist.all_reduce(n, group=_LOSS_GROUP[0])
    return n.clamp_min(1.0)


# ---- whole tensors and local shards -----------------------------------------


def local_part(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s local shard; a plain tensor itself."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def local_shard(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The part of the whole tensor ``full`` that this rank holds of the
    ``DTensor`` ``like`` (its placements' ``torch.chunk`` split, as FSDP2
    shards; dims past the sharded one may differ: a (V, 1) mask of a (V, D)
    table); ``full`` itself when ``like`` is a plain tensor."""
    from torch.distributed.tensor import DTensor

    if not isinstance(like, DTensor):
        return full
    t = full
    for i, place in enumerate(like.placements):
        if place.is_shard():
            chunks = torch.chunk(t, like.device_mesh.size(i), dim=place.dim)
            j = like.device_mesh.get_local_rank(i)
            t = chunks[j] if j < len(chunks) else t.narrow(place.dim, 0, 0)
    return t


def full_tensor(local: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The whole tensor of the local shard ``local`` laid out as ``like``
    (a collective every rank of its mesh joins); ``local`` itself when
    ``like`` is a plain tensor."""
    from torch.distributed.tensor import DTensor

    if not isinstance(like, DTensor):
        return local
    dt = DTensor.from_local(local, like.device_mesh, like.placements, shape=like.shape, stride=like.stride())
    return dt.full_tensor()


class ShardLayout:
    """Maps the optimizer's per-parameter tensors (local shards) to whole
    tensors and back, by the ``DTensor`` parameters they belong to, so its
    saved state is whole at any world size."""

    def __init__(self, params: Sequence[torch.Tensor]):
        self.params = list(params)

    def whole(self, i: int, t: torch.Tensor) -> torch.Tensor:
        return full_tensor(t, self.params[i])

    def local(self, i: int, t: torch.Tensor) -> torch.Tensor:
        return local_shard(t, self.params[i])


@contextlib.contextmanager
def unsharded(model: nn.Module) -> Iterator[None]:
    """Every FSDP unit's parameters gathered whole for the duration (each
    rank holds a whole replica: a decode runs no collective), then sharded
    again. A no-op on an unsharded model."""
    from torch.distributed.fsdp import FSDPModule

    units = [m for m in model.modules() if isinstance(m, FSDPModule)]
    for unit in units:
        unit.set_reshard_after_forward(False, recurse=False)
        unit.unshard()
    try:
        yield
    finally:
        for unit in units:
            unit.reshard()
            unit.set_reshard_after_forward(True, recurse=False)


def all_reduce_sum(values: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """The f32 sums of scalar tensors over ``group`` (one collective)."""
    v = torch.stack([t.detach().float().reshape(()) for t in values])
    dist.all_reduce(v, group=group)
    return list(v.unbind(0))
