"""The (dp, fsdp, tp) mesh on ``torch.distributed``: FSDP2 over the data axes.

Counterpart of ``slam_llm_tpu/parallel/sharding.py``. The reference lays one
GSPMD mesh ``(dp, fsdp, tp)`` over its devices and lets XLA insert the
all-gathers and reduce-scatters; the port runs one process per card and
writes them with FSDP2 (``fully_shard``) on a ``DeviceMesh`` of the same
axes:

* ``make_mesh`` builds the mesh over the process group; ``dp=-1`` absorbs
  ``world // (fsdp * tp)``. A mesh that does not equal the world raises,
  smaller ones included: the reference's silent truncation to the leading
  devices is not copied.
* ``shard_params`` first splits the model over ``tp``
  (``parallel.tensor_parallel.split_for_tp``: a Megatron-style split of
  every module the reference annotates with ``heads`` / ``mlp`` / ``vocab``:
  the decoder LLM, S2S's heads past it, the encoders' transformer layers,
  the projectors and VALL-E X; conv frontends, stems, positions and norms
  replicated over tp), then
  applies ``fully_shard`` over the 2-D ``("dp", "fsdp")``
  sub-mesh (HSDP: replicated over ``dp``, sharded over ``fsdp``, as the
  reference's ``embed -> fsdp`` rule shards every parameter on ``fsdp`` and
  none on ``dp``) to each layer of the model's layer lists, then to the
  root. The int8 base (``kernel_q`` / ``kernel_scale`` and the derived
  ``int8_rot`` / ``int8_sr`` tensors, the ``ce_quant`` head) becomes frozen
  parameters first (the int8 ones carried in a one-byte float dtype), so
  FSDP2 shards it as the reference's ``embed`` axis does; so does
  ``bwd_pretranspose``'s ``kernel_t``, derived from the rank's own shard
  after the tp split, as the reference shards it by its reversed axes. Gradients are summed, not averaged, over the ranks: each rank's
  loss is already its share of the global mean (``token_count``).
* ``shard_batch`` keeps rank ``r``'s rows ``[r B/n, (r+1) B/n)`` of the
  global batch, ``n = dp * fsdp``, ``r`` the data rank: the tp ranks of one
  data rank share its rows.
* ``token_count`` is the loss denominator: the count of valid tokens of the
  whole global batch, all-reduced over the data ranks inside
  ``global_loss``, so a rank's loss is its own NLL sum over the global
  count and the ranks' losses sum to the reference's mean. Under tp the
  data ranks' group is ``data_group`` (one per tp index).
* whole tensors: ``ShardLayout`` gathers a trainable tensor (or its
  optimizer state) over its FSDP placements, then over tp along its split
  dim, and takes a whole one apart in the reverse order, so checkpoints hold
  whole tensors and resume at any ``(dp, fsdp, tp)``; ``NormGroups`` sums a
  gradient norm's squares over the ranks that hold distinct parts.
* a decode sharded over ``fsdp`` (``sharded_decode``): FSDP2 gathers each
  layer unit around its forward and reshards it after, so no rank holds a
  whole replica; the root unit (embeddings, final norm, heads, projector,
  the encoders' stems) is gathered once for a decode call. The data ranks
  step in lockstep: every stop test is global (``all_running``), as the
  reference's ``lax.while_loop`` over a sharded batch is.
"""

from __future__ import annotations

import contextlib
import logging
import sys
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from slam_llm_tpu_torch.parallel.tensor_parallel import (
    TP,
    Split,
    gather_shard,
    narrow_shard,
    replicated_modules,
    split_for_tp,
    tp_of,
)

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


_DATA_GROUPS: Dict[Tuple[int, ...], Any] = {}


def data_group(mesh):
    """The process group of the ``dp * fsdp`` data ranks that share this
    rank's tp index (the world where tp is 1): the group the loss sums and
    metrics reduce over. Every rank creates every such group, in one order."""
    tp = mesh["tp"].size()
    if tp == 1:
        return dist.group.WORLD
    key = tuple(mesh.mesh.flatten().tolist())
    if key not in _DATA_GROUPS:
        ranks = mesh.mesh.reshape(-1, tp)
        groups = [dist.new_group(ranks[:, t].tolist()) for t in range(tp)]
        _DATA_GROUPS[key] = groups[mesh["tp"].get_local_rank()]
    return _DATA_GROUPS[key]


def replicated(mesh) -> Tuple:
    """The placements of a tensor held whole on every rank of ``mesh``."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * mesh.ndim


def layer_units(model: nn.Module) -> List[nn.Module]:
    """The modules ``shard_params`` shards one by one: the entries of every
    ``nn.ModuleList`` named ``layers`` / ``blocks`` / ``layer`` (or ending in
    ``_layers`` / ``_blocks``) that holds no such list itself (the decoder
    layers, each encoder's blocks), and the S2S TTS adapter's blocks
    (``tts_adapter_blocks``: attributes of their own, not a list). The S2S
    heads stay in the root unit: the vocab-parallel loss reads the LLM
    head's rows outside its forward."""

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
    return units + list(getattr(model, "tts_adapter_blocks", ()))


def derived_as_parameters(model: nn.Module) -> None:
    """Re-register the derived frozen buffers (the int8 base's
    ``INT8_BASE_TENSORS`` and ``bwd_pretranspose``'s ``kernel_t``) as frozen
    parameters, in place, so FSDP2 shards them on dim 0 in their dense's
    unit; the int8 ones as ``INT8_CARRIER`` views of the same bytes. Derive
    them (``ops.quant.quantize_base_params``,
    ``models.layers.refresh_pretransposed``) first."""
    for mod in model.modules():
        for name in (*INT8_BASE_TENSORS, "kernel_t"):
            t = mod._buffers.get(name)
            if t is None:
                continue
            del mod._buffers[name]
            mod._non_persistent_buffers_set.discard(name)
            carried = t.view(INT8_CARRIER) if t.dtype == torch.int8 else t
            mod.register_parameter(name, nn.Parameter(carried, requires_grad=False))


def shard_params(model: nn.Module, mesh) -> nn.Module:
    """Split the model over ``tp`` (``split_for_tp``, after
    ``quantize_base_params``: the int8 base is quantized whole, then
    split), derive ``kernel_t`` from each rank's shard, then ``fully_shard`` each
    layer unit and the root over the ``("dp", "fsdp")`` sub-mesh; gradients
    are summed over the data ranks. A tp mesh with one data rank takes no
    FSDP2: it would shard nothing, and its hooks cost host time a step."""
    from torch.distributed.fsdp import FSDPModule, fully_shard

    from slam_llm_tpu_torch.models.layers import refresh_pretransposed  # models import this package

    split = split_for_tp(model, mesh)
    refresh_pretransposed(model)  # the transpose of this rank's shard
    if split:
        logging.getLogger("slam_llm_tpu_torch").info(
            "tensor parallel tp=%d: split %s; replicated %s", mesh["tp"].size(),
            split, replicated_modules(model))
        if data_size(mesh) == 1:
            return model
    data_mesh = mesh["dp", "fsdp"]
    derived_as_parameters(model)
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
    tensors and back, by the parameters they belong to (their FSDP
    placements, then their tp split dims, ``tp_dims``, None where whole over
    tp), so its saved state is whole at any mesh."""

    def __init__(self, params: Sequence[torch.Tensor], tp_dims: Optional[Sequence[Optional[Split]]] = None,
                 tp: Optional[TP] = None):
        self.params = list(params)
        self.tp_dims = list(tp_dims) if tp_dims is not None else [None] * len(self.params)
        self.tp = tp

    def whole(self, i: int, t: torch.Tensor) -> torch.Tensor:
        t = full_tensor(t, self.params[i])
        dim = self.tp_dims[i]
        return t if dim is None or self.tp is None else gather_shard(t, dim, self.tp)

    def local(self, i: int, t: torch.Tensor) -> torch.Tensor:
        dim = self.tp_dims[i]
        if dim is not None and self.tp is not None:
            t = narrow_shard(t, dim, self.tp)
        return local_shard(t, self.params[i])

    def split(self) -> Tuple[bool, ...]:
        """Whether each tensor is split over tp."""
        return tuple(dim is not None and self.tp is not None for dim in self.tp_dims)


class NormGroups(NamedTuple):
    """What a sharded gradient norm sums over: every tensor's squares over
    the ``fsdp`` ranks; a tensor split over tp (``split``) also over the tp
    ranks, one replicated over tp once (tp rank 0's)."""

    fsdp: Any
    tp: TP
    split: Tuple[bool, ...]

    def square_sum(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        zero = torch.zeros((), dtype=torch.float32, device=grads[0].device if grads else None)
        parts = [sum((g.float().square().sum() for g, s in zip(grads, self.split) if s == want), zero)
                 for want in (True, False)]
        if self.tp.rank:
            parts[1] = torch.zeros_like(parts[1])
        sq = torch.stack(parts)
        dist.all_reduce(sq, group=self.fsdp)
        dist.all_reduce(sq, group=self.tp.group)
        return sq.sum()


def norm_groups(mesh, layout: ShardLayout):
    """The optimizer's ``norm_group``: the fsdp group, or ``NormGroups``
    under tp."""
    tp = tp_of(mesh)
    if tp is None:
        return mesh["fsdp"].get_group()
    return NormGroups(mesh["fsdp"].get_group(), tp, layout.split())


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


def under_fsdp(model: nn.Module) -> bool:
    """Whether ``model`` is an FSDP2 unit. A model ``shard_params`` sharded
    has imported ``torch.distributed.fsdp``; a one-process decode does not
    import it (seconds on the first call), so it is looked up, not imported."""
    fsdp = sys.modules.get("torch.distributed.fsdp")
    return fsdp is not None and isinstance(model, fsdp.FSDPModule)


# the decode entry points of the models, run as forward methods of FSDP2's root
DECODE_METHODS = ("prefill", "decode_step", "prefill_tts", "decode_step_tts")


@contextlib.contextmanager
def sharded_decode(model: nn.Module) -> Iterator[None]:
    """Around one decode call of a model sharded by ``shard_params``: every
    layer unit stays sharded except around its own forward, and the root
    unit's parameters are gathered once. FSDP2 runs its hooks around
    ``forward`` only, and a decode enters through the model's
    ``DECODE_METHODS``: on first use they are registered as forward methods
    of the root (``register_fsdp_forward_method``), so the root's hooks open
    every call (a layer unit reached first would be initialised as the root
    and keep its parameters gathered). The root's parameters (embeddings,
    final norm, heads, projector, the encoder's stem) are read by every
    prefill and step and between them (S2S's ``split_logits``): the root
    does not reshard after its forward during the call (FSDP2's own choice
    for the root in training) and is resharded at its end. A no-op on a
    model without FSDP2."""
    if not under_fsdp(model):
        yield
        return
    from torch.distributed.fsdp import register_fsdp_forward_method

    if not getattr(model, "_decode_methods_registered", False):
        for name in DECODE_METHODS:
            if hasattr(model, name):
                register_fsdp_forward_method(model, name)
        model._decode_methods_registered = True
    model.set_reshard_after_forward(False, recurse=False)
    try:
        yield
    finally:
        model.reshard()
        # FSDP2 records each unit's forward for the backward's prefetch and
        # clears the record after a backward; a decode runs none, so the
        # record would grow with every call
        order = getattr(getattr(model._get_fsdp_state(), "_comm_ctx", None), "post_forward_order", None)
        if order is None:
            raise RuntimeError(f"FSDP2's forward record (_comm_ctx.post_forward_order) is not in torch "
                               f"{torch.__version__}: sharded_decode cannot clear it after a decode")
        order.clear()


def all_running(running: bool, mesh, device) -> bool:
    """The lockstep stop test of a sharded decode: whether any data rank
    (``data_group(mesh)``: the ranks whose FSDP2 gathers this rank joins)
    still runs, given this rank's ``running``; ``running`` itself without a
    mesh (no collective, no tensor)."""
    if mesh is None:
        return running
    flag = torch.tensor([int(running)], dtype=torch.int32, device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=data_group(mesh))
    return bool(flag.item())


def all_reduce_sum(values: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """The f32 sums of scalar tensors over ``group`` (one collective)."""
    v = torch.stack([t.detach().float().reshape(()) for t in values])
    dist.all_reduce(v, group=group)
    return list(v.unbind(0))
