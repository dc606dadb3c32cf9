"""Activation checkpointing of decoder layers, with the reference's save policies.

Counterpart of ``nn.remat(DecoderLayer, policy=_remat_policy(name))`` in
``slam_llm_tpu/models/llm.py``: on the training path each decoder layer
keeps only its input and the tensors its policy names, and recomputes the
rest in the backward.

Route. The kernels (K1 flash forward, K2, K3) are ctypes calls inside
autograd Functions, which ``torch.utils.checkpoint``'s selective policies
cannot see: they see only dispatcher ops, so a per-op policy cannot tell a
dense output or the flash output from glue, and would rerun every kernel.
Registering every wrapper as a ``torch.library.custom_op`` would make them
visible at the price of a dispatcher round trip per call. Instead
``checkpoint_layer`` is one autograd Function per layer: its forward runs
the layer once without autograd and records on a ``Tape`` the tensors the
policy names, at the sites where the reference calls ``checkpoint_name``
(and at every matrix product for the ``dots_*`` policies); its backward
replays the layer with autograd on, where each site takes its value from
the tape instead of computing it, through a Function whose backward is
the site's own (``int8_dot(out=...)``, ``layers.linear(out=...)``,
``flash_attention(tape=...)``, ``SumOf``), and backpropagates through the
replay. Like the reference's partial evaluation, the replay skips a
product whose value no backward reads: a dense whose output was saved (its
base product and LoRA-B product feed only the sum), and ``mlp_down``, whose
output feeds only the residual add (so it is never saved either).

Generators. LoRA dropout draws from an explicit ``torch.Generator``, which
``torch.utils.checkpoint``'s ``preserve_rng_state`` would not restore, so
the replay would draw another mask. The forward records each generator's
state before the layer; the replay sets it, runs, and puts back the state
it found. The stochastic-rounding seeds are plain ints set on the modules
once per step, read by the forward and kept by ``int8_dot``'s Function, so
the replay neither draws nor changes them.

On the plain (CPU) attention path there is no flash site: ``flash_only``
saves nothing there, and the attention is recomputed under every policy.
"""

from __future__ import annotations

import contextlib
from typing import Dict, FrozenSet, Iterator, List, Optional, Tuple

import torch
from torch import nn

# the reference's checkpoint_name of each dense output
DENSE_SITES = {
    "q_proj": "attn_q", "k_proj": "attn_k", "v_proj": "attn_v", "o_proj": "attn_o",
    "gate_proj": "mlp_gate", "up_proj": "mlp_up", "down_proj": "mlp_down",
}
# outputs no backward reads: replayed lazily, never saved
DEAD_SITES = frozenset({"mlp_down"})
_DENSES = frozenset(DENSE_SITES.values()) - DEAD_SITES

# "dot": every matrix product's output; "flash": the flash kernel's (out, lse)
POLICIES: Dict[str, FrozenSet[str]] = {
    "full": frozenset(),
    "dots_saveable": frozenset({"dot"}),
    "flash_only": frozenset({"flash"}),
    "dots_flash_saveable": frozenset({"dot", "flash"}) | _DENSES,
    "min_saves": frozenset({"flash"}) | _DENSES,
}


def policy_names(name: str) -> FrozenSet[str]:
    """What a remat policy saves; an unknown name saves nothing, as the
    reference's fallback ``nothing_saveable`` does."""
    return POLICIES.get(name, frozenset())


class Tape:
    """The values a checkpointed layer's forward saved, keyed by
    (module, site). Recording when built without ``values``; replaying
    when built from them."""

    def __init__(self, names: FrozenSet[str], values: Optional[Dict[Tuple[nn.Module, str], torch.Tensor]] = None):
        self.names = names
        self.replaying = values is not None
        self.values: Dict[Tuple[nn.Module, str], torch.Tensor] = {} if values is None else values

    def saves(self, site: str) -> bool:
        return site in self.names

    def put(self, owner: nn.Module, site: str, value: torch.Tensor) -> None:
        self.values[(owner, site)] = value

    def get(self, owner: nn.Module, site: str) -> torch.Tensor:
        return self.values[(owner, site)]


def placeholder(shape, dtype: torch.dtype, device) -> torch.Tensor:
    """A stand-in value of ``shape`` that holds one element (stride 0): the
    forward value of a replayed product that nothing reads."""
    return torch.zeros((), dtype=dtype, device=device).expand(shape)


class SumOf(torch.autograd.Function):
    """``value`` in the forward, standing for ``sum(parts)``; the backward
    sends the gradient to each part, summed down to the part's shape."""

    @staticmethod
    def forward(ctx, value, *parts):
        ctx.shapes = [p.shape for p in parts]
        return value

    @staticmethod
    def backward(ctx, dy):
        return (None, *(dy if dy.shape == s else dy.sum_to_size(s) for s in ctx.shapes))


@contextlib.contextmanager
def _generator_states(states: List[Tuple[torch.Generator, torch.Tensor]]) -> Iterator[None]:
    """Run with each generator set to the recorded state, then put back the
    state each one had."""
    now = [(g, g.get_state()) for g, _ in states]
    for g, state in states:
        g.set_state(state)
    try:
        yield
    finally:
        for g, state in now:
            g.set_state(state)


class _CheckpointedLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, layer, names, x, positions, kv_mask, *params):
        gens = {id(g): g for m in layer.modules() if (g := getattr(m, "generator", None)) is not None}
        ctx.layer, ctx.names, ctx.params = layer, names, params
        ctx.gen_states = [(g, g.get_state()) for g in gens.values()]
        tape = Tape(names)
        out, _ = layer(x, positions, kv_mask=kv_mask, tape=tape)
        ctx.keys = list(tape.values)
        ctx.save_for_backward(x, positions, kv_mask, *tape.values.values())
        return out

    @staticmethod
    def backward(ctx, dout):
        x, positions, kv_mask, *values = ctx.saved_tensors
        tape = Tape(ctx.names, dict(zip(ctx.keys, values)))
        x = x.detach().requires_grad_(ctx.needs_input_grad[2])
        need = ctx.needs_input_grad[5:]
        params = [p for p, n in zip(ctx.params, need) if n]
        with torch.enable_grad(), _generator_states(ctx.gen_states):
            out, _ = ctx.layer(x, positions, kv_mask=kv_mask, tape=tape)
        inputs = ([x] if x.requires_grad else []) + params
        grads = iter(torch.autograd.grad(out, inputs, dout, allow_unused=True))
        dx = next(grads) if x.requires_grad else None
        return (None, None, dx, None, None, *(next(grads) if n else None for n in need))


def checkpoint_layer(layer: nn.Module, names: FrozenSet[str], x: torch.Tensor, positions: torch.Tensor,
                     kv_mask: torch.Tensor) -> torch.Tensor:
    """``layer(x, positions, kv_mask=kv_mask)[0]`` keeping only ``x`` and what
    the policy ``names`` saves for the backward."""
    params = [p for p in layer.parameters() if p.requires_grad]
    return _CheckpointedLayer.apply(layer, names, x, positions, kv_mask, *params)
