"""One K2 per shared activation: the attention's q / k / v and the MLP's
gate / up quantize their common input once (``ops.quant.SharedActQuant``),
on the CPU at a tiny size, with and without activation checkpointing."""

import dataclasses

import pytest
import torch

from slam_llm_tpu_torch.models.llm import CausalLM, LLMConfig
from slam_llm_tpu_torch.ops import quant as tquant
from slam_llm_tpu_torch.pipeline.common import init_params_


def _run(remat, policy, bwd, monkeypatch, shared=True):
    """Loss, LoRA and input gradients of a 2-layer int8 LLM, and the number
    of activation quantizations (K2 deterministic launches on the card)."""
    calls = []
    plain = tquant.act_quant

    def counted(x):
        calls.append(tuple(x.shape))
        return plain(x)

    monkeypatch.setattr(tquant, "act_quant", counted)
    if not shared:  # every dense quantizes its input itself
        monkeypatch.setattr(tquant.SharedActQuant, "__call__", lambda self: tquant.act_quant(self.x))
    cfg = dataclasses.replace(LLMConfig.tiny_test(vocab_size=64), dtype=torch.float32, lora_rank=4,
                              base_quant="int8", base_quant_bwd=bwd, remat=remat, remat_policy=policy)
    gen = torch.Generator().manual_seed(0)
    model = init_params_(CausalLM(cfg), gen)
    with torch.no_grad():
        for mod in model.modules():
            if getattr(mod, "lora_rank", 0):
                mod.lora_b.normal_(0, 0.05, generator=gen)
    tquant.quantize_base_params(model)
    params = []
    for mod in model.modules():
        if getattr(mod, "lora_rank", 0):
            params += [mod.lora_a.requires_grad_(True), mod.lora_b.requires_grad_(True)]
        if getattr(mod, "quant", None) == "int8":
            mod.quant_seed = 5
    model.train()
    x = torch.randn(2, 12, 64, generator=gen).requires_grad_(True)
    mask = torch.ones(2, 12, dtype=torch.int32)
    mask[1, :3] = 0
    labels = torch.randint(0, 64, (2, 12), generator=gen)
    loss, _ = model.loss_and_accuracy(x, mask, labels)
    grads = torch.autograd.grad(loss, params + [x])
    monkeypatch.undo()
    return loss.detach(), grads, len(calls)


@pytest.mark.parametrize("remat,policy,per_layer", [(False, "none", 4), (True, "dots_flash_saveable", 4),
                                                    (True, "full", 7)])
@pytest.mark.parametrize("bwd", ["int8_rot", "int8_sr"])
def test_shared_quantization_is_bit_equal_and_launches_fewer(monkeypatch, remat, policy, bwd, per_layer):
    """Loss and every gradient with the shared quantization equal the
    unshared path bit for bit; per layer it quantizes 4 activations in the
    forward (q/k/v once, o, gate/up once, down) instead of 7, and a replay
    that takes every dense from the tape quantizes none (``full`` replays
    all but the dead ``mlp_down``: 3 more)."""
    loss, grads, n = _run(remat, policy, bwd, monkeypatch)
    loss_u, grads_u, n_u = _run(remat, policy, bwd, monkeypatch, shared=False)
    assert torch.equal(loss, loss_u) and all(torch.equal(a, b) for a, b in zip(grads, grads_u))
    layers = LLMConfig.tiny_test().n_layers
    assert n == per_layer * layers
    assert n_u == {4: 7, 7: 13}[per_layer] * layers
