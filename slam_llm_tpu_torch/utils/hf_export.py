"""Export the trained LLM back to an HF llama checkpoint (safetensors).

Counterpart of ``slam_llm_tpu/utils/hf_export.py``, the inverse of
``utils.hf_loader.convert_llama``: an int8 base is dequantized first
(``ops.quant.dequantize_base_params``), LoRA is merged into each base weight
as ``W + (B A) * alpha / r`` (peft's ``merge_and_unload``), and every tensor
is written in f32 with the port's own writer (``utils.safetensors_io``),
with a ``config.json`` of the reference's keys.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import torch
from torch import nn

from slam_llm_tpu_torch.ops.quant import dequantize_base_params
from slam_llm_tpu_torch.utils.safetensors_io import save_file

_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP = ("gate_proj", "up_proj", "down_proj")


@torch.no_grad()
def merged_llama_state_dict(llm: nn.Module) -> Dict[str, torch.Tensor]:
    """The ``CausalLM``'s weights under HF llama names, f32, LoRA merged,
    on the module's device."""
    c = llm.cfg
    if c.head_size:
        raise ValueError("cannot export a narrow-head model (head_size set) as an HF llama checkpoint: "
                         "lm_head width would contradict config vocab_size")
    sd = dequantize_base_params(llm, torch.float32)
    scale = c.lora_alpha / c.lora_rank if c.lora_rank else 0.0

    def merged(prefix: str) -> torch.Tensor:
        w = sd[prefix + "weight"].float()
        if prefix + "lora_a" in sd and c.lora_rank > 0:
            w = w + (sd[prefix + "lora_b"].float() @ sd[prefix + "lora_a"].float()) * scale
        return w

    out = {"model.embed_tokens.weight": sd["embed_tokens.weight"].float(),
           "model.norm.weight": sd["final_norm.scale"].float()}
    if not c.tied_embeddings:
        out["lm_head.weight"] = merged("lm_head.")
    for i in range(c.n_layers):
        src, dst = f"layers.{i}.", f"model.layers.{i}."
        out[dst + "input_layernorm.weight"] = sd[src + "input_norm.scale"].float()
        out[dst + "post_attention_layernorm.weight"] = sd[src + "post_attn_norm.scale"].float()
        for group, names in (("self_attn", _ATTN), ("mlp", _MLP)):
            sub = "attn" if group == "self_attn" else "mlp"
            for name in names:
                out[f"{dst}{group}.{name}.weight"] = merged(f"{src}{sub}.{name}.")
                if f"{src}{sub}.{name}.bias" in sd:
                    out[f"{dst}{group}.{name}.bias"] = sd[f"{src}{sub}.{name}.bias"].float()
    return out


def export_llama(llm: nn.Module, out_dir: str) -> str:
    """Write ``llm`` (the port's ``CausalLM``) as ``out_dir/model.safetensors``
    (f32) + ``config.json``; returns ``out_dir``."""
    c = llm.cfg
    os.makedirs(out_dir, exist_ok=True)
    save_file(merged_llama_state_dict(llm), os.path.join(out_dir, "model.safetensors"), metadata={"format": "pt"})
    cfg = {
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
        "vocab_size": c.vocab_size,
        "hidden_size": c.d_model,
        "num_hidden_layers": c.n_layers,
        "num_attention_heads": c.n_heads,
        "num_key_value_heads": c.n_kv_heads,
        "intermediate_size": c.ffn_dim,
        "rms_norm_eps": c.rms_eps,
        "rope_theta": c.rope_theta,
        "tie_word_embeddings": c.tied_embeddings,
        # qwen2-style q/k/v biases only load back if the config says so
        "attention_bias": bool(c.qkv_bias),
        "bos_token_id": 1,
        "eos_token_id": 2,
        "max_position_embeddings": 4096,
        "torch_dtype": "float32",
    }
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
    return out_dir
