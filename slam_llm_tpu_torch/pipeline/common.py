"""Shared pipeline assembly: config -> (model, tokenizer, dataset) -> weights.

Counterpart of ``slam_llm_tpu/pipeline/common.py``. ``materialize_params``
draws the port's own random init from ``train_config.seed`` through a
``torch.Generator`` on the model's device, then overlays the HF checkpoints
(``model_config.llm_path`` / ``encoder_path``) and the trainable checkpoint
(``ckpt_path``), in the reference's order. ``encode_one`` builds the one-wav batch of the
reference's ``pipeline/inference.py`` (``run_test_during_validation``).
"""

from __future__ import annotations

import logging
import math
import random
from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from slam_llm_tpu_torch.config import RunConfig
from slam_llm_tpu_torch.models.beats import BEATsTransformer
from slam_llm_tpu_torch.models.layers import DenseGeneralLora
from slam_llm_tpu_torch.models.projector import ProjectorQFormer
from slam_llm_tpu_torch.models.vit import ViTEncoder
from slam_llm_tpu_torch.models.wavlm import WavLMEncoder
from slam_llm_tpu_torch.ops.quant import quantize_int8
from slam_llm_tpu_torch.registry import get_custom_dataset_factory, get_custom_model_factory
from slam_llm_tpu_torch.utils.checkpoint import load_trainable_into
from slam_llm_tpu_torch.utils.hf_loader import load_pretrained_into

def set_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)


def parse_device(argv: List[str]) -> Tuple[List[str], str]:
    """Split ``--device <name>`` (default ``cuda``) off a CLI argument list."""
    argv = list(argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            raise SystemExit("--device needs a value, e.g. --device cuda")
        device = argv[i + 1]
        del argv[i : i + 2]
    return argv, device


def resolve_device(device) -> torch.device:
    """A ``torch.device``; asking for CUDA without a usable GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev


def build_model_and_data(cfg: RunConfig, split: str = "train", device="cuda"):
    """Resolve the factories, build (model, tokenizer, dataset); the model's
    tensors are allocated on ``device`` (the card unless the caller asks for
    the CPU) and zero-filled."""
    factory = get_custom_model_factory(cfg.model_config)
    model, tokenizer = factory(cfg.train_config, cfg.model_config, device=resolve_device(device))
    ds_factory = get_custom_dataset_factory(cfg.dataset_config)
    dataset = ds_factory(cfg.dataset_config, tokenizer, split)
    return model, tokenizer, dataset


@torch.no_grad()
def init_params_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init in place, drawn on the generator's device, following the
    reference's initializers: dense and conv kernels (1-D, 2-D and 3-D; the
    ``hf-text`` BERT's ``nn.Linear``s too) normal with std 1/sqrt(fan_in),
    biases 0, LoRA A normal with std 1/r and B
    zero, embeddings and the Q-Former's queries standard normal, WavLM's
    and BEATs' relative-position tables and EAT's CLS token normal with std
    0.02, norms (BERT's ``nn.LayerNorm``s included; WavLM's gate constants)
    1 / 0. An int8 base is the quantization of such a kernel."""

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=generator.device) * std

    for mod in model.modules():
        if isinstance(mod, DenseGeneralLora):
            w = normal((mod.features, mod.in_features), 1.0 / math.sqrt(mod.in_features))
            if mod.quant == "int8":
                q, s = quantize_int8(w, contract_axis=-1)
                mod.kernel_q.copy_(q)
                mod.kernel_scale.copy_(s)
            else:
                mod.weight.copy_(w)
            if mod.bias is not None:
                mod.bias.zero_()
            if mod.lora_rank > 0:
                mod.lora_a.copy_(normal(mod.lora_a.shape, 1.0 / mod.lora_rank))
                mod.lora_b.zero_()
        elif isinstance(mod, nn.Linear):
            mod.weight.copy_(normal(mod.weight.shape, 1.0 / math.sqrt(mod.in_features)))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Conv3d)):
            fan_in = mod.weight[0].numel()  # input channels per group x taps
            mod.weight.copy_(normal(mod.weight.shape, 1.0 / math.sqrt(fan_in)))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.copy_(normal(mod.weight.shape, 1.0))
        elif isinstance(mod, ProjectorQFormer):
            mod.query.copy_(normal(mod.query.shape, 1.0))
        elif isinstance(mod, (WavLMEncoder, BEATsTransformer)) and mod.rel_attn_embed is not None:
            mod.rel_attn_embed.copy_(normal(mod.rel_attn_embed.shape, 0.02))
        elif isinstance(mod, ViTEncoder):
            mod.cls_token.copy_(normal(mod.cls_token.shape, 0.02))
    return model


def materialize_params(model: nn.Module, cfg: RunConfig) -> nn.Module:
    """Fill the model's weights as the reference does: the seeded random
    init, then the HF weights of ``model_config.llm_path`` /
    ``encoder_path`` (``utils.hf_loader``), then the trainable tensors of
    ``ckpt_path`` (``utils.checkpoint.load_trainable_into``: a directory
    holding ``model.pt``, else ``model.msgpack``, or either file). A path
    that is given and missing raises. The int8 backward buffers and CE head
    are derived from the loaded weights afterwards, by the trainer
    (``ops.quant.quantize_base_params``)."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(cfg.train_config.seed)
    init_params_(model, gen)
    mc = cfg.model_config
    if mc.llm_path or mc.encoder_path:
        load_pretrained_into(model, mc)
    if cfg.ckpt_path:
        logging.getLogger("slam_llm_tpu_torch").info("loading trainable checkpoint from %s", cfg.ckpt_path)
        load_trainable_into(model, cfg.ckpt_path)
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # a caller timing the load sees the copies and quantizations done
    return model


def encode_one(wav_path: str, prompt: str, tokenizer, dataset_config, ds_rate=None) -> dict:
    """A batch of one wav with the speech dataset's token assembly, as the
    reference's ``encode_one``: whisper log-mel of the wav padded or trimmed
    to ``max_audio_length_s``, ``(mel frames + 1) // 2 // ds_rate`` audio
    pseudo-tokens (id -1) and then the templated prompt. ``ds_rate`` is the
    projector's (``model_config.encoder_projector_ds_rate``)."""
    from slam_llm_tpu_torch.data.speech_dataset import PROMPT_TEMPLATE
    from slam_llm_tpu_torch.ops import audio as audio_ops

    mel_size = getattr(dataset_config, "mel_size", 80)
    max_samples = int(getattr(dataset_config, "max_audio_length_s", 30.0) * audio_ops.SAMPLE_RATE)
    audio = audio_ops.pad_or_trim(audio_ops.load_audio(wav_path), max_samples)
    mel = audio_ops.log_mel_spectrogram(audio, n_mels=mel_size)
    if ds_rate is None:
        ds_rate = getattr(dataset_config, "encoder_projector_ds_rate", 5)
    audio_length = (mel.shape[0] + 1) // 2 // ds_rate
    prompt_ids = tokenizer.encode(PROMPT_TEMPLATE.format(prompt))
    input_ids = np.concatenate([np.full(audio_length, -1, np.int64), np.asarray(prompt_ids, np.int64)])
    t = len(input_ids)
    return {
        "input_ids": input_ids[None],
        "attention_mask": np.ones((1, t), np.int32),
        "modality_mask": np.concatenate([np.ones(audio_length, np.int32), np.zeros(t - audio_length, np.int32)])[None],
        "audio_mel": mel[None].astype(np.float32),
        "audio_mel_mask": np.ones((1, mel.shape[0]), np.int32),
    }
