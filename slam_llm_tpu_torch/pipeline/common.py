"""Shared pipeline assembly: config -> (model, tokenizer, dataset) -> weights.

Counterpart of ``slam_llm_tpu/pipeline/common.py``. ``materialize_params``
draws the port's own random init from ``train_config.seed`` through a
``torch.Generator`` on the model's device, then overlays the HF checkpoints
(``model_config.llm_path`` / ``encoder_path``) and the trainable checkpoint
(``ckpt_path``), in the reference's order. ``encode_one`` builds the one-wav batch of the
reference's ``pipeline/inference.py`` (``run_test_during_validation``).

Under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` and
``MASTER_ADDR`` / ``MASTER_PORT`` in the environment) ``maybe_init_distributed``
joins the process group: NCCL on ``cuda:LOCAL_RANK``, or gloo when the caller
asks for the CPU; ``resolve_device`` then names the local rank's card and
``build_mesh`` lays the ``(dp, fsdp, tp)`` mesh over the world. Given the
mesh, ``build_model_and_data`` builds the model on ``meta`` (each tensor is
made on the card as its module is built, its value kept on the host if it
is not all zero, then moved to ``meta``), and ``materialize_params`` builds
it straight into the rank's shards: the tp split and FSDP2 laid out on
``meta``, the shards allocated, then one module's whole tensors at a time
drawn in the one-process order from the one seeded generator, overlaid with
the HF and trainable checkpoints, cast, their int8 base derived, and cut to
this rank's part (the tp slice, then FSDP2's dim-0 chunk). So no rank holds
more of the model than its shards and one module's tensors in flight, and
every value equals a one-process build's bit for bit. Without torchrun's
environment nothing here changes.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import math
import os
import random
from datetime import timedelta
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from slam_llm_tpu_torch.config import RunConfig
from slam_llm_tpu_torch.models.beats import BEATsTransformer
from slam_llm_tpu_torch.models.beats_tokenizer import BEATsTokenizer, l2norm
from slam_llm_tpu_torch.models.layers import DenseGeneralLora
from slam_llm_tpu_torch.models.llm import Attention
from slam_llm_tpu_torch.models.projector import ProjectorQFormer
from slam_llm_tpu_torch.models.vallex import VALLE
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


# how long a collective may wait before the run fails (it never hangs for good)
DIST_TIMEOUT = timedelta(seconds=600)
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def launched_by_torchrun() -> bool:
    return all(k in os.environ for k in _TORCHRUN_ENV)


def resolve_device(device) -> torch.device:
    """A ``torch.device``; asking for CUDA without a usable GPU raises.
    Under torchrun, ``cuda`` names the local rank's card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    if dev.type == "cuda" and dev.index is None and launched_by_torchrun():
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return dev


def maybe_init_distributed(device, timeout: timedelta = DIST_TIMEOUT) -> bool:
    """Join torchrun's process group (the reference's ``init_process_group``):
    NCCL on the local rank's card, gloo for ``--device cpu``, with ``timeout``
    on every collective. False (and nothing done) without torchrun's
    environment."""
    import torch.distributed as dist

    if not launched_by_torchrun():
        return False
    if dist.is_initialized():
        return True
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev, timeout=timeout)
    elif dev.type == "cpu":
        dist.init_process_group("gloo", timeout=timeout)
    else:
        raise ValueError(f"no process group for device {device!r}: expected cuda or cpu")
    logging.getLogger("slam_llm_tpu_torch").info(
        "joined the process group: rank %d of %d on %s (%s)", dist.get_rank(), dist.get_world_size(), dev,
        dist.get_backend())
    return True


def destroy_process_group() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def build_mesh(cfg: RunConfig, device) -> Optional[object]:
    """The ``(dp, fsdp, tp)`` mesh of ``train_config.shard`` over the process
    group, or None outside torchrun; there a mesh other than one process
    raises ``ValueError`` (``parallel.sharding.mesh_shape``), as the
    reference's ``make_mesh`` does on one device."""
    import torch.distributed as dist

    from slam_llm_tpu_torch.parallel.sharding import make_mesh, mesh_shape

    s = cfg.train_config.shard
    if not dist.is_initialized():
        mesh_shape(s.dp, s.fsdp, s.tp, 1)
        return None
    return make_mesh(dp=s.dp, fsdp=s.fsdp, tp=s.tp, device_type=resolve_device(device).type)


def build_model_and_data(cfg: RunConfig, split: str = "train", device="cuda", mesh=None):
    """Resolve the factories, build (model, tokenizer, dataset); the model's
    tensors are allocated on ``device`` (the card unless the caller asks for
    the CPU) and zero-filled, or, given a ``mesh``, built on ``meta``
    (``build_on_meta``) for ``materialize_params`` to fill into the rank's
    shards."""
    model, tokenizer = build_model(cfg, device, mesh)
    ds_factory = get_custom_dataset_factory(cfg.dataset_config)
    dataset = ds_factory(cfg.dataset_config, tokenizer, split)
    return model, tokenizer, dataset


def build_model(cfg: RunConfig, device="cuda", mesh=None):
    """(model, tokenizer) of the model factory: on ``device``, or on
    ``meta`` given a ``mesh`` (``build_on_meta``)."""
    factory = get_custom_model_factory(cfg.model_config)
    if mesh is None:
        return factory(cfg.train_config, cfg.model_config, device=resolve_device(device))
    with build_on_meta():
        model, tokenizer = factory(cfg.train_config, cfg.model_config, device=resolve_device(device))
    return offload_to_meta(model), tokenizer


# ---- building into the shards ---------------------------------------------------


def offload_to_meta(module: nn.Module) -> nn.Module:
    """Move every tensor of ``module`` that is not on ``meta`` yet there,
    each module's own in place (tied tensors stay tied), keeping its value
    as built: None where it is all zero, else a host copy, in the module's
    ``construction_values`` (what ``materialize_params`` starts from before
    the seeded init, as a built model's tensors hold it)."""
    for mod in module.modules():
        kept = {}
        for name, t in [*mod._parameters.items(), *mod._buffers.items()]:
            if t is None or t.is_meta:
                continue
            kept[name] = t.detach().to("cpu", copy=True) if bool(t.detach().ne(0).any()) else None
        if kept:
            mod.__dict__.setdefault("construction_values", {}).update(kept)
            mod.to_empty(device="meta", recurse=False)
    return module


@contextlib.contextmanager
def build_on_meta():
    """Inside, each module is moved to ``meta`` (``offload_to_meta``) as it
    is registered into its parent, i.e. once its constructor has finished:
    a model built here never holds more than the modules still under
    construction on its device. The root's own tensors stay; the caller
    offloads them."""

    def hook(parent, name, child):
        if child is not None:
            offload_to_meta(child)

    handle = torch.nn.modules.module.register_module_module_registration_hook(hook)
    try:
        yield
    finally:
        handle.remove()


def on_meta(model: nn.Module) -> bool:
    return any(t.is_meta for t in [*model.parameters(), *model.buffers()])


@torch.no_grad()
def init_params_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init in place, drawn on the generator's device, following the
    reference's initializers: dense and conv kernels (1-D, 2-D and 3-D; the
    ``hf-text`` BERT's ``nn.Linear``s too) normal with std 1/sqrt(fan_in),
    biases 0, LoRA A normal with std 1/r and B
    zero, embeddings and the Q-Former's queries standard normal, WavLM's
    and BEATs' relative-position tables and EAT's CLS token normal with std
    0.02, norms (BERT's ``nn.LayerNorm``s included; WavLM's gate constants)
    1 / 0, the BEATs tokenizer's codebook standard normal rows
    l2-normalized. An int8 base is the quantization of such a kernel.
    VALL-E X's embeddings are normal with std 0.02; prefix-tuning's slots
    and llama-adapter's prompt too, its gate 0."""
    vallex_embeds = {id(m) for v in model.modules() if isinstance(v, VALLE) for m in v.modules()
                     if isinstance(m, nn.Embedding)}
    for mod in model.modules():
        init_module_(mod, generator, id(mod) in vallex_embeds)
    return model


@torch.no_grad()
def init_module_(mod: nn.Module, generator: torch.Generator, vallex_embed: bool = False) -> None:
    """``init_params_``'s draws for one module's own tensors (``vallex_embed``:
    an embedding of VALL-E X)."""

    def normal(shape, std):  # scaled in place: one whole f32 draw in flight
        return torch.randn(shape, generator=generator, device=generator.device).mul_(std)

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
        mod.weight.copy_(normal(mod.weight.shape, 0.02 if vallex_embed else 1.0))
    elif isinstance(mod, Attention):
        for name in ("prefix_k", "prefix_v", "adaption_prompt"):
            if hasattr(mod, name):
                getattr(mod, name).copy_(normal(getattr(mod, name).shape, 0.02))
        if hasattr(mod, "adaption_gate"):
            mod.adaption_gate.zero_()
    elif isinstance(mod, ProjectorQFormer):
        mod.query.copy_(normal(mod.query.shape, 1.0))
    elif isinstance(mod, (WavLMEncoder, BEATsTransformer)) and mod.rel_attn_embed is not None:
        mod.rel_attn_embed.copy_(normal(mod.rel_attn_embed.shape, 0.02))
    elif isinstance(mod, ViTEncoder):
        mod.cls_token.copy_(normal(mod.cls_token.shape, 0.02))
    elif isinstance(mod, BEATsTokenizer):
        mod.codebook.copy_(l2norm(normal(mod.codebook.shape, 1.0)))


def materialize_params(model: nn.Module, cfg: RunConfig, mesh=None, device=None, train: bool = False) -> nn.Module:
    """Fill the model's weights as the reference does: the seeded random
    init, then the HF weights of ``model_config.llm_path`` /
    ``encoder_path`` (``utils.hf_loader``), then the trainable tensors of
    ``ckpt_path`` (``utils.checkpoint.load_trainable_into``: a directory
    holding ``model.pt``, else ``model.msgpack``, or either file). A path
    that is given and missing raises. The int8 backward buffers and CE head
    are derived from the loaded weights afterwards, by the trainer
    (``ops.quant.quantize_base_params``).

    A model that ``build_model_and_data`` built on ``meta`` for a ``mesh``
    is built straight into this rank's shards on ``device``
    (``materialize_sharded``), for the trainer with ``train``."""
    if mesh is not None and on_meta(model):
        return materialize_sharded(model, cfg, mesh, device, train)
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


def _own(mod: nn.Module, name: str) -> torch.Tensor:
    t = mod._parameters.get(name)
    return mod._buffers[name] if t is None else t


def _put(target: nn.Module, name: str, whole: torch.Tensor, tp) -> None:
    """This rank's part of tensor ``name`` of ``target`` from its whole
    value: the tp slice (the module's ``tp_dims``), then FSDP2's dim-0
    chunk, copied into the local shard (the int8 ones through their
    carrier's bytes)."""
    from slam_llm_tpu_torch.parallel.sharding import INT8_CARRIER, local_part, local_shard
    from slam_llm_tpu_torch.parallel.tensor_parallel import narrow_shard

    t = _own(target, name)
    spec = getattr(target, "tp_dims", {}).get(name)
    if spec is not None and tp is not None:
        whole = narrow_shard(whole, spec, tp)
    local = local_part(t)
    if local.dtype == INT8_CARRIER:
        local = local.view(torch.int8)
    local.copy_(local_shard(whole, t))


@torch.no_grad()
def materialize_sharded(model: nn.Module, cfg: RunConfig, mesh, device=None, train: bool = False) -> nn.Module:
    """Build ``model`` (on ``meta``, from ``build_on_meta``) into this rank's
    shards on ``device``, each value a one-process build's bit for bit, as
    the trainer (``train``) or a decoder shards it:

    * a copy of the whole model stays on ``meta``; ``model`` takes the
      trainer's dtypes and ``requires_grad`` (``train.state.prepare_params``)
      with ``train``, then its sharding (``parallel.shard_params``: the tp
      split, ``kernel_t`` of each shard, FSDP2's units; for a decoder
      without fsdp, the tp split alone) and is allocated on ``device``: the
      rank's shards only;
    * then, for each module in ``init_params_``'s order, the copy's own
      tensors are made whole on ``device``: their built values, the seeded
      draws from the one generator (``init_module_``), the HF and ``ckpt_path``
      tensors that land there, the cast to the shard's dtype and, where the
      trainer derives them (``train.state.derives_int8``), the int8 base's derived tensors (and a CE head's from
      the head's weight); each is cut to this rank's part (``_put``),
      ``kernel_t`` is the transpose of the weight's tp slice, and the module
      goes back to ``meta``."""
    from slam_llm_tpu_torch.models.layers import refresh_pretransposed
    from slam_llm_tpu_torch.ops.quant import derive_dense_int8_, head_int8
    from slam_llm_tpu_torch.parallel.sharding import INT8_CARRIER, shard_params
    from slam_llm_tpu_torch.parallel.tensor_parallel import narrow_shard, split_for_tp, tp_of
    from slam_llm_tpu_torch.utils.checkpoint import checked_trainable
    from slam_llm_tpu_torch.utils.hf_loader import pretrained_plan, write_overlay

    from slam_llm_tpu_torch.train.state import derives_int8, prepare_params

    dev = resolve_device(device)
    whole = copy.deepcopy(model)
    quantize = train and derives_int8(model.cfg)
    if train:
        prepare_params(model, model.cfg, cfg.train_config)
    if train or mesh["fsdp"].size() > 1:
        shard_params(model, mesh)
    else:
        logging.getLogger("slam_llm_tpu_torch").info("tensor parallel tp=%d: split %s", mesh["tp"].size(),
                                                     split_for_tp(model, mesh))
        refresh_pretransposed(model)
    model.to_empty(device=dev)
    tp, targets = tp_of(mesh), dict(model.named_modules())
    mc = cfg.model_config
    landing = {}  # module name -> the checkpoint writes into its own tensors, in the loaders' order
    for name, src, quant in pretrained_plan(whole, mc) if mc.llm_path or mc.encoder_path else ():
        owner, _, leaf = name.rpartition(".")
        landing.setdefault(owner, []).append((leaf, src, quant))
    for name, val in checked_trainable(whole, cfg.ckpt_path).items() if cfg.ckpt_path else ():
        owner, _, leaf = name.rpartition(".")
        landing.setdefault(owner, []).append((leaf, val, False))
    heads = {}  # id of the module whose weight is a CE head -> the name of the module deriving the int8 head
    if quantize:
        for name, mod in whole.named_modules():
            if getattr(mod, "head_q", None) is not None:
                heads[id(mod.embed_tokens if mod.cfg.tied_embeddings else mod.lm_head)] = name
    vallex_embeds = {id(m) for v in whole.modules() if isinstance(v, VALLE) for m in v.modules()
                     if isinstance(m, nn.Embedding)}
    gen = torch.Generator(device=dev).manual_seed(cfg.train_config.seed)
    for name, mod in whole.named_modules():
        if not any(t is not None for t in [*mod._parameters.values(), *mod._buffers.values()]):
            continue
        mod.to_empty(device=dev, recurse=False)
        built = getattr(mod, "construction_values", {})
        own = {n: t for n, t in [*mod._parameters.items(), *mod._buffers.items()] if t is not None}
        for n, t in own.items():
            if built.get(n) is None:
                t.zero_()
            else:
                t.copy_(built[n])
        init_module_(mod, gen, id(mod) in vallex_embeds)
        for leaf, src, quant in landing.get(name, ()):
            write_overlay(own, leaf, src, quant)
        if quantize:
            derive_dense_int8_(mod)
        target = targets[name]
        values = {}
        for n, t in own.items():
            dtype = _own(target, n).dtype
            values[n] = t.to(torch.int8 if dtype == INT8_CARRIER else dtype)
        if id(mod) in heads:
            for n, t in head_int8(values["weight"]).items():
                _put(targets[heads[id(mod)]], n, t, tp)
        for n, t in values.items():
            if n == "kernel_t":
                continue
            _put(target, n, t, tp)
            if n == "weight" and getattr(target, "kernel_t", None) is not None:
                spec = getattr(target, "tp_dims", {}).get(n)
                shard = t if spec is None or tp is None else narrow_shard(t, spec, tp)
                _put(target, "kernel_t", shard.t().contiguous(), None)
        del own, values
        mod.to_empty(device="meta", recurse=False)
    model.sharded_build = True
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
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
