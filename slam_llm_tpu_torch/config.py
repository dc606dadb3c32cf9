"""Config system: dataclass schemas + YAML files + ``++key=value`` CLI overrides.

Counterpart of ``slam_llm_tpu/config.py``, key for key (the recipe YAMLs
fill both). The port reads ``ShardConfig``'s mesh axes, remat and int8 knobs
as the single-device training path documents in ``pipeline/finetune.py``.

Mirrors the reference's Hydra surface (priority CLI > yaml > dataclass defaults,
reference README.md:135-139 and examples/asr_librispeech/asr_config.py:7-130)
without depending on hydra/omegaconf. Key names are kept identical where they
are load-bearing for users switching over (model_config.*, train_config.*,
dataset_config.*, peft_config.*, log_config.*); GPU-specific knobs
(enable_fsdp/enable_ddp/enable_deepspeed, FSDPConfig) are replaced by a single
``ShardConfig`` describing the GSPMD mesh.
"""

from __future__ import annotations

import copy
import dataclasses
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import yaml


# ---------------------------------------------------------------------------
# Schemas
# ---------------------------------------------------------------------------


@dataclass
class ModelConfig:
    """Mirrors reference examples/asr_librispeech/asr_config.py:13-32."""

    file: Optional[str] = None  # "path/to/recipe_model.py:model_factory"
    llm_name: str = "tinyllama-1.1b"
    llm_path: Optional[str] = None  # HF checkpoint dir (config.json + safetensors)
    llm_type: str = "decoder_only"
    llm_dim: int = 2048
    encoder_name: Optional[str] = None  # whisper | wavlm | hubert | eat | beats | ...
    encoder_ds_rate: int = 2
    encoder_path: Optional[str] = None
    encoder_dim: int = 1280
    encoder_config: Optional[str] = None  # preset name, e.g. "whisper-tiny"
    encoder_projector: str = "linear"  # linear | cov1d-linear | q-former
    encoder_projector_ds_rate: int = 5
    modal: str = "audio"
    normalize: bool = False
    encoder_type: str = "finetune"
    qformer_layers: int = 8
    query_len: int = 64
    qformer_dim: int = 768  # BLIP-2 QFormer width (reference bert-base default)
    qformer_heads: int = 12
    # S2S TTS adapter (reference s2s_config.py:93-94)
    tts_adapter: bool = False
    tts_adapter_layers: int = 6
    # S2S codec vocoder (reference s2s_config.py:90-92)
    codec_decode: bool = False
    codec_decoder_type: str = "SNAC"  # SNAC | CosyVoice
    codec_decoder_path: Optional[str] = None
    # TPU-specific:
    dtype: str = "bfloat16"  # compute dtype
    param_dtype: str = "float32"  # master params


@dataclass
class PeftConfig:
    """Mirrors reference asr_config.py:34-43 (peft LoraConfig surface)."""

    peft_method: str = "lora"  # lora | prefix | llama_adapter
    r: int = 8
    lora_alpha: int = 32
    target_modules: List[str] = field(default_factory=lambda: ["q_proj", "v_proj"])
    bias: str = "none"
    task_type: str = "CAUSAL_LM"
    lora_dropout: float = 0.05
    inference_mode: bool = False
    # prefix-tuning / llama-adapter knobs (reference config_utils.py:46-65)
    num_virtual_tokens: int = 30
    adapter_len: int = 10


@dataclass
class ShardConfig:
    """One GSPMD mesh replaces enable_ddp/enable_fsdp/enable_deepspeed.

    Axes follow the scaling-book recipe: data parallel outermost, ZeRO-3-style
    parameter sharding on ``fsdp``, tensor parallel innermost (rides fastest
    ICI links). ``dp=-1`` means "use all remaining devices".
    """

    dp: int = -1
    fsdp: int = 1
    tp: int = 1
    remat: bool = True  # activation checkpointing on decoder blocks
    # dots_flash_saveable (save matmul outputs + flash-attention residuals,
    # recompute only elementwise ops) measured ~40% faster than
    # nothing_saveable on the flagship at B=16 and still fits HBM; fall back
    # to nothing_saveable / flash_only when memory-bound
    remat_policy: str = "dots_flash_saveable"
    scan_layers: bool = True  # lax.scan over decoder layers (fast compile)
    scan_unroll: int = 1  # lax.scan unroll factor over layers
    # frozen-base backward: contract a stored transpose of each decoder
    # kernel in the dx dots (one extra bf16 weight copy in HBM; requires
    # freeze_llm). Measured NEUTRAL on v5e at the flagship shape (PERF.md) —
    # kept for hardware/shapes where the tradeoff differs.
    bwd_pretranspose: bool = False
    # FROZEN-base W8A8: "int8" stores decoder dense kernels quantized
    # (per-output-channel scales) and runs their dots s8 x s8 on the MXU at
    # 2x the bf16 rate (ops/quant.py). Requires freeze_llm. base_quant_bwd
    # picks the dx dot dtype: bf16 (exact — quality default; 1.1B evidence
    # in QUALITY_INT8.json) | int8_rot (2x rate, Hadamard-rotated dy +
    # stochastic rounding — the best-quality fast backward) | int8_rot_otf
    # (int8_rot's PER-STEP gradients — equal up to re-derivation rounding;
    # the adversarial single-batch trajectory probe diverges anyway, see
    # PERF.md — with the rotated weight derived on the fly in the backward:
    # no second weight copy in HBM. Measured DOMINATED at the 7B 1-chip
    # shape: its ~35% re-derivation cost exceeds just running dx exact in
    # bf16 (5.71 vs 7.80 utt/s, BENCH_7B_r05.json) — the 7B recipe ships
    # bwd=bf16; from 2 chips up fsdp shards the stored pair and plain
    # int8_rot is better) | int8_sr (2x
    # rate, stochastic rounding) | int8 (2x, deterministic — biased).
    # "_mlp"-suffixed modes (int8_rot_mlp) quantize dy on gate/up/down only
    # (~67% of the dense backward FLOPs); attention dx stays exact bf16.
    base_quant: str = "none"  # none | int8
    base_quant_bwd: str = "bf16"
    # W8A8 lm_head inside the fused CE. WARNING: "int8" FAILS the shipped
    # 0.30-nat trajectory quality gate (measured 1.1B 300-step delta 0.42,
    # 91.9% of the bf16 loss drop — QUALITY_INT8.json / PERF.md experiments):
    # the quantized logits feed the loss directly, so head-quant error is
    # bias, not noise. Throughput-only knob (+5%); quality-gated runs keep
    # "none".
    ce_quant: str = "none"  # none | int8 | int8_sr


@dataclass
class TrainConfig:
    """Mirrors reference asr_config.py:45-85 minus GPU-specific knobs."""

    model_name: str = "slam_tpu"
    run_validation: bool = True
    batch_size_training: int = 4
    batching_strategy: str = "bucketing"  # bucketing | padding | packing
    context_length: int = 4096
    gradient_accumulation_steps: int = 1
    num_epochs: int = 1
    warmup_steps: int = 1000
    total_steps: int = 100000
    validation_interval: int = 1000
    lr: float = 1e-4
    weight_decay: float = 0.0
    optimizer: str = "adamw"  # adamw | anyprecision (bf16 moments + Kahan)
    # accepted for config-compat but UNUSED, exactly like the reference: its
    # StepLR(gamma) line is commented out (finetune.py:252) in favor of the
    # warmup-linear LambdaLR that lr_schedule mirrors
    gamma: float = 0.85
    seed: int = 42
    val_batch_size: int = 1
    use_peft: bool = False
    # S2S partial-embedding tricks (reference examples/s2s/s2s_config.py:159-161)
    train_embed_only: bool = False
    train_audio_embed_only: bool = False
    train_embed: bool = False
    peft_config: PeftConfig = field(default_factory=PeftConfig)
    output_dir: str = "/tmp/slam_tpu_out"
    save_model: bool = True
    save_optimizer: bool = False
    resume_from: Optional[str] = None
    freeze_llm: bool = False
    freeze_encoder: bool = False
    shard: ShardConfig = field(default_factory=ShardConfig)
    max_steps_per_epoch: int = -1  # debug: cap steps
    log_interval: int = 5
    # decode one wav after each validation pass and log the text (reference
    # train_utils.py:306-320 qualitative mid-training check)
    run_test_during_validation: bool = False
    run_test_during_validation_file: Optional[str] = None
    run_test_during_validation_prompt: Optional[str] = None
    specaug: bool = False
    # Storage dtype for the FROZEN subtree (base LLM + encoder). fp32 masters
    # only matter for params the optimizer updates; keeping frozen weights
    # fp32 doubles their HBM footprint AND their read bandwidth in every
    # matmul (the bf16 cast fuses into each dot). Trainable params always
    # keep fp32 masters.
    frozen_dtype: str = "bfloat16"  # bfloat16 | float32


@dataclass
class DataConfig:
    """Mirrors reference asr_config.py:87-112 plus bucket table."""

    dataset: str = "speech_dataset"
    file: Optional[str] = None  # "path/to/dataset.py:get_dataset_factory"
    train_data_path: Optional[str] = None
    val_data_path: Optional[str] = None
    train_split: str = "train"
    test_split: str = "validation"
    prompt: Optional[str] = None
    fix_length_audio: int = -1
    inference_mode: bool = False
    input_type: str = "mel"  # raw | mel
    mel_size: int = 80
    normalize: bool = False
    # whisper pads/trims to 30 s (reference speech_dataset.py:101); shorter
    # caps cut host+device work for short-utterance corpora
    max_audio_length_s: float = 30.0
    # fbank datasets (audio_dataset.py — EAT/BEATs AAC recipes):
    encoder_name: str = "eat"
    fbank_mean: float = -4.268
    fbank_std: float = 4.569
    target_length: int = 1024
    fixed_length: bool = True
    random_crop: bool = False
    encoder_projector_ds_rate: int = 5
    # s2s datasets (s2s_dataset.py — SLAM-Omni):
    task_type: str = "s2s"
    code_layer: int = 3
    text_vocabsize: int = -1  # -1: from tokenizer
    audio_vocabsize: int = 4096
    num_latency_tokens: int = 0
    specaug: bool = False
    # large-scale iterable pipeline (speech_dataset_large.py — aispeech_asr):
    train_scp_file_path: Optional[str] = None
    dev_scp_file_path: Optional[str] = None
    pad_or_trim: bool = False
    train_max_frame_length: int = 4096
    eval_max_frame_length: int = 4096
    append_info_tasks: List[str] = field(default_factory=lambda: ["hotword"])
    # avhubert datasets: modality selection (audio | video | av)
    modal: str = "av"
    # e-chat dialog manifests (echat_dataset.py):
    data_path: Optional[str] = None
    # spatial soundQA (spatial_dataset.py — seld_spatialsoundqa/BAT):
    qa_data_root: Optional[str] = None
    stage: Optional[str] = None  # stage1-clsdoa | stage2-single | stage3-mixup
    anechoic_data_root: Optional[str] = None
    reverb_data_root: Optional[str] = None
    channel_type: str = "binaural"
    ext_audio: str = ".wav"
    # Static-shape pipeline (replaces dynamic collation; SURVEY.md §7.1):
    seed: int = 0  # dataset-side rng (vallex nar stages, mir crops)
    crop_seconds: float = 10.0  # mir random-crop window
    audio_token_buckets: List[int] = field(default_factory=lambda: [128, 256, 512, 1024])
    text_buckets: List[int] = field(default_factory=lambda: [64, 128, 192, 256])
    audio_buckets: List[int] = field(default_factory=lambda: [48000, 96000, 160000, 240000, 480000])
    num_workers: int = 2
    prefetch: int = 2
    # "thread" (zero-copy handoff), "process" (GIL-free scaling via
    # shared-memory batch transport — parent cost ~15 ms/batch vs ~36 ms for
    # "process_pickle"'s result pickle; measured model in data/loader.py +
    # bench.py) for the ~240 utt/s a 4-chip v5e host must feed
    worker_type: str = "thread"
    shuffle_buffer: int = 2048


@dataclass
class LogConfig:
    """Mirrors reference asr_config.py:125-133 (wandb optional/stubbed)."""

    use_wandb: bool = False
    wandb_dir: str = "/tmp/wandb"
    wandb_entity_name: str = ""
    wandb_project_name: str = "slam_tpu"
    wandb_exp_name: str = "exp"
    log_file: Optional[str] = None
    log_interval: int = 5
    # write a torch.profiler Chrome trace of training steps [profile_start,
    # profile_start+profile_steps) of the run to this dir (train/loop.py;
    # open it in chrome://tracing or Perfetto)
    profile_dir: Optional[str] = None
    profile_start: int = 3
    profile_steps: int = 5


@dataclass
class DecodeConfig:
    """Generation knobs; defaults mirror reference slam_model.generate
    (models/slam_model.py:439-454)."""

    max_new_tokens: int = 200
    num_beams: int = 4
    # top-N beam hypotheses per utterance (reference slam_aac's CLAP-Refine
    # candidate pool); the pred log gets N lines per key
    num_return_sequences: int = 1
    do_sample: bool = False
    min_length: int = 1
    top_p: float = 1.0
    top_k: int = 0
    repetition_penalty: float = 1.0
    length_penalty: float = 1.0
    temperature: float = 1.0
    decode_log: str = "/tmp/decode_log"
    # S2S (SLAM-Omni) driver knobs — reference examples/s2s/s2s_config.py
    # DecodeConfig (:205-232) + the generate/ entry dispatch
    mode: str = "online"  # online | online_multi_round | online_stream | batch
    text_repetition_penalty: float = 1.2
    audio_repetition_penalty: float = 1.2
    num_latency_tokens: int = 0
    decode_text_only: bool = False
    stream_stride: int = 24


@dataclass
class RunConfig:
    """Top-level bundle handed to pipelines."""

    model_config: ModelConfig = field(default_factory=ModelConfig)
    train_config: TrainConfig = field(default_factory=TrainConfig)
    dataset_config: DataConfig = field(default_factory=DataConfig)
    log_config: LogConfig = field(default_factory=LogConfig)
    decode_config: DecodeConfig = field(default_factory=DecodeConfig)
    ckpt_path: Optional[str] = None
    peft_ckpt: Optional[str] = None
    debug: bool = False


# ---------------------------------------------------------------------------
# Merge / override machinery
# ---------------------------------------------------------------------------


def _is_dataclass_instance(obj: Any) -> bool:
    return dataclasses.is_dataclass(obj) and not isinstance(obj, type)


def to_dict(cfg: Any) -> Any:
    if _is_dataclass_instance(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg


def _coerce(value: Any, target: Any) -> Any:
    """Coerce a YAML/CLI value to the type of the existing default."""
    if target is None or value is None:
        return value
    if isinstance(target, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(target, int) and not isinstance(target, bool):
        return int(value)
    if isinstance(target, float):
        return float(value)
    if isinstance(target, str):
        return str(value)
    if isinstance(target, (list, tuple)) and isinstance(value, str):
        return yaml.safe_load(value)
    return value


def merge_into(cfg: Any, data: Dict[str, Any], _path: str = "") -> Any:
    """Recursively merge a dict into a dataclass tree (in place), coercing types."""
    for key, value in data.items():
        if not hasattr(cfg, key):
            raise KeyError(f"Unknown config key: {_path}{key}")
        cur = getattr(cfg, key)
        if _is_dataclass_instance(cur) and isinstance(value, dict):
            merge_into(cur, value, _path=f"{_path}{key}.")
        else:
            setattr(cfg, key, _coerce(value, cur))
    return cfg


def set_by_path(cfg: Any, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    obj = cfg
    for p in parts[:-1]:
        if not hasattr(obj, p):
            raise KeyError(f"Unknown config key: {dotted}")
        obj = getattr(obj, p)
    leaf = parts[-1]
    if not hasattr(obj, leaf):
        raise KeyError(f"Unknown config key: {dotted}")
    cur = getattr(obj, leaf)
    parsed = yaml.safe_load(value) if isinstance(value, str) else value
    setattr(obj, leaf, _coerce(parsed, cur))


def parse_overrides(argv: List[str]) -> Tuple[Dict[str, str], List[str]]:
    """Split argv into {dotted_key: raw_value} overrides and leftover args.

    Accepts ``++key=val`` and ``key=val`` (hydra-style) tokens.
    """
    overrides: Dict[str, str] = {}
    rest: List[str] = []
    for tok in argv:
        t = tok
        if t.startswith("++"):
            t = t[2:]
        if "=" in t and not t.startswith("-"):
            k, v = t.split("=", 1)
            overrides[k] = v
        else:
            rest.append(tok)
    return overrides, rest


def load_run_config(argv: Optional[List[str]] = None, base: Optional[RunConfig] = None) -> RunConfig:
    """Build a RunConfig from (defaults, optional --config yaml, CLI overrides).

    Priority: CLI ``++k=v`` > yaml > dataclass defaults — identical to the
    reference's documented hydra priority (README.md:135-139).
    """
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = copy.deepcopy(base) if base is not None else RunConfig()

    # --config path/to/file.yaml (also supports --config-path + --config-name)
    yaml_path = None
    cleaned: List[str] = []
    i = 0
    cfg_dir, cfg_name = None, None
    while i < len(argv):
        a = argv[i]
        if a in ("--config", "--config-file") and i + 1 < len(argv):
            yaml_path = argv[i + 1]
            i += 2
        elif a == "--config-path" and i + 1 < len(argv):
            cfg_dir = argv[i + 1]
            i += 2
        elif a == "--config-name" and i + 1 < len(argv):
            cfg_name = argv[i + 1]
            i += 2
        else:
            cleaned.append(a)
            i += 1
    if cfg_dir and cfg_name:
        name = cfg_name if cfg_name.endswith((".yaml", ".yml")) else cfg_name + ".yaml"
        yaml_path = f"{cfg_dir}/{name}"

    if yaml_path:
        with open(yaml_path, "r", encoding="utf-8") as f:
            data = yaml.safe_load(f) or {}
        merge_into(cfg, data)

    overrides, _ = parse_overrides(cleaned)
    for k, v in overrides.items():
        set_by_path(cfg, k, v)
    return cfg
