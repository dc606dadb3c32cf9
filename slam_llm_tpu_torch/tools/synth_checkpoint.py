"""Seeded random checkpoints in the published HF layouts, at any width.

    python -m slam_llm_tpu_torch.tools.synth_checkpoint <out dir> \\
        [--llm tinyllama-1.1b | vicuna-7b | qwen2-7b | none] \\
        [--encoder whisper-small | whisper-large-v3 | wavlm-large | hubert-large | eat-base | beats-iter3 |
                   avhubert-large | ...]
        [--seed 0] [--device cuda]

writes ``<out dir>/llm`` (unless ``--llm none``) and ``<out dir>/whisper``
(or, for a WavLM-family preset, ``<out dir>/wavlm``) with the port's own safetensors writer
(``utils.safetensors_io``), or for an EAT / BEATs preset the torch file
``<out dir>/eat.pt`` / ``<out dir>/beats.pt``, for runs that need
pretrained-shaped weights where the real ones are not at hand. The tensors
are drawn on ``--device`` (the card unless the caller asks for the CPU):

* ``write_llama``: an HF Llama (or, with q/k/v biases, Qwen2) directory:
  ``config.json``, the weights in bf16 over two shards
  (``model-00001-of-00002.safetensors``, ``model-00002-of-00002.safetensors``)
  with ``model.safetensors.index.json``;
* ``write_tokenizer``: a Llama-layout ``tokenizer.json`` (BPE with
  ``byte_fallback``, TinyLlama's Prepend + Replace normalizer, ``<s>``
  template) + ``tokenizer_config.json``: ``<unk>`` ``<s>`` ``</s>``, the 256
  ``<0xXX>`` byte tokens, the transcripts' alphabet, then seeded merges of
  two existing tokens until the vocabulary holds ``vocab_size`` entries;
* ``write_qwen2_tokenizer``: a ``tokenizer.json`` in qwen2's published
  layout (NFC, qwen2's ``Split`` pattern + ``ByteLevel``, BPE, ``ByteLevel``
  post-processor and decoder) + qwen2's ``tokenizer_config.json``: the 256
  byte characters, merges learned greedily from a corpus (the most frequent
  adjacent pair first), then seeded merges of two existing tokens until the
  BPE holds ``vocab_size`` entries; ``<|endoftext|>`` (eos and pad),
  ``<|im_start|>``, ``<|im_end|>`` follow as special added tokens;
* ``write_whisper``: an HF whisper directory: ``config.json`` and
  ``model.safetensors`` (bf16) with the encoder under ``model.encoder.``, its
  sinusoidal ``embed_positions``, and a few decoder tensors, as a
  ``WhisperForConditionalGeneration`` checkpoint carries them;
* ``write_wavlm``: an HF ``WavLMModel`` (with the relative-position bias) or
  ``HubertModel`` (without) directory: ``config.json`` and
  ``model.safetensors`` (bf16), the positional conv stored under weight norm
  as ``weight_g`` / ``weight_v``, ``rel_attn_embed`` in layer 0 alone, as
  HF's checkpoints hold them;
* ``write_eat``: an EAT fairseq checkpoint, ``{"model": sd}`` (f32, as
  the published files) in the data2vec2 layout
  (``modality_encoders.IMAGE.local_encoder.proj``, ``extra_tokens``,
  ``blocks.N.attn.qkv`` fused, the top-level ``norm``);
* ``write_beats``: an official BEATs checkpoint, ``{"cfg": {...}, "model":
  sd}`` (f32), the positional conv under weight norm in the
  ``parametrizations.weight.original0`` / ``original1`` form and the
  relative-position table in every layer (BEATs shares layer 0's);
* ``write_spatial_ast``: a BAT / Spatial-AST checkpoint, ``{"model": sd}``
  (f32), the keys ``models.spatial_ast.convert_spatialast_torch`` reads
  (``--encoder spatialast-base`` writes ``<out dir>/spatial_ast.pt``);
* ``write_avhubert``: a fairseq AV-HuBERT checkpoint, ``{"model": sd}``
  (f32): the ResNet frontend with unfolded BatchNorms and PReLUs, the
  positional conv under weight norm, the pre-LN layers
  (``--encoder avhubert-large`` writes ``<out dir>/avhubert.pt``).

The torch files hold tensors and plain dicts only, so
``utils.hf_loader.load_torch_checkpoint`` reads them without fairseq or
omegaconf.

For CLAP and FENSE, called from Python:

* ``write_clap``: a reference ASE checkpoint, ``{"model": sd}`` (f32), with
  ``audio_encoder.audio_enc.*`` (HTSAT or Cnn14), ``text_encoder.text_enc.*``
  (HF ``BertModel`` names), the ``audio_proj`` / ``text_proj`` Sequentials
  (``.0`` and ``.2``) and ``temp``;
* ``write_bert_vocab``: a BERT ``vocab.txt``: ``[PAD] [UNK] [CLS] [SEP]
  [MASK]``, the given words, letters, digits and punctuation with their
  ``##`` pieces, then made-up lower-case words and ``##`` pieces to the size;
* ``write_sbert``: an HF ``BertModel`` directory (``config.json``,
  ``model.safetensors`` in f32, ``vocab.txt``), by default TinyBERT-L6-shaped
  (312 wide, 6 layers, 12 heads, ffn 1200), as FENSE's SBERT;
* ``write_echecker``: FENSE's error-detector ``.ckpt``,
  ``{"model_state_dict": sd}`` with a BERT (base by default) under
  ``encoder.`` and the 6-way ``clf`` head.

For the S2S vocoders, called from Python: ``write_cosyvoice`` (CosyVoice's
``flow.pt`` and ``hift.pt``, plain f32 state dicts in the reference's key
layout, the convolutions of HiFT under weight norm as ``weight_g`` /
``weight_v``) and ``write_snac`` (the snac package's decoder state dict,
weight-normed); ``*_state_dict`` return the dicts.

For VALL-E X, called from Python: ``write_encodec`` (an HF ``EncodecModel``
``model.safetensors``, facebook/encodec_24khz's widths by default: the
quantizer's codebooks and the decoder, weight-normed as ``weight_g`` /
``weight_v``) and ``write_vallex_corpus`` (a jsonl of phoneme ids and
8-codebook codec codes).

The SELD, MIR and E-chat recipes' synthetic corpora, called from Python:
``write_seld_corpus`` (32 kHz mono clips, 2-channel IR ``.npy`` files and
``{qa_data_root}/{stage}/{split}.json`` manifests), ``write_music_corpus``
(24 kHz clips of 8-14 s and a jsonl) and ``write_echat_corpus`` (a dialog
TSV over 16 kHz turns).

Linear weights are normal with std 1/sqrt(fan_in), embeddings with std 1
(the CLAP and FENSE files' with std 1/sqrt(width)), norm scales 1 + N(0,
0.05^2), biases N(0, 0.02^2). Each ``write_*`` returns the bytes it wrote.
"""

from __future__ import annotations

import json
import math
import os
import sys
import unicodedata
from collections import Counter
from typing import Dict, Iterable

import numpy as np
import torch

from slam_llm_tpu_torch.data.tokenizer import BYTE_TO_UNICODE, QWEN2_SPLIT, split_pretokens
from slam_llm_tpu_torch.models.layers import sinusoidal_positions
from slam_llm_tpu_torch.utils.safetensors_io import save_file

ALPHABET = "▁abcdefghijklmnopqrstuvwxyz0123456789.,'?!:"
MAX_TOKEN_CHARS = 12  # the longest merged token
DTYPE = torch.bfloat16


class _Draw:
    """Seeded tensors, drawn on ``device``, stored in bf16 on the CPU."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.device = device

    def normal(self, shape, std: float, mean: float = 0.0) -> torch.Tensor:
        x = torch.randn(shape, generator=self.gen, device=self.device) * std + mean
        return x.to(DTYPE).cpu()

    def linear(self, out_f: int, in_f: int) -> torch.Tensor:
        return self.normal((out_f, in_f), 1.0 / math.sqrt(in_f))


def write_llama(out_dir: str, cfg, seed: int = 0, device="cpu") -> int:
    """An HF Llama directory for ``cfg`` (the port's ``LLMConfig``)."""
    d = _Draw(seed, device)
    hd = cfg.head_dim
    first: Dict[str, torch.Tensor] = {"model.embed_tokens.weight": d.normal((cfg.vocab_size, cfg.d_model), 1.0)}
    second: Dict[str, torch.Tensor] = {}
    for i in range(cfg.n_layers):
        shard = first if i < (cfg.n_layers + 1) // 2 else second
        p = f"model.layers.{i}."
        shard[p + "input_layernorm.weight"] = d.normal((cfg.d_model,), 0.05, 1.0)
        shard[p + "post_attention_layernorm.weight"] = d.normal((cfg.d_model,), 0.05, 1.0)
        for name, out_f, in_f in (("q_proj", cfg.n_heads * hd, cfg.d_model), ("k_proj", cfg.n_kv_heads * hd, cfg.d_model),
                                  ("v_proj", cfg.n_kv_heads * hd, cfg.d_model), ("o_proj", cfg.d_model, cfg.n_heads * hd)):
            shard[f"{p}self_attn.{name}.weight"] = d.linear(out_f, in_f)
            if cfg.qkv_bias and name != "o_proj":
                shard[f"{p}self_attn.{name}.bias"] = d.normal((out_f,), 0.02)
        for name, out_f, in_f in (("gate_proj", cfg.ffn_dim, cfg.d_model), ("up_proj", cfg.ffn_dim, cfg.d_model),
                                  ("down_proj", cfg.d_model, cfg.ffn_dim)):
            shard[f"{p}mlp.{name}.weight"] = d.linear(out_f, in_f)
    second["model.norm.weight"] = d.normal((cfg.d_model,), 0.05, 1.0)
    if not cfg.tied_embeddings:
        second["lm_head.weight"] = d.linear(cfg.vocab_size, cfg.d_model)
    os.makedirs(out_dir, exist_ok=True)
    names = ("model-00001-of-00002.safetensors", "model-00002-of-00002.safetensors")
    written = sum(save_file(shard, os.path.join(out_dir, name), metadata={"format": "pt"})
                  for shard, name in zip((first, second), names))
    index = {"metadata": {"total_size": sum(t.numel() * t.element_size() for s in (first, second) for t in s.values())},
             "weight_map": {k: name for shard, name in zip((first, second), names) for k in shard}}
    qwen2 = bool(cfg.qkv_bias)
    config = {
        "architectures": ["Qwen2ForCausalLM" if qwen2 else "LlamaForCausalLM"],
        "model_type": "qwen2" if qwen2 else "llama", "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.d_model, "intermediate_size": cfg.ffn_dim, "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads, "num_key_value_heads": cfg.n_kv_heads, "head_dim": hd,
        "rms_norm_eps": cfg.rms_eps, "rope_theta": cfg.rope_theta, "max_position_embeddings": 2048,
        "tie_word_embeddings": cfg.tied_embeddings, "attention_bias": bool(cfg.qkv_bias), "hidden_act": "silu",
        "bos_token_id": 1, "eos_token_id": 2, "torch_dtype": "bfloat16",
    }
    return written + _write_json(out_dir, "model.safetensors.index.json", index) + _write_json(out_dir, "config.json", config)


def write_tokenizer(out_dir: str, vocab_size: int, seed: int = 0) -> int:
    """A Llama-layout ``tokenizer.json`` + ``tokenizer_config.json`` of
    ``vocab_size`` entries (module docstring)."""
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2, **{f"<0x{b:02X}>": 3 + b for b in range(256)}}
    words = []
    for ch in ALPHABET:
        if ch not in vocab:
            vocab[ch] = len(vocab)
            words.append(ch)
    if vocab_size < len(vocab):
        raise ValueError(f"vocab_size {vocab_size} < the {len(vocab)} specials, bytes and alphabet")
    rng = np.random.default_rng(seed)
    merges = []
    while len(vocab) < vocab_size:
        # early tokens are drawn more often, so merges build on merges
        a, b = (words[int(len(words) * rng.random() ** 2)] for _ in range(2))
        if len(a) + len(b) > MAX_TOKEN_CHARS or a + b in vocab or b.startswith("▁"):
            continue
        vocab[a + b] = len(vocab)
        words.append(a + b)
        merges.append(f"{a} {b}")
    added = [{"id": i, "content": t, "single_word": False, "lstrip": False, "rstrip": False, "normalized": False,
              "special": True} for i, t in enumerate(("<unk>", "<s>", "</s>"))]
    spec = {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"}, {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]},
        "pre_tokenizer": None,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}}, {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}}, {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "<s>", "type_id": 1}}, {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {"<s>": {"id": "<s>", "ids": [1], "tokens": ["<s>"]}}},
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "}, {"type": "ByteFallback"},
            {"type": "Fuse"}, {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>", "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": merges},
    }
    config = {"tokenizer_class": "LlamaTokenizerFast", "bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>",
              "pad_token": None, "add_bos_token": True, "add_eos_token": False, "legacy": False,
              "clean_up_tokenization_spaces": False, "model_max_length": 2048}
    return _write_json(out_dir, "tokenizer.json", spec) + _write_json(out_dir, "tokenizer_config.json", config)


QWEN2_SPECIALS = ("<|endoftext|>", "<|im_start|>", "<|im_end|>")
QWEN2_BPE = 151643  # qwen2's BPE entries before its special tokens


def write_qwen2_tokenizer(out_dir: str, vocab_size: int = QWEN2_BPE, seed: int = 0, corpus: Iterable[str] = ()) -> int:
    """A qwen2-layout ``tokenizer.json`` + ``tokenizer_config.json`` whose BPE
    holds ``vocab_size`` entries (module docstring); ``corpus`` is the text
    its first merges are learned from."""
    vocab = {ch: i for i, ch in enumerate(BYTE_TO_UNICODE.values())}
    if vocab_size < len(vocab):
        raise ValueError(f"vocab_size {vocab_size} < the 256 byte characters")
    merges = []
    # greedy BPE over the corpus: the most frequent adjacent pair (the first
    # seen of equal counts) merges next, while a pair occurs twice or more
    words = Counter("".join(BYTE_TO_UNICODE[b] for b in w.encode("utf-8"))
                    for text in corpus for w in split_pretokens(unicodedata.normalize("NFC", text), 1))
    seqs = {w: list(w) for w in words}
    while len(vocab) < vocab_size:
        pairs: Counter = Counter()
        for w, n in words.items():
            for pair in zip(seqs[w], seqs[w][1:]):
                pairs[pair] += n
        if not pairs or pairs.most_common(1)[0][1] < 2:
            break
        (a, b), _ = pairs.most_common(1)[0]
        vocab.setdefault(a + b, len(vocab))  # ("ab", "c") and ("a", "bc") make one token
        merges.append(f"{a} {b}")
        for w, sq in seqs.items():
            out, i = [], 0
            while i < len(sq):
                if i + 1 < len(sq) and sq[i] == a and sq[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(sq[i])
                    i += 1
            seqs[w] = out
    # then seeded merges of two existing tokens, early tokens drawn more often
    tokens = list(vocab)
    rng = np.random.default_rng(seed)
    space = BYTE_TO_UNICODE[ord(" ")]
    while len(vocab) < vocab_size:
        a, b = (tokens[int(len(tokens) * rng.random() ** 2)] for _ in range(2))
        if len(a) + len(b) > MAX_TOKEN_CHARS or a + b in vocab or space in b:
            continue
        vocab[a + b] = len(vocab)
        tokens.append(a + b)
        merges.append(f"{a} {b}")
    added = [{"id": vocab_size + i, "content": t, "single_word": False, "lstrip": False, "rstrip": False,
              "normalized": False, "special": True} for i, t in enumerate(QWEN2_SPECIALS)]
    level = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False, "use_regex": False}
    spec = {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": {"type": "NFC"},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": QWEN2_SPLIT}, "behavior": "Isolated", "invert": False}, level]},
        "post_processor": level, "decoder": level,
        "model": {"type": "BPE", "dropout": None, "unk_token": None, "continuing_subword_prefix": "",
                  "end_of_word_suffix": "", "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                  "vocab": vocab, "merges": merges},
    }
    config = {
        "tokenizer_class": "Qwen2Tokenizer", "add_prefix_space": False, "bos_token": None,
        "eos_token": QWEN2_SPECIALS[0], "pad_token": QWEN2_SPECIALS[0], "unk_token": None,
        "additional_special_tokens": list(QWEN2_SPECIALS[1:]), "clean_up_tokenization_spaces": False,
        "errors": "replace", "model_max_length": 32768, "split_special_tokens": False,
        "added_tokens_decoder": {str(t["id"]): {k: v for k, v in t.items() if k != "id"} for t in added},
    }
    return _write_json(out_dir, "tokenizer.json", spec) + _write_json(out_dir, "tokenizer_config.json", config)


def write_whisper(out_dir: str, cfg, seed: int = 0, device="cpu", decoder_vocab: int = 51865) -> int:
    """An HF whisper directory for ``cfg`` (the port's ``WhisperEncoderConfig``)
    with ``decoder_vocab`` rows of decoder embedding (whisper's 51865)."""
    d = _Draw(seed, device)
    dm, p = cfg.d_model, "model.encoder."
    sd: Dict[str, torch.Tensor] = {
        p + "conv1.weight": d.normal((dm, cfg.n_mels, 3), 1.0 / math.sqrt(3 * cfg.n_mels)),
        p + "conv1.bias": d.normal((dm,), 0.02),
        p + "conv2.weight": d.normal((dm, dm, 3), 1.0 / math.sqrt(3 * dm)),
        p + "conv2.bias": d.normal((dm,), 0.02),
        p + "embed_positions.weight": sinusoidal_positions(cfg.max_source_positions, dm).to(DTYPE),
        p + "layer_norm.weight": d.normal((dm,), 0.05, 1.0),
        p + "layer_norm.bias": d.normal((dm,), 0.02),
    }
    for i in range(cfg.n_layers):
        q = f"{p}layers.{i}."
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            sd[f"{q}{ln}.weight"] = d.normal((dm,), 0.05, 1.0)
            sd[f"{q}{ln}.bias"] = d.normal((dm,), 0.02)
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{q}self_attn.{name}.weight"] = d.linear(dm, dm)
            if name != "k_proj":
                sd[f"{q}self_attn.{name}.bias"] = d.normal((dm,), 0.02)
        sd[q + "fc1.weight"], sd[q + "fc1.bias"] = d.linear(4 * dm, dm), d.normal((4 * dm,), 0.02)
        sd[q + "fc2.weight"], sd[q + "fc2.bias"] = d.linear(dm, 4 * dm), d.normal((dm,), 0.02)
    # the decoder tensors a whisper checkpoint also carries (the port never loads them)
    sd["model.decoder.embed_tokens.weight"] = d.normal((decoder_vocab, dm), 0.02)
    sd["model.decoder.layer_norm.weight"] = d.normal((dm,), 0.05, 1.0)
    sd["model.decoder.layer_norm.bias"] = d.normal((dm,), 0.02)
    config = {
        "architectures": ["WhisperForConditionalGeneration"], "model_type": "whisper", "num_mel_bins": cfg.n_mels,
        "d_model": dm, "encoder_layers": cfg.n_layers, "encoder_attention_heads": cfg.n_heads,
        "encoder_ffn_dim": 4 * dm, "decoder_layers": 1, "decoder_attention_heads": cfg.n_heads,
        "decoder_ffn_dim": 4 * dm, "max_source_positions": cfg.max_source_positions, "max_target_positions": 448,
        "vocab_size": decoder_vocab, "torch_dtype": "bfloat16",
    }
    written = save_file(sd, os.path.join(out_dir, "model.safetensors"), metadata={"format": "pt"})
    return written + _write_json(out_dir, "config.json", config)


def write_wavlm(out_dir: str, cfg, seed: int = 0, device="cpu") -> int:
    """An HF WavLM / HuBERT directory for ``cfg`` (the port's ``WavLMConfig``)."""
    d = _Draw(seed, device)
    dm, hd, k = cfg.d_model, cfg.d_model // cfg.n_heads, cfg.conv_pos
    fe = "feature_extractor.conv_layers."
    sd: Dict[str, torch.Tensor] = {}
    c_in = 1
    for i, (dim, width) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        sd[f"{fe}{i}.conv.weight"] = d.normal((dim, c_in, width), 1.0 / math.sqrt(c_in * width))
        if cfg.feat_extract_norm == "layer" or i == 0:  # "group": a GroupNorm after conv 0 alone
            sd[f"{fe}{i}.layer_norm.weight"] = d.normal((dim,), 0.05, 1.0)
            sd[f"{fe}{i}.layer_norm.bias"] = d.normal((dim,), 0.02)
        c_in = dim
    sd["feature_projection.layer_norm.weight"] = d.normal((c_in,), 0.05, 1.0)
    sd["feature_projection.layer_norm.bias"] = d.normal((c_in,), 0.02)
    sd["feature_projection.projection.weight"] = d.linear(dm, c_in)
    sd["feature_projection.projection.bias"] = d.normal((dm,), 0.02)
    # weight norm over every axis but the taps: w = g * v / ||v||
    per_group = dm // cfg.conv_pos_groups
    v = d.normal((dm, per_group, k), 1.0 / math.sqrt(per_group * k))
    norm = v.float().square().sum(dim=(0, 1), keepdim=True).sqrt()
    sd["encoder.pos_conv_embed.conv.weight_v"] = v
    sd["encoder.pos_conv_embed.conv.weight_g"] = (norm * (1.0 + 0.05 * d.normal((1, 1, k), 1.0).float())).to(DTYPE)
    sd["encoder.pos_conv_embed.conv.bias"] = d.normal((dm,), 0.02)
    sd["encoder.layer_norm.weight"] = d.normal((dm,), 0.05, 1.0)
    sd["encoder.layer_norm.bias"] = d.normal((dm,), 0.02)
    sd["masked_spec_embed"] = d.normal((dm,), 1.0)
    for i in range(cfg.n_layers):
        p = f"encoder.layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{p}attention.{name}.weight"] = d.linear(dm, dm)
            sd[f"{p}attention.{name}.bias"] = d.normal((dm,), 0.02)
        if cfg.rel_bias:
            sd[p + "attention.gru_rel_pos_linear.weight"] = d.linear(8, hd)
            sd[p + "attention.gru_rel_pos_linear.bias"] = d.normal((8,), 0.02)
            sd[p + "attention.gru_rel_pos_const"] = d.normal((1, cfg.n_heads, 1, 1), 0.05, 1.0)
            if i == 0:
                sd[p + "attention.rel_attn_embed.weight"] = d.normal((cfg.num_buckets, cfg.n_heads), 0.02)
        for ln in ("layer_norm", "final_layer_norm"):
            sd[f"{p}{ln}.weight"] = d.normal((dm,), 0.05, 1.0)
            sd[f"{p}{ln}.bias"] = d.normal((dm,), 0.02)
        sd[p + "feed_forward.intermediate_dense.weight"] = d.linear(cfg.ffn_dim, dm)
        sd[p + "feed_forward.intermediate_dense.bias"] = d.normal((cfg.ffn_dim,), 0.02)
        sd[p + "feed_forward.output_dense.weight"] = d.linear(dm, cfg.ffn_dim)
        sd[p + "feed_forward.output_dense.bias"] = d.normal((dm,), 0.02)
    kind = "wavlm" if cfg.rel_bias else "hubert"
    config = {
        "architectures": ["WavLMModel" if cfg.rel_bias else "HubertModel"], "model_type": kind,
        "hidden_size": dm, "num_hidden_layers": cfg.n_layers, "num_attention_heads": cfg.n_heads,
        "intermediate_size": cfg.ffn_dim, "hidden_act": "gelu", "conv_dim": list(cfg.conv_dim),
        "conv_kernel": list(cfg.conv_kernel), "conv_stride": list(cfg.conv_stride), "conv_bias": False,
        "feat_extract_norm": cfg.feat_extract_norm, "feat_extract_activation": "gelu",
        "do_stable_layer_norm": cfg.do_stable_layer_norm, "num_conv_pos_embeddings": k,
        "num_conv_pos_embedding_groups": cfg.conv_pos_groups, "layer_norm_eps": cfg.layer_norm_eps,
        "hidden_dropout": 0.0, "attention_dropout": 0.0, "activation_dropout": 0.0, "feat_proj_dropout": 0.0,
        "layerdrop": 0.0, "torch_dtype": "bfloat16",
        **({"num_buckets": cfg.num_buckets, "max_bucket_distance": cfg.max_distance} if cfg.rel_bias else {}),
    }
    written = save_file(sd, os.path.join(out_dir, "model.safetensors"), metadata={"format": "pt"})
    return written + _write_json(out_dir, "config.json", config)


def write_eat(path: str, cfg, seed: int = 0, device="cpu") -> int:
    """An EAT fairseq checkpoint file for ``cfg`` (the port's ``ViTEncoderConfig``)."""
    d = _Draw(seed, device)
    dm, p, hidden = cfg.d_model, cfg.patch_size, int(cfg.d_model * cfg.mlp_ratio)
    pre = "modality_encoders.IMAGE."
    sd: Dict[str, torch.Tensor] = {
        pre + "local_encoder.proj.weight": d.normal((dm, 1, p, p), 1.0 / p),
        pre + "local_encoder.proj.bias": d.normal((dm,), 0.02),
        pre + "extra_tokens": d.normal((1, 1, dm), 0.02),
    }
    for i in range(cfg.n_layers):
        q = f"blocks.{i}."
        for ln in ("norm1", "norm2"):
            sd[f"{q}{ln}.weight"] = d.normal((dm,), 0.05, 1.0)
            sd[f"{q}{ln}.bias"] = d.normal((dm,), 0.02)
        sd[q + "attn.qkv.weight"], sd[q + "attn.qkv.bias"] = d.linear(3 * dm, dm), d.normal((3 * dm,), 0.02)
        sd[q + "attn.proj.weight"], sd[q + "attn.proj.bias"] = d.linear(dm, dm), d.normal((dm,), 0.02)
        sd[q + "mlp.fc1.weight"], sd[q + "mlp.fc1.bias"] = d.linear(hidden, dm), d.normal((hidden,), 0.02)
        sd[q + "mlp.fc2.weight"], sd[q + "mlp.fc2.bias"] = d.linear(dm, hidden), d.normal((dm,), 0.02)
    sd["norm.weight"], sd["norm.bias"] = d.normal((dm,), 0.05, 1.0), d.normal((dm,), 0.02)
    return _save_torch(path, {"model": sd})


def write_spatial_ast(path: str, cfg, seed: int = 0, device="cpu") -> int:
    """A BAT / Spatial-AST checkpoint file for ``cfg`` (the port's
    ``SpatialASTConfig``), ``{"model": sd}`` in f32: the affine-free
    ``bn`` over the two log-mel channels, ``conv_downsample`` (conv + its
    BatchNorm), ``patch_embed.proj``, ``pos_embed`` (1, 1 + patches, D) with
    the legacy leading slot before the fixed sin-cos table, ``cls_tokens``
    and timm ViT blocks with the fused qkv."""
    from slam_llm_tpu_torch.models.vit import sincos_2d_positions

    d = _Draw(seed, device)
    dm, p, hidden = cfg.d_model, cfg.patch_size, int(cfg.d_model * cfg.mlp_ratio)
    table = torch.from_numpy(sincos_2d_positions(cfg.target_frames // p, cfg.n_mels // p, dm))
    sd: Dict[str, torch.Tensor] = {
        # running statistics of dB log-mels: mean around -10, variance around 100
        "bn.running_mean": d.normal((2,), 2.0, -10.0), "bn.running_var": d.normal((2,), 5.0, 100.0),
        "conv_downsample.0.weight": d.normal((1, 4, 3, 3), 1.0 / 6.0),
        "conv_downsample.1.weight": d.normal((1,), 0.05, 1.0), "conv_downsample.1.bias": d.normal((1,), 0.02),
        "conv_downsample.1.running_mean": d.normal((1,), 0.1), "conv_downsample.1.running_var": d.normal((1,), 0.05, 1.0),
        "patch_embed.proj.weight": d.normal((dm, 1, p, p), 1.0 / p),
        "patch_embed.proj.bias": d.normal((dm,), 0.02),
        "pos_embed": torch.cat([torch.zeros(1, dm), table])[None],
        "cls_tokens": d.normal((1, cfg.n_cls_tokens, dm), 0.02),
    }
    for i in range(cfg.n_layers):
        q = f"blocks.{i}."
        for ln in ("norm1", "norm2"):
            sd[f"{q}{ln}.weight"] = d.normal((dm,), 0.05, 1.0)
            sd[f"{q}{ln}.bias"] = d.normal((dm,), 0.02)
        sd[q + "attn.qkv.weight"], sd[q + "attn.qkv.bias"] = d.linear(3 * dm, dm), d.normal((3 * dm,), 0.02)
        sd[q + "attn.proj.weight"], sd[q + "attn.proj.bias"] = d.linear(dm, dm), d.normal((dm,), 0.02)
        sd[q + "mlp.fc1.weight"], sd[q + "mlp.fc1.bias"] = d.linear(hidden, dm), d.normal((hidden,), 0.02)
        sd[q + "mlp.fc2.weight"], sd[q + "mlp.fc2.bias"] = d.linear(dm, hidden), d.normal((dm,), 0.02)
    return _save_torch(path, {"model": sd})


def write_avhubert(path: str, cfg, seed: int = 0, device="cpu") -> int:
    """A fairseq AV-HuBERT checkpoint file for ``cfg`` (the port's
    ``AVHubertConfig``), ``{"model": sd}`` in f32, the keys
    ``models.avhubert.convert_avhubert_fairseq`` reads: the ResNet video
    frontend with its BatchNorms unfolded (running statistics around 0 / 1)
    and bias-free convs, its PReLUs (slopes around 0.25), both modality
    projections, the fusion LayerNorm and ``post_extract_proj``, the
    positional conv under weight norm (``weight_g`` / ``weight_v``), the
    pre-LN layers and the pretraining ``mask_emb`` (which no converter reads)."""
    d = _Draw(seed, device)
    dm, fd, k = cfg.d_model, cfg.frontend_dim, cfg.conv_pos
    sd: Dict[str, torch.Tensor] = {}

    def conv(key, shape):
        sd[key] = d.normal(shape, 1.0 / math.sqrt(int(np.prod(shape[1:]))))

    def bn(prefix, n):
        sd[prefix + ".weight"], sd[prefix + ".bias"] = d.normal((n,), 0.05, 1.0), d.normal((n,), 0.02)
        sd[prefix + ".running_mean"], sd[prefix + ".running_var"] = d.normal((n,), 0.1), d.normal((n,), 0.05, 1.0)

    def dense(key, out_f, in_f):
        sd[key + ".weight"], sd[key + ".bias"] = d.linear(out_f, in_f), d.normal((out_f,), 0.02)

    def norm(key, n):
        sd[key + ".weight"], sd[key + ".bias"] = d.normal((n,), 0.05, 1.0), d.normal((n,), 0.02)

    res = "feature_extractor_video.resnet."
    conv(res + "frontend3D.0.weight", (fd, 1, 5, 7, 7))
    bn(res + "frontend3D.1", fd)
    sd[res + "frontend3D.2.weight"] = d.normal((fd,), 0.02, 0.25)
    c_in = fd
    for stage, dim in enumerate([fd, fd * 2, fd * 4, cfg.resnet_dim]):
        for j in range(2):
            blk = f"{res}trunk.layer{stage + 1}.{j}."
            fan_in, stride = (c_in, 1 if stage == 0 else 2) if j == 0 else (dim, 1)
            conv(blk + "conv1.weight", (dim, fan_in, 3, 3))
            bn(blk + "bn1", dim)
            conv(blk + "conv2.weight", (dim, dim, 3, 3))
            bn(blk + "bn2", dim)
            for relu in ("relu1", "relu2"):
                sd[f"{blk}{relu}.weight"] = d.normal((dim,), 0.02, 0.25)
            if stride != 1 or fan_in != dim:
                conv(blk + "downsample.0.weight", (dim, fan_in, 1, 1))
                bn(blk + "downsample.1", dim)
        c_in = dim
    dense("feature_extractor_video.proj", dm, cfg.resnet_dim)
    dense("feature_extractor_audio.proj", dm, cfg.audio_feat_dim)
    norm("layer_norm", 2 * dm)
    dense("post_extract_proj", dm, 2 * dm)
    per_group = dm // cfg.conv_pos_groups
    v = d.normal((dm, per_group, k), 1.0 / math.sqrt(per_group * k))
    norm_v = v.float().square().sum(dim=(0, 1), keepdim=True).sqrt()
    sd["encoder.pos_conv.0.weight_v"] = v
    sd["encoder.pos_conv.0.weight_g"] = (norm_v * (1.0 + 0.05 * d.normal((1, 1, k), 1.0).float())).to(DTYPE)
    sd["encoder.pos_conv.0.bias"] = d.normal((dm,), 0.02)
    for i in range(cfg.n_layers):
        p = f"encoder.layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense(f"{p}self_attn.{name}", dm, dm)
        norm(p + "self_attn_layer_norm", dm)
        dense(p + "fc1", cfg.ffn_dim, dm)
        dense(p + "fc2", dm, cfg.ffn_dim)
        norm(p + "final_layer_norm", dm)
    norm("encoder.layer_norm", dm)
    sd["mask_emb"] = d.normal((dm,), 1.0)
    return _save_torch(path, {"model": sd})


def write_beats(path: str, cfg, seed: int = 0, device="cpu") -> int:
    """An official BEATs checkpoint file for ``cfg`` (the port's ``BEATsEncoderConfig``)."""
    d = _Draw(seed, device)
    dm, pe, p, k = cfg.d_model, cfg.patch_embed_dim, cfg.patch_size, cfg.conv_pos
    sd: Dict[str, torch.Tensor] = {
        "patch_embedding.weight": d.normal((pe, 1, p, p), 1.0 / p),
        "layer_norm.weight": d.normal((pe,), 0.05, 1.0),
        "layer_norm.bias": d.normal((pe,), 0.02),
        "post_extract_proj.weight": d.linear(dm, pe),
        "post_extract_proj.bias": d.normal((dm,), 0.02),
    }
    # weight norm over every axis but the taps (dim=2): w = g * v / ||v||
    per_group = dm // cfg.conv_pos_groups
    v = d.normal((dm, per_group, k), 1.0 / math.sqrt(per_group * k))
    norm = v.float().square().sum(dim=(0, 1), keepdim=True).sqrt()
    sd["encoder.pos_conv.0.parametrizations.weight.original0"] = (
        norm * (1.0 + 0.05 * d.normal((1, 1, k), 1.0).float())).to(DTYPE)
    sd["encoder.pos_conv.0.parametrizations.weight.original1"] = v
    sd["encoder.pos_conv.0.bias"] = d.normal((dm,), 0.02)
    sd["encoder.layer_norm.weight"] = d.normal((dm,), 0.05, 1.0)
    sd["encoder.layer_norm.bias"] = d.normal((dm,), 0.02)
    rel = d.normal((cfg.num_buckets, cfg.n_heads), 0.02)
    for i in range(cfg.n_layers):
        q = f"encoder.layers.{i}."
        for name in ("k_proj", "v_proj", "q_proj", "out_proj"):
            sd[f"{q}self_attn.{name}.weight"] = d.linear(dm, dm)
            sd[f"{q}self_attn.{name}.bias"] = d.normal((dm,), 0.02)
        sd[q + "self_attn.grep_linear.weight"] = d.linear(8, dm // cfg.n_heads)
        sd[q + "self_attn.grep_linear.bias"] = d.normal((8,), 0.02)
        sd[q + "self_attn.grep_a"] = d.normal((1, cfg.n_heads, 1, 1), 0.05, 1.0)
        sd[q + "self_attn.relative_attention_bias.weight"] = rel
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            sd[f"{q}{ln}.weight"] = d.normal((dm,), 0.05, 1.0)
            sd[f"{q}{ln}.bias"] = d.normal((dm,), 0.02)
        sd[q + "fc1.weight"], sd[q + "fc1.bias"] = d.linear(cfg.ffn_dim, dm), d.normal((cfg.ffn_dim,), 0.02)
        sd[q + "fc2.weight"], sd[q + "fc2.bias"] = d.linear(dm, cfg.ffn_dim), d.normal((dm,), 0.02)
    beats_cfg = {
        "input_patch_size": p, "embed_dim": pe, "conv_bias": False, "encoder_layers": cfg.n_layers,
        "encoder_embed_dim": dm, "encoder_ffn_embed_dim": cfg.ffn_dim, "encoder_attention_heads": cfg.n_heads,
        "activation_fn": "gelu", "layer_wise_gradient_decay_ratio": 1.0, "layer_norm_first": False,
        "deep_norm": True, "dropout": 0.0, "attention_dropout": 0.0, "activation_dropout": 0.0,
        "encoder_layerdrop": 0.0, "dropout_input": 0.0, "conv_pos": k, "conv_pos_groups": cfg.conv_pos_groups,
        "relative_position_embedding": True, "num_buckets": cfg.num_buckets,
        "max_distance": cfg.max_distance, "gru_rel_pos": True, "finetuned_model": False,
    }
    return _save_torch(path, {"cfg": beats_cfg, "model": sd})


def _random_state(module: torch.nn.Module, d: _Draw) -> Dict[str, torch.Tensor]:
    """A random tensor for each ``state_dict`` entry of ``module`` (built on
    the meta device): 1-D weights are norm scales, 2-D and wider weights
    (linear, conv, embedding, the bias tables) normal with std
    1/sqrt(fan_in), BatchNorm statistics near 0 / 1."""
    out = {}
    for name, t in module.state_dict().items():
        leaf, shape = name.rsplit(".", 1)[-1], tuple(t.shape)
        if leaf == "running_mean":
            out[name] = d.normal(shape, 0.1)
        elif leaf == "running_var":
            out[name] = d.normal(shape, 0.1, 1.0).abs()
        elif leaf == "weight" and len(shape) == 1:
            out[name] = d.normal(shape, 0.05, 1.0)
        elif len(shape) <= 1:
            out[name] = d.normal(shape, 0.02)
        else:
            out[name] = d.normal(shape, 1.0 / math.sqrt(math.prod(shape[1:])))
    return out


def write_clap(path: str, cfg, seed: int = 0, device="cpu") -> int:
    """A reference ASE checkpoint file for ``cfg`` (the port's ``CLAPConfig``)."""
    from slam_llm_tpu_torch.models.clap import CLAP

    wrap = {"audio_enc.": "audio_encoder.audio_enc.", "text_enc.": "text_encoder.text_enc."}
    sd = {}
    for name, t in _random_state(CLAP(cfg, device="meta"), _Draw(seed, device)).items():
        head, _, rest = name.partition(".")
        sd[wrap.get(head + ".", head + ".") + rest if rest else name] = t
    sd["temp"] = torch.tensor(cfg.temp_init)
    return _save_torch(path, {"model": sd})


# ---------------------------------------------------------------------------
# the S2S vocoders: CosyVoice's flow.pt / hift.pt and SNAC, plain f32 state dicts
# ---------------------------------------------------------------------------


class _Vocoder:
    """A plain f32 state dict built key by key: weight-normed convolutions as
    ``weight_g`` / ``weight_v`` (g the norm of v over every axis but 0, so
    the folded kernel is v), Snake alphas near 1."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.device, self.sd = device, {}

    def _normal(self, shape, std: float, mean: float = 0.0) -> torch.Tensor:
        return (torch.randn(shape, generator=self.gen, device=self.device) * std + mean).float().cpu()

    def dense(self, name: str, shape, bias: bool = True):
        self.sd[f"{name}.weight"] = self._normal(shape, 1.0 / math.sqrt(math.prod(shape[1:])))
        if bias:
            self.sd[f"{name}.bias"] = self._normal((shape[0],), 0.02)

    def wn(self, name: str, shape, bias: bool = True, transposed: bool = False):
        """A weight-normed Conv1d (O, I, K), or ConvTranspose1d (I, O, K)."""
        fan_in = shape[0] * shape[2] if transposed else math.prod(shape[1:])
        v = self._normal(shape, 1.0 / math.sqrt(fan_in))
        self.sd[f"{name}.weight_v"] = v
        self.sd[f"{name}.weight_g"] = v.square().sum(dim=(1, 2), keepdim=True).sqrt()
        if bias:
            self.sd[f"{name}.bias"] = self._normal((shape[1] if transposed else shape[0],), 0.02)

    def norm(self, name: str, dim: int):
        self.sd[f"{name}.weight"], self.sd[f"{name}.bias"] = self._normal((dim,), 0.05, 1.0), self._normal((dim,), 0.02)

    def alpha(self, name: str, shape):
        self.sd[name] = self._normal(shape, 0.05, 1.0).abs()


def hift_state_dict(cfg, seed: int = 0, device="cpu") -> Dict[str, torch.Tensor]:
    """CosyVoice's ``hift.pt`` (HiFTNet generator) for ``cfg`` (``models.hift.HiFTConfig``)."""
    w = _Vocoder(seed, device)
    cc, base, nfft2 = cfg.f0_cond_channels, cfg.base_channels, cfg.n_fft + 2

    def resblock(pre, ch, k, dilations):
        for j, _ in enumerate(dilations):
            w.wn(f"{pre}.convs1.{j}", (ch, ch, k))
            w.wn(f"{pre}.convs2.{j}", (ch, ch, k))
            w.alpha(f"{pre}.activations1.{j}.alpha", (ch,))
            w.alpha(f"{pre}.activations2.{j}.alpha", (ch,))

    for i in range(5):
        w.wn(f"f0_predictor.condnet.{2 * i}", (cc, cfg.in_channels if i == 0 else cc, 3))
    w.dense("f0_predictor.classifier", (1, cc))
    w.dense("m_source.l_linear", (1, cfg.nb_harmonics + 1))
    w.wn("conv_pre", (base, cfg.in_channels, 7))
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        w.wn(f"ups.{i}", (base // 2 ** i, base // 2 ** (i + 1), k), transposed=True)
    cum = np.cumprod([1] + list(cfg.upsample_rates[::-1][:-1]))[::-1]
    for i, (u, k, d) in enumerate(zip(cum, cfg.source_resblock_kernel_sizes, cfg.source_resblock_dilations)):
        ch = base // 2 ** (i + 1)
        w.dense(f"source_downs.{i}", (ch, nfft2, 1 if int(u) == 1 else 2 * int(u)))
        resblock(f"source_resblocks.{i}", ch, k, d)
    nk = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        for j, (k, d) in enumerate(zip(cfg.resblock_kernel_sizes, cfg.resblock_dilations)):
            resblock(f"resblocks.{i * nk + j}", base // 2 ** (i + 1), k, d)
    w.wn("conv_post", (nfft2, base // 2 ** len(cfg.upsample_rates), 7))
    return w.sd


def cosyvoice_flow_state_dict(cfg, seed: int = 0, device="cpu") -> Dict[str, torch.Tensor]:
    """CosyVoice's ``flow.pt`` (MaskedDiffWithXvec) for ``cfg`` (``models.cosyvoice_flow.FlowConfig``)."""
    w = _Vocoder(seed, device)
    d, out, heads = cfg.input_size, cfg.output_size, cfg.enc_heads
    w.sd["input_embedding.weight"] = w._normal((cfg.vocab_size, d), 1.0)
    w.dense("spk_embed_affine_layer", (out, cfg.spk_embed_dim))
    w.dense("encoder.embed.out.0", (d, d))
    w.norm("encoder.embed.out.1", d)
    for i in range(cfg.enc_blocks):
        pre = f"encoder.encoders.{i}"
        for n in ("q", "k", "v", "out"):
            w.dense(f"{pre}.self_attn.linear_{n}", (d, d))
        w.dense(f"{pre}.self_attn.linear_pos", (d, d), bias=False)
        for n in ("u", "v"):
            w.sd[f"{pre}.self_attn.pos_bias_{n}"] = w._normal((heads, d // heads), 0.1)
        w.norm(f"{pre}.norm_mha", d)
        w.norm(f"{pre}.norm_ff", d)
        w.dense(f"{pre}.feed_forward.w_1", (cfg.enc_ffn, d))
        w.dense(f"{pre}.feed_forward.w_2", (d, cfg.enc_ffn))
    w.norm("encoder.after_norm", d)
    w.dense("encoder_proj", (out, d))
    for i in range(cfg.regulator_convs):
        w.dense(f"length_regulator.model.{3 * i}", (out, out, 3))
        w.norm(f"length_regulator.model.{3 * i + 1}", out)
    w.dense(f"length_regulator.model.{3 * cfg.regulator_convs}", (out, out, 1))

    est, ch = "decoder.estimator", cfg.est_channels
    tdim = ch[0] * 4

    def resnet(pre, din, dout):
        w.dense(f"{pre}.block1.block.0", (dout, din, 3))
        w.norm(f"{pre}.block1.block.1", dout)
        w.dense(f"{pre}.block2.block.0", (dout, dout, 3))
        w.norm(f"{pre}.block2.block.1", dout)
        w.dense(f"{pre}.mlp.1", (dout, tdim))
        w.dense(f"{pre}.res_conv", (dout, din, 1))

    def transformers(pre, c):
        inner = cfg.est_heads * cfg.est_head_dim
        for j in range(cfg.est_n_blocks):
            tf = f"{pre}.{j}"
            w.norm(f"{tf}.norm1", c)
            for n in ("to_q", "to_k", "to_v"):
                w.dense(f"{tf}.attn1.{n}", (inner, c), bias=False)
            w.dense(f"{tf}.attn1.to_out.0", (c, inner))
            w.norm(f"{tf}.norm3", c)
            w.dense(f"{tf}.ff.net.0.proj", (4 * c, c))
            w.dense(f"{tf}.ff.net.2", (c, 4 * c))

    w.dense(f"{est}.time_mlp.linear_1", (tdim, cfg.est_in_channels))
    w.dense(f"{est}.time_mlp.linear_2", (tdim, tdim))
    in_c = cfg.est_in_channels
    for i, c in enumerate(ch):
        resnet(f"{est}.down_blocks.{i}.0", in_c, c)
        transformers(f"{est}.down_blocks.{i}.1", c)
        w.dense(f"{est}.down_blocks.{i}.2" + (".conv" if i < len(ch) - 1 else ""), (c, c, 3))
        in_c = c
    for i in range(cfg.est_mid_blocks):
        resnet(f"{est}.mid_blocks.{i}.0", ch[-1], ch[-1])
        transformers(f"{est}.mid_blocks.{i}.1", ch[-1])
    rev = tuple(reversed(ch)) + (ch[0],)
    for i in range(len(rev) - 1):
        resnet(f"{est}.up_blocks.{i}.0", rev[i] * 2, rev[i + 1])
        transformers(f"{est}.up_blocks.{i}.1", rev[i + 1])
        if i < len(rev) - 2:  # ConvTranspose1d(c, c, 4, 2, 1): (I, O, K)
            w.dense(f"{est}.up_blocks.{i}.2.conv", (rev[i + 1], rev[i + 1], 4))
        else:
            w.dense(f"{est}.up_blocks.{i}.2", (rev[i + 1], rev[i + 1], 3))
    w.dense(f"{est}.final_block.block.0", (ch[0], ch[0], 3))
    w.norm(f"{est}.final_block.block.1", ch[0])
    w.dense(f"{est}.final_proj", (out, ch[0], 1))
    return w.sd


def snac_state_dict(cfg, seed: int = 0, device="cpu") -> Dict[str, torch.Tensor]:
    """A ``snac`` package decoder state dict (quantizer + decoder) for ``cfg``
    (``models.snac.SNACConfig``; ``SNACConfig.snac_24khz()`` is
    hubertsiuzdak/snac_24khz's)."""
    w = _Vocoder(seed, device)
    for i in range(len(cfg.vq_strides)):
        q = f"quantizer.quantizers.{i}"
        w.sd[f"{q}.codebook.weight"] = w._normal((cfg.codebook_size, cfg.codebook_dim), 1.0)
        w.wn(f"{q}.out_proj", (cfg.latent_dim, cfg.codebook_dim, 1))
    dd = cfg.decoder_dim
    w.wn("decoder.model.0", (dd, cfg.latent_dim, 7))
    for i, stride in enumerate(cfg.decoder_rates):
        base, cin, cout = f"decoder.model.{1 + i}.block", dd // 2 ** i, dd // 2 ** (i + 1)
        w.alpha(f"{base}.0.alpha", (1, cin, 1))
        w.wn(f"{base}.1", (cin, cout, 2 * stride), transposed=True)
        off = 2
        if cfg.noise:
            w.wn(f"{base}.2.linear", (cout, cout, 1), bias=False)
            off = 3
        for j in range(3):
            r = f"{base}.{off + j}.block"
            w.alpha(f"{r}.0.alpha", (1, cout, 1))
            w.wn(f"{r}.1", (cout, 1 if cfg.depthwise else cout, 7))
            w.alpha(f"{r}.2.alpha", (1, cout, 1))
            w.wn(f"{r}.3", (cout, cout, 1))
    last, n = dd // 2 ** len(cfg.decoder_rates), len(cfg.decoder_rates)
    w.alpha(f"decoder.model.{1 + n}.alpha", (1, last, 1))
    w.wn(f"decoder.model.{2 + n}", (1, last, 7))
    return w.sd


def write_cosyvoice(out_dir: str, flow_cfg=None, hift_cfg=None, seed: int = 0, device="cpu") -> int:
    """``<out_dir>/flow.pt`` and ``<out_dir>/hift.pt`` (CosyVoice-300M's
    widths by default): the directory ``model_config.codec_decoder_path``
    takes with ``codec_decoder_type: CosyVoice``."""
    from slam_llm_tpu_torch.models.cosyvoice_flow import FlowConfig
    from slam_llm_tpu_torch.models.hift import HiFTConfig

    os.makedirs(out_dir, exist_ok=True)
    flow, hift = os.path.join(out_dir, "flow.pt"), os.path.join(out_dir, "hift.pt")
    torch.save(cosyvoice_flow_state_dict(flow_cfg or FlowConfig(), seed, device), flow)
    torch.save(hift_state_dict(hift_cfg or HiFTConfig(), seed + 1, device), hift)
    return os.path.getsize(flow) + os.path.getsize(hift)


def encodec_state_dict(cfg, seed: int = 0, device="cpu") -> Dict[str, torch.Tensor]:
    """An HF ``EncodecModel`` state dict's quantizer codebooks
    (``quantizer.layers.{i}.codebook.embed``) and decoder
    (``decoder.layers.{j}``: the input conv, the LSTM, per ratio an ELU, the
    ConvTranspose1d and the ResnetBlocks, then an ELU and the output conv),
    the convolutions under weight norm as ``weight_g`` / ``weight_v``, for
    ``cfg`` (``models.encodec.EncodecConfig``; its default is
    facebook/encodec_24khz's). The encoder is left out: a decode never reads it."""
    w = _Vocoder(seed, device)
    for i in range(cfg.num_quantizers):
        w.sd[f"quantizer.layers.{i}.codebook.embed"] = w._normal((cfg.codebook_size, cfg.hidden_size), 1.0)
    d0 = 2 ** len(cfg.upsampling_ratios) * cfg.num_filters
    w.wn("decoder.layers.0.conv", (d0, cfg.hidden_size, cfg.kernel_size))
    for i in range(cfg.num_lstm_layers):
        for name, shape in (("weight_ih", (4 * d0, d0)), ("weight_hh", (4 * d0, d0))):
            w.sd[f"decoder.layers.1.lstm.{name}_l{i}"] = w._normal(shape, 1.0 / math.sqrt(d0))
        for name in ("bias_ih", "bias_hh"):
            w.sd[f"decoder.layers.1.lstm.{name}_l{i}"] = w._normal((4 * d0,), 0.02)
    idx, dim = 2, d0
    for ratio in cfg.upsampling_ratios:
        out = dim // 2
        w.wn(f"decoder.layers.{idx + 1}.conv", (dim, out, 2 * ratio), transposed=True)
        idx += 2
        for j in range(cfg.num_residual_layers):
            base = f"decoder.layers.{idx}"
            w.wn(f"{base}.block.1.conv", (out // cfg.compress, out, cfg.residual_kernel_size))
            w.wn(f"{base}.block.3.conv", (out, out // cfg.compress, 1))
            if cfg.use_conv_shortcut:
                w.wn(f"{base}.shortcut.conv", (out, out, 1))
            idx += 1
        dim = out
    w.wn(f"decoder.layers.{idx + 1}.conv", (1, dim, cfg.last_kernel_size))
    return w.sd


def write_encodec(out_dir: str, cfg=None, seed: int = 0, device="cpu") -> int:
    """``<out_dir>/model.safetensors``: ``encodec_state_dict`` (EnCodec-24kHz's
    widths by default), the file ``pipeline.inference_vallex --codec_path``
    takes."""
    from slam_llm_tpu_torch.models.encodec import EncodecConfig

    os.makedirs(out_dir, exist_ok=True)
    return save_file(encodec_state_dict(cfg or EncodecConfig.encodec_24khz(), seed, device),
                     os.path.join(out_dir, "model.safetensors"))


def write_vallex_corpus(path: str, n: int, frames=(300, 500), text_len=(20, 64), n_codebooks: int = 8,
                        audio_vocab: int = 1024, text_vocab: int = 512, seed: int = 0) -> str:
    """A VALL-E X jsonl of ``n`` rows ``{key, phonemes, audio_tokens}``:
    phoneme ids (``text_len`` long, evenly spread, below ``text_vocab``)
    and (n_codebooks, T) codec codes (T evenly spread over ``frames``, below
    ``audio_vocab``), seeded."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for i in range(n):
            share = i / max(n - 1, 1)
            nt = int(round(text_len[0] + (text_len[1] - text_len[0]) * share))
            nf = int(round(frames[0] + (frames[1] - frames[0]) * share))
            f.write(json.dumps({"key": f"tts{i}", "phonemes": rng.integers(0, text_vocab, nt).tolist(),
                                "audio_tokens": rng.integers(0, audio_vocab, (n_codebooks, nf)).tolist()}) + "\n")
    return path


def write_snac(path: str, cfg=None, seed: int = 0, device="cpu") -> int:
    """A SNAC state dict file (snac_24khz's widths by default)."""
    from slam_llm_tpu_torch.models.snac import SNACConfig

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(snac_state_dict(cfg or SNACConfig.snac_24khz(), seed, device), path)
    return os.path.getsize(path)


BERT_SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def write_bert_vocab(path: str, size: int = 30522, seed: int = 0, words: Iterable[str] = ()) -> int:
    """A BERT ``vocab.txt`` of ``size`` lines (module docstring); ``words``
    are lower-cased and split on whitespace and punctuation first."""
    chars = list("abcdefghijklmnopqrstuvwxyz0123456789") + list("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")
    seen = dict.fromkeys(BERT_SPECIALS)
    for w in words:
        for piece in "".join(c if c.isalnum() else f" {c} " for c in w.lower()).split():
            seen.setdefault(piece)
    for c in chars:
        seen.setdefault(c)
    for c in chars[:36]:
        seen.setdefault("##" + c)
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    while len(seen) < size:
        n = int(rng.integers(2, 9))
        tok = "".join(rng.choice(letters, n))
        seen.setdefault(("##" + tok[:5]) if rng.random() < 0.3 else tok)
    lines = list(seen)[:size]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    data = ("\n".join(lines) + "\n").encode("utf-8")
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def tinybert_l6():
    """FENSE's SBERT shape: 312 wide, 6 layers, 12 heads, ffn 1200."""
    from slam_llm_tpu_torch.models.bert import BertConfig

    return BertConfig(d_model=312, n_layers=6, n_heads=12, ffn_dim=1200)


def write_sbert(out_dir: str, cfg=None, seed: int = 0, device="cpu", words: Iterable[str] = ()) -> int:
    """An HF ``BertModel`` directory for ``cfg`` (the port's ``BertConfig``,
    TinyBERT-L6-shaped by default) with its ``vocab.txt``."""
    from slam_llm_tpu_torch.models.bert import BertEncoder

    cfg = cfg or tinybert_l6()
    sd = {k: v.float() for k, v in _random_state(BertEncoder(cfg, device="meta"), _Draw(seed, device)).items()}
    os.makedirs(out_dir, exist_ok=True)
    config = {"architectures": ["BertModel"], "model_type": "bert", "vocab_size": cfg.vocab_size,
              "hidden_size": cfg.d_model, "num_hidden_layers": cfg.n_layers, "num_attention_heads": cfg.n_heads,
              "intermediate_size": cfg.ffn_dim, "max_position_embeddings": cfg.max_positions,
              "type_vocab_size": cfg.type_vocab_size, "layer_norm_eps": cfg.ln_eps, "hidden_act": "gelu"}
    return (save_file(sd, os.path.join(out_dir, "model.safetensors"), metadata={"format": "pt"})
            + _write_json(out_dir, "config.json", config)
            + write_bert_vocab(os.path.join(out_dir, "vocab.txt"), cfg.vocab_size, seed, words))


def write_echecker(path: str, cfg=None, seed: int = 0, device="cpu") -> int:
    """FENSE's error-detector checkpoint for ``cfg`` (BERT-base by default)."""
    from slam_llm_tpu_torch.models.bert import BertConfig, BertEncoder

    cfg = cfg or BertConfig.base_uncased()
    d = _Draw(seed, device)
    sd = {f"encoder.{k}": v.float() for k, v in _random_state(BertEncoder(cfg, device="meta"), d).items()}
    sd["clf.weight"], sd["clf.bias"] = d.linear(6, cfg.d_model).float(), d.normal((6,), 1.0).float()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"model_state_dict": sd}, path)
    return os.path.getsize(path)


# ---------------------------------------------------------------------------
# synthetic corpora of the SELD, MIR and E-chat recipes
# ---------------------------------------------------------------------------


def write_wav(path: str, x: np.ndarray, sr: int) -> int:
    """A 16-bit mono wav of ``x`` (floats in [-1, 1])."""
    import wave

    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(x, -1.0, 1.0) * 32767).astype("<i2").tobytes())
    return os.path.getsize(path)


def _clip(rng: np.random.Generator, seconds: float, sr: int, i: int) -> np.ndarray:
    """Two tones and a little noise, distinct per ``i``."""
    t = np.arange(int(seconds * sr)) / sr
    f0 = 110.0 * 2 ** ((i % 24) / 12)
    x = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(2 * np.pi * 3.01 * f0 * t + i)
    return x + 0.02 * rng.standard_normal(t.size)


SELD_QUESTIONS = (("Identify the sound events in the audio clip.", "class"),
                  ("Where is the sound coming from?", "doa"),
                  ("How far away is the sound source?", "distance"))


def write_seld_corpus(root: str, n: int = 16, seed: int = 0, stage: str = "stage1-clsdoa", n_reverbs: int = 4,
                      seconds=(4.0, 12.0), splits=("train", "val", "test"), n_eval: int = None) -> dict:
    """A SpatialSoundQA-shaped corpus under ``root``: ``anechoic/clip{i}.wav``
    (32 kHz mono, ``seconds[0]``-``seconds[1]`` s, so some clips are padded
    and some cut to 10 s), ``reverb/binaural/ir{j}.npy`` (2 x 0.3 s
    two-channel IRs: a decaying noise tail, the right channel delayed and
    damped), and ``qa/{stage}/{split}.json`` ``{"data": [...]}`` manifests of
    ``n`` QA items for train and ``n_eval`` (default ``n``) for the others,
    every fourth a two-source mixup. Returns the dataset_config overrides
    that read it."""
    rng = np.random.default_rng(seed)
    anechoic, reverb = os.path.join(root, "anechoic"), os.path.join(root, "reverb", "binaural")
    os.makedirs(anechoic, exist_ok=True)
    os.makedirs(reverb, exist_ok=True)
    n_clips = min(n, 20) + 4
    for i in range(n_clips):
        sec = seconds[0] + (seconds[1] - seconds[0]) * i / max(n_clips - 1, 1)
        write_wav(os.path.join(anechoic, f"clip{i}.wav"), _clip(rng, sec, 32000, i), 32000)
    length = int(0.3 * 32000)
    for j in range(n_reverbs):
        tail = rng.standard_normal((2, length)) * np.exp(-np.arange(length) / (2000.0 + 500 * j))
        delay = 4 + 7 * j
        tail[1] = 0.6 * np.roll(tail[1], delay)
        tail[:, 0] = (1.0, 0.0)
        tail[1, delay] = 0.7
        np.save(os.path.join(reverb, f"ir{j}.npy"), tail.astype(np.float32))
    for s_i, split in enumerate(splits):
        items = []
        for k in range(n if split == "train" or n_eval is None else n_eval):
            question, kind = SELD_QUESTIONS[k % len(SELD_QUESTIONS)]
            item = {"audio_id": f"clip{(k + s_i) % n_clips}", "reverb_id": f"ir{k % n_reverbs}.npy",
                    "question": question, "answer": f"{kind} answer {k}", "question_type": kind,
                    "question_id": k}
            if k % 4 == 3:
                item.update(audio_id2=f"clip{(k + 5) % n_clips}", reverb_id2=f"ir{(k + 1) % n_reverbs}.npy")
            items.append(item)
        os.makedirs(os.path.join(root, "qa", stage), exist_ok=True)
        with open(os.path.join(root, "qa", stage, f"{split}.json"), "w", encoding="utf-8") as f:
            json.dump({"data": items}, f)
    return {"qa_data_root": os.path.join(root, "qa"), "stage": stage, "anechoic_data_root": anechoic,
            "reverb_data_root": os.path.join(root, "reverb")}


def write_music_corpus(root: str, n: int = 16, seed: int = 0, name: str = "train", seconds=(8.0, 14.0),
                       targets=("a calm piano melody", "an upbeat rock song with drums")) -> str:
    """``n`` 24 kHz music-like clips of ``seconds[0]``-``seconds[1]`` s and a
    ``{key, source, target}`` jsonl manifest; returns its path."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    manifest = os.path.join(root, f"{name}.jsonl")
    with open(manifest, "w", encoding="utf-8") as f:
        for i in range(n):
            sec = seconds[0] + (seconds[1] - seconds[0]) * i / max(n - 1, 1)
            path = os.path.join(root, f"{name}_music{i}.wav")
            write_wav(path, _clip(rng, sec, 24000, i), 24000)
            f.write(json.dumps({"key": f"music{i}", "source": path, "target": targets[i % len(targets)]}) + "\n")
    return manifest


ECHAT_EMOTIONS = ("happy", "sad", "angry", "neutral", "xxx")


def write_echat_corpus(root: str, n_dialogs: int = 8, seed: int = 0, name: str = "echat", python_literal=False) -> str:
    """An E-chat dialog TSV of ``n_dialogs`` dialogs of 3-5 turns (16 kHz
    wavs of 2-6 s; every fifth emotion ``xxx``, which the dataset skips),
    ``dialog_name\\t[{"wav", "emotion", "trans"}, ...]`` as JSON or, with
    ``python_literal``, as a Python literal; returns its path."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, f"{name}.tsv")
    turn = 0
    with open(path, "w", encoding="utf-8") as f:
        for d in range(n_dialogs):
            turns = []
            for _ in range(3 + d % 3):
                wav = os.path.join(root, f"{name}_turn{turn}.wav")
                write_wav(wav, _clip(rng, 2.0 + (turn % 5), 16000, turn), 16000)
                turns.append({"wav": wav, "emotion": ECHAT_EMOTIONS[turn % len(ECHAT_EMOTIONS)],
                              "trans": f"reply number {turn} of dialog {d}"})
                turn += 1
            f.write(f"dialog{d}\t{repr(turns) if python_literal else json.dumps(turns)}\n")
    return path


def _save_torch(path: str, obj: dict) -> int:
    """``obj`` with its ``model`` state dict in f32, the published files' dtype."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({**obj, "model": {k: v.float() for k, v in obj["model"].items()}}, path)
    return os.path.getsize(path)


def _write_json(out_dir: str, name: str, obj) -> int:
    os.makedirs(out_dir, exist_ok=True)
    data = json.dumps(obj, indent=1, ensure_ascii=False).encode("utf-8")
    with open(os.path.join(out_dir, name), "wb") as f:
        f.write(data)
    return len(data)


def main(argv=None) -> dict:
    import argparse

    from slam_llm_tpu_torch.models.avhubert import AVHUBERT_PRESETS
    from slam_llm_tpu_torch.models.beats import BEATS_PRESETS
    from slam_llm_tpu_torch.models.llm import LLMConfig
    from slam_llm_tpu_torch.models.spatial_ast import SPATIAL_AST_PRESETS
    from slam_llm_tpu_torch.models.vit import VIT_PRESETS
    from slam_llm_tpu_torch.models.wavlm import WAVLM_PRESETS
    from slam_llm_tpu_torch.models.whisper import PRESETS as WHISPER_PRESETS
    from slam_llm_tpu_torch.pipeline.common import resolve_device

    llms = {"tinyllama-1.1b": LLMConfig.tinyllama_1_1b, "vicuna-7b": LLMConfig.vicuna_7b,
            "qwen2-7b": LLMConfig.qwen2_7b, "tiny-test": LLMConfig.tiny_test}
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out")
    ap.add_argument("--llm", default="tinyllama-1.1b", choices=sorted(llms) + ["none"])
    encoders = {  # preset -> (its presets, writer, what it writes under <out>)
        **{name: (WHISPER_PRESETS, write_whisper, "whisper") for name in WHISPER_PRESETS},
        **{name: (WAVLM_PRESETS, write_wavlm, "wavlm") for name in WAVLM_PRESETS},
        **{name: (VIT_PRESETS, write_eat, "eat.pt") for name in VIT_PRESETS},
        **{name: (BEATS_PRESETS, write_beats, "beats.pt") for name in BEATS_PRESETS},
        **{name: (SPATIAL_AST_PRESETS, write_spatial_ast, "spatial_ast.pt") for name in SPATIAL_AST_PRESETS},
        **{name: (AVHUBERT_PRESETS, write_avhubert, "avhubert.pt") for name in AVHUBERT_PRESETS},
    }
    ap.add_argument("--encoder", default="whisper-small", choices=sorted(encoders))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # CUDA without a usable GPU raises
    presets, write_encoder, enc_name = encoders[args.encoder]
    llm_dir, enc_dir = os.path.join(args.out, "llm"), os.path.join(args.out, enc_name)
    sizes = {}
    if args.llm != "none":
        llm_cfg = llms[args.llm]()
        tokenizer = (write_qwen2_tokenizer(llm_dir, QWEN2_BPE, args.seed) if args.llm == "qwen2-7b"
                     else write_tokenizer(llm_dir, llm_cfg.vocab_size, args.seed))
        sizes["llm"] = write_llama(llm_dir, llm_cfg, args.seed, args.device) + tokenizer
    sizes["encoder"] = write_encoder(enc_dir, presets[args.encoder](), args.seed + 1, args.device)
    print(json.dumps({"llm_path": llm_dir if "llm" in sizes else None, "encoder_path": enc_dir, "bytes": sizes}))
    return sizes


if __name__ == "__main__":
    main(sys.argv[1:])
