"""Tokenizer loading.

Counterpart of ``slam_llm_tpu/data/tokenizer.py``, which wraps HF
``AutoTokenizer`` (reference models/slam_model.py:54-65) with the
``pad_token = eos_token`` fallback. The port reads a Llama-family
``tokenizer.json`` itself, in plain Python (``LlamaTokenizer``), so no
``transformers`` / ``tokenizers`` is needed; ``ByteTokenizer`` is the
dependency-free byte-level tokenizer of the tests and the synthetic recipes.
"""

from __future__ import annotations

import heapq
import json
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

SPIECE = "▁"  # "▁", sentencepiece's word boundary
_TODO_BYTELEVEL = ("ROADMAP Queue 1 item 4: the ByteLevel BPE tokenizers (qwen2, Llama-3) come with the "
                   "other whisper recipes")


class ByteTokenizer:
    """Deterministic byte-level tokenizer: ids 0..255 = bytes, then specials.

    Used by tests and the tiny end-to-end recipe; interface-compatible with
    the HF tokenizer surface the framework touches (encode/decode,
    bos/eos/pad ids).
    """

    def __init__(self):
        self.bos_token_id = 256
        self.eos_token_id = 257
        self.pad_token_id = 258
        self.vocab_size = 259

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_token_id] + ids) if add_bos else ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        bs = bytes(i for i in ids if 0 <= int(i) < 256)
        return bs.decode("utf-8", errors="ignore")

    def __call__(self, text: str):
        return {"input_ids": self.encode(text)}


class LlamaTokenizer:
    """A Llama-family ``tokenizer.json`` (HF ``tokenizers`` format), encoded
    and decoded as ``AutoTokenizer`` does:

    * added tokens (``<s>``, ``</s>``, ...) are split out of the raw text
      first, leftmost-longest; each piece between them is normalized on its
      own;
    * the normalizer: TinyLlama's ``Prepend("▁")`` + ``Replace(" ", "▁")``,
      or none with the newer ``Metaspace`` pre-tokenizer (``prepend_scheme``
      first, or always / never; ``split`` false);
    * the model: BPE, merges applied by rank (the lowest-ranked adjacent
      pair first, leftmost on ties), a character outside the vocabulary
      falling back to its UTF-8 ``<0xXX>`` byte tokens (``byte_fallback``),
      else to ``<unk>``, consecutive ones fused (``fuse_unk``);
    * the post-processor: ``TemplateProcessing``'s single template (``<s>``
      first); a Llama tokenizer class takes ``add_bos_token`` /
      ``add_eos_token`` from ``tokenizer_config.json``, as transformers'
      ``LlamaTokenizerFast`` rewrites its template from them;
    * the decoder: Replace("▁", " ") -> ByteFallback -> Fuse -> Strip(1, 0);
      ``skip_special_tokens`` drops the special added tokens;
      ``clean_up_tokenization_spaces`` as the config sets it.

    bos / eos / pad come from ``tokenizer_config.json`` or
    ``special_tokens_map.json``; pad is eos when neither sets one.
    ``vocab_size`` counts the added tokens, like ``len(tokenizer)``. ByteLevel
    tokenizers (qwen2, Llama-3) and other components raise
    ``NotImplementedError``.
    """

    def __init__(self, spec: dict, config: Optional[dict] = None):
        config = config or {}
        model = spec.get("model") or {}
        if model.get("type") != "BPE":
            raise NotImplementedError(f"tokenizer model {model.get('type')!r}: only BPE is ported")
        for key in ("continuing_subword_prefix", "end_of_word_suffix", "dropout", "ignore_merges"):
            if model.get(key):
                raise NotImplementedError(f"BPE {key}={model[key]!r} is not ported")
        _refuse_byte_level(spec)
        self.vocab: Dict[str, int] = dict(model["vocab"])
        self.ranks: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, merge in enumerate(model.get("merges", [])):
            a, b = merge.split(" ", 1) if isinstance(merge, str) else merge
            self.ranks[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b])
        self.byte_fallback = bool(model.get("byte_fallback", False))
        self.fuse_unk = bool(model.get("fuse_unk", False))
        self.unk_id = self.vocab.get(model["unk_token"]) if model.get("unk_token") else None

        self.added = sorted(spec.get("added_tokens", []), key=lambda t: -len(t["content"]))
        if any(t.get(key) for t in self.added for key in ("single_word", "lstrip", "rstrip")):
            raise NotImplementedError("added tokens with single_word / lstrip / rstrip are not ported")
        self.id_to_token = {i: tok for tok, i in self.vocab.items()}
        self.id_to_token.update({t["id"]: t["content"] for t in self.added})
        self.special_ids = {t["id"] for t in self.added if t.get("special")}
        self.vocab_size = len({**self.vocab, **{t["content"]: t["id"] for t in self.added}})

        self.normalizers = _flatten(spec.get("normalizer"), "normalizers")
        for n in self.normalizers:
            if n["type"] not in ("Prepend", "Replace"):
                raise NotImplementedError(f"normalizer {n['type']!r} is not ported")
            if n["type"] == "Replace" and "String" not in n["pattern"]:
                raise NotImplementedError("a regex Replace normalizer is not ported")
        pre = _flatten(spec.get("pre_tokenizer"), "pretokenizers")
        if any(p["type"] != "Metaspace" or p.get("split", True) for p in pre) or len(pre) > 1:
            raise NotImplementedError(f"pre-tokenizer {pre} is not ported (Metaspace with split false is)")
        self.metaspace = pre[0] if pre else None
        self.decoders = _flatten(spec.get("decoder"), "decoders")
        for d in self.decoders:
            if d["type"] not in ("Replace", "ByteFallback", "Fuse", "Strip"):
                raise NotImplementedError(f"decoder {d['type']!r} is not ported")

        def token_id(key, default):
            tok = config.get(key, default)
            tok = tok.get("content") if isinstance(tok, dict) else tok
            if tok is None:
                return None
            found = [t["id"] for t in self.added if t["content"] == tok]
            return found[0] if found else self.vocab.get(tok)

        llama = str(config.get("tokenizer_class", "")).startswith("Llama")
        self.bos_token_id = token_id("bos_token", "<s>" if llama else None)
        self.eos_token_id = token_id("eos_token", "</s>" if llama else None)
        pad = token_id("pad_token", None)
        self.pad_token_id = self.eos_token_id if pad is None else pad  # reference slam_model.py:64
        self.prefix, self.suffix = _template(spec.get("post_processor"))
        if llama:  # LlamaTokenizerFast.update_post_processor
            self.prefix = [self.bos_token_id] if config.get("add_bos_token", True) else []
            self.suffix = [self.eos_token_id] if config.get("add_eos_token", False) else []
        self.clean_up_spaces = bool(config.get("clean_up_tokenization_spaces", False))

    @classmethod
    def from_dir(cls, path: str) -> "LlamaTokenizer":
        spec_path = os.path.join(path, "tokenizer.json")
        if not os.path.isfile(spec_path):
            raise FileNotFoundError(f"no tokenizer.json in {path} (the port reads the HF tokenizers format only)")
        with open(spec_path, encoding="utf-8") as f:
            spec = json.load(f)
        config: dict = {}
        for name in ("special_tokens_map.json", "tokenizer_config.json"):  # the latter wins
            p = os.path.join(path, name)
            if os.path.isfile(p):
                with open(p, encoding="utf-8") as f:
                    config.update(json.load(f))
        return cls(spec, config)

    # -- encoding -------------------------------------------------------

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        """Token ids of ``text``; ``add_bos`` applies the post-processor's
        template (``add_special_tokens``)."""
        ids: List[int] = []
        for piece, offset, added_id in self._split_added(text):
            if added_id is not None:
                ids.append(added_id)
                continue
            for word in self._pre_tokenize(self._normalize(piece), offset):
                ids.extend(self._bpe(word))
        return self.prefix + ids + self.suffix if add_bos else ids

    def __call__(self, text: str):
        return {"input_ids": self.encode(text)}

    def _split_added(self, text: str):
        """(piece, its offset in ``text``, None) and (token, offset, id) in
        order; the added tokens matched leftmost-longest, empty pieces dropped."""
        out, start, i = [], 0, 0
        while i < len(text):
            tok = next((t for t in self.added if text.startswith(t["content"], i)), None)
            if tok is None:
                i += 1
                continue
            if i > start:
                out.append((text[start:i], start, None))
            out.append((tok["content"], i, tok["id"]))
            start = i = i + len(tok["content"])
        if start < len(text):
            out.append((text[start:], start, None))
        return out

    def _normalize(self, s: str) -> str:
        for n in self.normalizers:
            kind = n["type"]
            if kind == "Prepend":
                s = n["prepend"] + s if s else s
            else:
                s = s.replace(n["pattern"]["String"], n["content"])
        return s

    def _pre_tokenize(self, s: str, offset: int) -> List[str]:
        m = self.metaspace
        if m is None:
            return [s] if s else []
        rep = m.get("replacement", SPIECE)
        scheme = m.get("prepend_scheme", "always" if m.get("add_prefix_space", True) else "never")
        s = s.replace(" ", rep)
        if s and not s.startswith(rep) and (scheme == "always" or (scheme == "first" and offset == 0)):
            s = rep + s
        return [s] if s else []

    def _bpe(self, word: str) -> List[int]:
        syms: List[int] = []
        unk_open = False
        for ch in word:
            if ch in self.vocab:
                syms.append(self.vocab[ch])
                unk_open = False
                continue
            if self.byte_fallback:
                byte_ids = [self.vocab.get(f"<0x{b:02X}>") for b in ch.encode("utf-8")]
                if all(i is not None for i in byte_ids):
                    syms.extend(byte_ids)
                    unk_open = False
                    continue
            if self.unk_id is None:
                raise ValueError(f"character {ch!r} is not in the vocabulary and the tokenizer has no unk token")
            if not (self.fuse_unk and unk_open):
                syms.append(self.unk_id)
            unk_open = True
        return self._merge(syms)

    def _merge(self, syms: List[int]) -> List[int]:
        """Apply the merges by rank, the lowest-ranked adjacent pair first and
        the leftmost of equal ranks, as ``tokenizers``' ``Word::merge_all``:
        a heap of (rank, position) over a linked list of symbols, entries
        whose pair has changed skipped when they come up."""
        nxt = list(range(1, len(syms))) + [-1]
        prv = list(range(-1, len(syms) - 1))
        heap = []

        def push(i):
            if i >= 0 and nxt[i] >= 0:
                hit = self.ranks.get((syms[i], syms[nxt[i]]))
                if hit is not None:
                    heapq.heappush(heap, (hit[0], i))

        for i in range(len(syms) - 1):
            push(i)
        while heap:
            rank, i = heapq.heappop(heap)
            j = nxt[i]
            hit = self.ranks.get((syms[i], syms[j])) if syms[i] is not None and j >= 0 else None
            if hit is None or hit[0] != rank:
                continue  # stale: one side was merged away since
            syms[i], syms[j] = hit[1], None
            nxt[i] = nxt[j]
            if nxt[j] >= 0:
                prv[nxt[j]] = i
            push(prv[i])
            push(i)
        return [t for t in syms if t is not None]

    # -- decoding -------------------------------------------------------

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        tokens = []
        for i in np.asarray(ids).reshape(-1).tolist():
            i = int(i)
            if i < 0 or i not in self.id_to_token or (skip_special_tokens and i in self.special_ids):
                continue
            tokens.append(self.id_to_token[i])
        for d in self.decoders:
            tokens = _decode_step(d, tokens)
        text = "".join(tokens)
        return _clean_up(text) if self.clean_up_spaces else text


def _flatten(node: Optional[dict], key: str) -> List[dict]:
    if node is None:
        return []
    if node.get("type") == "Sequence":
        return [x for child in node[key] for x in _flatten(child, key)]
    return [node]


def _refuse_byte_level(spec: dict) -> None:
    for part, key in (("pre_tokenizer", "pretokenizers"), ("decoder", "decoders"), ("post_processor", "processors")):
        if any(n.get("type") == "ByteLevel" for n in _flatten(spec.get(part), key)):
            raise NotImplementedError(f"a ByteLevel {part} is not ported ({_TODO_BYTELEVEL})")


def _template(node: Optional[dict]) -> Tuple[List[int], List[int]]:
    """The (prefix, suffix) ids of a ``TemplateProcessing`` single template."""
    if node is None:
        return [], []
    if node.get("type") != "TemplateProcessing":
        raise NotImplementedError(f"post-processor {node.get('type')!r} is not ported (TemplateProcessing is)")
    prefix: List[int] = []
    suffix: List[int] = []
    seen_seq = False
    for item in node["single"]:
        if "Sequence" in item:
            seen_seq = True
            continue
        ids = node["special_tokens"][item["SpecialToken"]["id"]]["ids"]
        (suffix if seen_seq else prefix).extend(ids)
    return prefix, suffix


def _decode_step(d: dict, tokens: List[str]) -> List[str]:
    kind = d["type"]
    if kind == "Replace":
        return [t.replace(d["pattern"]["String"], d["content"]) for t in tokens]
    if kind == "Fuse":
        return ["".join(tokens)]
    if kind == "Strip":
        out = []
        for t in tokens:
            lo = 0
            while lo < min(d["start"], len(t)) and t[lo] == d["content"]:
                lo += 1
            hi = len(t)
            while len(t) - hi < d["stop"] and hi > lo and t[hi - 1] == d["content"]:
                hi -= 1
            out.append(t[lo:hi])
        return out
    if kind == "ByteFallback":
        out, pending = [], []

        def flush():
            if pending:
                try:
                    out.append(bytes(pending).decode("utf-8"))
                except UnicodeDecodeError:
                    out.extend("�" for _ in pending)
                pending.clear()

        for t in tokens:
            m = re.fullmatch(r"<0x([0-9A-Fa-f]{2})>", t)
            if m:
                pending.append(int(m.group(1), 16))
            else:
                flush()
                out.append(t)
        flush()
        return out
    raise NotImplementedError(f"decoder {kind!r} is not ported")


def _clean_up(text: str) -> str:
    """transformers' ``clean_up_tokenization``."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"), (" n't", "n't"),
                 (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
        text = text.replace(a, b)
    return text


def load_tokenizer(llm_path: Optional[str]):
    """The ``tokenizer.json`` of an HF checkpoint directory, or the byte
    tokenizer when no path is configured (tests / synthetic recipes)."""
    if llm_path in (None, "", "byte"):
        return ByteTokenizer()
    if not os.path.isdir(llm_path):
        raise FileNotFoundError(f"model_config.llm_path={llm_path!r} is not a checkpoint directory")
    return LlamaTokenizer.from_dir(llm_path)
