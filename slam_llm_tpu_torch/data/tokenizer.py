"""Tokenizer loading.

Counterpart of ``slam_llm_tpu/data/tokenizer.py``, which wraps HF
``AutoTokenizer`` (reference models/slam_model.py:54-65) with the
``pad_token = eos_token`` fallback. The port reads an HF ``tokenizer.json``
itself, in plain Python, so no ``transformers`` / ``tokenizers`` / ``regex``
is needed: ``LlamaTokenizer`` for the Llama family (sentencepiece-style BPE),
``ByteLevelTokenizer`` for qwen2's ByteLevel BPE; ``load_tokenizer`` picks
one from the file. ``ByteTokenizer`` is the dependency-free byte-level
tokenizer of the tests and the synthetic recipes.
"""

from __future__ import annotations

import heapq
import json
import os
import re
import unicodedata
from typing import Dict, List, Optional, Tuple

import numpy as np

SPIECE = "▁"  # "▁", sentencepiece's word boundary


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
    ``vocab_size`` counts the added tokens, like ``len(tokenizer)``. A
    ByteLevel tokenizer (``ByteLevelTokenizer``'s) and other components
    raise ``NotImplementedError``.
    """

    def __init__(self, spec: dict, config: Optional[dict] = None):
        config = config or {}
        model = spec.get("model") or {}
        if model.get("type") != "BPE":
            raise NotImplementedError(f"tokenizer model {model.get('type')!r}: only BPE is ported")
        for key in ("continuing_subword_prefix", "end_of_word_suffix", "dropout", "ignore_merges"):
            if model.get(key):
                raise NotImplementedError(f"BPE {key}={model[key]!r} is not ported")
        if _byte_level(spec):
            raise NotImplementedError("a ByteLevel tokenizer.json is read by ByteLevelTokenizer, not LlamaTokenizer")
        _read_bpe(self, spec)
        self.byte_fallback = bool(model.get("byte_fallback", False))
        self.fuse_unk = bool(model.get("fuse_unk", False))
        self.unk_id = self.vocab.get(model["unk_token"]) if model.get("unk_token") else None

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

        llama = str(config.get("tokenizer_class", "")).startswith("Llama")
        _special_ids(self, config, "<s>" if llama else None, "</s>" if llama else None)
        self.prefix, self.suffix = _template(spec.get("post_processor"))
        if llama:  # LlamaTokenizerFast.update_post_processor
            self.prefix = [self.bos_token_id] if config.get("add_bos_token", True) else []
            self.suffix = [self.eos_token_id] if config.get("add_eos_token", False) else []
        self.clean_up_spaces = bool(config.get("clean_up_tokenization_spaces", False))

    # -- encoding -------------------------------------------------------

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        """Token ids of ``text``; ``add_bos`` applies the post-processor's
        template (``add_special_tokens``)."""
        ids: List[int] = []
        for piece, offset, added_id in _split_added(self.added, text):
            if added_id is not None:
                ids.append(added_id)
                continue
            for word in self._pre_tokenize(self._normalize(piece), offset):
                ids.extend(self._bpe(word))
        return self.prefix + ids + self.suffix if add_bos else ids

    def __call__(self, text: str):
        return {"input_ids": self.encode(text)}

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
        return _merge(self.ranks, syms)

    # -- decoding -------------------------------------------------------

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        tokens = _id_tokens(self, ids, skip_special_tokens)
        for d in self.decoders:
            tokens = _decode_step(d, tokens)
        text = "".join(tokens)
        return _clean_up(text) if self.clean_up_spaces else text


# the Split pattern of qwen2's tokenizer.json, the one ByteLevelTokenizer takes
QWEN2_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|"
               r"\s*[\r\n]+|\s+(?!\S)|\s+")


class ByteLevelTokenizer:
    r"""qwen2's ``tokenizer.json`` (ByteLevel BPE), encoded and decoded as
    ``AutoTokenizer`` does:

    * the added tokens (``<|endoftext|>``, ``<|im_start|>``, ``<|im_end|>``)
      are split out of the raw text first, leftmost-longest;
    * the normalizer: NFC, or none;
    * the pre-tokenizer: ``Split`` with ``QWEN2_SPLIT`` (behaviour
      ``Isolated``), run by a scanner over ``unicodedata`` categories
      (``split_qwen2``), since Python's ``re`` has no ``\p{..}``; then
      ``ByteLevel`` (no prefix space, no regex of its own): each piece's
      UTF-8 bytes through GPT-2's byte -> unicode map;
    * the model: BPE, merges applied by rank as ``LlamaTokenizer`` applies
      them;
    * the post-processor: ``ByteLevel``, which adds no token (no BOS);
    * the decoder: ``ByteLevel``: each token's characters back to bytes (a
      token with a character outside the map gives its own UTF-8 bytes), the
      bytes decoded with U+FFFD for invalid sequences. Ids neither in the
      vocabulary nor added decode to nothing, as in ``tokenizers`` (qwen2's
      model has 152064 rows for 151646 tokens); ``skip_special_tokens``
      drops the special added tokens.

    bos / eos / pad come from ``tokenizer_config.json`` or
    ``special_tokens_map.json``, with no default (qwen2's bos is null); pad
    is eos when neither sets one. Any other pre-tokenizer, pattern (such as
    Llama-3's ``\p{N}{1,3}``) or component raises ``NotImplementedError``.
    """

    def __init__(self, spec: dict, config: Optional[dict] = None):
        config = config or {}
        model = spec.get("model") or {}
        if model.get("type") != "BPE":
            raise NotImplementedError(f"tokenizer model {model.get('type')!r}: only BPE is ported")
        for key in ("continuing_subword_prefix", "end_of_word_suffix", "dropout", "ignore_merges", "byte_fallback"):
            if model.get(key):
                raise NotImplementedError(f"BPE {key}={model[key]!r} is not ported for ByteLevel")
        _read_bpe(self, spec)
        if any(t.get("normalized") for t in self.added):
            raise NotImplementedError("normalized added tokens are not ported for ByteLevel")
        for n in _flatten(spec.get("normalizer"), "normalizers"):
            if n["type"] != "NFC":
                raise NotImplementedError(f"normalizer {n['type']!r} is not ported for ByteLevel (NFC is)")
        self.nfc = spec.get("normalizer") is not None
        pre = _flatten(spec.get("pre_tokenizer"), "pretokenizers")
        kinds = [p["type"] for p in pre]
        if kinds != ["Split", "ByteLevel"]:
            raise NotImplementedError(f"pre-tokenizers {kinds} are not ported (Split + ByteLevel is)")
        split, level = pre
        if (split["pattern"].get("Regex") != QWEN2_SPLIT or split.get("behavior") != "Isolated"
                or split.get("invert")):
            raise NotImplementedError(f"Split {split} is not ported (qwen2's pattern, Isolated, is)")
        if level.get("add_prefix_space") or level.get("use_regex"):
            raise NotImplementedError(f"{level} is not ported (ByteLevel without prefix space or regex is)")
        # the ByteLevel post-processor adds no token and the decoder maps
        # bytes back whatever their flags (which touch only offsets)
        post, dec = spec.get("post_processor"), _flatten(spec.get("decoder"), "decoders")
        if (post is not None and post["type"] != "ByteLevel") or [d["type"] for d in dec] != ["ByteLevel"]:
            raise NotImplementedError(f"post-processor {post} / decoders {dec} are not ported (ByteLevel is)")
        _special_ids(self, config, None, None)
        self.clean_up_spaces = bool(config.get("clean_up_tokenization_spaces", False))

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        """Token ids of ``text``; the ByteLevel post-processor adds none, so
        ``add_bos`` changes nothing."""
        ids: List[int] = []
        for piece, _, added_id in _split_added(self.added, text):
            if added_id is not None:
                ids.append(added_id)
                continue
            if self.nfc:
                piece = unicodedata.normalize("NFC", piece)
            for word in split_qwen2(piece):
                syms = []
                for ch in "".join(BYTE_TO_UNICODE[b] for b in word.encode("utf-8")):
                    if ch not in self.vocab:
                        raise ValueError(f"byte character {ch!r} is not in the vocabulary")
                    syms.append(self.vocab[ch])
                ids.extend(_merge(self.ranks, syms))
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        data = bytearray()
        for tok in _id_tokens(self, ids, skip_special_tokens):
            if all(ch in UNICODE_TO_BYTE for ch in tok):
                data.extend(UNICODE_TO_BYTE[ch] for ch in tok)
            else:
                data.extend(tok.encode("utf-8"))
        text = data.decode("utf-8", errors="replace")
        return _clean_up(text) if self.clean_up_spaces else text


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character map: the printable Latin-1 bytes
    map to themselves, the other 68 to U+0100 onwards, in byte order; the
    printable ones first, the order of the map and of qwen2's first 256 ids."""
    keep = [*range(ord("!"), ord("~") + 1), *range(ord("¡"), ord("¬") + 1), *range(ord("®"), ord("ÿ") + 1)]
    rest = [b for b in range(256) if b not in keep]
    return {**{b: chr(b) for b in keep}, **{b: chr(256 + n) for n, b in enumerate(rest)}}


BYTE_TO_UNICODE = _bytes_to_unicode()
UNICODE_TO_BYTE = {ch: b for b, ch in BYTE_TO_UNICODE.items()}

# Unicode's White_Space: what \s matches in the Oniguruma patterns of tokenizers
_SPACE = frozenset("\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
                   + "".join(map(chr, range(0x2000, 0x200B))))
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


def _letter(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "L"


def _number(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "N"


def _other(ch: str) -> bool:
    r"""``[^\s\p{L}\p{N}]``"""
    return ch not in _SPACE and unicodedata.category(ch)[0] not in "LN"


def split_qwen2(text: str) -> List[str]:
    """``text`` cut by ``QWEN2_SPLIT`` (every character lands in a match)."""
    out, i = [], 0
    while i < len(text):
        j = _match_qwen2(text, i)
        out.append(text[i:j])
        i = j
    return out


def _match_qwen2(s: str, i: int) -> int:
    """End of the leftmost alternative of ``QWEN2_SPLIT`` matching at ``i``,
    with the regex engine's greedy backtracking worked out per alternative."""
    n, c = len(s), s[i]
    if c == "'":  # (?i:'s|'t|'re|'ve|'m|'ll|'d): the first alternative that matches
        for suffix in _CONTRACTIONS:
            end = i + 1 + len(suffix)
            if end <= n and all(a.casefold() == b for a, b in zip(s[i + 1:end], suffix)):
                return end
    # [^\r\n\p{L}\p{N}]?\p{L}+
    start = i if _letter(c) else (i + 1 if c not in "\r\n" and not _number(c) and i + 1 < n
                                  and _letter(s[i + 1]) else None)
    if start is not None:
        while start < n and _letter(s[start]):
            start += 1
        return start
    if _number(c):  # \p{N}
        return i + 1
    # ' ?[^\s\p{L}\p{N}]+[\r\n]*'
    j = i + 1 if c == " " and i + 1 < n and _other(s[i + 1]) else i
    if _other(s[j]):
        while j < n and _other(s[j]):
            j += 1
        while j < n and s[j] in "\r\n":
            j += 1
        return j
    # c is white space: \s*[\r\n]+ ends after the run's last line break;
    # \s+(?!\S) takes the run, less its last character before a non-space;
    # \s+ the run
    end = i
    while end < n and s[end] in _SPACE:
        end += 1
    breaks = [k for k in range(i, end) if s[k] in "\r\n"]
    if breaks:
        return breaks[-1] + 1
    if end == n or end - i == 1:
        return end
    return end - 1


def _read_dir(path: str) -> Tuple[dict, dict]:
    """(``tokenizer.json``, the configs) of an HF directory."""
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
    return spec, config


def _read_bpe(tok, spec: dict) -> None:
    """The BPE vocabulary, merge ranks and added tokens of a tokenizer.json
    onto ``tok``: ``vocab``, ``ranks`` ((a, b) -> (rank, merged id)),
    ``added`` (longest first), ``id_to_token``, ``special_ids`` and
    ``vocab_size``, which counts the added tokens, like ``len(tokenizer)``."""
    model = spec["model"]
    tok.vocab = dict(model["vocab"])
    tok.ranks = {}
    for rank, merge in enumerate(model.get("merges", [])):
        a, b = merge.split(" ", 1) if isinstance(merge, str) else merge
        tok.ranks[(tok.vocab[a], tok.vocab[b])] = (rank, tok.vocab[a + b])
    tok.added = sorted(spec.get("added_tokens", []), key=lambda t: -len(t["content"]))
    if any(t.get(key) for t in tok.added for key in ("single_word", "lstrip", "rstrip")):
        raise NotImplementedError("added tokens with single_word / lstrip / rstrip are not ported")
    tok.id_to_token = {i: t for t, i in tok.vocab.items()}
    tok.id_to_token.update({t["id"]: t["content"] for t in tok.added})
    tok.special_ids = {t["id"] for t in tok.added if t.get("special")}
    tok.vocab_size = len({**tok.vocab, **{t["content"]: t["id"] for t in tok.added}})


def _special_ids(tok, config: dict, bos_default: Optional[str], eos_default: Optional[str]) -> None:
    """``bos_token_id`` / ``eos_token_id`` / ``pad_token_id`` from the configs
    (an added token's id, else the vocabulary's); pad falls back to eos."""

    def token_id(key, default):
        t = config.get(key, default)
        t = t.get("content") if isinstance(t, dict) else t
        if t is None:
            return None
        found = [a["id"] for a in tok.added if a["content"] == t]
        return found[0] if found else tok.vocab.get(t)

    tok.bos_token_id = token_id("bos_token", bos_default)
    tok.eos_token_id = token_id("eos_token", eos_default)
    pad = token_id("pad_token", None)
    tok.pad_token_id = tok.eos_token_id if pad is None else pad  # reference slam_model.py:64


def _split_added(added: List[dict], text: str):
    """(piece, its offset in ``text``, None) and (token, offset, id) in
    order; the added tokens matched leftmost-longest, empty pieces dropped."""
    out, start, i = [], 0, 0
    while i < len(text):
        tok = next((t for t in added if text.startswith(t["content"], i)), None)
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


def _merge(ranks: Dict[Tuple[int, int], Tuple[int, int]], syms: List[int]) -> List[int]:
    """Apply the merges by rank, the lowest-ranked adjacent pair first and
    the leftmost of equal ranks, as ``tokenizers``' ``Word::merge_all``: a
    heap of (rank, position) over a linked list of symbols, entries whose
    pair has changed skipped when they come up."""
    nxt = list(range(1, len(syms))) + [-1]
    prv = list(range(-1, len(syms) - 1))
    heap = []

    def push(i):
        if i >= 0 and nxt[i] >= 0:
            hit = ranks.get((syms[i], syms[nxt[i]]))
            if hit is not None:
                heapq.heappush(heap, (hit[0], i))

    for i in range(len(syms) - 1):
        push(i)
    while heap:
        rank, i = heapq.heappop(heap)
        j = nxt[i]
        hit = ranks.get((syms[i], syms[j])) if syms[i] is not None and j >= 0 else None
        if hit is None or hit[0] != rank:
            continue  # stale: one side was merged away since
        syms[i], syms[j] = hit[1], None
        nxt[i] = nxt[j]
        if nxt[j] >= 0:
            prv[nxt[j]] = i
        push(prv[i])
        push(i)
    return [t for t in syms if t is not None]


def _id_tokens(tok, ids, skip_special_tokens: bool) -> List[str]:
    """The token strings of ``ids``: negative ids and ids the tokenizer does
    not know are dropped, as are the special added tokens when asked."""
    out = []
    for i in np.asarray(ids).reshape(-1).tolist():
        i = int(i)
        if i < 0 or i not in tok.id_to_token or (skip_special_tokens and i in tok.special_ids):
            continue
        out.append(tok.id_to_token[i])
    return out


def _flatten(node: Optional[dict], key: str) -> List[dict]:
    if node is None:
        return []
    if node.get("type") == "Sequence":
        return [x for child in node[key] for x in _flatten(child, key)]
    return [node]


def _byte_level(spec: dict) -> bool:
    return any(n.get("type") == "ByteLevel" for part, key in (
        ("pre_tokenizer", "pretokenizers"), ("decoder", "decoders"), ("post_processor", "processors"))
        for n in _flatten(spec.get(part), key))


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
    """The ``tokenizer.json`` of an HF checkpoint directory (a ByteLevel one
    through ``ByteLevelTokenizer``, else ``LlamaTokenizer``), or the byte
    tokenizer when no path is configured (tests / synthetic recipes)."""
    if llm_path in (None, "", "byte"):
        return ByteTokenizer()
    if not os.path.isdir(llm_path):
        raise FileNotFoundError(f"model_config.llm_path={llm_path!r} is not a checkpoint directory")
    spec, config = _read_dir(llm_path)
    return (ByteLevelTokenizer if _byte_level(spec) else LlamaTokenizer)(spec, config)
