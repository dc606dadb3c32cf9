"""The port's pure-Python Llama tokenizer against transformers' ``AutoTokenizer``.

A Llama-layout ``tokenizer.json`` (BPE with ``byte_fallback`` and
``fuse_unk``, ``<unk>`` ``<s>`` ``</s>`` then the 256 ``<0xXX>`` byte tokens,
merges trained by ``tokenizers`` on a small corpus) is built in both
published forms: TinyLlama's ``Prepend("▁")`` + ``Replace(" ", "▁")``
normalizer, and the newer ``Metaspace`` pre-tokenizer (``prepend_scheme``
first, ``split`` false). The ids and the decoded text of about 50 strings
(empty, leading / repeated spaces, digits, accents, CJK, emoji through byte
fallback, special tokens in the text), the special ids and ``vocab_size``
must equal ``AutoTokenizer``'s.
"""

import json
import os

import numpy as np
import pytest

from slam_llm_tpu_torch.data.tokenizer import LlamaTokenizer, load_tokenizer

CORPUS = [
    "hello world", "the quick brown fox jumps over the lazy dog", "utterance one two three four five",
    "speech recognition with a large language model", "USER: Transcribe speech to text.", " ASSISTANT:",
    "hello there general kenobi", "seven eight nine ten eleven twelve",
] * 25

STRINGS = [
    "", " ", "  ", "hello world", " hello", "  hello  world ", "hello   world", "Hello World", "12345 67",
    "café naïve", "日本語のテキスト", "emoji 😀🎉", "tab\there", "new\nline", "USER: hi\n ASSISTANT:",
    "hello</s>world", "<s>hello", "a<unk>b", "the lazy dog", "ÿ", "x" * 30, "fox.", "it's", "don't stop",
    "über", "ß", "ﬁ", "𝔘nicode", "mixed 123 abc ÄÖÜ", "quick brown", "trailing ", " leading", "é", "é",
    " nbsp", "The Quick Brown Fox", "utterance 12", "speech recognition", "language model", "ASSISTANT:",
    "!?,.", "a b c d e f", "αβγ", "привет мир", "שלום", "مرحبا", "안녕하세요", "🙂 ok", "end </s>",
    "USER: Transcribe speech to text. \n ASSISTANT:hello world 3",
]


def build_llama_tokenizer(out_dir, form="prepend", vocab_size=120):
    """A Llama-layout ``tokenizer.json`` + ``tokenizer_config.json`` in
    ``out_dir`` (``form``: ``prepend`` or ``metaspace``); returns the vocab size."""
    from tokenizers import Tokenizer, decoders, models, normalizers, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True, fuse_unk=True))
    if form == "prepend":
        tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"), normalizers.Replace(" ", "▁")])
    else:
        tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="first", split=False)
    tok.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(), decoders.Fuse(),
                                     decoders.Strip(" ", 1, 0)])
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(vocab_size=vocab_size, special_tokens=["<unk>", "<s>", "</s>"],
                                                        show_progress=False))
    spec = json.loads(tok.to_str())
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2, **{f"<0x{b:02X}>": 3 + b for b in range(256)}}
    for t, _ in sorted(spec["model"]["vocab"].items(), key=lambda kv: kv[1]):
        vocab.setdefault(t, len(vocab))
    spec["model"]["vocab"] = vocab
    for added in spec["added_tokens"]:
        added["id"] = vocab[added["content"]]
    s = {"SpecialToken": {"id": "<s>", "type_id": 0}}
    spec["post_processor"] = {
        "type": "TemplateProcessing", "single": [s, {"Sequence": {"id": "A", "type_id": 0}}],
        "pair": [s, {"Sequence": {"id": "A", "type_id": 0}}, {"SpecialToken": {"id": "<s>", "type_id": 1}},
                 {"Sequence": {"id": "B", "type_id": 1}}],
        "special_tokens": {"<s>": {"id": "<s>", "ids": [1], "tokens": ["<s>"]}}}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(out_dir, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "LlamaTokenizerFast", "bos_token": "<s>", "eos_token": "</s>",
                   "unk_token": "<unk>", "add_bos_token": True, "add_eos_token": False, "legacy": False,
                   "clean_up_tokenization_spaces": False}, f)
    return len(vocab)


@pytest.fixture(scope="module", params=["prepend", "metaspace"])
def pair(request, tmp_path_factory):
    from transformers import AutoTokenizer

    d = tmp_path_factory.mktemp(f"tok_{request.param}")
    build_llama_tokenizer(d, request.param)
    return AutoTokenizer.from_pretrained(str(d)), load_tokenizer(str(d))


def test_ids_match_autotokenizer(pair):
    hf, port = pair
    assert isinstance(port, LlamaTokenizer)
    for s in STRINGS:
        assert port.encode(s) == hf.encode(s), s
        assert port.encode(s, add_bos=False) == hf.encode(s, add_special_tokens=False), s


def test_decoded_text_matches_autotokenizer(pair):
    hf, port = pair
    for s in STRINGS:
        ids = hf.encode(s)
        for skip in (True, False):
            assert port.decode(ids, skip_special_tokens=skip) == hf.decode(ids, skip_special_tokens=skip), (s, skip)
    rng = np.random.default_rng(0)  # arbitrary id runs: broken byte sequences, specials mid-text
    for _ in range(20):
        ids = rng.integers(0, port.vocab_size, 24).tolist()
        for skip in (True, False):
            assert port.decode(ids, skip_special_tokens=skip) == hf.decode(ids, skip_special_tokens=skip), ids
    assert port.decode(np.array([[-1, ids[0], -1]])) == hf.decode([ids[0]], skip_special_tokens=True)


def test_special_ids_and_vocab_size(pair):
    hf, port = pair
    assert (port.bos_token_id, port.eos_token_id) == (hf.bos_token_id, hf.eos_token_id) == (1, 2)
    assert hf.pad_token_id is None and port.pad_token_id == hf.eos_token_id  # reference slam_model.py:64
    assert port.vocab_size == len(hf)


def test_added_tokens_pad_and_clean_up_from_the_config(tmp_path):
    from transformers import AutoTokenizer

    n = build_llama_tokenizer(tmp_path)
    spec = json.loads((tmp_path / "tokenizer.json").read_text())
    spec["added_tokens"].append({"id": n, "content": "<pad>", "single_word": False, "lstrip": False,
                                 "rstrip": False, "normalized": False, "special": True})
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec))
    config = json.loads((tmp_path / "tokenizer_config.json").read_text())
    (tmp_path / "tokenizer_config.json").write_text(json.dumps({**config, "pad_token": "<pad>"}))
    hf, port = AutoTokenizer.from_pretrained(str(tmp_path)), load_tokenizer(str(tmp_path))
    assert port.vocab_size == len(hf) == n + 1
    assert port.pad_token_id == hf.pad_token_id == n
    assert port.encode("hi<pad>there") == hf.encode("hi<pad>there")
    # transformers' clean_up_tokenization_spaces, when a config turns it on
    (tmp_path / "tokenizer_config.json").write_text(json.dumps({**config, "clean_up_tokenization_spaces": True}))
    hf, port = AutoTokenizer.from_pretrained(str(tmp_path)), load_tokenizer(str(tmp_path))
    for s in ("fox . dog ?", "it 's done , they 're here !", "don 't", "a ' b"):
        assert port.decode(hf.encode(s)) == hf.decode(hf.encode(s), skip_special_tokens=True), s


def test_synthetic_tokenizer_matches_autotokenizer(tmp_path):
    """``tools.synth_checkpoint``'s seeded-merge tokenizer loads the same in both."""
    from transformers import AutoTokenizer

    from slam_llm_tpu_torch.tools.synth_checkpoint import write_tokenizer

    write_tokenizer(str(tmp_path), 2000, seed=3)
    hf, port = AutoTokenizer.from_pretrained(str(tmp_path)), load_tokenizer(str(tmp_path))
    assert port.vocab_size == len(hf) == 2000
    for s in STRINGS:
        assert port.encode(s) == hf.encode(s), s
        assert port.decode(hf.encode(s)) == hf.decode(hf.encode(s), skip_special_tokens=True), s


def test_byte_level_and_missing_files_raise(tmp_path):
    build_llama_tokenizer(tmp_path)
    spec = json.loads((tmp_path / "tokenizer.json").read_text())
    spec["pre_tokenizer"] = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True, "use_regex": True}
    with pytest.raises(NotImplementedError, match="ByteLevelTokenizer"):
        LlamaTokenizer(spec, {})
    with pytest.raises(FileNotFoundError):
        load_tokenizer(str(tmp_path / "missing"))
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        load_tokenizer(str(tmp_path / ".."))
