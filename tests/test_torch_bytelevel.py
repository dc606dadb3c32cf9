"""The ST recipe's text side in the port, against the packages it stands in for.

The port's ``ByteLevelTokenizer`` (qwen2's tokenizer.json in plain Python)
gives the ids and the decoded text of ``tokenizers`` on German with umlauts,
CJK, digits, contractions, emoji, runs of spaces and newlines and the special
tokens, for a tokenizer trained here with ``tokenizers``' BPE trainer and
qwen2's pre-tokenizer, and for the qwen2-layout tokenizer that
``tools/synth_checkpoint.py`` writes (against ``AutoTokenizer``). The port's
BLEU equals the JAX package's to 1e-9 and ``sacrebleu``'s, and its
``tools/eval_werbleu.py`` prints what the recipe's scorer prints.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from slam_llm_tpu_torch.data.tokenizer import (
    LLAMA3_SPLIT,
    QWEN2_SPLIT,
    ByteLevelTokenizer,
    LlamaTokenizer,
    load_tokenizer,
    split_pretokens,
)

REPO = Path(__file__).resolve().parent.parent
SPECIALS = ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]

STRINGS = [
    "Übersetze die Sprache ins Deutsche.",
    "Die Straße ist schön, aber die Bäume sind größer als gedacht.",
    "Ärger über Öl und Übermut: äöüß ÄÖÜ",
    "Grüße aus Köln! Wir fahren um 17:45 Uhr.",
    "Er sagte: „Das ist großartig“ – und ging.",
    "I'm sure it's fine, we'll see, they're here, you've been, he'd go.",
    "I'M SURE IT'S FINE, WE'LL SEE, THEY'RE HERE",
    "don't can't won't shouldn't 'quoted' ''double''",
    "'s 't 're 've 'm 'll 'd 'x",
    "翻译这段语音。今天天气很好。",
    "日本語のテキストとカタカナ、ひらがな。",
    "한국어 문장도 있습니다.",
    "Mixed 中文 and English 混合 text.",
    "Numbers: 1234567890 3.14159 1,000,000 ٣٤٥ ⅫⅣ ²³",
    "Phone +49 (0)30 1234-5678, ISBN 978-3-16-148410-0",
    "Emoji 😀😃🎉👍🏽 and 👨‍👩‍👧‍👦 family",
    "Flags 🇩🇪🇫🇷 and ❤️ hearts ✨",
    "   leading spaces",
    "trailing spaces   ",
    "runs    of     spaces",
    "line one\nline two\n\nline four",
    "windows\r\nline\r\nendings",
    "tabs\tand\t\tmore tabs",
    "mixed \t \n \r\n   whitespace  \n",
    "\n\n\nleading newlines",
    "trailing newlines\n\n\n",
    "  \n  spaced newline  \n  ",
    "punctuation!!! ??? ... ;;; ::: ---",
    "(brackets) [square] {curly} <angle>",
    "email@example.com https://example.org/path?q=1&x=2",
    "snake_case camelCase PascalCase kebab-case",
    "C'est l'été, n'est-ce pas?",
    "Señor niño jalapeño, ¿qué tal? ¡Olé!",
    "Ελληνικά κείμενα και Русский текст.",
    "עברית ועברית and العربية",
    "हिन्दी पाठ",
    "ไทย ภาษา",
    "Café vs Café (composed vs decomposed)",
    "Ångström and Ångström",
    "non breaking thin　ideographic spaces",
    "zero​width‍joiners",
    "<|endoftext|>",
    "<|im_start|>user\nÜbersetze das.<|im_end|>\n<|im_start|>assistant\n",
    "text<|endoftext|>more text<|im_end|>",
    "<|im_start|><|im_end|><|endoftext|>",
    "almost special <|im_start and |> tokens",
    "USER: Translate the speech to German. \n ASSISTANT:",
    "x",
    "",
    " ",
    "\n",
    "'",
    "a'b",
    "1a2b3c",
    "$$$100 €50 £20 ¥1000",
]

CORPUS = STRINGS * 3 + [
    "Die Katze sitzt auf der Matte und schaut aus dem Fenster.",
    "Wir übersetzen gesprochene Sprache in geschriebenen Text.",
    "The quick brown fox jumps over the lazy dog.",
    "東京は日本の首都です。北京是中国的首都。",
] * 5


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A ByteLevel BPE trained by ``tokenizers`` with qwen2's normalizer,
    pre-tokenizer, post-processor and decoder: (the tokenizers object, the
    port's tokenizer read from its saved file)."""
    from tokenizers import Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers, processors, trainers

    tok = Tokenizer(models.BPE())
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(QWEN2_SPLIT), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, trim_offsets=False, use_regex=False),
    ])
    tok.post_processor = processors.ByteLevel(add_prefix_space=False, trim_offsets=False, use_regex=False)
    tok.decoder = decoders.ByteLevel(add_prefix_space=False, trim_offsets=False, use_regex=False)
    trainer = trainers.BpeTrainer(vocab_size=1200, special_tokens=SPECIALS, show_progress=False,
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(CORPUS, trainer)
    d = tmp_path_factory.mktemp("bytelevel")
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps({"eos_token": SPECIALS[0], "bos_token": None}))
    port = load_tokenizer(str(d))
    assert isinstance(port, ByteLevelTokenizer)
    return tok, port


def test_ids_match_tokenizers(trained):
    tok, port = trained
    for s in STRINGS:
        assert port.encode(s) == tok.encode(s).ids, s


def test_decoded_text_matches_tokenizers(trained):
    tok, port = trained
    for s in STRINGS:
        ids = tok.encode(s).ids
        for skip in (True, False):
            assert port.decode(ids, skip_special_tokens=skip) == tok.decode(ids, skip_special_tokens=skip), s


def test_any_ids_decode_as_tokenizers_decodes_them(trained):
    """Random ids, some past the vocabulary (the model's extra rows), some
    special, some cutting a UTF-8 sequence: the same text, U+FFFD included."""
    tok, port = trained
    rng = np.random.default_rng(0)
    n = tok.get_vocab_size()
    for _ in range(200):
        ids = rng.integers(0, n + 40, rng.integers(1, 12)).tolist()
        for skip in (True, False):
            assert port.decode(ids, skip_special_tokens=skip) == tok.decode(ids, skip_special_tokens=skip), ids


def test_the_split_scanner_matches_the_regex(trained):
    """``split_pretokens`` with qwen2's digits against ``tokenizers``' own
    Split pre-tokenizer."""
    from tokenizers import Regex, pre_tokenizers

    split = pre_tokenizers.Split(Regex(QWEN2_SPLIT), behavior="isolated", invert=False)
    for s in STRINGS:
        assert split_pretokens(s, 1) == [p for p, _ in split.pre_tokenize_str(s)], s


def test_synthetic_qwen2_tokenizer_matches_autotokenizer(tmp_path):
    """``tools/synth_checkpoint.write_qwen2_tokenizer`` in qwen2's layout:
    ``AutoTokenizer`` reads it as a Qwen2 tokenizer, and the port agrees
    with it on ids, text, vocabulary size and bos / eos / pad."""
    from transformers import AutoTokenizer

    from slam_llm_tpu_torch.tools.synth_checkpoint import write_qwen2_tokenizer

    write_qwen2_tokenizer(str(tmp_path), 3000, seed=1, corpus=CORPUS)
    hf, port = AutoTokenizer.from_pretrained(str(tmp_path)), load_tokenizer(str(tmp_path))
    assert type(hf).__name__ == "Qwen2TokenizerFast" and isinstance(port, ByteLevelTokenizer)
    assert port.vocab_size == len(hf) == 3003
    assert (port.bos_token_id, port.eos_token_id, port.pad_token_id) == (hf.bos_token_id, hf.eos_token_id,
                                                                        hf.pad_token_id) == (None, 3000, 3000)
    for s in STRINGS:
        ids = hf.encode(s)
        assert port.encode(s) == ids, s
        assert port.decode(ids) == hf.decode(ids, skip_special_tokens=True), s
    assert port.decode([3000, 5000, -1, 7]) == hf.decode([3000, 5000, 7], skip_special_tokens=True)


def test_other_byte_level_tokenizers_raise(trained, tmp_path):
    """A Split pattern other than qwen2's and Llama-3's (digits in runs of up
    to two), GPT-2's regex inside ByteLevel, a post-processor other than
    ByteLevel + TemplateProcessing, and a ByteLevel file handed to the Llama
    reader all raise."""
    tok, _ = trained
    spec = json.loads(tok.to_str())
    other = json.loads(json.dumps(spec))
    other["pre_tokenizer"]["pretokenizers"][0]["pattern"]["Regex"] = QWEN2_SPLIT.replace(r"\p{N}|", r"\p{N}{1,2}|")
    with pytest.raises(NotImplementedError, match="Split"):
        ByteLevelTokenizer(other)
    bert = json.loads(json.dumps(spec))
    bert["post_processor"] = {"type": "BertProcessing", "sep": ["[SEP]", 0], "cls": ["[CLS]", 1]}
    with pytest.raises(NotImplementedError, match="post-processors"):
        ByteLevelTokenizer(bert)
    gpt2 = json.loads(json.dumps(spec))
    gpt2["pre_tokenizer"] = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True, "use_regex": True}
    with pytest.raises(NotImplementedError, match="pre-tokenizers"):
        ByteLevelTokenizer(gpt2)
    with pytest.raises(NotImplementedError, match="ByteLevelTokenizer"):
        LlamaTokenizer(spec)


# ---------------------------------------------------------------------------
# Llama-3's tokenizer.json
# ---------------------------------------------------------------------------

LLAMA3_SPECIALS = ["<|begin_of_text|>", "<|end_of_text|>", "<|start_header_id|>", "<|end_header_id|>", "<|eot_id|>"]
UNMERGED = "zqxjkv"
DIGITS = ["1", "12", "123", "1234", "12345", "123456", "1234567", "x1234567y 89 0.5 2024-10-18 ٣٤٥٦ ²³⁴⁵",
          "a1b22c333d4444"]


@pytest.fixture(scope="module")
def llama3(tmp_path_factory):
    """A synthetic Llama-3 ``tokenizer.json``, as Meta's is laid out: a BPE
    trained by ``tokenizers`` with Llama-3's Split (``\\p{N}{1,3}``,
    Isolated) and ByteLevel pre-tokenizers, ``ignore_merges``, the
    ByteLevel + TemplateProcessing post-processor (``<|begin_of_text|>``
    first), the ByteLevel decoder and ``tokenizer_config.json``'s
    ``PreTrainedTokenizerFast`` with ``clean_up_tokenization_spaces``:
    (the JAX package's tokenizer, the port's, the directory)."""
    from tokenizers import Regex, Tokenizer, decoders, models, pre_tokenizers, processors, trainers

    from slam_llm_tpu.data.tokenizer import load_tokenizer as j_load_tokenizer

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_SPLIT), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, trim_offsets=True, use_regex=False),
    ])
    tok.decoder = decoders.ByteLevel(add_prefix_space=True, trim_offsets=True, use_regex=True)
    trainer = trainers.BpeTrainer(vocab_size=1500, special_tokens=LLAMA3_SPECIALS, show_progress=False,
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(CORPUS + DIGITS * 4, trainer)
    bos = tok.token_to_id(LLAMA3_SPECIALS[0])
    tok.post_processor = processors.Sequence([
        processors.ByteLevel(add_prefix_space=True, trim_offsets=False, use_regex=True),
        processors.TemplateProcessing(single=f"{LLAMA3_SPECIALS[0]} $A", pair=f"{LLAMA3_SPECIALS[0]} $A $B",
                                      special_tokens=[(LLAMA3_SPECIALS[0], bos)]),
    ])
    spec = json.loads(tok.to_str())
    spec["model"]["ignore_merges"] = True
    vocab = spec["model"]["vocab"]
    vocab[UNMERGED] = max(vocab.values()) + 1  # an entry no merge builds: only ignore_merges reaches it
    d = tmp_path_factory.mktemp("llama3")
    (d / "tokenizer.json").write_text(json.dumps(spec, ensure_ascii=False), encoding="utf-8")
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "bos_token": LLAMA3_SPECIALS[0], "eos_token": LLAMA3_SPECIALS[1],
        "clean_up_tokenization_spaces": True, "model_max_length": 131072}))
    port = load_tokenizer(str(d))
    assert isinstance(port, ByteLevelTokenizer) and port.ignore_merges and port.digits == 3
    return j_load_tokenizer(str(d)), port, d


def test_llama3_split_scanner_matches_the_regex():
    """``split_pretokens(.., 3)`` against ``tokenizers``' own Split with
    Llama-3's pattern, digit runs of 1-7 included."""
    from tokenizers import Regex, pre_tokenizers

    split = pre_tokenizers.Split(Regex(LLAMA3_SPLIT), behavior="isolated", invert=False)
    for s in STRINGS + DIGITS:
        assert split_pretokens(s, 3) == [p for p, _ in split.pre_tokenize_str(s)], s
    assert split_pretokens("1234567", 3) == ["123", "456", "7"]


def test_llama3_ids_and_text_match_the_jax_tokenizer(llama3):
    """Encode (``<|begin_of_text|>`` first; ``add_bos=False`` drops it) and
    decode (special tokens kept or skipped, the clean-up applied) equal the
    JAX package's ``load_tokenizer`` (``AutoTokenizer``) on every string,
    digits in runs of 1-7 included; bos / eos / pad and the vocabulary
    size too."""
    jtok, port, _ = llama3
    assert (port.bos_token_id, port.eos_token_id, port.pad_token_id, port.vocab_size) == (
        jtok.bos_token_id, jtok.eos_token_id, jtok.pad_token_id, jtok.vocab_size)
    for s in STRINGS + DIGITS + ["<|begin_of_text|>hi<|eot_id|>", "<|start_header_id|>user<|end_header_id|>\n\n9",
                                 UNMERGED, f"say {UNMERGED}{UNMERGED} 1234567"]:
        ids = jtok.encode(s)
        assert port.encode(s) == ids, s
        assert ids[0] == port.bos_token_id and port.encode(s, add_bos=False) == ids[1:], s
        for skip in (True, False):
            assert port.decode(ids, skip_special_tokens=skip) == jtok.decode(ids, skip_special_tokens=skip), s


def test_llama3_ignore_merges_takes_whole_vocabulary_entries(llama3):
    """With ``ignore_merges`` a piece that is a vocabulary entry is that
    entry, as ``tokenizers``' own model reads the file; ``UNMERGED``, which
    no merge builds, is one id only because of it."""
    from tokenizers import Tokenizer

    _, port, d = llama3
    words = [w for w in port.vocab if len(w) > 2 and w.isascii() and w.isalpha()][:200]
    assert words
    spec = json.loads((d / "tokenizer.json").read_text(encoding="utf-8"))
    raw = Tokenizer.from_str(json.dumps({**spec, "post_processor": None}))
    for w in words + [UNMERGED]:
        assert port.encode(w, add_bos=False) == raw.encode(w).ids == [port.vocab[w]], w
    port.ignore_merges = False
    try:
        assert len(port.encode(UNMERGED, add_bos=False)) > 1
    finally:
        port.ignore_merges = True


# ---------------------------------------------------------------------------
# BLEU and the recipe's scorer
# ---------------------------------------------------------------------------

HYPS = ["Das ist ein kleiner Test .", "die katze sitzt auf der matte", "Guten Morgen, wie geht es Ihnen?",
        "", "3.14 ist ungefähr pi, 1,000 Dinge", "völlig andere wörter hier", "今天天气很好"]
REFS = ["Das ist ein kleiner Test.", "Die Katze sitzt auf der Matte.", "Guten Morgen, wie geht es dir?",
        "Leer", "3.14 ist ungefähr Pi, 1,000 Dinge.", "ganz etwas anderes", "今天天气不错"]


@pytest.mark.parametrize("tokenize", ["13a", "zh"])
def test_bleu_matches_jax_and_sacrebleu(tokenize):
    import sacrebleu

    from slam_llm_tpu.utils import bleu as jbleu
    from slam_llm_tpu_torch.utils import bleu as tbleu

    for hyps, refs in ((HYPS, REFS), (HYPS[:3], REFS[:3]), (["a b c d"], ["x y z w"]), (["a"], ["a b c d e"])):
        got = tbleu.corpus_bleu(hyps, [[r] for r in refs], tokenize=tbleu.TOKENIZERS[tokenize])
        want = jbleu.corpus_bleu(hyps, [[r] for r in refs], tokenize=jbleu.TOKENIZERS[tokenize])
        assert abs(got[0] - want[0]) <= 1e-9 and got[1] == want[1] and got[2] == want[2]
        if tokenize == "13a":
            sb = sacrebleu.corpus_bleu(hyps, [refs], tokenize="13a", smooth_method="exp")
            assert abs(got[0] - sb.score) <= 1e-9, (hyps, refs)


def _run_reference_scorer(argv, capsys, monkeypatch):
    path = REPO / "examples" / "st_covost2" / "eval_werbleu.py"
    spec = importlib.util.spec_from_file_location("st_eval_werbleu", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr("sys.argv", ["eval_werbleu.py", *argv])
    mod.main()
    return capsys.readouterr().out


def test_eval_werbleu_prints_what_the_recipes_scorer_prints(tmp_path, capsys, monkeypatch):
    """Decode logs with the CoT tag (transcript <|de|> translation), one
    response without it, and a results jsonl: the same WER and BLEU lines."""
    from slam_llm_tpu_torch.tools import eval_werbleu

    gts = [f"{r.lower()} <|de|> {h}" for r, h in zip(REFS, REFS)]
    preds = [f"{h} <|de|> {h}" for h in HYPS[:-1]] + ["no tag in this response"]
    (tmp_path / "d_gt").write_text("".join(f"utt{i}\t{g}\n" for i, g in enumerate(gts)))
    (tmp_path / "d_pred").write_text("".join(f"utt{i}\t{p}\n" for i, p in enumerate(preds)))
    rows = [{"gt": g, "response": p, "source": "x"} for g, p in zip(REFS, HYPS)]
    (tmp_path / "r.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
    for argv in (["--pred", str(tmp_path / "d_pred"), "--gt", str(tmp_path / "d_gt")],
                 ["--file", str(tmp_path / "r.jsonl")], ["--file", str(tmp_path / "r.jsonl"), "--task", "asr"]):
        want = _run_reference_scorer(argv, capsys, monkeypatch)
        lines = eval_werbleu.main(argv)
        got = capsys.readouterr().out
        assert got == want and [json.loads(x) for x in got.splitlines()] == lines, argv
