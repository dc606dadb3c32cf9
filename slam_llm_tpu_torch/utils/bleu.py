"""Corpus BLEU, sacrebleu-compatible (mteval-13a tokenization, exp smoothing).

The port's own copy of ``slam_llm_tpu/utils/bleu.py``, held against it and
against ``sacrebleu`` by ``tests/test_torch_bytelevel.py``. The reference
scores CoT-ST translation with ``sacrebleu.corpus_bleu`` (reference
examples/st_covost2/test_werbleu.py:76-83); this computes the same metric in
plain Python, so the recipe is scorable on a host without sacrebleu:

* ``tokenize_13a``: the WMT mteval-v13a tokenizer (sacrebleu's default) —
  language-independent punctuation splitting with digit-aware period/comma
  handling; ``tokenize_zh`` splits CJK characters for zh / ja targets.
* ``corpus_bleu``: BLEU-4 with corpus-level n-gram pooling, closest-length
  brevity penalty against multiple references, and sacrebleu's ``exp``
  smoothing (floor 1/(2^k) on zero precisions, k doubling per zero order).

Returns percentage scores (0-100), matching sacrebleu's scale.
"""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import List, Sequence, Tuple

# ---------------------------------------------------------------------------
# mteval-v13a tokenization
# ---------------------------------------------------------------------------

_13A_SUBS = [
    (re.compile(r"<skipped>"), ""),
    (re.compile(r"-\n"), ""),
    (re.compile(r"\n"), " "),
    (re.compile(r"&quot;"), '"'),
    (re.compile(r"&amp;"), "&"),
    (re.compile(r"&lt;"), "<"),
    (re.compile(r"&gt;"), ">"),
]

# tokenization proper (applied to " {text} " with padded spaces):
_13A_TOK = [
    # split out punctuation not adjacent to a digit
    (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
    # period/comma followed by non-digit
    (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
    # period/comma preceded by non-digit
    (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
    # dash preceded by a digit
    (re.compile(r"([0-9])(-)"), r"\1 \2 "),
]


def tokenize_13a(line: str) -> List[str]:
    for pat, rep in _13A_SUBS:
        line = pat.sub(rep, line)
    line = f" {line} "
    for pat, rep in _13A_TOK:
        line = pat.sub(rep, line)
    return line.split()


# ---------------------------------------------------------------------------
# corpus BLEU
# ---------------------------------------------------------------------------


_CJK_RANGES = (
    (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0xF900, 0xFAFF),
    (0x3040, 0x30FF),  # hiragana/katakana
    (0x3000, 0x303F),  # CJK symbols/punctuation (、。「」...)
    (0xFF00, 0xFFEF),  # fullwidth forms (，！？ etc.)
    (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),  # Ext-B/C ideographs
)


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


def tokenize_zh(line: str) -> List[str]:
    """sacrebleu 'zh'-style: CJK characters become individual tokens, the
    remaining (latin/digit) spans go through 13a splitting. Used for zh/ja
    targets (reference test_werbleu.py maps ja to mecab, which needs a
    dictionary; character splitting is the standard offline fallback)."""
    out: List[str] = []
    buf: List[str] = []

    def flush():
        if buf:
            out.extend(tokenize_13a("".join(buf)))
            buf.clear()

    for ch in line:
        if _is_cjk(ch):
            flush()
            out.append(ch)
        else:
            buf.append(ch)
    flush()
    return out


TOKENIZERS = {"13a": tokenize_13a, "zh": tokenize_zh, "ja": tokenize_zh}


def _ngrams(tokens: Sequence[str], max_n: int) -> Counter:
    counts: Counter = Counter()
    for n in range(1, max_n + 1):
        for i in range(len(tokens) - n + 1):
            counts[tuple(tokens[i : i + n])] += 1
    return counts


def corpus_bleu(
    hypotheses: List[str],
    references: List[List[str]],
    max_n: int = 4,
    smooth: str = "exp",
    tokenize=tokenize_13a,
    effective_order: bool = False,
) -> Tuple[float, List[float], float]:
    """sacrebleu-exact corpus BLEU (semantics mirror
    ``sacrebleu.metrics.bleu.BLEU.compute_bleu``, parity-tested in
    tests/test_torch_bytelevel.py):

    * zero clipped matches at EVERY order -> score 0, no smoothing;
    * orders with zero total hyp n-grams terminate the precision loop;
    * ``exp`` smoothing (mteval NIST): zero-match orders get
      100/(2^k * total), k doubling per zero order;
    * ``effective_order`` (sacrebleu's sentence-BLEU flag, default False like
      corpus BLEU): when True the geometric mean stops at the last order with
      any hyp n-grams; when False a zero precision zeroes the score.

    Returns (bleu_percent, precisions_percent[max_n], brevity_penalty).
    """
    if smooth not in ("exp", "none", None):
        raise ValueError(
            f"smooth={smooth!r}: only 'exp'/'none' are implemented "
            "(sacrebleu 'floor'/'add-k' are not — failing loudly beats a "
            "silently-zero score)"
        )

    if len(hypotheses) != len(references):
        raise ValueError(f"{len(hypotheses)} hyps vs {len(references)} ref sets")
    num = [0] * max_n  # clipped matches per order
    den = [0] * max_n  # total hyp ngrams per order
    sys_len = 0
    ref_len = 0
    for hyp, refs in zip(hypotheses, references):
        h = tokenize(hyp.rstrip())
        rs = [tokenize(r.rstrip()) for r in refs]
        sys_len += len(h)
        # closest reference length (ties -> shorter), sacrebleu/mteval rule
        ref_len += min((abs(len(r) - len(h)), len(r)) for r in rs)[1]
        h_counts = _ngrams(h, max_n)
        max_ref: Counter = Counter()
        for r in rs:
            for gram, c in _ngrams(r, max_n).items():
                if c > max_ref[gram]:
                    max_ref[gram] = c
        for gram, c in h_counts.items():
            n = len(gram) - 1
            den[n] += c
            num[n] += min(c, max_ref.get(gram, 0))

    bp = 1.0
    if sys_len < ref_len:
        bp = math.exp(1.0 - ref_len / sys_len) if sys_len > 0 else 0.0

    precisions = [0.0] * max_n
    if not any(num):  # sacrebleu #141: no matches at any order -> hard zero
        return 0.0, precisions, bp

    smooth_val = 1.0
    eff_order = max_n
    for n in range(max_n):
        if den[n] == 0:
            break
        if effective_order:
            eff_order = n + 1
        if num[n] == 0:
            if smooth == "exp":
                smooth_val *= 2.0
                precisions[n] = 100.0 / (smooth_val * den[n])
        else:
            precisions[n] = 100.0 * num[n] / den[n]

    def _log(p: float) -> float:
        return math.log(p) if p > 0.0 else -9999999999.0

    score = bp * math.exp(sum(_log(p) for p in precisions[:eff_order]) / eff_order)
    return score, precisions, bp
