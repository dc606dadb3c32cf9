"""Kaldi-style decode-log preprocessing, mirroring two reference CLIs.

Counterpart of ``slam_llm_tpu/utils/preprocess_text.py``:

* ``utils/preprocess_text.py`` — strip ``<|``/``|>`` markers and punctuation
  (apostrophes kept), uppercase, emit ``key TEXT`` lines;
* ``utils/num2word.py`` — spell standalone digit tokens as English words
  (the reference wraps the ``num2words`` pip package; here the expansion is
  from scratch, inverse of textnorm.words_to_number).

    python -m slam_llm_tpu_torch.utils.preprocess_text in.tsv out.txt [--num2word]
"""

from __future__ import annotations

import re
import string
import sys

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [(10 ** 9, "billion"), (10 ** 6, "million"), (10 ** 3, "thousand")]


def number_to_words(n: int) -> str:
    """English words for a non-negative integer (num2words semantics for the
    cardinal form: 'one hundred and twenty-three')."""
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        tens, rem = divmod(n, 10)
        return _TENS[tens] + ("-" + _ONES[rem] if rem else "")
    if n < 1000:
        hundreds, rem = divmod(n, 100)
        out = _ONES[hundreds] + " hundred"
        return out + (" and " + number_to_words(rem) if rem else "")
    for scale, name in _SCALES:
        if n >= scale:
            major, rem = divmod(n, scale)
            out = number_to_words(major) + " " + name
            if not rem:
                return out
            joiner = " and " if rem < 100 else " "
            return out + joiner + number_to_words(rem)
    return str(n)  # pragma: no cover


def digits_to_words(text: str) -> str:
    """Spell standalone digit tokens (reference num2word.py: ``ct.isdigit()``
    tokens only — '42' converts, '42nd' and '4.5' pass through)."""
    return " ".join(
        number_to_words(int(tok)) if tok.isdigit() else tok
        for tok in text.split()
    )


_PUNCT_TABLE = str.maketrans("", "", string.punctuation.replace("'", ""))


def kaldi_uppercase_normalize(text: str) -> str:
    """Reference preprocess_text.py: drop special-token markers, strip
    punctuation except apostrophes, uppercase."""
    text = text.replace("<|", "").replace("|>", "").replace("—", "")
    return text.translate(_PUNCT_TABLE).upper()


def preprocess_file(src: str, dst: str, num2word: bool = False) -> None:
    """``key\\ttext`` TSV in, ``key TEXT`` kaldi lines out (empty texts
    become a single space, matching the reference)."""
    with open(src, encoding="utf-8") as f_in, open(dst, "w", encoding="utf-8") as f_out:
        for line in f_in:
            parts = line.strip().split("\t", 1)
            if len(parts) == 2:
                key, text = parts
                if num2word:
                    text = digits_to_words(text)
                text = kaldi_uppercase_normalize(text)
            else:
                key, text = parts[0], " "
            f_out.write(f"{key} {text}\n")


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    preprocess_file(args[0], args[1], num2word="--num2word" in sys.argv)
