"""English text normalization for WER scoring.

From-scratch equivalent of the reference's normalizer wrappers
(``utils/whisper_tn.py`` / ``utils/llm_tn.py``, which call the pip package
``whisper_normalizer.english.EnglishTextNormalizer``): lowercase, strip
bracketed/parenthesized asides, expand contractions, spell out symbols,
convert spelled numbers to digits (common cases), squash llm repetition
loops, collapse whitespace. CLI-compatible file interface (key<TAB>text). Counterpart of
``slam_llm_tpu/utils/textnorm.py``:

    python -m slam_llm_tpu_torch.utils.textnorm <in: key text> <out: key<TAB>text> [--llm]

(``--llm`` also squashes repetition loops.)
"""

from __future__ import annotations

import re
from typing import List

_CONTRACTIONS = {
    "won't": "will not", "can't": "can not", "shan't": "shall not",
    "n't": " not", "'re": " are", "'ve": " have", "'ll": " will",
    "'d": " would", "'m": " am", "let's": "let us",
    "ma'am": "madam", "o'clock": "of the clock", "y'all": "you all",
}

_SPECIALS = {
    "mr": "mister", "mrs": "missus", "st": "saint", "dr": "doctor",
    "prof": "professor", "jr": "junior", "sr": "senior",
    "&": "and", "%": "percent",
}
# currency symbols precede the amount in writing but FOLLOW it in speech:
# "$25" must normalize to "25 dollars" (matching the spoken hypothesis), not
# "dollars 25"
_CURRENCY = {"$": "dollars", "£": "pounds", "€": "euros"}

_ONES = {
    "zero": 0, "one": 1, "two": 2, "three": 3, "four": 4, "five": 5,
    "six": 6, "seven": 7, "eight": 8, "nine": 9, "ten": 10, "eleven": 11,
    "twelve": 12, "thirteen": 13, "fourteen": 14, "fifteen": 15,
    "sixteen": 16, "seventeen": 17, "eighteen": 18, "nineteen": 19,
}
_TENS = {
    "twenty": 20, "thirty": 30, "forty": 40, "fifty": 50,
    "sixty": 60, "seventy": 70, "eighty": 80, "ninety": 90,
}
_SCALES = {"hundred": 100, "thousand": 1000, "million": 10**6, "billion": 10**9}


def words_to_number(tokens: List[str]):
    """Parse a run of number words; returns (value, n_consumed) or None.

    A component may only EXTEND the current hundreds-group if it is strictly
    smaller than what room remains ("twenty" then "five" ok; "nineteen" then
    "ninety" is TWO numbers) — without this, adjacent independent numbers
    summed ("nineteen ninety nine" -> 118). "and" joins only after a scale
    word ("hundred and two"), never two independent numbers ("one and two").
    """
    total, current, consumed = 0, 0, 0
    seen_any = False
    room = 10 ** 9  # next component must be < room within the group
    last_was_scale = False
    for tok in tokens:
        t = tok.replace("-", " ").split()
        if len(t) == 2 and t[0] in _TENS and t[1] in _ONES and 0 < _ONES[t[1]] < 10:
            v = _TENS[t[0]] + _ONES[t[1]]
            if _TENS[t[0]] >= room:
                break
            current += v
            room = 1  # group exhausted (tens+ones)
            consumed += 1
            seen_any = True
            last_was_scale = False
        elif tok in _ONES:
            v = _ONES[tok]
            if v == 0:
                # "zero" never combines ("zero zero seven" stays three words)
                break
            need = 11 if v >= 10 else v  # teens occupy the tens+ones slots
            if need >= room:
                break
            current += v
            room = 1
            consumed += 1
            seen_any = True
            last_was_scale = False
        elif tok in _TENS:
            if _TENS[tok] >= room:
                break
            current += _TENS[tok]
            room = 10  # only a ones word may follow in this group
            consumed += 1
            seen_any = True
            last_was_scale = False
        elif tok == "and" and last_was_scale:
            consumed += 1
        elif tok in _SCALES:
            if not seen_any:
                return None
            if tok == "hundred":
                if current == 0 or current >= 100:
                    break
                current = current * 100
                room = 100
            else:
                total += max(current, 1) * _SCALES[tok]
                current = 0
                room = 10 ** 9
            consumed += 1
            last_was_scale = True
        else:
            break
    if not seen_any:
        return None
    # trailing "and" shouldn't be consumed
    while consumed > 0 and tokens[consumed - 1] == "and":
        consumed -= 1
    return total + current, consumed


def normalize_numbers(text: str) -> str:
    tokens = text.split()
    out: List[str] = []
    i = 0
    while i < len(tokens):
        parsed = words_to_number(tokens[i:])
        if parsed is not None and parsed[1] >= 2:  # only convert multi-word numbers
            out.append(str(parsed[0]))
            i += parsed[1]
        else:
            out.append(tokens[i])
            i += 1
    return " ".join(out)


def reduce_repeated_words(text: str) -> str:
    """Squash LLM repetition loops (reference utils/llm_tn.py:9-16)."""
    for i in range(1, 50):
        text = re.sub(f"(.{{{i}}})" + r"\1{4,200}", r"\1", text)
    for i in range(50, 100):
        text = re.sub(f"(.{{{i}}})" + r"\1{3,200}", r"\1", text)
    return text


class EnglishTextNormalizer:
    def __call__(self, text: str) -> str:
        s = text.lower()
        # fold unicode apostrophes BEFORE contraction lookup: curly-quote
        # "won’t" must expand like ASCII "won't", not shatter to "won t"
        s = s.replace("’", "'").replace("‘", "'").replace("ʼ", "'")
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)  # remove [..] <..> asides
        s = re.sub(r"\(([^)]+?)\)", "", s)  # remove (..) asides
        for k, v in _CONTRACTIONS.items():
            s = s.replace(k, v)
        s = re.sub(r"(\d),(\d)", r"\1\2", s)  # 1,000 -> 1000
        for sym, word in _CURRENCY.items():
            # $25 / $25.50 -> "25 dollars" (spoken order); bare symbol -> word
            s = re.sub(rf"\{sym}\s*(\d+(?:\.\d+)?)", rf"\1 {word}", s)
            s = s.replace(sym, f" {word} ")
        for k, v in _SPECIALS.items():
            if len(k) > 1:
                s = re.sub(rf"\b{k}\b\.?", v, s)
            else:
                s = s.replace(k, f" {v} ")
        s = re.sub(r"[^\w\s'.-]", " ", s)  # drop punctuation
        # keep '.' only BETWEEN digits (3.14); "costs 5." must yield "5"
        s = re.sub(r"\.(?!\d)", " ", s)
        s = s.replace("-", " ")
        s = normalize_numbers(s)
        s = re.sub(r"\s+", " ", s).strip()
        return s


def basic_normalize(text: str) -> str:
    """Language-agnostic normalizer (whisper ``BasicTextNormalizer``
    semantics, used by the ST scorer, reference
    examples/st_covost2/test_werbleu.py:66-81): lowercase, drop bracketed
    asides, replace symbols/punctuation (any non word/space codepoint) with
    space, collapse whitespace. Unicode word chars survive, so it is safe on
    non-English targets."""
    s = text.lower()
    s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)
    s = re.sub(r"\(([^)]+?)\)", "", s)
    s = re.sub(r"[^\w\s]", " ", s, flags=re.UNICODE)
    return re.sub(r"\s+", " ", s).strip()


def normalize_file(src: str, dst: str, squash_repeats: bool = False) -> None:
    """key<SP>text -> key<TAB>normalized (matches whisper_tn/llm_tn CLIs)."""
    norm = EnglishTextNormalizer()
    with open(src, encoding="utf-8") as f_in, open(dst, "w", encoding="utf-8") as f_out:
        for line in f_in:
            parts = line.strip().split()
            if not parts:
                continue
            key, text = parts[0], " ".join(parts[1:])
            text = norm(text)
            if squash_repeats:
                text = reduce_repeated_words(text)
            f_out.write(f"{key}\t{text}\n")


if __name__ == "__main__":
    import sys

    normalize_file(sys.argv[1], sys.argv[2], squash_repeats="--llm" in sys.argv)
