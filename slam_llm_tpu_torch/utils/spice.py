"""SPICE: Semantic Propositional Image Caption Evaluation (Anderson et al.
2016), self-contained.

The reference computes SPICE through ``aac-metrics`` (reference
utils/compute_aac_metrics.py:5-27), which shells out to the original Java
scorer: a Stanford dependency parse -> scene graph -> tuple F1 with WordNet
synset matching. None of that stack (Java, CoreNLP models, WordNet data) is
a dependency here, so this module rebuilds the pipeline in pure Python
(the port's own copy of ``slam_llm_tpu/utils/spice.py``, held against it
by ``tests/test_torch_host.py``):

  1. tokenize + rule/lexicon POS tagging (closed-class table, caption-domain
     lexicon, suffix + context rules — captions are short declaratives, the
     genre the Brill-style rules were designed for);
  2. scene-graph extraction over NP chunks: objects = lemmatized head nouns,
     attributes = adjectival/participial premodifiers and copular
     complements, relations = (subject, verb[_prep], object) and bare
     prepositional attachments (``man in car`` -> (man, in, car));
  3. tuples T(G) = objects  +  (obj, attr)  +  (subj, rel, obj), as sets;
  4. candidate-vs-merged-reference matching with lemma equality or shared
     membership in an embedded synonym table (standing in for WordNet
     synsets);
  5. score = mean over captions of F1(P, R), the quantity the official
     scorer reports.

Differences from the Java scorer — a dependency parse replaced by chunk
rules, WordNet replaced by a fixed synonym table — mean scores are
close-but-not-bit-identical; the propositional content being scored is the
same. SPIDEr = (CIDEr-D + SPICE)/2 becomes computable offline
(utils/caption_metrics.py wires it in).
"""

from __future__ import annotations

import re
from typing import Dict, FrozenSet, List, Sequence, Set, Tuple

Tup = Tuple[str, ...]

# ---------------------------------------------------------------------------
# lexicon
# ---------------------------------------------------------------------------

# closed classes (exhaustive enough for caption English)
_CLOSED: Dict[str, str] = {}
for _w in ("a", "an", "the", "this", "that", "these", "those", "some", "any",
           "each", "every", "no", "another", "both", "all", "several", "few",
           "many", "much", "more", "most", "other", "various"):
    _CLOSED[_w] = "DT"
for _w in ("in", "on", "at", "by", "with", "from", "into", "onto", "over",
           "under", "near", "behind", "beside", "between", "through",
           "against", "above", "below", "inside", "outside", "across",
           "along", "around", "towards", "toward", "during", "off", "upon",
           "within", "amid", "of", "for", "as", "to"):
    _CLOSED[_w] = "IN"
for _w in ("and", "or", "but", "nor"):
    _CLOSED[_w] = "CC"
for _w in ("he", "she", "it", "they", "we", "you", "i", "him", "her", "them",
           "us", "me", "someone", "something", "somebody"):
    _CLOSED[_w] = "PRP"
for _w in ("his", "hers", "its", "their", "our", "your", "my"):
    _CLOSED[_w] = "PRP$"
for _w in ("is", "are", "was", "were", "be", "been", "being", "am"):
    _CLOSED[_w] = "BE"
for _w in ("can", "could", "will", "would", "may", "might", "shall",
           "should", "must"):
    _CLOSED[_w] = "MD"
for _w in ("not", "n't", "there", "then", "also", "very", "too", "so",
           "again", "still", "just", "once", "twice", "repeatedly",
           "continuously", "loudly", "quietly", "softly", "rapidly",
           "slowly", "quickly", "faintly", "steadily", "gently",
           "occasionally", "intermittently", "constantly", "gradually",
           "suddenly", "briefly", "nearby", "away", "back", "forth", "up",
           "down", "while", "when", "before", "after", "followed"):
    _CLOSED[_w] = "RB"
_CLOSED["followed"] = "VBN"  # "X followed by Y" — pervasive in AAC captions

# open-class hints for the audio/visual caption domain. Words not listed
# fall through to suffix + context rules.
_VERBS = {
    "bark", "barks", "barking", "speak", "speaks", "speaking", "spoke",
    "talk", "talks", "talking", "play", "plays", "playing", "played",
    "sing", "sings", "singing", "sang", "run", "runs", "running", "ran",
    "walk", "walks", "walking", "ring", "rings", "ringing", "rang",
    "honk", "honks", "honking", "hum", "hums", "humming", "buzz", "buzzes",
    "buzzing", "chirp", "chirps", "chirping", "meow", "meows", "meowing",
    "crow", "crows", "crowing", "cry", "cries", "crying", "laugh", "laughs",
    "laughing", "shout", "shouts", "shouting", "whistle", "whistles",
    "whistling", "blow", "blows", "blowing", "drive", "drives", "driving",
    "pass", "passes", "passing", "approach", "approaches", "approaching",
    "accelerate", "accelerates", "accelerating", "idle", "idles", "idling",
    "rev", "revs", "revving", "drip", "drips", "dripping", "splash",
    "splashes", "splashing", "pour", "pours", "pouring", "flow", "flows",
    "flowing", "rain", "rains", "raining", "thunder", "thunders",
    "thundering", "knock", "knocks", "knocking", "tap", "taps", "tapping",
    "bang", "bangs", "banging", "slam", "slams", "slamming", "open",
    "opens", "opening", "close", "closes", "closing", "make", "makes",
    "making", "made", "produce", "produces", "producing", "emit", "emits",
    "emitting", "sound", "sounds", "sounding", "hear", "hears", "heard",
    "follow", "follows", "following", "accompany", "accompanies",
    "accompanied", "accompanying", "start", "starts", "starting", "stop",
    "stops", "stopping", "continue", "continues", "continuing", "get",
    "gets", "getting", "go", "goes", "going", "come", "comes", "coming",
    "stand", "stands", "standing", "sit", "sits", "sitting", "hold",
    "holds", "holding", "wear", "wears", "wearing", "eat", "eats",
    "eating", "fly", "flies", "flying", "jump", "jumps", "jumping",
    "ride", "rides", "riding", "throw", "throws", "throwing", "catch",
    "catches", "catching", "look", "looks", "looking", "watch", "watches",
    "watching", "snore", "snores", "snoring", "breathe", "breathes",
    "breathing", "cough", "coughs", "coughing", "sneeze", "sneezes",
    "sneezing", "clap", "claps", "clapping", "cheer", "cheers", "cheering",
    "howl", "howls", "howling", "growl", "growls", "growling", "squeak",
    "squeaks", "squeaking", "squeal", "squeals", "squealing", "rustle",
    "rustles", "rustling", "rumble", "rumbles", "rumbling", "roar",
    "roars", "roaring", "hiss", "hisses", "hissing", "beep", "beeps",
    "beeping", "click", "clicks", "clicking", "tick", "ticks", "ticking",
    "spray", "sprays", "spraying", "vibrate", "vibrates", "vibrating",
    "echo", "echoes", "echoing", "fade", "fades", "fading", "increase",
    "increases", "increasing", "decrease", "decreases", "decreasing",
}
_ADJS = {
    "loud", "quiet", "soft", "faint", "distant", "high", "low", "deep",
    "high-pitched", "low-pitched", "large", "small", "big", "little",
    "long", "short", "fast", "slow", "heavy", "light", "metallic",
    "mechanical", "electronic", "muffled", "sharp", "dull", "steady",
    "constant", "continuous", "intermittent", "repetitive", "rhythmic",
    "musical", "male", "female", "young", "old", "adult", "human",
    "animal", "red", "green", "blue", "white", "black", "brown", "gray",
    "yellow", "orange", "wet", "dry", "hard", "empty", "full", "open",
    "closed", "busy", "noisy", "silent", "audible", "multiple", "single",
    "nearby", "strong", "gentle", "angry", "happy", "sad", "excited",
    "calm", "wooden", "plastic", "glass", "electric",
}
_NOUNS = {
    "man", "woman", "person", "people", "child", "children", "boy", "girl",
    "baby", "crowd", "dog", "cat", "bird", "rooster", "duck", "horse",
    "cow", "sheep", "goat", "pig", "insect", "bee", "frog", "engine",
    "car", "truck", "bus", "train", "motorcycle", "vehicle", "traffic",
    "airplane", "plane", "helicopter", "boat", "siren", "horn", "alarm",
    "bell", "phone", "telephone", "music", "song", "instrument", "guitar",
    "piano", "drum", "drums", "violin", "flute", "trumpet", "wind",
    "water", "rain", "thunder", "storm", "river", "stream", "ocean",
    "wave", "waves", "fire", "door", "window", "machine", "machinery",
    "tool", "saw", "drill", "hammer", "vacuum", "blender", "microwave",
    "clock", "keyboard", "typewriter", "paper", "plastic", "metal",
    "glass", "wood", "footsteps", "voice", "voices", "speech", "noise",
    "sound", "sounds", "background", "foreground", "street", "road",
    "room", "kitchen", "bathroom", "toilet", "sink", "shower", "crying",
    "laughter", "applause", "crackling", "static", "silence", "gun",
    "gunshot", "fireworks", "explosion", "whistle", "motor", "fan",
    "radio", "television", "tv", "speaker", "microphone", "camera",
    "surface", "floor", "ground", "table", "field", "park", "beach",
    "distance", "time", "group", "series", "variety", "type", "kind",
}

# synonym equivalence classes (WordNet-synset stand-in). Every class member
# maps to a canonical id; tuples match when lemmas are equal OR share a class.
_SYNONYM_CLASSES: List[Set[str]] = [
    {"man", "guy", "male", "gentleman"},
    {"woman", "lady", "female"},
    {"person", "human", "individual", "somebody", "someone"},
    {"child", "kid", "youngster"},
    {"baby", "infant"},
    {"people", "crowd", "group"},
    {"car", "automobile", "auto"},
    {"vehicle", "motorcar"},
    {"plane", "airplane", "aircraft", "jet"},
    {"phone", "telephone"},
    {"tv", "television"},
    {"speak", "talk", "converse"},
    {"say", "tell", "state"},
    {"loud", "noisy"},
    {"quiet", "silent", "soft"},
    {"fast", "quick", "rapid"},
    {"slow", "sluggish"},
    {"big", "large", "huge"},
    {"small", "little", "tiny"},
    {"begin", "start", "commence"},
    {"stop", "halt", "cease", "end"},
    {"make", "produce", "create", "emit", "generate"},
    {"sound", "noise"},
    {"road", "street"},
    {"dog", "canine", "puppy"},
    {"cat", "feline", "kitten"},
    {"cry", "weep", "sob"},
    {"laugh", "chuckle", "giggle"},
    {"shout", "yell", "scream"},
    {"ring", "chime", "toll"},
    {"hum", "drone", "whir"},
    {"bang", "slam", "thud"},
    {"rain", "rainfall"},
    {"engine", "motor"},
    {"song", "tune", "melody"},
]
_SYN_ID: Dict[str, int] = {}
for _i, _cls in enumerate(_SYNONYM_CLASSES):
    for _w in _cls:
        _SYN_ID[_w] = _i

_IRREGULAR_PLURALS = {
    "men": "man", "women": "woman", "children": "child", "people": "people",
    "geese": "goose", "mice": "mouse", "feet": "foot", "teeth": "tooth",
    "leaves": "leaf", "wolves": "wolf", "knives": "knife", "lives": "life",
    "buses": "bus", "glasses": "glass", "dishes": "dish", "echoes": "echo",
}
_IRREGULAR_VERBS = {
    "spoke": "speak", "sang": "sing", "ran": "run", "rang": "ring",
    "made": "make", "heard": "hear", "went": "go", "came": "come",
    "sat": "sit", "stood": "stand", "held": "hold", "wore": "wear",
    "ate": "eat", "flew": "fly", "threw": "throw", "caught": "catch",
    "said": "say", "got": "get", "drove": "drive",
}


def lemma(word: str) -> str:
    """Rule lemmatizer: irregulars, then -ies/-es/-s, -ing/-ed with
    consonant-doubling undo. Good enough for caption vocabulary."""
    w = word.lower()
    if w in _IRREGULAR_PLURALS:
        return _IRREGULAR_PLURALS[w]
    if w in _IRREGULAR_VERBS:
        return _IRREGULAR_VERBS[w]
    for suf, repl in (("ies", "y"), ("sses", "ss"), ("shes", "sh"),
                      ("ches", "ch"), ("xes", "x"), ("zes", "z")):
        if w.endswith(suf) and len(w) > len(suf) + 1:
            return w[: -len(suf)] + repl
    if w.endswith("s") and not w.endswith("ss") and len(w) > 3:
        return w[:-1]
    for suf in ("ing", "ed"):
        if w.endswith(suf) and len(w) > len(suf) + 2:
            stem = w[: -len(suf)]
            if len(stem) > 2 and stem[-1] == stem[-2] and stem[-1] not in "lsz":
                stem = stem[:-1]  # running -> run, tapped -> tap
            if stem + "e" in _VERBS or stem + "e" in _NOUNS:
                stem += "e"  # driving -> drive
            return stem
    return w


def _match(a: str, b: str) -> bool:
    if a == b:
        return True
    ia, ib = _SYN_ID.get(a), _SYN_ID.get(b)
    return ia is not None and ia == ib


# ---------------------------------------------------------------------------
# POS tagging
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"[a-z0-9']+(?:-[a-z0-9']+)*")


def tokenize(s: str) -> List[str]:
    return _TOKEN_RE.findall(s.lower())


def pos_tag(tokens: Sequence[str]) -> List[str]:
    """Lexicon + suffix tags, then context fixups."""
    tags: List[str] = []
    for w in tokens:
        if w in _CLOSED:
            tags.append(_CLOSED[w])
        elif w in _NOUNS:
            tags.append("NN")
        elif w in _VERBS:
            tags.append("VBG" if w.endswith("ing") else "VB")
        elif w in _ADJS:
            tags.append("JJ")
        elif w.isdigit():
            tags.append("CD")
        elif w.endswith("ly") and len(w) > 3:
            tags.append("RB")
        elif w.endswith("ing") and len(w) > 4:
            tags.append("VBG")
        elif w.endswith("ed") and len(w) > 3:
            tags.append("VBN")
        else:
            tags.append("NN")
    # context fixups
    for i, (w, t) in enumerate(zip(tokens, tags)):
        prev = tags[i - 1] if i else "<s>"
        nxt = tags[i + 1] if i + 1 < len(tags) else "</s>"
        # gerund after BE is progressive verb: "a dog is barking"
        if t == "VBG" and prev == "BE":
            tags[i] = "VB"
        # gerund directly before a noun premodifies it: "barking dog"
        elif t == "VBG" and nxt in ("NN", "JJ"):
            tags[i] = "JJ"
        # known verb right after a determiner/adjective is really a noun:
        # "a bark", "the loud crow"
        if t in ("VB",) and prev in ("DT", "JJ", "PRP$", "CD"):
            tags[i] = "NN"
        # plural-looking known verb after a plural noun stays a verb:
        # "dogs bark" — already VB. Known noun directly before VB/BE keeps NN.
    return tags


# ---------------------------------------------------------------------------
# scene graph
# ---------------------------------------------------------------------------


def scene_graph(caption: str) -> Set[Tup]:
    """Caption -> set of SPICE tuples: (obj,), (obj, attr), (s, rel, o)."""
    toks = tokenize(caption)
    tags = pos_tag(toks)
    n = len(toks)
    tuples: Set[Tup] = set()

    # --- NP chunks: [DT|PRP$|CD]? (JJ|NN)* (NN|NNS); heads may coordinate
    chunks: List[Dict] = []  # {"heads": [lemma], "attrs": [lemma], "s", "e"}
    i = 0
    while i < n:
        t = toks[i]
        if tags[i] in ("DT", "PRP$", "CD") or tags[i] in ("JJ", "NN"):
            j = i
            attrs: List[str] = []
            nouns: List[int] = []
            while j < n and tags[j] in ("DT", "PRP$", "CD", "JJ", "NN", "CC"):
                if tags[j] == "JJ":
                    attrs.append(lemma(toks[j]))
                elif tags[j] == "NN":
                    nouns.append(j)
                elif tags[j] == "CC" and not (
                    j + 1 < n and tags[j + 1] in ("DT", "JJ", "NN", "CD", "PRP$")
                ):
                    break
                j += 1
            if nouns:
                # heads: final noun of each coordinated segment; preceding
                # nouns in the same segment are compound modifiers (dropped —
                # the Java parser folds most compounds into the head)
                heads: List[str] = []
                seg: List[int] = []
                for k in range(i, j):
                    if tags[k] == "NN":
                        seg.append(k)
                    elif tags[k] == "CC" and seg:
                        heads.append(lemma(toks[seg[-1]]))
                        seg = []
                if seg:
                    heads.append(lemma(toks[seg[-1]]))
                chunks.append({"heads": heads, "attrs": attrs, "s": i, "e": j})
                for h in heads:
                    tuples.add((h,))
                    for a in attrs:
                        tuples.add((h, a))
                i = j
                continue
            i = j if j > i else i + 1
            continue
        i += 1

    # --- relations between consecutive chunks
    for ci in range(len(chunks)):
        cur = chunks[ci]
        nxt_chunk = chunks[ci + 1] if ci + 1 < len(chunks) else None
        gap_s, gap_e = cur["e"], nxt_chunk["s"] if nxt_chunk else n
        verbs = [k for k in range(gap_s, gap_e) if tags[k] in ("VB", "VBG", "VBN")]
        preps = [k for k in range(gap_s, gap_e) if tags[k] == "IN"]
        copula = any(tags[k] == "BE" for k in range(gap_s, gap_e))

        # copular adjective: "the dog is loud" (JJ in the gap after BE)
        if copula:
            for k in range(gap_s, gap_e):
                if tags[k] == "JJ":
                    for h in cur["heads"]:
                        tuples.add((h, lemma(toks[k])))

        if nxt_chunk is None:
            # trailing verb with no object: intransitive -> attribute
            # ("a dog barking", "two men talk")
            for k in verbs:
                for h in cur["heads"]:
                    tuples.add((h, lemma(toks[k])))
            continue

        rel: str
        if verbs:
            rel = lemma(toks[verbs[-1]])
            if preps and preps[-1] > verbs[-1]:
                rel = f"{rel} {toks[preps[-1]]}"
        elif preps:
            rel = toks[preps[-1]]
        else:
            continue
        for h1 in cur["heads"]:
            for h2 in nxt_chunk["heads"]:
                tuples.add((h1, rel, h2))
        # verbs are propositional on their own too ("man playing guitar"
        # implies (man, play)); the Java parser emits these as attributes
        for k in verbs:
            for h in cur["heads"]:
                tuples.add((h, lemma(toks[k])))

    return tuples


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------


def _tuple_match(a: Tup, b: Tup) -> bool:
    return len(a) == len(b) and all(
        _match(x, y) or (" " in x and " " in y and
                         all(_match(p, q) for p, q in zip(x.split(), y.split())))
        for x, y in zip(a, b)
    )


def _f1(cand: Set[Tup], ref: Set[Tup]) -> float:
    if not cand and not ref:
        return 1.0
    if not cand or not ref:
        return 0.0
    matched_c = sum(1 for c in cand if any(_tuple_match(c, r) for r in ref))
    matched_r = sum(1 for r in ref if any(_tuple_match(r, c) for c in cand))
    p = matched_c / len(cand)
    r = matched_r / len(ref)
    return 2 * p * r / (p + r) if p + r else 0.0


def spice(candidates: List[str], references: List[List[str]]) -> float:
    """Mean per-caption F1 between candidate tuples and the UNION of all
    reference captions' tuples (the official scorer merges reference scene
    graphs before matching)."""
    if not candidates:
        return 0.0
    total = 0.0
    for cand, refs in zip(candidates, references):
        ref_tuples: Set[Tup] = set()
        for r in refs:
            ref_tuples |= scene_graph(r)
        total += _f1(scene_graph(cand), ref_tuples)
    return total / len(candidates)
