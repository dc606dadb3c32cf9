"""The port's last host modules against the JAX package's, on the CPU.

``ops/monotonic_align.py``: the port's own C++ core (built with ``g++`` at
first use into ``build/slam_llm_tpu_torch/``) and its numpy twin equal the
JAX package's numpy path and the exhaustive best path; a failed build
raises. ``utils/ppl.py``: ``ppl_of_texts`` and ``main`` on a random tiny HF
Llama checkpoint written here, against the JAX package's (both bf16, as the
CLI runs). ``utils/preprocess_text.py``, ``utils/chat_utils.py`` and
``utils/safety_utils.py`` give the JAX modules' outputs.
"""

import json

import numpy as np
import pytest

from slam_llm_tpu.ops import monotonic_align as jma
from slam_llm_tpu_torch.ops import monotonic_align as tma


def _brute_force_best(value):
    """The best monotonic path of a small matrix by exhaustive search."""
    tx, ty = value.shape
    best, best_path = -np.inf, None

    def rec(x, y, score, path):
        nonlocal best, best_path
        score, path = score + value[x, y], path + [(x, y)]
        if y == ty - 1:
            if x == tx - 1 and score > best:
                best, best_path = score, path
            return
        rec(x, y + 1, score, path)
        if x + 1 < tx:
            rec(x + 1, y + 1, score, path)

    rec(0, 0, 0.0, [])
    out = np.zeros((tx, ty), np.int32)
    for x, y in best_path:
        out[x, y] = 1
    return out


@pytest.mark.parametrize("native", [True, False])
def test_maximum_path_matches_jax_and_brute_force(native):
    """Ragged batches: the native core and the twin equal the JAX package's
    numpy path bit for bit, and small matrices the exhaustive best path;
    the input is not written."""
    rng = np.random.default_rng(1)
    v = rng.standard_normal((4, 11, 17)).astype(np.float32)
    txs, tys = np.array([11, 8, 5, 1], np.int32), np.array([17, 12, 9, 3], np.int32)
    before = v.copy()
    got = tma.maximum_path(v, txs, tys, native=native)
    want = np.zeros_like(got)
    jma._maximum_path_numpy(want, v.copy(), txs, tys, -1e9)
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(v, before) and got.dtype == np.int32
    for i in range(4):
        assert got[i, : txs[i], : tys[i]].sum(0).tolist() == [1] * tys[i]  # one x per frame
        assert not got[i, txs[i]:].any() and not got[i, :, tys[i]:].any()
    for seed in range(4):
        small = np.random.default_rng(seed).standard_normal((4, 7)).astype(np.float32)
        np.testing.assert_array_equal(tma.maximum_path(small[None], native=native)[0], _brute_force_best(small))


def test_native_build_lands_in_the_build_dir_and_a_failed_build_raises(tmp_path, monkeypatch):
    """The library is the port's own, built from its copy of the source
    under ``build/slam_llm_tpu_torch/`` (never the JAX package's ``.so``);
    a source that does not compile raises with the compiler's message."""
    lib = tma.build()
    assert lib.parent == tma.BUILD_DIR and lib.exists() and tma.SRC.parent.name == "native"
    assert tma.SRC.parent.parent.name == "slam_llm_tpu_torch"
    bad = tmp_path / "monotonic_align.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tma, "SRC", bad)
    monkeypatch.setattr(tma, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="building monotonic_align.cpp failed"):
        tma.build()


# ---- ppl ---------------------------------------------------------------------------------

VOCAB = 384  # the synthetic Llama tokenizer's entries, the tiny model's rows
TEXTS = ["the quick brown fox jumps over the lazy dog", "a b", "", "hello, world! 1234 ... what's that?",
         "ab" * 40]


@pytest.fixture
def tiny_llm(tmp_path, monkeypatch):
    """A random tiny Llama HF directory (the ``tiny-test`` widths at
    ``VOCAB`` rows) with a Llama tokenizer of ``VOCAB`` entries, both
    packages' ``tiny-test`` preset widened to it, and a decode log."""
    from slam_llm_tpu.models import llm as jllm
    from slam_llm_tpu_torch.models import llm as tllm
    from slam_llm_tpu_torch.tools.synth_checkpoint import write_llama, write_tokenizer

    for mod in (jllm, tllm):
        tiny = mod.LLMConfig.tiny_test
        monkeypatch.setattr(mod.LLMConfig, "tiny_test", staticmethod(lambda vocab_size=VOCAB, f=tiny: f(VOCAB)))
    d = tmp_path / "llm"
    write_llama(str(d), tllm.LLMConfig.tiny_test(), seed=3)
    write_tokenizer(str(d), VOCAB, seed=3)
    log = tmp_path / "decode_pred"
    log.write_text("".join(f"utt{i}\t{t}\n" for i, t in enumerate(TEXTS)) + "no_tab_line\n", encoding="utf-8")
    return d, log


def test_ppl_of_texts_and_main_match_jax(tiny_llm, capsys):
    """Per-text and corpus perplexities within 1e-2 relative of the JAX
    package's ``ppl_of_texts`` (bf16 compute on both sides, causal forwards
    without a cache; a text of the BOS alone is nan on both), the
    checkpoint loaded as the JAX ``main`` means to load it; ``main`` prints
    the JSON line the JAX ``main`` would (its count, its corpus ppl rounded
    to 3 places, within 1e-2). The JAX ``main`` itself stops at its overlay
    of the boxed init tree (``AttributeError``); the port's runs."""
    import math

    from slam_llm_tpu.utils import ppl as jppl
    from slam_llm_tpu_torch.utils import ppl as tppl

    d, log = tiny_llm
    model, tok = tppl.load_llm(str(d), "tiny-test", device="cpu")
    per_text, total = tppl.ppl_of_texts(model, tok, TEXTS)
    want_per_text, want_total = _jax_ppl(d)
    assert math.isnan(per_text[2]) and math.isnan(want_per_text[2])
    for a, b in zip(per_text, want_per_text):
        assert (math.isnan(a) and math.isnan(b)) or abs(a - b) <= 1e-2 * b
    assert abs(total - want_total) <= 1e-2 * want_total
    got_total = tppl.main([str(log), "--llm", str(d), "--llm-name", "tiny-test", "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # the empty text's line loses its tab to strip(), as the JAX reader's does
    assert got_total == total and got == {"corpus_ppl": round(total, 3), "n": len(TEXTS) - 1}
    with pytest.raises(AttributeError, match="LogicallyPartitioned"):
        jppl.main([str(log), "--llm", str(d), "--llm-name", "tiny-test"])


def _jax_ppl(d):
    """The JAX package's ``ppl_of_texts`` over ``TEXTS`` on the checkpoint
    overlaid on its unboxed init, as its ``main`` means to."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    from slam_llm_tpu.data.tokenizer import load_tokenizer
    from slam_llm_tpu.models.llm import CausalLM, LLMConfig
    from slam_llm_tpu.utils.hf_loader import _overlay, convert_llama, load_hf_state_dict
    from slam_llm_tpu.utils.ppl import ppl_of_texts

    cfg = LLMConfig.tiny_test()
    model = CausalLM(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32),
                        method="init_all")
    host = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(params["params"]))
    _overlay(host, convert_llama(load_hf_state_dict(str(d)), cfg))
    return ppl_of_texts(model, {"params": jax.tree_util.tree_map(jnp.asarray, host)}, load_tokenizer(str(d)), TEXTS)


def test_ppl_cli_defaults_to_the_card(tiny_llm):
    """Without ``--device`` the CLI asks for the card, which this host lacks."""
    import torch

    from slam_llm_tpu_torch.utils import ppl as tppl

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    d, log = tiny_llm
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tppl.main([str(log), "--llm", str(d), "--llm-name", "tiny-test"])


# ---- the text CLIs -----------------------------------------------------------------------

DIALOGS = [
    [{"role": "system", "content": "Be brief."}, {"role": "user", "content": " Hi there "},
     {"role": "assistant", "content": "Hello. "}, {"role": "user", "content": "Bye"}],
    [{"role": "user", "content": "Only a question?"}],
    [{"role": "system", "content": "Alone"}],
    [],
]


def test_chat_templates_match_jax(tmp_path):
    from slam_llm_tpu.utils import chat_utils as jchat
    from slam_llm_tpu_torch.utils import chat_utils as tchat

    path = tmp_path / "dialogs.json"
    path.write_text(json.dumps(DIALOGS))
    assert tchat.read_dialogs_from_file(str(path)) == jchat.read_dialogs_from_file(str(path)) == DIALOGS
    for dialog in DIALOGS:
        assert tchat.format_llama2_chat(dialog) == jchat.format_llama2_chat(dialog)
        assert tchat.format_vicuna_chat(dialog) == jchat.format_vicuna_chat(dialog)


def test_safety_checkers_match_jax():
    """The keyword screen's verdicts and reports, custom patterns too, and
    the AuditNLG checker's lazy import (skipped as in the JAX package when
    ``auditnlg`` is absent)."""
    from slam_llm_tpu.utils import safety_utils as jsafe
    from slam_llm_tpu_torch.utils import safety_utils as tsafe

    texts = ["a normal answer", "How to make a bomb quickly", "HOW TO BUILD AN EXPLOSIVE", "child sexual content",
             "the bombastic style"]
    for text in texts:
        assert tsafe.is_safe(text) == jsafe.is_safe(text)
        assert tsafe.KeywordSafetyChecker([r"\bfox\b"])(text + " fox") == jsafe.KeywordSafetyChecker([r"\bfox\b"])(
            text + " fox")
    assert [type(c).__name__ for c in tsafe.get_safety_checkers(enable_audit=True)] == [
        type(c).__name__ for c in jsafe.get_safety_checkers(enable_audit=True)]
    try:
        import auditnlg  # noqa: F401
    except ImportError:
        assert tsafe.AuditNLGSafetyChecker()("text") == jsafe.AuditNLGSafetyChecker()("text") == (
            "AuditNLGSafetyChecker", True, "auditnlg not installed (skipped)")


def test_preprocess_text_matches_jax(tmp_path):
    """``number_to_words`` over 0-1,000,000 sampled and the scale edges,
    ``digits_to_words``, the Kaldi normalization and ``preprocess_file``
    (with and without ``--num2word``) equal the JAX module's."""
    from slam_llm_tpu.utils import preprocess_text as jpre
    from slam_llm_tpu_torch.utils import preprocess_text as tpre

    numbers = [*range(0, 1200), 9999, 10 ** 6, 10 ** 6 + 1, 10 ** 9 + 7, 123456789012, -42,
               *np.random.default_rng(0).integers(0, 10 ** 7, 500).tolist()]
    for n in numbers:
        assert tpre.number_to_words(n) == jpre.number_to_words(n), n
    line = "The <|en|> 42nd item cost 3 dollars — isn't 4.5 right? 1000"
    assert tpre.digits_to_words(line) == jpre.digits_to_words(line)
    assert tpre.kaldi_uppercase_normalize(line) == jpre.kaldi_uppercase_normalize(line)
    src = tmp_path / "in.tsv"
    src.write_text("u1\tHello, world 7!\nu2\nu3\t<|zh|> I'm 21.\n", encoding="utf-8")
    for num2word in (False, True):
        tpre.preprocess_file(str(src), str(tmp_path / "t.txt"), num2word=num2word)
        jpre.preprocess_file(str(src), str(tmp_path / "j.txt"), num2word=num2word)
        assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
