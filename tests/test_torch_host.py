"""The port's own host modules against the JAX package's, on the same inputs.

``slam_llm_tpu_torch`` carries copies of the host code its two entry points
reach (config, registry, the speech dataset and its loader, the tokenizer,
the audio frontend, SpecAugment, logging, and for the audio-captioning
recipes the Kaldi fbank, the caption metrics and SPICE). Each is held here
against its counterpart in ``slam_llm_tpu``: equal configs from every recipe
YAML with ``++`` overrides, bit-equal log-mel and fbank, identical collated
batches and sampler orders, identical token ids, equal caption metrics and
the same CLI JSON. CPU only, tiny inputs.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import wave
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tests"))
from helpers import make_corpus  # noqa: E402

from slam_llm_tpu import config as jconfig  # noqa: E402
from slam_llm_tpu import registry as jregistry  # noqa: E402
from slam_llm_tpu.data import loader as jloader  # noqa: E402
from slam_llm_tpu.data import speech_dataset as jspeech  # noqa: E402
from slam_llm_tpu.data import tokenizer as jtok  # noqa: E402
from slam_llm_tpu.ops import audio as jaudio  # noqa: E402
from slam_llm_tpu.ops import fbank as jfbank  # noqa: E402
from slam_llm_tpu.ops import specaug as jspecaug  # noqa: E402
from slam_llm_tpu.utils import caption_metrics as jcaption  # noqa: E402
from slam_llm_tpu.utils import logging_utils as jlog  # noqa: E402
from slam_llm_tpu.utils import spice as jspice  # noqa: E402
from slam_llm_tpu_torch import config as tconfig  # noqa: E402
from slam_llm_tpu_torch import registry as tregistry  # noqa: E402
from slam_llm_tpu_torch.data import loader as tloader  # noqa: E402
from slam_llm_tpu_torch.data import speech_dataset as tspeech  # noqa: E402
from slam_llm_tpu_torch.data import tokenizer as ttok  # noqa: E402
from slam_llm_tpu_torch.ops import audio as taudio  # noqa: E402
from slam_llm_tpu_torch.ops import fbank as tfbank  # noqa: E402
from slam_llm_tpu_torch.ops import specaug as tspecaug  # noqa: E402
from slam_llm_tpu_torch.utils import caption_metrics as tcaption  # noqa: E402
from slam_llm_tpu_torch.utils import logging_utils as tlog  # noqa: E402
from slam_llm_tpu_torch.utils import spice as tspice  # noqa: E402

RECIPES = sorted((REPO / "examples").rglob("conf/*.yaml"))
OVERRIDES = [
    "++train_config.lr=3e-4", "++train_config.shard.base_quant_bwd=int8_sr",
    "++train_config.peft_config.target_modules=[q_proj,k_proj,v_proj]", "++dataset_config.val_data_path=/x.jsonl",
    "++decode_config.num_beams=2", "++train_config.use_peft=true", "++log_config.log_file=null",
]


@pytest.mark.parametrize("recipe", RECIPES, ids=lambda p: p.stem)
def test_config_loaders_agree_on_every_recipe(recipe):
    argv = ["--config", str(recipe), *OVERRIDES]
    assert dataclasses.asdict(tconfig.load_run_config(argv)) == dataclasses.asdict(jconfig.load_run_config(argv))


def test_config_set_by_path_and_unknown_keys_agree():
    got, want = tconfig.RunConfig(), jconfig.RunConfig()
    for cfg, mod in ((got, tconfig), (want, jconfig)):
        mod.set_by_path(cfg, "train_config.shard.remat", "false")
        mod.set_by_path(cfg, "dataset_config.text_buckets", "[32, 64]")
        with pytest.raises(KeyError):
            mod.set_by_path(cfg, "train_config.no_such_key", "1")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tconfig.parse_overrides(["++a.b=1", "c=2", "--x"]) == jconfig.parse_overrides(["++a.b=1", "c=2", "--x"])


def _wav(path: Path, width: int, channels: int, sr: int, seconds: float = 1.3, seed: int = 0) -> Path:
    rng = np.random.default_rng(seed)
    x = 0.4 * np.sin(2 * np.pi * 311 * np.arange(int(seconds * sr)) / sr) + 0.05 * rng.standard_normal(int(seconds * sr))
    x = np.repeat(x[:, None], channels, axis=1)
    if width == 1:
        raw = ((x * 127) + 128).astype(np.uint8).tobytes()
    elif width == 2:
        raw = (x * 32767).astype("<i2").tobytes()
    elif width == 3:
        v = (x * 8388607).astype("<i4")
        raw = np.stack([(v >> s) & 0xFF for s in (0, 8, 16)], axis=-1).astype(np.uint8).tobytes()
    else:
        raw = (x * 2147483647).astype("<i4").tobytes()
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(raw)
    return path


@pytest.mark.parametrize("width,channels,sr,n_mels", [(2, 1, 16000, 80), (1, 2, 16000, 80), (3, 1, 16000, 128),
                                                      (4, 1, 16000, 80), (2, 1, 8000, 80)])
def test_log_mel_is_bit_equal(tmp_path, width, channels, sr, n_mels):
    path = _wav(tmp_path / "a.wav", width, channels, sr)
    xt, xj = taudio.load_audio(str(path)), jaudio.load_audio(str(path))
    assert np.array_equal(xt, xj) and xt.dtype == np.float32
    for length in (taudio.N_SAMPLES, 3 * 16000):
        mt = taudio.log_mel_spectrogram(taudio.pad_or_trim(xt, length), n_mels=n_mels)
        mj = jaudio.log_mel_spectrogram(jaudio.pad_or_trim(xj, length), n_mels=n_mels)
        assert mt.shape == mj.shape and np.array_equal(mt, mj)
    assert np.array_equal(taudio.mel_filterbank(n_mels), jaudio.mel_filterbank(n_mels))


def test_specaug_matches_for_the_same_generator():
    mel = np.random.default_rng(3).standard_normal((300, 80)).astype(np.float32)
    got = tspecaug.spec_augment(mel, rng=np.random.default_rng(9))
    want = jspecaug.spec_augment(mel, rng=np.random.default_rng(9))
    assert np.array_equal(got, want) and not np.array_equal(got, mel)


def test_tokenizer_ids_and_text_agree():
    t, j = ttok.load_tokenizer(None), jtok.load_tokenizer("byte")
    for text in ("USER: hello\n ASSISTANT:", "naïve café 你好", ""):
        for bos in (True, False):
            assert t.encode(text, add_bos=bos) == j.encode(text, add_bos=bos)
        ids = t.encode(text) + [t.eos_token_id, t.pad_token_id]
        assert t.decode(ids) == j.decode(ids) == text
    assert (t.bos_token_id, t.eos_token_id, t.pad_token_id, t.vocab_size) == \
        (j.bos_token_id, j.eos_token_id, j.pad_token_id, j.vocab_size)


def _dataset_config(mod, manifest, **kw):
    cfg = mod.RunConfig().dataset_config
    cfg.train_data_path = cfg.val_data_path = str(manifest)
    cfg.mel_size = 8
    cfg.max_audio_length_s = 1.0
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _assert_batches_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("kw,split", [({}, "train"), ({"inference_mode": True}, "validation"),
                                      ({"specaug": True}, "train"), ({"input_type": "raw"}, "train"),
                                      ({"fix_length_audio": 7, "prompt": "Say it."}, "train")])
def test_speech_dataset_and_collator_give_identical_batches(tmp_path, kw, split):
    manifest = make_corpus(tmp_path, n=5)
    tok = ttok.ByteTokenizer()
    got = tspeech.get_speech_dataset(_dataset_config(tconfig, manifest, **kw), tok, split)
    want = jspeech.get_speech_dataset(_dataset_config(jconfig, manifest, **kw), jtok.ByteTokenizer(), split)
    assert len(got) == len(want) == 5
    assert [got.sort_key(i) for i in range(5)] == [want.sort_key(i) for i in range(5)]
    for rows in ([0], [1, 2], [4, 0, 3]):
        _assert_batches_equal(got.collator([got[i] for i in rows]), want.collator([want[i] for i in rows]))
    assert tspeech.PROMPT_TEMPLATE == jspeech.PROMPT_TEMPLATE and tspeech.DEFAULT_PROMPT == jspeech.DEFAULT_PROMPT


@pytest.mark.parametrize("seed", [0, 7])
def test_samplers_give_the_same_batch_order(seed):
    lengths = np.random.default_rng(seed).integers(1, 50, 37).tolist()
    for drop_last in (True, False):
        for shuffle in (True, False):
            kw = dict(drop_last=drop_last, shuffle=shuffle, seed=seed)
            got, want = tloader.LengthBasedBatchSampler(lengths, 4, **kw), jloader.LengthBasedBatchSampler(lengths, 4, **kw)
            for epoch in (0, 1):
                got.set_epoch(epoch)
                want.set_epoch(epoch)
                assert list(got) == list(want) and len(got) == len(want)
    for tail in ("drop", "wrap"):
        for rank in range(3):
            got = tloader.DistributedLengthBasedBatchSampler(lengths, 4, 3, rank, ragged_tail=tail, seed=seed)
            want = jloader.DistributedLengthBasedBatchSampler(lengths, 4, 3, rank, ragged_tail=tail, seed=seed)
            assert list(got) == list(want) and len(got) == len(want)


@pytest.mark.parametrize("worker_type", ["thread", "process"])
def test_build_dataloader_yields_identical_batches(tmp_path, worker_type):
    """The port's loader with ``worker_type`` against the JAX loader's thread
    route (which ``tests/test_loader.py`` holds equal to its process route,
    so this case makes no ``psm_*`` segment beside that test's leak check);
    the process route leaves none of the port's ``SHM_PREFIX`` segments."""
    manifest = make_corpus(tmp_path, n=6)
    kw = dict(batch_size=2, shuffle=True, seed=3, num_workers=2)
    before = set(Path("/dev/shm").glob(tloader.SHM_PREFIX + "*"))
    got = list(tloader.build_dataloader(
        tspeech.get_speech_dataset(_dataset_config(tconfig, manifest), ttok.ByteTokenizer(), "train"),
        worker_type=worker_type, **kw))
    want = list(jloader.build_dataloader(
        jspeech.get_speech_dataset(_dataset_config(jconfig, manifest), jtok.ByteTokenizer(), "train"),
        worker_type="thread", **kw))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        _assert_batches_equal(a, b)
    assert set(Path("/dev/shm").glob(tloader.SHM_PREFIX + "*")) - before == set()


def test_registry_resolves_like_the_reference_and_names_the_unported(tmp_path):
    recipe = tmp_path / "my_data.py"
    recipe.write_text("def get_speech_dataset(cfg, tok, split):\n    return ('custom', split)\n")
    cfg = tconfig.RunConfig().dataset_config
    cfg.file = f"{recipe}:get_speech_dataset"
    assert tregistry.get_custom_dataset_factory(cfg)(None, None, "train") == ("custom", "train")
    assert jregistry.resolve_factory(f"{recipe}:get_speech_dataset")(None, None, "x") == ("custom", "x")
    cfg.file = None
    assert tregistry.get_custom_dataset_factory(cfg) is tspeech.get_speech_dataset
    # every in-tree dataset of the JAX package is the port's module of the same path
    for name, (module, factory) in tregistry.DATASETS.items():
        cfg.dataset = name
        jfactory = jregistry.get_custom_dataset_factory(cfg)
        assert module == tregistry.port_module_name(jfactory.__module__) and factory == jfactory.__name__, name
        assert tregistry.get_custom_dataset_factory(cfg).__module__ == module
    cfg.dataset, cfg.file = None, "slam_llm_tpu.data.no_such_dataset:get_it"  # a JAX path the port has no module for
    with pytest.raises(NotImplementedError, match="not ported"):
        tregistry.get_custom_dataset_factory(cfg)
    assert tregistry.resolve_factory("slam_llm_tpu_torch.data.tokenizer:load_tokenizer") is ttok.load_tokenizer


def test_logging_surface_matches(tmp_path):
    """Both loggers write the same line format; MemoryTrace reports the JAX
    package's keys (the device ones only where there is a card)."""
    lines = []
    for mod, name in ((tlog, "slam_llm_tpu_torch.test_host"), (jlog, "slam_llm_tpu.test_host")):
        log_file = tmp_path / f"{mod.__name__}.log"
        mod.setup_logger(name, log_file=str(log_file)).info("step %d loss=%.5g", 3, 1.5)
        lines.append(log_file.read_text().split(" - ", 1)[1])
    assert lines[0] == lines[1] == "step 3 loss=1.5\n"
    with tlog.MemoryTrace() as trace:
        stats = trace.stats()
    assert {"host_rss_peak_gb", "elapsed_s"} <= set(stats) <= {
        "host_rss_peak_gb", "elapsed_s", "hbm_in_use_gb", "hbm_peak_gb", "hbm_limit_gb"}
    tlog.MetricsLogger(tconfig.LogConfig()).log({"loss": 1.5}, step=3)


def _waveform(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * 523 * t) + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("seconds", [0.02, 1.3, 4.7])
def test_fbank_is_bit_equal(seconds):
    """The Kaldi fbank and both encoders' preprocessing, bit-equal on seeded
    waveforms: ``fbank`` at 128 and 80 bins, ``eat_preprocess`` padded to a
    multiple of 16, padded or trimmed to a fixed length, and randomly
    cropped with the same generator, ``beats_preprocess``; the banks and the
    window too."""
    x = _waveform(seconds, seed=int(seconds * 10))
    for bins in (128, 80):
        got, want = tfbank.fbank(x, num_mel_bins=bins), jfbank.fbank(x, num_mel_bins=bins)
        assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    for kw in ({}, {"fixed_length": True, "target_length": 96}, {"fixed_length": True, "target_length": 64},
               {"fixed_length": True, "target_length": 64, "random_crop": True}):
        got = tfbank.eat_preprocess(x, **kw, rng=np.random.default_rng(5))
        want = jfbank.eat_preprocess(x, **kw, rng=np.random.default_rng(5))
        assert got.shape == want.shape and np.array_equal(got, want), kw
    assert np.array_equal(tfbank.beats_preprocess(x), jfbank.beats_preprocess(x))
    assert np.array_equal(tfbank.kaldi_mel_banks(128), jfbank.kaldi_mel_banks(128))
    assert np.array_equal(tfbank._hann_symmetric(400), jfbank._hann_symmetric(400))


def test_eat_random_crop_draws_from_the_generator():
    """A clip longer than the fixed length is cropped at a generator-drawn
    start (the same start in both), and trimmed from 0 without ``random_crop``."""
    x = _waveform(1.3, seed=2)  # 128 frames
    crops = {tfbank.eat_preprocess(x, target_length=64, fixed_length=True, random_crop=True,
                                   rng=np.random.default_rng(seed))[0, 0] for seed in range(6)}
    assert len(crops) > 1
    full = tfbank.eat_preprocess(x, target_length=128, fixed_length=True)
    assert np.array_equal(tfbank.eat_preprocess(x, target_length=64, fixed_length=True), full[:64])


CANDIDATES = ["a dog barks in the yard while a car passes", "rain falls on a metal roof",
              "a man talks while music plays", "birds are chirping", "quantum entanglement", ""]
REFERENCES = [
    ["a dog barks loudly in the yard", "a dog is barking as a vehicle drives by", "dogs bark outside"],
    ["rain falls on the roof", "heavy rain hits a tin roof"],
    ["a man speaks while music plays", "a person talks over background music", "music and a male voice"],
    ["several birds chirp in the trees", "birds sing"],
    ["an engine idles", "a motor runs"],
    ["water flows from a tap"],
]


def test_caption_metrics_and_spice_agree():
    """Every metric of ``compute_caption_metrics``, each scorer alone, FENSE
    with the same callables, and SPICE's tokenizer, tagger, lemmas and scene
    graphs, on multi-reference captions."""
    assert tcaption.compute_caption_metrics(CANDIDATES, REFERENCES) == jcaption.compute_caption_metrics(
        CANDIDATES, REFERENCES)
    for name in ("bleu", "rouge_l", "cider_d", "meteor_lite"):
        assert getattr(tcaption, name)(CANDIDATES, REFERENCES) == getattr(jcaption, name)(CANDIDATES, REFERENCES)
    assert tspice.spice(CANDIDATES, REFERENCES) == jspice.spice(CANDIDATES, REFERENCES)

    def embed(texts):
        return np.stack([np.bincount([ord(c) % 16 for c in t] or [0], minlength=16) / (len(t) + 1.0) for t in texts])

    def disfluent(texts):
        return [len(t.split()) < 3 for t in texts]

    got = tcaption.compute_caption_metrics(CANDIDATES, REFERENCES, fense_embed_fn=embed, fense_fluency_fn=disfluent)
    assert got == jcaption.compute_caption_metrics(CANDIDATES, REFERENCES, fense_embed_fn=embed,
                                                  fense_fluency_fn=disfluent) and "fense" in got
    for caption in CANDIDATES + [r for refs in REFERENCES for r in refs]:
        tokens = tspice.tokenize(caption)
        assert tokens == jspice.tokenize(caption) and tspice.pos_tag(tokens) == jspice.pos_tag(tokens)
        assert [tspice.lemma(w) for w in tokens] == [jspice.lemma(w) for w in tokens]
        assert tspice.scene_graph(caption) == jspice.scene_graph(caption)


def test_caption_metrics_cli_prints_the_same_json(tmp_path):
    """``python -m slam_llm_tpu_torch.utils.caption_metrics <gt> <pred>``
    prints the JAX module's JSON, every reference of a key kept."""
    import subprocess

    gt, pred = tmp_path / "decode_gt", tmp_path / "decode_pred"
    gt.write_text("".join(f"clip{i}\t{r}\n" for i, refs in enumerate(REFERENCES) for r in refs))
    pred.write_text("".join(f"clip{i}\t{c}\n" for i, c in enumerate(CANDIDATES)))
    assert tcaption._read_log(str(gt)) == jcaption._read_log(str(gt)) == {
        f"clip{i}": refs for i, refs in enumerate(REFERENCES)}
    out = subprocess.run([sys.executable, "-m", "slam_llm_tpu_torch.utils.caption_metrics", str(gt), str(pred)],
                         cwd=REPO, capture_output=True, text=True, timeout=120, check=True).stdout
    want = jcaption.compute_caption_metrics(CANDIDATES, REFERENCES)
    assert json.loads(out.strip().splitlines()[-1]) == want and out.strip().splitlines()[-1] == json.dumps(want)
