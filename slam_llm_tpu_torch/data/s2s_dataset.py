"""S2S (SLAM-Omni) multi-stream jsonl dataset.

Counterpart of ``slam_llm_tpu/data/s2s_dataset.py``. Each item carries
``source_wav`` (the question's speech), ``source_text``, ``target_text`` and
``target_token`` (codec tokens: one flat list for grouped CosyVoice, or
code_layer lists for SNAC). Streams (code_layer audio + 1 text):

  prompt  : text=[input_t, tok(prompt), eot]       audio_i=[pad_a]*len
  input   : text=[input_t, pad_t*A, eot, answer_t] audio_i=[input_a, pad_a*A, eoa, answer_a]
  answer  : text=[tok(answer), eot, pad_t...]      audio_i=[target_tokens_i, pad_a...]

with labels on the answer region only; every audio-stream id is
layershifted into the extended vocabulary. The question's speech is
whisper's 30 s log-mel (``pad_or_trim``), so A = (3000 + 1) // 2 // 5 = 300
placeholders, unless ``fix_length_audio``; ``audio_seconds`` is what the
model hears of the question (its length, cut at ``max_audio_length_s``).
The collator left-pads every row to one header length and buckets the
total (``text_buckets``). ``question_mel`` and ``header_streams`` build the
question and the prompt / input regions for the online drivers too
(``pipeline.generate_s2s.build_round_batch``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from slam_llm_tpu_torch.data.speech_dataset import bucketize, normalize_split, read_jsonl
from slam_llm_tpu_torch.models.s2s import VocabConfig
from slam_llm_tpu_torch.ops import audio as audio_ops

IGNORE_INDEX = -100
# the reference's speech_dataset_s2s.py:28 (its inference drivers frame the
# prompt the same way)
PROMPT_TEMPLATE = "<SYSTEM>: {}\n "
DEFAULT_S2S_PROMPT = "Conduct a spoken conversation with the user. "


def group_answer_tokens(flat_tokens: List[int], code_layer: int, num_latency: int, pad_a: int,
                        eoa: int) -> np.ndarray:
    """A grouped (CosyVoice) codec stream -> (code_layer, T) with latency
    pads and EOA (the reference's codec_utils get_group_answer_token)."""
    arr = np.asarray(flat_tokens, np.int64)
    n = (len(arr) // code_layer) * code_layer
    grouped = arr[:n].reshape(-1, code_layer).T  # (L, T)
    t = grouped.shape[1]
    out = np.full((code_layer, num_latency + t + 1), pad_a, np.int64)
    out[:, num_latency: num_latency + t] = grouped
    out[:, num_latency + t] = eoa
    return out


def snac_answer_tokens(layer_tokens: List[List[int]], pad_a: int, eoa: int) -> np.ndarray:
    """Per-layer SNAC token lists -> (code_layer, T), right-padded, with EOA."""
    t = max(len(x) for x in layer_tokens)
    out = np.full((len(layer_tokens), t + 1), pad_a, np.int64)
    for i, toks in enumerate(layer_tokens):
        out[i, : len(toks)] = toks
        out[i, len(toks)] = eoa
    return out


def question_mel(wav_path: str, max_audio_samples: int, mel_size: int = 80,
                 fix_length_audio: int = -1) -> Tuple[np.ndarray, int, float]:
    """A spoken question -> (whisper's log-mel of the clip padded or cut to
    ``max_audio_samples``, its placeholder count A, the seconds of speech
    the model hears)."""
    raw = audio_ops.load_audio(wav_path)
    mel = audio_ops.log_mel_spectrogram(audio_ops.pad_or_trim(raw, max_audio_samples), n_mels=mel_size)
    audio_length = fix_length_audio if fix_length_audio > 0 else (mel.shape[0] + 1) // 2 // 5
    return mel, audio_length, min(len(raw), max_audio_samples) / audio_ops.SAMPLE_RATE


def header_streams(tokenizer, vocab: VocabConfig, prompt: str, audio_length: int = 0,
                   text_ids: Optional[Sequence[int]] = None) -> Tuple[List[List[int]], int]:
    """The prompt and input regions of the L + 1 streams (module docstring)
    and the prompt's length: A = ``audio_length`` placeholders for a spoken
    question, or a written question's ``text_ids`` in the text stream."""
    v, L = vocab, vocab.code_layer

    def pads(n, i):
        return [int(v.layershift(np.int64(v.pad_a), i))] * n

    prompt_ids = [v.input_t] + list(tokenizer.encode(prompt, add_bos=False)) + [v.eot]
    p_len = len(prompt_ids)
    a_len = audio_length if text_ids is None else len(text_ids)
    streams = [pads(p_len, i) + [int(v.layershift(np.int64(v.input_a), i))] + pads(a_len, i)
               + [int(v.layershift(np.int64(v.eoa), i)), int(v.layershift(np.int64(v.answer_a), i))]
               for i in range(L)]
    question = [v.pad_t] * a_len if text_ids is None else [int(t) for t in text_ids]
    streams.append(prompt_ids + [v.input_t] + question + [v.eot, v.answer_t])
    return streams, p_len


class S2SDatasetJsonl:
    def __init__(self, dataset_config, tokenizer=None, split: str = "train"):
        split = normalize_split(dataset_config, split)
        self.config, self.tokenizer, self.split = dataset_config, tokenizer, split
        vc = getattr(dataset_config, "vocab_config", None)
        if isinstance(vc, VocabConfig):
            self.vocab = vc
        else:
            text_v = getattr(dataset_config, "text_vocabsize", -1)
            if text_v is None or text_v < 0:
                text_v = getattr(tokenizer, "vocab_size", VocabConfig.text_vocabsize)
            self.vocab = VocabConfig(text_vocabsize=int(text_v), code_layer=getattr(dataset_config, "code_layer", 7),
                                     audio_vocabsize=getattr(dataset_config, "audio_vocabsize", 4096))
        self.code_layer = self.vocab.code_layer
        self.task_type = getattr(dataset_config, "task_type", "s2s")
        self.prompt = getattr(dataset_config, "prompt", None) or DEFAULT_S2S_PROMPT
        self.mel_size = getattr(dataset_config, "mel_size", 80)
        self.fix_length_audio = getattr(dataset_config, "fix_length_audio", -1)
        self.inference_mode = getattr(dataset_config, "inference_mode", False)
        self.num_latency_tokens = getattr(dataset_config, "num_latency_tokens", 0)
        self.max_audio_samples = int(getattr(dataset_config, "max_audio_length_s", 30.0) * audio_ops.SAMPLE_RATE)
        path = dataset_config.train_data_path if split == "train" else dataset_config.val_data_path
        self.data_list = read_jsonl(path)

    def __len__(self):
        return len(self.data_list)

    def _shift(self, tok, layer):
        return self.vocab.layershift(np.asarray(tok, np.int64), layer)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        v, L = self.vocab, self.code_layer
        item = self.data_list[index]
        source_wav, target_token = item.get("source_wav"), item.get("target_token")
        source_text, target_text = item.get("source_text"), item.get("target_text")
        key = item.get("key", str(index))

        audio_mel, audio_length, audio_seconds = None, 0, 0.0
        if self.task_type in ("s2s", "asr") and source_wav is not None:
            audio_mel, audio_length, audio_seconds = question_mel(source_wav, self.max_audio_samples, self.mel_size,
                                                                  self.fix_length_audio)
        target_audio, target_audio_length = None, 0
        if target_token is not None and self.task_type == "s2s":
            if isinstance(target_token[0], list):
                target_audio = snac_answer_tokens(target_token, v.pad_a, v.eoa)
            else:
                target_audio = group_answer_tokens(target_token, L, self.num_latency_tokens, v.pad_a, v.eoa)
            target_audio_length = target_audio.shape[1]

        # the prompt region, with a multi-round history folded into it
        prompt = PROMPT_TEMPLATE.format(self.prompt)
        if source_text and "<USER>:" in source_text and self.task_type == "s2s":
            history = source_text.rsplit("<USER>:", 1)[0].strip()
            if history:
                prompt = prompt + history + "\n "
        # with the input region: [marker, placeholders * A, eos, answer marker]
        streams, p_len = header_streams(self.tokenizer, v, prompt, audio_length)
        header = p_len + audio_length + 3
        meta = {"audio_mel": audio_mel, "audio_length": audio_length, "prompt_length": p_len,
                "header_length": header, "modality_start": p_len + 1, "key": key, "source_text": source_text,
                "audio_seconds": audio_seconds}
        if self.task_type == "asr":
            target_text = (source_text or "").split("<USER>:")[-1].strip()
        if self.inference_mode:
            input_ids = np.stack([np.asarray(s, np.int64) for s in streams])
            return {"input_ids": input_ids, "attention_mask": np.ones(input_ids.shape[1], np.int32), **meta,
                    "target_text": target_text}

        # the answer region
        answer_text_ids = list(self.tokenizer.encode(str(target_text), add_bos=False)) + [v.eot]
        answer_len = max(len(answer_text_ids), target_audio_length)
        labels = [None] * (L + 1)
        for i in range(L):
            audio_lab = np.full(answer_len, IGNORE_INDEX, np.int64)
            audio_in = np.full(answer_len, int(self._shift(v.pad_a, i)), np.int64)
            if target_audio is not None:
                audio_lab[:target_audio_length] = target_audio[i]
                audio_in[:target_audio_length] = self._shift(target_audio[i], i)
            streams[i] += list(audio_in)
            labels[i] = audio_lab
        text_lab = np.full(answer_len, IGNORE_INDEX, np.int64)
        text_lab[: len(answer_text_ids)] = answer_text_ids
        text_in = np.full(answer_len, v.pad_t, np.int64)
        text_in[: len(answer_text_ids)] = answer_text_ids
        streams[L] += list(text_in)
        labels[L] = text_lab

        input_ids = np.stack([np.asarray(s, np.int64) for s in streams])  # (L+1, T)
        t_total = input_ids.shape[1]
        labels_full = np.full((L + 1, t_total), IGNORE_INDEX, np.int64)
        labels_full[:, header:] = np.stack(labels)
        if self.task_type == "asr":
            labels_full[:L, :] = IGNORE_INDEX
        return {"input_ids": input_ids, "labels": labels_full, "attention_mask": np.ones(t_total, np.int32), **meta,
                "target_text": target_text}

    def sort_key(self, index: int) -> int:
        item = self.data_list[index]
        tok = item.get("target_token") or []
        # a SNAC manifest's length is its streams', not its number of layers
        tok_len = max(len(t) for t in tok) if tok and isinstance(tok[0], (list, tuple)) else len(tok)
        return len(str(item.get("target_text", ""))) + tok_len

    def collator(self, samples: List[Dict[str, Any]]) -> Dict[str, Any]:
        v, L = self.vocab, self.code_layer
        text_buckets = list(getattr(self.config, "text_buckets", [128, 256, 512, 1024]))
        headers = [s["header_length"] for s in samples]
        answers = [s["input_ids"].shape[1] - h for s, h in zip(samples, headers)]
        max_header = max(headers)
        total = bucketize(max_header + max(answers) if answers else max_header, text_buckets)
        b = len(samples)
        input_ids = np.zeros((b, L + 1, total), np.int64)
        for i in range(L):
            input_ids[:, i, :] = int(v.layershift(v.pad_a, i))
        input_ids[:, L, :] = v.pad_t
        attention_mask = np.zeros((b, total), np.int32)
        labels = np.full((b, L + 1, total), IGNORE_INDEX, np.int64)
        modality_mask = np.zeros((b, total), np.int32)
        for bi, s in enumerate(samples):
            left = max_header - headers[bi]
            n = s["input_ids"].shape[1]
            input_ids[bi, :, left: left + n] = s["input_ids"]
            attention_mask[bi, left: left + n] = 1
            if "labels" in s:
                labels[bi, :, left: left + n] = s["labels"]
            ms = left + s["modality_start"]
            modality_mask[bi, ms: ms + s["audio_length"]] = 1
        out = {"input_ids": input_ids, "attention_mask": attention_mask, "modality_mask": modality_mask}
        if not self.inference_mode:
            out["labels"] = labels
        mels = [s["audio_mel"] for s in samples if s["audio_mel"] is not None]
        if mels:
            mel_len = max(m.shape[0] for m in mels)
            audio_mel = np.zeros((b, mel_len, mels[0].shape[1]), np.float32)
            audio_mel_mask = np.zeros((b, mel_len), np.int32)
            for bi, s in enumerate(samples):
                if s["audio_mel"] is not None:
                    audio_mel[bi, : s["audio_mel"].shape[0]] = s["audio_mel"]
                    audio_mel_mask[bi, : s["audio_mel"].shape[0]] = 1
            out["audio_mel"], out["audio_mel_mask"] = audio_mel, audio_mel_mask
        if self.inference_mode:
            out["keys"] = [s["key"] for s in samples]
            out["targets"] = [s["target_text"] for s in samples]
        return out


def get_s2s_dataset(dataset_config, tokenizer, split: str) -> S2SDatasetJsonl:
    return S2SDatasetJsonl(dataset_config, tokenizer, split)
