"""Codec token utilities and the vocoder front door of S2S.

Counterpart of ``slam_llm_tpu/utils/codec_utils.py``:

* SNAC's "flat-8" manifests (8 tokens a frame: the '#' slot and 7 codebook
  tokens) -> the staggered (7, T) layout of parallel generation, and
  generated staggered streams -> SNAC's [1, 2, 4]-codebook tensors;
* ``cosyvoice_group_to_stream``: grouped streams (L, T) -> one token stream;
* ``CodecDecoder``: SNAC (``models/snac.py``) or CosyVoice (``models/
  cosyvoice_flow.py`` then ``models/hift.py``), both in f32 on the device
  the weights were loaded to; the published ``.pt`` state dicts are read
  with ``torch.load`` and converted once.

The JAX package draws the vocoders' noise from fixed keys (SNAC's
NoiseBlocks and the flow's CFM noise from ``PRNGKey(0)``, HiFT's source
from ``PRNGKey(1)``); the port draws it from ``torch.Generator``s seeded 0
and 1, or takes it as tensors (``decode(z=..., noises=...)``);
``decode(hift_noise=False)`` runs HiFT's deterministic source. Decoding runs
without autograd and with cuDNN's TF32 off (``ops.torch_port.f32_convolutions``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch


@dataclass(frozen=True)
class SnacConfig:
    audio_vocab_size: int = 4096
    end_of_audio: int = 4096
    padding_token: int = 4097
    code_layer: int = 7


def snac_answer_token_layout(flat_tokens: Sequence[int], cfg: SnacConfig = SnacConfig()):
    """A flat SNAC stream (8 tokens a frame, slot 0 the '#' marker) -> the
    staggered (7, T) layout of the parallel-generation targets (the
    reference's snac_utils.get_snac_answer_token): layer j delayed by j
    frames of padding, ended with EOA, tail-padded to one length."""
    toks = list(flat_tokens)
    n_frames = len(toks) // 8
    toks = toks[: n_frames * 8]  # a trailing partial frame is dropped
    layers = []
    for layer in range(1, 8):
        row = [cfg.padding_token] * layer + [int(toks[i]) for i in range(len(toks)) if i % 8 == layer]
        row.append(cfg.end_of_audio)
        if layer < 7:
            row += [cfg.padding_token] * (7 - layer)
        layers.append(row)
    return np.asarray(layers, np.int64), n_frames + 8


def _snac_regroup(rows: List[np.ndarray]):
    """Seven equal-length un-staggered rows -> SNAC's codebook tensors
    [(1, t), (1, 2t), (1, 4t)], frame by frame [c0 | c1 c4 | c2 c3 c5 c6]."""
    t = len(rows[0])
    cb1 = np.empty((1, 2 * t), np.int64)
    cb1[0, 0::2], cb1[0, 1::2] = rows[1], rows[4]
    cb2 = np.empty((1, 4 * t), np.int64)
    cb2[0, 0::4], cb2[0, 1::4], cb2[0, 2::4], cb2[0, 3::4] = rows[2], rows[3], rows[5], rows[6]
    return [rows[0][None, :], cb1, cb2]


def snac_frame_window(streams, f0: int, f1: int, cfg: SnacConfig = SnacConfig()):
    """Frames [f0, f1) un-staggered from the FULL staggered streams: layer
    j's token for frame f sits at f + j + 1. Streaming cuts its chunks this
    way so no chunk boundary drops the per-layer delays (the reference's
    get_snac indexes the full history too, snac_utils.py:38-46)."""
    rows = [np.asarray(streams[j][f0 + j + 1: f1 + j + 1], np.int64) % (cfg.audio_vocab_size + 64)
            for j in range(7)]
    return _snac_regroup(rows)


def snac_num_frames(streams, cfg: SnacConfig = SnacConfig()) -> int:
    """Complete frames in staggered streams (layer 6 needs position f + 7)."""
    return max(0, min(len(streams[j]) for j in range(7)) - 7)


def snac_streams_to_codebooks(streams: np.ndarray, cfg: SnacConfig = SnacConfig()):
    """Generated staggered streams (7, T) -> SNAC's codebook tensors."""
    return snac_frame_window(streams, 0, snac_num_frames(streams, cfg), cfg)


def cosyvoice_group_to_stream(streams: np.ndarray) -> np.ndarray:
    """Grouped parallel streams (L, T) -> the flat codec stream (T * L,)
    (the inverse of ``data.s2s_dataset.group_answer_tokens``)."""
    return np.asarray(streams).T.reshape(-1)


def _load_state(path: str, *keys: str) -> dict:
    """A ``.pt`` state dict (or a module holding one), unwrapped from the
    first of ``keys`` it holds; a missing or unreadable file raises."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    for key in keys:
        if isinstance(sd, dict) and key in sd and isinstance(sd[key], dict):
            return sd[key]
    return sd


@dataclass
class CodecDecoder:
    """The SNAC / CosyVoice vocoder."""

    codec_type: str = "snac"  # snac | cosyvoice
    sample_rate: int = 24000
    snac_params: Optional[dict] = None
    snac_cfg: Optional[object] = None
    flow_params: Optional[dict] = None
    flow_cfg: Optional[object] = None
    hift_params: Optional[dict] = None
    hift_cfg: Optional[object] = None
    spk_embedding: Optional[np.ndarray] = None

    @staticmethod
    def from_snac_checkpoint(path: str, device="cuda") -> "CodecDecoder":
        """A SNAC state dict (``.pt`` / ``.pth``), its weights on ``device``."""
        from slam_llm_tpu_torch.models.snac import SNACConfig, convert_snac_torch_state
        from slam_llm_tpu_torch.ops.torch_port import to_device

        cfg = SNACConfig.snac_24khz()
        return CodecDecoder(codec_type="snac", snac_params=to_device(convert_snac_torch_state(_load_state(path), cfg),
                                                                     device), snac_cfg=cfg,
                            sample_rate=cfg.sampling_rate)

    @staticmethod
    def from_cosyvoice_checkpoint(flow_path: str, hift_path: str, spk_embedding: Optional[np.ndarray] = None,
                                  device="cuda") -> "CodecDecoder":
        """CosyVoice's ``flow.pt`` + ``hift.pt`` (the reference's token2wav),
        their weights on ``device``. ``spk_embedding``: a (1, 192) x-vector,
        zeros by default (the reference takes a stock speaker)."""
        from slam_llm_tpu_torch.models.cosyvoice_flow import FlowConfig, convert_cosyvoice_flow_state
        from slam_llm_tpu_torch.models.hift import HiFTConfig, convert_hift_torch_state
        from slam_llm_tpu_torch.ops.torch_port import to_device

        fcfg, hcfg = FlowConfig(), HiFTConfig()
        return CodecDecoder(
            codec_type="cosyvoice",
            flow_params=to_device(convert_cosyvoice_flow_state(_load_state(flow_path, "model"), fcfg), device),
            flow_cfg=fcfg,
            hift_params=to_device(convert_hift_torch_state(_load_state(hift_path, "generator", "model"), hcfg),
                                  device),
            hift_cfg=hcfg, sample_rate=hcfg.sampling_rate, spk_embedding=spk_embedding,
        )

    def _device(self) -> torch.device:
        if self.codec_type == "snac":
            return self.snac_params["quantizer"][0]["codebook"].device
        return self.flow_params["input_embedding"].device

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self._device()).manual_seed(seed)

    def _decode_snac_codebooks(self, cbs, noises=None) -> np.ndarray:
        if self.snac_params is None:
            raise RuntimeError("no vocoder attached: use CodecDecoder.from_snac_checkpoint(path)")
        from slam_llm_tpu_torch.models.snac import snac_decode
        from slam_llm_tpu_torch.ops.torch_port import f32_convolutions

        cfg = self.snac_cfg
        cbs = [c % cfg.codebook_size for c in cbs]
        # the published decoder adds NoiseBlock noise on every call; a
        # seeded generator keeps it and stays reproducible
        with torch.no_grad(), f32_convolutions():
            gen = None if noises is not None else self._generator(0)
            return snac_decode(self.snac_params, cbs, cfg, noises, gen)[0].cpu().numpy()

    def num_frames(self, streams) -> int:
        """Complete (every layer present) frames of staggered SNAC streams."""
        return snac_num_frames(streams)

    def decode_window(self, streams, f0: int, f1: int) -> Optional[np.ndarray]:
        """SNAC streaming: frames [f0, f1) against the FULL staggered
        history, so chunk boundaries keep the per-layer delays."""
        if self.codec_type != "snac":
            raise RuntimeError("decode_window is SNAC-specific")
        if f1 <= f0:
            return None
        return self._decode_snac_codebooks(snac_frame_window(streams, f0, f1))

    def decode(self, streams: np.ndarray, z: Optional[torch.Tensor] = None,
               noises: Optional[List[torch.Tensor]] = None, hift_noise: bool = True) -> np.ndarray:
        """Staggered generated streams (L, T) -> waveform f32 (samples,).
        ``noises``: SNAC's NoiseBlock inputs; ``z``: the CFM's initial noise;
        ``hift_noise=False``: HiFT's deterministic source (zero phases, no
        noise)."""
        if self.codec_type == "snac":
            return self._decode_snac_codebooks(snac_streams_to_codebooks(streams), noises)
        tokens = cosyvoice_group_to_stream(streams)
        if self.flow_params is None:
            raise RuntimeError("CosyVoice decoding: use CodecDecoder.from_cosyvoice_checkpoint(flow_path, hift_path)")
        from slam_llm_tpu_torch.models.cosyvoice_flow import flow_token2mel
        from slam_llm_tpu_torch.models.hift import hift_decode
        from slam_llm_tpu_torch.ops.torch_port import f32_convolutions

        fcfg = self.flow_cfg
        tokens = np.asarray(tokens)
        # the reference's codec_utils.py:84-94: TRUNCATE at the first EOA
        # (vocab_size in local audio space), then replace the remaining pads
        # in place with 4095: deleting them would shift every later token
        # one slot and break the frame grouping
        eoa_pos = np.nonzero(tokens == fcfg.vocab_size)[0]
        if eoa_pos.size:
            tokens = tokens[: eoa_pos[0]]
        tokens = np.where(tokens >= fcfg.vocab_size, fcfg.vocab_size - 1, tokens)[None]
        spk = self.spk_embedding if self.spk_embedding is not None else np.zeros((1, fcfg.spk_embed_dim), np.float32)
        with torch.no_grad(), f32_convolutions():
            mel = flow_token2mel(self.flow_params, torch.from_numpy(tokens), torch.as_tensor(spk), fcfg,
                                 generator=None if z is not None else self._generator(0), z=z)
            gen = self._generator(1) if hift_noise else None
            wav = hift_decode(self.hift_params, mel, self.hift_cfg, generator=gen)
        return wav[0].cpu().numpy()
