"""CosyVoice's flow-matching token -> mel decoder (inference).

Counterpart of ``slam_llm_tpu/models/cosyvoice_flow.py``: plain functions
over the parameter dict that ``convert_cosyvoice_flow_state`` makes from
the reference's ``flow.pt``, its arrays moved to the device once
(``ops.torch_port.to_device``); ``models/hift.py`` is the second half of
token2wav.

  speech tokens -> embedding (4096 -> 512) -> ESPnet relative-position
  encoder (6 blocks, 8 heads) -> proj (512 -> 80) -> linear time
  interpolation to the mel rate + conv / GroupNorm / Mish stack = mu
  -> ConditionalCFM: 10 Euler steps over a cosine t-schedule with
  classifier-free guidance 0.7, the velocity from the Matcha U-Net
  estimator conditioned on (mu, speaker embedding, prompt-mel cond).

f32, no dropout, every position valid (batch-1 decode at exact lengths).
The estimator's attention is the JAX package's plain einsum (no Pallas
kernel), so it is plain PyTorch here too. ``cfm_solve`` takes its initial
noise ``z`` as a tensor, or draws it from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from slam_llm_tpu_torch.ops.torch_port import conv1d_nct as _conv1d
from slam_llm_tpu_torch.ops.torch_port import to_np as _np


@dataclass(frozen=True)
class FlowConfig:
    vocab_size: int = 4096
    input_size: int = 512  # token embedding / encoder width
    output_size: int = 80  # mel bins
    spk_embed_dim: int = 192
    input_frame_rate: int = 50
    # encoder (CosyVoice-300M flow conformer: no macaron, no conv module)
    enc_blocks: int = 6
    enc_heads: int = 8
    enc_ffn: int = 2048
    regulator_convs: int = 4
    # CFM estimator (Matcha U-Net)
    est_channels: tuple = (256, 256)
    est_heads: int = 8
    est_head_dim: int = 64
    est_n_blocks: int = 4
    est_mid_blocks: int = 12
    # CFM solver
    n_timesteps: int = 10
    inference_cfg_rate: float = 0.7
    mel_hop: int = 256
    mel_sr: int = 22050

    @property
    def est_in_channels(self) -> int:
        return 4 * self.output_size  # [x, mu, spks, cond]

    @staticmethod
    def tiny_test() -> "FlowConfig":
        return FlowConfig(
            vocab_size=64, input_size=16, output_size=8, spk_embed_dim=6, enc_blocks=2, enc_heads=2, enc_ffn=32,
            regulator_convs=2, est_channels=(16, 16), est_heads=2, est_head_dim=4, est_n_blocks=1,
            est_mid_blocks=2, n_timesteps=4,
        )


def _ln(x, scale, bias, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _groupnorm(x, scale, bias, groups, eps=1e-5):
    """(B, C, T) GroupNorm."""
    b, c, t = x.shape
    xg = x.reshape(b, groups, c // groups, t)
    mu = xg.mean(dim=(2, 3), keepdim=True)
    var = ((xg - mu) ** 2).mean(dim=(2, 3), keepdim=True)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return xg.reshape(b, c, t) * scale[None, :, None] + bias[None, :, None]


def _mish(x):
    return x * torch.tanh(F.softplus(x))


def _linear_interp(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """(B, C, T) -> (B, C, out_len): F.interpolate(mode='linear',
    align_corners=False), written out as the JAX package does."""
    t = x.shape[-1]
    if t == out_len:
        return x
    pos = (torch.arange(out_len, device=x.device, dtype=torch.float32) + 0.5) * t / out_len - 0.5
    lo = pos.floor().to(torch.int64).clamp(0, t - 1)
    hi = (lo + 1).clamp(0, t - 1)
    w_hi = (pos - lo).clamp(0.0, 1.0)
    return x[:, :, lo] * (1 - w_hi) + x[:, :, hi] * w_hi


# ---------------------------------------------------------------------------
# the ESPnet relative-position encoder
# ---------------------------------------------------------------------------


def _espnet_rel_pos(t: int, d: int) -> np.ndarray:
    """(2T - 1, D): relative positions T-1 .. 0 .. -(T-1), sin / cos interleaved."""
    position = np.arange(t, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * -(math.log(10000.0) / d))
    pe_pos, pe_neg = np.zeros((t, d)), np.zeros((t, d))
    pe_pos[:, 0::2], pe_pos[:, 1::2] = np.sin(position * div), np.cos(position * div)
    pe_neg[:, 0::2], pe_neg[:, 1::2] = np.sin(-position * div), np.cos(-position * div)
    return np.concatenate([pe_pos[::-1], pe_neg[1:]], axis=0).astype(np.float32)


def _rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, 2T - 1) -> (B, H, T, T) (the reference's attention.py:225-247)."""
    b, h, t, _ = x.shape
    xp = torch.cat([x.new_zeros(b, h, t, 1), x], dim=-1).reshape(b, h, 2 * t, t)
    return xp[:, :, 1:].reshape(b, h, t, 2 * t - 1)[:, :, :, :t]


def flow_encoder_apply(p: Dict, x: torch.Tensor, cfg: FlowConfig) -> torch.Tensor:
    """(B, T, input_size) token embeddings -> (B, T, input_size)."""
    d = cfg.input_size
    b, t = x.shape[:2]
    x = _ln(x @ p["embed_w"] + p["embed_b"], p["embed_ln_s"], p["embed_ln_b"]) * math.sqrt(d)  # ESPnet xscale
    pos = torch.from_numpy(_espnet_rel_pos(t, d)).to(x.device)
    hd = d // cfg.enc_heads
    for i in range(cfg.enc_blocks):
        L = p[f"l{i}"]
        h = _ln(x, L["norm_mha_s"], L["norm_mha_b"])
        q = (h @ L["q_w"] + L["q_b"]).reshape(b, t, cfg.enc_heads, hd)
        k = (h @ L["k_w"] + L["k_b"]).reshape(b, t, cfg.enc_heads, hd)
        v = (h @ L["v_w"] + L["v_b"]).reshape(b, t, cfg.enc_heads, hd)
        pp = (pos @ L["pos_w"]).reshape(2 * t - 1, cfg.enc_heads, hd)
        ac = torch.einsum("bqhd,bkhd->bhqk", q + L["bias_u"], k)
        bd = _rel_shift(torch.einsum("bqhd,phd->bhqp", q + L["bias_v"], pp))
        attn = torch.softmax((ac + bd) / math.sqrt(hd), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, t, d)
        x = x + (o @ L["out_w"] + L["out_b"])
        h = _ln(x, L["norm_ff_s"], L["norm_ff_b"])
        x = x + (F.silu(h @ L["ff1_w"] + L["ff1_b"]) @ L["ff2_w"] + L["ff2_b"])
    return _ln(x, p["after_norm_s"], p["after_norm_b"])


# ---------------------------------------------------------------------------
# the length regulator
# ---------------------------------------------------------------------------


def _regulator_stack(p: Dict, h: torch.Tensor, cfg: FlowConfig) -> torch.Tensor:
    """conv / GroupNorm / Mish stack + the 1x1 out conv on (B, C, L)."""
    for i in range(cfg.regulator_convs):
        h = _mish(_groupnorm(_conv1d(h, p[f"c{i}_w"], p[f"c{i}_b"], padding=1), p[f"n{i}_s"], p[f"n{i}_b"], 1))
    return _conv1d(h, p["out_w"], p["out_b"])


def length_regulator_apply(p: Dict, x: torch.Tensor, out_len: int, cfg: FlowConfig) -> torch.Tensor:
    """(B, T, mel) -> (B, out_len, mel): the reference InterpolateRegulator."""
    return _regulator_stack(p, _linear_interp(x.transpose(1, 2), out_len), cfg).transpose(1, 2)


def interp_generated(hseg: torch.Tensor, mel_len2: int, cfg: FlowConfig) -> torch.Tensor:
    """(1, Tg, C) -> (1, C, mel_len2). More than 40 tokens interpolate head,
    middle and tail apart (20 tokens -> 34 frames at each end), as
    InterpolateRegulator.inference does (the reference's length_regulator.py:52-63)."""
    ht = hseg.transpose(1, 2)
    if hseg.shape[1] > 40:
        edge = int(20 / cfg.input_frame_rate * cfg.mel_sr / cfg.mel_hop)
        return torch.cat([_linear_interp(ht[:, :, :20], edge), _linear_interp(ht[:, :, 20:-20], mel_len2 - 2 * edge),
                          _linear_interp(ht[:, :, -20:], edge)], dim=-1)
    return _linear_interp(ht, mel_len2)


# ---------------------------------------------------------------------------
# the Matcha U-Net estimator
# ---------------------------------------------------------------------------


def _time_emb(p: Dict, t: torch.Tensor, dim: int) -> torch.Tensor:
    """SinusoidalPosEmb(dim, scale 1000) + TimestepEmbedding (SiLU MLP)."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, device=t.device, dtype=torch.float32) * -(math.log(10000) / (half - 1)))
    ang = 1000.0 * t[:, None] * freqs[None, :]
    se = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return F.silu(se @ p["t1_w"] + p["t1_b"]) @ p["t2_w"] + p["t2_b"]


def _est_resnet(p: Dict, x, t_emb):
    h = _mish(_groupnorm(_conv1d(x, p["b1_w"], p["b1_b"], padding=1), p["n1_s"], p["n1_b"], 8))
    h = h + (_mish(t_emb) @ p["mlp_w"] + p["mlp_b"])[:, :, None]
    h = _mish(_groupnorm(_conv1d(h, p["b2_w"], p["b2_b"], padding=1), p["n2_s"], p["n2_b"], 8))
    return h + _conv1d(x, p["res_w"], p["res_b"])


def _est_transformer(p: Dict, x, heads: int, head_dim: int):
    """diffusers BasicTransformerBlock (self-attention + GELU FF) on (B, T, C)."""
    h = _ln(x, p["norm1_s"], p["norm1_b"])
    b, t, _ = h.shape
    q = (h @ p["q_w"]).reshape(b, t, heads, head_dim)
    k = (h @ p["k_w"]).reshape(b, t, heads, head_dim)
    v = (h @ p["v_w"]).reshape(b, t, heads, head_dim)
    attn = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(head_dim), dim=-1)
    x = x + (torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, t, heads * head_dim) @ p["o_w"] + p["o_b"])
    h = _ln(x, p["norm3_s"], p["norm3_b"])
    return x + (F.gelu(h @ p["ff1_w"] + p["ff1_b"]) @ p["ff2_w"] + p["ff2_b"])


def _est_stage(p: Dict, h, t_emb, cfg: FlowConfig):
    """A resnet block, then the transformer blocks over (B, T, C)."""
    h = _est_resnet(p["res"], h, t_emb)
    ht = h.transpose(1, 2)
    for j in range(cfg.est_n_blocks):
        ht = _est_transformer(p[f"tf_{j}"], ht, cfg.est_heads, cfg.est_head_dim)
    return ht.transpose(1, 2)


def estimator_apply(p: Dict, x: torch.Tensor, mu: torch.Tensor, t: torch.Tensor, spks: torch.Tensor,
                    cond: torch.Tensor, cfg: FlowConfig) -> torch.Tensor:
    """The velocity field: x / mu / cond (B, mel, L), spks (B, mel), t (B,)."""
    t_emb = _time_emb(p, t, cfg.est_in_channels)
    L = x.shape[-1]
    h = torch.cat([x, mu, spks[:, :, None].expand(-1, -1, L), cond], dim=1)
    hiddens = []
    n = len(cfg.est_channels)
    for i in range(n):
        d = p[f"down_{i}"]
        h = _est_stage(d, h, t_emb, cfg)
        hiddens.append(h)
        h = _conv1d(h, d["down_w"], d["down_b"], stride=2 if i < n - 1 else 1, padding=1)
    for i in range(cfg.est_mid_blocks):
        h = _est_stage(p[f"mid_{i}"], h, t_emb, cfg)
    for i in range(n):
        u = p[f"up_{i}"]
        skip = hiddens.pop()
        h = _est_stage(u, torch.cat([h[:, :, : skip.shape[-1]], skip], dim=1), t_emb, cfg)
        if i < n - 1:  # ConvTranspose1d(k=4, s=2, p=1) == lhs dilation 2, pads (2, 2)
            h = _conv1d(h, u["up_w"], u["up_b"], lhs_dilation=2, padding=2)
        else:
            h = _conv1d(h, u["up_w"], u["up_b"], padding=1)
    h = _mish(_groupnorm(_conv1d(h, p["final_b_w"], p["final_b_b"], padding=1), p["final_n_s"], p["final_n_b"], 8))
    return _conv1d(h, p["final_w"], p["final_b"])


# ---------------------------------------------------------------------------
# the CFM solver and token -> mel
# ---------------------------------------------------------------------------


def cfm_solve(p: Dict, mu: torch.Tensor, spks: torch.Tensor, cond: torch.Tensor, cfg: FlowConfig,
              generator: Optional[torch.Generator] = None, temperature: float = 1.0,
              z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Euler ODE over the cosine t-schedule with classifier-free guidance
    (the reference's flow_matching.py:70-110); mu / cond (B, mel, L). ``z``
    is the initial noise, else drawn from ``generator`` times
    ``temperature``. The conditional / unconditional pair runs as one
    batch-2B estimator call per step."""
    if z is None:
        z = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=mu.dtype) * temperature
    ts = 1 - torch.cos(torch.linspace(0, 1, cfg.n_timesteps + 1, device=mu.device) * 0.5 * math.pi)
    r = cfg.inference_cfg_rate
    b = mu.shape[0]
    if r > 0:
        mu2 = torch.cat([mu, torch.zeros_like(mu)])
        spks2 = torch.cat([spks, torch.zeros_like(spks)])
        cond2 = torch.cat([cond, torch.zeros_like(cond)])
    x = z
    for step in range(1, cfg.n_timesteps + 1):
        t, dt = ts[step - 1][None], ts[step] - ts[step - 1]
        if r > 0:
            vv = estimator_apply(p, torch.cat([x, x]), mu2, t, spks2, cond2, cfg)
            v = (1.0 + r) * vv[:b] - r * vv[b:]
        else:
            v = estimator_apply(p, x, mu, t, spks, cond, cfg)
        x = x + dt * v
    return x


def flow_token2mel(params: Dict, tokens: torch.Tensor, spk_embedding: torch.Tensor, cfg: FlowConfig = FlowConfig(),
                   generator: Optional[torch.Generator] = None, prompt_tokens: Optional[torch.Tensor] = None,
                   prompt_feat: Optional[torch.Tensor] = None, z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference MaskedDiffWithXvec.inference (flow.py:104-148): tokens
    (1, T) -> mel (1, mel, L) of the generated tokens (the prompt's region
    stripped). ``z`` (1, mel, prompt frames + L) is the CFM's initial noise,
    else drawn from ``generator``."""
    dev = params["input_embedding"].device
    tokens = tokens.to(dev, torch.int64)
    n_prompt = prompt_tokens.shape[1] if prompt_tokens is not None and prompt_tokens.numel() else 0
    if n_prompt:
        tokens = torch.cat([prompt_tokens.to(dev, torch.int64), tokens], dim=1)
        mel_len1 = prompt_feat.shape[1]
    else:
        mel_len1 = 0
    emb = spk_embedding.to(dev, torch.float32)
    emb = emb / emb.norm(dim=1, keepdim=True).clamp_min(1e-12)
    spks = emb @ params["spk_w"] + params["spk_b"]  # (1, mel)
    h = flow_encoder_apply(params["encoder"], params["input_embedding"][tokens.clamp_min(0)], cfg)
    h = h @ params["enc_proj_w"] + params["enc_proj_b"]  # (1, T, mel)
    mel_len2 = int((tokens.shape[1] - n_prompt) / cfg.input_frame_rate * cfg.mel_sr / cfg.mel_hop)
    if mel_len1 > 0:  # the reference interpolates the prompt and the generated tokens apart
        hi = torch.cat([_linear_interp(h[:, :n_prompt].transpose(1, 2), mel_len1),
                        interp_generated(h[:, n_prompt:], mel_len2, cfg)], dim=-1)
    else:
        hi = interp_generated(h, mel_len2, cfg)
    mu = _regulator_stack(params["regulator"], hi, cfg)  # (1, mel, L)
    conds = mu.new_zeros(1, mel_len1 + mel_len2, cfg.output_size)
    if mel_len1 > 0:
        conds[:, :mel_len1] = prompt_feat.to(dev, torch.float32)
    mel = cfm_solve(params["estimator"], mu, spks, conds.transpose(1, 2), cfg, generator, z=z)
    return mel[:, :, mel_len1:]


# ---------------------------------------------------------------------------
# the reference checkpoint
# ---------------------------------------------------------------------------


def _t(v):
    return np.ascontiguousarray(_np(v).T)


def _est_resnet_params(sd, pre):
    return {
        "b1_w": _np(sd[f"{pre}.block1.block.0.weight"]), "b1_b": _np(sd[f"{pre}.block1.block.0.bias"]),
        "n1_s": _np(sd[f"{pre}.block1.block.1.weight"]), "n1_b": _np(sd[f"{pre}.block1.block.1.bias"]),
        "mlp_w": _t(sd[f"{pre}.mlp.1.weight"]), "mlp_b": _np(sd[f"{pre}.mlp.1.bias"]),
        "b2_w": _np(sd[f"{pre}.block2.block.0.weight"]), "b2_b": _np(sd[f"{pre}.block2.block.0.bias"]),
        "n2_s": _np(sd[f"{pre}.block2.block.1.weight"]), "n2_b": _np(sd[f"{pre}.block2.block.1.bias"]),
        "res_w": _np(sd[f"{pre}.res_conv.weight"]), "res_b": _np(sd[f"{pre}.res_conv.bias"]),
    }


def _est_tf_params(sd, pre):
    return {
        "norm1_s": _np(sd[f"{pre}.norm1.weight"]), "norm1_b": _np(sd[f"{pre}.norm1.bias"]),
        "q_w": _t(sd[f"{pre}.attn1.to_q.weight"]), "k_w": _t(sd[f"{pre}.attn1.to_k.weight"]),
        "v_w": _t(sd[f"{pre}.attn1.to_v.weight"]),
        "o_w": _t(sd[f"{pre}.attn1.to_out.0.weight"]), "o_b": _np(sd[f"{pre}.attn1.to_out.0.bias"]),
        "norm3_s": _np(sd[f"{pre}.norm3.weight"]), "norm3_b": _np(sd[f"{pre}.norm3.bias"]),
        "ff1_w": _t(sd[f"{pre}.ff.net.0.proj.weight"]), "ff1_b": _np(sd[f"{pre}.ff.net.0.proj.bias"]),
        "ff2_w": _t(sd[f"{pre}.ff.net.2.weight"]), "ff2_b": _np(sd[f"{pre}.ff.net.2.bias"]),
    }


def _est_block(sd, pre, cfg):
    return {"res": _est_resnet_params(sd, f"{pre}.0"),
            **{f"tf_{j}": _est_tf_params(sd, f"{pre}.1.{j}") for j in range(cfg.est_n_blocks)}}


def convert_cosyvoice_flow_state(sd: Dict[str, Any], cfg: FlowConfig = FlowConfig()) -> Dict:
    """The reference ``flow.pt`` state dict -> ``flow_token2mel``'s
    parameters as numpy; ``ops.torch_port.to_device`` puts them on the card."""
    p: Dict[str, Any] = {
        "input_embedding": _np(sd["input_embedding.weight"]),
        "spk_w": _t(sd["spk_embed_affine_layer.weight"]), "spk_b": _np(sd["spk_embed_affine_layer.bias"]),
        "enc_proj_w": _t(sd["encoder_proj.weight"]), "enc_proj_b": _np(sd["encoder_proj.bias"]),
    }
    enc: Dict[str, Any] = {
        "embed_w": _t(sd["encoder.embed.out.0.weight"]), "embed_b": _np(sd["encoder.embed.out.0.bias"]),
        "embed_ln_s": _np(sd["encoder.embed.out.1.weight"]), "embed_ln_b": _np(sd["encoder.embed.out.1.bias"]),
        "after_norm_s": _np(sd["encoder.after_norm.weight"]), "after_norm_b": _np(sd["encoder.after_norm.bias"]),
    }
    for i in range(cfg.enc_blocks):
        src = f"encoder.encoders.{i}"
        a = f"{src}.self_attn"
        enc[f"l{i}"] = {
            **{f"{n}_w": _t(sd[f"{a}.linear_{n}.weight"]) for n in ("q", "k", "v")},
            **{f"{n}_b": _np(sd[f"{a}.linear_{n}.bias"]) for n in ("q", "k", "v")},
            "out_w": _t(sd[f"{a}.linear_out.weight"]), "out_b": _np(sd[f"{a}.linear_out.bias"]),
            "pos_w": _t(sd[f"{a}.linear_pos.weight"]),
            "bias_u": _np(sd[f"{a}.pos_bias_u"]), "bias_v": _np(sd[f"{a}.pos_bias_v"]),
            "norm_mha_s": _np(sd[f"{src}.norm_mha.weight"]), "norm_mha_b": _np(sd[f"{src}.norm_mha.bias"]),
            "norm_ff_s": _np(sd[f"{src}.norm_ff.weight"]), "norm_ff_b": _np(sd[f"{src}.norm_ff.bias"]),
            "ff1_w": _t(sd[f"{src}.feed_forward.w_1.weight"]), "ff1_b": _np(sd[f"{src}.feed_forward.w_1.bias"]),
            "ff2_w": _t(sd[f"{src}.feed_forward.w_2.weight"]), "ff2_b": _np(sd[f"{src}.feed_forward.w_2.bias"]),
        }
    p["encoder"] = enc
    reg: Dict[str, Any] = {}
    for i in range(cfg.regulator_convs):
        reg[f"c{i}_w"] = _np(sd[f"length_regulator.model.{3 * i}.weight"])
        reg[f"c{i}_b"] = _np(sd[f"length_regulator.model.{3 * i}.bias"])
        reg[f"n{i}_s"] = _np(sd[f"length_regulator.model.{3 * i + 1}.weight"])
        reg[f"n{i}_b"] = _np(sd[f"length_regulator.model.{3 * i + 1}.bias"])
    last = 3 * cfg.regulator_convs
    reg["out_w"] = _np(sd[f"length_regulator.model.{last}.weight"])
    reg["out_b"] = _np(sd[f"length_regulator.model.{last}.bias"])
    p["regulator"] = reg
    base = "decoder.estimator"
    est: Dict[str, Any] = {
        "t1_w": _t(sd[f"{base}.time_mlp.linear_1.weight"]), "t1_b": _np(sd[f"{base}.time_mlp.linear_1.bias"]),
        "t2_w": _t(sd[f"{base}.time_mlp.linear_2.weight"]), "t2_b": _np(sd[f"{base}.time_mlp.linear_2.bias"]),
    }
    n = len(cfg.est_channels)
    for i in range(n):
        d = _est_block(sd, f"{base}.down_blocks.{i}", cfg)
        conv = f"{base}.down_blocks.{i}.2" + (".conv" if i < n - 1 else "")
        d["down_w"], d["down_b"] = _np(sd[f"{conv}.weight"]), _np(sd[f"{conv}.bias"])
        est[f"down_{i}"] = d
    for i in range(cfg.est_mid_blocks):
        est[f"mid_{i}"] = _est_block(sd, f"{base}.mid_blocks.{i}", cfg)
    for i in range(n):
        u = _est_block(sd, f"{base}.up_blocks.{i}", cfg)
        if i < n - 1:
            w = _np(sd[f"{base}.up_blocks.{i}.2.conv.weight"])  # ConvTranspose1d (I, O, K)
            u["up_w"] = np.ascontiguousarray(w.transpose(1, 0, 2)[:, :, ::-1])
            u["up_b"] = _np(sd[f"{base}.up_blocks.{i}.2.conv.bias"])
        else:
            u["up_w"], u["up_b"] = _np(sd[f"{base}.up_blocks.{i}.2.weight"]), _np(sd[f"{base}.up_blocks.{i}.2.bias"])
        est[f"up_{i}"] = u
    est["final_b_w"] = _np(sd[f"{base}.final_block.block.0.weight"])
    est["final_b_b"] = _np(sd[f"{base}.final_block.block.0.bias"])
    est["final_n_s"] = _np(sd[f"{base}.final_block.block.1.weight"])
    est["final_n_b"] = _np(sd[f"{base}.final_block.block.1.bias"])
    est["final_w"] = _np(sd[f"{base}.final_proj.weight"])
    est["final_b"] = _np(sd[f"{base}.final_proj.bias"])
    p["estimator"] = est
    return p
