"""The S2S vocoders of the port against the JAX package, on the CPU.

The shared conv glue (``ops.torch_port``), HiFT (deterministic source),
the CosyVoice flow (encoder, estimator at an odd length, token -> mel with
the same CFM noise ``z``), SNAC (the same NoiseBlock ``noises``) and
``CodecDecoder.decode`` for both codecs, all from one set of seeded weights
written by ``tools/synth_checkpoint`` in the published layouts (checked by
a strict load into the JAX tests' torch mirrors) and converted by each
package's own converter. f32 throughout: within 1e-4 of the output's scale
(the JAX package's own mirror tests allow 2e-4).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from slam_llm_tpu.models import cosyvoice_flow as jflow
from slam_llm_tpu.models import hift as jhift
from slam_llm_tpu.models import snac as jsnac
from slam_llm_tpu.ops import torch_port as jport
from slam_llm_tpu.utils import codec_utils as jcodec
from slam_llm_tpu_torch.models import cosyvoice_flow as tflow
from slam_llm_tpu_torch.models import hift as thift
from slam_llm_tpu_torch.models import snac as tsnac
from slam_llm_tpu_torch.ops import torch_port as tport
from slam_llm_tpu_torch.tools import synth_checkpoint as synth
from slam_llm_tpu_torch.utils import codec_utils as tcodec

TOL = 1e-4


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max |diff| {err} > {tol} x {scale}"


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


# ---------------------------------------------------------------------------
# ops.torch_port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(padding=3), dict(stride=2, padding=1), dict(padding=4, dilation=2), dict(padding=3, groups=4),
    # ConvTranspose1d forms: HiFT's / SNAC's (odd stride: output padding) / the flow's up conv
    dict(lhs_dilation=4, padding=5, pad_hi=5), dict(lhs_dilation=3, padding=3, pad_hi=4),
    dict(lhs_dilation=2, padding=2),
    # a grouped transposed form, which runs over the zero-dilated input
    dict(lhs_dilation=2, padding=3, pad_hi=3, groups=2),
])
def test_conv1d_nct_matches_jax(kw):
    rng = np.random.default_rng(0)
    groups = kw.get("groups", 1)
    k = 8 if kw.get("lhs_dilation", 1) > 1 else 7
    x = rng.standard_normal((2, 8, 13)).astype(np.float32)
    w = rng.standard_normal((6 if groups == 1 else 8, 8 // groups, k)).astype(np.float32)
    b = rng.standard_normal(w.shape[0]).astype(np.float32)
    want = jport.conv1d_nct(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **kw)
    got = tport.conv1d_nct(_t(x), _t(w), _t(b), **kw)
    _close(got, want)


def test_snake_and_fold_weight_norm_match_jax():
    rng = np.random.default_rng(1)
    x, a = rng.standard_normal((2, 5, 7)).astype(np.float32), rng.uniform(0.2, 2, 5).astype(np.float32)
    _close(tport.snake(_t(x), _t(a)), jport.snake(jnp.asarray(x), jnp.asarray(a)))
    g, v = rng.uniform(0.5, 2, (4, 1, 1)).astype(np.float32), rng.standard_normal((4, 3, 5)).astype(np.float32)
    for sd in ({"c.weight_g": torch.from_numpy(g), "c.weight_v": torch.from_numpy(v)},
               {"c.parametrizations.weight.original0": g, "c.parametrizations.weight.original1": v},
               {"c.weight": torch.from_numpy(v)}):
        np.testing.assert_array_equal(tport.fold_weight_norm(sd, "c"), jport.fold_weight_norm(sd, "c"))


# ---------------------------------------------------------------------------
# the published layouts
# ---------------------------------------------------------------------------


def test_synth_vocoder_state_dicts_load_into_the_reference_mirrors():
    """The writers' keys and shapes are the mirrors' (the reference's
    schema), at the tiny sizes and at CosyVoice-300M's / snac_24khz's."""
    from test_cosyvoice_flow import TorchFlow
    from test_hift import TorchHiFT
    from test_snac import TorchSNACDecoder

    for mirror, cfgs, fn in ((TorchHiFT, jhift.HiFTConfig, synth.hift_state_dict),
                             (TorchFlow, jflow.FlowConfig, synth.cosyvoice_flow_state_dict),
                             (TorchSNACDecoder, jsnac.SNACConfig, synth.snac_state_dict)):
        for cfg in (cfgs.tiny_test(), cfgs()):
            with torch.device("meta"):
                module = mirror(cfg)
            missing, unexpected = module.load_state_dict(fn(cfg), strict=False, assign=True)
            assert not missing and not unexpected, (mirror.__name__, missing[:3], unexpected[:3])


# ---------------------------------------------------------------------------
# HiFT
# ---------------------------------------------------------------------------


def test_stft_istft_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 203)).astype(np.float32)
    got, want = thift.stft_small(_t(x), 16, 4), jhift.stft_small(jnp.asarray(x), 16, 4)
    for g, w in zip(got, want):
        _close(g, w)
    re, im = (rng.standard_normal((2, 9, 20)).astype(np.float32) for _ in range(2))
    _close(thift.istft_small(_t(re), _t(im), 16, 4), jhift.istft_small(jnp.asarray(re), jnp.asarray(im), 16, 4))


def test_hift_decode_matches_jax():
    """The deterministic source (the JAX package's rng=None): f0, the sine
    source, every scale and the iSTFT, on 12 mel frames (3,072 samples:
    the phase's f32 cumsum is compared sample by sample)."""
    cfg, tcfg = jhift.HiFTConfig.tiny_test(), thift.HiFTConfig.tiny_test()
    sd = synth.hift_state_dict(tcfg, seed=3)
    mel = np.random.default_rng(3).standard_normal((2, cfg.in_channels, 12)).astype(np.float32)
    want = jhift.hift_decode(jhift.convert_hift_torch_state(sd, cfg), jnp.asarray(mel), cfg, rng=None)
    params = tport.to_device(thift.convert_hift_torch_state(sd, tcfg), "cpu")
    got = thift.hift_decode(params, _t(mel), tcfg)
    assert got.shape == (2, 12 * tcfg.upsample_total)
    _close(got, want)
    # f0 and the source alone, where the decode's clip could hide a difference
    jp = jhift.convert_hift_torch_state(sd, cfg)
    _close(thift.f0_predict(params["f0"], _t(mel)), jhift.f0_predict(jp["f0"], jnp.asarray(mel)))


# ---------------------------------------------------------------------------
# the CosyVoice flow
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def flow_pair():
    cfg, tcfg = jflow.FlowConfig.tiny_test(), tflow.FlowConfig.tiny_test()
    sd = synth.cosyvoice_flow_state_dict(tcfg, seed=4)
    return cfg, tcfg, jflow.convert_cosyvoice_flow_state(sd, cfg), tport.to_device(
        tflow.convert_cosyvoice_flow_state(sd, tcfg), "cpu")


def test_flow_encoder_matches_jax(flow_pair):
    cfg, tcfg, jp, tp = flow_pair
    x = np.random.default_rng(5).standard_normal((2, 11, cfg.input_size)).astype(np.float32)
    _close(tflow.flow_encoder_apply(tp["encoder"], _t(x), tcfg), jflow.flow_encoder_apply(jp["encoder"],
                                                                                            jnp.asarray(x), cfg))


def test_estimator_odd_length_matches_jax(flow_pair):
    """An odd mel length: the down conv's stride 2 and the up conv's
    transposed form leave a frame more, which the skip concat trims."""
    cfg, tcfg, jp, tp = flow_pair
    rng = np.random.default_rng(6)
    x, mu, cond = (rng.standard_normal((2, cfg.output_size, 13)).astype(np.float32) for _ in range(3))
    spks = rng.standard_normal((2, cfg.output_size)).astype(np.float32)
    t = np.array([0.3, 0.7], np.float32)
    want = jflow.estimator_apply(jp["estimator"], *(jnp.asarray(a) for a in (x, mu, t, spks, cond)), cfg)
    got = tflow.estimator_apply(tp["estimator"], *(_t(a) for a in (x, mu, t, spks, cond)), tcfg)
    _close(got, want)


@pytest.mark.parametrize("n_tokens", [30, 47])
def test_flow_token2mel_matches_jax_with_the_same_noise(flow_pair, n_tokens):
    """47 tokens take the head / middle / tail interpolation; the CFM's
    initial noise is the JAX package's PRNGKey(0) draw, passed as ``z``."""
    cfg, tcfg, jp, tp = flow_pair
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (1, n_tokens))
    spk = rng.standard_normal((1, cfg.spk_embed_dim)).astype(np.float32)
    want = jflow.flow_token2mel(jp, tokens, spk, cfg, rng=jax.random.PRNGKey(0))
    mel_len = int(n_tokens / cfg.input_frame_rate * cfg.mel_sr / cfg.mel_hop)
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, cfg.output_size, mel_len), jnp.float32))
    got = tflow.flow_token2mel(tp, torch.from_numpy(tokens), _t(spk), tcfg, z=_t(z))
    _close(got, want)


# ---------------------------------------------------------------------------
# SNAC
# ---------------------------------------------------------------------------


def _jax_snac_noises(cfg, t_frames, b=1, key=0):
    """The NoiseBlock inputs the JAX ``decoder_apply`` draws from ``rng``."""
    rng, out = jax.random.PRNGKey(key), []
    for t in tsnac.noise_lengths(t_frames, cfg):
        rng, sub = jax.random.split(rng)
        out.append(torch.from_numpy(np.asarray(jax.random.normal(sub, (b, 1, t), jnp.float32))))
    return out


@pytest.mark.parametrize("noise", [True, False])
def test_snac_decode_matches_jax_with_the_same_noises(noise):
    cfg = jsnac.SNACConfig(decoder_dim=32, decoder_rates=(4, 3), latent_dim=16, codebook_size=32, codebook_dim=4,
                           vq_strides=(2, 1), noise=noise)
    tcfg = tsnac.SNACConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    sd = synth.snac_state_dict(tcfg, seed=8)
    rng = np.random.default_rng(8)
    codes = [rng.integers(0, cfg.codebook_size, (2, 6 // s)) for s in cfg.vq_strides]
    jp = jsnac.convert_snac_torch_state(sd, cfg)
    want = jsnac.snac_decode(jp, codes, cfg, rng=jax.random.PRNGKey(1) if noise else None)
    noises = _jax_snac_noises(tcfg, 6, b=2, key=1) if noise else None
    got = tsnac.snac_decode(tport.to_device(tsnac.convert_snac_torch_state(sd, tcfg), "cpu"), codes, tcfg, noises)
    assert got.shape == (2, 6 * 12)
    _close(got, want)


# ---------------------------------------------------------------------------
# CodecDecoder
# ---------------------------------------------------------------------------


def _jax_decoder(**params):
    """The JAX ``CodecDecoder`` over host (numpy) parameters. Its
    ``from_*_checkpoint`` put every leaf on the device, the convolutions'
    strides too, which ``lax.conv_general_dilated`` then refuses
    (``unhashable type``): its decode fails on every call, and its drivers
    swallow the failure. The port's loaders keep the strides Python ints."""
    return jcodec.CodecDecoder(**params)


def test_codec_decoder_snac_matches_jax(tmp_path, monkeypatch):
    """snac_24khz's layout from a file (the port loads it with ``torch.load``
    onto the device), staggered 7-layer streams, the JAX decoder's
    PRNGKey(0) NoiseBlock draws passed as ``noises``; at a narrow width."""
    cfg = jsnac.SNACConfig(decoder_dim=32, decoder_rates=(4, 2), latent_dim=16, codebook_size=4096, codebook_dim=4)
    tcfg = tsnac.SNACConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    path = str(tmp_path / "snac.pt")
    synth.write_snac(path, tcfg, seed=9)
    monkeypatch.setattr(jsnac.SNACConfig, "snac_24khz", staticmethod(lambda: cfg))
    monkeypatch.setattr(tsnac.SNACConfig, "snac_24khz", staticmethod(lambda: tcfg))
    jdec = _jax_decoder(codec_type="snac", snac_params=jsnac.convert_snac_torch_state(torch.load(path), cfg),
                        snac_cfg=cfg)
    tdec = tcodec.CodecDecoder.from_snac_checkpoint(path, device="cpu")
    rng = np.random.default_rng(9)
    streams = rng.integers(0, 4096, (7, 15))
    cbs = tcodec.snac_streams_to_codebooks(streams)
    assert [c.tolist() for c in cbs] == [c.tolist() for c in jcodec.snac_streams_to_codebooks(streams)]
    want = jdec.decode(streams)
    got = tdec.decode(streams, noises=_jax_snac_noises(tcfg, cbs[-1].shape[1]))  # the stride-1 codebook
    _close(got, want)
    # the port's own seeded noise: reproducible, and a different draw than none
    again = tdec.decode(streams)
    np.testing.assert_array_equal(again, tdec.decode(streams))
    assert got.shape == again.shape and tdec.decode_window(streams, 0, 0) is None


def test_codec_decoder_cosyvoice_matches_jax(tmp_path, monkeypatch):
    """flow.pt + hift.pt from ``write_cosyvoice``; EOA truncation and the
    4095 pad replacement of grouped 3-layer streams; the CFM noise is the
    JAX package's PRNGKey(0) draw (``z``) and HiFT's source deterministic on
    both sides (the JAX decoder's PRNGKey(1) source cannot be matched)."""
    fcfg, hcfg = jflow.FlowConfig.tiny_test(), jhift.HiFTConfig.tiny_test()
    tf, th = tflow.FlowConfig.tiny_test(), thift.HiFTConfig.tiny_test()
    # the tiny flow's 64 tokens: EOA is 64; a pad 65 sits before it
    synth.write_cosyvoice(str(tmp_path), tf, th, seed=10)
    for mod, f, h in ((jflow, fcfg, None), (tflow, tf, None), (jhift, None, hcfg), (thift, None, th)):
        if f is not None:
            monkeypatch.setattr(mod, "FlowConfig", lambda f=f: f)
        else:
            monkeypatch.setattr(mod, "HiFTConfig", lambda h=h: h)
    real_hift = jhift.hift_decode
    monkeypatch.setattr(jhift, "hift_decode", lambda p, mel, cfg, rng=None: real_hift(p, mel, cfg, rng=None))
    flow, hift = str(tmp_path / "flow.pt"), str(tmp_path / "hift.pt")
    jdec = _jax_decoder(codec_type="cosyvoice", flow_cfg=fcfg, hift_cfg=hcfg,
                        flow_params=jflow.convert_cosyvoice_flow_state(torch.load(flow), fcfg),
                        hift_params=jhift.convert_hift_torch_state(torch.load(hift), hcfg))
    tdec = tcodec.CodecDecoder.from_cosyvoice_checkpoint(flow, hift, device="cpu")
    rng = np.random.default_rng(10)
    streams = rng.integers(0, 64, (3, 16))
    streams[1, 9] = 65  # a pad: replaced by vocab_size - 1 in place
    streams[2, 14] = 64  # EOA: the stream is cut before it
    tokens = tcodec.cosyvoice_group_to_stream(streams)
    np.testing.assert_array_equal(tokens, jcodec.cosyvoice_group_to_stream(streams))
    n = int(np.nonzero(tokens == 64)[0][0])
    mel_len = int(n / fcfg.input_frame_rate * fcfg.mel_sr / fcfg.mel_hop)
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, fcfg.output_size, mel_len), jnp.float32))
    want = jdec.decode(streams)
    got = tdec.decode(streams, z=_t(z), hift_noise=False)
    assert got.shape == (mel_len * th.upsample_total,)
    _close(got, want)


def test_codec_decoder_raises_on_a_missing_or_foreign_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        tcodec.CodecDecoder.from_snac_checkpoint(str(tmp_path / "none.pt"), device="cpu")
    bad = tmp_path / "bad.pt"
    torch.save({"something.else": torch.zeros(1)}, bad)
    with pytest.raises(KeyError):
        tcodec.CodecDecoder.from_cosyvoice_checkpoint(str(bad), str(bad), device="cpu")
