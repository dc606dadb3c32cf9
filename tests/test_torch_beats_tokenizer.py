"""The port's BEATs tokenizer against the JAX package's, on the CPU.

``models/beats_tokenizer.py``: the quantizer (indices, commitment loss,
straight-through gradient), the EMA codebook update (in one process, and
with its sums all-reduced over a gloo group of two ranks, each holding half
of the samples, this file run as the workers' script), cosine k-means fed
the JAX draw's initial indices, and ``extract_labels`` / the projected
features of the whole tokenizer (a ragged mask and none, f32) from a JAX
parameter tree through ``utils.convert`` and from an official-layout
checkpoint through ``convert_encoder_checkpoint(..., "beats_tokenizer")``.
"""

import dataclasses
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_llm_tpu.models import beats_tokenizer as jbt
from slam_llm_tpu_torch.models import beats_tokenizer as tbt

HERE = Path(__file__).resolve().parent


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _codebook(n=16, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return np.array(jbt.l2norm(jnp.asarray(rng.standard_normal((n, d)), jnp.float32)))


def test_quantizer_matches_jax():
    """Indices equal, z_q and the commitment loss within 1e-6, and the
    straight-through gradient (the l2norm's) within 1e-6 of JAX's."""
    cb = _codebook()
    z = np.random.default_rng(1).standard_normal((3, 5, 8)).astype(np.float32) * 2
    jz_q, jloss, jidx = jbt.norm_ema_quantize(jnp.asarray(z), jnp.asarray(cb), beta=0.5)
    tz = torch.from_numpy(z).requires_grad_(True)
    z_q, loss, idx = tbt.norm_ema_quantize(tz, torch.from_numpy(cb), beta=0.5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(z_q.detach().numpy(), np.asarray(jz_q), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    (z_q * 2.0).sum().backward()
    jg = jax.grad(lambda zz: jnp.sum(jbt.norm_ema_quantize(zz, jnp.asarray(cb))[0] * 2.0))(jnp.asarray(z))
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)


def _ema_case(seed=2, n=12):
    """(codebook, cluster sizes, n samples, their indices): fewer samples
    than rows, so some rows get none."""
    rng = np.random.default_rng(seed)
    cb = _codebook(seed=seed)
    cs = rng.random(16).astype(np.float32)
    z = rng.standard_normal((n, 8)).astype(np.float32)
    _, _, idx = jbt.norm_ema_quantize(jnp.asarray(z), jnp.asarray(cb))
    return cb, cs, z, np.array(idx)


def test_ema_update_matches_jax():
    """The new codebook and cluster sizes within 1e-6 of JAX's; rows without
    samples only re-normalized; the inputs not written."""
    cb, cs, z, idx = _ema_case()
    want_cb, want_cs = jbt.ema_codebook_update(jnp.asarray(cb), jnp.asarray(cs), jnp.asarray(z), jnp.asarray(idx),
                                               decay=0.9)
    tcb = torch.from_numpy(cb.copy())
    got_cb, got_cs = tbt.ema_codebook_update(tcb, torch.from_numpy(cs), torch.from_numpy(z),
                                             torch.from_numpy(idx), decay=0.9)
    np.testing.assert_allclose(got_cb.numpy(), np.asarray(want_cb), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_cs.numpy(), np.asarray(want_cs), rtol=1e-6, atol=1e-7)
    empty = np.bincount(idx, minlength=16) == 0
    assert empty.any() and torch.equal(tcb, torch.from_numpy(cb))
    np.testing.assert_allclose(got_cb.numpy()[empty], cb[empty], rtol=1e-6, atol=1e-6)  # re-normalized only


def _ema_worker(payload: str, out_dir: str) -> None:
    import torch.distributed as dist

    from slam_llm_tpu_torch.pipeline.common import maybe_init_distributed

    torch.set_num_threads(1)
    assert maybe_init_distributed("cpu")
    job = torch.load(payload, weights_only=False)
    r, n = dist.get_rank(), dist.get_world_size()
    rows = slice(r * len(job["z"]) // n, (r + 1) * len(job["z"]) // n)
    cb, cs = tbt.ema_codebook_update(job["cb"], job["cs"], job["z"][rows], job["idx"][rows], decay=0.9,
                                     group=dist.group.WORLD)
    torch.save({"cb": cb, "cs": cs}, Path(out_dir) / f"ema{r}.pt")
    dist.destroy_process_group()


def test_ema_update_all_reduced_over_a_group(tmp_path):
    """Two gloo ranks with half of the samples each, the bins and sums
    all-reduced over the group the caller passes: each rank's update equals
    JAX's over all samples within 1e-6 (the reference's all_reduce, the
    JAX package's psum)."""
    from test_torch_distributed import _Group

    cb, cs, z, idx = _ema_case(seed=3, n=24)
    group = _Group(2, {"cb": torch.from_numpy(cb), "cs": torch.from_numpy(cs), "z": torch.from_numpy(z),
                       "idx": torch.from_numpy(idx)}, tmp_path, script=Path(__file__))
    want_cb, want_cs = jbt.ema_codebook_update(jnp.asarray(cb), jnp.asarray(cs), jnp.asarray(z), jnp.asarray(idx),
                                               decay=0.9)
    group.wait()
    for r in range(2):
        got = torch.load(tmp_path / f"ema{r}.pt")
        np.testing.assert_allclose(got["cb"].numpy(), np.asarray(want_cb), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["cs"].numpy(), np.asarray(want_cs), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n_samples", [128, 5])
def test_kmeans_matches_jax_from_the_same_initial_indices(n_samples):
    """Cosine k-means from JAX's initial draw (a permutation's first N, or
    N draws with replacement when there are fewer samples): the means within
    1e-5 and the bins equal; with a ``torch.Generator`` instead, the draw is
    reproducible and the clusters of separable data are found."""
    rng = np.random.default_rng(4)
    centers = np.asarray(jbt.l2norm(jnp.asarray(rng.standard_normal((4, 8)), jnp.float32)))
    pts = np.repeat(centers, 32, axis=0)[:n_samples] + 0.05 * rng.standard_normal((n_samples, 8)).astype(np.float32)
    pts = np.asarray(jbt.l2norm(jnp.asarray(pts)), np.float32)
    key = jax.random.PRNGKey(7)
    init = (jax.random.permutation(key, n_samples)[:4] if n_samples >= 4
            else jax.random.randint(key, (4,), 0, n_samples))
    want_means, want_bins = jbt.kmeans_cosine(key, jnp.asarray(pts), 4, 10)
    means, bins = tbt.kmeans_cosine(torch.from_numpy(pts), 4, 10, init_indices=torch.from_numpy(np.array(init)))
    np.testing.assert_allclose(means.numpy(), np.asarray(want_means), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(bins.numpy(), np.asarray(want_bins))
    if n_samples == 128:
        a = tbt.kmeans_cosine(torch.from_numpy(pts), 4, 10, generator=torch.Generator().manual_seed(0))
        b = tbt.kmeans_cosine(torch.from_numpy(pts), 4, 10, generator=torch.Generator().manual_seed(0))
        assert torch.equal(a[0], b[0]) and float(a[1].sum()) == 128.0


# ---- the whole tokenizer --------------------------------------------------------------


def _configs():
    jcfg = jbt.BEATsTokenizerConfig.tiny_test()
    jcfg = dataclasses.replace(jcfg, trunk=dataclasses.replace(jcfg.trunk, dtype=jnp.float32))
    tcfg = tbt.BEATsTokenizerConfig.tiny_test()
    tcfg = dataclasses.replace(tcfg, trunk=dataclasses.replace(tcfg.trunk, dtype=torch.float32))
    return jcfg, tcfg


def _inputs():
    rng = np.random.default_rng(5)
    fbank = rng.standard_normal((3, 40, 16)).astype(np.float32)
    mask = np.ones((3, 40), np.int32)
    mask[1, 24:] = 0
    mask[2, 9:] = 0
    return fbank, mask


def _hold(model, jmodel, params):
    """``extract_labels`` equal and the projected features within 1e-5
    relative L2, with the ragged mask and without one; the patch mask and
    the commitment loss too."""
    fbank, mask = _inputs()
    for m in (mask, None):
        jm = None if m is None else jnp.asarray(m)
        jidx, jloss, jmask = jmodel.apply({"params": params}, jnp.asarray(fbank), jm)
        labels = jmodel.apply({"params": params}, jnp.asarray(fbank), jm, method="extract_labels")
        tm = None if m is None else torch.from_numpy(m)
        with torch.no_grad():
            idx, loss, out_mask = model(torch.from_numpy(fbank), tm)
            zin, _ = model.project(torch.from_numpy(fbank), tm)
            got_labels = model.extract_labels(torch.from_numpy(fbank), tm)
        assert idx.shape == (3, 40)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(got_labels.numpy(), np.asarray(labels))
        np.testing.assert_array_equal(out_mask.numpy(), np.asarray(jmask))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        jz = _jax_projected(jmodel, params, fbank, jm)
        assert _rel_l2(zin.numpy(), jz) <= 1e-5


def _jax_projected(jmodel, params, fbank, mask):
    """The JAX tokenizer's codebook-space features (its ``quantize_out``
    output), read through flax's intermediate capture."""
    _, state = jmodel.apply({"params": params}, jnp.asarray(fbank), mask, capture_intermediates=True,
                            mutable=["intermediates"])
    return np.asarray(state["intermediates"]["quantize_out"]["__call__"][0])


def test_tokenizer_from_a_jax_tree_matches_jax():
    """A JAX-initialized tokenizer (codebook l2-normalized) carried into the
    port by ``utils.convert.flax_to_state_dict`` and loaded strictly: its
    trunk is the plain post-LN stack (no rel-pos table, no gate), and it
    meets the JAX module (``_hold``)."""
    from flax import linen as nn

    from slam_llm_tpu_torch.utils.convert import flax_to_state_dict

    jcfg, tcfg = _configs()
    fbank, mask = _inputs()
    jmodel = jbt.BEATsTokenizer(jcfg)
    params = nn.meta.unbox(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(fbank), jnp.asarray(mask))["params"])
    model = tbt.BEATsTokenizer(tcfg).eval()
    model.load_state_dict(flax_to_state_dict(params))
    assert model.trunk.transformer.rel_attn_embed is None
    assert not any("gru_rel_pos" in n for n, _ in model.named_parameters())
    _hold(model, jmodel, params)


def _tokenizer_checkpoint(path, cfg, seed=0):
    """An official BEATs tokenizer checkpoint: the BEATs trunk's keys
    without the gate and the rel-pos table, ``quantize_layer.0`` / ``.2`` and
    ``quantize.embedding`` (l2-normalized rows)."""
    from slam_llm_tpu_torch.tools.synth_checkpoint import write_beats

    write_beats(str(path), cfg.trunk, seed=seed)
    ckpt = torch.load(path, weights_only=False)
    sd = {k: v.float() for k, v in ckpt["model"].items() if "grep" not in k and "relative_attention_bias" not in k}
    g = torch.Generator().manual_seed(seed + 1)
    d, q = cfg.trunk.d_model, cfg.quant_dim
    sd.update({"quantize_layer.0.weight": torch.randn(d, d, generator=g) / d ** 0.5,
               "quantize_layer.0.bias": torch.randn(d, generator=g) * 0.1,
               "quantize_layer.2.weight": torch.randn(q, d, generator=g) / d ** 0.5,
               "quantize_layer.2.bias": torch.randn(q, generator=g) * 0.1,
               "quantize.embedding.weight": tbt.l2norm(torch.randn(cfg.quant_n, q, generator=g))})
    torch.save({"cfg": ckpt["cfg"], "model": sd}, path)
    return sd


def test_tokenizer_checkpoint_route_matches_jax(tmp_path):
    """``convert_encoder_checkpoint(path, "beats_tokenizer", cfg)`` routes an
    official tokenizer checkpoint to ``convert_beats_tokenizer``, as the JAX
    package's dispatcher does; loaded strictly, the port meets the JAX
    tokenizer built by its own converter from the same file (``_hold``)."""
    from slam_llm_tpu.utils.hf_loader import convert_encoder_checkpoint as j_convert
    from slam_llm_tpu_torch.utils.hf_loader import convert_encoder_checkpoint

    jcfg, tcfg = _configs()
    path = tmp_path / "beats_tokenizer.pt"
    _tokenizer_checkpoint(path, tcfg)
    model = tbt.BEATsTokenizer(tcfg).eval()
    model.load_state_dict(convert_encoder_checkpoint(str(path), "beats_tokenizer", tcfg))
    params = jax.tree_util.tree_map(jnp.asarray, j_convert(str(path), "beats_tokenizer", jcfg))
    _hold(model, jbt.BEATsTokenizer(jcfg), params)


def test_seeded_init_fills_a_normalized_codebook():
    """``pipeline.common.init_params_`` draws the codebook with unit rows,
    as the JAX initializer does."""
    from slam_llm_tpu_torch.pipeline.common import init_params_

    model = tbt.BEATsTokenizer(_configs()[1])
    init_params_(model, torch.Generator().manual_seed(0))
    norms = model.codebook.norm(dim=-1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5) and model.quantize_out.weight.abs().sum() > 0


if __name__ == "__main__":
    sys.path.insert(0, str(HERE))
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    _ema_worker(sys.argv[1], sys.argv[2])
