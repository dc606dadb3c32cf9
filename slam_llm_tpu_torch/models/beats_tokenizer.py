"""BEATs acoustic tokenizer: the BEATs trunk + a norm-EMA vector quantizer.

Counterpart of ``slam_llm_tpu/models/beats_tokenizer.py`` (the reference's
``models/BEATs/Tokenizers.py`` and ``quantizer.py``): the BEATs patch
embedding and transformer (``models.beats``) as a plain post-LN stack
(``rel_bias``, ``deep_norm`` and ``gate_from_query`` off, the tokenizer's
defaults), ``Linear -> tanh -> Linear`` to the 256-d codebook space, and the
nearest row of a 1024-entry l2-normalized codebook. ``extract_labels``
returns each patch's codebook index, the labels BEATs pre-training distills
against. No recipe builds it; it serves users who pre-train their own BEATs.

* The trunk's attention takes no bias, so its padding goes in as a key mask
  (the WavLM layer's structured route): on a CUDA tensor it runs K1.
* ``norm_ema_quantize`` is the quantizer's forward (straight-through z_q,
  commitment loss); ``ema_codebook_update`` its training-mode EMA update as
  a function returning the new ``(codebook, cluster_size)``, the bins and
  sums all-reduced over a process group the caller passes (the reference's
  ``all_reduce``; the JAX package's ``psum``).
* ``kmeans_cosine`` is the codebook's k-means init, its first means drawn
  with an explicit ``torch.Generator`` (or given as ``init_indices``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from slam_llm_tpu_torch.models.beats import BEATsEncoder, BEATsEncoderConfig, convert_beats
from slam_llm_tpu_torch.models.layers import DenseGeneralLora


def l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``F.normalize(p=2, dim=-1)``: x / max(|x|, eps)."""
    return x / x.square().sum(-1, keepdim=True).sqrt().clamp_min(eps)


@dataclass(frozen=True)
class BEATsTokenizerConfig:
    trunk: BEATsEncoderConfig = field(
        default_factory=lambda: BEATsEncoderConfig(rel_bias=False, deep_norm=False, gate_from_query=False))
    quant_n: int = 1024  # codebook entries
    quant_dim: int = 256  # codebook dimension
    decay: float = 0.99
    eps: float = 1e-5
    beta: float = 1.0  # commitment-loss weight

    @staticmethod
    def beats_iter3() -> "BEATsTokenizerConfig":
        return BEATsTokenizerConfig()

    @staticmethod
    def tiny_test() -> "BEATsTokenizerConfig":
        return BEATsTokenizerConfig(
            trunk=BEATsEncoderConfig(
                patch_size=4, patch_embed_dim=8, n_mels=16, d_model=32, n_heads=2, n_layers=2, ffn_dim=64,
                num_buckets=32, max_distance=64, conv_pos=16, conv_pos_groups=2,
                rel_bias=False, deep_norm=False, gate_from_query=False,
            ),
            quant_n=16, quant_dim=8,
        )


def norm_ema_quantize(z: torch.Tensor, codebook: torch.Tensor, beta: float = 1.0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(z_q, loss, indices) of ``z`` (..., D) against ``codebook`` (N, D),
    rows l2-normalized: z l2-normalized in f32, the nearest row by squared
    euclidean distance (||z||^2 + ||e||^2 - 2 z.e), the commitment loss
    beta * mean((z_q - z)^2) with z_q detached, and the straight-through
    z + (z_q - z).detach()."""
    z = l2norm(z.float())
    flat = z.reshape(-1, z.shape[-1])
    cb = codebook.float()
    d = flat.square().sum(1, keepdim=True) + cb.square().sum(1)[None, :] - 2.0 * flat @ cb.T
    idx = d.argmin(1)
    z_q = cb[idx].reshape(z.shape)
    loss = beta * (z_q.detach() - z).square().mean()
    return z + (z_q - z).detach(), loss, idx.reshape(z.shape[:-1])


def ema_codebook_update(codebook: torch.Tensor, cluster_size: torch.Tensor, z: torch.Tensor,
                        indices: torch.Tensor, decay: float = 0.99, group=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training-mode EMA update: the l2-normalized ``z`` (..., D) summed
    per assigned row (``indices``), bins and sums all-reduced over ``group``
    when given; cluster sizes EMA-merged; each row that got samples moves
    toward their normalized mean and is re-normalized, the others stay.
    Returns the new ``(codebook, cluster_size)``; nothing is written in place."""
    n, dim = codebook.shape
    flat = l2norm(z.float()).reshape(-1, dim)
    idx = indices.reshape(-1)
    bins = torch.zeros(n, device=flat.device).index_add_(0, idx, torch.ones_like(idx, dtype=torch.float32))
    embed_sum = torch.zeros(n, dim, device=flat.device).index_add_(0, idx, flat)
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(bins, group=group)
        dist.all_reduce(embed_sum, group=group)
    new_cluster = cluster_size * decay + bins * (1.0 - decay)
    zero = bins == 0
    embed_normalized = l2norm(embed_sum / torch.where(zero, 1.0, bins)[:, None])
    embed_normalized = torch.where(zero[:, None], codebook, embed_normalized)
    return l2norm(codebook * decay + embed_normalized * (1.0 - decay)), new_cluster


def kmeans_cosine(samples: torch.Tensor, num_clusters: int, num_iters: int = 10,
                  generator: Optional[torch.Generator] = None, init_indices: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cosine k-means for the codebook's init: the first means a random
    subset of the samples (``init_indices``, else drawn from ``generator``:
    without replacement when there are enough samples), then ``num_iters``
    rounds of max-dot-product assignment, each mean the normalized mean of
    its samples, an empty cluster keeping its mean. Returns (means (N, D),
    the last round's bins (N,))."""
    n_samples = samples.shape[0]
    samples = samples.float()
    if init_indices is None:
        dev = generator.device if generator is not None else samples.device
        if n_samples >= num_clusters:
            init_indices = torch.randperm(n_samples, generator=generator, device=dev)[:num_clusters]
        else:
            init_indices = torch.randint(0, n_samples, (num_clusters,), generator=generator, device=dev)
    means = samples[init_indices.to(samples.device)]
    bins = torch.zeros(num_clusters, device=samples.device)
    for _ in range(num_iters):
        buckets = (samples @ means.T).argmax(1)
        bins = torch.zeros(num_clusters, device=samples.device).index_add_(
            0, buckets, torch.ones(n_samples, device=samples.device))
        sums = torch.zeros_like(means).index_add_(0, buckets, samples)
        new_means = l2norm(sums / bins.clamp_min(1.0)[:, None])
        means = torch.where((bins == 0)[:, None], means, new_means)
    return means, bins


class BEATsTokenizer(nn.Module):
    """(B, T_mel, 128) normalized fbank (+ mask) -> (B, n_patches) codebook
    indices. ``trunk`` is a ``BEATsEncoder`` (its names, so one converter
    serves both), then ``quantize_in`` -> tanh -> ``quantize_out`` and the
    ``codebook`` (N, D) f32."""

    def __init__(self, cfg: BEATsTokenizerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        t = cfg.trunk
        self.trunk = BEATsEncoder(t, device)
        self.quantize_in = DenseGeneralLora(t.d_model, t.d_model, use_bias=True, dtype=t.dtype, device=device)
        self.quantize_out = DenseGeneralLora(t.d_model, cfg.quant_dim, use_bias=True, dtype=t.dtype, device=device)
        self.codebook = nn.Parameter(torch.zeros(cfg.quant_n, cfg.quant_dim, device=device), requires_grad=False)

    def project(self, fbank: torch.Tensor, mel_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The codebook-space features (B, n_patches, quant_dim), before
        normalization, and the patch mask."""
        x, out_mask = self.trunk(fbank, mel_mask)
        return self.quantize_out(torch.tanh(self.quantize_in(x))), out_mask

    def forward(self, fbank: torch.Tensor, mel_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(indices, commitment loss, patch mask)."""
        zin, out_mask = self.project(fbank, mel_mask)
        _, loss, idx = norm_ema_quantize(zin, self.codebook, self.cfg.beta)
        return idx, loss, out_mask

    def extract_labels(self, fbank: torch.Tensor, mel_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Each patch's codebook index (the reference's ``extract_labels``,
        from the fbank ``ops.fbank`` computes)."""
        return self(fbank, mel_mask)[0]


def convert_beats_tokenizer(sd: Dict[str, torch.Tensor], cfg: BEATsTokenizerConfig) -> Dict[str, torch.Tensor]:
    """An official BEATs tokenizer checkpoint's ``model`` state dict ->
    ``BEATsTokenizer`` ``state_dict`` names: the trunk through
    ``models.beats.convert_beats`` (a tokenizer checkpoint has no gate keys
    and no rel-pos table, as the trunk's config has none),
    ``quantize_layer.0`` / ``.2`` and ``quantize.embedding``."""
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    out = {f"trunk.{k}": v for k, v in convert_beats(sd, cfg.trunk).items()}
    for port, ref in (("quantize_in", "quantize_layer.0"), ("quantize_out", "quantize_layer.2")):
        out[f"{port}.weight"] = sd[f"{ref}.weight"]
        out[f"{port}.bias"] = sd[f"{ref}.bias"]
    out["codebook"] = sd["quantize.embedding.weight"]
    return out
