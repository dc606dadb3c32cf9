"""CUDA kernels of slam_llm_tpu_torch against their plain twins, on the card.

Every test here needs a CUDA GPU and skips without one. The file imports no
JAX, so it also runs on a torch-only GPU host, where the repository's
conftest (which imports JAX) has to be left out:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from slam_llm_tpu_torch.ops import quant as tquant
from slam_llm_tpu_torch.ops.kernels import flash_attention as tflash
from slam_llm_tpu_torch.ops.kernels import rowquant as trowquant

pytestmark = pytest.mark.gpu


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode; their twins are tested on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("d,n", [(64, 64), (64, 128), (128, 64), (128, 128)])
def test_wgmma_layouts_on_one_tile(gen, d, n):
    """The operand layouts K1 and K4 build on, pinned on one tile: S = Q K^T
    with both operands K-major from TMA's 128-byte-swizzled panels, then
    O = bf16(S) V with S taken from the accumulator registers as the A
    fragment and V read MN-major (the transpose bit; at D = 128 across two
    panels, the LBO)."""
    from slam_llm_tpu_torch.kernels.build import check, library, stream_ptr

    q = torch.randn(64, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(n, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(n, d, generator=gen, device="cuda").bfloat16()
    s = torch.empty(64, n, device="cuda")
    o = torch.empty(64, d, device="cuda")
    check(library().slam_wgmma_probe(q.data_ptr(), k.data_ptr(), v.data_ptr(), s.data_ptr(), o.data_ptr(), d, n,
                                     stream_ptr(q)), "wgmma probe")
    torch.cuda.synchronize()
    want_s = q.float() @ k.float().T
    assert (s - want_s).abs().max().item() <= 1e-3 * want_s.abs().max().item()
    want_o = s.bfloat16().float() @ v.float()  # the kernel's own S, rounded as the fragment rounds it
    assert (o - want_o).abs().max().item() <= 1e-4 * want_o.abs().max().item()


@pytest.mark.parametrize("t,h,hkv,d,causal", [(1500, 12, 12, 64, False), (448, 32, 4, 64, True),
                                               (512, 8, 8, 128, True), (70, 4, 1, 64, True),
                                               (1, 8, 1, 64, True), (449, 8, 4, 64, True),
                                               (449, 12, 3, 64, False), (1500, 12, 12, 128, False),
                                               (70, 16, 2, 128, True), (1500, 32, 4, 64, False),
                                               # the ST recipe: qwen2-7b's G = 7 at decode T = 1, vicuna-7b,
                                               # whisper-large-v3's encoder, the Q-Former's self-attention
                                               (1, 28, 4, 128, True), (512, 32, 32, 128, True),
                                               (1500, 20, 20, 64, False), (80, 12, 12, 64, False)])
def test_flash_kernel_matches_twin(gen, t, h, hkv, d, causal):
    """bf16 out within 2e-2 abs of the f32 twin on the same bf16 inputs (the
    kernel rounds p to bf16 for the p.v product); live-row lse within 1e-3;
    rows with no visible key exactly 0. T = 1 masks every key of both
    batch rows."""
    b = 2
    q = torch.randn(b, t, h, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(b, t, hkv, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(b, t, hkv, d, generator=gen, device="cuda").bfloat16()
    mask = torch.ones(b, t, dtype=torch.int32, device="cuda")
    mask[0, :17] = 0
    mask[1, t - 11:] = 0
    before = tflash.flash_attention_fwd.launches
    out, lse = tflash.flash_attention_fwd(q, k, v, mask, causal)
    assert tflash.flash_attention_fwd.launches == before + 1
    ref, ref_lse = tflash.flash_attention_ref(q.float(), k.float(), v.float(), mask, causal)
    live = mask.cumsum(1) > 0 if causal else torch.ones_like(mask, dtype=torch.bool)
    assert (out.float() - ref).abs().max().item() <= 2e-2
    if bool(live.any()):
        assert (lse - ref_lse)[live].abs().max().item() <= 1e-3
    assert bool((out[~live] == 0).all())


@pytest.mark.parametrize("h", [16, 12])  # hubert-large, emotion2vec-base
def test_flash_kernel_at_the_encoder_shapes(gen, h):
    """K1 at the raw-waveform encoders' attention: T = 499 (a 10 s bucket of
    160,000 samples), non-causal, key masks right-padded to ragged lengths
    as ``WavLMEncoder`` builds them; within 2e-2 of the f32 twin, lse within
    1e-3 on every row."""
    b, t, d = 4, 499, 64
    q, k, v = _qkv(b, t, h, h, d, gen)
    mask = torch.zeros(b, t, dtype=torch.int32, device="cuda")
    for i, n in enumerate((499, 436, 249, 99)):
        mask[i, :n] = 1
    out, lse = tflash.flash_attention_fwd(q, k, v, mask, False)
    ref, ref_lse = tflash.flash_attention_ref(q.float(), k.float(), v.float(), mask, False)
    assert (out.float() - ref).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.parametrize("b,t,lengths", [
    (16, 513, None),  # EAT-base's fixed-length training batch: 1024 frames -> 64 x 8 patches + CLS
    (8, 513, None),  # its decode batch
    (4, 513, (1, 129, 257, 513)),  # ragged keys: the CLS alone, one past a 128-key tile, ...
    (2, 97, None), (2, 1025, None),  # fixed_length: false at 1.9 s and 20.5 s (1 + 8 * frames / 16)
])
def test_flash_kernel_at_the_eat_shapes(gen, b, t, lengths):
    """K1 at EAT-base's attention: 12 heads, D = 64, non-causal, so 128-key
    tiles and 128-row units, of which T = 513 fills the last with one key
    and one row; right-padded key masks as ``ViTEncoder`` builds them.
    Within 2e-2 abs of the f32 twin, lse within 1e-3 on every row."""
    h, d = 12, 64
    plan = tflash.plan_flash(b, t, t, h, h, d, False, False).fwd
    assert (plan.tile, plan.positions) == (128, 128)
    q, k, v = _qkv(b, t, h, h, d, gen)
    mask = torch.ones(b, t, dtype=torch.int32, device="cuda")
    for i, n in enumerate(lengths or ()):
        mask[i, n:] = 0
    before = tflash.flash_attention_fwd.launches
    out, lse = tflash.flash_attention_fwd(q, k, v, mask, False)
    assert tflash.flash_attention_fwd.launches == before + 1
    ref, ref_lse = tflash.flash_attention_ref(q.float(), k.float(), v.float(), mask, False)
    assert (out.float() - ref).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3


def test_eat_block_matches_its_cpu_twin(gen):
    """One whole EAT-base block (pre-LN, q / k / v / proj with bias, K1,
    the exact-GELU MLP) in bf16 on the card against the same block in f32
    on the CPU plain path, ragged key masks: cosine >= 0.999 at every token,
    one K1 launch."""
    from slam_llm_tpu_torch.models.vit import VIT_PRESETS, ViTBlock
    from slam_llm_tpu_torch.pipeline.common import init_params_

    cfg = VIT_PRESETS["eat-base"]()
    blk = init_params_(ViTBlock(cfg, device="cuda").eval(), gen)
    with torch.no_grad():
        for mod in blk.modules():  # biases and norms away from 0 / 1
            for name in ("bias", "scale"):
                t = getattr(mod, name, None)
                if isinstance(t, torch.Tensor):
                    t.add_(0.1 * torch.randn(t.shape, generator=gen, device="cuda").to(t.dtype))
    x = torch.randn(4, 513, cfg.d_model, generator=gen, device="cuda").bfloat16()
    mask = torch.ones(4, 513, dtype=torch.int32, device="cuda")
    for i, n in enumerate((513, 401, 129, 1)):
        mask[i, n:] = 0
    before = tflash.flash_attention_fwd.launches
    with torch.no_grad():
        out = blk(x, mask)
    assert tflash.flash_attention_fwd.launches == before + 1
    cpu = ViTBlock(dataclasses.replace(cfg, dtype=torch.float32)).eval()
    cpu.load_state_dict({k: v.float().cpu() for k, v in blk.state_dict().items()})
    with torch.no_grad():
        ref = cpu(x.float().cpu(), mask.cpu())
    cos = torch.nn.functional.cosine_similarity(out.float().cpu(), ref, dim=-1)
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all()) and cos.min().item() >= 0.999


def test_flash_kernel_strided_cross_attention(gen):
    """Non-causal Tq != Tk on views of fused projections (q from a (B, T, 3,
    H, D) tensor, k / v from a (B, T, 2, Hkv, D) one): the tensor maps take
    the model's strides; G = 4."""
    qkv = torch.randn(2, 70, 3, 8, 64, generator=gen, device="cuda").bfloat16()
    kv = torch.randn(2, 449, 2, 2, 64, generator=gen, device="cuda").bfloat16()
    q, k, v = qkv[:, :, 0], kv[:, :, 0], kv[:, :, 1]
    mask = torch.ones(2, 449, dtype=torch.int32, device="cuda")
    mask[1, 300:] = 0
    out, lse = tflash.flash_attention_fwd(q, k, v, mask)
    ref, ref_lse = tflash.flash_attention_ref(q.float(), k.float(), v.float(), mask)
    assert (out.float() - ref).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3


def test_flash_row_with_every_key_masked(gen):
    """A batch row whose keys are all masked: its outputs are exactly 0, its
    dq exactly 0, and its dk / dv exactly 0 (no pair of it is valid)."""
    q, k, v = _qkv(2, 130, 8, 2, 64, gen)
    dout = torch.randn_like(q)
    mask = torch.ones(2, 130, dtype=torch.int32, device="cuda")
    mask[0] = 0
    for causal in (False, True):
        out, lse = tflash.flash_attention_fwd(q, k, v, mask, causal)
        dq, dk, dv = tflash.flash_attention_bwd(q, k, v, mask, out, lse, dout, causal)
        assert bool((out[0] == 0).all()) and bool((dq[0] == 0).all())
        assert bool((dk[0] == 0).all()) and bool((dv[0] == 0).all())
        ref, _ = tflash.flash_attention_ref(q.float(), k.float(), v.float(), mask, causal)
        assert (out[1].float() - ref[1]).abs().max().item() <= 2e-2


def test_flash_kernel_cross_attention_and_routing(gen):
    """Non-causal Tq != Tk runs the kernel; ``mha_attention`` keeps a dense
    bias and end-aligned causal Tq != Tk on the plain path."""
    from slam_llm_tpu_torch.models import layers

    q = torch.randn(2, 70, 4, 64, generator=gen, device="cuda").bfloat16()
    k = torch.randn(2, 200, 2, 64, generator=gen, device="cuda").bfloat16()
    mask = torch.ones(2, 200, dtype=torch.int32, device="cuda")
    mask[1, 150:] = 0
    out, _ = tflash.flash_attention_fwd(q, k, k, mask)
    ref, _ = tflash.flash_attention_ref(q.float(), k.float(), k.float(), mask)
    assert (out.float() - ref).abs().max().item() <= 2e-2
    before = tflash.flash_attention_fwd.launches
    got = layers.mha_attention(q, k, k, kv_mask=mask, causal=True)
    want = layers._xla_attention(q, k, k, None, kv_mask=mask, causal=True)
    assert torch.equal(got, want) and tflash.flash_attention_fwd.launches == before
    bias = layers.make_padding_bias(mask, 70)
    assert torch.equal(layers.mha_attention(q, k, k, bias=bias), layers._xla_attention(q, k, k, bias))
    assert tflash.flash_attention_fwd.launches == before


def test_flash_kernel_refuses_what_it_cannot_take(gen):
    """head_dim outside {64, 128} in either route; mixed or half dtypes;
    fused RoPE on the f32 routes, forward and backward; K4's f32 route on
    Tq != Tk."""
    q = torch.randn(1, 64, 2, 32, generator=gen, device="cuda").bfloat16()
    mask = torch.ones(1, 64, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        tflash.flash_attention_fwd(q, q, q, mask)
    with pytest.raises(ValueError, match="head_dim"):
        tflash.flash_attention_fwd(q.float(), q.float(), q.float(), mask)
    q64 = torch.randn(1, 64, 2, 64, generator=gen, device="cuda")
    with pytest.raises(TypeError, match="bfloat16"):
        tflash.flash_attention_fwd(q64, q64.bfloat16(), q64.bfloat16(), mask)
    with pytest.raises(TypeError, match="bfloat16"):
        tflash.flash_attention_fwd(q64.half(), q64.half(), q64.half(), mask)
    rope = tuple(torch.zeros(1, 64, 32, device="cuda") for _ in range(2))
    with pytest.raises(NotImplementedError, match="fused RoPE"):
        tflash.flash_attention_fwd(q64, q64, q64, mask, rope=rope)
    out, lse = tflash.flash_attention_fwd(q64, q64, q64, mask)
    with pytest.raises(NotImplementedError, match="fused RoPE"):
        tflash.flash_attention_bwd(q64, q64, q64, mask, out, lse, out, rope=rope)
    x = q64.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="fused RoPE"):
        tflash.flash_attention(x, x, x, mask, rope=rope).sum().backward()
    k_long = torch.randn(1, 80, 2, 64, generator=gen, device="cuda")
    mask_long = torch.ones(1, 80, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="self-attention"):
        tflash.flash_attention_bwd_f32(q64, k_long, k_long, mask_long, out, lse, out)


def _f32_mask(b, t, pad):
    mask = torch.ones(b, t, dtype=torch.int32, device="cuda")
    if pad == "ragged":  # right-padded to ragged lengths, one row with a single key, one with none
        for i in range(b):
            mask[i, [t, t - 63, t // 2, 65, 1, 0, t - 1, 64][i % 8]:] = 0
    return mask


@pytest.mark.parametrize("b,t,h,hkv,d,causal,pad", [
    (16, 515, 12, 12, 64, False, "none"),  # SpatialAST-base: 3 CLS + 512 patches, a training batch
    (8, 515, 12, 12, 64, False, "none"),  # its decode batch
    (8, 515, 12, 12, 64, False, "ragged"),
    (4, 515, 12, 12, 64, True, "ragged"),
    (2, 200, 8, 2, 128, True, "ragged"),  # GQA, head_dim 128
    (3, 70, 4, 1, 64, False, "ragged"),
    (2, 1, 4, 4, 64, True, "none"),
    # the edges of the 128-row blocks and 64-key tiles (D = 64), of the
    # 64-row blocks and 32-key tiles (D = 128), and a single query / key
    (2, 127, 4, 4, 64, True, "ragged"),
    (2, 128, 4, 2, 64, False, "ragged"),
    (2, 129, 4, 4, 64, True, "none"),
    (3, 1, 4, 4, 64, False, "none"),
    (2, 129, 4, 4, 128, False, "ragged"),
    (2, 97, 6, 3, 128, True, "ragged"),
    (2, 1, 2, 1, 128, False, "none"),
])
def test_flash_f32_kernel_matches_twin(gen, b, t, h, hkv, d, causal, pad):
    """K1's f32 route against the f32 twin on the same f32 unit-normal
    inputs: out within 2e-5 abs (single-pass TF32 would miss by ~50x),
    lse within 1e-4 on live rows, rows with no visible key exactly 0; one
    launch on the f32 route's count and none on the bf16 kernel's."""
    q, k, v = (torch.randn(b, t, n, d, generator=gen, device="cuda") for n in (h, hkv, hkv))
    mask = _f32_mask(b, t, pad)
    before = tflash.flash_attention_fwd_f32.launches, tflash.flash_attention_fwd.launches
    out, lse = tflash.flash_attention_fwd(q, k, v, mask, causal)
    torch.cuda.synchronize()
    assert (tflash.flash_attention_fwd_f32.launches, tflash.flash_attention_fwd.launches) == (before[0] + 1,
                                                                                                before[1])
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    ref, ref_lse = tflash.flash_attention_ref(q, k, v, mask, causal)
    live = mask.cumsum(1) > 0 if causal else (mask.sum(1, keepdim=True) > 0).expand(b, t)
    assert (out - ref).abs().max().item() <= 2e-5
    assert (lse - ref_lse)[live].abs().max().item() <= 1e-4
    assert bool((out[~live] == 0).all())


def test_flash_f32_kernel_strided_views(gen):
    """f32 q from a fused (B, T, 3, H, D) projection and k / v from a (B, T,
    2, Hkv, D) one, Tq != Tk: the kernel takes the model's strides."""
    qkv = torch.randn(2, 70, 3, 8, 64, generator=gen, device="cuda")
    kv = torch.randn(2, 449, 2, 2, 64, generator=gen, device="cuda")
    q, k, v = qkv[:, :, 0], kv[:, :, 0], kv[:, :, 1]
    mask = torch.ones(2, 449, dtype=torch.int32, device="cuda")
    mask[1, 300:] = 0
    out, lse = tflash.flash_attention_fwd(q, k, v, mask)
    ref, ref_lse = tflash.flash_attention_ref(q, k, v, mask)
    assert (out - ref).abs().max().item() <= 2e-5
    assert (lse - ref_lse).abs().max().item() <= 1e-4


def _bwd_f32_close(got, want, q, k, v, dout):
    """Each of dq, dk, dv within 2e-5 of the twin's largest entry (at T = 1,
    dq and dk within 2e-5 of the cancellation's scale: ``bwd_f32_error``)."""
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
    assert tflash.bwd_f32_error(got, want, q, k, v, dout) <= 2e-5


@pytest.mark.parametrize("b,t,h,hkv,d,causal,pad", [
    (16, 515, 12, 12, 64, False, "none"),  # Spatial-AST-base's training batch: 3 CLS + 512 patches
    (8, 515, 12, 12, 64, False, "ragged"),
    (4, 515, 12, 12, 64, True, "ragged"),
    (2, 256, 8, 2, 128, True, "ragged"),  # GQA, head_dim 128
    (2, 200, 12, 4, 128, False, "none"),
    (8, 70, 4, 1, 64, False, "ragged"),  # MQA, a row with one key, a row with none
    (2, 2, 4, 4, 64, True, "none"),  # query 0 sees key 0 alone: its dS is round-off
    (9, 64, 6, 3, 64, True, "ragged"),  # one tile exactly
    # the edges of the 128-row dq blocks, 64-key dk / dv blocks and 32-key /
    # 32-query tiles (D = 64), of the 64-row blocks and 16-query tiles
    # (D = 128), and a single position
    (2, 127, 4, 4, 64, True, "ragged"),
    (2, 128, 4, 2, 64, False, "ragged"),
    (2, 129, 4, 4, 64, True, "none"),
    (3, 1, 4, 4, 64, False, "none"),
    (2, 129, 4, 4, 128, False, "ragged"),
    (3, 97, 6, 3, 128, True, "ragged"),
    (2, 1, 2, 1, 128, True, "none"),
])
def test_flash_bwd_f32_kernel_matches_twin(gen, b, t, h, hkv, d, causal, pad):
    """K4's f32 route against the f32 twin on K1 f32's out / lse: dq, dk, dv
    each within 2e-5 of the twin's largest entry, dq exactly 0 on rows with
    no visible key, the same bits on a second run (no atomics), one launch
    on the f32 route's count and none on the bf16 kernel's."""
    q, k, v = (torch.randn(b, t, n, d, generator=gen, device="cuda") for n in (h, hkv, hkv))
    dout = torch.randn(b, t, h, d, generator=gen, device="cuda")
    mask = _f32_mask(b, t, pad)
    out, lse = tflash.flash_attention_fwd(q, k, v, mask, causal)
    before = tflash.flash_attention_bwd_f32.launches, tflash.flash_attention_bwd.launches
    got = tflash.flash_attention_bwd(q, k, v, mask, out, lse, dout, causal)
    torch.cuda.synchronize()
    assert (tflash.flash_attention_bwd_f32.launches, tflash.flash_attention_bwd.launches) == (before[0] + 1,
                                                                                              before[1])
    want = tflash.flash_attention_bwd_ref(q, k, v, mask, out, lse, dout, causal)
    _bwd_f32_close(got, want, q, k, v, dout)
    live = mask.cumsum(1) > 0 if causal else (mask.sum(1, keepdim=True) > 0).expand(b, t)
    assert bool((got[0][~live] == 0).all())
    again = tflash.flash_attention_bwd(q, k, v, mask, out, lse, dout, causal)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def test_flash_bwd_f32_kernel_strided_views(gen):
    """q / k / v as views of one fused (B, T, 3, H, D) projection and dout
    as a (B, H, T, D) tensor's transpose: the kernel takes their strides."""
    qkv = torch.randn(2, 130, 3, 8, 64, generator=gen, device="cuda")
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    dout = torch.randn(2, 8, 130, 64, generator=gen, device="cuda").transpose(1, 2)
    mask = _f32_mask(2, 130, "ragged")
    out, lse = tflash.flash_attention_fwd(q, k, v, mask)
    got = tflash.flash_attention_bwd_f32(q, k, v, mask, out, lse, dout)
    _bwd_f32_close(got, tflash.flash_attention_bwd_ref(q, k, v, mask, out, lse, dout), q, k, v, dout)


def test_flash_f32_autograd_runs_both_f32_routes(gen):
    """``flash_attention`` on f32 leaves: K1 f32 forward, K4 f32 backward,
    each once, no bf16 launch; the gradients within 2e-5 of the twins'."""
    q, k, v = (torch.randn(2, 515, n, 64, generator=gen, device="cuda").requires_grad_() for n in (12, 12, 12))
    w = torch.randn(2, 515, 12, 64, generator=gen, device="cuda")
    mask = _f32_mask(2, 515, "none")
    counts = (tflash.flash_attention_fwd_f32, tflash.flash_attention_bwd_f32, tflash.flash_attention_fwd,
              tflash.flash_attention_bwd)
    before = [c.launches for c in counts]
    (tflash.flash_attention(q, k, v, mask) * w).sum().backward()
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counts, before)] == [1, 1, 0, 0]
    grads, (q, k, v) = (q.grad, k.grad, v.grad), (q.detach(), k.detach(), v.detach())
    out, lse = tflash.flash_attention_ref(q, k, v, mask)
    _bwd_f32_close(grads, tflash.flash_attention_bwd_ref(q, k, v, mask, out, lse, w), q, k, v, w)


@pytest.mark.parametrize("b,t,h,pad", [
    (16, 251, 16, "ragged"), (8, 251, 16, "none"),  # MusicFM-MSD: 10 s of 24 kHz mel -> 251 frames
    (16, 64, 12, "none"), (8, 64, 12, "none"),  # the Q-Former's self-attention over 64 queries
])
def test_flash_kernel_at_the_music_and_qformer_shapes(gen, b, t, h, pad):
    """K1 (bf16) at MusicFM's attention (a key mask zeroing the frames past
    a short clip) and the 64-query Q-Former's: within 2e-2 of the f32 twin,
    lse within 1e-3 on live rows."""
    q, k, v = _qkv(b, t, h, h, 64, gen)
    mask = _f32_mask(b, t, pad)
    out, lse = tflash.flash_attention_fwd(q, k, v, mask, False)
    ref, ref_lse = tflash.flash_attention_ref(q.float(), k.float(), v.float(), mask, False)
    live = (mask.sum(1, keepdim=True) > 0).expand(b, t)
    assert (out.float() - ref).abs().max().item() <= 2e-2
    assert (lse - ref_lse)[live].abs().max().item() <= 1e-3


# K2 at M in {1, 5, 32, 300, 8192}: decode, ragged and training rows
K2_M = (1, 5, 32, 300, 8192)


def _k2_rows(m, k, gen, scale, dtype=torch.bfloat16):
    """Random rows, the first of them replaced by the adversarial ones:
    exact .5 ties (amax 127 x 2^-3, so s = 2^-3 and x / s = n + 0.5), values
    down to bf16's subnormals beside a scale of 1 (the division's slow
    branch), an all-zero row, a row whose amax is below the 1e-28 floor, and
    one outlier beside tiny values."""
    x = torch.randn(m, k, generator=gen, device="cuda") * scale
    ties = (torch.arange(k, device="cuda").remainder(254) - 127).float() + 0.5
    special = [torch.where(torch.arange(k, device="cuda") == 0, 127.0, ties) * 0.125]
    tiny = torch.tensor([2.0 ** -126, -2.0 ** -130, 2.0 ** -133, 1e-30, -3.5e-31], device="cuda")
    row = tiny.repeat(-(-k // 5))[:k].clone()
    row[1] = 127.0
    special.append(row)
    special.append(torch.zeros(k, device="cuda"))
    special.append(torch.randn(k, generator=gen, device="cuda") * 1e-30)
    row = torch.randn(k, generator=gen, device="cuda") * 1e-3
    row[k // 2] = 300.0
    special.append(row)
    for i, r in enumerate(special[:m]):
        x[i] = r
    return x.to(dtype)


@pytest.mark.parametrize("m", K2_M)
@pytest.mark.parametrize("k", [2048, 5632, 256, 2056, 104, 4096, 11008])  # 4096 / 11008: vicuna-7b's rows
def test_rowquant_kernel_bit_exact(gen, m, k):
    """bf16 in, bit-exact with the adversarial rows; f32 input and
    K % 8 != 0 are refused."""
    x = _k2_rows(m, k, gen, 3.0)
    q, s = trowquant.rowquant(x)
    rq, rs = trowquant.rowquant_ref(x)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    with pytest.raises(TypeError, match="bfloat16"):
        trowquant.rowquant(x.float())
    with pytest.raises(ValueError, match="K % 8"):
        trowquant.rowquant(x[:, :-4].contiguous())


def test_rowquant_kernel_division_is_correctly_rounded(gen):
    """The reciprocal-and-FMA quotient against a true division over scales
    from the 1e-28 floor to 1e30 and quotients from 2^-130 up: 8192 rows of
    2048, each row's amax set, the other values spread over 40 binades."""
    m, k = 8192, 2048
    amax = torch.exp2(torch.empty(m, device="cuda").uniform_(-100, 100, generator=gen))
    mag = torch.exp2(torch.empty(m, k, device="cuda").uniform_(-40, 0, generator=gen))
    sign = torch.randint(0, 2, (m, k), generator=gen, device="cuda").float() * 2 - 1
    x = (sign * mag * amax[:, None]).bfloat16()
    x[:, 0] = amax.bfloat16()
    q, s = trowquant.rowquant(x)
    rq, rs = trowquant.rowquant_ref(x)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    q, s = trowquant.rowquant(x, seed=5)
    rq, rs = trowquant.rowquant_ref(x, seed=5)
    assert torch.equal(q, rq) and torch.equal(s, rs)


def test_rowquant_plans_every_width(gen):
    """Other plans than the planner's (rows per group, threads, units per
    thread) run bit-exact, and a plan the kernel cannot take is refused."""
    x = _k2_rows(300, 2048, gen, 1.0)
    rq, rs = trowquant.rowquant_ref(x)
    for threads, rows, units in ((256, 1, 1), (128, 1, 2), (256, 4, 4), (512, 8, 4), (32, 1, 8), (128, 2, 4)):
        plan = trowquant.RowquantPlan(threads, rows, units, False)
        q, s = trowquant._launch(x, None, None, False, plan)
        assert torch.equal(q, rq) and torch.equal(s, rs), plan
    with pytest.raises(RuntimeError, match="CUDA error"):
        trowquant._launch(x, None, None, False, trowquant.RowquantPlan(256, 4, 1, False))


@pytest.mark.parametrize("m", [1, 8, 32, 4096])
@pytest.mark.parametrize("k,f", [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048), (48, 40)])
def test_int8_matmul_kernel_matches_twin(gen, m, k, f):
    """Bit-exact against the f64 twin, or at most one bf16 ulp; the f32
    epilogue (counted on its own) bit-exact; other output types refused."""
    xq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    wq = torch.randint(-127, 128, (f, k), generator=gen, device="cuda", dtype=torch.int8)
    xs = torch.rand(m, generator=gen, device="cuda") * 0.05
    ws = torch.rand(f, generator=gen, device="cuda") * 0.01
    out = tquant.int8_matmul(xq, wq, xs, ws, torch.bfloat16)
    ref = tquant.int8_matmul_ref(xq, wq, xs, ws, torch.bfloat16)
    assert (out.view(torch.int16).int() - ref.view(torch.int16).int()).abs().max().item() <= 1
    before = tquant.int8_matmul_f32.launches
    out32 = tquant.int8_matmul(xq, wq, xs, ws, torch.float32)
    assert tquant.int8_matmul_f32.launches == before + 1
    assert torch.equal(out32, tquant.int8_matmul_ref(xq, wq, xs, ws, torch.float32))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        tquant.int8_matmul(xq, wq, xs, ws, torch.float16)


K3_BOUNDARY = [(m, 48, 40) for m in (1, 16, 17, 64, 65, 127, 128)] + [(129, 2064, 264), (300, 5632, 2048)]
K3_RECIPE = [(m, kc, n) for m in (8, 32, 4096) for kc, n in ((2048, 2048), (2048, 256), (2048, 5632), (5632, 2048))]
K3_RECIPE += [(8192, 256, 2048), (1024, 32000, 2048), (1024, 2048, 32000)]
# one utterance's int8 CE head dx (a chunk of 64 rows, K = 32000) and a
# 33-127 row tile with long K: split counts whose owners hold uneven rows
K3_RECIPE += [(64, 32000, 2048), (100, 5632, 2048)]
# vicuna-7b's int8 base (asr_wavlm_vicuna): q / k / v / o, gate / up and down
# at decode M, prefill M and a training M that is not a multiple of 128
K3_RECIPE += [(m, kc, n) for m in (8, 32, 4096, 3000) for kc, n in ((4096, 4096), (4096, 11008), (11008, 4096))]


@pytest.mark.parametrize("m,k,f", K3_BOUNDARY + K3_RECIPE)
def test_int8_matmul_paths_exact_and_deterministic(gen, m, k, f):
    """K3 at the planner's path boundaries and the recipe's shapes, and every
    split count its path allows there: f32 bit-exact against the f64 twin,
    bf16 within one ulp, two runs bit-identical; each launch counted on the
    path the plan names."""
    xq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    wq = torch.randint(-127, 128, (f, k), generator=gen, device="cuda", dtype=torch.int8)
    xs = torch.rand(m, generator=gen, device="cuda") * 0.05 + 1e-3
    ws = torch.rand(f, generator=gen, device="cuda") * 0.01 + 1e-4
    ref16 = tquant.int8_matmul_ref(xq, wq, xs, ws, torch.bfloat16)
    ref32 = tquant.int8_matmul_ref(xq, wq, xs, ws, torch.float32)
    plan = tquant.plan_int8_matmul(m, f, k, torch.cuda.get_device_properties(0).multi_processor_count)
    assert plan.path == ("wgmma" if m >= 128 else "splitk")
    slices = -(-k // tquant.K_SLICE)
    cap = tquant.SPLITK_MAX_SPLITS if plan.path == "splitk" else 2
    for splits in sorted({plan.splits} | {d for d in range(1, cap + 1) if slices % d == 0}):
        alt = tquant.Int8Plan(plan.path, plan.tile, splits)
        before = tquant.K3_PATHS[plan.path].launches
        out = tquant.int8_matmul(xq, wq, xs, ws, torch.bfloat16, plan=alt)
        again = tquant.int8_matmul(xq, wq, xs, ws, torch.bfloat16, plan=alt)
        out32 = tquant.int8_matmul(xq, wq, xs, ws, torch.float32, plan=alt)
        assert tquant.K3_PATHS[plan.path].launches == before + 3
        assert (out.view(torch.int16).int() - ref16.view(torch.int16).int()).abs().max().item() <= 1, alt
        assert torch.equal(out, again) and torch.equal(out32, ref32), alt


def test_int8_matmul_refuses_a_plan_the_kernel_cannot_take(gen):
    xq = torch.randint(-127, 128, (32, 2048), generator=gen, device="cuda", dtype=torch.int8)
    wq = torch.randint(-127, 128, (256, 2048), generator=gen, device="cuda", dtype=torch.int8)
    xs, ws = torch.rand(32, device="cuda"), torch.rand(256, device="cuda")
    for bad in (tquant.Int8Plan("splitk", (32, 64, 128), 3), tquant.Int8Plan("wgmma", (64, 256, 128), 1)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            tquant.int8_matmul(xq, wq, xs, ws, plan=bad)


@pytest.mark.parametrize("m,k,f", [(1024, 2048, 32000), (1024, 32000, 2048), (512, 5632, 2048)])
def test_int8_matmul_head_and_transposed_dx_shapes(gen, m, k, f):
    """The int8 CE head's f32 logits and its int8_sr dx (K = 32000), and a
    transposed-weight dx: bit-exact against the f64 twin."""
    xq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    wq = torch.randint(-127, 128, (f, k), generator=gen, device="cuda", dtype=torch.int8)
    xs = torch.rand(m, generator=gen, device="cuda") * 0.05
    ws = torch.rand(f, generator=gen, device="cuda") * 0.01
    for dt in (torch.float32, torch.bfloat16):
        assert torch.equal(tquant.int8_matmul(xq, wq, xs, ws, dt), tquant.int8_matmul_ref(xq, wq, xs, ws, dt))


K2_FOLD = [(m, k, torch.bfloat16) for m in K2_M for k in (2048, 5632, 256, 2056)]
K2_FOLD += [(m, k, torch.float32) for m in (1, 5, 32, 300, 1024) for k in (32000, 44, 2048)]


@pytest.mark.parametrize("m,k,dtype", K2_FOLD)
@pytest.mark.parametrize("seed", [None, 31])
def test_rowquant_fold_kernel_bit_exact(gen, m, k, dtype, seed):
    """K2's fold kernels (deterministic and stochastic rounding; bf16 dy and
    the f32 dlog of the int8 CE head) bit-exact against the twin, with the
    adversarial rows (a unit fold keeps their ties exact) and random folds;
    counted on their own; a fold that is not a contiguous f32 (K,) vector,
    K % 8 != 0 for bf16 and fold with rotate are refused."""
    x = _k2_rows(m, k, gen, 0.3, dtype)
    for fold in (torch.ones(k, device="cuda"), torch.rand(k, generator=gen, device="cuda") * 0.02 + 1e-4):
        before = trowquant.rowquant_fold.launches
        q, s = trowquant.rowquant(x, fold, seed=seed)
        assert trowquant.rowquant_fold.launches == before + 1
        rq, rs = trowquant.rowquant_ref(x, fold, seed=seed)
        assert torch.equal(s, rs) and torch.equal(q, rq)
    with pytest.raises(ValueError, match="fold"):
        trowquant.rowquant(x, fold.double(), seed=seed)
    with pytest.raises(ValueError, match="mutually exclusive"):
        trowquant.rowquant(x, fold, rotate=True)
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError, match="K % 8"):
            trowquant.rowquant(x[:, :-4].contiguous(), fold[:-4].contiguous(), seed=seed)


def test_small_slice_on_card_matches_cpu_plain_path(gen):
    """A narrow sandwich with 64-wide heads (the flash kernel's width): the
    card's prefill logits (K1, K2, K3) keep a cosine >= 0.99 with the CPU
    plain path on the same bf16 weights, and every kernel launched."""
    from slam_llm_tpu_torch.models.llm import LLMConfig, init_kv_cache
    from slam_llm_tpu_torch.models.projector import ProjectorConfig
    from slam_llm_tpu_torch.models.slam_model import SLAMConfig, SLAMModel
    from slam_llm_tpu_torch.models.whisper import WhisperEncoderConfig
    from slam_llm_tpu_torch.pipeline.common import init_params_

    llm = dataclasses.replace(LLMConfig.tiny_test(vocab_size=300), d_model=256, n_heads=4,
                              n_kv_heads=2, head_dim=64, ffn_dim=512, lora_rank=8, base_quant="int8")
    cfg = SLAMConfig(llm=llm, encoder=WhisperEncoderConfig(80, 128, 2, 2, 100),
                     projector_cfg=ProjectorConfig(encoder_dim=128, llm_dim=256, hidden_dim=256))
    model = init_params_(SLAMModel(cfg, device="cuda").eval(), gen)
    for mod in model.modules():  # nonzero LoRA B, so the LoRA branch counts
        if getattr(mod, "lora_rank", 0):
            mod.lora_b.normal_(0, 0.05, generator=gen)
    b, t, n_audio = 2, 40, 20
    ids = torch.randint(3, 250, (b, t), generator=gen, device="cuda")
    ids[:, :n_audio] = -1
    modality = torch.zeros(b, t, dtype=torch.int32, device="cuda")
    modality[:, :n_audio] = 1
    batch = {"input_ids": ids, "attention_mask": torch.ones(b, t, dtype=torch.int32, device="cuda"),
             "modality_mask": modality,
             "audio_mel": torch.randn(b, 200, 80, generator=gen, device="cuda"),
             "audio_mel_mask": torch.ones(b, 200, dtype=torch.int32, device="cuda")}
    counters = (tflash.flash_attention_fwd, trowquant.rowquant, tquant.int8_matmul)
    before = [fn.launches for fn in counters]
    with torch.inference_mode():
        gpu, _ = model.prefill(batch, init_kv_cache(llm, b, t + 1, gen_start=t, device="cuda"))
        torch.cuda.synchronize()
        assert all(fn.launches > n for fn, n in zip(counters, before))
        model = model.to("cpu")
        cpu, _ = model.prefill({k: v.cpu() for k, v in batch.items()}, init_kv_cache(llm, b, t + 1, gen_start=t))
    cos = torch.nn.functional.cosine_similarity(gpu.cpu().flatten(0, 1), cpu.flatten(0, 1), dim=-1)
    assert bool(torch.isfinite(gpu).all()) and cos.min().item() >= 0.99


# ---- training-path kernels: K1 + fused RoPE, K4, K2 rotate / SR ------------


def _rope(b, t, gen, left_pad=None, d=64, theta=10000.0):
    from slam_llm_tpu_torch.models.layers import rope_tables

    mask = torch.ones(b, t, dtype=torch.int32, device="cuda")
    if left_pad is not None:
        for i, n in enumerate(left_pad):
            mask[i, :n] = 0
    pos = (mask.long().cumsum(1) - 1).clamp_min(0)
    return mask, rope_tables(pos, d, theta)


def _qkv(b, t, h, hkv, d, gen):
    return [torch.randn(b, t, n, d, generator=gen, device="cuda").bfloat16() for n in (h, hkv, hkv)]


@pytest.mark.parametrize("b,t,h,hkv", [(2, 70, 4, 1), (16, 512, 32, 4)])
def test_flash_fused_rope_matches_rotate_then_twin(gen, b, t, h, hkv):
    """K1 with fused RoPE against apply_rope_tables (f32 rotation, one bf16
    rounding: the kernel's numerics) then the f32 twin: out within 2e-2,
    live-row lse within 1e-3, left-padded dead rows exactly 0."""
    _check_fused_rope(gen, b, t, h, hkv, 64, 10000.0)


@pytest.mark.parametrize("t", [449, 130])
def test_flash_fused_rope_at_qwen2_heads(gen, t):
    """The same check at qwen2-7b's attention: 28 query heads over 4 kv heads
    (G = 7: 7 heads x 18 positions fill 126 of a unit's 128 rows, and a
    unit's 18 positions straddle the 64-key tiles), head_dim 128, RoPE at
    theta 1e6, rows left-padded."""
    _check_fused_rope(gen, 2, t, 28, 4, 128, 1e6)


def _check_fused_rope(gen, b, t, h, hkv, d, theta):
    q, k, v = _qkv(b, t, h, hkv, d, gen)
    mask, rope = _rope(b, t, gen, left_pad=[(i * 37) % (t // 3) for i in range(b)], d=d, theta=theta)
    out, lse = tflash.flash_attention_fwd(q, k, v, mask, True, rope=rope)
    qr, kr = (tflash.apply_rope_tables(x, *rope) for x in (q, k))
    ref, ref_lse = tflash.flash_attention_ref(qr.float(), kr.float(), v.float(), mask, True)
    live = mask.cumsum(1) > 0
    assert (out.float() - ref).abs().max().item() <= 2e-2
    assert (lse - ref_lse)[live].abs().max().item() <= 1e-3
    assert bool((out[~live] == 0).all())


def _bwd_twin_f32(q, k, v, mask, out, lse, dout, causal, rope):
    """The f32 twin of K4 on the kernel's own inputs: q / k rotated in bf16
    as the kernel rotates them, then f32 throughout, dq / dk counter-rotated
    in f32."""
    if rope is not None:
        q, k = (tflash.apply_rope_tables(x, *rope) for x in (q, k))
    dq, dk, dv = tflash.flash_attention_bwd_ref(q.float(), k.float(), v.float(), mask, out.float(), lse,
                                                dout.float(), causal)
    if rope is not None:
        dq, dk = (tflash.apply_rope_tables(x, *rope, inverse=True) for x in (dq, dk))
    return dq, dk, dv


def _rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


@pytest.mark.parametrize("b,t,h,hkv,d,causal,rope,pad", [
    (2, 130, 4, 2, 64, True, True, "left"),
    (16, 512, 32, 4, 64, True, True, "both"),  # the training path's shape
    (2, 1500, 12, 12, 64, False, False, "right"),  # whisper-small
    (2, 256, 8, 8, 128, True, False, "left"),
    (2, 449, 8, 2, 64, True, True, "left"),  # G = 4, ragged T
    (2, 70, 8, 8, 128, False, False, "right"),
    (2, 1500, 16, 2, 64, True, True, "both"),  # G = 8 at whisper's T
    (3, 130, 4, 2, 128, True, True, "left"),
])
def test_flash_backward_kernel_matches_twin(gen, b, t, h, hkv, d, causal, rope, pad):
    """K4 dq / dk / dv within 2e-2 relative L2 of the f32 twin (the kernel
    rounds P and dS to bf16 for its products); dead rows' dq exactly 0;
    two runs bit-identical (no atomics)."""
    _check_flash_backward(gen, b, t, h, hkv, d, causal, rope, pad, 10000.0)


@pytest.mark.parametrize("b,t,h,hkv,d,causal,rope,pad", [
    (2, 449, 28, 4, 128, True, True, "left"),  # qwen2-7b: G = 7, head_dim 128
    (2, 130, 28, 4, 128, True, True, "both"),
    (2, 80, 12, 12, 64, False, False, "right"),  # the Q-Former's self-attention
    (16, 64, 12, 12, 64, False, False, "none"),  # the 64-query Q-Former (SELD, SEC)
])
def test_flash_backward_kernel_at_the_st_shapes(gen, b, t, h, hkv, d, causal, rope, pad):
    """The same check at the ST recipe's shapes, RoPE at qwen2's theta 1e6."""
    _check_flash_backward(gen, b, t, h, hkv, d, causal, rope, pad, 1e6)


@pytest.mark.parametrize("b,t,h,hkv,d,causal,rope,pad", [
    (2, 449, 32, 32, 128, True, True, "left"),  # vicuna-7b: 32 / 32 heads, head_dim 128
    (2, 130, 32, 32, 128, True, True, "both"),
])
def test_flash_backward_kernel_at_vicuna_shapes(gen, b, t, h, hkv, d, causal, rope, pad):
    """The same check at vicuna-7b's attention (asr_wavlm_vicuna's training
    step), RoPE at theta 1e4."""
    _check_flash_backward(gen, b, t, h, hkv, d, causal, rope, pad, 1e4)


def _check_flash_backward(gen, b, t, h, hkv, d, causal, rope, pad, theta):
    q, k, v = _qkv(b, t, h, hkv, d, gen)
    dout = torch.randn(b, t, h, d, generator=gen, device="cuda").bfloat16()
    mask = torch.ones(b, t, dtype=torch.int32, device="cuda")
    for i in range(b):
        n = 5 + (i * 37) % (t // 3)
        if pad in ("left", "both"):
            mask[i, :n] = 0
        if pad in ("right", "both"):
            mask[i, t - n // 2:] = 0
    tables = None
    if rope:
        from slam_llm_tpu_torch.models.layers import rope_tables

        tables = rope_tables((mask.long().cumsum(1) - 1).clamp_min(0), d, theta)
    out, lse = tflash.flash_attention_fwd(q, k, v, mask, causal, rope=tables)
    before = tflash.flash_attention_bwd.launches
    got = tflash.flash_attention_bwd(q, k, v, mask, out, lse, dout, causal, rope=tables)
    again = tflash.flash_attention_bwd(q, k, v, mask, out, lse, dout, causal, rope=tables)
    assert tflash.flash_attention_bwd.launches == before + 2
    want = _bwd_twin_f32(q, k, v, mask, out, lse, dout, causal, tables)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        assert _rel_l2(g, w) <= 2e-2
    if causal:
        dead = mask.cumsum(1) == 0
        assert bool((got[0][dead] == 0).all())


def _one_hot_blocks(m, k, gen):
    """Rows whose 256-blocks each hold one value at their first column: the
    rotation spreads c to c / 16 over the block, so a block of 2032 sets
    s = 1 and blocks of 16 (n + 0.5) give exact ties."""
    x = torch.zeros(m, k, device="cuda")
    c = (torch.randint(-127, 127, (m, k // 256), generator=gen, device="cuda").float() + 0.5) * 16
    c[:, 0] = 2032.0
    x[:, ::256] = c
    return x.bfloat16()


@pytest.mark.parametrize("m", K2_M)
@pytest.mark.parametrize("k", [2048, 256, 5632, 512])
@pytest.mark.parametrize("seed,rotate", [(11, True), (None, True), (12, False)])
def test_rowquant_rot_sr_kernel_bit_exact(gen, m, k, seed, rotate):
    """K2's rotate / stochastic-rounding kernel bit-exact against the twin
    (same Philox stream, same butterfly order), with the adversarial rows,
    and rows whose rotation gives exact ties; rotation refuses K % 256 != 0."""
    for x in (_k2_rows(m, k, gen, 0.3), _one_hot_blocks(m, k, gen)):
        before = trowquant.rowquant_rot_sr.launches
        q, s = trowquant.rowquant(x, seed=seed, rotate=rotate)
        assert trowquant.rowquant_rot_sr.launches == before + 1
        rq, rs = trowquant.rowquant_ref(x, seed=seed, rotate=rotate)
        assert torch.equal(s, rs) and torch.equal(q, rq)
    if rotate:
        with pytest.raises(ValueError, match="K % 256"):
            trowquant.rowquant(x[:, :k - 128].contiguous(), seed=seed, rotate=True)


@pytest.mark.parametrize("m", [1, 5, 64])
@pytest.mark.parametrize("seed", [None, 31])
def test_rowquant_fold_long_rows_bit_exact(gen, m, seed):
    """qwen2's int8 CE head dlog, (m, 152064) f32 with a fold: rows longer
    than a block's registers take the kernel's long-row path, bit-exact
    against the twin with the adversarial rows, deterministic and seeded."""
    k = 152064
    assert trowquant.plan_rowquant(m, k, 4, False, True).units == 0
    x = _k2_rows(m, k, gen, 0.3, torch.float32)
    fold = torch.rand(k, generator=gen, device="cuda") * 0.02 + 1e-4
    q, s = trowquant.rowquant(x, fold, seed=seed)
    rq, rs = trowquant.rowquant_ref(x, fold, seed=seed)
    assert torch.equal(s, rs) and torch.equal(q, rq)


@pytest.mark.parametrize("k,rotate,fold", [(33024, False, False), (33024, True, False), (2056, False, False),
                                           (2056, False, True), (512, True, False), (44, False, True)])
@pytest.mark.parametrize("seed", [None, 11])
def test_rowquant_long_row_path_bit_exact(gen, k, rotate, fold, seed):
    """The long-row path under every mode the wrappers take: bf16 rows just
    past MAX_K through the planner, and the path forced on narrow and
    ragged widths (a row shorter than one pass of the block) at 512 and 64
    threads; bit-exact against the twin with the adversarial rows."""
    dtype = torch.float32 if k == 44 else torch.bfloat16
    x = _k2_rows(37, k, gen, 0.3, dtype)
    f = torch.rand(k, generator=gen, device="cuda") * 0.02 + 1e-4 if fold else None
    rq, rs = trowquant.rowquant_ref(x, f, seed=seed, rotate=rotate)
    if k > trowquant.MAX_K:
        q, s = trowquant.rowquant(x, f, seed=seed, rotate=rotate)
        assert torch.equal(s, rs) and torch.equal(q, rq)
    for threads in (512, 64):
        q, s = trowquant._launch(x, f, seed, rotate, trowquant.RowquantPlan(threads, 1, 0, False))
        assert torch.equal(s, rs) and torch.equal(q, rq), threads


@pytest.mark.parametrize("rotate,fold", [(False, False), (True, False), (False, True)])
def test_rowquant_sr_takes_a_true_division_at_a_zero_draw(gen, rotate, fold):
    """Philox keyed 11 draws 0 at row 15289, columns 160-163 (word 0 of
    counter 40), where stochastic rounding is floor(x / s) itself: the
    kernel redoes those four values with div.rn, on the group path and on
    the long-row path. Around that column the row holds tiny values of both
    signs, signed zeros, ties and its amax."""
    m, k = 15290, 256
    x = torch.randn(m, k, generator=gen, device="cuda") * 0.3
    x[-1, 152:168] = torch.tensor([-1e-30, 1e-30, -0.0, 2.5, -2.5, 3e-39, -3e-39, 0.0,
                                   -2.0 ** -133, 2.0 ** -133, -0.0, 127.0, -127.0, 1.0, -1.0, 0.5], device="cuda")
    x = x.bfloat16()
    f = torch.rand(k, generator=gen, device="cuda") + 0.5 if fold else None
    assert float(trowquant.uniform_ref(m, k, 11, "cuda")[-1, 160]) == 0.0
    q, s = trowquant.rowquant(x, f, seed=11, rotate=rotate)
    rq, rs = trowquant.rowquant_ref(x, f, seed=11, rotate=rotate)
    assert torch.equal(s, rs) and torch.equal(q, rq)
    q, s = trowquant._launch(x, f, 11, rotate, trowquant.RowquantPlan(256, 1, 0, False))  # the long-row path
    assert torch.equal(s, rs) and torch.equal(q, rq)


def test_training_step_full_width_on_card(gen):
    """One training step of the recipe's model at full width (whisper-small,
    TinyLlama-1.1B with an int8 base and the int8_rot backward, LoRA r8 on
    q / v), batch 2: finite loss and gradient norm, and every kernel of the
    training path launched (K1, K4, K2 both kernels, K3)."""
    from slam_llm_tpu.config import TrainConfig
    from slam_llm_tpu_torch.models.llm import LLMConfig
    from slam_llm_tpu_torch.models.projector import ProjectorConfig
    from slam_llm_tpu_torch.models.slam_model import SLAMConfig, SLAMModel
    from slam_llm_tpu_torch.models.whisper import WhisperEncoderConfig
    from slam_llm_tpu_torch.pipeline.common import init_params_
    from slam_llm_tpu_torch.train.state import Trainer

    llm = dataclasses.replace(LLMConfig.tinyllama_1_1b(), lora_rank=8, base_quant="int8",
                              base_quant_bwd="int8_rot", lora_dropout=0.05)
    enc = WhisperEncoderConfig.small()
    cfg = SLAMConfig(llm=llm, encoder=enc, projector_cfg=ProjectorConfig(encoder_dim=768, llm_dim=2048))
    model = init_params_(SLAMModel(cfg, device="cuda"), gen)
    tc = TrainConfig()
    tc.use_peft, tc.warmup_steps = True, 2
    trainer = Trainer(model, cfg, tc).state_from_params()
    b, t, n_audio = 2, 448, 300
    ids = torch.randint(3, 32000, (b, t), generator=gen, device="cuda")
    ids[:, :n_audio] = -1
    labels = ids.clone()
    labels[:, :n_audio + 8] = -100
    modality = torch.zeros(b, t, dtype=torch.int32, device="cuda")
    modality[:, :n_audio] = 1
    attn = torch.ones(b, t, dtype=torch.int32, device="cuda")
    attn[1, :20] = 0  # left padding
    batch = {"input_ids": ids, "labels": labels, "attention_mask": attn, "modality_mask": modality,
             "audio_mel": torch.randn(b, 3000, 80, generator=gen, device="cuda"),
             "audio_mel_mask": torch.ones(b, 3000, dtype=torch.int32, device="cuda")}
    counters = (tflash.flash_attention_fwd, tflash.flash_attention_bwd, trowquant.rowquant,
                trowquant.rowquant_rot_sr, tquant.int8_matmul)
    before = [fn.launches for fn in counters]
    for _ in range(2):
        m = trainer.train_step(batch)
    torch.cuda.synchronize()
    assert all(fn.launches > n for fn, n in zip(counters, before))
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"])) and m["lr"] > 0


@pytest.mark.parametrize("policy", ["dots_flash_saveable", "full"])
def test_remat_on_card_is_bit_identical_and_saves_memory(gen, policy):
    """A narrow LLM with 64-wide heads on the card, LoRA dropout 0.05, the
    int8_sr backward and the int8_sr CE head: the loss and every LoRA
    gradient with checkpointing equal those without it bit for bit (K1, K3
    and K4 are deterministic, the replay redraws the dropout mask), the
    replay skips K1 where the policy saved its output, and the peak memory
    of the forward + backward drops."""
    from slam_llm_tpu.config import TrainConfig
    from slam_llm_tpu_torch.models.llm import CausalLM, LLMConfig
    from slam_llm_tpu_torch.ops import quant as q
    from slam_llm_tpu_torch.pipeline.common import init_params_

    def run(remat):
        cfg = dataclasses.replace(LLMConfig.tiny_test(vocab_size=512), d_model=512, n_heads=8, n_kv_heads=2,
                                  head_dim=64, ffn_dim=1024, n_layers=4, lora_rank=8, lora_dropout=0.05,
                                  base_quant="int8", base_quant_bwd="int8_sr", ce_quant="int8_sr",
                                  remat=remat, remat_policy=policy)
        model = init_params_(CausalLM(cfg, device="cuda"), torch.Generator(device="cuda").manual_seed(1))
        with torch.no_grad():
            for mod in model.modules():
                if getattr(mod, "lora_rank", 0):
                    mod.lora_b.normal_(0, 0.05, generator=torch.Generator(device="cuda").manual_seed(2))
        q.quantize_base_params(model)
        drop = torch.Generator(device="cuda").manual_seed(3)
        params = []
        for mod in model.modules():
            if getattr(mod, "lora_rank", 0):
                mod.generator, mod.quant_seed = drop, 77
                params += [mod.lora_a.requires_grad_(True), mod.lora_b.requires_grad_(True)]
            elif getattr(mod, "quant", None) == "int8":
                mod.quant_seed = 78
        model.ce_seed = 79
        model.train()
        g = torch.Generator(device="cuda").manual_seed(4)
        x = torch.randn(8, 256, 512, generator=g, device="cuda").bfloat16().requires_grad_(True)
        mask = torch.ones(8, 256, dtype=torch.int32, device="cuda")
        mask[1, :30] = 0
        labels = torch.randint(0, 512, (8, 256), generator=g, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        k1 = tflash.flash_attention_fwd.launches
        loss, _ = model.loss_and_accuracy(x, mask, labels)
        grads = torch.autograd.grad(loss, params + [x])
        torch.cuda.synchronize()
        return loss.detach(), grads, torch.cuda.max_memory_allocated() - base, tflash.flash_attention_fwd.launches - k1

    loss_off, grads_off, peak_off, k1_off = run(False)
    loss_on, grads_on, peak_on, k1_on = run(True)
    assert torch.equal(loss_on, loss_off) and all(torch.equal(a, b) for a, b in zip(grads_on, grads_off))
    assert peak_on < peak_off
    assert k1_off == 4 and k1_on == (4 if policy == "dots_flash_saveable" else 8)


@pytest.mark.parametrize("remat", [False, True])
def test_training_step_quantizes_each_shared_activation_once(gen, remat):
    """One forward + backward of a 4-layer int8 LLM on the card (int8_rot
    backward, the recipe's remat policy): 4 K2 deterministic launches per
    layer (q / k / v share one, gate / up one, o and down one each) and 7
    rotate + SR launches (one per dense's dy); the replay under
    dots_flash_saveable quantizes nothing again."""
    from slam_llm_tpu_torch.models.llm import CausalLM, LLMConfig
    from slam_llm_tpu_torch.pipeline.common import init_params_

    # k / v 256 wide: the rotation's block
    cfg = dataclasses.replace(LLMConfig.tiny_test(vocab_size=512), d_model=512, n_heads=8, n_kv_heads=4,
                              head_dim=64, ffn_dim=1024, n_layers=4, lora_rank=8, base_quant="int8",
                              base_quant_bwd="int8_rot", remat=remat, remat_policy="dots_flash_saveable")
    model = init_params_(CausalLM(cfg, device="cuda"), gen)
    tquant.quantize_base_params(model)
    params = [p.requires_grad_(True) for n, p in model.named_parameters() if "lora" in n]
    x = torch.randn(2, 128, 512, generator=gen, device="cuda").bfloat16().requires_grad_(True)
    mask = torch.ones(2, 128, dtype=torch.int32, device="cuda")
    labels = torch.randint(0, 512, (2, 128), generator=gen, device="cuda")
    before = trowquant.rowquant.launches, trowquant.rowquant_rot_sr.launches
    loss, _ = model.loss_and_accuracy(x, mask, labels)
    torch.autograd.grad(loss, params + [x])
    torch.cuda.synchronize()
    assert trowquant.rowquant.launches - before[0] == 4 * cfg.n_layers
    assert trowquant.rowquant_rot_sr.launches - before[1] == 7 * cfg.n_layers


def _synth_weights(tmp_path):
    """A 2-layer, 64-wide-head LLM (int8 base, LoRA r8 on q / v) and a
    2-layer whisper encoder, written as bf16 HF directories by the port's
    own writer (the card's host has no transformers)."""
    from types import SimpleNamespace

    from slam_llm_tpu_torch.models.llm import LLMConfig
    from slam_llm_tpu_torch.models.projector import ProjectorConfig
    from slam_llm_tpu_torch.models.slam_model import SLAMConfig
    from slam_llm_tpu_torch.models.whisper import WhisperEncoderConfig
    from slam_llm_tpu_torch.tools.synth_checkpoint import write_llama, write_whisper

    llm = dataclasses.replace(LLMConfig.tiny_test(vocab_size=512), d_model=512, n_heads=8, n_kv_heads=2,
                              head_dim=64, ffn_dim=1024, n_layers=2, lora_rank=8, base_quant="int8")
    enc = WhisperEncoderConfig(n_mels=80, d_model=256, n_heads=4, n_layers=2)
    write_llama(str(tmp_path / "llm"), llm, seed=0)
    write_whisper(str(tmp_path / "whisper"), enc, seed=1, decoder_vocab=64)
    cfg = SLAMConfig(llm=llm, encoder=enc, projector_cfg=ProjectorConfig(encoder_dim=256, llm_dim=512, hidden_dim=512))
    mc = SimpleNamespace(llm_path=str(tmp_path / "llm"), encoder_path=str(tmp_path / "whisper"), encoder_name="whisper")
    return cfg, mc


def test_hf_loader_puts_every_tensor_on_the_card(gen, tmp_path):
    from slam_llm_tpu_torch.models.slam_model import SLAMModel
    from slam_llm_tpu_torch.utils.hf_loader import load_hf_state_dict, load_pretrained_into

    cfg, mc = _synth_weights(tmp_path)
    model = load_pretrained_into(SLAMModel(cfg, device="cuda"), mc)
    assert {t.device.type for t in model.state_dict().values()} == {"cuda"}
    assert {t.device.type for _, t in model.named_buffers()} == {"cuda"}
    sd = load_hf_state_dict(mc.llm_path)
    assert torch.equal(model.llm.embed_tokens.weight.cpu(), sd["model.embed_tokens.weight"])
    assert torch.equal(model.llm.layers[1].input_norm.scale.cpu(), sd["model.layers.1.input_layernorm.weight"].float())


def test_quantize_at_load_on_the_card_equals_the_cpu(gen, tmp_path):
    from slam_llm_tpu_torch.models.slam_model import SLAMModel
    from slam_llm_tpu_torch.utils.hf_loader import load_pretrained_into

    cfg, mc = _synth_weights(tmp_path)
    on_card = load_pretrained_into(SLAMModel(cfg, device="cuda"), mc).state_dict()
    on_cpu = load_pretrained_into(SLAMModel(cfg, device="cpu"), mc).state_dict()
    assert sum(n.endswith("kernel_q") for n in on_cpu) == 14
    for name, t in on_cpu.items():
        assert torch.equal(on_card[name].cpu(), t), name


def test_checkpoint_round_trip_decodes_the_same_tokens_on_the_card(gen, tmp_path):
    from slam_llm_tpu_torch.inference.generate import GenerationConfig, Generator
    from slam_llm_tpu_torch.models.slam_model import SLAMModel
    from slam_llm_tpu_torch.pipeline.common import init_params_
    from slam_llm_tpu_torch.utils.checkpoint import load_trainable_into, save_trainable
    from slam_llm_tpu_torch.utils.hf_loader import load_pretrained_into

    cfg, mc = _synth_weights(tmp_path)
    rng = np.random.default_rng(0)
    n_audio, n_text = 40, 8  # 400 mel frames -> 200 encoder frames -> 40 projected
    ids = np.concatenate([np.full((2, n_audio), -1), rng.integers(3, 512, (2, n_text))], axis=1)
    batch = {"input_ids": ids, "attention_mask": np.ones(ids.shape, np.int32),
             "modality_mask": (ids < 0).astype(np.int32),
             "audio_mel": rng.standard_normal((2, 400, 80)).astype(np.float32),
             "audio_mel_mask": np.ones((2, 400), np.int32)}

    def decode(model):
        return Generator(model.eval(), GenerationConfig(max_new_tokens=8, num_beams=1, eos_token_id=2, pad_token_id=2,
                                                        bos_token_id=1)).generate(batch)

    trained = load_pretrained_into(init_params_(SLAMModel(cfg, device="cuda"), gen), mc)
    with torch.no_grad():
        for name, p in trained.named_parameters():
            if "lora_b" in name or "encoder_projector" in name:
                p.normal_(0.0, 0.05, generator=gen)
    before = decode(trained)
    save_trainable(str(tmp_path / "ckpt" / "model.pt"),
                   {n: p for n, p in trained.named_parameters() if "lora" in n or "encoder_projector" in n})
    fresh = load_pretrained_into(init_params_(SLAMModel(cfg, device="cuda"), torch.Generator(device="cuda").manual_seed(9)),
                                 mc)
    load_trainable_into(fresh, str(tmp_path / "ckpt"))
    assert all(torch.equal(a, b) for a, b in zip(trained.state_dict().values(), fresh.state_dict().values()))
    assert np.array_equal(decode(fresh), before)


# ---- the ST recipe: the Q-Former and the ByteLevel tokenizer ----------------


def test_qformer_on_card_matches_the_cpu_plain_path(gen):
    """The recipe's Q-Former (80 queries, 768 wide, 12 heads; 2 of its 8
    blocks) over whisper-large-v3-wide states, some padded: the output and
    every gradient of a weighted sum, card (K1 forward and K4 backward in
    each block's self-attention) vs the CPU plain path, both bf16, cosine
    >= 0.99; the key projections' biases, whose gradient is 0 in exact
    arithmetic, within 5e-2 of their query biases' gradient norm."""
    from slam_llm_tpu_torch.models.projector import ProjectorConfig, ProjectorQFormer
    from slam_llm_tpu_torch.pipeline.common import init_params_

    model = init_params_(ProjectorQFormer(ProjectorConfig(encoder_dim=1280, llm_dim=3584, query_len=80,
                                                          qformer_layers=2), device="cuda"), gen)
    model.requires_grad_(True)
    x = torch.randn(4, 1500, 1280, generator=gen, device="cuda").bfloat16()
    mask = torch.ones(4, 1500, dtype=torch.int32, device="cuda")
    mask[1, 1000:] = 0
    weight = torch.randn(4, 80, 3584, generator=gen, device="cuda")
    names = [n for n, _ in model.named_parameters()]

    def run():
        params = list(model.parameters())
        out = model(x.to(params[0].device), mask.to(params[0].device))
        grads = torch.autograd.grad((out.float() * weight.to(out.device)).sum(), params)
        return out.float().cpu(), dict(zip(names, (g.float().cpu() for g in grads)))

    fwd, bwd = tflash.flash_attention_fwd.launches, tflash.flash_attention_bwd.launches
    out_gpu, g_gpu = run()
    assert (tflash.flash_attention_fwd.launches - fwd, tflash.flash_attention_bwd.launches - bwd) == (2, 2)
    model.to("cpu")
    out_cpu, g_cpu = run()
    cos = torch.nn.functional.cosine_similarity(out_gpu.flatten(0, 1), out_cpu.flatten(0, 1), dim=-1)
    assert bool(torch.isfinite(out_gpu).all()) and cos.min().item() >= 0.99
    for name in names:
        a, c = g_gpu[name], g_cpu[name]
        if name.endswith("k_proj.bias"):
            ref = g_cpu[name.replace("k_proj", "q_proj")].norm()
            assert max(a.norm(), c.norm()) <= 5e-2 * ref, name
        else:
            assert torch.nn.functional.cosine_similarity(a.flatten(), c.flatten(), dim=0).item() >= 0.99, name


_BYTELEVEL_PROBE = r"""
import json, sys, tempfile
from slam_llm_tpu_torch.data.tokenizer import ByteLevelTokenizer, load_tokenizer
from slam_llm_tpu_torch.tools.synth_checkpoint import QWEN2_BPE, write_qwen2_tokenizer
from slam_llm_tpu_torch.tools import eval_werbleu
d = tempfile.mkdtemp()
write_qwen2_tokenizer(d, QWEN2_BPE, corpus=["das Wetter ist heute schön"])
tok = load_tokenizer(d)
text = "Übersetze: das Wetter ist heute schön 😀 翻译 <|im_start|>x<|im_end|>\n"
ids = tok.encode(text)
print(json.dumps({"type": type(tok).__name__, "vocab": tok.vocab_size, "round_trip": tok.decode(ids, False) == text,
                  "absent": sorted(m for m in ("tokenizers", "transformers", "regex", "sacrebleu", "jax")
                                   if m in sys.modules)}))
"""


def test_bytelevel_tokenizer_runs_on_the_cards_host(gen, tmp_path):
    """qwen2's ByteLevel tokenizer at its full 151,646 tokens, written,
    read and round-tripped in a fresh interpreter on the card's host, which
    imports none of tokenizers, transformers, regex, sacrebleu or jax."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = str(Path(__file__).resolve().parent.parent)
    env = {**os.environ, "PYTHONPATH": repo}
    out = subprocess.run([sys.executable, "-c", _BYTELEVEL_PROBE], capture_output=True, text=True, env=env,
                         timeout=120, check=True, cwd=repo)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "type": "ByteLevelTokenizer", "vocab": 151646, "round_trip": True, "absent": []}


# ---- the WavLM recipe: the raw-waveform encoders ----------------------------


@pytest.mark.parametrize("rel_bias", [True, False])
def test_wavlm_encoder_on_card_matches_the_cpu_plain_path(gen, rel_bias):
    """A narrow WavLM / HuBERT encoder (64-wide heads, the flash kernel's
    width; pre-LN, the layer-norm extractor) over two ragged waveforms: the
    card's bf16 output within cosine 0.99 of the CPU plain path on the same
    weights at every valid frame, the masks equal. With the relative-position
    bias every layer runs the plain attention (no K1); without it every
    layer runs K1 once."""
    from slam_llm_tpu_torch.models.wavlm import WavLMConfig, WavLMEncoder
    from slam_llm_tpu_torch.pipeline.common import init_params_

    cfg = WavLMConfig(d_model=128, n_heads=2, n_layers=2, ffn_dim=256, conv_dim=(64, 64, 64),
                      conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2), conv_pos=16, conv_pos_groups=4,
                      feat_extract_norm="layer", do_stable_layer_norm=True, rel_bias=rel_bias)
    enc = init_params_(WavLMEncoder(cfg, device="cuda").eval(), gen)
    audio = torch.randn(2, 16000, generator=gen, device="cuda")
    mask = torch.ones(2, 16000, dtype=torch.int32, device="cuda")
    mask[1, 9000:] = 0
    before = tflash.flash_attention_fwd.launches
    with torch.no_grad():
        gpu, gpu_mask = enc(audio, mask)
        torch.cuda.synchronize()
        launched = tflash.flash_attention_fwd.launches - before
        enc.to("cpu")
        cpu, cpu_mask = enc(audio.cpu(), mask.cpu())
    assert launched == (0 if rel_bias else cfg.n_layers)
    assert torch.equal(gpu_mask.cpu(), cpu_mask)
    live = cpu_mask.bool()
    cos = torch.nn.functional.cosine_similarity(gpu.float().cpu()[live], cpu.float()[live], dim=-1)
    assert bool(torch.isfinite(gpu).all()) and cos.min().item() >= 0.99


# ---- the CLAP recipes: DRCap's training batch, HTSAT-base and BERT-base -----


def _drcap_mask(b=16, t=192):
    """The key mask of DRCap's collated training batch (vicuna-7b, T = 192):
    each row's audio slot and RAG prompt (131-148 tokens) left-padded to the
    longest prompt, its caption and EOS (14-34 tokens) right-padded to T; the
    audio slot is a row's first valid key."""
    prompts = [131 + (i * 5) % 18 for i in range(b)]
    answers = [14 + (i * 7) % 21 for i in range(b)]
    mask = torch.zeros(b, t, dtype=torch.int32, device="cuda")
    for i, (p, a) in enumerate(zip(prompts, answers)):
        left = max(prompts) - p
        mask[i, left:left + p + a] = 1
    return mask


def test_flash_kernels_at_drcaps_training_batch(gen):
    """K1 (fused RoPE at theta 1e4, causal) and K4 at DRCap's collated
    training batch (16, 192, 32 / 32 heads, head_dim 128), left and right
    padded as the speech dataset collates it: out within 2e-2 of the f32
    twin, live-row lse within 1e-3, dead rows 0; dq / dk / dv within 2e-2
    relative L2, two runs bit-identical, dead rows' dq 0."""
    from slam_llm_tpu_torch.models.layers import rope_tables

    b, t, h, d = 16, 192, 32, 128
    mask = _drcap_mask(b, t)
    q, k, v = _qkv(b, t, h, h, d, gen)
    dout = torch.randn(b, t, h, d, generator=gen, device="cuda").bfloat16()
    rope = rope_tables((mask.long().cumsum(1) - 1).clamp_min(0), d, 1e4)
    out, lse = tflash.flash_attention_fwd(q, k, v, mask, True, rope=rope)
    qr, kr = (tflash.apply_rope_tables(x, *rope) for x in (q, k))
    ref, ref_lse = tflash.flash_attention_ref(qr.float(), kr.float(), v.float(), mask, True)
    live = mask.cumsum(1) > 0
    assert (out.float() - ref).abs().max().item() <= 2e-2
    assert (lse - ref_lse)[live].abs().max().item() <= 1e-3
    assert bool((out[~live] == 0).all())
    got = tflash.flash_attention_bwd(q, k, v, mask, out, lse, dout, True, rope=rope)
    again = tflash.flash_attention_bwd(q, k, v, mask, out, lse, dout, True, rope=rope)
    for g, a, w in zip(got, again, _bwd_twin_f32(q, k, v, mask, out, lse, dout, True, rope)):
        assert torch.equal(g, a) and _rel_l2(g, w) <= 2e-2
    assert bool((got[0][~live] == 0).all())


def _perturbed(mod, gen):
    """``mod`` with every parameter redrawn: weights N(0, 1/fan_in), norm
    scales 1 + N(0, 0.1^2), biases and bias tables N(0, 0.1^2)."""
    with torch.no_grad():
        for name, p in mod.named_parameters():
            if p.ndim >= 2:
                p.copy_(torch.randn(p.shape, generator=gen, device="cuda") / p[0].numel() ** 0.5)
            elif name.endswith("weight"):
                p.copy_(1 + 0.1 * torch.randn(p.shape, generator=gen, device="cuda"))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=gen, device="cuda"))
    return mod.eval()


def test_htsat_base_stage_on_card_matches_the_cpu(gen):
    """HTSAT-base's first Swin stage (96 wide, 4 heads of 24, window 8 over the
    64 x 64 patch grid, the second block's shifted windows) and its patch
    merging, f32 on the card against the same weights on the CPU: cosine
    >= 0.999 at every token."""
    from slam_llm_tpu_torch.models.htsat import HTSAT, HTSATConfig

    cfg = HTSATConfig()
    stage = _perturbed(HTSAT(cfg, device="cuda").layers[0], gen)
    x = torch.randn(2, 64 * 64, cfg.embed_dim, generator=gen, device="cuda")

    def run(s, y):
        with torch.no_grad():
            for block in s.blocks:
                y = block(y)
            return s.downsample(y)

    out = run(stage, x)
    ref = run(stage.to("cpu"), x.cpu())
    cos = torch.nn.functional.cosine_similarity(out.cpu(), ref, dim=-1)
    assert out.shape == (2, 32 * 32, 2 * cfg.embed_dim) and stage.blocks[1].shift == 4
    assert cos.min().item() >= 0.999


def test_bert_base_layer_on_card_matches_the_cpu(gen):
    """One BERT-base layer (768 wide, 12 heads, ffn 3072), f32 on the card
    against the CPU on the same weights, ragged key masks: cosine >= 0.999
    at every token of every row."""
    from slam_llm_tpu_torch.models.bert import BertConfig, BertLayer

    layer = _perturbed(BertLayer(BertConfig(), device="cuda"), gen)
    x = torch.randn(4, 64, 768, generator=gen, device="cuda")
    mask = torch.ones(4, 64, dtype=torch.int32, device="cuda")
    for i, n in enumerate((64, 40, 9, 2)):
        mask[i, n:] = 0
    neg = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9)
    with torch.no_grad():
        out = layer(x, neg)
        ref = layer.to("cpu")(x.cpu(), neg.cpu())
    cos = torch.nn.functional.cosine_similarity(out.cpu(), ref, dim=-1)
    assert bool(torch.isfinite(out).all()) and cos.min().item() >= 0.999
