# coding=utf-8
"""The port's kernels against their plain PyTorch versions on the card.

Every test here needs an NVIDIA GPU (Hopper, sm_90a) and skips elsewhere;
whether a card is present is decided inside the `cuda` fixture, never at
import.  Run on the card with:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

(`--noconftest`: tests/conftest.py imports JAX, which the card's machine
does not need to have.)
"""
import numpy as np
import pytest
import torch

from centerclip_tpu_torch import config as port_config
from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
from centerclip_tpu_torch.ops import attention_cuda, kmedoids_cuda
from centerclip_tpu_torch.ops import layernorm_triton
from centerclip_tpu_torch.ops.distances import pairwise_distance
from centerclip_tpu_torch.ops.kmedoids import (batch_fast_kmedoids,
                                               kmedoids_inputs)

pytestmark = pytest.mark.gpu

# bf16 keeps 8 significant bits: kernel and plain version round the same
# fp32 values, so they differ by at most about one bf16 ulp
BF16_TOL = dict(rtol=1.6e-2, atol=1.6e-2)
# fp32 backward outputs that are sums over a sequence or over rows, taken in
# another order than the plain version's: within 1e-5 of the sum of the
# terms' magnitudes (the worst case of ~150 sequential fp32 adds)
SUM_RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest --noconftest "
                    "-m gpu tests/test_torch_gpu.py` on the card")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


def _randn(shape, dtype, device, seed=0, scale=1.0):
    g = np.random.default_rng(seed)
    x = g.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def _causal(L, device):
    return torch.full((L, L), float("-inf"), device=device).triu(1)


@pytest.mark.parametrize("B,L,H,hd,dtype,causal", [
    (16, 50, 12, 64, torch.bfloat16, False),    # vision blocks
    (8, 32, 8, 64, torch.bfloat16, True),       # text tower
    (4, 50, 12, 64, torch.float32, False),
    (3, 77, 8, 64, torch.float16, True),
    (2, 197, 12, 64, torch.bfloat16, False),    # ViT-B/16 length
])
def test_attention_kernel_matches_plain(cuda, B, L, H, hd, dtype, causal):
    qkv = _randn((B, L, 3 * H * hd), dtype, cuda, seed=L + H)
    mask = _causal(L, cuda) if causal else None
    before = attention_cuda.fused_attention.launches
    out = attention_cuda.fused_attention(qkv, H, mask)
    torch.cuda.synchronize()
    assert attention_cuda.fused_attention.launches == before + 1
    ref = attention_cuda.attention_plain(qkv, H, mask)
    assert out.dtype == dtype and out.shape == (B, L, H * hd)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(out.float(), ref.float(), **tol)


def test_attention_rejects_what_it_cannot_take(cuda):
    qkv = _randn((2, 50, 3 * 768), torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        attention_cuda.fused_attention(qkv[:, ::2], 12)          # strided
    with pytest.raises(ValueError):
        attention_cuda.fused_attention(qkv, 7)                   # heads
    with pytest.raises(ValueError):
        attention_cuda.fused_attention(
            _randn((1, 400, 3 * 768), torch.float32, cuda), 12)  # smem
    with pytest.raises(ValueError):                              # hd % 16
        attention_cuda.fused_attention(
            _randn((2, 50, 3 * 240), torch.bfloat16, cuda), 6)
    with pytest.raises(ValueError):                              # float64
        attention_cuda.fused_attention(qkv.double(), 12)


def _variant_counts(fn):
    return dict(fn.variant_launches)


# the tensor-core kernels at the edges of their 16-row tiles and 64-key /
# 64-channel register tiles: odd B, causal (with the mask gradient) at odd L
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("L", [1, 16, 17, 49, 63, 64, 65, 128])
def test_attention_tensor_core_lengths(cuda, L, dtype):
    B, H, hd = 3, 4, 64
    causal = L % 2 == 1
    qkv = _randn((B, L, 3 * H * hd), dtype, cuda, seed=L)
    dout = _randn((B, L, H * hd), dtype, cuda, seed=L + 1)
    mask = _causal(L, cuda) if causal else None
    fwd0 = _variant_counts(attention_cuda.fused_attention)
    bwd0 = _variant_counts(attention_cuda.attention_backward)
    out = attention_cuda.fused_attention(qkv, H, mask)
    dqkv, dmask = attention_cuda.attention_backward(qkv, dout, H, mask,
                                                    mask_grad=causal)
    torch.cuda.synchronize()
    for fn, before in ((attention_cuda.fused_attention, fwd0),
                       (attention_cuda.attention_backward, bwd0)):
        assert fn.variant_launches["tensor_core"] == \
            before["tensor_core"] + 1
        assert fn.variant_launches["cuda_core"] == before["cuda_core"]
    torch.testing.assert_close(
        out.float(), attention_cuda.attention_plain(qkv, H, mask).float(),
        **BF16_TOL)
    ref, ref_mask = attention_cuda.attention_bwd_plain(qkv, dout, H, mask,
                                                       mask_grad=causal)
    torch.testing.assert_close(dqkv.float(), ref.float(), **BF16_TOL)
    if causal:
        assert bool((dmask.triu(1) == 0).all())
        _assert_sum_close(dmask, ref_mask, _abs_ds_sum(qkv, dout, H, mask))


# head_dim below, at and above one 64-channel register tile
@pytest.mark.parametrize("hd", [16, 48, 128])
def test_attention_tensor_core_head_dims(cuda, hd):
    B, L, H = 5, 50, 2
    qkv = _randn((B, L, 3 * H * hd), torch.bfloat16, cuda, seed=hd)
    dout = _randn((B, L, H * hd), torch.bfloat16, cuda, seed=hd + 1)
    out = attention_cuda.fused_attention(qkv, H)
    dqkv, _ = attention_cuda.attention_backward(qkv, dout, H)
    torch.testing.assert_close(
        out.float(), attention_cuda.attention_plain(qkv, H).float(),
        **BF16_TOL)
    ref, _ = attention_cuda.attention_bwd_plain(qkv, dout, H)
    torch.testing.assert_close(dqkv.float(), ref.float(), **BF16_TOL)


def test_attention_bwd_kernel_is_deterministic(cuda):
    B, L, H = 7, 50, 12
    qkv = _randn((B, L, 3 * H * 64), torch.bfloat16, cuda, seed=11)
    dout = _randn((B, L, H * 64), torch.bfloat16, cuda, seed=12)
    a, _ = attention_cuda.attention_backward(qkv, dout, H)
    b, _ = attention_cuda.attention_backward(qkv, dout, H)
    assert torch.equal(a, b)


@pytest.mark.parametrize("R,D,dtype", [
    (384 * 50, 768, torch.bfloat16), (192 * 50, 768, torch.float32),
    (384, 768, torch.bfloat16), (4 * 32, 512, torch.bfloat16),
    (33, 100, torch.float16)])
def test_layernorm_kernel_matches_plain(cuda, R, D, dtype):
    x = _randn((R, D), dtype, cuda, seed=R, scale=3.0) + 1.5
    w = _randn((D,), torch.float32, cuda, seed=1, scale=0.1) + 1.0
    b = _randn((D,), torch.float32, cuda, seed=2)
    before = layernorm_triton.layer_norm.launches
    y = layernorm_triton.layer_norm(x, w, b)
    torch.cuda.synchronize()
    assert layernorm_triton.layer_norm.launches == before + 1
    ref = layernorm_triton.layer_norm_plain(x, w, b)
    assert y.dtype == dtype
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(y.float(), ref.float(), **tol)


def _cost(D, meds, assign):
    """Sum over points of D[medoid of its cluster, point], in fp64."""
    med_of = torch.gather(meds.long(), 1, assign.long())
    rows = torch.gather(D.double(), 1, med_of[:, None, :]).squeeze(1)
    return rows.sum(-1)


def _blobs(B, N, Dim, centres, seed, device):
    g = np.random.default_rng(seed)
    out = np.zeros((B, N, Dim), np.float32)
    for b in range(B):
        c = g.standard_normal((centres, Dim)).astype(np.float32) * 5.0
        out[b] = c[g.integers(0, centres, N)] \
            + g.standard_normal((N, Dim)) * 0.5
    return torch.from_numpy(out).to(device)


@pytest.mark.parametrize("B,N,Dim,K,distance,pre_norm", [
    (192, 98, 64, 49, "euclidean", False),      # flagship segment shape
    (32, 20, 16, 5, "euclidean", False),        # direct (x-y)^2 branch
    (24, 98, 32, 49, "cosine", False),
    (24, 60, 32, 8, "euclidean", True),
])
def test_kmedoids_kernel_matches_plain(cuda, B, N, Dim, K, distance,
                                       pre_norm):
    X = _blobs(B, N, Dim, 8, seed=N + K, device=cuda)
    before = kmedoids_cuda.kmedoids_from_distances.launches
    a1, m1 = kmedoids_cuda.kmedoids(X, K, distance=distance,
                                    pre_norm=pre_norm)
    torch.cuda.synchronize()
    assert kmedoids_cuda.kmedoids_from_distances.launches == before + 1
    a2, m2 = batch_fast_kmedoids(X, K, distance=distance, iter_limit=100,
                                 pre_norm=pre_norm)
    assert m1.dtype == torch.int32 and m1.shape == (B, K)
    same = (m1 == m2).all(dim=1)
    if not bool(same.all()):
        # a fp32 summation-order tie may pick another, equally good medoid
        _, D, _ = kmedoids_inputs(X, distance, pre_norm=pre_norm)
        c1, c2 = _cost(D, m1, a1), _cost(D, m2, a2)
        diff = ~same
        torch.testing.assert_close(c1[diff], c2[diff], rtol=1e-6, atol=0)
    assert bool(same.float().mean() >= 0.95)
    torch.testing.assert_close(a1[same], a2[same], rtol=0, atol=0)


def test_kmedoids_kernel_rejects_large_n(cuda):
    X = _randn((2, kmedoids_cuda.GLOBAL_MAX_N + 1, 16), torch.float32, cuda)
    with pytest.raises(ValueError):
        kmedoids_cuda.kmedoids(X, 49)


def test_distances_symmetric_on_card(cuda):
    X = _randn((8, 98, 768), torch.float32, cuda)
    D = pairwise_distance(X, X, all_negative=True, self_nearest=True)
    assert torch.equal(D, D.transpose(-1, -2))


def _assert_sum_close(out, ref, abs_terms):
    """|out - ref| <= SUM_RTOL * sum |terms| + 1e-6, elementwise."""
    err = (out.float() - ref.float()).abs()
    bound = SUM_RTOL * abs_terms + 1e-6
    assert bool((err <= bound).all()), float((err - bound).max())


def _abs_ds_sum(qkv, dout, H, mask):
    """sum over samples and heads of |dS| (the terms of the mask gradient)."""
    B, L, D3 = qkv.shape
    D = D3 // 3
    hd = D // H

    def heads(x):
        return x.reshape(B, L, H, hd).transpose(1, 2).float()
    q, k, v = qkv.split(D, dim=-1)
    p = torch.softmax(heads(q * hd ** -0.5) @ heads(k).transpose(-1, -2)
                      + mask, dim=-1)
    dp = heads(dout) @ heads(v).transpose(-1, -2)
    return (p * (dp - (dp * p).sum(-1, keepdim=True))).abs().sum((0, 1))


@pytest.mark.parametrize("B,L,H,hd,dtype,causal,mask_grad", [
    (16, 50, 12, 64, torch.bfloat16, False, False),    # vision blocks
    (8, 32, 8, 64, torch.bfloat16, True, False),       # text tower
    (8, 32, 8, 64, torch.bfloat16, True, True),        # dmask atomics
    (4, 50, 12, 64, torch.float32, False, False),
    (3, 77, 8, 64, torch.float16, True, True),
])
def test_attention_bwd_kernel_matches_plain(cuda, B, L, H, hd, dtype, causal,
                                            mask_grad):
    qkv = _randn((B, L, 3 * H * hd), dtype, cuda, seed=L + H)
    dout = _randn((B, L, H * hd), dtype, cuda, seed=L + H + 1)
    mask = _causal(L, cuda) if causal else None
    before = attention_cuda.attention_backward.launches
    dqkv, dmask = attention_cuda.attention_backward(qkv, dout, H, mask,
                                                    mask_grad=mask_grad)
    torch.cuda.synchronize()
    assert attention_cuda.attention_backward.launches == before + 1
    ref, ref_mask = attention_cuda.attention_bwd_plain(qkv, dout, H, mask,
                                                       mask_grad=mask_grad)
    assert dqkv.dtype == dtype and dqkv.shape == qkv.shape
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(dqkv.float(), ref.float(), **tol)
    if mask_grad:
        assert bool(torch.isfinite(dmask).all())
        assert bool((dmask.triu(1) == 0).all())    # -inf entries: dS = 0
        # dS summed over samples and heads by atomics in any order
        _assert_sum_close(dmask, ref_mask, _abs_ds_sum(qkv, dout, H, mask))
    else:
        assert dmask is None


# the long variants (L > 128): 64-row tiles, the last one ragged
LONG_CASES = [(L, dtype, False) for L in (129, 131, 161, 197, 256)
              for dtype in (torch.bfloat16, torch.float16)] + [
    (161, torch.bfloat16, True),        # a mask, without its gradient
    (197, torch.float16, True)]


@pytest.mark.parametrize("L,dtype,causal", LONG_CASES)
def test_attention_bwd_key_tiled_matches_plain(cuda, L, dtype, causal):
    """Kernel B's long variant: two calls equal to the bit, each within one
    ulp of the plain version, counted under its variant."""
    B, H = 6, 12
    qkv = _randn((B, L, 3 * H * 64), dtype, cuda, seed=L)
    dout = _randn((B, L, H * 64), dtype, cuda, seed=L + 1)
    mask = _causal(L, cuda) if causal else None
    before = _variant_counts(attention_cuda.attention_backward)
    dqkv, _ = attention_cuda.attention_backward(qkv, dout, H, mask)
    again, _ = attention_cuda.attention_backward(qkv, dout, H, mask)
    torch.cuda.synchronize()
    after = _variant_counts(attention_cuda.attention_backward)
    assert after[attention_cuda.TENSOR_CORE_LONG] \
        == before[attention_cuda.TENSOR_CORE_LONG] + 2
    assert torch.equal(dqkv, again)                     # deterministic
    ref, _ = attention_cuda.attention_bwd_plain(qkv, dout, H, mask)
    torch.testing.assert_close(dqkv.float(), ref.float(), **BF16_TOL)


@pytest.mark.parametrize("L,dtype,causal", LONG_CASES + [
    (300, torch.bfloat16, False), (520, torch.float16, True)])
def test_attention_long_forward_matches_plain(cuda, L, dtype, causal):
    """Kernel A's long variant, past the backward's 256 too: two calls
    equal to the bit, within one ulp of the plain version, counted under
    its variant."""
    B, H = 5, 12
    qkv = _randn((B, L, 3 * H * 64), dtype, cuda, seed=L + 2)
    mask = _causal(L, cuda) if causal else None
    before = _variant_counts(attention_cuda.fused_attention)
    out = attention_cuda.fused_attention(qkv, H, mask)
    again = attention_cuda.fused_attention(qkv, H, mask)
    torch.cuda.synchronize()
    after = _variant_counts(attention_cuda.fused_attention)
    assert after[attention_cuda.TENSOR_CORE_LONG] \
        == before[attention_cuda.TENSOR_CORE_LONG] + 2
    assert after[attention_cuda.TENSOR_CORE] == before[attention_cuda.TENSOR_CORE]
    assert torch.equal(out, again)
    torch.testing.assert_close(
        out.float(), attention_cuda.attention_plain(qkv, H, mask).float(),
        **BF16_TOL)


# head_dim below, at and above one 64-channel register tile (the kernels
# compiled for 64 and the generic ones)
@pytest.mark.parametrize("hd", [16, 48, 128])
def test_attention_long_head_dims(cuda, hd):
    B, L, H = 3, 197, 2
    qkv = _randn((B, L, 3 * H * hd), torch.bfloat16, cuda, seed=hd)
    dout = _randn((B, L, H * hd), torch.bfloat16, cuda, seed=hd + 1)
    out = attention_cuda.fused_attention(qkv, H)
    dqkv, _ = attention_cuda.attention_backward(qkv, dout, H)
    torch.testing.assert_close(
        out.float(), attention_cuda.attention_plain(qkv, H).float(),
        **BF16_TOL)
    ref, _ = attention_cuda.attention_bwd_plain(qkv, dout, H)
    torch.testing.assert_close(dqkv.float(), ref.float(), **BF16_TOL)


@pytest.mark.parametrize("B,L", [(1536, 197), (768, 161)])
def test_attention_long_vitb16_shapes(cuda, B, L):
    """ViT-B/16's full-width shapes (12 heads of 64, the recipe's batch of
    128 clips x 12 or 6 frames): both long kernels within one ulp, the
    backward through the autograd Function to the bit."""
    H = 12
    qkv = _randn((B, L, 3 * H * 64), torch.bfloat16, cuda, seed=B + L)
    dout = _randn((B, L, H * 64), torch.bfloat16, cuda, seed=B + L + 1)
    x = qkv.clone().requires_grad_(True)
    out = attention_cuda.fused_attention(x, H)
    out.backward(dout)
    dqkv, _ = attention_cuda.attention_backward(qkv, dout, H)
    assert torch.equal(x.grad, dqkv)
    torch.testing.assert_close(
        out.detach().float(), attention_cuda.attention_plain(qkv, H).float(),
        **BF16_TOL)
    del out, x
    ref, _ = attention_cuda.attention_bwd_plain(qkv, dout, H)
    torch.testing.assert_close(dqkv.float(), ref.float(), **BF16_TOL)


def test_attention_long_occupancy(cuda):
    """The long kernels' registers and shared memory leave room for the
    CTAs per SM their launch bounds aim at (4 for A, 3 for B's two)."""
    fwd = attention_cuda.long_occupancy(torch.bfloat16, 64)
    bwd = attention_cuda.long_occupancy(torch.bfloat16, 64, backward=True)
    assert fwd["attention_fwd_long_kernel"]["ctas_per_sm"] >= 4, fwd
    assert all(v["ctas_per_sm"] >= 3 for v in bwd.values()), bwd


def test_attention_function_backward_is_the_kernel(cuda):
    B, L, H = 6, 50, 12
    qkv = _randn((B, L, 3 * H * 64), torch.bfloat16, cuda, seed=3)
    dout = _randn((B, L, H * 64), torch.bfloat16, cuda, seed=4)
    x = qkv.clone().requires_grad_(True)
    a0 = attention_cuda.fused_attention.launches
    b0 = attention_cuda.attention_backward.launches
    out = attention_cuda.fused_attention(x, H)
    out.backward(dout)
    assert attention_cuda.fused_attention.launches == a0 + 1
    assert attention_cuda.attention_backward.launches == b0 + 1
    dqkv, _ = attention_cuda.attention_backward(qkv, dout, H)
    assert torch.equal(x.grad, dqkv)


def test_attention_bwd_rejects_what_it_cannot_take(cuda):
    qkv = _randn((2, 257, 3 * 768), torch.bfloat16, cuda)
    dout = _randn((2, 257, 768), torch.bfloat16, cuda)
    with pytest.raises(ValueError):                     # L > 256
        attention_cuda.attention_backward(qkv, dout, 12)
    with pytest.raises(ValueError):                     # L = 129: no dmask
        attention_cuda.attention_backward(
            _randn((1, 129, 3 * 128), torch.float16, cuda),
            _randn((1, 129, 128), torch.float16, cuda), 2,
            _causal(129, cuda), mask_grad=True)
    with pytest.raises(ValueError):                     # hd % 16
        attention_cuda.attention_backward(
            _randn((1, 50, 3 * 80), torch.bfloat16, cuda),
            _randn((1, 50, 80), torch.bfloat16, cuda), 2)
    with pytest.raises(ValueError):                     # fp32 shared memory
        attention_cuda.attention_backward(
            _randn((1, 197, 3 * 768), torch.float32, cuda),
            _randn((1, 197, 768), torch.float32, cuda), 12)
    small = _randn((2, 50, 3 * 768), torch.bfloat16, cuda)
    with pytest.raises(ValueError):                     # dout shape
        attention_cuda.attention_backward(small, dout, 12)
    with pytest.raises(ValueError):                     # dmask, no mask
        attention_cuda.attention_backward(
            small, _randn((2, 50, 768), torch.bfloat16, cuda), 12,
            mask_grad=True)


def _check_ln_bwd(x, w, dy, out):
    """The kernel's (dx, dgamma, dbeta) against the plain version: dx within
    one ulp of its dtype, the sums within SUM_RTOL of their terms."""
    dx, dw, db = out
    rx, rw, rb = layernorm_triton.layer_norm_bwd_plain(x, w, dy)
    tol = dict(rtol=1e-5, atol=1e-5) if x.dtype == torch.float32 \
        else BF16_TOL
    torch.testing.assert_close(dx.float(), rx.float(), **tol)
    xf = x.float().reshape(-1, x.shape[-1])
    xhat = (xf - xf.mean(-1, keepdim=True)) / xf.std(-1, correction=0,
                                                      keepdim=True)
    dyf = dy.float().reshape(xf.shape)
    _assert_sum_close(dw, rw, (dyf * xhat).abs().sum(0))
    _assert_sum_close(db, rb, dyf.abs().sum(0))


@pytest.mark.parametrize("R,D,dtype", [
    (1536 * 50, 768, torch.bfloat16), (768 * 50, 768, torch.bfloat16),
    (768, 768, torch.bfloat16), (128 * 32, 512, torch.bfloat16),
    (1000, 768, torch.float32), (33, 100, torch.float16)])
def test_layernorm_bwd_kernel_matches_plain(cuda, R, D, dtype):
    x = _randn((R, D), dtype, cuda, seed=R, scale=3.0) + 1.5
    w = _randn((D,), torch.float32, cuda, seed=1, scale=0.1) + 1.0
    dy = _randn((R, D), dtype, cuda, seed=2)
    before = layernorm_triton.layer_norm_backward.launches
    out = layernorm_triton.layer_norm_backward(x, w, dy)
    torch.cuda.synchronize()
    assert layernorm_triton.layer_norm_backward.launches == before + 1
    assert out[0].dtype == dtype and out[1].dtype == out[2].dtype \
        == torch.float32
    _check_ln_bwd(x, w, dy, out)


# the rows at the plan's edges: one row, one partial tile, many programs
@pytest.mark.parametrize("lead", [(2, 50), (1,), (3, 1), (128, 6, 50)])
def test_layernorm_function_backward_is_the_kernel(cuda, lead):
    x = _randn((*lead, 768), torch.bfloat16, cuda, seed=5)
    w = _randn((768,), torch.float32, cuda, seed=6) * 0.1 + 1.0
    b = _randn((768,), torch.float32, cuda, seed=7)
    dy = _randn((*lead, 768), torch.bfloat16, cuda, seed=8)
    xs, ws, bs = (a.clone().requires_grad_(True) for a in (x, w, b))
    c0 = layernorm_triton.layer_norm.launches
    d0 = layernorm_triton.layer_norm_backward.launches
    layernorm_triton.layer_norm(xs, ws, bs).backward(dy)
    assert layernorm_triton.layer_norm.launches == c0 + 1
    assert layernorm_triton.layer_norm_backward.launches == d0 + 1
    dx, dw, db = layernorm_triton.layer_norm_backward(x, w, dy)
    assert torch.equal(xs.grad, dx) and torch.equal(ws.grad, dw) \
        and torch.equal(bs.grad, db)


def test_one_training_step_of_a_tiny_model_on_the_card(cuda, monkeypatch):
    """A 2 + 2 block clustered model takes one Trainer step on the card
    through all five kernels; loss and every gradient are finite."""
    from centerclip_tpu_torch.train import Trainer
    monkeypatch.setitem(port_config.CLIP_ARCHS, "tiny-gpu-train", dict(
        embed_dim=32, image_resolution=64, vision_layers=2, vision_width=128,
        vision_patch_size=16, vision_heads=2, context_length=16,
        vocab_size=100, transformer_width=128, transformer_heads=2,
        transformer_layers=2))
    run = port_config.make_run_config(
        clip_name="tiny-gpu-train", max_frames=4, max_words=16,
        inter=True, algo="kmediods++", cluster_num_blocks=(8, 8),
        target_frames_blocks=(4, 2), optim="AdamW", lr=1e-3,
        freeze_layer_num=0)
    model = CLIP4Clip(run.model, device=cuda, seed=0)
    g = np.random.default_rng(0)
    ids = g.integers(1, 98, (4, 16))
    ids[:, -1] = 99
    batch = {"input_ids": ids, "attention_mask": np.ones((4, 16), np.int32),
             "video": g.integers(0, 256, (4, 1, 4, 3, 64, 64),
                                 dtype=np.uint8),
             "video_mask": np.ones((4, 4), np.int32)}
    counters = (attention_cuda.fused_attention,
                attention_cuda.attention_backward, layernorm_triton.layer_norm,
                layernorm_triton.layer_norm_backward,
                kmedoids_cuda.kmedoids_from_distances)
    before = [fn.launches for fn in counters]
    trainer = Trainer(run, model, total_steps=10)
    # the gradients are read between the backward and the update, which
    # would fill a missing one with zeros
    update, seen = trainer.optimizer.step, {}

    def checked_update():
        seen.update({n: None if p.grad is None else p.grad.clone()
                     for n, p in model.named_parameters() if p.requires_grad})
        update()
    trainer.optimizer.step = checked_update
    loss, gstep = trainer.train_epoch(0, [batch], n_display=1)
    torch.cuda.synchronize()
    assert gstep == 1 and np.isfinite(loss)
    assert all(fn.launches > b for fn, b in zip(counters, before))
    assert seen
    for name, grad in seen.items():
        assert grad is not None and bool(torch.isfinite(grad).all()) \
            and bool(grad.abs().max() > 0), name


# ------------------------------------------------ LayerNorm backward design
# row counts at the plan's edges (one program, one partial tile, one tile
# per program, many tiles per program) at a width that is no power of two
@pytest.mark.parametrize("R", [1, 3, 768, 4096, 38400])
def test_layernorm_bwd_rows_and_repeatable(cuda, R):
    D = 640
    x = _randn((R, D), torch.bfloat16, cuda, seed=R, scale=3.0) + 1.5
    w = _randn((D,), torch.float32, cuda, seed=1, scale=0.1) + 1.0
    dy = _randn((R, D), torch.bfloat16, cuda, seed=2)
    first = layernorm_triton.layer_norm_backward(x, w, dy)
    again = layernorm_triton.layer_norm_backward(x, w, dy)
    torch.cuda.synchronize()
    _check_ln_bwd(x, w, dy, first)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_layernorm_bwd_many_calls_in_a_row(cuda):
    """50 calls at alternating shapes, each right: the ticket counters are
    back at zero after every call, whatever the plan's group count."""
    shapes = [(1, 768), (76800 // 8, 768), (4096, 512), (33, 100),
              (768, 768)]
    inputs = []
    for i, (R, D) in enumerate(shapes):
        inputs.append((
            _randn((R, D), torch.bfloat16, cuda, seed=10 + i, scale=2.0),
            _randn((D,), torch.float32, cuda, seed=20 + i, scale=0.1) + 1.0,
            _randn((R, D), torch.bfloat16, cuda, seed=30 + i)))
    outs = [layernorm_triton.layer_norm_backward(*inputs[i % len(shapes)])
            for i in range(50)]
    torch.cuda.synchronize()
    for i, out in enumerate(outs):
        _check_ln_bwd(*inputs[i % len(shapes)], out)
        if i >= len(shapes):
            assert all(torch.equal(a, b)
                       for a, b in zip(out, outs[i - len(shapes)]))


# ----------------------------------------------------------- k-medoids design
def _check_kmedoids_on_distances(X, K, iter_limit=100, id_sort=True):
    """The kernel against `kmedoids_on_distances` on the same distances:
    ids equal on >= 95 % of the segments, and where a fp32 summation-order
    tie picked another medoid, the costs equal to 1e-6; assignments equal
    wherever the medoids are."""
    from centerclip_tpu_torch.ops.kmedoids import kmedoids_on_distances
    Xf, D, l2 = kmedoids_inputs(X)
    before = kmedoids_cuda.kmedoids_from_distances.launches
    a1, m1, steps = kmedoids_cuda.kmedoids_from_distances(
        D, l2, K, iter_limit=iter_limit, id_sort=id_sort)
    torch.cuda.synchronize()
    assert kmedoids_cuda.kmedoids_from_distances.launches == before + 1
    assert bool((steps >= 1).all()) and bool((steps <= iter_limit).all())
    a2, m2 = kmedoids_on_distances(Xf, D, l2, K, iter_limit=iter_limit,
                                   id_sort=id_sort)
    same = (m1 == m2).all(dim=1)
    if not bool(same.all()):
        diff = ~same
        torch.testing.assert_close(_cost(D, m1, a1)[diff],
                                   _cost(D, m2, a2)[diff], rtol=1e-6, atol=0)
    assert bool(same.float().mean() >= 0.95)
    torch.testing.assert_close(a1[same], a2[same], rtol=0, atol=0)
    return steps


@pytest.mark.parametrize("B,N,K", [
    (64, 97, 49),       # odd N: D loads by 4-byte cp.async
    (64, 21, 5),
    (32, 98, 1),        # one cluster
    (32, 40, 40),       # every point its own medoid
    (8, 234, 49),       # near the shared-memory limit, bulk copy
    (8, 235, 60),       # at the limit, odd
])
def test_kmedoids_kernel_shapes(cuda, B, N, K):
    X = _blobs(B, N, 32, 8, seed=N * 7 + K, device=cuda)
    _check_kmedoids_on_distances(X, K)


@pytest.mark.parametrize("B,N,K", [
    (16, 257, 100),     # the first N past the shared-memory variant's
    (64, 392, 160),     # ViT-B/16: 2 x 196 tokens, K = 160
    (8, 512, 200),      # the global variant's limit
    (8, 393, 160),      # odd N
])
def test_kmedoids_global_variant_matches_plain(cuda, B, N, K):
    assert kmedoids_cuda.choose_variant(N) == kmedoids_cuda.GLOBAL
    before = dict(kmedoids_cuda.kmedoids_from_distances.variant_launches)
    X = _blobs(B, N, 64, 40, seed=N + K, device=cuda)
    _check_kmedoids_on_distances(X, K)
    after = kmedoids_cuda.kmedoids_from_distances.variant_launches
    assert after[kmedoids_cuda.GLOBAL] == before[kmedoids_cuda.GLOBAL] + 1


@pytest.mark.parametrize("N,K", [(98, 49), (147, 49), (196, 98), (232, 116)])
def test_kmedoids_global_variant_equals_shared(cuda, N, K):
    """Where both variants run, they give the same bits: the one algorithm
    with D read from shared memory or from device memory."""
    X = _blobs(48, N, 64, 20, seed=N, device=cuda)
    _, D, l2 = kmedoids_inputs(X)
    outs = [kmedoids_cuda.kmedoids_from_distances(D, l2, K, variant=v)
            for v in (kmedoids_cuda.SHARED, kmedoids_cuda.GLOBAL)]
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_kmedoids_kernel_one_step_and_no_sort(cuda):
    X = _blobs(96, 98, 64, 8, seed=3, device=cuda)
    steps = _check_kmedoids_on_distances(X, 49, iter_limit=1)
    assert bool((steps == 1).all())
    # id_sort=False: the plain version's assignment is that of the medoids
    # before its last update, equal at the fixed point the kernel stops at
    _check_kmedoids_on_distances(X, 49, id_sort=False)


# ------------------------------------------------------------ data and main
def _tiny_fstore(root, n=8, T=10, H=64, W=80):
    from centerclip_tpu_torch.data.framestore import build_framestore
    g = np.random.default_rng(0)
    vids = {f"video{i}": g.integers(0, 256, (T, H, W, 3), dtype=np.uint8)
            for i in range(n)}
    return build_framestore(vids, str(root / "videos.fstore")), vids


def test_reader_gathers_into_pinned_memory(cuda, tmp_path):
    """The C++ reader's `out=` into a pinned buffer, and the loader's pinned
    batches, equal the pageable ones and copy to the card unchanged."""
    from centerclip_tpu_torch.data.fast_dataset import FrameStoreClipDataset
    from centerclip_tpu_torch.data.loader import BatchLoader
    from centerclip_tpu_torch.data.native import NativeFrameStore
    from centerclip_tpu_torch.models.tokenizer import SimpleTokenizer
    from centerclip_tpu_torch.train.loop import batch_to_device
    path, vids = _tiny_fstore(tmp_path)
    ns = NativeFrameStore(path, num_threads=4)
    idx = np.tile(np.arange(6), (3, 1))
    want = ns.gather_batch_u8([0, 1, 2], idx, size=64)
    buf = torch.empty((3, 6, 3, 64, 64), dtype=torch.uint8, pin_memory=True)
    assert buf.is_pinned()
    ns.gather_batch_u8([0, 1, 2], idx, size=64, out=buf.numpy())
    np.testing.assert_array_equal(buf.numpy(), want)
    assert torch.equal(buf.to(cuda, non_blocking=True).cpu(),
                       torch.from_numpy(want))
    ds = FrameStoreClipDataset(path, [(k, f"caption {k}") for k in vids],
                               SimpleTokenizer(), max_words=16, max_frames=6,
                               image_resolution=64, is_train=True,
                               device_normalize=True)
    plain = list(BatchLoader(ds, 3, shuffle=True, seed=1))
    pinned = list(BatchLoader(ds, 3, shuffle=True, seed=1, pin_memory=True))
    assert len(plain) == len(pinned) == 3
    for a, b in zip(plain, pinned):
        assert sorted(a) == sorted(b)
        for k in a:
            assert isinstance(b[k], torch.Tensor) and b[k].is_pinned(), k
            np.testing.assert_array_equal(b[k].numpy(), a[k])
        on_card = batch_to_device(b, cuda)
        torch.cuda.synchronize()
        assert torch.equal(on_card["video"].cpu(), torch.from_numpy(
            a["video"]))
        assert on_card["input_ids"].dtype == torch.int64


def test_main_trains_and_reloads_on_the_card(cuda, tmp_path, monkeypatch):
    """`main` at a tiny size on the card (bf16, a .fstore): every kernel
    launches, and an eval-only reload of its checkpoint gives the same
    similarity matrix to the bit."""
    import csv
    import dataclasses
    import json
    from centerclip_tpu_torch import cli, main as port_main
    from centerclip_tpu_torch.train import evaluate
    monkeypatch.setitem(port_config.CLIP_ARCHS, "tiny-gpu-main", dict(
        embed_dim=32, image_resolution=64, vision_layers=2, vision_width=128,
        vision_patch_size=16, vision_heads=2, context_length=16,
        vocab_size=49408, transformer_width=128, transformer_heads=2,
        transformer_layers=2))
    path, vids = _tiny_fstore(tmp_path)
    with open(tmp_path / "train.csv", "w", newline="") as f:
        csv.writer(f).writerows([["video_id"]] + [[v] for v in vids])
    with open(tmp_path / "test.csv", "w", newline="") as f:
        csv.writer(f).writerows([["video_id", "sentence"]] + [
            [v, f"a clip, number {i}"] for i, v in enumerate(vids)])
    with open(tmp_path / "data.json", "w") as f:
        json.dump({"sentences": [{"video_id": v, "caption": f"{v} {j}"}
                                 for v in vids for j in range(2)]}, f)
    argv = ["--do_train", "1", "--do_eval", "1",
            "--train_csv", str(tmp_path / "train.csv"),
            "--val_csv", str(tmp_path / "test.csv"),
            "--data_path", str(tmp_path / "data.json"),
            "--features_path", path, "--output_dir", str(tmp_path / "out"),
            "--pretrained_dir", str(tmp_path / "none"),
            "--pretrained_clip_name", "tiny-gpu-main", "--max_words", "16",
            "--max_frames", "4", "--batch_size", "8", "--batch_size_val",
            "8", "--epochs", "1", "--optim", "AdamW", "--lr", "1e-3",
            "--loose_type", "--expand_msrvtt_sentences", "--cluster_inter",
            "1", "--cluster_num_blocks", "8", "8", "--target_frames_blocks",
            "4", "2", "--precision", "amp", "--n_display", "1",
            "--num_thread_reader", "4"]
    orig = cli.args_to_run_config
    monkeypatch.setattr(cli, "args_to_run_config", lambda a: dataclasses
                        .replace(orig(a), data=dataclasses.replace(
                            orig(a).data, image_resolution=64)))
    evals = []
    orig_evaluate = evaluate.Evaluator.evaluate

    def recording(self, *a, **k):
        evals.append(orig_evaluate(self, *a, **k))
        return evals[-1]
    monkeypatch.setattr(evaluate.Evaluator, "evaluate", recording)
    counters = (attention_cuda.fused_attention,
                attention_cuda.attention_backward, layernorm_triton.layer_norm,
                layernorm_triton.layer_norm_backward,
                kmedoids_cuda.kmedoids_from_distances)
    before = [fn.launches for fn in counters]
    best = port_main.main(argv)
    assert all(fn.launches > b for fn, b in zip(counters, before))
    assert 0.0 <= best <= 100.0
    with open(tmp_path / "out" / "tensorboard" / "scalars.jsonl") as f:
        losses = [json.loads(line)["train/sim_loss"] for line in f]
    assert len(losses) == 2 and np.isfinite(losses).all()
    argv[1] = "0"
    argv[argv.index("--output_dir") + 1] = str(tmp_path / "eval")
    res = port_main.main(argv + ["--init_model",
                                 str(tmp_path / "out" / "ckpt.pth.tar")])
    assert res is evals[-1] and len(evals) == 2
    np.testing.assert_array_equal(res["sim_matrix"], evals[0]["sim_matrix"])
    assert res["t2v"] == evals[0]["t2v"]


# ------------------------------------------------------------------ serving
def _tied(scores, atol):
    """[Q, k] scores sorted descending -> [Q, k-1] mask of neighbours that
    differ by no more than atol (their order may fall either way)."""
    return np.abs(np.diff(scores, axis=1)) <= atol


@pytest.mark.parametrize("quantize", ["float32", "int8"])
def test_ivf_at_full_probe_equals_flat_on_the_card(cuda, quantize):
    """A clusterable gallery drawn on the card: IVF at nprobe = K gives
    the flat index's ids (where neighbouring scores are not tied to fp32
    summation order) and scores, and the CPU's ids on the same rows."""
    from centerclip_tpu_torch.serve import IVFVideoIndex, VideoIndex
    g = torch.Generator(device=cuda).manual_seed(0)
    centers = torch.randn((64, 128), generator=g, device=cuda)
    centers /= centers.norm(dim=1, keepdim=True)
    which = torch.randint(64, (20000,), generator=g, device=cuda)
    emb = centers[which] + 0.25 / 128 ** 0.5 * torch.randn(
        (20000, 128), generator=g, device=cuda)
    ids = [str(i) for i in range(20000)]
    q = (centers[:40] + 0.02 * torch.randn((40, 128), generator=g,
                                           device=cuda)).cpu().numpy()
    flat = VideoIndex(emb, ids, quantize=quantize)
    ivf = IVFVideoIndex(emb, ids, quantize=quantize, n_clusters=64,
                        iters=3)
    assert ivf.centroids.device.type == "cuda" and ivf.regroups == 0
    s0, i0 = flat.search(q, k=10)
    s1, i1 = ivf.search(q, k=10, nprobe=64)
    tol = 1e-5 * np.abs(s0).max()
    np.testing.assert_allclose(s1, s0, rtol=0, atol=tol)
    untied = ~(np.concatenate([_tied(s0, tol), np.zeros((40, 1), bool)], 1)
               | np.concatenate([np.zeros((40, 1), bool), _tied(s0, tol)],
                                1))
    np.testing.assert_array_equal(i1[untied], i0[untied])
    cpu = VideoIndex(emb.cpu(), ids, quantize=quantize, device="cpu")
    s2, i2 = cpu.search(q, k=10)
    np.testing.assert_array_equal(i2[untied], i0[untied])
    # recall@10 at a partial probe on clusterable rows
    _, i8 = ivf.search(q, k=10, nprobe=8)
    recall = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(i8, i0)])
    assert recall >= 0.9, recall
    # a live add lands in the cells' slack and is its own top hit
    new = emb[:50] + 0.01 * torch.randn((50, 128), generator=g,
                                        device=cuda)
    ivf.add(new, [f"new{i}" for i in range(50)])
    assert ivf.regroups == 0 and len(ivf) == 20050
    _, top = ivf.search(new.cpu().numpy(), k=1)
    assert ivf.lookup(top[:, 0]) == [f"new{i}" for i in range(50)]


def test_pinned_batch_encode_equals_pageable_and_warmup(cuda, monkeypatch):
    """The engine encodes a pinned batch (and a short one padded on the
    card) to the same bits as the pageable numpy batch; the CLI's
    re-batching keeps pinned rows pinned; `warmup` loads the forward
    path's kernel libraries and runs each query bucket."""
    from centerclip_tpu_torch.ops import _build
    from centerclip_tpu_torch.serve import RetrievalEngine, VideoIndex
    from centerclip_tpu_torch.serve.cli import gallery_batches
    monkeypatch.setitem(port_config.CLIP_ARCHS, "tiny-gpu-serve", dict(
        embed_dim=32, image_resolution=64, vision_layers=2, vision_width=128,
        vision_patch_size=16, vision_heads=2, context_length=16,
        vocab_size=49408, transformer_width=128, transformer_heads=2,
        transformer_layers=2))
    run = port_config.make_run_config(
        clip_name="tiny-gpu-serve", max_frames=4, max_words=16,
        inter=True, algo="kmediods++", cluster_num_blocks=(8, 8),
        target_frames_blocks=(4, 2))
    engine = RetrievalEngine(CLIP4Clip(run.model, device=cuda, seed=0))
    g = np.random.default_rng(0)
    video = g.integers(0, 256, (6, 1, 4, 3, 64, 64), dtype=np.uint8)
    vmask = np.ones((6, 4), np.int32)
    batch = {"video": video, "video_mask": vmask}
    pinned = {k: torch.from_numpy(v).pin_memory() for k, v in batch.items()}
    pageable = engine.embed_video_batches([batch])
    on_pinned = engine.embed_video_batches([pinned])
    np.testing.assert_array_equal(on_pinned, pageable)
    parts = [{k: v[s:s + 4] for k, v in pinned.items()} for s in (0, 4)]
    rebatched = list(gallery_batches(parts, True, [1, 2, 3, 4, 5, 6], 4))
    assert [b["video"].shape[0] for b in rebatched] == [4, 2]
    assert all(t.is_pinned() for b in rebatched for t in b.values())
    np.testing.assert_array_equal(
        engine.embed_video_batches(rebatched),
        engine.embed_video_batches([{k: v[s:e] for k, v in batch.items()}
                                    for s, e in ((0, 4), (4, 6))]))
    engine.index = VideoIndex(pageable, [f"v{i}" for i in range(6)])
    assert engine.warmup(k=3, max_queries=8) == 4
    assert set(_build.FORWARD_SOURCES) <= set(_build._libs)
    hits = engine.search(["a cat", "a dog"], k=3)
    assert [len(h) for h in hits] == [3, 3]
