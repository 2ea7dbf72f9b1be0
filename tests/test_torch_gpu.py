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
from centerclip_tpu_torch.ops import _build, attention_cuda, kmedoids_cuda
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
    (2, 64, 2, 192, torch.float32, False),      # fp32 past head_dim 128
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
    with pytest.raises(ValueError):                 # fp32 head_dim > 128
        attention_cuda.fused_attention(
            _randn((1, 400, 3 * 768), torch.float32, cuda), 4)
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


@pytest.mark.parametrize("R,D,dtype,vector", [
    (1, 768, torch.bfloat16, True), (1, 512, torch.bfloat16, True),
    (1, 1000, torch.bfloat16, False), (4097, 1000, torch.bfloat16, False),
    (5000, 768, torch.bfloat16, True), (300, 768, torch.float32, True),
    (77, 512, torch.float16, True), (9, 100, torch.float32, False)])
def test_layernorm_cuda_kernel_paths(cuda, R, D, dtype, vector):
    """Kernel C's vector path (rows of whole 512-byte pieces) and scalar
    path (any other width), at one row and at many: each call launches the
    kernel once and matches the plain version."""
    x = _randn((R, D), dtype, cuda, seed=R + D, scale=3.0) + 1.5
    w = _randn((D,), torch.float32, cuda, seed=1, scale=0.1) + 1.0
    b = _randn((D,), torch.float32, cuda, seed=2)
    assert (layernorm_triton.fwd_vecs(D, x.element_size()) > 0) == vector
    before = layernorm_triton.layer_norm.launches
    y = layernorm_triton.layer_norm(x, w, b)
    torch.cuda.synchronize()
    assert layernorm_triton.layer_norm.launches == before + 1
    assert y.device.type == "cuda" and y.dtype == dtype
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(
        y.float(), layernorm_triton.layer_norm_plain(x, w, b).float(), **tol)


def test_layernorm_cuda_kernel_unaligned_rows(cuda):
    """A contiguous x whose data starts 2 bytes past a 16-byte boundary
    takes the scalar path, with the same result as an aligned copy."""
    R, D = 300, 768
    base = _randn((R * D + 1,), torch.bfloat16, cuda, seed=5, scale=3.0)
    x = base[1:].view(R, D)
    assert x.data_ptr() % 16 != 0
    w = _randn((D,), torch.float32, cuda, seed=1, scale=0.1) + 1.0
    b = _randn((D,), torch.float32, cuda, seed=2)
    y = layernorm_triton.layer_norm(x, w, b)
    torch.testing.assert_close(y.float(), layernorm_triton.layer_norm_plain(
        x, w, b).float(), **BF16_TOL)


def test_layernorm_cuda_kernel_rejects_what_it_cannot_take(cuda):
    x = _randn((4, 768), torch.bfloat16, cuda)
    w = torch.ones(768, device=cuda)
    b = torch.zeros(768, device=cuda)
    for bad in (dict(x=x.t()), dict(x=x.double()), dict(w=w.half()),
                dict(b=b[:512]), dict(w=w.cpu())):
        args = {**dict(x=x, w=w, b=b), **bad}
        with pytest.raises(ValueError):
            layernorm_triton.layer_norm(args["x"], args["w"], args["b"])


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
    """Past MAX_N the member masks pass 32-bit indices: raised before the
    distances are computed; and K past N."""
    X = _randn((1, kmedoids_cuda.MAX_N + 1, 16), torch.float32, cuda)
    with pytest.raises(ValueError, match=str(kmedoids_cuda.MAX_N)):
        kmedoids_cuda.kmedoids(X, 49)
    X = _randn((1, 2352, 16), torch.float32, cuda)
    with pytest.raises(ValueError, match="K <= N"):
        kmedoids_cuda.kmedoids(X, 2353)


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
    (2, 50, 2, 192, torch.float32, False, False),   # fp32 past head_dim 128
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


# the long variants (L > 128): 64-row tiles, the last one ragged; past 4
# key tiles, 1 + K after a cluster layer of K = 256, 392, 588 and 784
LONG_CASES = [(L, dtype, False)
              for L in (129, 131, 161, 197, 256, 257, 393, 589, 785)
              for dtype in (torch.bfloat16, torch.float16)] + [
    (393, torch.bfloat16, True),
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


@pytest.mark.parametrize("B,L", [(1536, 197), (768, 161), (384, 393)])
def test_attention_long_vitb16_shapes(cuda, B, L):
    """ViT-B/16's full-width shapes (12 heads of 64, the recipe's batch of
    128 clips x 12 or 6 frames, or x 3 segments of 4 frames clustered to
    K = 392): both long kernels within one ulp, the backward through the
    autograd Function to the bit."""
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
    CTAs per SM their launch bounds aim at (4 for A, 3 for B's two; in
    fp32, tf32x3's, 4 for A and 3 for B's two at head_dim 64, 1 at 128)."""
    fwd = attention_cuda.long_occupancy(torch.bfloat16, 64)
    bwd = attention_cuda.long_occupancy(torch.bfloat16, 64, backward=True)
    assert fwd["attention_fwd_long_kernel"]["ctas_per_sm"] >= 4, fwd
    assert all(v["ctas_per_sm"] >= 3 for v in bwd.values()), bwd
    fwd = attention_cuda.long_occupancy(torch.float32, 64)
    assert fwd["attention_fwd_tf32x3_kernel"]["ctas_per_sm"] >= 4, fwd
    for hd, ctas in ((64, 3), (128, 1)):
        bwd = attention_cuda.long_occupancy(torch.float32, hd, backward=True)
        assert set(bwd) == {"attention_bwd_tf32x3_dq_kernel",
                            "attention_bwd_tf32x3_dkv_kernel"}, bwd
        assert all(v["ctas_per_sm"] >= ctas for v in bwd.values()), bwd


# the fp32 tensor-core variant (TF32X3): one 64-row tile and less, past
# it, ragged tiles and tails of 1-7 keys, ViT-B/16's L = 161 and 197,
# K = 392's 393, L = 785; a causal mask on some (no mask gradient)
FP32_LONG_CASES = [(1, False), (8, True), (32, True), (49, False),
                   (64, False), (77, True), (129, True), (161, False),
                   (197, False), (197, True), (393, False), (785, True)]


@pytest.mark.parametrize("L,causal", FP32_LONG_CASES)
def test_attention_fp32_long_matches_plain(cuda, L, causal):
    """Kernels A and B's tf32x3 variant within the fp32 tolerances (1e-5
    forward, 1e-4 backward) of the plain versions, B twice equal to the
    bit (called alone, it launches A for O and the log-sum-exp first),
    each counted under its variant."""
    B, H = 3, 12
    x3 = attention_cuda.TF32X3
    qkv = _randn((B, L, 3 * H * 64), torch.float32, cuda, seed=L + 7)
    dout = _randn((B, L, H * 64), torch.float32, cuda, seed=L + 8)
    mask = _causal(L, cuda) if causal else None
    f0 = _variant_counts(attention_cuda.fused_attention)
    b0 = _variant_counts(attention_cuda.attention_backward)
    out = attention_cuda._forward(qkv, H, mask, variant=x3)
    dqkv, _ = attention_cuda.attention_backward(qkv, dout, H, mask,
                                                variant=x3)
    again, _ = attention_cuda.attention_backward(qkv, dout, H, mask,
                                                 variant=x3)
    torch.cuda.synchronize()
    for fn, before, n in ((attention_cuda.fused_attention, f0, 3),
                          (attention_cuda.attention_backward, b0, 2)):
        assert fn.variant_launches[x3] == before[x3] + n
    assert torch.equal(dqkv, again)
    torch.testing.assert_close(out, attention_cuda.attention_plain(
        qkv, H, mask), rtol=1e-5, atol=1e-5)
    ref, _ = attention_cuda.attention_bwd_plain(qkv, dout, H, mask)
    torch.testing.assert_close(dqkv, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hd", [16, 32, 33, 40, 96, 128])
def test_attention_fp32_long_head_dims(cuda, hd):
    """Any head_dim <= 128: 16-byte copies where it is a multiple of 4,
    4-byte ones else; channels padded to 8; one or two 64-channel groups
    of the outputs in registers; a causal mask."""
    B, L, H = 2, 197, 2
    x3 = attention_cuda.TF32X3
    qkv = _randn((B, L, 3 * H * hd), torch.float32, cuda, seed=hd)
    dout = _randn((B, L, H * hd), torch.float32, cuda, seed=hd + 1)
    mask = _causal(L, cuda)
    assert attention_cuda.choose_variant(torch.float32, hd, L) == x3
    torch.testing.assert_close(
        attention_cuda._forward(qkv, H, mask, variant=x3),
        attention_cuda.attention_plain(qkv, H, mask), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        attention_cuda.attention_backward(qkv, dout, H, mask,
                                          variant=x3)[0],
        attention_cuda.attention_bwd_plain(qkv, dout, H, mask)[0],
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("L,causal", [(77, True), (197, False)])
def test_attention_tf32x3_function_saves_the_forward_statistics(cuda, L,
                                                                causal):
    """Through the autograd Function, B takes A's output and log-sum-exp
    (no second A launch) and gives the bits of B called alone; the
    log-sum-exp is the rows' within the fp32 tolerance; under no_grad the
    Function's output is the same."""
    B, H = 4, 12
    x3 = attention_cuda.TF32X3
    qkv = _randn((B, L, 3 * H * 64), torch.float32, cuda, seed=L)
    dout = _randn((B, L, H * 64), torch.float32, cuda, seed=L + 1)
    mask = _causal(L, cuda) if causal else None
    assert attention_cuda.choose_variant(torch.float32, 64, L) == x3
    assert attention_cuda.choose_variant(torch.float32, 64, L, True) == x3
    x = qkv.clone().requires_grad_(True)
    f0 = _variant_counts(attention_cuda.fused_attention)
    out = attention_cuda.fused_attention(x, H, mask)
    out.backward(dout)
    torch.cuda.synchronize()
    assert _variant_counts(attention_cuda.fused_attention)[x3] == f0[x3] + 1
    dqkv, _ = attention_cuda.attention_backward(qkv, dout, H, mask)
    assert torch.equal(x.grad, dqkv)
    o2, lse = attention_cuda._forward(qkv, H, mask, lse_out=True)
    assert torch.equal(o2, out.detach())
    q, k = (t.reshape(B, L, H, 64).transpose(1, 2)
            for t in qkv.split(H * 64, dim=-1)[:2])
    s = (q * 0.125) @ k.transpose(-1, -2)
    if mask is not None:
        s = s + mask
    torch.testing.assert_close(lse.reshape(B, H, L), torch.logsumexp(s, -1),
                               rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        assert torch.equal(attention_cuda.fused_attention(x, H, mask), o2)


@pytest.mark.parametrize("B,L", [(1536, 197), (768, 161), (384, 393)])
def test_attention_fp32_vitb16_shapes(cuda, B, L):
    """ViT-B/16's full-width fp32 shapes: both fp32 long kernels within
    the fp32 tolerances, the backward through the autograd Function to the
    bit."""
    H = 12
    qkv = _randn((B, L, 3 * H * 64), torch.float32, cuda, seed=B + L)
    dout = _randn((B, L, H * 64), torch.float32, cuda, seed=B + L + 1)
    x = qkv.clone().requires_grad_(True)
    out = attention_cuda.fused_attention(x, H)
    out.backward(dout)
    dqkv, _ = attention_cuda.attention_backward(qkv, dout, H)
    assert torch.equal(x.grad, dqkv)
    torch.testing.assert_close(out.detach(), attention_cuda.attention_plain(
        qkv, H), rtol=1e-5, atol=1e-5)
    del out, x
    ref, _ = attention_cuda.attention_bwd_plain(qkv, dout, H)
    torch.testing.assert_close(dqkv, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("L", [32, 40, 50, 77, 108])
def test_attention_fp32_variants_agree_where_both_run(cuda, L):
    """Where the CUDA-core variant fits too, the two fp32 variants agree
    within the fp32 tolerances (other sums, other orders)."""
    B, H = 4, 8
    qkv = _randn((B, L, 3 * H * 64), torch.float32, cuda, seed=L + 3)
    dout = _randn((B, L, H * 64), torch.float32, cuda, seed=L + 4)
    mask = _causal(L, cuda)
    outs = [attention_cuda._forward(qkv, H, mask, variant=v)
            for v in attention_cuda.FP32_VARIANTS]
    grads = [attention_cuda.attention_backward(qkv, dout, H, mask,
                                               variant=v)[0]
             for v in attention_cuda.FP32_VARIANTS]
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-4, atol=1e-4)


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
    dout = _randn((2, 257, 768), torch.bfloat16, cuda)
    with pytest.raises(ValueError):                     # L = 129: no dmask
        attention_cuda.attention_backward(
            _randn((1, 129, 3 * 128), torch.float16, cuda),
            _randn((1, 129, 128), torch.float16, cuda), 2,
            _causal(129, cuda), mask_grad=True)
    with pytest.raises(ValueError):                     # hd % 16
        attention_cuda.attention_backward(
            _randn((1, 50, 3 * 80), torch.bfloat16, cuda),
            _randn((1, 50, 80), torch.bfloat16, cuda), 2)
    with pytest.raises(ValueError):                     # fp32 head_dim > 128
        attention_cuda.attention_backward(
            _randn((1, 197, 3 * 768), torch.float32, cuda),
            _randn((1, 197, 768), torch.float32, cuda), 4)
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


@pytest.mark.parametrize("fsdp", [False, True])
def test_one_nccl_rank_steps_equal_the_unwrapped_steps(cuda, monkeypatch,
                                                       fsdp):
    """DDP, or FSDP, over a world of one NCCL rank: two steps of a 2 + 2
    block clustered model launch all five kernels (kernel D on the default
    stream only) and give the unwrapped steps' losses, gradients and
    parameters to the bit."""
    import socket
    import torch.distributed as dist
    from centerclip_tpu_torch import parallel
    from centerclip_tpu_torch.train import Trainer
    from centerclip_tpu_torch.train.loop import make_train_step
    monkeypatch.setitem(port_config.CLIP_ARCHS, "tiny-gpu-dp", dict(
        embed_dim=32, image_resolution=64, vision_layers=2, vision_width=128,
        vision_patch_size=16, vision_heads=2, context_length=16,
        vocab_size=100, transformer_width=128, transformer_heads=2,
        transformer_layers=2))
    kw = dict(clip_name="tiny-gpu-dp", max_frames=4, max_words=16,
              inter=True, algo="kmediods++", cluster_num_blocks=(8, 8),
              target_frames_blocks=(4, 2), optim="AdamW", lr=1e-3)
    g = np.random.default_rng(0)
    batches = []
    for _ in range(2):
        ids = g.integers(1, 98, (4, 16))
        ids[:, -1] = 99
        batches.append({
            "input_ids": ids, "attention_mask": np.ones((4, 16), np.int32),
            "video": g.integers(0, 256, (4, 1, 4, 3, 64, 64),
                                dtype=np.uint8),
            "video_mask": np.ones((4, 4), np.int32)})
    counters = (attention_cuda.fused_attention,
                attention_cuda.attention_backward, layernorm_triton.layer_norm,
                layernorm_triton.layer_norm_backward,
                kmedoids_cuda.kmedoids_from_distances)
    streams = []
    tickets = layernorm_triton._tickets

    def recording(device, n):
        streams.append(torch.cuda.current_stream(device).cuda_stream)
        return tickets(device, n)
    monkeypatch.setattr(layernorm_triton, "_tickets", recording)

    def steps(run):
        model = CLIP4Clip(run.model, device=cuda, seed=0)
        trainer = Trainer(run, model, total_steps=4)
        step = make_train_step(trainer.module, trainer.optimizer)
        losses, grads = [], []
        for b in batches:
            losses.append(float(step(b)["loss"]))
            grads.append(parallel.fetch_replicated(
                {n: p.grad for n, p in model.named_parameters()
                 if p.grad is not None}))
        return losses, grads, parallel.fetch_replicated(model.state_dict())

    ref = steps(port_config.make_run_config(**kw))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for k, v in dict(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                     RANK="0", WORLD_SIZE="1", LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    parallel.init_distributed()
    try:
        before = [fn.launches for fn in counters]
        streams.clear()
        got = steps(port_config.make_run_config(data_parallel=1, fsdp=fsdp,
                                                **kw))
        torch.cuda.synchronize()
        assert all(fn.launches > b for fn, b in zip(counters, before))
    finally:
        dist.destroy_process_group()
    assert set(streams) == {torch.cuda.default_stream(cuda).cuda_stream}
    dev = torch.device("cuda", torch.cuda.current_device())
    assert int(layernorm_triton._ticket_buffers[dev].abs().sum()) == 0
    assert got[0] == ref[0]
    for a, b in ((got[1][0], ref[1][0]), (got[1][1], ref[1][1]),
                 (got[2], ref[2])):
        assert sorted(a) == sorted(b)
        for k in b:
            assert torch.equal(a[k], b[k]), k


# ------------------------------------------- tensor and sequence parallelism
# a rank's heads under tensor parallelism: ViT-B/32's 12 vision heads over
# 2 or 4 ranks (qkv [N, 50, 1152] / [N, 50, 576]), the text tower's 8
# (qkv [128, 32, 768] / [128, 32, 384], causal)
@pytest.mark.parametrize("B,L,H,causal", [(768, 50, 6, False),
                                          (1536, 50, 3, False),
                                          (128, 32, 4, True),
                                          (128, 32, 2, True)])
def test_attention_kernels_at_tensor_parallel_shapes(cuda, B, L, H, causal):
    """Kernels A and B on a rank's local heads against their plain
    versions, within one bf16 ulp."""
    qkv = _randn((B, L, 3 * 64 * H), torch.bfloat16, cuda, seed=B + H)
    dout = _randn((B, L, 64 * H), torch.bfloat16, cuda, seed=B + H + 1)
    mask = _causal(L, cuda) if causal else None
    a0 = attention_cuda.fused_attention.launches
    b0 = attention_cuda.attention_backward.launches
    out = attention_cuda.fused_attention(qkv, H, mask)
    dqkv, _ = attention_cuda.attention_backward(qkv, dout, H, mask)
    torch.cuda.synchronize()
    assert attention_cuda.fused_attention.launches == a0 + 1
    assert attention_cuda.attention_backward.launches == b0 + 1
    assert out.shape == (B, L, 64 * H) and dqkv.shape == qkv.shape
    torch.testing.assert_close(
        out.float(), attention_cuda.attention_plain(qkv, H, mask).float(),
        **BF16_TOL)
    ref, _ = attention_cuda.attention_bwd_plain(qkv, dout, H, mask)
    torch.testing.assert_close(dqkv.float(), ref.float(), **BF16_TOL)


# a rank's LayerNorm rows under sequence parallelism: ceil(50 / tp) vision
# tokens of 768 clips (tp 2) or 1536 (tp 4), 32 / tp text tokens
@pytest.mark.parametrize("R,D", [(768 * 25, 768), (1536 * 13, 768),
                                 (64 * 16, 512), (128 * 8, 512)])
def test_layernorm_kernels_at_sequence_parallel_rows(cuda, R, D):
    """Kernels C and D on a rank's token chunk against their plain
    versions (dx within one bf16 ulp; dgamma and dbeta, the partial sums
    the model group then adds, within SUM_RTOL of the terms' sum)."""
    x = _randn((R, D), torch.bfloat16, cuda, seed=R, scale=3.0) + 1.5
    w = _randn((D,), torch.float32, cuda, seed=1, scale=0.1) + 1.0
    b = _randn((D,), torch.float32, cuda, seed=2)
    dy = _randn((R, D), torch.bfloat16, cuda, seed=3)
    y = layernorm_triton.layer_norm(x, w, b)
    torch.testing.assert_close(
        y.float(), layernorm_triton.layer_norm_plain(x, w, b).float(),
        **BF16_TOL)
    _check_ln_bwd(x, w, dy, layernorm_triton.layer_norm_backward(x, w, dy))


# ------------------------------------------------- pipeline parallelism
# a stage's microbatch under pipeline parallelism (M = 4 S): ViT-B/32's
# 96 or 48 frames before and after the cluster layer and 8 texts (the pipe
# meshes at the global 128), 48 / 24 frames and 4 texts (two stages at 32)
@pytest.mark.parametrize("B,L,H,causal", [(96, 50, 12, False),
                                          (48, 50, 12, False),
                                          (24, 50, 12, False),
                                          (8, 32, 8, True),
                                          (4, 32, 8, True)])
def test_attention_kernels_at_pipeline_microbatch_shapes(cuda, B, L, H,
                                                         causal):
    """Kernels A and B on a stage's microbatch against their plain
    versions, within one bf16 ulp."""
    test_attention_kernels_at_tensor_parallel_shapes(cuda, B, L, H, causal)


@pytest.mark.parametrize("R,D", [(96 * 50, 768), (48 * 50, 768),
                                 (8 * 32, 512)])
def test_layernorm_kernels_at_pipeline_microbatch_rows(cuda, R, D):
    """Kernels C and D on a stage's microbatch rows against their plain
    versions (as at the sequence-parallel rows)."""
    test_layernorm_kernels_at_sequence_parallel_rows(cuda, R, D)


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
def _check_kmedoids_on_distances(X, K, iter_limit=100, id_sort=True,
                                 variant=None):
    """The kernel (the router's variant, or `variant`) against
    `kmedoids_on_distances` on the same distances: ids equal on >= 95 % of
    the segments, and where a fp32 summation-order tie picked another
    medoid, the costs equal to 1e-6; assignments equal wherever the
    medoids are."""
    from centerclip_tpu_torch.ops.kmedoids import kmedoids_on_distances
    Xf, D, l2 = kmedoids_inputs(X)
    before = kmedoids_cuda.kmedoids_from_distances.launches
    a1, m1, steps = kmedoids_cuda.kmedoids_from_distances(
        D, l2, K, iter_limit=iter_limit, id_sort=id_sort, variant=variant)
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


@pytest.mark.parametrize("N,K", [(257, 100), (392, 160), (512, 200)])
def test_kmedoids_cluster_variant_equals_global(cuda, N, K):
    """Where both run, the cluster variant (forced below its range, on 1,
    2 and 8 CTAs a segment) gives the global one's bits: the same steps on
    a cluster of CTAs."""
    X = _blobs(48, N, 64, 40, seed=N, device=cuda)
    _, D, l2 = kmedoids_inputs(X)
    ref = kmedoids_cuda.kmedoids_from_distances(
        D, l2, K, variant=kmedoids_cuda.GLOBAL)
    for cs in (1, 2, 8):
        got = kmedoids_cuda.kmedoids_from_distances(
            D, l2, K, variant=kmedoids_cuda.CLUSTER, cluster=cs)
        torch.cuda.synchronize()
        for a, b in zip(ref, got):
            assert torch.equal(a, b), cs


@pytest.mark.parametrize("B,N,K", [
    (2, 3920, 160),     # a 20-frame ViT-B/16 segment
    (1, 3920, 392),
    (2, 2352, 2352),    # a 12-frame clip, every token a medoid
    (1, 3137, 160),     # past 16 frames of 196 tokens
    (2, 2352, 1000),    # member masks past a CTA
])
def test_kmedoids_scratch_variant_matches_plain(cuda, B, N, K):
    """The scratch variant, forced (the router gives these N and K the
    cluster variant)."""
    assert kmedoids_cuda.choose_variant(N, K) == kmedoids_cuda.CLUSTER
    before = dict(kmedoids_cuda.kmedoids_from_distances.variant_launches)
    X = _blobs(B, N, 64, 60, seed=N + K, device=cuda)
    _check_kmedoids_on_distances(X, K, variant=kmedoids_cuda.SCRATCH)
    after = kmedoids_cuda.kmedoids_from_distances.variant_launches
    assert after[kmedoids_cuda.SCRATCH] == before[kmedoids_cuda.SCRATCH] + 1


@pytest.mark.parametrize("B,N,K,span", [(2, 3920, 160, 3000),
                                        (2, 3920, 392, 300),
                                        (2, 2352, 2352, 3000),
                                        # the state past shared memory too
                                        (1, 18000, 160, 3000)])
def test_kmedoids_scratch_variant_equals_plain_ids_and_steps(cuda, B, N, K,
                                                             span):
    """On integer distances (every sum exact in any order) the scratch
    variant and the variant the router gives (the cluster one at these N
    and K) give the plain version's ids and assignment in every segment,
    and each segment's Lloyd steps are the plain version's steps to its
    fixed point."""
    from centerclip_tpu_torch.ops.kmedoids import (fixed_point_steps,
                                                   kmedoids_on_distances)
    X, D, l2 = _line_distances(B, N, N + K + span, cuda, span)
    assert kmedoids_cuda.choose_variant(N, K) == kmedoids_cuda.CLUSTER
    a2, m2 = kmedoids_on_distances(X, D, l2, K, iter_limit=100)
    want = fixed_point_steps(D, l2, K, 100)
    for variant in (None, kmedoids_cuda.SCRATCH):
        a1, m1, steps = kmedoids_cuda.kmedoids_from_distances(
            D, l2, K, variant=variant)
        assert torch.equal(m1, m2), variant
        assert torch.equal(a1, a2), variant
        assert torch.equal(steps, want), variant


@pytest.mark.parametrize("B,N,K", [
    (16, 513, 160),     # the first N past the global variant's
    (32, 588, 160),     # ViT-B/16, segments of 3 frames
    (16, 784, 160),     # ViT-B/16, segments of 4 frames
    (8, 784, 392),
    (2, 2352, 160),     # a whole 12-frame ViT-B/16 clip
    (2, 2352, 2352),    # every token a medoid
    (1, 3137, 160),     # past 16 frames of 196 tokens
    (2, 3920, 160),     # a 20-frame ViT-B/16 segment
    (1, 3920, 392),
])
def test_kmedoids_cluster_variant_matches_plain(cuda, B, N, K):
    """The router's variant past N = 512, on clusters of the size it
    picks."""
    assert kmedoids_cuda.choose_variant(N, K) == kmedoids_cuda.CLUSTER
    before = dict(kmedoids_cuda.kmedoids_from_distances.variant_launches)
    X = _blobs(B, N, 64, 60, seed=N + K + 1, device=cuda)
    _check_kmedoids_on_distances(X, K)
    after = kmedoids_cuda.kmedoids_from_distances.variant_launches
    assert after[kmedoids_cuda.CLUSTER] == before[kmedoids_cuda.CLUSTER] + 1


@pytest.mark.parametrize("B,N,K,data", [
    (16, 784, 160, "blobs"), (8, 588, 294, "blobs"),
    (4, 2352, 160, "blobs"), (2, 2352, 2352, "blobs"),
    (2, 3137, 160, "blobs"), (2, 3920, 160, "blobs"),
    (2, 3920, 392, "blobs"), (8, 784, 160, "line"),
    (2, 3920, 160, "line"), (2, 2352, 2352, "line")])
def test_kmedoids_cluster_variant_equals_scratch(cuda, B, N, K, data):
    """At every cluster size that holds the segment (1, 2, 4, 8, 16 CTAs),
    the cluster variant gives the bits of the scratch variant (whose steps
    the large variant these N took before it ran too): ids, assignment and
    each segment's Lloyd steps, in full, after one step and with no step,
    sorted or not; two runs give the same bits."""
    if data == "blobs":
        X = _blobs(B, N, 64, 60, seed=N + K, device=cuda)
        _, D, l2 = kmedoids_inputs(X)
    else:
        _, D, l2 = _line_distances(B, N, N + K, cuda, 300)
    parent = kmedoids_cuda.SCRATCH
    sizes = [cs for cs in kmedoids_cuda.CLUSTER_SIZES
             if kmedoids_cuda.cluster_fits(N, K, cs)]
    assert sizes[-1] == 16 and len(sizes) >= (2 if K == N else 4)
    for iter_limit, id_sort in ((100, True), (1, True), (0, True),
                                (100, False)):
        ref = kmedoids_cuda.kmedoids_from_distances(
            D, l2, K, iter_limit, id_sort, variant=parent)
        for cs in sizes:
            for run in range(2 if iter_limit == 100 and id_sort else 1):
                got = kmedoids_cuda.kmedoids_from_distances(
                    D, l2, K, iter_limit, id_sort,
                    variant=kmedoids_cuda.CLUSTER, cluster=cs)
                torch.cuda.synchronize()
                for a, b in zip(ref, got):
                    assert torch.equal(a, b), (iter_limit, id_sort, cs, run)


def test_kmedoids_cluster_layout_is_the_sources(cuda):
    """`cluster_smem_bytes`, which `cluster_fits` and the router read, is
    the source's own, and its static shared memory is within
    CLUSTER_STATIC_SMEM (nvcc reports 2176 bytes)."""
    lib = _build.load("kmedoids")
    for N, K, cs in ((513, 160, 16), (784, 160, 1), (2352, 2352, 16),
                     (3920, 160, 8), (3920, 392, 2), (18000, 160, 16)):
        assert kmedoids_cuda.cluster_smem_bytes(N, K, cs) == \
            _build.smem_bytes(lib, "cc_kmedoids_cluster_smem_bytes", N, K,
                              cs)
    assert 2176 <= kmedoids_cuda.CLUSTER_STATIC_SMEM


def test_kmedoids_cluster_sizes_are_resident(cuda):
    """The card holds a cluster of every size that fits at ViT-B/16's
    shapes, and the size the router picks keeps the path's segments
    resident at once where the card can (8 CTAs for the 20-frame step's
    48 segments of 3920, K = 160)."""
    dev = torch.device("cuda")
    for B, N, K in ((48, 3920, 160), (96, 3920, 160), (8, 2352, 160),
                    (384, 784, 160), (512, 588, 160), (8, 2352, 2352)):
        res = kmedoids_cuda.resident_clusters(dev, N, K)
        assert all(n > 0 for n in res.values()), (N, K, res)
        cs = kmedoids_cuda.device_cluster_size(dev, B, N, K)
        assert B <= res[cs], (B, N, K, cs, res)
    assert kmedoids_cuda.device_cluster_size(dev, 48, 3920, 160) == 8


def test_kmedoids_cluster_variant_rejects_what_it_cannot_take(cuda):
    X = _blobs(2, 600, 16, 10, seed=1, device=cuda)
    _, D, l2 = kmedoids_inputs(X)
    for cs in (3, 32):                  # not a size; past 16 CTAs
        with pytest.raises(ValueError, match="CTAs"):
            kmedoids_cuda.kmedoids_from_distances(
                D, l2, 6, variant=kmedoids_cuda.CLUSTER, cluster=cs)
    X = _blobs(1, 3920, 16, 10, seed=1, device=cuda)
    _, D, l2 = kmedoids_inputs(X)
    with pytest.raises(ValueError, match="CTAs"):   # K = 392 on one CTA
        kmedoids_cuda.kmedoids_from_distances(
            D, l2, 392, variant=kmedoids_cuda.CLUSTER, cluster=1)


def test_attention_tf32x3_layout_is_the_sources(cuda):
    """The tf32x3 kernels' shared memory, as the sources size it, is the
    layout tests/test_torch_attention_design.py holds (52 224 bytes
    forward, 69 888 backward at head_dim 64) and does not grow with L."""
    fwd, bwd = _build.load("attention"), _build.load("attention_bwd")
    for L in (1, 197, 785):
        assert _build.smem_bytes(fwd, "cc_attention_tf32x3_smem_bytes", L,
                                 64) == 52_224
        assert _build.smem_bytes(bwd, "cc_attention_bwd_tf32x3_smem_bytes",
                                 L, 64) == 69_888
    assert _build.smem_bytes(bwd, "cc_attention_bwd_tf32x3_smem_bytes", 197,
                             128) <= _build.MAX_SMEM_BYTES


def test_attention_fp32_short_layout_is_the_sources(cuda):
    """`fp32_short_smem_bytes`, which `choose_variant` reads, is the
    sources' own `simt_smem`, forward and backward."""
    for backward, src, fn in ((False, "attention",
                               "cc_attention_simt_smem_bytes"),
                              (True, "attention_bwd",
                               "cc_attention_bwd_simt_smem_bytes")):
        lib = _build.load(src)
        for L, hd in ((32, 64), (40, 512), (77, 33), (108, 64), (163, 64)):
            assert attention_cuda.fp32_short_smem_bytes(L, hd, backward) \
                == _build.smem_bytes(lib, fn, L, hd)


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


def _line_distances(B, N, seed, device, span=1000):
    """D [B, N, N] of B segments of N integers on a line (repeats allowed)
    with both tricks applied: small integers, so every fp32 sum is exact
    in any order, and distances tie often."""
    g = np.random.default_rng(seed)
    p = torch.from_numpy(g.integers(0, span, (B, N)).astype(np.float32))
    dis = (p[:, :, None] - p[:, None, :]).abs()
    D = dis - dis.amax(dim=(1, 2), keepdim=True) - 1.0 - torch.eye(N)
    return p[..., None].to(device), D.to(device), p.abs().to(device)


@pytest.mark.parametrize("B,N,K,span", [(64, 392, 160, 1000),
                                        (192, 392, 160, 300),
                                        (16, 300, 120, 60),
                                        (64, 784, 160, 1000),
                                        (32, 588, 294, 300),
                                        (4, 2352, 392, 3000)])
def test_kmedoids_global_variant_equals_plain_ids_and_steps(cuda, B, N, K,
                                                            span):
    """Where the plain version's sums are exact too (integer distances),
    the global variant (the cluster one past N = 512) gives its ids and
    assignment in every segment, and each segment's Lloyd steps are the
    plain version's steps to its fixed point."""
    from centerclip_tpu_torch.ops.kmedoids import (fixed_point_steps,
                                                   kmedoids_on_distances)
    X, D, l2 = _line_distances(B, N, N + K + span, cuda, span)
    assert kmedoids_cuda.choose_variant(N) == (
        kmedoids_cuda.GLOBAL if N <= 512 else kmedoids_cuda.CLUSTER)
    a1, m1, steps = kmedoids_cuda.kmedoids_from_distances(D, l2, K)
    a2, m2 = kmedoids_on_distances(X, D, l2, K, iter_limit=100)
    assert torch.equal(m1, m2)
    assert torch.equal(a1, a2)
    assert torch.equal(steps, fixed_point_steps(D, l2, K, 100))


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


def _tiny_main_argv(tmp_path, monkeypatch):
    """`main`'s flags for a tiny model (2 + 2 blocks, 16 patch tokens of
    64 x 64 frames, 4 -> 2 frames before block 2) on a tiny MSR-VTT in a
    .fstore under `tmp_path`."""
    import csv
    import dataclasses
    import json
    from centerclip_tpu_torch import cli
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
    return argv


def test_main_trains_and_reloads_on_the_card(cuda, tmp_path, monkeypatch):
    """`main` at a tiny size on the card (bf16, a .fstore): every kernel
    launches, and an eval-only reload of its checkpoint gives the same
    similarity matrix to the bit."""
    import json
    from centerclip_tpu_torch import main as port_main
    from centerclip_tpu_torch.train import evaluate
    argv = _tiny_main_argv(tmp_path, monkeypatch)
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


@pytest.mark.parametrize("flags", [
    ["--cluster_algo", "spectral", "--spectral_graph", "KNN"],
    ["--cluster_algo", "sparse_sampling"],
    ["--cluster_inter", "0", "--deep_cluster", "1"]])
def test_main_trains_the_other_cluster_algorithms_on_the_card(
        cuda, tmp_path, monkeypatch, flags):
    """`main` with another algorithm's flags (the later flag wins) on the
    card: kernels A-D launch, E only for spectral (its embedding's
    k-medoids), finite losses, a positive cluster loss for deep_cluster
    only, an evaluation."""
    import json
    from centerclip_tpu_torch import main as port_main
    argv = _tiny_main_argv(tmp_path, monkeypatch) + flags
    counters = (attention_cuda.fused_attention,
                attention_cuda.attention_backward, layernorm_triton.layer_norm,
                layernorm_triton.layer_norm_backward,
                kmedoids_cuda.kmedoids_from_distances)
    before = [fn.launches for fn in counters]
    best = port_main.main(argv)
    moved = [fn.launches > b for fn, b in zip(counters, before)]
    assert moved == [True] * 4 + ["spectral" in flags]
    assert 0.0 <= best <= 100.0
    with open(tmp_path / "out" / "tensorboard" / "scalars.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert len(recs) == 2
    for r in recs:
        assert np.isfinite(r["train/sim_loss"])
        assert (r["train/cluster_loss"] > 0) == ("--deep_cluster" in flags)


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


# --------------------------------------------- the other cluster algorithms
def _spectral_tokens(B, seed, device):
    """B segments of 98 tokens of width 768 in 7 planted groups, as the
    cluster layer hands them to spectral clustering (fp32)."""
    return _blobs(B, 98, 768, 7, seed=seed, device=device) * 0.05


@pytest.mark.parametrize("solver", ["eigh", "subspace"])
def test_spectral_embedding_on_the_card_matches_plain(cuda, solver):
    """L_sym and its eigensolve on the card (no host round trip) against
    the CPU on the same tokens: eigenvalues within 1e-4, the projector onto
    the first K eigenvectors within 1e-3 (planted groups: a clear gap).
    The heat-kernel graph: a KNN graph's edges at its k-th neighbour flip
    with the distances' rounding, so card and CPU may hold other graphs.
    L_sym within 1e-5 + 1e-4 relative: each squared distance (~1e2) sums
    768 fp32 products in an order that differs between the CPU and the
    card's cuBLAS kernel (whose choice may change from run to run), some
    1e-4 apart, which moves the affinities by ~1e-5 relative.
    `subspace` takes the JAX package's 12 steps from its cosine basis,
    which lies nearly orthogonal to these groups' eigenvectors: where the
    CPU's residual |L v - lambda v| shows a pair left unconverged (above
    1e-2), that pair's Ritz value moves with rounding, and the eigenvalues
    are held within 1e-3; 24 steps converge every pair, held within 1e-4."""
    from centerclip_tpu_torch.ops import spectral
    X = _spectral_tokens(24, 1, cuda)
    L = spectral.normalized_laplacian(X, 2.0, "HeatKernel", 10)
    K = 7

    def solve(L_sym, iters=12):
        if solver == "eigh":
            lam, vec = torch.linalg.eigh(L_sym)
            return lam[:, :K], vec[..., :K]
        return spectral._smallest_eigvecs_subspace(L_sym, K, iters=iters)
    lam, vec = solve(L)
    assert lam.is_cuda and vec.is_cuda
    Lc = spectral.normalized_laplacian(X.cpu(), 2.0, "HeatKernel", 10)
    lam_c, vec_c = solve(Lc)
    residual = torch.linalg.vector_norm(
        Lc @ vec_c - vec_c * lam_c[:, None, :], dim=1).max().item()
    torch.testing.assert_close(L.cpu(), Lc, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(lam.cpu(), lam_c, rtol=0,
                               atol=1e-3 if residual > 1e-2 else 1e-4)
    torch.testing.assert_close((vec @ vec.mT).cpu(), vec_c @ vec_c.mT,
                               rtol=0, atol=1e-3)
    if solver == "subspace":
        lam, _ = solve(L, iters=24)
        lam_c, vec_c = solve(Lc, iters=24)
        assert torch.linalg.vector_norm(
            Lc @ vec_c - vec_c * lam_c[:, None, :], dim=1).max() < 1e-3
        torch.testing.assert_close(lam.cpu(), lam_c, rtol=0, atol=1e-4)


def test_kmedoids_kernel_on_spectral_embeddings(cuda):
    """Kernel E at the spectral path's shape: the row-normalised embedding
    [768, 98, 49] of ViT-B/32-wide tokens in planted groups (a KNN graph
    with edges between tokens, not W = I), D [768, 98, 98], K = 49."""
    from centerclip_tpu_torch.ops import spectral
    X = _spectral_tokens(768, 0, cuda)
    Q = spectral.spectral_embedding(X, 49, mode="KNN", knn_k=10, sigma=2.0)
    assert Q.shape == (768, 98, 49)
    _check_kmedoids_on_distances(Q, 49)


def test_spectral_layer_on_the_card_matches_plain(cuda):
    """The spectral cluster layer at ViT-B/32's shapes (2 clips of 12
    frames, 49 + 1 tokens, width 768, 12 -> 6 frames, K = 49), bf16, on
    tokens in planted groups (at randn's scale the heat kernel underflows
    off the diagonal): the card's output against the CPU's with the card's
    medoid ids replayed."""
    from centerclip_tpu_torch.ops.cluster_layer import TokenClusterInter
    spec = port_config.BlockClusterSpec(
        block_id=7, algo="spectral", before_cluster_num=49, cluster_num=49,
        before_frames=12, after_frames=6, frame_duration=2, spectral_knn_k=10)
    cfg = port_config.ClusterConfig(inter=True, algo="spectral",
                                    spectral_graph="KNN")
    x = (_blobs(24, 50, 768, 7, seed=7, device=cuda) * 0.05).bfloat16()
    mod = TokenClusterInter(spec, cfg, 768)
    chosen = []

    def record(res_tmp, own=mod._cluster):
        out = own(res_tmp)
        chosen.append(tuple(a.cpu() for a in out))
        return out
    mod._cluster = record
    before = kmedoids_cuda.kmedoids_from_distances.launches
    out = mod(x)
    torch.cuda.synchronize()
    assert kmedoids_cuda.kmedoids_from_distances.launches == before + 1
    assert out.shape == (12, 50, 768) and out.dtype == torch.bfloat16
    cpu = TokenClusterInter(spec, cfg, 768)
    cpu._cluster = lambda res_tmp: chosen[0]
    torch.testing.assert_close(out.cpu(), cpu(x.cpu()), rtol=0, atol=0)


@pytest.mark.parametrize("algo", ["kmediods++", "pooling", "sparse_sampling",
                                  "spectral", "temporal_shift",
                                  "token_shift", "deep_cluster"])
def test_each_algorithm_eval_forward_card_matches_plain(cuda, algo,
                                                        monkeypatch):
    """A 2 + 2 block model of each algorithm (width 128, 4 frames -> 2):
    the card's eval video embedding against the CPU's on the same weights
    (cosine >= 0.99; kmediods++ and spectral with the card's medoid ids
    replayed: at K = 8 of 32 tokens, rounding picks other medoids)."""
    monkeypatch.setitem(port_config.CLIP_ARCHS, "tiny-gpu-algos", dict(
        embed_dim=32, image_resolution=64, vision_layers=2, vision_width=128,
        vision_patch_size=16, vision_heads=2, context_length=16,
        vocab_size=100, transformer_width=128, transformer_heads=2,
        transformer_layers=2))
    kw = dict(clip_name="tiny-gpu-algos", max_frames=4, max_words=16,
              cluster_num_blocks=(16, 8), target_frames_blocks=(4, 2))
    if algo == "deep_cluster":
        kw["deep_cluster"] = True
    else:
        kw.update(inter=True, algo=algo)
    cfg = port_config.make_run_config(**kw).model
    card = CLIP4Clip(cfg, device=cuda, seed=0).eval()
    cpu = CLIP4Clip(cfg, device="cpu", seed=0).eval()
    g = np.random.default_rng(1)
    video = torch.from_numpy(g.integers(0, 256, (3, 1, 4, 3, 64, 64),
                                        dtype=np.uint8))
    vmask = torch.ones((3, 4), dtype=torch.int32)
    if algo in ("kmediods++", "spectral"):
        chosen = []
        mc = card.clip.visual.transformer.resblocks[1].tokencluster_inter

        def record(res_tmp, own=mc._cluster):
            out = own(res_tmp)
            chosen.append(tuple(a.cpu() for a in out))
            return out
        mc._cluster = record
        cpu.clip.visual.transformer.resblocks[1].tokencluster_inter \
            ._cluster = lambda res_tmp: chosen[0]
    with torch.inference_mode():
        a = card(video=video.to(cuda), video_mask=vmask.to(cuda))
        b = cpu(video=video, video_mask=vmask)
    va, vb = a["visual_output"].float().cpu(), b["visual_output"].float()
    assert va.shape == vb.shape and bool(torch.isfinite(va).all())
    cos = torch.nn.functional.cosine_similarity(va.flatten(1), vb.flatten(1))
    assert float(cos.min()) >= 0.99, cos


# ------------------------------------ headers, 3-D patchify, ResNet towers
_TINY_GPU = dict(embed_dim=64, image_resolution=64, vision_layers=2,
                 vision_width=128, vision_patch_size=16, vision_heads=2,
                 context_length=16, vocab_size=100, transformer_width=128,
                 transformer_heads=2, transformer_layers=2)
_TINY_GPU_RN = dict(embed_dim=64, image_resolution=64,
                    vision_layers=(1, 1, 1, 1), vision_width=16,
                    vision_patch_size=None, context_length=16,
                    vocab_size=100, transformer_width=128,
                    transformer_heads=2, transformer_layers=2)
# fp32 card (cuBLAS / cuDNN in true fp32: TF32 off) vs CPU, sums in
# another order
FP32_TOL = dict(rtol=1e-4, atol=1e-5)


def _tiny_batch(n, res=64, seed=0):
    g = np.random.default_rng(seed)
    ids = g.integers(1, 98, (n, 16))
    ids[:, -1] = 99
    vmask = np.ones((n, 4), np.int32)
    vmask[-1, -2:] = 0
    return {"input_ids": ids, "attention_mask": np.ones((n, 16), np.int32),
            "video": g.integers(0, 256, (n, 1, 4, 3, res, res),
                                dtype=np.uint8), "video_mask": vmask}


@pytest.mark.parametrize("header", ["seqTransf", "tightTransf"])
def test_header_blocks_on_the_card_run_no_attention_kernel(cuda, header,
                                                           monkeypatch):
    """The seqTransf / cross blocks run the plain fp32 attention on the
    card (their per-sample mask is one kernel A does not take) and their
    LayerNorms launch kernel C on fp32 rows; their logits equal the CPU's.
    Then one training step: the towers launch A-E, the loss is finite."""
    from centerclip_tpu_torch.train import Trainer
    monkeypatch.setitem(port_config.CLIP_ARCHS, "tiny-gpu-headers",
                        _TINY_GPU)
    run = port_config.make_run_config(
        clip_name="tiny-gpu-headers", max_frames=4, max_words=16,
        sim_header=header, cross_num_hidden_layers=2,
        inter=True, algo="kmediods++", cluster_num_blocks=(8, 8),
        target_frames_blocks=(4, 2), optim="AdamW", lr=1e-3,
        freeze_layer_num=0, **({} if header == "tightTransf"
                               else {"loose_type": True}))
    card = CLIP4Clip(run.model, device=cuda, seed=0)
    cpu = CLIP4Clip(run.model, device="cpu", seed=0)
    assert torch.backends.cudnn.allow_tf32 is False
    g = np.random.default_rng(2)
    seq = torch.from_numpy(g.standard_normal((5, 1, 64)).astype(np.float32))
    vis = torch.from_numpy(g.standard_normal((4, 2, 64)).astype(np.float32))
    vmask = torch.tensor([[1, 1], [1, 0], [1, 1], [1, 1]])
    a0 = attention_cuda.fused_attention.launches
    c0 = layernorm_triton.layer_norm.launches
    with torch.inference_mode():
        out = card.get_similarity_logits(seq.to(cuda), vis.to(cuda), None,
                                         vmask.to(cuda))
        ref = cpu.get_similarity_logits(seq, vis, None, vmask)
    torch.cuda.synchronize()
    assert attention_cuda.fused_attention.launches == a0
    assert layernorm_triton.layer_norm.launches > c0
    torch.testing.assert_close(out.cpu(), ref, **FP32_TOL)

    counters = (attention_cuda.fused_attention,
                attention_cuda.attention_backward, layernorm_triton.layer_norm,
                layernorm_triton.layer_norm_backward,
                kmedoids_cuda.kmedoids_from_distances)
    before = [fn.launches for fn in counters]
    loss, gstep = Trainer(run, card, total_steps=4).train_epoch(
        0, [_tiny_batch(4)], n_display=1)
    torch.cuda.synchronize()
    assert gstep == 1 and np.isfinite(loss)
    assert all(fn.launches > b for fn, b in zip(counters, before))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_patchify_3d_on_the_card_matches_cpu(cuda, dtype):
    """ViT-B/32's tubelet patchify (12 frames of 224 x 224, width 768) on
    the card against the CPU's fp32 one on the same (for bf16:
    bf16-rounded) inputs, and against `F.conv3d` on the card.  Each
    output is a sum of 9216 products taken in another order: within 1e-6
    of the sum of their magnitudes, and for bf16 one bf16 ulp more."""
    from centerclip_tpu_torch import set_fp32_numerics
    from centerclip_tpu_torch.models.clip import patchify_3d
    set_fp32_numerics()
    video = _randn((2 * 12, 3, 224, 224), torch.float32, "cpu", seed=3)
    w = _randn((768, 3, 3, 32, 32), torch.float32, "cpu", seed=4,
               scale=0.02)
    if dtype == torch.bfloat16:
        video, w = video.bfloat16().float(), w.bfloat16().float()
    ref = patchify_3d(video, w, 12, torch.float32)
    terms = patchify_3d(video.abs(), w.abs(), 12, torch.float32)
    out = patchify_3d(video.to(cuda), w.to(cuda), 12, dtype)
    x5 = video.to(cuda).reshape(2, 12, 3, 224, 224).transpose(1, 2)
    conv = torch.nn.functional.conv3d(
        x5.to(dtype), w.to(cuda, dtype), stride=(1, 32, 32),
        padding=(1, 0, 0)).permute(0, 2, 3, 4, 1).reshape(24, 49, 768)
    torch.cuda.synchronize()
    assert out.shape == (24, 49, 768) and out.dtype == dtype
    tol = 1e-6 * terms
    if dtype == torch.bfloat16:
        tol = tol + BF16_TOL["atol"] + BF16_TOL["rtol"] * ref.abs()
    for got in (out, conv):
        err = (got.float().cpu() - ref).abs()
        assert bool((err <= tol).all()), float((err - tol).max())


def test_narrow_resnet_on_the_card_matches_cpu(cuda, monkeypatch):
    """A narrow ModifiedResNet (layers (1, 1, 1, 1), width 16) in fp32 with
    cuDNN's TF32 off: the visual features on the card equal the CPU's."""
    monkeypatch.setitem(port_config.CLIP_ARCHS, "tiny-gpu-rn", _TINY_GPU_RN)
    cfg = port_config.make_run_config(clip_name="tiny-gpu-rn", max_frames=4,
                                      max_words=16).model
    card = CLIP4Clip(cfg, device=cuda, seed=0).eval()
    cpu = CLIP4Clip(cfg, device="cpu", seed=0).eval()
    assert torch.backends.cudnn.allow_tf32 is False
    b = _tiny_batch(3)
    video, vmask = torch.from_numpy(b["video"]), torch.ones(3, 4)
    with torch.inference_mode():
        out = card.get_visual_output(video.to(cuda), vmask.to(cuda))
        ref = cpu.get_visual_output(video, vmask)
    assert out.shape == (3, 4, 64) and out.dtype == torch.float32
    torch.testing.assert_close(out.cpu(), ref, **FP32_TOL)


def test_rn50_encodes_on_the_card_like_the_cpu(cuda):
    """RN50 at full width: a 2-frame clip's features on the card against
    the CPU's, same seeded weights (cosine >= 0.9999)."""
    cfg = port_config.make_run_config(clip_name="RN50", max_frames=2).model
    card = CLIP4Clip(cfg, device=cuda, seed=0).eval()
    cpu = CLIP4Clip(cfg, device="cpu", seed=0).eval()
    video = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (1, 1, 2, 3, 224, 224), dtype=np.uint8))
    with torch.inference_mode():
        out = card.get_visual_output(video.to(cuda), torch.ones(1, 2,
                                                                device=cuda))
        ref = cpu.get_visual_output(video, torch.ones(1, 2))
    assert out.shape == (1, 2, 1024) and bool(torch.isfinite(out).all())
    cos = torch.nn.functional.cosine_similarity(out.cpu()[0], ref[0])
    assert float(cos.min()) >= 0.9999, cos


# ------------------------------------------------------- QuickGELU (kernel F)
def _bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def _qgelu_input(n, dtype, device, seed):
    """n seeded values (normal, scale 4) with the edges of the dtype's
    range and both zeros first: where the sigmoid saturates, underflows or
    its argument overflows."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, generator=g, device=device) * 4
    big = torch.finfo(dtype).max
    edge = torch.tensor([0.0, -0.0, 1e-30, -1e-30, 20.0, -20.0, 90.0, -90.0,
                         1e4, -1e4, big, -big], device=device)
    x[:min(n, edge.numel())] = edge[:n]
    return x.to(dtype)


def _qgelu_eager_vs_kernel(x, dy):
    """F's output and x's gradient through `quick_gelu_op` against the eager
    composition's, to the bit; one launch each way."""
    from centerclip_tpu_torch.ops.quick_gelu import (quick_gelu_backward,
                                                     quick_gelu_forward,
                                                     quick_gelu_op,
                                                     quick_gelu_plain)
    xe = x.detach().clone().requires_grad_()
    ye = quick_gelu_plain(xe)
    ye.backward(dy)
    ye, ge = ye.detach(), xe.grad
    del xe
    xk = x.detach().clone().requires_grad_()
    f0, b0 = quick_gelu_forward.launches, quick_gelu_backward.launches
    yk = quick_gelu_op(xk)
    yk.backward(dy)
    torch.cuda.synchronize()
    assert quick_gelu_forward.launches == f0 + 1
    assert quick_gelu_backward.launches == b0 + 1
    assert torch.equal(_bits(yk.detach()), _bits(ye))
    assert torch.equal(_bits(xk.grad), _bits(ge))


@pytest.mark.parametrize("shape,dtype", [
    ((302592, 3072), torch.bfloat16),     # ViT-B/16 blocks 1-6
    ((123648, 3072), torch.bfloat16),     # ViT-B/16 blocks 7-12
    ((76800, 3072), torch.bfloat16),      # ViT-B/32 blocks 1-6
    ((38400, 3072), torch.bfloat16),      # ViT-B/32 blocks 7-12
    ((4096, 2048), torch.bfloat16),       # text tower
    ((38400, 3072), torch.float16),
    ((38400, 3072), torch.float32),
    ((768, 512), torch.float32),          # seqTransf header rows
    ((3, 1001), torch.bfloat16),          # ragged: 3003 = 375 x 8 + 3
    ((5,), torch.bfloat16),               # less than one vector
    ((1000003,), torch.float32),          # ragged: 3 past 4-element vectors
    ((7, 13), torch.float16),
])
def test_quick_gelu_kernel_equals_eager_bits(cuda, shape, dtype):
    n = int(np.prod(shape))
    x = _qgelu_input(n, dtype, cuda, seed=n % 1000).view(shape)
    dy = _qgelu_input(n, dtype, cuda, seed=n % 1000 + 1).view(shape)
    _qgelu_eager_vs_kernel(x, dy)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_quick_gelu_kernel_on_a_misaligned_view(cuda, dtype):
    """A contiguous view one element into its storage (not 16-byte
    aligned) takes the scalar kernels, with the same bits."""
    n = 4099
    x = _qgelu_input(n + 1, dtype, cuda, seed=3)[1:]
    dy = _qgelu_input(n + 1, dtype, cuda, seed=4)[1:]
    assert x.is_contiguous() and x.data_ptr() % 16 and dy.data_ptr() % 16
    _qgelu_eager_vs_kernel(x, dy)
    # x aligned, dy not: the backward's scalar kernel
    _qgelu_eager_vs_kernel(x.clone(), dy)


def test_quick_gelu_kernel_rejects_what_it_cannot_take(cuda):
    from centerclip_tpu_torch.ops import quick_gelu
    x = torch.ones(4, 8, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError):
        quick_gelu.quick_gelu_op(x)
    x = torch.ones(4, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        quick_gelu.quick_gelu_op(x[:, ::2])                      # strided
    with pytest.raises(ValueError):
        quick_gelu.quick_gelu_backward(x, torch.ones(4, 8, device=cuda))


def test_quick_gelu_in_a_vitb32_training_step(cuda):
    """One training step of the ViT-B/32 preset at 4 clips launches F 24
    times each way (12 vision and 12 text blocks, no remat), and nothing
    else of the model computes QuickGELU."""
    from centerclip_tpu_torch.ops.quick_gelu import (quick_gelu_backward,
                                                     quick_gelu_forward)
    from centerclip_tpu_torch.train import Trainer
    run = port_config.preset("msrvtt_vitb32_k6", batch_size=4)
    assert not run.model.remat and run.freeze_layer_num == 0
    model = CLIP4Clip(run.model, device=cuda, seed=0)
    g = np.random.default_rng(0)
    ids = g.integers(1, 49406, (4, 32))
    ids[:, -1] = 49407
    batch = {"input_ids": ids, "attention_mask": np.ones((4, 32), np.int32),
             "video": g.integers(0, 256, (4, 1, 12, 3, 224, 224),
                                 dtype=np.uint8),
             "video_mask": np.ones((4, 12), np.int32)}
    f0, b0 = quick_gelu_forward.launches, quick_gelu_backward.launches
    loss, gstep = Trainer(run, model, total_steps=4).train_epoch(
        0, [batch], n_display=1)
    torch.cuda.synchronize()
    assert gstep == 1 and np.isfinite(loss)
    assert quick_gelu_forward.launches - f0 == 24
    assert quick_gelu_backward.launches - b0 == 24


def test_quick_gelu_block_saves_one_tensor_fewer(cuda, monkeypatch):
    """A ViT-B/32 block on 32 clips' blocks-7-12 tokens ([32, 50, 768]
    bf16) keeps one [1600, 3072] tensor fewer for its backward than with
    the eager composition: sigmoid's output."""
    from centerclip_tpu_torch.models import layers
    from centerclip_tpu_torch.ops.quick_gelu import quick_gelu_plain
    block = layers.ResidualAttentionBlock(768, 12, torch.bfloat16).to(cuda)
    x = _randn((32, 50, 768), torch.bfloat16, cuda).requires_grad_()
    fused = _saved_bytes(lambda: block(x))
    monkeypatch.setattr(layers, "quick_gelu_op", quick_gelu_plain)
    eager = _saved_bytes(lambda: block(x))
    assert eager - fused == 32 * 50 * 3072 * 2


def _saved_bytes(fn):
    """The bytes of the distinct storages autograd keeps for fn's
    backward."""
    seen = {}

    def pack(t):
        s = t.untyped_storage()
        seen[s.data_ptr()] = s.nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    del out
    return sum(seen.values())
