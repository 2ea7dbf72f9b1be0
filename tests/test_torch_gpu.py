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

from centerclip_tpu_torch.ops import attention_cuda, kmedoids_cuda
from centerclip_tpu_torch.ops import layernorm_triton
from centerclip_tpu_torch.ops.distances import pairwise_distance
from centerclip_tpu_torch.ops.kmedoids import (batch_fast_kmedoids,
                                               kmedoids_inputs)

pytestmark = pytest.mark.gpu

# bf16 keeps 8 significant bits: kernel and plain version round the same
# fp32 values, so they differ by at most about one bf16 ulp
BF16_TOL = dict(rtol=1.6e-2, atol=1.6e-2)


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
    X = _randn((2, 320, 16), torch.float32, cuda)
    with pytest.raises(ValueError):
        kmedoids_cuda.kmedoids(X, 49)


def test_distances_symmetric_on_card(cuda):
    X = _randn((8, 98, 768), torch.float32, cuda)
    D = pairwise_distance(X, X, all_negative=True, self_nearest=True)
    assert torch.equal(D, D.transpose(-1, -2))
