# coding=utf-8
"""The port's plain kernel versions against the JAX package, on the CPU.

Inputs come from numpy with a seed and are copied at the boundary.  The
JAX side runs as its own tests run it: the Pallas kernels in interpret mode
at tiny shapes, and the XLA paths they were written against.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from centerclip_tpu.models import layers as jax_layers
from centerclip_tpu.ops.attention_pallas import fused_mha
from centerclip_tpu.ops.distances import pairwise_distance as jax_pairwise
from centerclip_tpu.ops.kmedoids import batch_fast_kmedoids as jax_kmedoids
from centerclip_tpu.ops.kmedoids import kmedoids_oracle
from centerclip_tpu.ops.kmedoids_pallas import kmedoids_from_distances
from centerclip_tpu.ops.layernorm_pallas import fused_layernorm
from centerclip_tpu_torch.models import layers as torch_layers
from centerclip_tpu_torch.ops import attention_cuda, kmedoids_cuda
from centerclip_tpu_torch.ops import layernorm_triton
from centerclip_tpu_torch.ops.distances import pairwise_distance
from centerclip_tpu_torch.ops.kmedoids import (batch_fast_kmedoids,
                                               kmedoids_on_distances)

FP32 = dict(rtol=1e-5, atol=1e-5)


def t(x):
    """numpy -> torch, never sharing memory with the source."""
    return torch.from_numpy(np.array(x, copy=True))


def causal_np(L):
    return np.triu(np.full((L, L), -np.inf, np.float32), k=1)


# ---------------------------------------------------------------- attention
@pytest.mark.parametrize("L", [32, 50, 77])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_plain_matches_fused_mha(L, causal):
    B, H, hd = 3, 2, 16
    D = H * hd
    qkv = np.random.default_rng(L).standard_normal(
        (B, L, 3 * D)).astype(np.float32)
    mask = causal_np(L) if causal else None
    q, k, v = np.split(qkv, 3, axis=-1)
    ref = fused_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    None if mask is None else jnp.asarray(mask), heads=H,
                    group=2, interpret=True)
    out = attention_cuda.fused_attention(
        t(qkv), H, None if mask is None else t(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FP32)


@pytest.mark.parametrize("L", [32, 50])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_module_matches_layers_path(L, causal):
    """The port's MultiHeadAttention (projections + plain core) against the
    JAX XLA attention path of models/layers.py, same weights."""
    B, H, D = 2, 4, 32
    x = np.random.default_rng(7 + L).standard_normal(
        (B, L, D)).astype(np.float32)
    mask = causal_np(L) if causal else None
    jmod = jax_layers.MultiHeadAttention(D, H, jnp.float32)
    params = jmod.init(jax.random.PRNGKey(L), jnp.asarray(x))["params"]
    ref = jmod.apply({"params": params}, jnp.asarray(x),
                     None if mask is None else jnp.asarray(mask))
    mod = torch_layers.MultiHeadAttention(D, H, torch.float32)
    mod.load_state_dict({
        "in_proj_weight": t(np.asarray(params["in_proj"]["kernel"]).T),
        "in_proj_bias": t(params["in_proj"]["bias"]),
        "out_proj.weight": t(np.asarray(params["out_proj"]["kernel"]).T),
        "out_proj.bias": t(params["out_proj"]["bias"])})
    out = mod(t(x), None if mask is None else t(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **FP32)


def test_attention_plain_bf16_rounds_like_layers_path():
    """bf16 operands: fp32 logits/softmax, bf16 probabilities, within one
    bf16 ulp of the JAX path."""
    B, L, H, hd = 2, 50, 2, 16
    qkv = np.random.default_rng(3).standard_normal(
        (B, L, 3 * H * hd)).astype(np.float32)
    q, k, v = np.split(qkv, 3, axis=-1)
    ref = fused_mha(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                    jnp.asarray(v, jnp.bfloat16), None, heads=H, group=2,
                    interpret=True)
    out = attention_cuda.fused_attention(t(qkv).to(torch.bfloat16), H)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=1.6e-2, atol=1.6e-2)


# ---------------------------------------------------------------- layernorm
@pytest.mark.parametrize("R,D", [(37, 768), (20, 512)])
def test_layernorm_plain_matches_fused_layernorm(R, D):
    g = np.random.default_rng(R)
    x = (g.standard_normal((R, D)) * 3.0 + 2.0).astype(np.float32)
    w = (g.standard_normal(D) * 0.1 + 1.0).astype(np.float32)
    b = g.standard_normal(D).astype(np.float32)
    ref = fused_layernorm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                          interpret=True)
    out = layernorm_triton.layer_norm(t(x), t(w), t(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FP32)


def test_layernorm_module_matches_layernorm_f32():
    g = np.random.default_rng(5)
    x = g.standard_normal((2, 7, 64)).astype(np.float32) * 2.0
    jmod = jax_layers.LayerNormF32()
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(g.standard_normal(p.shape), jnp.float32),
        params)
    ref = jmod.apply({"params": params}, jnp.asarray(x))
    mod = torch_layers.LayerNormF32(64)
    mod.load_state_dict({"weight": t(params["norm"]["scale"]),
                         "bias": t(params["norm"]["bias"])})
    np.testing.assert_allclose(mod(t(x)).detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=2e-5)


def test_layernorm_plain_keeps_bf16():
    x = t(np.random.default_rng(1).standard_normal((6, 768))).to(
        torch.bfloat16)
    y = layernorm_triton.layer_norm(x, torch.ones(768), torch.zeros(768))
    assert y.dtype == torch.bfloat16 and y.shape == x.shape


# ---------------------------------------------------------------- distances
@pytest.mark.parametrize("N", [17, 98])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_distances_match_jax(N, metric):
    x = np.random.default_rng(N).standard_normal((2, N, 24)).astype(
        np.float32) * 3.0
    ref = np.asarray(jax_pairwise(jnp.asarray(x), jnp.asarray(x),
                                  metric=metric, all_negative=True,
                                  self_nearest=True))
    out = pairwise_distance(t(x), t(x), metric=metric, all_negative=True,
                            self_nearest=True).numpy()
    # the matmul identity's error is absolute (~eps * |x|^2); the diagonal
    # of the N > 25 branch is sqrt of that rounding noise
    off = ~np.eye(N, dtype=bool)[None].repeat(2, 0)
    np.testing.assert_allclose(out[off], ref[off], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(out[~off], ref[~off], rtol=0, atol=3e-2)


def test_distances_bitwise_symmetric_at_n98():
    x = t(np.random.default_rng(0).standard_normal((4, 98, 768)).astype(
        np.float32))
    D = pairwise_distance(x, x, all_negative=True, self_nearest=True)
    assert torch.equal(D, D.transpose(-1, -2))


# ----------------------------------------------------------------- kmedoids
def make_blobs(rng, B, N, Dim, centres, spread=0.05):
    """`centres` well-separated blobs per batch element."""
    out = np.zeros((B, N, Dim), np.float32)
    for b in range(B):
        c = rng.standard_normal((centres, Dim)).astype(np.float32) * 5.0
        out[b] = c[rng.integers(0, centres, size=N)] \
            + rng.standard_normal((N, Dim)) * spread
    return out


def _jax_prep(metric, pre_norm):
    """The JAX package's distance preparation under jit, as its
    batch_fast_kmedoids runs it: (points, distances, norms)."""
    @jax.jit
    def prep(X):
        if pre_norm:
            X = X / (jnp.linalg.norm(X, axis=-1, keepdims=True) + 1e-6)
        D = jax_pairwise(X, X, metric=metric, all_negative=True,
                         self_nearest=True)
        return X, D, jnp.linalg.norm(X, axis=-1)
    return prep


VARIANTS = [("euclidean", False), ("cosine", False), ("euclidean", True)]


@pytest.mark.parametrize("distance,pre_norm", [("euclidean", False),
                                               ("euclidean", True)])
def test_kmedoids_plain_matches_jax_small_n(distance, pre_norm):
    """N <= 25: the direct (x-y)^2 branch, where both packages compute the
    same distances bit for bit, end to end."""
    x = make_blobs(np.random.default_rng(4), 3, 20, 8, 4)
    a_ref, m_ref = jax_kmedoids(jnp.asarray(x), 4, distance=distance,
                                iter_limit=100, pre_norm=pre_norm)
    a, m = batch_fast_kmedoids(t(x), 4, distance=distance, iter_limit=100,
                               pre_norm=pre_norm)
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_ref))
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    # the kernel wrapper takes this plain version for CPU tensors
    a2, m2 = kmedoids_cuda.kmedoids(t(x), 4, distance=distance,
                                    pre_norm=pre_norm)
    assert torch.equal(m2, m) and torch.equal(a2, a)


@pytest.mark.parametrize("N,K", [(20, 4), (98, 49)])
@pytest.mark.parametrize("distance,pre_norm", VARIANTS)
def test_kmedoids_plain_matches_jax_on_same_distances(N, K, distance,
                                                      pre_norm):
    """The algorithm (KKZ, Lloyd, stop rule, id sort) on the distances the
    JAX package computes.  The matmul branch's distances agree only to
    rounding (test_distances_match_jax), and the diagonal's rounding noise
    decides which point of a 2-point cluster is its medoid, so ids are held
    exactly equal on identical distances."""
    x = make_blobs(np.random.default_rng(N + K), 2, N, 32, 8)
    a_ref, m_ref = jax_kmedoids(jnp.asarray(x), K, distance=distance,
                                iter_limit=100, pre_norm=pre_norm)
    Xj, Dj, lj = _jax_prep(distance, pre_norm)(jnp.asarray(x))
    a, m = kmedoids_on_distances(t(Xj), t(Dj), t(lj), K, iter_limit=100)
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_ref))
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))


@pytest.mark.parametrize("N,K", [(20, 4), (98, 49)])
def test_kmedoids_plain_matches_pallas_kernel(N, K):
    """Against the Pallas kernel (interpret mode) on the same distances;
    the kernel stops at the medoid fixed point, the plain version on the
    batch-mean shift: both reach the same fixed point here."""
    x = make_blobs(np.random.default_rng(K), 2, N, 16, 8)
    Xj, Dj, lj = _jax_prep("euclidean", False)(jnp.asarray(x))
    a_ref, m_ref = kmedoids_from_distances(Dj, lj, K, iter_limit=40,
                                           interpret=True)
    a, m = kmedoids_on_distances(t(Xj), t(Dj), t(lj), K, iter_limit=40)
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_ref))
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))


def test_kmedoids_plain_matches_loop_oracle():
    x = make_blobs(np.random.default_rng(11), 3, 24, 6, 5)
    a, m = batch_fast_kmedoids(t(x), 5, iter_limit=60)
    for b in range(3):
        a_ref, m_ref = kmedoids_oracle(x[b], 5)
        np.testing.assert_array_equal(m[b].numpy(), m_ref)
        np.testing.assert_array_equal(a[b].numpy(), a_ref)


def test_kmedoids_plain_end_to_end_at_n98_on_exact_data():
    """N = 98, K = 49 through the port's own distances, on integer points
    whose coordinates sum to zero: the mean, the norms and the matmul are
    then exact in fp32, so both packages build the same distances."""
    g = np.random.default_rng(0)
    x = np.zeros((4, 98, 32), np.float32)
    for b in range(4):
        c = g.integers(-40, 41, (8, 32))
        pts = c[g.integers(0, 8, 97)] + g.integers(-3, 4, (97, 32))
        x[b, :97], x[b, 97] = pts, -pts.sum(0)
    a_ref, m_ref = jax_kmedoids(jnp.asarray(x), 49, iter_limit=100)
    a, m = batch_fast_kmedoids(t(x), 49, iter_limit=100)
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_ref))
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))


def test_kmedoids_kernel_entry_needs_cuda():
    D = torch.zeros(1, 4, 4)
    with pytest.raises(ValueError):
        kmedoids_cuda.kmedoids_from_distances(D, torch.zeros(1, 4), 2)
