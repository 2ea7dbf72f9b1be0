# coding=utf-8
"""The port's spectral clustering (`ops/spectral.py`) against the JAX
package's, on the CPU.

Eigenvectors are unique only up to sign and, within a repeated eigenvalue,
up to a rotation, and random tokens give near-repeated ones (at N = 98 the
KNN graph falls into several components).  So the solvers are held by
their eigenvalues and by the projector onto their first K eigenvectors, on
planted clusters with a clear gap; k-medoids is held on the JAX package's
own embedding; the whole layer with replayed medoid ids
(tests/test_torch_cluster_algos.py).  Tolerances: affinity and L_sym within
1e-6, eigenvalues within 1e-5, projectors within 1e-4, the graph and the
medoid ids equal.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from centerclip_tpu.ops import kmedoids as jax_kmedoids
from centerclip_tpu.ops.distances import pairwise_distance as jax_pairwise
from centerclip_tpu.ops import spectral as jax_spectral
from centerclip_tpu_torch.ops import spectral
from centerclip_tpu_torch.ops.kmedoids import kmedoids_on_distances

TIGHT = dict(rtol=1e-6, atol=1e-6)


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def planted(seed, B=3, clusters=5, per=12, dim=16, spread=0.15):
    """B segments of `clusters` well separated blobs of `per` points."""
    g = np.random.default_rng(seed)
    centres = g.standard_normal((B, clusters, dim)) * 2.0
    x = np.repeat(centres, per, axis=1) \
        + spread * g.standard_normal((B, clusters * per, dim))
    perm = g.permutation(clusters * per)
    return x[:, perm].astype(np.float32)


def jax_laplacian(X, sigma, mode, knn_k, spg=None):
    """The JAX package's L_sym, as `batch_spectral_clustering` forms it."""
    W = jax_spectral.construct_affinity(jnp.asarray(X), jnp.asarray(X),
                                        sigma=sigma, mode=mode, knn_k=knn_k,
                                        spatial_temporal_graph=spg)
    d = jnp.sum(W, axis=-1)
    inv = jnp.power(d, -0.5)
    L = jax.vmap(jnp.diag)(d) - W
    return np.asarray(inv[..., :, None] * L * inv[..., None, :])


def projector(V):
    return V @ np.swapaxes(V, -1, -2)


@pytest.mark.parametrize("mode,mutual,with_spg", [
    ("HeatKernel", False, False), ("KNN", False, False), ("KNN", True, False),
    ("KNN", False, True)])
def test_affinity_matches_jax(mode, mutual, with_spg):
    X = planted(1, B=2, clusters=2, per=18, dim=8)         # N = 36 = 4 x 9
    spg = spectral.spatial_temporal_graph(36, 9, 5, 3) if with_spg else None
    ref = jax_spectral.construct_affinity(
        jnp.asarray(X), jnp.asarray(X), sigma=2.0, mode=mode, knn_k=7,
        mutual=mutual,
        spatial_temporal_graph=None if spg is None else jnp.asarray(spg))
    out = spectral.construct_affinity(
        t(X), t(X), sigma=2.0, mode=mode, knn_k=7, mutual=mutual,
        spatial_temporal_graph=None if spg is None else t(spg))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TIGHT)
    if mode == "KNN":
        assert ((out.numpy() > 0) == (np.asarray(ref) > 0)).all()


@pytest.mark.parametrize("mode,N", [("HeatKernel", 20), ("KNN", 60)])
def test_normalized_laplacian_matches_jax(mode, N):
    X = planted(2, B=2, clusters=4, per=N // 4, dim=12)
    ref = jax_laplacian(X, 2.0, mode, 10)
    out = spectral.normalized_laplacian(t(X), 2.0, mode, 10)
    np.testing.assert_allclose(out.numpy(), ref, **TIGHT)


@pytest.mark.parametrize("solver", ["eigh", "subspace"])
def test_solvers_match_jax_on_planted_clusters(solver):
    """Eigenvalues within 1e-5, the projector onto the first K within 1e-4
    (K = the planted cluster count: a gap after the K-th eigenvalue)."""
    K, X = 5, planted(3)
    L = jax_laplacian(X, 2.0, "KNN", 10)
    if solver == "eigh":
        jl, jv = (np.asarray(a) for a in jnp.linalg.eigh(jnp.asarray(L)))
        pl, pv = (a.numpy() for a in torch.linalg.eigh(t(L)))
        jl, jv, pl, pv = jl[:, :K], jv[..., :K], pl[:, :K], pv[..., :K]
    else:
        jl, jv = (np.asarray(a) for a in
                  jax_spectral._smallest_eigvecs_subspace(jnp.asarray(L), K))
        pl, pv = (a.numpy() for a in
                  spectral._smallest_eigvecs_subspace(t(L), K))
    assert pv.shape == (3, 60, K)
    gap = np.asarray(jnp.linalg.eigvalsh(jnp.asarray(L)))[:, K] - jl[:, -1]
    assert gap.min() > 0.05
    np.testing.assert_allclose(pl, jl, rtol=0, atol=1e-5)
    np.testing.assert_allclose(projector(pv), projector(jv), rtol=0,
                               atol=1e-4)


def test_sign_flip_matches_jax():
    g = np.random.default_rng(4)
    U = g.standard_normal((2, 10, 10)).astype(np.float32)
    S = np.abs(g.standard_normal((2, 10))).astype(np.float32)
    ref = jax_spectral.sign_flip_rasmus_bro(jnp.asarray(U), jnp.asarray(S),
                                            jnp.asarray(np.swapaxes(U, 1, 2)))
    out = spectral.sign_flip_rasmus_bro(t(U), t(S), t(np.swapaxes(U, 1, 2)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("N,P,s,tk", [(98, 49, 9, 7), (196, 49, 9, 7),
                                      (18, 9, 3, 3), (37, 9, 5, 3),
                                      (99, 49, 9, 7)])
def test_spatial_temporal_graph_equals_jax(N, P, s, tk):
    """Equal, including N = T * P + 1, where the remainder token gets no
    incoming edge and the graph is not symmetric."""
    out = spectral.spatial_temporal_graph(N, P, s, tk)
    ref = jax_spectral.spatial_temporal_graph(N, P, s, tk)
    np.testing.assert_array_equal(out, ref)
    assert (N % P == 0) == bool((out == out.T).all())


@pytest.mark.parametrize("N,K", [(60, 5), (98, 49)])
def test_kmedoids_on_the_jax_embedding_equal_ids(N, K):
    """The JAX package's row-normalised spectral embedding and the
    distances its k-medoids computes from it (the matmul branch's agree
    only to rounding, tests/test_torch_kernels_plain.py): both packages'
    k-medoids give equal ids and assignments."""
    X = planted(5, clusters=5, per=N // 5) if N == 60 else \
        np.random.default_rng(6).standard_normal((3, N, 64)).astype(
            np.float32)
    L = jnp.asarray(jax_laplacian(X, 2.0, "KNN", 10))
    lam, vec = jnp.linalg.eigh(L)
    vec = jax_spectral.sign_flip_rasmus_bro(vec, lam,
                                            jnp.swapaxes(vec, -1, -2))
    Q = vec[..., :K]
    Q = Q / (jnp.linalg.norm(Q, axis=-1, keepdims=True) + 1e-6)
    ja, jm = jax_kmedoids.batch_fast_kmedoids(Q, K, iter_limit=100)
    D = jax.jit(lambda q: jax_pairwise(q, q, all_negative=True,
                                       self_nearest=True))(Q)
    pa, pm = kmedoids_on_distances(t(Q), t(D), t(jnp.linalg.norm(Q, axis=-1)),
                                   K, iter_limit=100)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))


@pytest.mark.parametrize("solver", ["eigh", "subspace"])
def test_spectral_clustering_recovers_planted_clusters_as_jax(solver):
    """Both packages' full pipelines give the same partition."""
    K, X = 5, planted(7)
    ja, _ = jax_spectral.batch_spectral_clustering(
        jnp.asarray(X), K, mode="KNN", knn_k=10, sigma=2.0, iter_limit=100,
        solver=solver)
    pa, pm = spectral.batch_spectral_clustering(
        t(X), K, mode="KNN", knn_k=10, sigma=2.0, iter_limit=100,
        solver=solver)
    assert pa.dtype == torch.int32 and tuple(pm.shape) == (3, K)
    for b in range(3):
        # the same partition: a one-to-one map between the labels
        pairs = set(zip(pa[b].tolist(), np.asarray(ja[b]).tolist()))
        assert len(pairs) == K


def test_unknown_solver_raises():
    with pytest.raises(ValueError):
        spectral.spectral_embedding(t(planted(8)), 5, solver="lanczos")
