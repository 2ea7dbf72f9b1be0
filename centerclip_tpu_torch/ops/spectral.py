# coding=utf-8
"""Normalised spectral clustering (port of the JAX package's
`ops/spectral.py`; reference: modules/cluster/spectral.py:15-167).

affinity W (heat kernel, optionally sparsified to each row's k nearest,
optionally masked by a spatial-temporal graph) -> L_sym = D^-1/2 (D - W)
D^-1/2 -> the eigenvectors of its K smallest eigenvalues -> rows
normalised -> k-medoids on those rows.  All of it fp32, no autograd.

The eigensolve runs where the tokens are: `torch.linalg.eigh` on the card
for CUDA tensors (there is no host round trip), or, with
`solver="subspace"`, subspace iteration (batched matmuls, a batched
CholeskyQR and one (K+8)-wide `eigh`).  k-medoids goes through
`ops/kmedoids_cuda.kmedoids`: kernel E on the card, its plain version on
the CPU.  Eigenvectors are unique only up to sign and, where eigenvalues
repeat, up to a rotation of their subspace; the pairwise distances
k-medoids reads are invariant to both signs and orderings.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .distances import squared_l2_distance
from .kmedoids_cuda import kmedoids

SOLVERS = ("eigh", "subspace")


def construct_affinity(x: torch.Tensor, y: torch.Tensor, sigma: float = 2.0,
                       mode: str = "HeatKernel", knn_k: int = 10,
                       mutual: bool = False,
                       spatial_temporal_graph: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Affinity graph W [..., N, M] (reference `constructW`,
    spectral.py:77-106): exp(-||xi - xj||^2 / 2 sigma^2); KNN keeps each
    row's k largest (ties kept), symmetrised by OR (AND when `mutual`)."""
    W = torch.exp(-1.0 * squared_l2_distance(x, y) / (2.0 * sigma ** 2))
    if mode == "KNN":
        kth = torch.topk(W, knn_k, dim=-1).values[..., -1:]
        mask = W >= kth
        mask_t = mask.transpose(-1, -2)
        mask = (mask & mask_t) if mutual else (mask | mask_t)
        W = W * mask
    elif mode != "HeatKernel":
        raise NotImplementedError(mode)
    if spatial_temporal_graph is not None:
        W = W * spatial_temporal_graph
    return W


def sign_flip_rasmus_bro(U: torch.Tensor, S: torch.Tensor, Vh: torch.Tensor
                         ) -> torch.Tensor:
    """Rasmus Bro's sign correction (reference: spectral.py:109-137): each
    column of U turned toward the dominant direction of S Vh."""
    SVh = S[..., :, None] * Vh
    sign_left = (torch.sign(SVh) * SVh.square()).sum(-1)
    return torch.sign(sign_left)[..., None, :] * U


def normalized_laplacian(X: torch.Tensor, sigma: float, mode: str,
                         knn_k: int,
                         spatial_temporal_graph: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """L_sym [B, N, N] of the tokens X [B, N, Dim], computed the explicit
    way (spectral.py:46-52), as the JAX package does."""
    W = construct_affinity(X, X, sigma=sigma, mode=mode, knn_k=knn_k,
                           spatial_temporal_graph=spatial_temporal_graph)
    diag_D = W.sum(-1)
    inv_sqrt = diag_D.pow(-0.5)
    L = torch.diag_embed(diag_D) - W
    return inv_sqrt[..., :, None] * L * inv_sqrt[..., None, :]


def _smallest_eigvecs_subspace(L_sym: torch.Tensor, K: int,
                               oversample: int = 8, iters: int = 12
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K smallest eigenpairs of L_sym by subspace iteration on
    M = 2I - L_sym (L_sym's spectrum lies in [0, 2]) from a fixed cosine
    basis: `iters` steps of M Q and CholeskyQR, then Rayleigh-Ritz with a
    (K + oversample)-wide `eigh`.  Returns (eigenvalues [B, K] ascending,
    eigenvectors [B, N, K])."""
    B, N, _ = L_sym.shape
    q = min(K + oversample, N)
    eye = torch.eye(N, dtype=L_sym.dtype, device=L_sym.device)
    M = -L_sym + 2.0 * eye
    n_i = torch.arange(N, dtype=L_sym.dtype, device=L_sym.device)[:, None]
    k_i = torch.arange(q, dtype=L_sym.dtype, device=L_sym.device)[None, :]
    Q = torch.cos((n_i + 0.5) * (k_i + 1.0) * (math.pi / N)).expand(B, N, q)
    eye_q = torch.eye(q, dtype=L_sym.dtype, device=L_sym.device)

    def chol_qr(Z):
        G = Z.transpose(-1, -2) @ Z + 1e-7 * eye_q
        R = torch.linalg.cholesky(G)                # lower: G = R R^T
        # Q R^T = Z
        return torch.linalg.solve_triangular(R.transpose(-1, -2), Z,
                                             upper=True, left=False)
    for _ in range(iters):
        Q = chol_qr(M @ Q)
    Q = chol_qr(Q)
    T = Q.transpose(-1, -2) @ (M @ Q)
    theta, S = torch.linalg.eigh(T)                 # ascending, of M
    order = torch.arange(q - 1, q - 1 - K, -1, device=L_sym.device)
    return 2.0 - theta[..., order], Q @ S[..., order]


def eigenpairs(L_sym: torch.Tensor, K: int, solver: str = "eigh"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """L_sym's eigenpairs, ascending, on L_sym's device: all N of them by
    `torch.linalg.eigh`, or the K smallest by subspace iteration."""
    if solver == "subspace":
        return _smallest_eigvecs_subspace(L_sym, K)
    if solver != "eigh":
        raise ValueError(f"unknown spectral solver {solver!r}")
    return torch.linalg.eigh(L_sym)


def spectral_embedding(X: torch.Tensor, K: int, mode: str = "HeatKernel",
                       knn_k: int = 10, correct_sign: bool = True,
                       sigma: float = 2.5,
                       spatial_temporal_graph: Optional[torch.Tensor] = None,
                       solver: str = "eigh") -> torch.Tensor:
    """[B, N, Dim] tokens -> the row-normalised embedding [B, N, K] that
    k-medoids clusters."""
    L_sym = normalized_laplacian(X.float(), sigma, mode, knn_k,
                                 spatial_temporal_graph)
    eigvals, Q = eigenpairs(L_sym, K, solver)
    if correct_sign:
        # L_sym = Q diag(lam) Q^T: U = Q, S = lam, Vh = Q^T
        Q = sign_flip_rasmus_bro(Q, eigvals, Q.transpose(-1, -2))
    Q = Q[..., :K]
    return Q / (torch.linalg.vector_norm(Q, dim=-1, keepdim=True) + 1e-6)


@torch.no_grad()
def batch_spectral_clustering(X: torch.Tensor, K: int,
                              mode: str = "HeatKernel", knn_k: int = 10,
                              metric: str = "euclidean",
                              threshold: float = 1e-5, iter_limit: int = 60,
                              id_sort: bool = True, norm_p: float = 2.0,
                              correct_sign: bool = True, sigma: float = 2.5,
                              spatial_temporal_graph: Optional[
                                  torch.Tensor] = None,
                              solver: str = "eigh"
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalised spectral clustering of [B, N, Dim] tokens (reference:
    spectral.py:15-73).  Returns (assign [B, N], medoids [B, K]) as int32;
    the medoid ids index the token axis."""
    Q = spectral_embedding(X, K, mode=mode, knn_k=knn_k,
                           correct_sign=correct_sign, sigma=sigma,
                           spatial_temporal_graph=spatial_temporal_graph,
                           solver=solver)
    return kmedoids(Q, K, distance=metric, threshold=threshold,
                    iter_limit=iter_limit, id_sort=id_sort, norm_p=norm_p)


def spatial_temporal_graph(N: int, tokens_per_frame: int, s_kernel: int = 5,
                           t_kernel: int = 5) -> np.ndarray:
    """Boolean locality mask [N, N] over the token axis (reference:
    spectral.py:140-167): token i connects to token j iff they are within
    t_kernel // 2 frames and s_kernel // 2 grid cells (per axis) of each
    other.  Built on the host once per config.

    As in the reference, only the target's frame is bounds-checked: where
    N is not a multiple of `tokens_per_frame` (N = T * P + 1 with a CLS
    slot), the remainder tokens get no incoming edge, not even from
    themselves, while their own rows stay populated, so the graph is not
    symmetric there.  The cluster layer always passes a multiple."""
    W = int(tokens_per_frame ** 0.5)
    frames = N // tokens_per_frame
    half_t, half_s = t_kernel // 2, s_kernel // 2
    idx = np.arange(N)
    t = idx // tokens_per_frame
    h = (idx % tokens_per_frame) // W
    w = (idx % tokens_per_frame) % W
    valid = t < frames
    dt = (np.abs(t[:, None] - t[None, :]) <= half_t) & valid[None, :]
    dh = np.abs(h[:, None] - h[None, :]) <= half_s
    dw = np.abs(w[:, None] - w[None, :]) <= half_s
    return dt & dh & dw
