"""CenterCLIP's normalised spectral clustering of a segment's tokens, in
plain PyTorch.

Written from the published description (CenterCLIP, Zhao et al. 2022,
its `modules/cluster/spectral.py:15-167`), in fp32 with TF32 off and no
kernel of the program's:

* affinity W = exp(-||x_i - x_j||^2 / 2 sigma^2);
* KNN graph: each row keeps its k largest entries (its own among them,
  ties kept), symmetrised by OR;
* L_sym = D^-1/2 (D - W) D^-1/2, D the row sums' diagonal;
* `torch.linalg.eigh`, eigenvalues ascending;
* Rasmus Bro's sign correction (each eigenvector turned toward the
  dominant direction of S V^T, with U = Q, S = the eigenvalues, V = Q);
* the first K columns, each row divided by its norm + 1e-6;
* k-medoids on those rows (the reference's own, `model.kmedoids`), whose
  sorted medoid ids pick the segment's tokens.

Departures from the description: the squared distances are summed from
the tokens' differences, where CenterCLIP takes them from a Gram matrix
(the same numbers but for rounding); the spatial-temporal mask
(`--spectral_spg`) is not written (the plan refuses it); and the sign
correction, which turns columns whole, leaves every distance between rows
as it is, so the medoids do not depend on it.

`layer_readings` judges a set of medoid ids of the first spectral cluster
layer (the program's, or another precision's) in this embedding: their
k-medoids cost (each row's distance to its nearest medoid, summed over
the batch's segments) against that of the reference's own ids.  It also
counts the segments whose heat-kernel affinity has no entry off the
diagonal above 1e-6 (W = I, L_sym = 0: nothing to cluster), those whose
K-th and (K+1)-th eigenvalues lie under 1e-5 apart (the first K
eigenvectors are not unique there), the share of segments whose ids are
the reference's, and the median over segments of the median distance
between a segment's tokens, in sigma.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

IDENTITY = 1e-6
NEAR_TIE = 1e-5
# elements of the [segments, N, N, D] differences held at once
BLOCK_ELEMS = 1 << 27


def squared_distances(X: torch.Tensor) -> torch.Tensor:
    """[B, N, D] -> [B, N, N] squared Euclidean distances, summed from the
    differences, in blocks of segments."""
    B, N, D = X.shape
    step = max(1, BLOCK_ELEMS // (N * N * D))
    out = []
    for a in range(0, B, step):
        x = X[a:a + step]
        diff = x[:, :, None, :] - x[:, None, :, :]
        out.append((diff * diff).sum(-1))
    return torch.cat(out)


def affinity(d2: torch.Tensor, sigma: float) -> torch.Tensor:
    """The heat kernel of squared distances."""
    return torch.exp(-d2 / (2.0 * sigma ** 2))


def knn_graph(W: torch.Tensor, k: int) -> torch.Tensor:
    """Each row's k largest entries (ties kept), symmetrised by OR."""
    kth = torch.topk(W, k, dim=-1).values[..., -1:]
    keep = W >= kth
    return W * (keep | keep.transpose(-1, -2))


def laplacian(W: torch.Tensor) -> torch.Tensor:
    """L_sym = D^-1/2 (D - W) D^-1/2."""
    d = W.sum(-1)
    inv = d.pow(-0.5)
    return inv[..., :, None] * (torch.diag_embed(d) - W) * inv[..., None, :]


def sign_corrected(Q: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Rasmus Bro's sign correction of the eigenvectors Q [B, N, N]
    (columns) of eigenvalues lam [B, N]."""
    SVh = lam[..., :, None] * Q.transpose(-1, -2)
    side = (torch.sign(SVh) * SVh.square()).sum(-1)
    return torch.sign(side)[..., None, :] * Q


def embedding(X: torch.Tensor, spec) -> torch.Tensor:
    """[B, N, D] tokens -> the row-normalised spectral embedding [B, N, K]
    of the cluster layer `spec` (`plan.Cluster`)."""
    return _embedding(X.float(), squared_distances(X.float()), spec)[0]


def _embedding(X, d2, spec):
    """(embedding, eigenvalues) of tokens X with squared distances d2."""
    W = affinity(d2, spec.sigma)
    if spec.graph == "KNN":
        W = knn_graph(W, spec.knn_k)
    elif spec.graph != "HeatKernel":
        raise ValueError(f"no spectral graph {spec.graph!r}")
    lam, Q = torch.linalg.eigh(laplacian(W))
    Q = sign_corrected(Q, lam)[..., :spec.k]
    return Q / (torch.linalg.vector_norm(Q, dim=-1, keepdim=True)
                + 1e-6), lam


@torch.no_grad()
def medoids(X: torch.Tensor, spec, iter_limit: int,
            kmedoids: Callable) -> torch.Tensor:
    """[B, N, D] tokens -> [B, K] sorted medoid ids: `kmedoids` (the
    reference's) on the spectral embedding."""
    return kmedoids(embedding(X, spec), spec.k, iter_limit)


def cost(E: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """[B] k-medoids cost of medoid ids [B, K] in the embedding E [B, N,
    K]: each row's Euclidean distance to its nearest medoid, summed."""
    M = torch.gather(E, 1, ids.long()[..., None].expand(-1, -1,
                                                        E.shape[-1]))
    d = torch.cdist(E, M, compute_mode="donot_use_mm_for_euclid_dist")
    return d.min(dim=-1).values.sum(dim=-1)


@torch.no_grad()
def first_tokens(W, s, video: torch.Tensor, chunk: int, num=None):
    """(the tokens [n*S, N, D] that the first cluster layer of the plan
    clusters, clip-major, its `plan.Cluster`) of clips `video` [n, T, 3,
    H, W] from weights W, in chunks of `chunk` clips."""
    from . import model as M
    num = num or M.Numerics("fp32")
    spec = next(p for p in s.plan if p is not None)
    out = []
    for a in range(0, video.shape[0], chunk):
        v = video[a:a + chunk]
        x = M.stem(W, s, v, num)
        for i in range(spec.block):
            x = M.block(x, W, f"clip.visual.transformer.resblocks.{i}.",
                        s.heads, None, num)
        out.append(M.segments(x, spec, v.shape[0]))
    return torch.cat(out), spec


@torch.no_grad()
def layer_readings(X: torch.Tensor, spec, ids: torch.Tensor,
                   iter_limit: int, kmedoids: Callable) -> dict:
    """Medoid ids [B, K] of the tokens X [B, N, D] (clip-major, as
    `first_tokens` gives them) judged in the reference (module
    docstring): {cost_excess: their cost over the reference's ids' - 1
    (inf where the ids are not [B, K]), identity_segments, near_ties,
    agreement, median_sigmas, segments}."""
    X = X.float()
    d2 = squared_distances(X)
    E, lam = _embedding(X, d2, spec)
    own = kmedoids(E, spec.k, iter_limit)
    B, N = d2.shape[:2]
    off = ~torch.eye(N, dtype=torch.bool, device=X.device)
    linked = ((affinity(d2, spec.sigma) > IDENTITY) & off).any(-1).any(-1)
    K = spec.k
    ties = int(((lam[:, K] - lam[:, K - 1]) < NEAR_TIE).sum()) \
        if K < N else 0
    out = {"cost_excess": math.inf, "agreement": 0.0,
           "identity_segments": int((~linked).sum()), "near_ties": ties / B,
           "median_sigmas": float((d2.sqrt()[:, off].median(dim=-1).values
                                   / spec.sigma).median()),
           "segments": B}
    ids = ids.to(X.device).long()
    if ids.shape == own.shape:
        out["cost_excess"] = float(cost(E, ids).sum()
                                   / cost(E, own).sum()) - 1.0
        out["agreement"] = float((ids.sort(dim=1).values == own).all(dim=1)
                                 .float().mean())
    return out
