# coding=utf-8
"""Batched k-medoids with deterministic KKZ seeding, plain PyTorch.

Port of the JAX package's `ops/kmedoids.py` (`kkz_init`, the assign/update
steps, `batch_fast_kmedoids`) with the same stop rule: `FIXED_ITER_CAP`
steps, then single steps until the batch-mean medoid shift drops below
`threshold` or `iter_limit` steps have run, then `id_sort` and a last
assignment.  Every argmin/argmax keeps the first index on ties.  Everything
is fp32 and runs without autograd (clustering is a no-grad region).

This is the plain version that `ops/kmedoids_cuda.py` holds its kernel to;
the kernel stops per segment at the medoid fixed point instead, which gives
the same medoids whenever every segment converges.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .distances import pairwise_distance

# unrolled steps before the first convergence test (kmedoids.py:43)
FIXED_ITER_CAP = 12


def _take_rows(D: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, k, :] = D[b, idx[b, k], :]."""
    return torch.gather(D, 1, idx[..., None].expand(-1, -1, D.shape[-1]))


def kkz_init(l2: torch.Tensor, D: torch.Tensor, K: int) -> torch.Tensor:
    """KKZ seeding (reference: cluster_utils.py:77-118): the max-norm point,
    then repeatedly the point farthest from its nearest chosen medoid.

    l2: [B, N] point norms; D: [B, N, N] distances with both tricks.
    Returns [B, K] int64 medoid ids."""
    B = D.shape[0]
    meds = torch.zeros((B, K), dtype=torch.long, device=D.device)
    cur = l2.argmax(dim=1)
    meds[:, 0] = cur
    mindist = _take_rows(D, cur[:, None])[:, 0, :]
    for i in range(1, K):
        cur = mindist.argmax(dim=1)
        meds[:, i] = cur
        mindist = torch.minimum(mindist, _take_rows(D, cur[:, None])[:, 0, :])
    return meds


def _assign_step(D: torch.Tensor, meds: torch.Tensor) -> torch.Tensor:
    """Nearest medoid of every point (fast_kmeans.py:75-76)."""
    return _take_rows(D, meds).argmin(dim=1)                  # [B, N]


def _update_step(D: torch.Tensor, assign: torch.Tensor, K: int
                 ) -> torch.Tensor:
    """Medoid update as one batched matmul against the one-hot assignment;
    non-members score 0, which loses to every (negative) member sum."""
    onehot = torch.nn.functional.one_hot(assign, K).to(D.dtype)  # [B, N, K]
    scores = (D @ onehot) * onehot
    return scores.argmin(dim=1)                               # [B, K]


def _shift(X: torch.Tensor, new: torch.Tensor, old: torch.Tensor
           ) -> torch.Tensor:
    """Batch mean of the summed per-medoid movement (fast_kmeans.py:85-86)."""
    moved = _take_rows(X, new) - _take_rows(X, old)
    return moved.mul(moved).sum(-1).sqrt().sum(-1).mean()


@torch.no_grad()
def kmedoids_on_distances(X: torch.Tensor, D: torch.Tensor, l2: torch.Tensor,
                          K: int, threshold: float = 1e-5,
                          iter_limit: int = 60, id_sort: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KKZ + Lloyd + id sort on given distances D [B, N, N] (both tricks
    applied), norms l2 [B, N] and the points X [B, N, Dim] the stop rule
    measures medoid movement in.  Returns (assign, medoids) as int32."""
    meds = kkz_init(l2, D, K)
    assign = torch.zeros(D.shape[:2], dtype=torch.long, device=D.device)
    step, shift = 0, float("inf")
    if iter_limit >= FIXED_ITER_CAP:
        for _ in range(FIXED_ITER_CAP - 1):
            meds = _update_step(D, _assign_step(D, meds), K)
        step = FIXED_ITER_CAP - 1
    # one host read per step from here on, for the stop test
    while step < iter_limit and shift >= threshold:
        assign = _assign_step(D, meds)
        new = _update_step(D, assign, K)
        shift = float(_shift(X, new, meds))
        meds = new
        step += 1
    if id_sort:
        meds = meds.sort(dim=1).values
        assign = _assign_step(D, meds)
    return assign.int(), meds.int()


@torch.no_grad()
def fixed_point_steps(D: torch.Tensor, l2: torch.Tensor, K: int,
                      iter_limit: int = 100) -> torch.Tensor:
    """[B] int32: the Lloyd steps each segment takes to its medoid fixed
    point from KKZ, counted as the kernel counts them (the step that leaves
    the medoid set unchanged is the last one counted), at most
    `iter_limit`."""
    meds = kkz_init(l2, D, K)
    steps = torch.zeros(D.shape[0], dtype=torch.int32, device=D.device)
    running = torch.ones(D.shape[0], dtype=torch.bool, device=D.device)
    for _ in range(iter_limit):
        new = _update_step(D, _assign_step(D, meds), K)
        steps += running
        running &= (new != meds).any(dim=1)
        meds = new
        if not bool(running.any()):
            break
    return steps


def kmedoids_inputs(X: torch.Tensor, distance: str = "euclidean",
                    norm_p: float = 2.0, pre_norm: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[B, N, Dim] points -> (fp32 points, distances D [B, N, N] with both
    tricks, norms l2 [B, N]): what the plain version and the kernel take."""
    X = X.float()
    if pre_norm:
        X = X / (torch.linalg.vector_norm(X, dim=-1, keepdim=True) + 1e-6)
    D = pairwise_distance(X, X, metric=distance, p=norm_p,
                          all_negative=True, self_nearest=True)
    return X, D, torch.linalg.vector_norm(X, dim=-1)


@torch.no_grad()
def batch_fast_kmedoids(X: torch.Tensor, K: int, distance: str = "euclidean",
                        threshold: float = 1e-5, iter_limit: int = 60,
                        id_sort: bool = True, norm_p: float = 2.0,
                        pre_norm: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, N, Dim] points -> (assign [B, N] int32, medoids [B, K] int32)."""
    X, D, l2 = kmedoids_inputs(X, distance, norm_p, pre_norm)
    return kmedoids_on_distances(X, D, l2, K, threshold=threshold,
                                 iter_limit=iter_limit, id_sort=id_sort)
