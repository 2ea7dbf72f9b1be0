# coding=utf-8
"""Pairwise distances of the clustering pipeline (fp32).

Port of the JAX package's `ops/distances.py`, same formulation, because the
argmin/argmax decisions of k-medoids depend on it:

* direct `(x - y)^2` sums when both sides have at most 25 points (what
  `torch.cdist` does too), else mean-centre and take
  `(x2 + y2^T) - 2 x.y^T` in that grouping, clamped at 0;
* `all_negative`: shift each sample by `-(max + 1)` so every entry is
  negative (masked-out sums of 0 then lose every argmin);
* `self_nearest`: subtract 1 on the diagonal.

All of it is fp32.  On the card the matmuls run in true fp32: TF32 stays off
(`torch.backends.cuda.matmul.allow_tf32` is False by default).
"""
from __future__ import annotations

import torch


def squared_l2_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[..., N, D] x [..., M, D] -> [..., N, M] squared L2, fp32, >= 0."""
    x = x.float()
    y = y.float()
    if x.shape[-2] <= 25 and y.shape[-2] <= 25:
        diff = x[..., :, None, :] - y[..., None, :, :]
        return (diff * diff).sum(-1)
    mu = x.mean(dim=-2, keepdim=True)
    x = x - mu
    y = y - mu
    x2 = (x * x).sum(-1, keepdim=True)                       # [..., N, 1]
    y2 = (y * y).sum(-1, keepdim=True)                       # [..., M, 1]
    xy = x @ y.transpose(-1, -2)                             # [..., N, M]
    # (x2 + y2^T) - 2xy is bitwise symmetric for x is y whenever xy is
    # (tests/test_torch_kernels_plain.py checks it); the grouping keeps
    # 2-point clusters at an exact tie in the medoid update
    d2 = (x2 + y2.transpose(-1, -2)) - 2.0 * xy
    return d2.clamp_min(0.0)


def minkowski_distance(x: torch.Tensor, y: torch.Tensor, p: float
                       ) -> torch.Tensor:
    """General p-norm distance by broadcasting (exotic configs only)."""
    diff = (x.float()[..., :, None, :] - y.float()[..., None, :, :]).abs()
    if p == 1.0:
        return diff.sum(-1)
    if p == float("inf"):
        return diff.amax(-1)
    return diff.pow(p).sum(-1).pow(1.0 / p)


def cosine_distance(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-6
                    ) -> torch.Tensor:
    """1 - cosine similarity (reference: cluster_utils.py:24-30)."""
    x = x.float()
    y = y.float()
    xn = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)
    yn = y / (torch.linalg.vector_norm(y, dim=-1, keepdim=True) + eps)
    return 1.0 - xn @ yn.transpose(-1, -2)


def pairwise_distance(x: torch.Tensor, y: torch.Tensor,
                      metric: str = "euclidean", p: float = 2.0,
                      all_negative: bool = False,
                      self_nearest: bool = False) -> torch.Tensor:
    """Pairwise distance with the clustering pipeline's two tricks; the
    all-negative shift is per sample, as in the JAX package."""
    if metric == "euclidean":
        if p == 2.0:
            dis = squared_l2_distance(x, y).sqrt()
        else:
            dis = minkowski_distance(x, y, p)
    elif metric == "cosine":
        dis = cosine_distance(x, y)
    else:
        raise NotImplementedError(f"{metric} metric is not implemented")
    if all_negative:
        dis = dis - dis.amax(dim=(-2, -1), keepdim=True) - 1.0
    if self_nearest:
        n = dis.shape[-1]
        dis = dis - torch.eye(n, dtype=dis.dtype, device=dis.device)
    return dis
