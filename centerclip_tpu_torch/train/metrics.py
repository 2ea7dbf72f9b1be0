# coding=utf-8
"""Retrieval metrics (reference: utils/metrics.py), NumPy — metrics run on
the host over the assembled similarity matrix.  An own copy of the JAX
package's `train/metrics.py`; `AverageMeter` has no cross-process sync
(the port has no distributed training yet).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def compute_metrics(x: np.ndarray) -> Dict[str, float]:
    """R@1/5/10, median and mean rank of the diagonal
    (reference: metrics.py:11-26): for row i, the rank of entry (i, i) among
    row i sorted descending."""
    x = np.asarray(x)
    sx = np.sort(-x, axis=1)
    d = np.diag(-x)[:, np.newaxis]
    ind = np.where(sx - d == 0)[1]
    metrics: Dict[str, float] = {}
    metrics["R1"] = float(np.sum(ind == 0)) * 100 / len(ind)
    metrics["R5"] = float(np.sum(ind < 5)) * 100 / len(ind)
    metrics["R10"] = float(np.sum(ind < 10)) * 100 / len(ind)
    metrics["MR"] = float(np.median(ind) + 1)
    metrics["MedianR"] = metrics["MR"]
    metrics["MeanR"] = float(np.mean(ind) + 1)
    metrics["cols"] = [int(i) for i in list(ind)]
    return metrics


def tensor_text_to_video_metrics(sim_tensor: np.ndarray,
                                 top_k=(1, 5, 10)) -> Dict[str, float]:
    """Multi-sentence T2V metrics (reference: metrics.py:38-65).

    sim_tensor: [n_videos, max_caps, n_videos] with -inf padding rows for
    videos with fewer captions.  Rank of the true video for every valid
    caption via double argsort.
    """
    sim = np.asarray(sim_tensor, np.float64)
    # [max_caps, n_videos(query), n_videos(gallery)]
    stacked = np.transpose(sim, (1, 0, 2))
    first = np.argsort(-stacked, axis=-1, kind="stable")
    second = np.argsort(first, axis=-1, kind="stable")
    ranks = np.diagonal(second, axis1=1, axis2=2).flatten()
    original = np.diagonal(sim, axis1=0, axis2=2).flatten()
    valid = ~(np.isinf(original) | np.isnan(original))
    valid_ranks = ranks[valid]
    results = {f"R{k}": float(np.sum(valid_ranks < k) * 100 / len(valid_ranks))
               for k in top_k}
    results["MedianR"] = float(np.median(valid_ranks + 1))
    results["MeanR"] = float(np.mean(valid_ranks + 1))
    results["Std_Rank"] = float(np.std(valid_ranks + 1))
    results["MR"] = results["MedianR"]
    return results


def tensor_video_to_text_sim(sim_tensor: np.ndarray) -> np.ndarray:
    """V2T similarity: per-(video, gallery-video) max over that video's
    captions (reference: metrics.py:68-76).  NaNs count as -inf."""
    sim = np.asarray(sim_tensor, np.float64).copy()
    sim[np.isnan(sim)] = -np.inf
    return np.max(sim, axis=1).T.squeeze()


def reshape_multi_sentence_sim(sim_matrix: np.ndarray,
                               cut_off_points: List[int]) -> np.ndarray:
    """Pack a flat [n_sentences, n_videos] sim matrix into
    [n_videos, max_caps, n_videos] with -inf padding
    (reference: main.py:466-476).

    Args:
        cut_off_points: per-video 1-based end index into the sentence axis
            (dataset convention, e.g. dataloader_msvd_retrieval.py:64-89).
    """
    starts = [0] + cut_off_points[:-1]
    max_length = max(e - s for s, e in zip(starts, cut_off_points))
    rows = []
    for s, e in zip(starts, cut_off_points):
        pad = np.full((max_length - (e - s), sim_matrix.shape[1]), -np.inf)
        rows.append(np.concatenate((sim_matrix[s:e], pad), axis=0))
    return np.stack(rows, axis=0)


class AverageMeter:
    """Running average (reference: metrics.py:88-118)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)
