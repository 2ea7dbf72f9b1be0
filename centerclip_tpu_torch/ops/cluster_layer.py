# coding=utf-8
"""Multi-segment token reduction before a ViT block (port of the JAX
package's `ops/cluster_layer.py`; reference:
modules/cluster/cluster.py:66-352).

  input  [B*T, 1+P, D]   T frames, P patch tokens per frame, CLS first

* `kmediods++` and `spectral`: group the T frames into S segments of `dur`
  frames; per segment cluster the dur*P patch tokens into K medoids (on a
  detached fp32 copy, no autograd); the new CLS is the mean of the
  segment's frame CLS tokens.  Output [B*S, 1+K, D].
* `pooling`: the mean over each segment's frames, CLS included.  Output
  [B*S, 1+P, D].
* `sparse_sampling`: K of each segment's dur*P patch tokens, picked
  uniformly, or, given a `generator` (training), one at random from each
  of K equal runs, the same columns for every clip; CLS as above.  Output
  [B*S, 1+K, D].
* `temporal_shift` / `token_shift`: channel shifts over the T frames
  (`ops/shift.py`); same shape.

Output in x's dtype, as in the JAX package.  Gradient flows, as there
(whose `stop_gradient` sits inside `_cluster` only), through the gathered
tokens (or the cluster means) and the CLS means back to the tokens of the
blocks before.

k-medoids goes through `ops/kmedoids_cuda.kmedoids` (kernel E for a CUDA
tensor, the plain version for a CPU tensor); spectral clustering through
`ops/spectral.py`, whose k-medoids takes the same route.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import BlockClusterSpec, ClusterConfig
from ..utils.spans import span
from .kmedoids_cuda import kmedoids
from .shift import temporal_shift_wo_cls, token_shift
from . import spectral

PORTED_ALGOS = ("kmediods++", "pooling", "sparse_sampling", "spectral",
                "temporal_shift", "token_shift")
# the algorithms that cluster and so carry the learned extras
CLUSTERING_ALGOS = ("kmediods++", "spectral")


def segment_major(res_x: torch.Tensor, S: int, dur: int) -> torch.Tensor:
    """[B, T, P, D] -> [S*B, dur*P, D]; sample b, segment s at row s*B + b
    (torch.split(dim=1) + cat(dim=0), cluster.py:249-250)."""
    B, T, P, D = res_x.shape
    if T != S * dur:
        raise ValueError(f"T={T} is not S*dur={S}*{dur}")
    x = res_x.reshape(B, S, dur, P, D).transpose(0, 1)       # [S, B, dur, P, D]
    return x.reshape(S * B, dur * P, D)


def segment_interleave(x_tmp: torch.Tensor, B: int, S: int) -> torch.Tensor:
    """Segment-major [S*B, K, D] -> clip-major [B*S, K, D] (cluster.py:303)."""
    SB, K, D = x_tmp.shape
    return x_tmp.reshape(S, B, K, D).transpose(0, 1).reshape(B * S, K, D)


class TokenClusterInter(nn.Module):
    """Token reduction of one insertion point.  Its learned parameters
    (`cluster_embed`, `cluster_frame_embed`, `cls_multiplier`) exist only
    for the clustering algorithms and only when the config enables them,
    under the reference's names; `cluster_frame_embed` is created and never
    read, as in the JAX package.  `spectral_spg` adds the fixed
    spatial-temporal graph as the buffer `spg` (not in the state dict)."""

    def __init__(self, spec: BlockClusterSpec, cfg: ClusterConfig,
                 width: int):
        super().__init__()
        if spec.algo not in PORTED_ALGOS:
            raise NotImplementedError(
                f"unknown cluster algo {spec.algo!r} (ported: "
                f"{PORTED_ALGOS})")
        self.spec, self.cfg = spec, cfg
        clustering = spec.algo in CLUSTERING_ALGOS
        self.has_embed = cfg.cluster_embedding and clustering
        self.has_frame_embed = cfg.cluster_frame_embedding and clustering
        self.has_multiplier = cfg.adaptive_cls and clustering
        if self.has_embed:
            self.cluster_embed = nn.Parameter(
                torch.empty(spec.cluster_num, width))
        if self.has_frame_embed:
            self.cluster_frame_embed = nn.Parameter(
                torch.empty(spec.frame_duration, 1, width))
        if self.has_multiplier:
            self.cls_multiplier = nn.Parameter(torch.full(
                (1, spec.before_frames, 1, 1), 1.0 / spec.frame_duration))
        graph = None
        if cfg.spectral_spg and spec.algo == "spectral":
            graph = torch.from_numpy(spectral.spatial_temporal_graph(
                spec.before_cluster_num * spec.frame_duration,
                spec.before_cluster_num, s_kernel=spec.spg_s_kernel,
                t_kernel=spec.spg_t_kernel)[None].astype(np.float32))
        self.register_buffer("spg", graph, persistent=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for on, p in ((self.has_embed, "cluster_embed"),
                          (self.has_frame_embed, "cluster_frame_embed")):
                if on:
                    p = getattr(self, p)
                    p.normal_(0.0, p.shape[-1] ** -0.5, generator=generator)
            if self.has_multiplier:
                self.cls_multiplier.fill_(1.0 / self.spec.frame_duration)

    def _cluster(self, res_tmp: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(assign [S*B, N], medoid ids [S*B, K]) of segment-major tokens."""
        cfg, spec = self.cfg, self.spec
        res_tmp = res_tmp.detach().float()
        if spec.algo == "spectral":
            return spectral.batch_spectral_clustering(
                res_tmp, spec.cluster_num, mode=cfg.spectral_graph,
                knn_k=spec.spectral_knn_k, metric=cfg.distance,
                threshold=cfg.threshold, iter_limit=cfg.iter_limit,
                id_sort=cfg.id_sort, norm_p=cfg.minkowski_p,
                correct_sign=cfg.svd_correct_sign, sigma=cfg.spectral_sigma,
                spatial_temporal_graph=self.spg,
                solver=cfg.spectral_solver)
        return kmedoids(res_tmp, spec.cluster_num,
                        distance=cfg.distance, threshold=cfg.threshold,
                        iter_limit=cfg.iter_limit, id_sort=cfg.id_sort,
                        norm_p=cfg.minkowski_p, pre_norm=cfg.pre_norm)

    def _segment_cls(self, x: torch.Tensor, B: int) -> torch.Tensor:
        """[B*T, 1+P, D] -> the mean CLS of each segment, [B*S, 1, D]."""
        spec = self.spec
        all_cls = x[:, 0, :].reshape(B, spec.before_frames, 1, x.shape[-1])
        if self.has_multiplier:
            all_cls = all_cls * self.cls_multiplier
        cls_seg = all_cls.reshape(B, spec.after_frames, spec.frame_duration,
                                  x.shape[-1]).mean(dim=2)
        return cls_seg.reshape(B * spec.after_frames, 1, x.shape[-1])

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B*T, 1+P, D] -> the reduced tokens.  `generator` draws
        `sparse_sampling`'s random columns (training); without one its
        uniform columns are taken.  The other algorithms draw nothing.
        Runs in a `cluster` span (`utils/spans.py`) of its B*S segments."""
        spec = self.spec
        with span("cluster", algo=spec.algo, segments=x.shape[0]
                  // spec.before_frames * spec.after_frames):
            return self._reduce(x, generator)

    def _reduce(self, x: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        spec = self.spec
        Bt, num_tokens, width = x.shape
        T, S, dur = spec.before_frames, spec.after_frames, spec.frame_duration
        B = Bt // T
        K = spec.cluster_num

        if spec.algo == "temporal_shift":
            return temporal_shift_wo_cls(x, T)
        if spec.algo == "token_shift":
            return token_shift(x, T)
        if spec.algo == "pooling":
            res = x.reshape(B, S, dur, num_tokens, width).mean(dim=2)
            return res.reshape(B * S, num_tokens, width)

        cls_seg = self._segment_cls(x, B)
        if spec.algo == "sparse_sampling":
            total = dur * (num_tokens - 1)
            res_x = x[:, 1:, :].reshape(B, S, total, width)
            if generator is None:
                cols = torch.as_tensor(uniform_token_indices(K, total),
                                       device=x.device)[None].expand(S, K)
            else:
                cols = random_token_indices(generator, S, K, total)
            idx = cols.to(x.device)[None, :, :, None].expand(B, -1, -1, width)
            x_tmp = torch.gather(res_x, 2, idx).reshape(B * S, K, width)
            return torch.cat([cls_seg.to(x_tmp.dtype), x_tmp], dim=1)

        res_x = x[:, 1:, :].reshape(B, T, num_tokens - 1, width)
        res_tmp = segment_major(res_x, S, dur)               # [S*B, N, D]
        assign, medoid_ids = self._cluster(res_tmp)
        if self.cfg.aggregation in (None, "None"):
            idx = medoid_ids.long()[..., None].expand(-1, -1, width)
            x_tmp = torch.gather(res_tmp, 1, idx)                # [S*B, K, D]
        else:
            onehot = nn.functional.one_hot(assign.long(), K).to(res_tmp.dtype)
            sums = torch.einsum("bnk,bnd->bkd", onehot, res_tmp)
            counts = onehot.sum(dim=1)[..., None]
            x_tmp = sums / counts.clamp_min(1e-6)
        x_tmp = segment_interleave(x_tmp, B, S)                  # [B*S, K, D]
        if self.has_embed:
            x_tmp = x_tmp + self.cluster_embed.to(x_tmp.dtype)
        return torch.cat([cls_seg.to(x_tmp.dtype), x_tmp], dim=1)


def uniform_token_indices(target: int, total: int) -> np.ndarray:
    """Uniform token pick (reference: cluster_utils.py:163-173); with fewer
    tokens than `target`, every token in order and then the last one again
    (the JAX package's gather clamps the reference's index `total` so)."""
    if total > target:
        tick = total / float(target)
        return np.array([int(tick / 2.0 + tick * i) for i in range(target)])
    return np.clip(np.arange(target), 0, total - 1)


def random_token_indices(generator: torch.Generator, segments: int,
                         target: int, total: int) -> torch.Tensor:
    """[segments, target] random token columns, drawn on the generator's
    device (reference: cluster_utils.py:150-161): one from each of `target`
    runs of total // target tokens; with fewer tokens than `target`, as
    `uniform_token_indices` (the reference's sorted random subset needs
    total > target, where no run is empty)."""
    dev = generator.device
    avg = total // target
    if avg == 0:
        return torch.as_tensor(uniform_token_indices(target, total),
                               device=dev).expand(segments, target)
    base = torch.arange(target, device=dev) * avg
    return base + torch.randint(0, avg, (segments, target),
                                generator=generator, device=dev)


def video_mask_after_cluster(video_mask, final_frames: int,
                             f_frame_duration: int):
    """Keep the mask of the last frame of each segment
    (reference: clip4clip.py:436-447)."""
    T = video_mask.shape[-1]
    inds = np.arange(f_frame_duration - 1, T, T // final_frames)
    return video_mask[..., inds.tolist()]
