# coding=utf-8
"""Multi-segment token clustering before a ViT block (kmediods++ branch).

Port of the JAX package's `ops/cluster_layer.py` (reference:
modules/cluster/cluster.py:66-352):

  input  [B*T, 1+P, D]   T frames, P patch tokens per frame, CLS first
  group the T frames into S segments of `dur` frames; per segment cluster
  the dur*P patch tokens into K medoids (k-medoids on a detached fp32 copy,
  no autograd); the new CLS is the mean of the segment's frame CLS tokens
  output [B*S, 1+K, D]   in x's dtype, as in the JAX package

Gradient flows, as in the JAX package (whose `stop_gradient` sits inside
`_cluster` only), through the gathered medoid tokens (or the cluster means)
and the CLS means back to the tokens of the blocks before.

k-medoids goes through `ops/kmedoids_cuda.kmedoids`: the CUDA kernel for a
CUDA tensor, the plain version for a CPU tensor.  The pooling,
sparse_sampling, spectral and shift algorithms are not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..config import BlockClusterSpec, ClusterConfig
from .kmedoids_cuda import kmedoids

PORTED_ALGOS = ("kmediods++",)


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
    """Clustering module of one insertion point.  Its learned parameters
    (`cluster_embed`, `cls_multiplier`) exist only when the config enables
    them, under the reference's names."""

    def __init__(self, spec: BlockClusterSpec, cfg: ClusterConfig,
                 width: int):
        super().__init__()
        if spec.algo not in PORTED_ALGOS:
            raise NotImplementedError(
                f"cluster algo {spec.algo!r} is not ported yet "
                f"(ported: {PORTED_ALGOS})")
        if cfg.cluster_frame_embedding:
            raise NotImplementedError("cluster_frame_embedding is not ported")
        self.spec, self.cfg = spec, cfg
        if cfg.cluster_embedding:
            self.cluster_embed = nn.Parameter(
                torch.empty(spec.cluster_num, width))
        if cfg.adaptive_cls:
            self.cls_multiplier = nn.Parameter(torch.full(
                (1, spec.before_frames, 1, 1), 1.0 / spec.frame_duration))

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.cfg.cluster_embedding:
            width = self.cluster_embed.shape[1]
            with torch.no_grad():
                self.cluster_embed.normal_(0.0, width ** -0.5,
                                           generator=generator)
        if self.cfg.adaptive_cls:
            with torch.no_grad():
                self.cls_multiplier.fill_(1.0 / self.spec.frame_duration)

    def _cluster(self, res_tmp: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg, spec = self.cfg, self.spec
        return kmedoids(res_tmp.detach().float(), spec.cluster_num,
                        distance=cfg.distance, threshold=cfg.threshold,
                        iter_limit=cfg.iter_limit, id_sort=cfg.id_sort,
                        norm_p=cfg.minkowski_p, pre_norm=cfg.pre_norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        Bt, num_tokens, width = x.shape
        T, S, dur = spec.before_frames, spec.after_frames, spec.frame_duration
        B = Bt // T
        K = spec.cluster_num

        all_cls = x[:, 0, :].reshape(B, T, 1, width)
        if self.cfg.adaptive_cls:
            all_cls = all_cls * self.cls_multiplier
        cls_seg = all_cls.reshape(B, S, dur, width).mean(dim=2)
        cls_seg = cls_seg.reshape(B * S, 1, width)

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
        if self.cfg.cluster_embedding:
            x_tmp = x_tmp + self.cluster_embed.to(x_tmp.dtype)
        return torch.cat([cls_seg.to(x_tmp.dtype), x_tmp], dim=1)


def video_mask_after_cluster(video_mask, final_frames: int,
                             f_frame_duration: int):
    """Keep the mask of the last frame of each segment
    (reference: clip4clip.py:436-447)."""
    T = video_mask.shape[-1]
    inds = np.arange(f_frame_duration - 1, T, T // final_frames)
    return video_mask[..., inds.tolist()]
