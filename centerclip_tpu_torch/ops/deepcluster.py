# coding=utf-8
"""Learned ("deep") clustering head (port of the JAX package's
`ops/deepcluster.py`; reference: modules/cluster/deepcluster.py).

Experimental in the reference ("does not work now", deepcluster.py:3) but
part of its surface: an MLP over the token axis predicts K centroids from
the detached segment tokens, a within-cluster sum of squares (WCSS) is added
to the training loss, and the tokens nearest the centroids continue as the
segment's tokens.  Mutually exclusive with `cluster_inter`.

The head's three Linear + LayerNorm(eps 1e-5) pairs run in fp32 on fp32
parameters whatever the tower's dtype (the JAX package's Dense and LayerNorm
layers promote bf16 tokens against fp32 parameters the same way); they are
plain PyTorch layers, as the JAX package's run outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..config import BlockClusterSpec, ClusterConfig, ModelConfig
from .cluster_layer import segment_interleave, segment_major
from .distances import squared_l2_distance


def deep_cluster_plan(cfg: ModelConfig
                      ) -> Tuple[Optional[BlockClusterSpec], ...]:
    """Which blocks get a DeepCluster head.  Unlike `build_cluster_plan`,
    frames are read straight off `target_frames_blocks` with no
    `max_frames` prepended (reference: deepcluster.py:25-34)."""
    num_layers = cfg.arch["vision_layers"]
    cl = cfg.cluster
    if not cl.deep_cluster:
        return tuple(None for _ in range(num_layers))
    if len(cl.cluster_num_blocks) != num_layers \
            or len(cl.target_frames_blocks) != num_layers:
        raise ValueError(f"cluster_num_blocks and target_frames_blocks must "
                         f"have {num_layers} entries")
    plan = []
    for block_id in range(1, num_layers + 1):
        cluster_num = cl.cluster_num_blocks[block_id - 1]
        before_cluster_num = cl.cluster_num_blocks[max(block_id - 2, 0)]
        after_frames = cl.target_frames_blocks[block_id - 1]
        before_frames = cl.target_frames_blocks[max(block_id - 2, 0)]
        is_cluster = (cluster_num is not None and cluster_num > 1) and (
            before_frames > after_frames or before_cluster_num > cluster_num)
        plan.append(BlockClusterSpec(
            block_id=block_id, algo="deepcluster",
            before_cluster_num=before_cluster_num, cluster_num=cluster_num,
            before_frames=before_frames, after_frames=after_frames,
            frame_duration=before_frames // after_frames)
            if is_cluster else None)
    return tuple(plan)


def batch_within_cluster_sse(x: torch.Tensor, centroids: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(WCSS loss, hard assignment [B, L]) (reference:
    deepcluster.py:203-218)."""
    d2 = squared_l2_distance(x, centroids)                 # [B, L, K]
    values, assign = d2.min(dim=-1)
    return values.sum(-1).mean(), assign


def get_medoids(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Sorted ids [B, K] of the tokens nearest each centroid (reference:
    deepcluster.py:221-246), with the reference's all-negative trick:
    tokens outside cluster k are zeroed by the mask and lose the min
    against the strictly negative members."""
    K = centroids.shape[1]
    d = squared_l2_distance(x, centroids).sqrt()           # [B, L, K]
    d = d - d.max() - 1.0
    cluster_distance, assign = d.min(dim=-1)               # [B, L]
    onehot = nn.functional.one_hot(assign, K).to(d.dtype)  # [B, L, K]
    medoids = (onehot * cluster_distance[..., None]).argmin(dim=1)
    return medoids.sort(dim=-1).values


class DeepCluster(nn.Module):
    """The learned clustering head before one block (reference:
    deepcluster.py:51-151): fc1 (L -> 4L), fc2 (4L -> dur*K), fc3
    (dur*K -> K) over the token axis, each followed by ln1-ln3, where
    L = dur * `tokens_per_frame`, the patch tokens per frame that reach
    the block (the JAX package's layers take L from the input)."""

    def __init__(self, spec: BlockClusterSpec, cfg: ClusterConfig,
                 tokens_per_frame: int):
        super().__init__()
        self.spec, self.cfg = spec, cfg
        dur, K = spec.frame_duration, spec.cluster_num
        L_in = dur * tokens_per_frame
        self.fc1 = nn.Linear(L_in, 4 * L_in)
        self.ln1 = nn.LayerNorm(4 * L_in, eps=1e-5)
        self.fc2 = nn.Linear(4 * L_in, dur * K)
        self.ln2 = nn.LayerNorm(dur * K, eps=1e-5)
        self.fc3 = nn.Linear(dur * K, K)
        self.ln3 = nn.LayerNorm(K, eps=1e-5)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's initialisers: Dense kernels normal(0.01),
        biases 0, LayerNorm scale 1 and bias 0."""
        with torch.no_grad():
            for fc, ln in ((self.fc1, self.ln1), (self.fc2, self.ln2),
                           (self.fc3, self.ln3)):
                fc.weight.normal_(0.0, 0.01, generator=generator)
                fc.bias.zero_()
                ln.weight.fill_(1.0)
                ln.bias.zero_()

    def forward(self, x: torch.Tensor, training: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B*T_before, 1+P, D] -> ([B*T_after, 1+K, D] in x's dtype,
        WCSS loss: a fp32 scalar, 0 unless `training`)."""
        spec = self.spec
        Bt, num_tokens, width = x.shape
        T, S, dur = spec.before_frames, spec.after_frames, spec.frame_duration
        B = Bt // T

        all_cls = x[:, 0, :].reshape(B, T, 1, width)
        cls_seg = all_cls.reshape(B, S, dur, width).mean(dim=2)
        cls_seg = cls_seg.reshape(B * S, 1, width)

        res_x = x[:, 1:, :].reshape(B, T, num_tokens - 1, width)
        data = segment_major(res_x, S, dur)                  # [S*B, L, D]
        d_data = data.detach()

        h = d_data.float().transpose(-1, -2)                 # [S*B, D, L]
        h = self.ln1(self.fc1(h))
        h = self.ln2(self.fc2(h))
        h = self.ln3(self.fc3(h))
        centroids = h.transpose(-1, -2)                      # [S*B, K, D]

        if training:
            cluster_loss, _ = batch_within_cluster_sse(d_data, centroids)
        else:
            cluster_loss = torch.zeros((), device=x.device)

        with torch.no_grad():
            medoids = get_medoids(d_data, centroids.detach())
        idx = medoids[..., None].expand(-1, -1, width)
        sampled = segment_interleave(torch.gather(data, 1, idx), B, S)
        return torch.cat([cls_seg.to(sampled.dtype), sampled], dim=1), \
            cluster_loss
