# coding=utf-8
"""Explicit collectives over the data axis (port of the JAX package's
`parallel/collectives.py`; reference: modules/utils.py:25-64).

`all_gather_local_grads` is the reference's trick for the contrastive loss
over the global batch: every rank gathers every rank's features, and the
gradient flows back only through the rank's own slot (the reference
replaces the local slot of the gathered list with the grad-carrying
tensor, modules/utils.py:47-64).  `group` is a `torch.distributed` process
group, None for the default one: the counterpart of JAX's axis name.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


class _AllGatherLocalGrads(torch.autograd.Function):
    """Forward: the tiled all-gather.  Backward: the rows of this rank's
    slot, times `grad_scale`; no collective."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group, grad_scale: float):
        ctx.rows, ctx.grad_scale = x.shape[0], grad_scale
        ctx.start = dist.get_rank(group) * x.shape[0]
        return all_gather(x.detach(), group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        local = grad[ctx.start:ctx.start + ctx.rows]
        if ctx.grad_scale != 1.0:
            local = local * ctx.grad_scale
        return local, None, None


def all_gather_local_grads(x: torch.Tensor, group=None,
                           grad_scale: float = 1.0) -> torch.Tensor:
    """All-gather along the group with gradients only through the local
    shard: [world * B, ...] in rank order, where this rank's slot holds
    `x` itself.  Summed over the ranks, the backward equals the full
    gradient of a loss computed on the gathered tensor (JAX
    `collectives.py:17-36`).

    `grad_scale` multiplies the local slot's gradient.  When every rank
    computes the same loss on the gathered tensor and the gradients are
    then averaged over the ranks (DDP, FSDP), `grad_scale = world` makes
    that average the one-process gradient of the global-batch loss: each
    rank's local-slot gradient is 1 / world of the sum over the ranks'
    identical losses."""
    return _AllGatherLocalGrads.apply(x, group, float(grad_scale))


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Plain tiled all-gather, [world * B, ...] in rank order (the list
    form of the collective, which both NCCL and gloo take)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def psum(x: torch.Tensor, group: Optional[object] = None) -> torch.Tensor:
    """Cross-rank sum, as a new tensor (gradient reduction / AverageMeter
    sync, reference: metrics.py:112-115)."""
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out
