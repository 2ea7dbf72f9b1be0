# coding=utf-8
"""Explicit collectives over the data and model axes (port of the JAX
package's `parallel/collectives.py`; reference: modules/utils.py:25-64).

`all_gather_local_grads` is the reference's trick for the contrastive loss
over the global batch: every rank of the data group gathers every rank's
features, and the gradient flows back only through the rank's own slot
(the reference replaces the local slot of the gathered list with the
grad-carrying tensor, modules/utils.py:47-64).  `group` is a
`torch.distributed` process group, None for the default one: the
counterpart of JAX's axis name.

The Megatron operators of tensor and sequence parallelism (arXiv:1909.08053,
2205.05198), as autograd Functions over the plain collectives, which both
NCCL and gloo take (JAX's GSPMD inserts the same collectives from its
shardings):

* `copy_to_model`: identity forward, all-reduce backward (before a
  column-parallel layer);
* `reduce_from_model`: all-reduce forward, identity backward (after a
  row-parallel layer);
* `gather_tokens`: all-gather on the token axis forward, reduce-scatter
  backward (sequence parallelism's entry to a column-parallel layer);
* `reduce_scatter_tokens`: reduce-scatter on the token axis forward,
  all-gather backward (its exit from a row-parallel layer);
* `split_tokens` and `gather_whole_tokens`: a run of token-split blocks'
  entry (this rank's tokens of a replicated stream; all-gather backward)
  and exit (all-gather forward; this rank's tokens of the replicated
  gradient backward).

The token axis is axis 1 ([batch, tokens, ...]).  A length L that the
group's size n does not divide is padded with zero tokens to n * ceil(L /
n), as GSPMD pads an uneven shard: rank r holds tokens [r c, (r + 1) c) of
the padded stream, and a gather trims the padding.  A collective that
fails raises; nothing falls back to a whole-model path.

The stage hop of pipeline parallelism (`parallel/pipeline.py`, JAX's
`ppermute` and `psum` over the pipe axis, `pipeline.py:155-162` there):

* `stage_hop`: one tick's exchange on a pipe group, a microbatch (or its
  gradient) sent to one neighbouring stage and another received from the
  other, paired in one `batch_isend_irecv`.  gloo's point-to-point reads
  a tensor's memory from the host, so over gloo a CUDA tensor goes through
  host memory (NCCL takes the device pointers); so do the broadcasts
  below.
* `from_last_stage`: broadcast from the last stage forward (the segment's
  output, which only it holds: JAX's `psum`), identity backward (the
  graph after a segment is the same on every stage, so is its cotangent;
  a sum would scale it by the stage count);
* `to_stages`: identity forward (every stage holds the replicated input),
  and backward the sum over the group of a gradient that only the first
  stage holds, as a broadcast from it.
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


# ------------------------------------------------------------ the model axis
def token_chunk(length: int, size: int) -> int:
    """Tokens a rank holds of a stream of `length` split over `size`
    ranks: ceil(length / size)."""
    return -(-length // size)


def _pad_tokens(x: torch.Tensor, size: int) -> torch.Tensor:
    pad = size * token_chunk(x.shape[1], size) - x.shape[1]
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], pad, *x.shape[2:]))], 1)


def _all_gather_tokens(x: torch.Tensor, group, size: int, length: int
                       ) -> torch.Tensor:
    """Every rank's [B, c, ...] chunk -> the [B, length, ...] stream."""
    x = x.contiguous()
    out = x.new_empty((size * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    out = out.reshape(size, *x.shape).transpose(0, 1)
    return out.reshape(x.shape[0], size * x.shape[1],
                       *x.shape[2:])[:, :length]


def _reduce_scatter_tokens(x: torch.Tensor, group, size: int
                           ) -> torch.Tensor:
    """[B, L, ...] partial sums -> this rank's [B, c, ...] chunk of their
    sum over the group."""
    xp = _pad_tokens(x, size)
    B, c = xp.shape[0], xp.shape[1] // size
    src = xp.reshape(B, size, c, *xp.shape[2:]).transpose(0, 1)
    src = src.reshape(size * B, c, *xp.shape[2:]).contiguous()
    out = src.new_empty((B, c, *xp.shape[2:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out


def _own_tokens(x: torch.Tensor, size: int, rank: int) -> torch.Tensor:
    """This rank's [B, c, ...] chunk of a whole [B, L, ...] stream."""
    c = token_chunk(x.shape[1], size)
    return _pad_tokens(x, size)[:, rank * c:(rank + 1) * c].contiguous()


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, length, reduce_grad):
        ctx.args = group, size, length, reduce_grad
        return _all_gather_tokens(x, group, size, length)

    @staticmethod
    def backward(ctx, grad):
        group, size, length, reduce_grad = ctx.args
        rank = dist.get_rank(group)
        g = (_reduce_scatter_tokens(grad, group, size) if reduce_grad
             else _own_tokens(grad, size, rank))
        return g, None, None, None, None


class _ReduceScatterTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size):
        ctx.args = group, size, x.shape[1]
        return _reduce_scatter_tokens(x, group, size)

    @staticmethod
    def backward(ctx, grad):
        group, size, length = ctx.args
        return _all_gather_tokens(grad, group, size, length), None, None


class _SplitTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size):
        ctx.args = group, size, x.shape[1]
        return _own_tokens(x, size, dist.get_rank(group))

    @staticmethod
    def backward(ctx, grad):
        group, size, length = ctx.args
        return _all_gather_tokens(grad, group, size, length), None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: `x` as it is; its gradient summed over the model
    group (each rank's column-parallel slice contributes a part)."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: the sum over the model group of the row-parallel
    partial products; the gradient passes as it is."""
    return _ReduceFromModel.apply(x, group)


def gather_tokens(x: torch.Tensor, group, length: int) -> torch.Tensor:
    """Sequence parallelism's entry to a column-parallel layer: every
    rank's token chunk [B, c, ...] -> the [B, length, ...] stream; the
    gradient (a partial sum on each rank) reduce-scattered back to the
    chunks."""
    return _GatherTokens.apply(x, group, dist.get_world_size(group), length,
                               True)


def reduce_scatter_tokens(x: torch.Tensor, group) -> torch.Tensor:
    """Sequence parallelism's exit from a row-parallel layer: the partial
    products [B, L, ...] summed over the model group, this rank's token
    chunk [B, c, ...] kept; the gradient all-gathered back."""
    return _ReduceScatterTokens.apply(x, group, dist.get_world_size(group))


def split_tokens(x: torch.Tensor, group) -> torch.Tensor:
    """A token-split run's entry: this rank's chunk [B, c, ...] of a
    stream [B, L, ...] that every rank of the group holds whole; the
    chunks' gradients all-gathered back to the whole stream's."""
    return _SplitTokens.apply(x, group, dist.get_world_size(group))


def gather_whole_tokens(x: torch.Tensor, group, length: int
                        ) -> torch.Tensor:
    """A token-split run's exit: the whole stream [B, length, ...] on every
    rank of the group; of its gradient, whole and equal on every rank,
    each rank keeps its chunk's."""
    return _GatherTokens.apply(x, group, dist.get_world_size(group), length,
                               False)


# ------------------------------------------------------------- the pipe axis
def group_ranks(group) -> list:
    """The global ranks of `group`, in group order."""
    return dist.get_process_group_ranks(group)


def _host_staged(group, t: torch.Tensor) -> bool:
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def stage_hop(send: Optional[torch.Tensor], dst: Optional[int],
              recv_like: Optional[torch.Tensor], src: Optional[int],
              group) -> Optional[torch.Tensor]:
    """One tick of the pipeline: send `send` to group rank `dst` and
    receive a tensor shaped as `recv_like` from group rank `src`, either
    or both (None to skip), as one batch of point-to-point operations.
    Returns the received tensor (on `recv_like`'s device), or None.  Every
    send must meet its receive in the same tick on the peer."""
    ranks = group_ranks(group)
    ops, staged = [], []
    out = None
    if send is not None:
        buf = send.detach().contiguous()
        if _host_staged(group, buf):
            buf = buf.cpu()
        ops.append(dist.P2POp(dist.isend, buf, ranks[dst], group))
    if recv_like is not None:
        out = torch.empty_like(recv_like,
                               memory_format=torch.contiguous_format)
        buf = out
        if _host_staged(group, out):
            buf = torch.empty(out.shape, dtype=out.dtype)
            staged.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, ranks[src], group))
    if not ops:
        return None
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged:
        out.copy_(staged[0])
    return out


def broadcast_from(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """`x` of group rank `src` on every rank of `group` (a new tensor;
    through host memory over gloo, as `stage_hop`)."""
    out = x.detach().contiguous().clone()
    buf = out.cpu() if _host_staged(group, out) else out
    dist.broadcast(buf, group_ranks(group)[src], group=group)
    if buf is not out:
        out.copy_(buf)
    return out


class _FromLastStage(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        return broadcast_from(y, dist.get_world_size(group) - 1, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ToStages(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return broadcast_from(grad, 0, ctx.group), None


def from_last_stage(y: torch.Tensor, group) -> torch.Tensor:
    """A pipelined segment's exit: the last stage's `y` on every stage; the
    gradient passes as it is (see the module docstring)."""
    return _FromLastStage.apply(y, group)


def to_stages(x: torch.Tensor, group) -> torch.Tensor:
    """A pipelined segment's entry: `x` as it is; of its gradient, which
    only the first stage holds, the sum over the group (a broadcast from
    the first stage)."""
    return _ToStages.apply(x, group)
