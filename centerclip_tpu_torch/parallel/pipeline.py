# coding=utf-8
"""GPipe pipeline parallelism over a `(data, pipe)` mesh (port of the JAX
package's `parallel/pipeline.py`).

A run of homogeneous blocks (the text tower's 12, or a vision run between
two cluster modules) is split into `S` contiguous stages, one a rank of
the pipe group, and the rank's rows into `M` microbatches, which flow
stage to stage on a static schedule of `M + S - 1` ticks: at tick `t`
stage `s` runs microbatch `t - s`.  The largest prefix of the run that `S`
divides is pipelined, `n // S` blocks a stage; the rest runs in sequence
afterwards, on every rank (JAX `pipeline.py:98-104, 167-168`).

The schedule is one autograd Function (`_GPipe`) that takes the stage's
parameters as inputs, so DDP's and FSDP's hooks see their gradients:

* forward: each tick, one `collectives.stage_hop` (the previous tick's
  output to the next stage, this tick's input from the previous one),
  then the stage's blocks on the microbatch without recording a graph; a
  stage keeps only its input of each microbatch;
* backward: the reverse schedule, each stage recomputing its blocks from
  the kept input and differentiating them (JAX's `jax.checkpoint(
  stage_apply)`, `pipeline.py:148`), the input gradients hopping back a
  stage a tick; then every stage's parameter gradients gathered over the
  pipe group, so each rank holds the whole gradient of every pipelined
  block (JAX's transpose of its `pipe`-sharded stacked parameters).

Around it, `collectives.to_stages` and `collectives.from_last_stage` (the
transposes of JAX's replicated `x` and of its `psum`, `pipeline.py:162`):
the segment's output is the last stage's, broadcast; its cotangent is the
same on every stage and only the last stage reads it; the input's
gradient, which only the first stage computes, is summed over the group.

Kept differences from JAX: the stage weights stay whole on every rank
(JAX stacks and shards them over `pipe` inside the step; the port's
parameters and moments are replicated, as JAX's `param_shardings` leaves
them), and a stage idle at a tick computes nothing (JAX computes garbage
ticks to keep shapes static); the pairs of sends and receives match tick
by tick all the same.  Each stage's microbatch matmuls round as the
whole batch's do not, so a pipelined step equals the sequential one to
rounding.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from .collectives import from_last_stage, stage_hop, to_stages


def context_pipe_size(axes) -> int:
    """The pipe extent of `axes` (a `mesh.Axes`), or 0 without a pipe axis:
    the counterpart of JAX's trace-time context mesh."""
    return axes.pipe_size if axes is not None and axes.pp else 0


def pick_microbatches(rows: int, stages: int, microbatches: int = 0) -> int:
    """The GPipe microbatch count of `rows` rows on `stages` stages:
    `microbatches` when given, else the largest M <= 4 S that divides the
    rows (JAX `pipeline.py:106-111`).  Raises ValueError when the rows do
    not split into M microbatches."""
    if microbatches:
        M = int(microbatches)
    else:
        M = max(m for m in range(1, min(4 * stages, max(rows, 1)) + 1)
                if rows % m == 0)
    if M <= 0 or rows % M:
        raise ValueError(
            f"pipeline_parallel: {rows} rows do not split into {M} "
            f"microbatches; pick batch/microbatch counts so the rows a "
            f"rank holds divide evenly")
    return M


@dataclass
class _Plan:
    """One pipelined segment: its blocks (all stages'), the stage's share
    of them, the block function and the pipe group's geometry."""
    blocks: List[nn.Module]
    apply_one: Callable
    per_stage: int
    stages: int
    stage: int
    microbatches: int
    group: object
    params: List[List[nn.Parameter]]      # each block's parameters

    def own(self, stage: Optional[int] = None) -> range:
        s = self.stage if stage is None else stage
        return range(s * self.per_stage, (s + 1) * self.per_stage)

    def run(self, h: torch.Tensor) -> torch.Tensor:
        for i in self.own():
            h = self.apply_one(self.blocks[i], h)
        return h

    def trainable(self, stage: int) -> List[nn.Parameter]:
        return [p for i in self.own(stage) for p in self.params[i]
                if p.requires_grad]


def _active(t: int, stage: int, M: int) -> bool:
    return 0 <= t - stage < M


class _GPipe(torch.autograd.Function):
    """The schedule of one segment (module docstring).  Inputs: the plan,
    the replicated stream x, then every block's parameters in block
    order.  Output: the last stage's result; zeros on the other stages."""

    @staticmethod
    def forward(ctx, plan: _Plan, x: torch.Tensor, *params):
        S, s, M = plan.stages, plan.stage, plan.microbatches
        xs = x.contiguous().chunk(M)
        kept, outs, prev = [], [], None
        for t in range(M + S - 1):
            send = prev if s < S - 1 and _active(t - 1, s, M) else None
            want = s > 0 and _active(t, s, M)
            got = stage_hop(send, s + 1, xs[0] if want else None, s - 1,
                            plan.group)
            prev = None
            if _active(t, s, M):
                h = xs[t - s] if s == 0 else got
                kept.append(h)
                prev = plan.run(h)
                if s == S - 1:
                    outs.append(prev)
        ctx.plan, ctx.kept = plan, kept
        return torch.cat(outs) if s == S - 1 else torch.zeros_like(x)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        plan, kept = ctx.plan, ctx.kept
        S, s, M = plan.stages, plan.stage, plan.microbatches
        if any(a is not b for i in plan.own() for a, b in zip(
                plan.blocks[i].parameters(), plan.params[i])):
            raise RuntimeError("a pipelined block's parameters changed "
                               "between the forward and the backward")
        own = plan.trainable(s)
        sums: List[Optional[torch.Tensor]] = [None] * len(own)
        dys = dy.contiguous().chunk(M)
        dxs, prev = [], None
        for t in reversed(range(M + S - 1)):
            send = prev if s > 0 and _active(t + 1, s, M) else None
            want = s < S - 1 and _active(t, s, M)
            got = stage_hop(send, s - 1, dys[0] if want else None, s + 1,
                            plan.group)
            prev = None
            if _active(t, s, M):
                m = t - s
                g = dys[m] if s == S - 1 else got
                h = kept[m].detach().requires_grad_(True)
                with torch.enable_grad():
                    y = plan.run(h)
                grads = torch.autograd.grad(y, [h] + own, g,
                                            allow_unused=True)
                prev = grads[0]
                for j, gp in enumerate(grads[1:]):
                    if gp is not None:
                        sums[j] = gp if sums[j] is None else sums[j] + gp
                if s == 0:
                    dxs.append(prev)
        ctx.plan = ctx.kept = None
        dx = (torch.cat(dxs[::-1]) if s == 0
              else torch.zeros_like(dy))
        whole = _gather_stage_grads(plan, sums)
        return (None, dx, *(whole.get(id(p)) for ps in plan.params
                            for p in ps))


def _gather_stage_grads(plan: _Plan, sums: List[Optional[torch.Tensor]]):
    """{id(param): whole gradient} of every stage's trainable parameters:
    each stage's gradients flattened, padded to the largest stage's size
    and all-gathered over the pipe group (the blocks' parameters share one
    dtype, fp32)."""
    stages = [plan.trainable(j) for j in range(plan.stages)]
    sizes = [sum(p.numel() for p in ps) for ps in stages]
    width = max(sizes)
    if width == 0:
        return {}
    like = next(p for ps in stages for p in ps)
    flat = like.new_zeros(width)
    own = stages[plan.stage]
    if own:
        flat[:sizes[plan.stage]] = torch.cat([
            (g if g is not None else torch.zeros_like(p)).reshape(-1)
            for g, p in zip(sums, own)])
    gathered = like.new_empty(plan.stages * width)
    dist.all_gather_into_tensor(gathered, flat, group=plan.group)
    out = {}
    for j, ps in enumerate(stages):
        parts = gathered[j * width:j * width + sizes[j]].split(
            [p.numel() for p in ps])
        out.update((id(p), g.view_as(p)) for p, g in zip(ps, parts))
    return out


def pipeline_blocks(blocks: Sequence[nn.Module], apply_one: Callable,
                    x: torch.Tensor, microbatches: int = 0, axes=None,
                    apply_rest: Optional[Callable] = None) -> torch.Tensor:
    """Run `x` through a homogeneous block stack on the GPipe schedule of
    `axes`' pipe group (JAX `pipeline_blocks`, `pipeline.py:80-169`).

    blocks: the run's blocks (the same structure each).  The largest
      prefix that the pipe extent S divides is pipelined, `len(blocks) //
      S` blocks a stage; the remainder runs in sequence afterwards.
    apply_one(block, h) -> h: one block.
    x: `[rows, ...]`, the same on every rank of the pipe group (this
      rank's rows of the global batch).
    microbatches: M; 0 picks the largest M <= 4 S that divides the rows
      (`pick_microbatches`); rows that do not split raise ValueError.
    apply_rest(block, h) -> h: the remainder's block function (default
      `apply_one`; the towers recompute it under `remat`).
    """
    S = context_pipe_size(axes)
    if S == 0:
        raise RuntimeError("pipeline_blocks needs the axes of a (data, pipe) "
                           "mesh")
    blocks = list(blocks)
    lps = len(blocks) // S
    head, tail = blocks[:lps * S], blocks[lps * S:]
    if lps:
        M = pick_microbatches(x.shape[0], S, microbatches)
        params = [list(b.parameters()) for b in head]
        plan = _Plan(head, apply_one, lps, S, axes.stage, M,
                     axes.pipe_group, params)
        x = to_stages(x, axes.pipe_group)
        x = _GPipe.apply(plan, x, *[p for ps in params for p in ps])
        x = from_last_stage(x, axes.pipe_group)
    for block in tail:
        x = (apply_rest or apply_one)(block, x)
    return x
