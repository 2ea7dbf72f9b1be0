# coding=utf-8
"""LayerNorm with fp32 statistics: Triton kernels for the forward and the
backward, their plain versions, and the autograd Function that joins them.

Replaces the TPU kernels of `centerclip_tpu/ops/layernorm_pallas.py`: the
forward `_ln_fwd_kernel` / `_ln_fwd_call` (entry `fused_layernorm`) and the
backward `_ln_bwd_kernel` / `_ln_bwd_call` (its custom VJP).  LayerNorm is
over the last axis with fp32 mean and variance, fp32 gamma/beta, eps 1e-5,
output in the input's dtype.

* Forward: one Triton program normalises one row, with `BLOCK_D` the next
  power of two above D (1024 for 768, 512 for 512).
* Backward: each program takes a block of rows, recomputes mean and rstd in
  fp32, writes dx in x's dtype and its fp32 partial sums of dy * x_hat and
  dy to a `[n_blocks, D]` scratch buffer; a second small program reduces
  the partials over the blocks into dgamma and dbeta.  Deterministic, no
  atomics: the TPU kernel's accumulator across a sequential grid has no
  counterpart on a card whose blocks run in parallel.

Both are a few flops per element, so they are bound by reading x (and dy)
and writing y (or dx) once; each makes a single pass over device memory.

`layer_norm` is differentiable through `_LayerNorm`: kernel C forward,
kernel D backward.  For CPU tensors both sides take their plain versions; a
CUDA tensor launches the kernels or raises.  `layer_norm.launches` and
`layer_norm_backward.launches` count launches.  Triton is imported when a
kernel is first launched, never at import.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

EPS = 1e-5
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# backward: about this many row blocks, each written as one partial row
_BWD_PROGRAMS = 1024


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """fp32 two-pass LayerNorm over the last axis, cast back to x's dtype
    (the arithmetic of `_ln_fwd_kernel`, layernorm_pallas.py:42-49)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(x.dtype)


def layer_norm_bwd_plain(x: torch.Tensor, weight: torch.Tensor,
                         dy: torch.Tensor, eps: float = EPS
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward (the arithmetic of `_ln_bwd_kernel`,
    layernorm_pallas.py:52-72), all in fp32:
    dx = rstd * (dy*g - mean(dy*g) - x_hat * mean(dy*g*x_hat)) in x's dtype,
    dgamma = sum over rows of dy * x_hat, dbeta = sum over rows of dy."""
    D = x.shape[-1]
    xf = x.float().reshape(-1, D)
    dyf = dy.float().reshape(-1, D)
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = xc * rstd
    dyg = dyf * weight.float()
    m1 = dyg.mean(dim=-1, keepdim=True)
    m2 = (dyg * xhat).mean(dim=-1, keepdim=True)
    dx = rstd * (dyg - m1 - xhat * m2)
    return (dx.reshape(x.shape).to(x.dtype), (dyf * xhat).sum(dim=0),
            dyf.sum(dim=0))


@functools.lru_cache(maxsize=None)
def _kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def _ln_fwd(X, W, B, Y, D, eps, BLOCK_D: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_D)
        valid = cols < D
        x = tl.load(X + row * D + cols, mask=valid, other=0.0).to(tl.float32)
        mean = tl.sum(x, axis=0) / D
        xc = tl.where(valid, x - mean, 0.0)
        var = tl.sum(xc * xc, axis=0) / D
        rstd = 1.0 / tl.sqrt(var + eps)
        w = tl.load(W + cols, mask=valid, other=0.0)
        b = tl.load(B + cols, mask=valid, other=0.0)
        y = xc * rstd * w + b
        tl.store(Y + row * D + cols, y.to(Y.dtype.element_ty), mask=valid)

    @triton.jit
    def _ln_bwd(X, W, DY, DX, PW, PB, R, D, rows_per_block, eps,
                BLOCK_D: tl.constexpr):
        blk = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_D)
        valid = cols < D
        w = tl.load(W + cols, mask=valid, other=0.0)
        acc_w = tl.zeros([BLOCK_D], dtype=tl.float32)
        acc_b = tl.zeros([BLOCK_D], dtype=tl.float32)
        for r in range(0, rows_per_block):
            row = blk * rows_per_block + r
            ok = valid & (row < R)
            # rows past R load zeros: dy = 0 adds nothing to the sums
            x = tl.load(X + row * D + cols, mask=ok, other=0.0).to(tl.float32)
            dy = tl.load(DY + row * D + cols, mask=ok, other=0.0).to(tl.float32)
            mean = tl.sum(x, axis=0) / D
            xc = tl.where(valid, x - mean, 0.0)
            var = tl.sum(xc * xc, axis=0) / D
            rstd = 1.0 / tl.sqrt(var + eps)
            xhat = xc * rstd
            dyg = dy * w
            m1 = tl.sum(dyg, axis=0) / D
            m2 = tl.sum(dyg * xhat, axis=0) / D
            dx = rstd * (dyg - m1 - xhat * m2)
            tl.store(DX + row * D + cols, dx.to(DX.dtype.element_ty), mask=ok)
            acc_w += dy * xhat
            acc_b += dy
        tl.store(PW + blk * D + cols, acc_w, mask=valid)
        tl.store(PB + blk * D + cols, acc_b, mask=valid)

    @triton.jit
    def _ln_bwd_reduce(PW, PB, DW, DB, NB, D, BLOCK_N: tl.constexpr,
                       BLOCK_C: tl.constexpr):
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        cvalid = cols < D
        acc_w = tl.zeros([BLOCK_N, BLOCK_C], dtype=tl.float32)
        acc_b = tl.zeros([BLOCK_N, BLOCK_C], dtype=tl.float32)
        for n0 in range(0, NB, BLOCK_N):
            rows = n0 + tl.arange(0, BLOCK_N)
            ok = (rows[:, None] < NB) & cvalid[None, :]
            offs = rows[:, None] * D + cols[None, :]
            acc_w += tl.load(PW + offs, mask=ok, other=0.0)
            acc_b += tl.load(PB + offs, mask=ok, other=0.0)
        tl.store(DW + cols, tl.sum(acc_w, axis=0), mask=cvalid)
        tl.store(DB + cols, tl.sum(acc_b, axis=0), mask=cvalid)

    return triton, _ln_fwd, _ln_bwd, _ln_bwd_reduce


def _check_cuda(x: torch.Tensor, params) -> int:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    D = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    for name, t in params:
        if t.dtype != torch.float32 or t.device != x.device \
                or tuple(t.shape) != (D,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous fp32 [{D}] tensor "
                             f"on {x.device}")
    return D


def _forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             eps: float) -> torch.Tensor:
    """Kernel C on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps)
    D = _check_cuda(x, (("weight", weight), ("bias", bias)))
    y = torch.empty_like(x)
    R = x.numel() // D if D else 0
    if R == 0:
        return y
    triton, kernel, _, _ = _kernels()
    block = triton.next_power_of_2(D)
    with torch.cuda.device(x.device):
        kernel[(R,)](x, weight, bias, y, D, eps, BLOCK_D=block,
                     num_warps=4 if block <= 1024 else 8)
    layer_norm.launches += 1
    return y


def layer_norm_backward(x: torch.Tensor, weight: torch.Tensor,
                        dy: torch.Tensor, eps: float = EPS
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx in x's dtype and shape, dgamma [D] fp32, dbeta [D] fp32) for the
    output gradient `dy` (x's dtype and shape).  Kernel D on CUDA tensors,
    `layer_norm_bwd_plain` on CPU tensors."""
    if x.device.type == "cpu":
        return layer_norm_bwd_plain(x, weight, dy, eps)
    D = _check_cuda(x, (("weight", weight),))
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous():
        raise ValueError(f"dy must be a contiguous {x.dtype} "
                         f"{tuple(x.shape)} tensor on {x.device}")
    dx = torch.empty_like(x)
    R = x.numel() // D if D else 0
    if R == 0:
        zeros = torch.zeros(D, dtype=torch.float32, device=x.device)
        return dx, zeros, zeros.clone()
    rows_per_block = -(-R // _BWD_PROGRAMS)
    n_blocks = -(-R // rows_per_block)
    partial = torch.empty((2, n_blocks, D), dtype=torch.float32,
                          device=x.device)
    dwb = torch.empty((2, D), dtype=torch.float32, device=x.device)
    triton, _, bwd, reduce = _kernels()
    block = triton.next_power_of_2(D)
    block_c = 64
    with torch.cuda.device(x.device):
        bwd[(n_blocks,)](x, weight, dy, dx, partial[0], partial[1], R, D,
                         rows_per_block, eps, BLOCK_D=block,
                         num_warps=4 if block <= 1024 else 8)
        reduce[(triton.cdiv(D, block_c),)](partial[0], partial[1], dwb[0],
                                           dwb[1], n_blocks, D, BLOCK_N=32,
                                           BLOCK_C=block_c, num_warps=4)
    layer_norm_backward.launches += 1
    return dx, dwb[0], dwb[1]


class _LayerNorm(torch.autograd.Function):
    """Kernel C forward, kernel D backward (plain versions on the CPU).
    Saves x and gamma: the backward recomputes the statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, weight)
        return _forward(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw, db = layer_norm_backward(x, weight, dy.contiguous(), ctx.eps)
        return dx, dw, db, None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = EPS) -> torch.Tensor:
    """LayerNorm over the last axis of a contiguous x of any rank; weight
    and bias are fp32 [D]; the output has x's dtype and shape.
    Differentiable in x, weight and bias."""
    return _LayerNorm.apply(x, weight, bias, eps)


layer_norm.launches = 0
layer_norm_backward.launches = 0
