# coding=utf-8
"""LayerNorm with fp32 statistics: a CUDA C++ kernel for the forward, a
Triton kernel for the backward, their plain versions, and the autograd
Function that joins them.

Replaces the TPU kernels of `centerclip_tpu/ops/layernorm_pallas.py`: the
forward `_ln_fwd_kernel` / `_ln_fwd_call` (entry `fused_layernorm`) and the
backward `_ln_bwd_kernel` / `_ln_bwd_call` (its custom VJP).  LayerNorm is
over the last axis with fp32 mean and variance, fp32 gamma/beta, eps 1e-5,
output in the input's dtype.

* Forward (kernel C), `csrc/layernorm.cu`, built by `ops/_build.py` and
  called through ctypes: a warp normalises a row from registers (warp
  shuffles, no shared memory, no block barrier), 16 bytes a lane per load
  and store for rows of a whole number of 512-byte pieces (`fwd_vecs`: D =
  512 or 768 in bf16 or fp32; a scalar path for any other width or
  alignment), gamma and beta held in registers across the rows a warp
  strides over; `fwd_launch_plan` sizes the grid from R and the SM count.
* Backward (kernel D), one launch: a persistent grid of
  `bwd_launch_plan(...)` programs, as many per SM as fit, each walking a
  contiguous range of rows in `[ROWS, BLOCK_D]` tiles, software-pipelined
  so that the next tiles' loads are in flight while this one is reduced.
  Per row it recomputes mean and rstd in fp32 and writes dx in x's dtype;
  the fp32 sums of dy * x_hat and dy stay in registers across its rows and
  are written once, as one partial row per program.  The partials are
  reduced inside the same launch by tickets: the last program of each
  group of `_BWD_GROUP` to finish (an int32 `atomic_add`, acq_rel) sums its
  group's partial rows in program order, and the last group to finish sums
  the group rows into dgamma and dbeta, again in order.  No float atomics
  and no autotuning: the plan is a fixed function of (R, D, dtype) and the
  card's SM count, so two calls on the same inputs return the same bits.
  The ticket counters live in one int32 buffer per device, zero between
  calls (the last taker of each resets it), which assumes that calls on
  one device run on one stream at a time.  The TPU kernel's accumulator
  across a sequential grid has no counterpart on a card whose programs run
  in parallel; the tickets are its replacement.

Both are a few flops per element, so they are bound by reading x (and dy)
and writing y (or dx) once; each makes a single pass over device memory.

`layer_norm` is differentiable through `_LayerNorm`: kernel C forward,
kernel D backward.  For CPU tensors both sides take their plain versions; a
CUDA tensor launches the kernels or raises.  `layer_norm.launches` and
`layer_norm_backward.launches` count launches.  Triton is imported when the
backward kernel is first launched, never at import.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch

from . import _build

EPS = 1e-5
# the kernels' dtypes, with the forward's codes (csrc/layernorm.cu)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_DTYPES = tuple(_DTYPE_CODES)
# forward plan: CTAs of _FWD_WARPS warps (csrc/layernorm.cu kWarps), a warp
# a row; the vector path holds at most _FWD_MAX_VECS 16-byte vectors a lane
_FWD_WARPS = 4
_FWD_MAX_VECS = 8
# backward plan: a warp spans 32 16-byte loads along a row, a program has
# at most _BWD_MAX_WARPS warps and a [ROWS, BLOCK_D] tile of about
# _BWD_THREAD_ELEMS elements per thread (ROWS at most _BWD_MAX_ROWS), an SM
# runs as many programs as about _BWD_SM_WARPS resident warps make, the
# loop over tiles keeps _BWD_STAGES tiles' loads in flight, and one ticket
# group sums the partial rows of _BWD_GROUP programs
_BWD_THREAD_ELEMS = 32
_BWD_MAX_ROWS = 16
_BWD_MAX_WARPS = 8
_BWD_SM_WARPS = 12
_BWD_STAGES = 3
_BWD_GROUP = 16


class BwdPlan(NamedTuple):
    """How the backward kernel cuts R rows of width D: `programs` programs,
    program p taking rows [p * rows_per_program, (p + 1) * rows_per_program)
    (the last one fewer) in tiles of `rows`; ticket groups of `group`
    programs, `groups` of them; tile width `block_d` and `num_warps`."""
    programs: int
    rows: int
    rows_per_program: int
    group: int
    groups: int
    block_d: int
    num_warps: int


class FwdPlan(NamedTuple):
    """How the forward kernel cuts R rows: `ctas` CTAs of _FWD_WARPS warps,
    warp w of the W = ctas * _FWD_WARPS taking rows w, w + W, ...; `vecs`
    16-byte vectors a lane on the vector path, 0 for the scalar path."""
    ctas: int
    vecs: int


def fwd_vecs(D: int, elem_bytes: int, aligned: bool = True) -> int:
    """16-byte vectors a lane for rows of width D (`elem_bytes` an
    element) on the vector path, where a row is a whole number of 512-byte
    warp-wide pieces, at most _FWD_MAX_VECS (D = 768 or 512 in bf16 or
    fp32); 0, the scalar path, for any other width or a pointer that is
    not 16-byte aligned."""
    vecs, rest = divmod(D * elem_bytes, 512)
    return vecs if aligned and not rest and vecs <= _FWD_MAX_VECS else 0


def fwd_launch_plan(R: int, D: int, elem_bytes: int, n_sm: int,
                    ctas_per_sm: int, aligned: bool = True) -> FwdPlan:
    """The forward kernel's grid for R >= 1 rows: a warp a row while R is
    small (the rows spread over the card), at most the `ctas_per_sm` CTAs
    an SM holds at once on each of `n_sm` SMs (each warp then streams its
    rows)."""
    ctas = max(1, min(-(-R // _FWD_WARPS), n_sm * max(1, ctas_per_sm)))
    return FwdPlan(ctas=ctas, vecs=fwd_vecs(D, elem_bytes, aligned))


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def bwd_launch_plan(R: int, D: int, n_sm: int, elem_bytes: int = 2
                    ) -> BwdPlan:
    """The backward kernel's grid for R >= 1 rows of width D, `elem_bytes`
    bytes an element, on a card of `n_sm` SMs: a fixed function of these,
    so the order of every sum is too.  The programs are at most
    `n_sm * (_BWD_SM_WARPS // num_warps)`, each with the same whole number
    of tiles (the last possibly fewer rows), none idle."""
    block_d = _next_pow2(D)
    num_warps = max(1, min(_BWD_MAX_WARPS, block_d * elem_bytes // 512))
    rows = max(1, min(_BWD_MAX_ROWS,
                      _BWD_THREAD_ELEMS * 32 * num_warps // block_d))
    tiles = -(-R // rows)
    cap = n_sm * max(1, _BWD_SM_WARPS // num_warps)
    tiles_per_program = -(-tiles // min(tiles, cap))
    programs = -(-tiles // tiles_per_program)
    return BwdPlan(programs=programs, rows=rows,
                   rows_per_program=tiles_per_program * rows,
                   group=_BWD_GROUP, groups=-(-programs // _BWD_GROUP),
                   block_d=block_d, num_warps=num_warps)


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
    def _add2(a0, a1, b0, b1):
        return a0 + b0, a1 + b1

    @triton.jit
    def _sum_rows(SRC, first, count, half, D, cols, valid,
                  BLOCK_P: tl.constexpr, BLOCK_D: tl.constexpr):
        """Rows first .. first + count - 1 of the two row-major fp32
        [half, D] arrays at SRC and SRC + half * D, each summed in a fixed
        order (BLOCK_P rows of each loaded at once).  `.cg` reads from L2:
        the rows were written by other programs of this launch."""
        acc_w = tl.zeros([BLOCK_D], dtype=tl.float32)
        acc_b = tl.zeros([BLOCK_D], dtype=tl.float32)
        for i in range(0, count, BLOCK_P):
            k = i + tl.arange(0, BLOCK_P)
            ok = (k < count)[:, None] & valid[None, :]
            offs = (first + k).to(tl.int64)[:, None] * D + cols[None, :]
            acc_w += tl.sum(tl.load(SRC + offs, mask=ok, other=0.0,
                                    cache_modifier=".cg"), axis=0)
            acc_b += tl.sum(tl.load(SRC + half * D + offs, mask=ok,
                                    other=0.0, cache_modifier=".cg"), axis=0)
        return acc_w, acc_b

    @triton.jit
    def _ln_bwd(X, W, DY, DX, PART, GPART, DWB, TICKETS, R, D,
                rows_per_program, P, groups, eps, ROWS: tl.constexpr,
                BLOCK_D: tl.constexpr, GROUP: tl.constexpr,
                STAGES: tl.constexpr, SUM_ROWS: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK_D)
        valid = cols < D
        w = tl.load(W + cols, mask=valid, other=0.0)
        first = pid.to(tl.int64) * rows_per_program
        end = tl.minimum(first + rows_per_program, R)
        acc_w = tl.zeros([BLOCK_D], dtype=tl.float32)
        acc_b = tl.zeros([BLOCK_D], dtype=tl.float32)
        for r0 in tl.range(0, rows_per_program, ROWS, num_stages=STAGES):
            rows = first + r0 + tl.arange(0, ROWS)
            ok = (rows < end)[:, None] & valid[None, :]
            offs = rows[:, None] * D + cols[None, :]
            # rows past the range load zeros: dy = 0 adds nothing to the sums
            x = tl.load(X + offs, mask=ok, other=0.0).to(tl.float32)
            dy = tl.load(DY + offs, mask=ok, other=0.0).to(tl.float32)
            mean = tl.sum(x, axis=1) / D
            xc = tl.where(valid[None, :], x - mean[:, None], 0.0)
            var = tl.sum(xc * xc, axis=1) / D
            rstd = 1.0 / tl.sqrt(var + eps)
            xhat = xc * rstd[:, None]
            dyg = dy * w[None, :]
            # both row sums of the gradient in one reduction
            s1, s2 = tl.reduce((dyg, dyg * xhat), 1, _add2)
            m1 = s1 / D
            m2 = s2 / D
            dx = rstd[:, None] * (dyg - m1[:, None] - xhat * m2[:, None])
            tl.store(DX + offs, dx.to(DX.dtype.element_ty), mask=ok)
            acc_w += tl.sum(dy * xhat, axis=0)
            acc_b += tl.sum(dy, axis=0)
        tl.store(PART + pid * D + cols, acc_w, mask=valid)
        tl.store(PART + (P + pid) * D + cols, acc_b, mask=valid)
        # every thread's partial stores before the ticket's release
        tl.debug_barrier()
        grp = pid // GROUP
        g0 = grp * GROUP
        gsize = tl.minimum(P - g0, GROUP)
        ticket = tl.atomic_add(TICKETS + grp, 1, sem="acq_rel")
        if ticket == gsize - 1:
            # the group's last program: every partial row of it is written
            tl.store(TICKETS + grp, 0)
            gw, gb = _sum_rows(PART, g0, gsize, P, D, cols, valid, SUM_ROWS,
                               BLOCK_D)
            tl.store(GPART + grp * D + cols, gw, mask=valid)
            tl.store(GPART + (groups + grp) * D + cols, gb, mask=valid)
            tl.debug_barrier()
            last = tl.atomic_add(TICKETS + groups, 1, sem="acq_rel")
            if last == groups - 1:
                tl.store(TICKETS + groups, 0)
                dw, db = _sum_rows(GPART, 0, groups, groups, D, cols, valid,
                                   SUM_ROWS, BLOCK_D)
                tl.store(DWB + cols, dw, mask=valid)
                tl.store(DWB + D + cols, db, mask=valid)

    return _ln_bwd


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


def _on(device: torch.device):
    """The device guard a launch on `device` needs: none when it is the
    current device already (the common case, and the cheap one)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


@functools.lru_cache(maxsize=None)
def _fwd_entry():
    lib = _build.load("layernorm")
    fn = lib.cc_layernorm_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
        + [ctypes.c_float, ctypes.c_void_p]
    return lib, fn


@functools.lru_cache(maxsize=None)
def _fwd_ctas_per_sm(device: torch.device, code: int, vecs: int) -> int:
    """The CTAs an SM holds of the forward kernel for dtype `code` and
    `vecs` (the CUDA occupancy query), memoised: the host path of a call
    is part of what kernel C costs."""
    lib, _ = _fwd_entry()
    fn = lib.cc_layernorm_fwd_ctas_per_sm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    with torch.cuda.device(device):
        n = fn(code, vecs)
    if n < 1:
        raise RuntimeError(f"the LayerNorm forward kernel (dtype code {code},"
                           f" {vecs} vectors a lane) fits no CTA on an SM")
    return n


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
    lib, fn = _fwd_entry()
    code = _DTYPE_CODES[x.dtype]
    ptrs = (x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr())
    aligned = not (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3]) & 15
    vecs = fwd_vecs(D, x.element_size(), aligned)
    plan = fwd_launch_plan(R, D, x.element_size(), _sm_count(x.device),
                           _fwd_ctas_per_sm(x.device, code, vecs), aligned)
    with _on(x.device):
        err = fn(*ptrs, R, D, code, plan.vecs, plan.ctas, eps,
                 torch._C._cuda_getCurrentRawStream(x.device.index))
    _build.check(lib, err, "LayerNorm forward kernel")
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
    plan = bwd_launch_plan(R, D, _sm_count(x.device), x.element_size())
    partial = torch.empty((2, plan.programs, D), dtype=torch.float32,
                          device=x.device)
    group_partial = torch.empty((2, plan.groups, D), dtype=torch.float32,
                                device=x.device)
    dwb = torch.empty((2, D), dtype=torch.float32, device=x.device)
    bwd = _kernels()
    with torch.cuda.device(x.device):
        bwd[(plan.programs,)](
            x, weight, dy, dx, partial, group_partial, dwb,
            _tickets(x.device, plan.groups + 1), R, D, plan.rows_per_program,
            plan.programs, plan.groups, eps, ROWS=plan.rows,
            BLOCK_D=plan.block_d, GROUP=plan.group, STAGES=_BWD_STAGES,
            SUM_ROWS=2 * plan.rows, num_warps=plan.num_warps)
    layer_norm_backward.launches += 1
    return dx, dwb[0], dwb[1]


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_ticket_buffers: Dict[torch.device, torch.Tensor] = {}


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """The backward's int32 ticket counters on `device`, all zero between
    calls; made (zeroed) at first use, larger when a plan needs more."""
    buf = _ticket_buffers.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _ticket_buffers[device] = buf
    return buf


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
    Differentiable in x, weight and bias; where no gradient can flow (no
    grad mode, or no input that requires one: serving, encoding) the
    forward runs without the autograd Function and its host cost."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _LayerNorm.apply(x, weight, bias, eps)
    return _forward(x, weight, bias, eps)


layer_norm.launches = 0
layer_norm_backward.launches = 0
