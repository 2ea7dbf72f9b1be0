# coding=utf-8
"""QuickGELU, y = x * sigmoid(1.702 x): one hand-written CUDA kernel each
way (kernel F), its plain version, and the autograd Function that joins
them.

F replaces no TPU kernel: the JAX package leaves `quick_gelu`
(`centerclip_tpu/models/layers.py:22`) to XLA's fusion.  In eager PyTorch
the function is three kernels forward and five backward over the MLP's
`[rows, 4 * width]` activation, and autograd keeps x and sigmoid's output
for the backward.  Kernel F (`csrc/quick_gelu.cu`, built by `ops/_build.py`
and called through ctypes) reads x and writes y in one pass, and in the
backward reads x and dy and writes dx in one pass, recomputing the
sigmoid; `_QuickGelu` saves x alone.  It is bound by bytes: 2 tensor-sizes
forward, 3 backward.  Every step rounds as the eager op does, so its
output and gradient are the eager composition's bits on the card in bf16,
fp16 and fp32 (the source's header lists the steps).

The kernel adapts to what it is given: its dtype, a view that is not
16-byte aligned (an element at a time), a count that is not a whole number
of 16-byte vectors (the tail an element a thread).  `quick_gelu_op` takes
the plain version on a CPU tensor; on a CUDA tensor it launches F or
raises.  `quick_gelu_forward.launches` and `quick_gelu_backward.launches`
count F's launches, as `layer_norm.launches` does C's.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .layernorm_triton import _on, _sm_count

# the kernels' dtypes, with their codes (csrc/quick_gelu.cu)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def quick_gelu_plain(x: torch.Tensor) -> torch.Tensor:
    """The eager composition (reference: clip.py's QuickGELU)."""
    return x * torch.sigmoid(1.702 * x)


def quick_gelu_bwd_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The gradient of `quick_gelu_plain` at x for the output gradient dy,
    by the ops autograd runs for it: the product's two gradients, sigmoid's
    backward, the scale, and their sum."""
    s = torch.sigmoid(1.702 * x)
    return dy * s + torch.ops.aten.sigmoid_backward(dy * x, s) * 1.702


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _build.load("quick_gelu")
    fwd, bwd = lib.cc_quick_gelu_fwd, lib.cc_quick_gelu_bwd
    fwd.restype = bwd.restype = ctypes.c_int
    fwd.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64] \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.cc_quick_gelu_threads.restype = ctypes.c_int
    return lib, fwd, bwd, lib.cc_quick_gelu_threads()


@functools.lru_cache(maxsize=None)
def _resident(device: torch.device, code: int, backward: bool,
              vector: bool) -> int:
    """The CTAs of one of F's kernels the card holds at once: its SMs times
    the CTAs an SM holds (the CUDA occupancy query), memoised: the host
    path of a call is part of what F costs."""
    lib = _entry()[0]
    fn = lib.cc_quick_gelu_ctas_per_sm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3
    with torch.cuda.device(device):
        n = fn(code, int(backward), int(vector))
    if n < 1:
        raise RuntimeError(f"the QuickGELU kernel (dtype code {code}, "
                           f"backward {backward}) fits no CTA on an SM")
    return _sm_count(device) * n


def launch_plan(n: int, elem_bytes: int, vector: bool, threads: int,
                resident: int) -> int:
    """F's grid for n >= 1 elements: a thread per 16-byte vector (per
    element on the scalar path) while that is fewer CTAs than the
    `resident` the card holds at once, else those, each thread then
    striding."""
    items = max(1, n // (16 // elem_bytes)) if vector else n
    return max(1, min(-(-items // threads), resident))


def _check_cuda(x: torch.Tensor, what: str = "x") -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _launch(backward: bool, tensors) -> None:
    """F forward (x, y) or backward (x, dy, dx) on contiguous CUDA tensors
    of one dtype and size."""
    lib, fwd, bwd, threads = _entry()
    x = tensors[0]
    code = _DTYPE_CODES[x.dtype]
    ptrs = [t.data_ptr() for t in tensors]
    vector = not (ptrs[0] | ptrs[1] | ptrs[-1]) & 15     # every pointer
    device = x.device
    ctas = launch_plan(x.numel(), x.element_size(), vector, threads,
                       _resident(device, code, backward, vector))
    with _on(device):
        err = (bwd if backward else fwd)(
            *ptrs, x.numel(), code, int(vector), ctas,
            torch._C._cuda_getCurrentRawStream(device.index))
    _build.check(lib, err, "QuickGELU " + ("backward" if backward
                                           else "forward") + " kernel")


def quick_gelu_forward(x: torch.Tensor) -> torch.Tensor:
    """Kernel F's forward on a CUDA tensor, the plain version on a CPU
    tensor."""
    if x.device.type == "cpu":
        return quick_gelu_plain(x)
    _check_cuda(x)
    y = torch.empty_like(x)
    if x.numel():
        _launch(False, (x, y))
        quick_gelu_forward.launches += 1
    return y


def quick_gelu_backward(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dx for the output gradient dy (x's dtype and shape): kernel F's
    backward on CUDA tensors, `quick_gelu_bwd_plain` on CPU tensors."""
    if x.device.type == "cpu":
        return quick_gelu_bwd_plain(x, dy)
    _check_cuda(x)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must be a {x.dtype} {tuple(x.shape)} tensor "
                         f"on {x.device}")
    _check_cuda(dy, "dy")
    dx = torch.empty_like(x)
    if x.numel():
        _launch(True, (x, dy, dx))
        quick_gelu_backward.launches += 1
    return dx


class _QuickGelu(torch.autograd.Function):
    """Kernel F both ways (plain versions on the CPU).  Saves x alone: the
    backward recomputes the sigmoid."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return quick_gelu_forward(x)

    @staticmethod
    def backward(ctx, dy):
        x, = ctx.saved_tensors
        return quick_gelu_backward(x, dy.contiguous())


def quick_gelu_op(x: torch.Tensor) -> torch.Tensor:
    """QuickGELU of x, differentiable in x; where no gradient can flow (no
    grad mode, or an x that needs none: serving, encoding, evaluation) the
    forward runs without the autograd Function and saves nothing."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _QuickGelu.apply(x)
    return quick_gelu_forward(x)


quick_gelu_forward.launches = 0
quick_gelu_backward.launches = 0
