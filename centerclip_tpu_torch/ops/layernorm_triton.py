# coding=utf-8
"""LayerNorm forward with fp32 statistics: a Triton kernel and its plain
version.

Replaces the TPU kernel `centerclip_tpu/ops/layernorm_pallas.py`
(`_ln_fwd_kernel` / `_ln_fwd_call`, entry `fused_layernorm`): LayerNorm
over the last axis with fp32 mean and variance, fp32 gamma/beta, eps 1e-5,
output in the input's dtype.  One Triton program normalises one row, with
`BLOCK_D` the next power of two above D (1024 for 768, 512 for 512).  The
work is a few flops per element, so the kernel is bound by reading x and
writing y once; the design makes it a single pass over device memory.

`layer_norm` takes the plain version for CPU tensors only.  A CUDA tensor
launches the kernel or raises.  `layer_norm.launches` counts launches.
Triton is imported when the kernel is first launched, never at import.
"""
from __future__ import annotations

import functools

import torch

EPS = 1e-5
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


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


@functools.lru_cache(maxsize=None)
def _kernel():
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

    return triton, _ln_fwd


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = EPS) -> torch.Tensor:
    """LayerNorm over the last axis of a contiguous x of any rank; weight
    and bias are fp32 [D]; the output has x's dtype and shape."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    D = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.dtype != torch.float32 or t.device != x.device \
                or tuple(t.shape) != (D,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous fp32 [{D}] tensor "
                             f"on {x.device}")
    y = torch.empty_like(x)
    R = x.numel() // D if D else 0
    if R == 0:
        return y
    triton, kernel = _kernel()
    block = triton.next_power_of_2(D)
    with torch.cuda.device(x.device):
        kernel[(R,)](x, weight, bias, y, D, eps, BLOCK_D=block,
                     num_warps=4 if block <= 1024 else 8)
    layer_norm.launches += 1
    return y


layer_norm.launches = 0
