# coding=utf-8
"""Multi-head self-attention: CUDA C++ kernels for the forward and the
backward, their plain versions, and the autograd Function that joins them.

Replaces the TPU kernels of `centerclip_tpu/ops/attention_pallas.py`: the
forward `_mha_kernel` / `_mha_fwd_call` (entry `fused_mha`) with
`csrc/attention.cu`, and the backward `_mha_bwd_kernel` / `_mha_bwd_call`
(its custom VJP) with `csrc/attention_bwd.cu`.  One CTA per (sample, head)
reads q, k and v straight from the packed `[B, L, 3*D]` output of the QKV
projection and keeps the fp32 scores and softmax in shared memory; the
forward writes `[B, L, D]`, the backward recomputes the probabilities
(nothing `[L, L]`-sized is saved) and writes the gradient packed as
`[B, L, 3*D]`, so the projection's backward stays one matmul.  At CLIP's
sequence lengths (50 vision tokens, 32 text tokens) both are bound by the
bytes of their inputs and outputs, not by flops; the design keeps every
intermediate out of device memory and needs no head transposes.

`fused_attention` is differentiable through `_FusedAttention`: kernel A
forward, kernel B backward.  For CPU tensors both sides take their plain
versions; a CUDA tensor launches the kernels or raises.
`fused_attention.launches` and `attention_backward.launches` count kernel
launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def attention_plain(qkv: torch.Tensor, heads: int,
                    attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version, the fp32-logit path of the JAX package's
    `models/layers.py:103-116`: q is scaled in its own dtype, the logits and
    softmax are fp32, the probabilities are cast to v's dtype, and P.V
    accumulates in fp32 (operands are upcast, which is exact for the
    products) before the cast back to the input dtype."""
    B, L, D3 = qkv.shape
    D = D3 // 3
    hd = D // heads
    q, k, v = qkv.split(D, dim=-1)
    q = (q * hd ** -0.5).reshape(B, L, heads, hd).transpose(1, 2)
    k = k.reshape(B, L, heads, hd).transpose(1, 2)
    v = v.reshape(B, L, heads, hd).transpose(1, 2)
    logits = q.float() @ k.float().transpose(-1, -2)           # [B, H, L, L]
    if attn_mask is not None:
        logits = logits + attn_mask.float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = probs.float() @ v.float()                             # [B, H, L, hd]
    return out.transpose(1, 2).reshape(B, L, D).to(qkv.dtype)


def attention_bwd_plain(qkv: torch.Tensor, dout: torch.Tensor, heads: int,
                        attn_mask: Optional[torch.Tensor] = None,
                        mask_grad: bool = False
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain PyTorch version of the backward of `attention_plain`, with
    its rounding points written out (kernel B does the same arithmetic):

    the probabilities are recomputed from q scaled and rounded to qkv's
    dtype; dV = P_r^T . dO with P rounded to v's dtype, as the forward's
    P.V uses it; dP = dO . V^T, dS = P * (dP - rowsum(dP * P)),
    dQ = scale * dS . K and dK = dS^T . q_scaled all in fp32 (dS stays fp32
    as in `_attend_bwd`, attention_pallas.py:235-259), cast once at the end.

    Returns (dqkv [B, L, 3*D] in qkv's dtype, dmask [L, L] fp32 — the sum
    of dS over samples and heads — or None unless `mask_grad`)."""
    B, L, D3 = qkv.shape
    D = D3 // 3
    hd = D // heads
    scale = hd ** -0.5

    def split_heads(x: torch.Tensor) -> torch.Tensor:
        return x.reshape(B, L, heads, hd).transpose(1, 2).float()

    q, k, v = qkv.split(D, dim=-1)
    qs, kf, vf = split_heads(q * scale), split_heads(k), split_heads(v)
    do = split_heads(dout)
    logits = qs @ kf.transpose(-1, -2)                          # [B, H, L, L]
    if attn_mask is not None:
        logits = logits + attn_mask.float()
    probs = torch.softmax(logits, dim=-1)
    dv = probs.to(qkv.dtype).float().transpose(-1, -2) @ do
    dp = do @ vf.transpose(-1, -2)
    ds = probs * (dp - (dp * probs).sum(dim=-1, keepdim=True))
    dq = (ds @ kf) * scale
    dk = ds.transpose(-1, -2) @ qs
    dqkv = torch.cat([g.transpose(1, 2).reshape(B, L, D) for g in (dq, dk, dv)],
                     dim=-1).to(qkv.dtype)
    return dqkv, (ds.sum(dim=(0, 1)) if mask_grad else None)


def _check_cuda_inputs(qkv: torch.Tensor, heads: int,
                       attn_mask: Optional[torch.Tensor], lib_name: str,
                       smem_fn: str) -> int:
    if qkv.dim() != 3 or qkv.shape[-1] % 3 or (qkv.shape[-1] // 3) % heads:
        raise ValueError(f"qkv must be [B, L, 3*D] with D divisible by "
                         f"heads={heads}; got {tuple(qkv.shape)}")
    if qkv.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    B, L, _ = qkv.shape
    if attn_mask is not None:
        if attn_mask.device != qkv.device or attn_mask.dtype != torch.float32:
            raise ValueError("attn_mask must be fp32 on the device of qkv")
        if tuple(attn_mask.shape) != (L, L) or not attn_mask.is_contiguous():
            raise ValueError(f"attn_mask must be a contiguous [{L}, {L}] "
                             f"tensor; got {tuple(attn_mask.shape)}")
    hd = qkv.shape[-1] // 3 // heads
    smem = _build.smem_bytes(_build.load(lib_name), smem_fn, L, hd,
                             qkv.element_size())
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"L={L}, head_dim={hd} needs {smem} bytes of shared "
                         f"memory per CTA; the kernel takes at most "
                         f"{_build.MAX_SMEM_BYTES}")
    return hd


def _forward(qkv: torch.Tensor, heads: int,
             attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Kernel A on a CUDA tensor, the plain version on a CPU tensor."""
    if qkv.device.type == "cpu":
        return attention_plain(qkv, heads, attn_mask)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    hd = _check_cuda_inputs(qkv, heads, attn_mask, "attention",
                            "cc_attention_smem_bytes")
    B, L, D3 = qkv.shape
    out = torch.empty((B, L, D3 // 3), dtype=qkv.dtype, device=qkv.device)
    if B == 0:
        return out
    lib = _build.load("attention")
    fn = lib.cc_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qkv.data_ptr(),
                 attn_mask.data_ptr() if attn_mask is not None else None,
                 out.data_ptr(), B, L, heads, hd, _DTYPE_CODES[qkv.dtype],
                 float(hd ** -0.5), stream)
    _build.check(lib, err, "attention kernel")
    fused_attention.launches += 1
    return out


def attention_backward(qkv: torch.Tensor, dout: torch.Tensor, heads: int,
                       attn_mask: Optional[torch.Tensor] = None,
                       mask_grad: bool = False
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Gradient of `fused_attention` for the output gradient `dout`
    [B, L, D] (qkv's dtype): (dqkv [B, L, 3*D], dmask [L, L] fp32 or None).
    Kernel B on CUDA tensors, `attention_bwd_plain` on CPU tensors."""
    if qkv.device.type == "cpu":
        return attention_bwd_plain(qkv, dout, heads, attn_mask, mask_grad)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    hd = _check_cuda_inputs(qkv, heads, attn_mask, "attention_bwd",
                            "cc_attention_bwd_smem_bytes")
    B, L, D3 = qkv.shape
    if tuple(dout.shape) != (B, L, D3 // 3) or dout.dtype != qkv.dtype \
            or dout.device != qkv.device or not dout.is_contiguous():
        raise ValueError(f"dout must be a contiguous {qkv.dtype} "
                         f"[{B}, {L}, {D3 // 3}] tensor on {qkv.device}; got "
                         f"{dout.dtype} {tuple(dout.shape)}")
    if mask_grad and attn_mask is None:
        raise ValueError("mask_grad needs an attn_mask")
    dqkv = torch.empty_like(qkv)
    dmask = (torch.zeros((L, L), dtype=torch.float32, device=qkv.device)
             if mask_grad else None)
    if B == 0:
        return dqkv, dmask
    lib = _build.load("attention_bwd")
    fn = lib.cc_attention_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p]
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qkv.data_ptr(),
                 attn_mask.data_ptr() if attn_mask is not None else None,
                 dout.data_ptr(), dqkv.data_ptr(),
                 dmask.data_ptr() if dmask is not None else None,
                 B, L, heads, hd, _DTYPE_CODES[qkv.dtype], float(hd ** -0.5),
                 stream)
    _build.check(lib, err, "attention backward kernel")
    attention_backward.launches += 1
    return dqkv, dmask


class _FusedAttention(torch.autograd.Function):
    """Kernel A forward, kernel B backward (plain versions on the CPU).
    Saves only qkv (and the mask): the backward recomputes P."""

    @staticmethod
    def forward(ctx, qkv, attn_mask, heads):
        ctx.heads = heads
        ctx.save_for_backward(qkv, attn_mask)
        return _forward(qkv, heads, attn_mask)

    @staticmethod
    def backward(ctx, dout):
        qkv, attn_mask = ctx.saved_tensors
        dqkv, dmask = attention_backward(
            qkv, dout.contiguous(), ctx.heads, attn_mask,
            mask_grad=ctx.needs_input_grad[1])
        return dqkv, dmask, None


def fused_attention(qkv: torch.Tensor, heads: int,
                    attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention from the packed QKV projection output, differentiable
    in qkv (and in the mask, where it requires grad).

    Args:
        qkv: [B, L, 3*D] (q | k | v, heads packed in each), float32,
            bfloat16 or float16.
        heads: number of heads H (D = H * head_dim).
        attn_mask: optional additive fp32 [L, L] mask (e.g. causal).
    Returns:
        [B, L, D] in qkv's dtype.
    """
    return _FusedAttention.apply(qkv, attn_mask, heads)


fused_attention.launches = 0
attention_backward.launches = 0
