# coding=utf-8
"""Multi-head self-attention forward: a CUDA C++ kernel and its plain version.

Replaces the TPU kernel `centerclip_tpu/ops/attention_pallas.py`
(`_mha_kernel` / `_mha_fwd_call`, entry `fused_mha`).  The kernel is
`csrc/attention.cu`: one CTA per (sample, head) reads its q, k and v
straight from the packed `[B, L, 3*D]` output of the QKV projection, keeps
the fp32 scores and softmax in shared memory and writes `[B, L, D]`.  At
CLIP's sequence lengths (50 vision tokens, 32 text tokens) attention is
bound by the bytes of q, k, v and out, not by flops; the design keeps every
intermediate out of device memory and needs no head transposes.

`fused_attention` takes the plain version for CPU tensors only.  A CUDA
tensor launches the kernel or raises.  `fused_attention.launches` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

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


def _check_cuda_inputs(qkv: torch.Tensor, heads: int,
                       attn_mask: Optional[torch.Tensor]) -> int:
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
    smem = _build.smem_bytes(_build.load("attention"),
                             "cc_attention_smem_bytes", L, hd,
                             qkv.element_size())
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"L={L}, head_dim={hd} needs {smem} bytes of shared "
                         f"memory per CTA; the kernel takes at most "
                         f"{_build.MAX_SMEM_BYTES}")
    return hd


def fused_attention(qkv: torch.Tensor, heads: int,
                    attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention from the packed QKV projection output.

    Args:
        qkv: [B, L, 3*D] (q | k | v, heads packed in each), float32,
            bfloat16 or float16.
        heads: number of heads H (D = H * head_dim).
        attn_mask: optional additive fp32 [L, L] mask (e.g. causal).
    Returns:
        [B, L, D] in qkv's dtype.
    """
    if qkv.device.type == "cpu":
        return attention_plain(qkv, heads, attn_mask)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    hd = _check_cuda_inputs(qkv, heads, attn_mask)
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


fused_attention.launches = 0
