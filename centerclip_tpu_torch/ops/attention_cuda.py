# coding=utf-8
"""Multi-head self-attention: CUDA C++ kernels for the forward and the
backward, their plain versions, and the autograd Function that joins them.

Replaces the TPU kernels of `centerclip_tpu/ops/attention_pallas.py`: the
forward `_mha_kernel` / `_mha_fwd_call` (entry `fused_mha`) with
`csrc/attention.cu`, and the backward `_mha_bwd_kernel` / `_mha_bwd_call`
(its custom VJP) with `csrc/attention_bwd.cu`.  A CTA takes one (sample,
head) at a time, reads its q, k and v straight from the packed
`[B, L, 3*D]` output of the QKV projection and keeps the scores and
probabilities on chip; the forward
writes `[B, L, D]`, the backward recomputes the probabilities (nothing
`[L, L]`-sized is saved) and writes the gradient packed as `[B, L, 3*D]`,
so the projection's backward stays one matmul.  At CLIP's sequence lengths
(50 vision tokens, 32 text tokens) both are bound by the bytes of their
inputs and outputs, not by flops.

Each source has a "tensor_core" variant (bf16 / fp16 with head_dim % 16 ==
0, L <= 128: mma.sync from ldmatrix, cp.async loads, one CTA per (sample,
head); the backward's warps hold their rows of S and dP whole in
registers), a "tensor_core_long" variant (bf16 / fp16, L > 128: ViT-B/16's
197 tokens, and 1 + K after its cluster layer, e.g. 161 or 393) that
splits each (sample, head) over CTAs of 64 query rows (the forward and
the backward's dQ launch) or 64 keys (the backward's dK / dV launch) and
streams the other side's rows in tiles of 64, a "cuda_core" variant
(fp32: fmaf loops with the whole [L, L] fp32 scores in shared memory, so
short sequences only, at any head_dim where they fit) and a "tf32x3"
variant (fp32 on the tensor cores: every product in three TF32 passes,
x = hi + lo with hi = tf32(x), lo = tf32(x - hi), lo.hi + hi.lo + hi.hi
with fp32 accumulation, any L, head_dim <= 128; csrc/f32_tile.cuh).  Its
forward writes each row's log-sum-exp, which `_FusedAttention` saves with
the output O for its backward (delta = rowsum(dO * O), no statistics
pass).  cuBLAS and cuDNN TF32 stay off in the port: the split is the
kernels' own arithmetic and keeps fp32's tolerances.
`choose_variant` picks one from dtype, head_dim, L and the direction
before the launch; what none takes raises.

`fused_attention` is differentiable through `_FusedAttention`: kernel A
forward, kernel B backward.  For CPU tensors both sides take their plain
versions; a CUDA tensor launches the kernels or raises.
`fused_attention.launches` and `attention_backward.launches` count kernel
launches, and their `variant_launches` split the count by variant.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

_DTYPE_CODES = {torch.bfloat16: 1, torch.float16: 2}
TENSOR_CORE, CUDA_CORE = "tensor_core", "cuda_core"
TENSOR_CORE_LONG, TF32X3 = "tensor_core_long", "tf32x3"
VARIANTS = (TENSOR_CORE, TENSOR_CORE_LONG, CUDA_CORE, TF32X3)
FP32_VARIANTS = (CUDA_CORE, TF32X3)
# the tensor-core variants stage a whole (sample, head) and the backward's
# warps hold their S and dP rows whole in registers; the long variants take
# every length above (their shared memory does not grow with L)
TENSOR_CORE_MAX_L = 128
# fp32: the lengths (lo, hi] at which the CUDA-core variant is the faster
# one, a direction each, where its [L, L] scores fit a CTA (to 163 forward
# and 108 backward at head_dim 64); TF32X3 elsewhere.  Set from an H100's
# times (chip_smoke.py's threshold rows, 1536 x 12 heads of 64 at L =
# 32-163 and the text tower's 128 x 8 causal at 32 and 77): TF32X3 was
# the faster one at every length, both directions (1.9-7.5x forward,
# 1.2-4.5x backward), so the CUDA-core variant runs only past head_dim
# TF32X3_MAX_HEAD_DIM
FP32_SHORT_RANGES = {False: (), True: ()}
# the tf32x3 kernels hold one or two 64-channel groups of the outputs
TF32X3_MAX_HEAD_DIM = 128
_SMEM_FNS = {(False, TENSOR_CORE): "cc_attention_mma_smem_bytes",
             (False, TENSOR_CORE_LONG): "cc_attention_long_smem_bytes",
             (False, CUDA_CORE): "cc_attention_simt_smem_bytes",
             (False, TF32X3): "cc_attention_tf32x3_smem_bytes",
             (True, TENSOR_CORE): "cc_attention_bwd_mma_smem_bytes",
             (True, TENSOR_CORE_LONG): "cc_attention_bwd_long_smem_bytes",
             (True, CUDA_CORE): "cc_attention_bwd_simt_smem_bytes",
             (True, TF32X3): "cc_attention_bwd_tf32x3_smem_bytes"}


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


def fp32_short_smem_bytes(L: int, head_dim: int, backward: bool) -> int:
    """Shared memory of one CTA of the fp32 CUDA-core variant, as
    `simt_smem` in csrc/attention.cu (q, k^T, v, then the [L, L] scores at
    a 16-byte offset) and csrc/attention_bwd.cu (qs, k^T, k, v^T, dO, P and
    dP / dS) compute it."""
    if backward:
        return (5 * L * head_dim + 2 * L * L) * 4
    return (3 * L * head_dim * 4 + 15) // 16 * 16 + L * L * 4


def choose_variant(dtype: torch.dtype, head_dim: int, L: int,
                   backward: bool = False) -> str:
    """The kernel variant a CUDA tensor takes, from its dtype, head_dim,
    sequence length and direction alone: for bf16 / fp16 with head_dim a
    multiple of 16 TENSOR_CORE up to L = TENSOR_CORE_MAX_L and
    TENSOR_CORE_LONG past it, forward and backward; for fp32 CUDA_CORE in
    the direction's FP32_SHORT_RANGES, and at head_dim past
    TF32X3_MAX_HEAD_DIM, where its scores (forward) or its scores and
    dS (backward) fit a CTA's shared memory, TF32X3 elsewhere.
    Raises ValueError for what no variant takes; whether the tiles fit in
    shared memory is also checked at launch from the sources' own sizes."""
    if L < 1 or head_dim < 1:
        raise ValueError(f"need L >= 1 and head_dim >= 1; got L={L}, "
                         f"head_dim={head_dim}")
    if dtype == torch.float32:
        fits = fp32_short_smem_bytes(L, head_dim, backward) \
            <= _build.MAX_SMEM_BYTES
        wide = head_dim > TF32X3_MAX_HEAD_DIM
        if fits and (wide or any(lo < L <= hi for lo, hi
                                 in FP32_SHORT_RANGES[backward])):
            return CUDA_CORE
        if wide:
            raise ValueError(
                f"fp32 attention at L={L}, head_dim={head_dim}: the "
                f"CUDA-core variant's scores do not fit a CTA and the "
                f"tensor-core one takes head_dim <= {TF32X3_MAX_HEAD_DIM}")
        return TF32X3
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {dtype}")
    if head_dim % 16:
        raise ValueError(f"the {dtype} kernels need head_dim % 16 == 0; got "
                         f"{head_dim}")
    return TENSOR_CORE_LONG if L > TENSOR_CORE_MAX_L else TENSOR_CORE


def _check_cuda_inputs(qkv: torch.Tensor, heads: int,
                       attn_mask: Optional[torch.Tensor],
                       backward: bool, variant: Optional[str] = None
                       ) -> Tuple[int, str]:
    """(head_dim, variant) for a CUDA qkv, or ValueError."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3 or (qkv.shape[-1] // 3) % heads:
        raise ValueError(f"qkv must be [B, L, 3*D] with D divisible by "
                         f"heads={heads}; got {tuple(qkv.shape)}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    B, L, _ = qkv.shape
    hd = qkv.shape[-1] // 3 // heads
    if variant is None:
        variant = choose_variant(qkv.dtype, hd, L, backward)
    elif qkv.dtype != torch.float32 or variant not in FP32_VARIANTS or (
            variant == TF32X3 and hd > TF32X3_MAX_HEAD_DIM):
        raise ValueError(f"no attention variant {variant!r} for "
                         f"{qkv.dtype}, head_dim={hd}")
    if attn_mask is not None:
        if attn_mask.device != qkv.device or attn_mask.dtype != torch.float32:
            raise ValueError("attn_mask must be fp32 on the device of qkv")
        if tuple(attn_mask.shape) != (L, L) or not attn_mask.is_contiguous():
            raise ValueError(f"attn_mask must be a contiguous [{L}, {L}] "
                             f"tensor; got {tuple(attn_mask.shape)}")
    if variant not in FP32_VARIANTS and qkv.data_ptr() % 16:
        raise ValueError("qkv must start at a 16-byte aligned address")
    lib = _build.load("attention_bwd" if backward else "attention")
    sizes = (L, hd) if variant in FP32_VARIANTS else (L, hd,
                                                      qkv.element_size())
    smem = _build.smem_bytes(lib, _SMEM_FNS[(backward, variant)], *sizes)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"L={L}, head_dim={hd} needs {smem} bytes of shared "
                         f"memory per CTA; the kernel takes at most "
                         f"{_build.MAX_SMEM_BYTES}")
    return hd, variant


def _entry(lib: ctypes.CDLL, name: str, n_ptrs: int, n_ints: int,
           dtype_code: bool):
    """The exported `int name(ptrs..., ints... [, dtype], float scale,
    void* stream)` with its ctypes signature set."""
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs
                   + [ctypes.c_int] * (n_ints + int(dtype_code))
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _stats_len(lib: ctypes.CDLL, L: int) -> int:
    fn = lib.cc_attention_bwd_long_stats_len
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int]
    return fn(L)


def long_occupancy(dtype: torch.dtype, head_dim: int,
                   backward: bool = False) -> dict:
    """{kernel: {"registers", "smem_bytes", "ctas_per_sm"}} of the long
    variant's kernels (the forward's one, the backward's two) for this dtype
    (fp32: TF32X3's) and head_dim on the current card
    (cudaFuncGetAttributes and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    f32 = dtype == torch.float32
    code = () if f32 else (_DTYPE_CODES[dtype],)
    if backward:
        lib = _build.load("attention_bwd")
        kernels = (("attention_bwd_tf32x3_dq_kernel" if f32
                    else "attention_bwd_dq_kernel", (0,)),
                   ("attention_bwd_tf32x3_dkv_kernel" if f32
                    else "attention_bwd_dkv_kernel", (1,)))
        name = "cc_attention_bwd_tf32x3_occupancy" if f32 \
            else "cc_attention_bwd_long_occupancy"
    else:
        lib = _build.load("attention")
        kernels = (("attention_fwd_tf32x3_kernel" if f32
                    else "attention_fwd_long_kernel", ()),)
        name = "cc_attention_fwd_tf32x3_occupancy" if f32 \
            else "cc_attention_fwd_long_occupancy"
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * (len(kernels[0][1]) + 1 + len(code))
                   + [ctypes.c_void_p])
    out = {}
    for kernel, which in kernels:
        vals = (ctypes.c_int * 3)()
        _build.check(lib, fn(*which, head_dim, *code,
                             ctypes.addressof(vals)),
                     f"occupancy of {kernel}")
        out[kernel] = dict(registers=vals[0], smem_bytes=vals[1],
                           ctas_per_sm=vals[2])
    return out


def _count(fn, variant: str) -> None:
    fn.launches += 1
    fn.variant_launches[variant] += 1


def _forward(qkv: torch.Tensor, heads: int,
             attn_mask: Optional[torch.Tensor],
             variant: Optional[str] = None, lse_out: bool = False):
    """Kernel A on a CUDA tensor, the plain version on a CPU tensor.
    `variant` (an fp32 one for an fp32 qkv) overrides `choose_variant`, to
    hold the two fp32 variants against each other where both run.  With
    `lse_out`, returns (out, lse): lse each row's log-sum-exp [B*H, L]
    fp32 where the variant is TF32X3 (it writes them beside O), else
    None."""
    if qkv.device.type == "cpu":
        out = attention_plain(qkv, heads, attn_mask)
        return (out, None) if lse_out else out
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    hd, variant = _check_cuda_inputs(qkv, heads, attn_mask, backward=False,
                                     variant=variant)
    B, L, D3 = qkv.shape
    out = torch.empty((B, L, D3 // 3), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((B * heads, L), dtype=torch.float32,
                       device=qkv.device)
           if lse_out and variant == TF32X3 else None)
    if B == 0:
        return (out, lse) if lse_out else out
    lib = _build.load("attention")
    mask_ptr = attn_mask.data_ptr() if attn_mask is not None else None
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        if variant not in FP32_VARIANTS:
            name = ("cc_attention_fwd_mma" if variant == TENSOR_CORE
                    else "cc_attention_fwd_long")
            err = _entry(lib, name, 3, 4, True)(
                qkv.data_ptr(), mask_ptr, out.data_ptr(), B, L, heads, hd,
                _DTYPE_CODES[qkv.dtype], float(hd ** -0.5), stream)
        elif variant == TF32X3:
            err = _entry(lib, "cc_attention_fwd_tf32x3", 4, 4, False)(
                qkv.data_ptr(), mask_ptr, out.data_ptr(),
                lse.data_ptr() if lse is not None else None, B, L, heads,
                hd, float(hd ** -0.5), stream)
        else:
            err = _entry(lib, "cc_attention_fwd_simt", 3, 4, False)(
                qkv.data_ptr(), mask_ptr, out.data_ptr(), B, L, heads, hd,
                float(hd ** -0.5), stream)
    _build.check(lib, err, f"attention kernel ({variant})")
    _count(fused_attention, variant)
    return (out, lse) if lse_out else out


def attention_backward(qkv: torch.Tensor, dout: torch.Tensor, heads: int,
                       attn_mask: Optional[torch.Tensor] = None,
                       mask_grad: bool = False, variant: Optional[str] = None,
                       out: Optional[torch.Tensor] = None,
                       lse: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Gradient of `fused_attention` for the output gradient `dout`
    [B, L, D] (qkv's dtype): (dqkv [B, L, 3*D], dmask [L, L] fp32 or None).
    Kernel B on CUDA tensors, `attention_bwd_plain` on CPU tensors.
    `variant` as in `_forward`.  TF32X3 takes the forward's output `out`
    and log-sum-exp `lse` (`_forward(..., lse_out=True)` on the same qkv
    and mask); without them it launches kernel A's TF32X3 variant for
    them first."""
    if qkv.device.type == "cpu":
        return attention_bwd_plain(qkv, dout, heads, attn_mask, mask_grad)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    hd, variant = _check_cuda_inputs(qkv, heads, attn_mask, backward=True,
                                     variant=variant)
    B, L, D3 = qkv.shape
    if tuple(dout.shape) != (B, L, D3 // 3) or dout.dtype != qkv.dtype \
            or dout.device != qkv.device or not dout.is_contiguous():
        raise ValueError(f"dout must be a contiguous {qkv.dtype} "
                         f"[{B}, {L}, {D3 // 3}] tensor on {qkv.device}; got "
                         f"{dout.dtype} {tuple(dout.shape)}")
    if variant not in FP32_VARIANTS and dout.data_ptr() % 16:
        raise ValueError("dout must start at a 16-byte aligned address")
    if mask_grad and attn_mask is None:
        raise ValueError("mask_grad needs an attn_mask")
    if mask_grad and variant in (TENSOR_CORE_LONG, TF32X3):
        raise ValueError(f"the {variant} backward has no mask gradient")
    dqkv = torch.empty_like(qkv)
    dmask = (torch.zeros((L, L), dtype=torch.float32, device=qkv.device)
             if mask_grad else None)
    if B == 0:
        return dqkv, dmask
    if variant == TF32X3:
        if out is None or lse is None:
            out, lse = _forward(qkv, heads, attn_mask, variant=TF32X3,
                                lse_out=True)
        if tuple(out.shape) != tuple(dout.shape) or out.dtype != qkv.dtype \
                or not out.is_contiguous() or out.device != qkv.device \
                or tuple(lse.shape) != (B * heads, L) \
                or lse.dtype != torch.float32 or not lse.is_contiguous() \
                or lse.device != qkv.device:
            raise ValueError("out and lse must be the tf32x3 forward's "
                             "contiguous output and log-sum-exp")
    lib = _build.load("attention_bwd")
    ptrs = (qkv.data_ptr(),
            attn_mask.data_ptr() if attn_mask is not None else None,
            dout.data_ptr(), dqkv.data_ptr(),
            dmask.data_ptr() if dmask is not None else None)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        if variant == TENSOR_CORE:
            err = _entry(lib, "cc_attention_bwd_mma", 5, 4, True)(
                *ptrs, B, L, heads, hd, _DTYPE_CODES[qkv.dtype],
                float(hd ** -0.5), stream)
        elif variant == TENSOR_CORE_LONG:
            # m, l and delta of every query row, from the first launch to
            # the second
            stats = torch.empty((3, B * heads, _stats_len(lib, L)),
                                dtype=torch.float32, device=qkv.device)
            err = _entry(lib, "cc_attention_bwd_long", 5, 4, True)(
                *ptrs[:4], stats.data_ptr(), B, L, heads, hd,
                _DTYPE_CODES[qkv.dtype], float(hd ** -0.5), stream)
        elif variant == TF32X3:
            # delta = rowsum(dO * O) of every query row, from the first
            # launch to the second
            delta = torch.empty((B * heads, L), dtype=torch.float32,
                                device=qkv.device)
            err = _entry(lib, "cc_attention_bwd_tf32x3", 7, 4, False)(
                *ptrs[:3], out.data_ptr(), lse.data_ptr(), dqkv.data_ptr(),
                delta.data_ptr(), B, L, heads, hd, float(hd ** -0.5), stream)
        else:
            err = _entry(lib, "cc_attention_bwd_simt", 5, 4, False)(
                *ptrs, B, L, heads, hd, float(hd ** -0.5), stream)
    _build.check(lib, err, f"attention backward kernel ({variant})")
    _count(attention_backward, variant)
    return dqkv, dmask


class _FusedAttention(torch.autograd.Function):
    """Kernel A forward, kernel B backward (plain versions on the CPU).
    Saves qkv (and the mask): the backward recomputes P.  Where a gradient
    is wanted (`grad`) and both directions take TF32X3 it also saves the
    output O (the tensor the out-projection saves anyway) and the rows'
    log-sum-exp [B*H, L]."""

    @staticmethod
    def forward(ctx, qkv, attn_mask, heads, grad):
        ctx.heads = heads
        out, lse = (_forward(qkv, heads, attn_mask, lse_out=True) if grad
                    else (_forward(qkv, heads, attn_mask), None))
        if lse is not None and choose_variant(
                qkv.dtype, qkv.shape[-1] // 3 // heads, qkv.shape[1],
                backward=True) == TF32X3:
            ctx.save_for_backward(qkv, attn_mask, out, lse)
        else:
            ctx.save_for_backward(qkv, attn_mask, None, None)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, attn_mask, out, lse = ctx.saved_tensors
        dqkv, dmask = attention_backward(
            qkv, dout.contiguous(), ctx.heads, attn_mask,
            mask_grad=ctx.needs_input_grad[1], out=out, lse=lse)
        return dqkv, dmask, None, None


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
    grad = torch.is_grad_enabled() and (
        qkv.requires_grad or (attn_mask is not None
                              and attn_mask.requires_grad))
    return _FusedAttention.apply(qkv, attn_mask, heads, grad)


def reset_counts() -> None:
    """Zero both wrappers' launch counts, the totals and by variant."""
    for fn in (fused_attention, attention_backward):
        fn.launches = 0
        fn.variant_launches = dict.fromkeys(VARIANTS, 0)


reset_counts()
