# coding=utf-8
"""The design of the tensor-core attention kernels, held on the CPU.

- The wrappers' choice of kernel variant, a pure function of dtype,
  head_dim and L.
- The long variants' tiling (L > 128), emulated here with PyTorch and held
  against the plain versions at ViT-B/16's L = 197 and 161: the forward's
  two passes over 64-key tiles (m and l first, then P normalised in fp32,
  rounded, and P.V summed over the tiles in order); the backward's
  statistics per 64-key tile (the running max m, l = sum exp(s - m) and
  a = sum exp(s - m) dP, rescaled when m grows, give the softmax and
  delta = a / l), dQ summed over key tiles in order, dK and dV per key
  tile summed over query blocks in order, dS as the hi/lo pair.
- The backward kernel's one departure from the plain version's operands:
  dS enters the dQ and dK products as the pair hi = T(dS), lo = T(dS - hi)
  of 16-bit operands with fp32 accumulation (two mma per product), emulated
  here with PyTorch and held against `attention_bwd_plain`.
- The fp32 tensor-core variant (TF32X3), its arithmetic emulated in fp32:
  every product in three TF32 passes (x = hi + lo, hi and lo rounded to
  TF32 by cvt.rna's rule on the bits, lo.hi + hi.lo + hi.hi), the
  forward's online softmax over 64-key tiles and its log-sum-exp, the
  backward's P = exp(S - lse), delta = rowsum(dO * O), dQ over key tiles
  and dK, dV over 32-row query tiles in order; held against the plain
  versions at L = 32, 50, 77 (causal), 161, 197 and 393 within half the
  card's fp32 tolerances (1e-5 forward, 1e-4 backward), and at a small
  width against the JAX package's `fused_mha` (Pallas, interpret mode)
  and its VJP.  One TF32 pass, what TF32 matmuls would do, fails those
  tolerances: the lo terms are needed.  The fp32 variants' shared-memory
  layouts (the CUDA-core one's [L, L] limits, the tf32x3 one's
  independence of L).
- The build's freshness rule: a library is rebuilt when its source or any
  header the source includes is newer.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centerclip_tpu.ops.attention_pallas import fused_mha
from centerclip_tpu_torch.ops import _build, attention_cuda
from centerclip_tpu_torch.ops.attention_cuda import (CUDA_CORE,
                                                     TENSOR_CORE,
                                                     TENSOR_CORE_LONG,
                                                     TF32X3,
                                                     choose_variant)

# bf16 tolerance of the card's kernel-vs-plain checks (chip_smoke.py,
# tests/test_torch_gpu.py): about one bf16 ulp
BF16_ATOL, BF16_RTOL = 1.6e-2, 1.6e-2


# ------------------------------------------------------------ variant choice
@pytest.mark.parametrize("dtype,hd,L,backward,expected", [
    (torch.bfloat16, 64, 50, False, TENSOR_CORE),     # vision tower
    (torch.bfloat16, 64, 50, True, TENSOR_CORE),
    (torch.bfloat16, 64, 32, True, TENSOR_CORE),      # text tower
    (torch.float16, 16, 1, True, TENSOR_CORE),
    (torch.float16, 128, 128, True, TENSOR_CORE),     # the backward's limit
    (torch.bfloat16, 64, 128, False, TENSOR_CORE),    # the forward's limit
    (torch.bfloat16, 64, 129, False, TENSOR_CORE_LONG),   # past 128 keys
    (torch.bfloat16, 64, 197, False, TENSOR_CORE_LONG),   # ViT-B/16 forward
    (torch.float16, 64, 256, False, TENSOR_CORE_LONG),
    (torch.bfloat16, 128, 600, False, TENSOR_CORE_LONG),  # no forward limit
    (torch.bfloat16, 64, 129, True, TENSOR_CORE_LONG),    # past 128 keys
    (torch.bfloat16, 64, 197, True, TENSOR_CORE_LONG),    # ViT-B/16 backward
    (torch.float16, 64, 256, True, TENSOR_CORE_LONG),
    (torch.bfloat16, 64, 257, True, TENSOR_CORE_LONG),    # past 4 key tiles
    (torch.bfloat16, 64, 393, True, TENSOR_CORE_LONG),    # K = 392 + CLS
    (torch.float16, 64, 1024, True, TENSOR_CORE_LONG),    # no backward limit
    (torch.float32, 64, 50, False, TF32X3),   # fp32, head_dim <= 128
    (torch.float32, 40, 197, True, TF32X3),   # fp32: any head_dim
    (torch.float32, 64, 32, False, TF32X3),   # the text tower
    (torch.float32, 64, 32, True, TF32X3),
    (torch.float32, 64, 1, True, TF32X3),     # any L: no short range
    (torch.float32, 64, 64, True, TF32X3),    # one key tile
    (torch.float32, 64, 77, True, TF32X3),    # just past one tile
    (torch.float32, 64, 77, False, TF32X3),
    (torch.float32, 64, 96, True, TF32X3),
    (torch.float32, 64, 48, True, TF32X3),
    (torch.float32, 64, 49, True, TF32X3),
    (torch.float32, 64, 72, False, TF32X3),
    (torch.float32, 64, 73, False, TF32X3),
    (torch.float32, 64, 41, False, TF32X3),
    (torch.float32, 64, 161, True, TF32X3),   # ViT-B/16 blocks 7-12
    (torch.float32, 128, 785, True, TF32X3),  # no length limit
    (torch.float32, 33, 77, False, TF32X3),   # any head_dim <= 128
    (torch.float32, 128, 8, False, TF32X3),   # to head_dim 128
    (torch.float32, 512, 30, False, CUDA_CORE),       # fits the short one
    (torch.float32, 192, 64, False, CUDA_CORE),       # past 128, where it fits
])
def test_choose_variant(dtype, hd, L, backward, expected):
    assert choose_variant(dtype, hd, L, backward) == expected


@pytest.mark.parametrize("dtype,hd,L,backward", [
    (torch.bfloat16, 40, 50, False),      # head_dim not a multiple of 16
    (torch.float16, 72, 32, True),
    (torch.float64, 64, 50, False),       # no float64 kernel
    (torch.bfloat16, 64, 0, False),       # empty sequence
    (torch.float32, 192, 197, False),     # fp32 long: head_dim <= 128
    (torch.float32, 512, 40, True),       # short scores do not fit
])
def test_choose_variant_raises(dtype, hd, L, backward):
    with pytest.raises(ValueError):
        choose_variant(dtype, hd, L, backward)


def test_cpu_tensors_take_the_plain_versions_whatever_the_variant():
    """The variant rule is for CUDA tensors: hd = 40 in bf16 has no kernel,
    but on the CPU it is the plain version's to compute."""
    g = np.random.default_rng(0)
    qkv = torch.from_numpy(g.standard_normal((2, 9, 3 * 80)).astype(
        np.float32)).to(torch.bfloat16)
    dout = torch.from_numpy(g.standard_normal((2, 9, 80)).astype(
        np.float32)).to(torch.bfloat16)
    out = attention_cuda.fused_attention(qkv, 2)
    assert torch.equal(out, attention_cuda.attention_plain(qkv, 2))
    dqkv, _ = attention_cuda.attention_backward(qkv, dout, 2)
    assert torch.equal(dqkv, attention_cuda.attention_bwd_plain(qkv, dout, 2)[0])


# ------------------------------------------------ the long variants' tiling
TILE = 64      # keys per streamed tile; query rows per block / keys per CTA


def _heads(x, B, L, heads, hd):
    return x.reshape(B, L, heads, hd).transpose(1, 2).float()


def _long_fwd_emulated(qkv, heads):
    """The long forward's arithmetic: q scaled and rounded to T; pass 1 over
    64-key tiles keeps each row's running max m and sum l (rescaled as m
    grows); pass 2 forms P = exp(S - m) / l per tile in fp32, rounds it to
    T and adds P.V of the tile to an fp32 sum, tile after tile."""
    B, L, D3 = qkv.shape
    D = D3 // 3
    hd = D // heads
    T = qkv.dtype
    q, k, v = qkv.split(D, dim=-1)
    qs = _heads((q * hd ** -0.5).to(T), B, L, heads, hd)
    kf, vf = _heads(k, B, L, heads, hd), _heads(v, B, L, heads, hd)
    m = torch.full((B, heads, L, 1), float("-inf"))
    l = torch.zeros((B, heads, L, 1))
    for j0 in range(0, L, TILE):
        s = qs @ kf[..., j0:j0 + TILE, :].transpose(-1, -2)
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        l = l * torch.exp(m - mn) + torch.exp(s - mn).sum(-1, keepdim=True)
        m = mn
    out = torch.zeros((B, heads, L, hd))
    for j0 in range(0, L, TILE):
        s = qs @ kf[..., j0:j0 + TILE, :].transpose(-1, -2)
        p = (torch.exp(s - m) / l).to(T).float()
        out = out + p @ vf[..., j0:j0 + TILE, :]
    return out.transpose(1, 2).reshape(B, L, D).to(T)


def _long_bwd_emulated(qkv, dout, heads):
    """The long backward's decomposition.  Launch 1, per query row: m, l and
    a = sum exp(s - m) dP over 64-key tiles (rescaled as m grows), delta =
    a / l; then per key tile j in order, dS_j = P_j (dP_j - delta) and
    dQ += dS_j.K_j with dS as the hi/lo pair.  Launch 2, per key tile j:
    over query blocks i of 64 in order, dV_j += T(P_ij)^T.dO_i and
    dK_j += dS_ij^T.qs_i (hi/lo)."""
    B, L, D3 = qkv.shape
    D = D3 // 3
    hd = D // heads
    scale = hd ** -0.5
    T = qkv.dtype
    q, k, v = qkv.split(D, dim=-1)
    qs = _heads((q * scale).to(T), B, L, heads, hd)
    kf, vf = _heads(k, B, L, heads, hd), _heads(v, B, L, heads, hd)
    do = _heads(dout, B, L, heads, hd)
    tiles = range(0, L, TILE)
    m = torch.full((B, heads, L, 1), float("-inf"))
    l = torch.zeros((B, heads, L, 1))
    a = torch.zeros((B, heads, L, 1))
    for j0 in tiles:
        s = qs @ kf[..., j0:j0 + TILE, :].transpose(-1, -2)
        dp = do @ vf[..., j0:j0 + TILE, :].transpose(-1, -2)
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        x = torch.exp(s - mn)
        shrink = torch.exp(m - mn)
        l = l * shrink + x.sum(-1, keepdim=True)
        a = a * shrink + (x * dp).sum(-1, keepdim=True)
        m = mn
    delta = a / l

    def hilo(x):
        hi = x.to(T).float()
        return hi, (x - hi).to(T).float()

    def p_ds(rows, j0):
        """P and dS of query rows `rows` (a slice) and key tile j0"""
        s = qs[..., rows, :] @ kf[..., j0:j0 + TILE, :].transpose(-1, -2)
        dp = do[..., rows, :] @ vf[..., j0:j0 + TILE, :].transpose(-1, -2)
        p = torch.exp(s - m[..., rows, :]) / l[..., rows, :]
        return p, p * (dp - delta[..., rows, :])

    dq = torch.zeros((B, heads, L, hd))
    for j0 in tiles:                                     # launch 1, pass 2
        _, ds = p_ds(slice(0, L), j0)
        hi, lo = hilo(ds)
        dq = dq + (hi @ kf[..., j0:j0 + TILE, :] + lo @ kf[..., j0:j0 + TILE, :])
    dk, dv = torch.zeros((B, heads, L, hd)), torch.zeros((B, heads, L, hd))
    for j0 in tiles:                                     # launch 2
        for i0 in tiles:
            p, ds = p_ds(slice(i0, i0 + TILE), j0)
            hi, lo = hilo(ds)
            qi, doi = qs[..., i0:i0 + TILE, :], do[..., i0:i0 + TILE, :]
            dv[..., j0:j0 + TILE, :] += p.to(T).float().transpose(-1, -2) @ doi
            dk[..., j0:j0 + TILE, :] += (hi.transpose(-1, -2) @ qi
                                         + lo.transpose(-1, -2) @ qi)
    return torch.cat([g.transpose(1, 2).reshape(B, L, D)
                      for g in (dq * scale, dk, dv)], dim=-1).to(T)


def _qkv_dout(L, B=2, H=12, hd=64):
    g = np.random.default_rng(L)
    qkv = torch.from_numpy(g.standard_normal((B, L, 3 * H * hd)).astype(
        np.float32)).to(torch.bfloat16)
    dout = torch.from_numpy(g.standard_normal((B, L, H * hd)).astype(
        np.float32)).to(torch.bfloat16)
    return qkv, dout, H


def _held(out, ref):
    """(worst error over the card's bf16 tolerance, share of values that
    differ)"""
    o, r = out.float(), ref.float()
    return (((o - r).abs() / (BF16_ATOL + BF16_RTOL * r.abs())).max().item(),
            (o != r).float().mean().item())


@pytest.mark.parametrize("L", [161, 197])
def test_long_forward_tiling_keeps_the_plain_forward(L):
    """The two passes over 64-key tiles move the output only by fp32
    rounding: within half the card's bf16 tolerance of `attention_plain`,
    under 1 % of its values changed."""
    qkv, _, H = _qkv_dout(L)
    worst, share = _held(_long_fwd_emulated(qkv, H),
                         attention_cuda.attention_plain(qkv, H))
    assert worst <= 0.5 and share <= 0.01, (worst, share)


@pytest.mark.parametrize("L", [129, 161, 197])
def test_key_tiled_statistics_keep_the_plain_backward(L):
    """The long backward's decomposition (statistics over 64-key tiles, dQ
    over key tiles in order, dK and dV per key tile over query blocks in
    order, hi/lo dS) stays within half the card's bf16 tolerance of
    `attention_bwd_plain` and changes under 1 % of its values."""
    qkv, dout, H = _qkv_dout(L)
    ref, _ = attention_cuda.attention_bwd_plain(qkv, dout, H)
    worst, share = _held(_long_bwd_emulated(qkv, dout, H), ref)
    assert worst <= 0.5 and share <= 0.01, (worst, share)


def test_long_backward_tiles_cover_every_row_once():
    """Launch 2's key tiles and query blocks cover [0, L) once each, and the
    statistics rows the wrapper allocates hold whole tiles."""
    for L in (129, 161, 192, 197, 256):
        tiles = list(range(0, L, TILE))
        rows = sorted(i for i0 in tiles for i in range(i0, min(i0 + TILE, L)))
        assert rows == list(range(L))
        assert len(tiles) * TILE >= L > (len(tiles) - 1) * TILE


# ------------------------------------------- the fp32 tensor-core variant
FP32_ATOL, FP32_RTOL = 1e-5, 1e-5            # the card's: forward
FP32_BWD_ATOL, FP32_BWD_RTOL = 1e-4, 1e-4    # backward
# csrc's tf32x3 steps: keys per ring stage of the forward and of the dQ
# launch, query rows per step of the dK / dV launch
FWD_KEYS, DQ_KEYS, QROWS = 32, 32, 16


def _tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 does: to nearest on the 10
    stored mantissa bits, ties away from zero (the 13 low bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm(a, b, passes=3):
    """a @ b on the tensor cores: three TF32 passes (the two small terms
    first, as the kernels add them), or one (TF32 alone).  Products of TF32
    values are exact in fp32, so fp32 matmuls of the halves emulate mma."""
    ah, al = _split(a)
    bh, bl = _split(b)
    if passes == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def _tf32x3_fwd_emulated(qkv, heads, mask=None, passes=3):
    """TF32X3's forward: q scaled in fp32; per FWD_KEYS-key tile S = qs.K^T
    (+ mask), the running max m, l = l exp(m - m') + sum exp(S - m') and
    O = O exp(m - m') + P.V with P = exp(S - m') in fp32; O / l and the
    rows' log-sum-exp m + ln l.  Returns (out [B, L, D], O [B, H, L, hd],
    lse [B, H, L, 1])."""
    B, L, D3 = qkv.shape
    D = D3 // 3
    hd = D // heads
    q, k, v = qkv.split(D, dim=-1)
    qs = _heads(q * hd ** -0.5, B, L, heads, hd)
    kf, vf = _heads(k, B, L, heads, hd), _heads(v, B, L, heads, hd)
    m = torch.full((B, heads, L, 1), float("-inf"))
    l = torch.zeros((B, heads, L, 1))
    o = torch.zeros((B, heads, L, hd))
    for j0 in range(0, L, FWD_KEYS):
        keys = slice(j0, j0 + FWD_KEYS)
        s = _mm(qs, kf[..., keys, :].transpose(-1, -2), passes)
        if mask is not None:
            s = s + mask[:, keys]
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        shrink = torch.exp(m - mn)
        p = torch.exp(s - mn)
        l = l * shrink + p.sum(-1, keepdim=True)
        o = o * shrink + _mm(p, vf[..., keys, :], passes)
        m = mn
    o = o / l
    return o.transpose(1, 2).reshape(B, L, D), o, m + torch.log(l)


def _tf32x3_bwd_emulated(qkv, dout, heads, mask=None, passes=3):
    """TF32X3's backward, from the emulated forward's O and log-sum-exp:
    delta = rowsum(dO * O); launch 1 per DQ_KEYS-key tile in order:
    dP = dO.V^T, P = exp(S - lse), dS = P (dP - delta), dQ += dS.K;
    launch 2 per 64-key tile, over QROWS-row query tiles in order:
    dV += P^T.dO, dK += dS^T.qs."""
    B, L, D3 = qkv.shape
    D = D3 // 3
    hd = D // heads
    scale = hd ** -0.5
    q, k, v = qkv.split(D, dim=-1)
    qs = _heads(q * scale, B, L, heads, hd)
    kf, vf = _heads(k, B, L, heads, hd), _heads(v, B, L, heads, hd)
    do = _heads(dout, B, L, heads, hd)
    _, o, lse = _tf32x3_fwd_emulated(qkv, heads, mask, passes)
    delta = (do * o).sum(-1, keepdim=True)

    def p_ds(rows, keys):
        kt, vt = kf[..., keys, :], vf[..., keys, :]
        s = _mm(qs[..., rows, :], kt.transpose(-1, -2), passes)
        if mask is not None:
            s = s + mask[rows, keys]
        dp = _mm(do[..., rows, :], vt.transpose(-1, -2), passes)
        p = torch.exp(s - lse[..., rows, :])
        return p, p * (dp - delta[..., rows, :])

    dq = torch.zeros((B, heads, L, hd))
    for j0 in range(0, L, DQ_KEYS):                      # launch 1
        keys = slice(j0, j0 + DQ_KEYS)
        _, ds = p_ds(slice(0, L), keys)
        dq = dq + _mm(ds, kf[..., keys, :], passes)
    dk, dv = torch.zeros((B, heads, L, hd)), torch.zeros((B, heads, L, hd))
    for j0 in range(0, L, TILE):                         # launch 2
        keys = slice(j0, j0 + TILE)
        for i0 in range(0, L, QROWS):
            rows = slice(i0, i0 + QROWS)
            p, ds = p_ds(rows, keys)
            dv[..., keys, :] += _mm(p.transpose(-1, -2), do[..., rows, :],
                                    passes)
            dk[..., keys, :] += _mm(ds.transpose(-1, -2), qs[..., rows, :],
                                    passes)
    return torch.cat([g.transpose(1, 2).reshape(B, L, D)
                      for g in (dq * scale, dk, dv)], dim=-1)


def _fp32_qkv_dout(L, B=2, H=12, hd=64):
    g = np.random.default_rng(L + 1)
    qkv = torch.from_numpy(g.standard_normal((B, L, 3 * H * hd)).astype(
        np.float32))
    dout = torch.from_numpy(g.standard_normal((B, L, H * hd)).astype(
        np.float32))
    return qkv, dout, H


def _causal(L):
    return torch.full((L, L), float("-inf")).triu(1)


def _share(out, ref, atol, rtol):
    """worst error as a share of the tolerance atol + rtol |ref|"""
    return ((out - ref).abs() / (atol + rtol * ref.abs())).max().item()


# ViT-B/32's 50 tokens, the text towers' 32 and 77 (causal), ViT-B/16's
# 197 and 161, K = 392's 393
FP32_LENGTHS = [32, 50, 77, 161, 197, 393]


@pytest.mark.parametrize("L", FP32_LENGTHS)
def test_fp32_long_forward_tiling_keeps_the_plain_forward(L):
    """TF32X3's forward (three TF32 passes a product, the online softmax
    over 64-key tiles) on fp32 inputs stays within half the card's fp32
    tolerance of `attention_plain`, and its log-sum-exp is the rows'."""
    qkv, _, H = _fp32_qkv_dout(L)
    mask = _causal(L) if L == 77 else None
    assert choose_variant(torch.float32, 64, L) in (TF32X3, CUDA_CORE)
    out, _, lse = _tf32x3_fwd_emulated(qkv, H, mask)
    ref = attention_cuda.attention_plain(qkv, H, mask)
    assert _share(out, ref, FP32_ATOL, FP32_RTOL) <= 0.5
    D = qkv.shape[-1] // 3
    s = _heads(qkv[..., :D] * 0.125, 2, L, H, 64) @ \
        _heads(qkv[..., D:2 * D], 2, L, H, 64).transpose(-1, -2)
    if mask is not None:
        s = s + mask
    torch.testing.assert_close(lse, torch.logsumexp(s, -1, keepdim=True),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("L", FP32_LENGTHS)
def test_fp32_key_tiled_statistics_keep_the_plain_backward(L):
    """TF32X3's backward (P from the forward's log-sum-exp, delta =
    rowsum(dO * O) from its output, three TF32 passes a product, dQ over
    key tiles, dK and dV over 32-row query tiles) on fp32 inputs stays
    within half the card's fp32 backward tolerance of
    `attention_bwd_plain`."""
    qkv, dout, H = _fp32_qkv_dout(L)
    mask = _causal(L) if L == 77 else None
    assert choose_variant(torch.float32, 64, L, backward=True) \
        in (TF32X3, CUDA_CORE)
    ref, _ = attention_cuda.attention_bwd_plain(qkv, dout, H, mask)
    out = _tf32x3_bwd_emulated(qkv, dout, H, mask)
    assert _share(out, ref, FP32_BWD_ATOL, FP32_BWD_RTOL) <= 0.5


@pytest.mark.parametrize("backward", [False, True])
def test_fp32_single_tf32_pass_misses_the_tolerances(backward):
    """One TF32 pass a product (no lo terms: what TF32 matmuls do) misses
    the card's fp32 tolerances at ViT-B/16's L = 197, where the three
    passes stay within half of them: the lo terms are what keeps fp32."""
    qkv, dout, H = _fp32_qkv_dout(197)
    if backward:
        ref, _ = attention_cuda.attention_bwd_plain(qkv, dout, H)
        shares = [_share(_tf32x3_bwd_emulated(qkv, dout, H, passes=n), ref,
                         FP32_BWD_ATOL, FP32_BWD_RTOL) for n in (3, 1)]
    else:
        ref = attention_cuda.attention_plain(qkv, H)
        shares = [_share(_tf32x3_fwd_emulated(qkv, H, passes=n)[0], ref,
                         FP32_ATOL, FP32_RTOL) for n in (3, 1)]
    assert shares[0] <= 0.5 < 1.0 < shares[1], shares


def test_tf32_rounding_is_cvt_rna():
    """_tf32 rounds to nearest with ties away from zero on 10 mantissa
    bits, and x - hi of any fp32 x is exact, so hi + lo leaves ~2^-22."""
    one = 1.0 + 2.0 ** -11                 # ties: away from zero
    x = torch.tensor([1.0, one, -one, 1.0 + 2.0 ** -12, 3.0 + 2.0 ** -10,
                      3.0 + 2.0 ** -9])
    assert _tf32(x).tolist() == [1.0, 1.0 + 2.0 ** -10, -1.0 - 2.0 ** -10,
                                 1.0, 3.0 + 2.0 ** -9, 3.0 + 2.0 ** -9]
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(
        4096).astype(np.float32))
    hi, lo = _split(y)
    assert torch.equal(_tf32(hi), hi) and torch.equal(_tf32(lo), lo)
    assert ((hi + lo - y).abs() <= y.abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("causal", [False, True])
def test_fp32_tf32x3_matches_jax_fused_mha(causal):
    """At a small width (2 heads of 16, L = 77) the emulated TF32X3 forward
    and backward against the JAX package's `fused_mha` (Pallas, interpret
    mode) and its custom VJP, within the card's fp32 tolerances."""
    B, L, H, hd = 2, 77, 2, 16
    D = H * hd
    g = np.random.default_rng(77 + causal)
    qkv = g.standard_normal((B, L, 3 * D)).astype(np.float32)
    dout = g.standard_normal((B, L, D)).astype(np.float32)
    mask = np.triu(np.full((L, L), -np.inf, np.float32), 1) if causal \
        else None
    jmask = None if mask is None else jnp.asarray(mask)
    q, k, v = (jnp.asarray(x) for x in np.split(qkv, 3, axis=-1))
    ref, vjp = jax.vjp(lambda q, k, v: fused_mha(
        q, k, v, jmask, heads=H, group=2, interpret=True), q, k, v)
    dref = np.concatenate([np.asarray(x) for x in vjp(jnp.asarray(dout))],
                          axis=-1)
    tmask = None if mask is None else torch.from_numpy(mask)
    out = _tf32x3_fwd_emulated(torch.from_numpy(qkv), H, tmask)[0]
    dqkv = _tf32x3_bwd_emulated(torch.from_numpy(qkv),
                                torch.from_numpy(dout), H, tmask)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=FP32_RTOL, atol=FP32_ATOL)
    np.testing.assert_allclose(dqkv.numpy(), dref, rtol=FP32_BWD_RTOL,
                               atol=FP32_BWD_ATOL)


def test_fp32_short_variant_limits_and_threshold():
    """The CUDA-core variant's [L, L] scores fit a CTA to L = 163 forward
    and 108 backward at head_dim 64 (`fp32_short_smem_bytes`, as
    csrc/attention.cu and attention_bwd.cu size them); FP32_SHORT_RANGES,
    set from the card's times, lie under them."""
    limit = _build.MAX_SMEM_BYTES
    size = attention_cuda.fp32_short_smem_bytes
    assert size(163, 64, False) <= limit < size(164, 64, False)
    assert size(108, 64, True) <= limit < size(109, 64, True)
    for backward, fits in ((False, 163), (True, 108)):
        for lo, hi in attention_cuda.FP32_SHORT_RANGES[backward]:
            assert 0 <= lo < hi <= fits


def test_fp32_long_layouts_fit_a_cta_whatever_l():
    """TF32X3's shared memory (csrc/f32_tile.cuh strides: head tiles
    pad8(hd) + 4 floats apart): the forward's 64 raw q rows and two ring
    stages of a split (hi, lo) FWD_KEYS-row tile; the dQ launch's raw q
    and dO and two such stages of DQ_KEYS rows; the dK / dV launch's raw
    K and V of 64 keys and two stages of QROWS query rows' split q and dO
    with 2 x QROWS statistics.  No term has L in it, every head_dim <= 128
    fits, and at ViT's 64 the CTAs the kernels' launch bounds aim at (4
    forward, 3 each backward launch) share an SM."""
    def pad8(x):
        return (x + 7) // 8 * 8

    def sizes(hd):
        row = pad8(hd) + 4
        return ((64 + 2 * 2 * FWD_KEYS) * row * 4,
                (2 * 64 + 2 * 2 * DQ_KEYS) * row * 4,
                ((2 * 64 + 2 * 4 * QROWS) * row + 2 * 2 * QROWS) * 4)
    assert sizes(64) == (52_224, 69_632, 69_888)
    assert all(max(sizes(hd)) <= _build.MAX_SMEM_BYTES
               for hd in range(1, 129))
    for size, ctas in zip(sizes(64), (4, 3, 3)):      # 1 KB reserved a CTA
        assert ctas * (size + 1024) <= 228 * 1024


# --------------------------------------------------------- hi/lo dS operands
def _bwd_emulated(qkv, dout, heads, ds_operand):
    """`attention_bwd_plain` with dS handed to the dQ and dK products as
    16-bit operands: "hilo" as the kernel does it (T(dS) + T(dS - T(dS))),
    "single" as one T(dS) (the Pallas kernel's rounding,
    attention_pallas.py:252).  Products accumulate in fp32, as mma does."""
    B, L, D3 = qkv.shape
    D = D3 // 3
    hd = D // heads
    scale = hd ** -0.5
    T = qkv.dtype

    def split_heads(x):
        return x.reshape(B, L, heads, hd).transpose(1, 2).float()
    q, k, v = qkv.split(D, dim=-1)
    qs, kf, vf = split_heads(q * scale), split_heads(k), split_heads(v)
    do = split_heads(dout)
    probs = torch.softmax(qs @ kf.transpose(-1, -2), dim=-1)
    dv = probs.to(T).float().transpose(-1, -2) @ do
    dp = do @ vf.transpose(-1, -2)
    ds = probs * (dp - (dp * probs).sum(dim=-1, keepdim=True))
    parts = [ds.to(T).float()]
    if ds_operand == "hilo":
        parts.append((ds - parts[0]).to(T).float())
    dq = sum(p @ kf for p in parts) * scale
    dk = sum(p.transpose(-1, -2) @ qs for p in parts)
    return torch.cat([g.transpose(1, 2).reshape(B, L, D) for g in (dq, dk, dv)],
                     dim=-1).to(T)


def test_hilo_ds_operands_keep_the_plain_backward():
    """At the vision tower's shape (16 samples, L = 50, 12 heads of 64, bf16)
    the hi/lo operands leave dq and dk within the card's bf16 tolerance of
    the plain version, at no more than half of it, and change at most 1 % of
    their bf16 values (0.2 % measured when this bound was set; one T(dS)
    changes about 40 %, and this test also holds that it changes more)."""
    B, L, H, hd = 16, 50, 12, 64
    D = H * hd
    g = np.random.default_rng(50)
    qkv = torch.from_numpy(g.standard_normal((B, L, 3 * D)).astype(
        np.float32)).to(torch.bfloat16)
    dout = torch.from_numpy(g.standard_normal((B, L, D)).astype(
        np.float32)).to(torch.bfloat16)
    ref, _ = attention_cuda.attention_bwd_plain(qkv, dout, H)
    shares = {}
    for operand in ("hilo", "single"):
        out = _bwd_emulated(qkv, dout, H, operand)
        # dV does not go through dS: the same arithmetic, bit for bit
        assert torch.equal(out[..., 2 * D:], ref[..., 2 * D:])
        o, r = out[..., :2 * D].float(), ref[..., :2 * D].float()
        worst = ((o - r).abs() / (BF16_ATOL + BF16_RTOL * r.abs())).max()
        shares[operand] = (o != r).float().mean().item()
        assert worst.item() <= (0.5 if operand == "hilo" else 1.0), operand
    assert shares["hilo"] <= 0.01, shares
    assert shares["hilo"] < shares["single"], shares


# ------------------------------------------------------------------ build
def _touch(path, t):
    os.utime(path, (t, t))


def test_library_freshness_follows_included_headers(tmp_path):
    src, hdr, inner = (tmp_path / n for n in ("k.cu", "h.cuh", "inner.cuh"))
    src.write_text('#include <cuda_runtime.h>\n#include "h.cuh"\n')
    hdr.write_text('#pragma once\n  #  include "inner.cuh"\n')
    inner.write_text("#pragma once\n")
    lib = tmp_path / "libk.so"
    assert not _build._is_fresh(str(src), str(lib))         # not built
    lib.write_bytes(b"")
    for p in (src, hdr, inner):
        _touch(p, 100)
    _touch(lib, 200)
    assert _build.dependencies(str(src)) == [str(src), str(hdr), str(inner)]
    assert _build._is_fresh(str(src), str(lib))
    for p in (src, hdr, inner):                              # any newer one
        _touch(p, 300)
        assert not _build._is_fresh(str(src), str(lib)), p.name
        _touch(p, 100)
    assert _build._is_fresh(str(src), str(lib))


def test_attention_sources_share_the_tile_header():
    header = os.path.join(_build.CSRC_DIR, "mma_tile.cuh")
    for name in ("attention", "attention_bwd"):
        src = os.path.join(_build.CSRC_DIR, f"{name}.cu")
        assert header in _build.dependencies(src)
