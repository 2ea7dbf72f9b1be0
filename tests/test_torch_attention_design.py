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
- The build's freshness rule: a library is rebuilt when its source or any
  header the source includes is newer.
"""
import os

import numpy as np
import pytest
import torch

from centerclip_tpu_torch.ops import _build, attention_cuda
from centerclip_tpu_torch.ops.attention_cuda import (CUDA_CORE, TENSOR_CORE,
                                                     TENSOR_CORE_LONG,
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
    (torch.float16, 64, 256, True, TENSOR_CORE_LONG),     # the long limit
    (torch.float32, 64, 50, False, CUDA_CORE),
    (torch.float32, 40, 197, True, CUDA_CORE),        # fp32: any head_dim
])
def test_choose_variant(dtype, hd, L, backward, expected):
    assert choose_variant(dtype, hd, L, backward) == expected


@pytest.mark.parametrize("dtype,hd,L,backward", [
    (torch.bfloat16, 64, 257, True),      # backward beyond 256 keys
    (torch.float16, 64, 1024, True),
    (torch.bfloat16, 40, 50, False),      # head_dim not a multiple of 16
    (torch.float16, 72, 32, True),
    (torch.float64, 64, 50, False),       # no float64 kernel
    (torch.bfloat16, 64, 0, False),       # empty sequence
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
