# coding=utf-8
"""Transformer building blocks of the CLIP towers (port of the JAX package's
`models/layers.py`).

Numerics follow the JAX package: parameters are fp32; a linear layer casts
its input, weight and bias to the activation dtype (the JAX `Dense(dtype=...,
param_dtype=float32)`); LayerNorm computes in fp32 and returns the input's
dtype; attention logits and softmax are fp32.  Layout is [batch, tokens,
dim] throughout.  LayerNorm, the attention core and QuickGELU go through
the port's kernel wrappers, which use their plain versions on CPU tensors.

`fused` selects the attention core, as the JAX package's `fused` flag does
(`models/layers.py:58-116` there): the CLIP towers' blocks are built with
`fused=True` and run the attention kernel (A forward, B backward; on a CUDA
tensor it launches or raises).  The similarity headers' blocks (seqTransf's
`transformerClip`, the cross model) are built with `fused=False`, the JAX
block's default, and run `attention_plain` on every device: the JAX
block's own unfused path (fp32 logits and softmax), which JAX runs there
outside any Pallas kernel.  Their key-padding mask is per sample,
[B, 1, 1, L], which neither the TPU kernel nor kernel A takes (both take
one [L, L] mask).  That is a choice made when the block is built, never a
fallback from a kernel that failed.

Under tensor parallelism (`parallel.mesh.split_model`) a block holds this
rank's slices and its attention `H / tp` local heads: the packed
`[B, L, 3 D / tp]` projection goes to kernel A (or `attention_plain`) as
whole heads, and the block places the Megatron operators of
`parallel/collectives.py` around its column- and row-parallel layers,
where the JAX block's `shard_tokens` constraints put GSPMD's collectives
(`models/layers.py:152-166` there).  The row-parallel biases add after the
reduction.  With `axes.sp` the block takes and returns this rank's tokens
of the stream; LayerNorm (kernels C and D) then runs on those rows only.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..ops.attention_cuda import attention_plain, fused_attention
from ..ops.layernorm_triton import EPS, layer_norm
from ..ops.quick_gelu import quick_gelu_op
from ..parallel.collectives import (copy_to_model, gather_tokens,
                                    reduce_from_model, reduce_scatter_tokens)


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype
           ) -> torch.Tensor:
    """`layer` applied in `dtype` (operands cast, fp32 parameters kept)."""
    bias = layer.bias.to(dtype) if layer.bias is not None else None
    return nn.functional.linear(x.to(dtype), layer.weight.to(dtype), bias)


def row_parallel(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype,
                 reduce: Optional[Callable]) -> torch.Tensor:
    """`linear` of a row-parallel layer: without `reduce` the layer whole;
    with it the partial product of this rank's input features, reduced
    over the model group (`reduce`), then the bias."""
    if reduce is None:
        return linear(x, layer, dtype)
    y = nn.functional.linear(x.to(dtype), layer.weight.to(dtype))
    return reduce(y) + layer.bias.to(dtype)


def _lecun_normal_(weight: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    with torch.no_grad():
        weight.normal_(0.0, fan_in ** -0.5, generator=generator)


class LayerNormF32(nn.Module):
    """LayerNorm with fp32 statistics and parameters, output in x's dtype
    (reference: clip.py:183-189), through the port's LayerNorm kernel."""

    def __init__(self, width: int, eps: float = EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x.contiguous(), self.weight, self.bias, self.eps)


class MultiHeadAttention(nn.Module):
    """Self-attention with a packed QKV projection (`in_proj_weight` rows in
    Q, K, V order, as torch's nn.MultiheadAttention stores them), whose
    `[B, L, 3*D]` output goes straight into the attention kernel
    (`fused=True`) or into its plain version `attention_plain`
    (`fused=False`).  `heads` is the local count under tensor parallelism,
    and `reduce` the row-parallel reduction (`row_parallel`)."""

    def __init__(self, width: int, heads: int, dtype: torch.dtype,
                 fused: bool = True):
        super().__init__()
        self.heads, self.dtype, self.fused = heads, dtype, fused
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def reset_parameters(self, generator: torch.Generator) -> None:
        width = self.out_proj.in_features
        _lecun_normal_(self.in_proj_weight, width, generator)
        _lecun_normal_(self.out_proj.weight, width, generator)
        with torch.no_grad():
            self.in_proj_bias.zero_()
            self.out_proj.bias.zero_()

    def forward(self, x: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                reduce: Optional[Callable] = None) -> torch.Tensor:
        dt = self.dtype
        qkv = nn.functional.linear(x.to(dt), self.in_proj_weight.to(dt),
                                   self.in_proj_bias.to(dt))
        attend = fused_attention if self.fused else attention_plain
        return row_parallel(attend(qkv, self.heads, attn_mask),
                            self.out_proj, dt, reduce)


class MLP(nn.Module):
    """c_fc -> QuickGELU -> c_proj (reference: clip.py:207-211).  QuickGELU
    is kernel F (`ops/quick_gelu.py`) on the card, elementwise over the
    `[.., 4 * width / tp]` c_fc output whatever the block's parallelism."""

    def __init__(self, width: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in (self.c_fc, self.c_proj):
            _lecun_normal_(layer.weight, layer.in_features, generator)
            with torch.no_grad():
                layer.bias.zero_()

    def forward(self, x: torch.Tensor,
                reduce: Optional[Callable] = None) -> torch.Tensor:
        return row_parallel(quick_gelu_op(linear(x, self.c_fc, self.dtype)),
                            self.c_proj, self.dtype, reduce)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN transformer block (reference: clip.py:197-253).  A vision block
    may carry the clustering module that runs before it
    (`tokencluster_inter`, the reference's attribute name); the tower calls
    it, so the token count changes between blocks.  `fused` picks the
    attention core (module docstring); `axes` (a `parallel.mesh.Axes`, set
    by `split_model`) its tensor and sequence parallelism."""

    def __init__(self, width: int, heads: int, dtype: torch.dtype,
                 fused: bool = True):
        super().__init__()
        self.attn = MultiHeadAttention(width, heads, dtype, fused)
        self.ln_1 = LayerNormF32(width)
        self.mlp = MLP(width, dtype)
        self.ln_2 = LayerNormF32(width)
        self.tokencluster_inter: Optional[nn.Module] = None
        self.axes = None

    def forward(self, x: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                length: Optional[int] = None) -> torch.Tensor:
        """x [B, L, D] whole, or under sequence parallelism this rank's
        [B, ceil(length / tp), D] tokens of a stream of `length`."""
        axes = self.axes
        if axes is None or not axes.tp:
            x = x + self.attn(self.ln_1(x), attn_mask)
            return x + self.mlp(self.ln_2(x))
        group = axes.model_group
        if axes.sp:
            def enter(h):
                return gather_tokens(h, group, length)

            def leave(h):
                return reduce_scatter_tokens(h, group)
        else:
            def enter(h):
                return copy_to_model(h, group)

            def leave(h):
                return reduce_from_model(h, group)
        x = x + self.attn(enter(self.ln_1(x)), attn_mask, leave)
        return x + self.mlp(enter(self.ln_2(x)), leave)


def causal_mask(length: int, device=None) -> torch.Tensor:
    """Additive causal mask: -inf above the diagonal, 0 elsewhere
    (reference: clip.py:448-454)."""
    return torch.full((length, length), float("-inf"),
                      device=device).triu(1)
