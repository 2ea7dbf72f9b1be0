# coding=utf-8
"""Transformer building blocks of the CLIP towers (port of the JAX package's
`models/layers.py`).

Numerics follow the JAX package: parameters are fp32; a linear layer casts
its input, weight and bias to the activation dtype (the JAX `Dense(dtype=...,
param_dtype=float32)`); LayerNorm computes in fp32 and returns the input's
dtype; attention logits and softmax are fp32.  Layout is [batch, tokens,
dim] throughout.  LayerNorm and the attention core go through the port's
kernel wrappers, which use their plain versions on CPU tensors.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.attention_cuda import fused_attention
from ..ops.layernorm_triton import EPS, layer_norm


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype
           ) -> torch.Tensor:
    """`layer` applied in `dtype` (operands cast, fp32 parameters kept)."""
    bias = layer.bias.to(dtype) if layer.bias is not None else None
    return nn.functional.linear(x.to(dtype), layer.weight.to(dtype), bias)


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
    `[B, L, 3*D]` output goes straight into the attention kernel."""

    def __init__(self, width: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.heads, self.dtype = heads, dtype
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
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.dtype
        qkv = nn.functional.linear(x.to(dt), self.in_proj_weight.to(dt),
                                   self.in_proj_bias.to(dt))
        out = fused_attention(qkv, self.heads, attn_mask)
        return linear(out, self.out_proj, dt)


class MLP(nn.Module):
    """c_fc -> QuickGELU -> c_proj (reference: clip.py:207-211)."""

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(quick_gelu(linear(x, self.c_fc, self.dtype)),
                      self.c_proj, self.dtype)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN transformer block (reference: clip.py:197-253).  A vision block
    may carry the clustering module that runs before it
    (`tokencluster_inter`, the reference's attribute name); the tower calls
    it, so the token count changes between blocks."""

    def __init__(self, width: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.attn = MultiHeadAttention(width, heads, dtype)
        self.ln_1 = LayerNormF32(width)
        self.mlp = MLP(width, dtype)
        self.ln_2 = LayerNormF32(width)
        self.tokencluster_inter: Optional[nn.Module] = None

    def forward(self, x: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), attn_mask)
        return x + self.mlp(self.ln_2(x))


def causal_mask(length: int, device=None) -> torch.Tensor:
    """Additive causal mask: -inf above the diagonal, 0 elsewhere
    (reference: clip.py:448-454)."""
    return torch.full((length, length), float("-inf"),
                      device=device).triu(1)
