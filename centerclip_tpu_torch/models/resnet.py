# coding=utf-8
"""ModifiedResNet vision tower (port of the JAX package's `models/resnet.py`;
reference: modules/clip.py:40-180).

CLIP's anti-aliased ResNet: a 3-convolution stem with an average pool,
bottleneck blocks whose stride is an average pool after the 3x3
convolution, and a QKV attention pool in place of global average pooling.
Module and state-dict names are the reference's (`layer{l}.{b}.conv1`,
`bn1.running_mean`, `downsample.0` / `downsample.1`, `attnpool.q_proj`, ...),
so OpenAI's RN50 / RN101 weights load with `load_state_dict(strict=True)`.

Support level is the JAX package's: the tower encodes.  BatchNorm is
`FrozenBatchNorm`, which normalises with its stored running statistics in
training as in evaluation and never updates them.  Everything runs in fp32
(the JAX tower ignores the compute dtype); on the card the convolutions run
with cuDNN's TF32 turned off (`centerclip_tpu_torch.set_fp32_numerics`, set
by the model builder), as the JAX package computes them in full fp32.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .layers import _lecun_normal_


class FrozenBatchNorm(nn.Module):
    """BatchNorm in its inference form: y = (x - mean) / sqrt(var + eps) *
    weight + bias over the channel axis of NCHW input.  `weight` and
    `bias` are parameters, `running_mean` and `running_var` buffers that
    nothing updates; a checkpoint's `num_batches_tracked` is dropped on
    load."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def c(t):
            return t[:, None, None]
        inv = torch.rsqrt(self.running_var + self.eps)
        return (x - c(self.running_mean)) * c(inv) * c(self.weight) \
            + c(self.bias)


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride, padding=kernel // 2,
                     bias=False)


def _pool(stride: int) -> nn.Module:
    return nn.AvgPool2d(stride) if stride > 1 else nn.Identity()


class Bottleneck(nn.Module):
    """reference: clip.py:40-83; the stride is an average pool after conv2."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.conv1, self.bn1 = _conv(inplanes, planes, 1), FrozenBatchNorm(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), FrozenBatchNorm(planes)
        self.avgpool = _pool(stride)
        self.conv3, self.bn3 = _conv(planes, out, 1), FrozenBatchNorm(out)
        self.downsample = None
        if stride > 1 or inplanes != out:
            self.downsample = nn.Sequential(OrderedDict([
                ("-1", _pool(stride)), ("0", _conv(inplanes, out, 1)),
                ("1", FrozenBatchNorm(out))]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(self.avgpool(out)))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """QKV attention pooling (reference: clip.py:86-120): the mean token
    (with the positional embedding) queries all H*W + 1 tokens, with
    separate q / k / v projections and `heads` heads, fp32 softmax."""

    def __init__(self, spatial: int, embed_dim: int, heads: int,
                 output_dim: int):
        super().__init__()
        self.heads = heads
        self.positional_embedding = nn.Parameter(
            torch.empty(spatial * spatial + 1, embed_dim))
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            C = self.positional_embedding.shape[1]
            self.positional_embedding.normal_(0.0, C ** -0.5,
                                              generator=generator)
            for layer in (self.q_proj, self.k_proj, self.v_proj, self.c_proj):
                _lecun_normal_(layer.weight, layer.in_features, generator)
                layer.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, H, W] -> [B, output_dim]."""
        B, C = x.shape[:2]
        tokens = x.flatten(2).transpose(1, 2)                  # [B, HW, C]
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding
        hd = C // self.heads

        def heads(t):
            return t.reshape(B, -1, self.heads, hd).transpose(1, 2)
        q = heads(self.q_proj(tokens[:, :1])) * hd ** -0.5
        k, v = heads(self.k_proj(tokens)), heads(self.v_proj(tokens))
        probs = (q @ k.transpose(-1, -2)).float().softmax(dim=-1)
        out = (probs.to(v.dtype) @ v).transpose(1, 2).reshape(B, C)
        return self.c_proj(out)


class ModifiedResNet(nn.Module):
    """reference: clip.py:123-180.  [B, 3, H, W] CLIP-normalised fp32
    frames -> [B, output_dim] fp32 features."""

    def __init__(self, layers: Sequence[int], output_dim: int, heads: int,
                 input_resolution: int = 224, width: int = 64):
        super().__init__()
        self.conv1, self.bn1 = _conv(3, width // 2, 3, 2), \
            FrozenBatchNorm(width // 2)
        self.conv2, self.bn2 = _conv(width // 2, width // 2, 3), \
            FrozenBatchNorm(width // 2)
        self.conv3, self.bn3 = _conv(width // 2, width, 3), \
            FrozenBatchNorm(width)
        self.avgpool = nn.AvgPool2d(2)
        inplanes = width
        for i, (blocks, stride) in enumerate(zip(layers, (1, 2, 2, 2))):
            planes = width * 2 ** i
            seq = [Bottleneck(inplanes, planes, stride)]
            inplanes = planes * Bottleneck.expansion
            seq += [Bottleneck(inplanes, planes) for _ in range(1, blocks)]
            self.add_module(f"layer{i + 1}", nn.Sequential(*seq))
        self.attnpool = AttentionPool2d(input_resolution // 32, width * 32,
                                        heads, output_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's initialisers: LeCun-normal convolutions, unit
        BatchNorms, the attention pool's own."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                _lecun_normal_(m.weight, m.weight[0].numel(), generator)
            elif isinstance(m, (FrozenBatchNorm, AttentionPool2d)):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = self.avgpool(F.relu(self.bn3(self.conv3(x))))
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return self.attnpool(x)
