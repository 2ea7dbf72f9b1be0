# coding=utf-8
"""Seeding, parameter counts and dtype conversions (port of the JAX
package's `utils/misc.py`; reference: utils/misc.py:49-65)."""
from __future__ import annotations

import random

import numpy as np
import torch
from torch import nn


def set_random_seed(seed: int, device=None) -> torch.Generator:
    """Seed Python's and numpy's global generators and return a
    `torch.Generator` on `device` (default the CPU) seeded with `seed`: the
    counterpart of the JAX package's root PRNG key, handed to whatever
    draws, rather than torch's global generator being seeded."""
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator(device=device or "cpu").manual_seed(seed)


def count_params(module: nn.Module) -> int:
    """Number of parameter elements of `module` (buffers not counted)."""
    return sum(p.numel() for p in module.parameters())


def count_params_million(module: nn.Module) -> float:
    return count_params(module) / 1e6


def _convert_floating(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    for t in list(module.parameters()) + list(module.buffers()):
        if t.is_floating_point():
            t.data = t.data.to(dtype)
    return module


def convert_params_to_fp32(module: nn.Module) -> nn.Module:
    """Every floating parameter and buffer of `module` to fp32, in place
    (integer buffers are kept)."""
    return _convert_floating(module, torch.float32)


def convert_params_to_bf16(module: nn.Module) -> nn.Module:
    """Every floating parameter and buffer of `module` to bf16, in place."""
    return _convert_floating(module, torch.bfloat16)
