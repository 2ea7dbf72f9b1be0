# coding=utf-8
"""Training losses (port of the JAX package's `models/losses.py`,
reference: modules/losses.py).

`cross_entropy` (CrossEn) is the loss wired into training; MIL-NCE and the
max-margin ranking loss are ported for parity with the JAX package, which
does not wire them into training either.
"""
from __future__ import annotations

import numpy as np
import torch


def cross_entropy(sim_matrix: torch.Tensor) -> torch.Tensor:
    """Symmetric-InfoNCE half: mean of -diag(log_softmax(sim)), in fp32
    (reference: losses.py:8-18)."""
    logpt = torch.log_softmax(sim_matrix.float(), dim=-1)
    return -torch.diagonal(logpt).mean()


def milnce_loss(sim_matrix: torch.Tensor, batch_size: int, n_pair: int
                ) -> torch.Tensor:
    """MIL-NCE (reference: losses.py:21-49)."""
    mm_mask = torch.from_numpy(np.kron(np.eye(batch_size),
                                       np.ones((n_pair, n_pair)))).to(
        device=sim_matrix.device, dtype=torch.float32)
    from_text = sim_matrix + mm_mask * -1e12
    from_video = sim_matrix.t()
    new_sim = torch.cat([from_video, from_text], dim=-1)
    logpt = torch.log_softmax(new_sim.float(), dim=-1)
    mask_logpt = torch.cat([mm_mask, torch.zeros_like(mm_mask)], dim=-1)
    masked = logpt + (1.0 - mask_logpt) * -1e12
    new_logpt = -torch.logsumexp(masked, dim=-1)
    mark = np.arange(batch_size) * n_pair + n_pair // 2
    return new_logpt[torch.from_numpy(mark).to(sim_matrix.device)].mean()


def max_margin_ranking_loss(sim_matrix: torch.Tensor, margin: float = 1.0,
                            negative_weighting: bool = False,
                            batch_size: int = 1, n_pair: int = 1,
                            hard_negative_rate: float = 0.5) -> torch.Tensor:
    """Max-margin ranking loss (reference: losses.py:52-80)."""
    d = torch.diagonal(sim_matrix)
    max_margin = (torch.relu(margin + sim_matrix - d[:, None])
                  + torch.relu(margin + sim_matrix - d[None, :]))
    if negative_weighting and n_pair > 1 and batch_size > 1:
        easy = 1.0 - hard_negative_rate
        alpha = easy / ((batch_size - 1) * (1.0 - easy))
        mm = (1.0 - alpha) * np.eye(batch_size) + alpha
        mm = np.kron(mm, np.ones((n_pair, n_pair))) \
            * (batch_size * (1.0 - easy))
        max_margin = max_margin * torch.from_numpy(mm).to(
            device=max_margin.device, dtype=max_margin.dtype)
    return max_margin.mean()
