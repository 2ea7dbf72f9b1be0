# coding=utf-8
"""Temporal and token shift baselines (port of the JAX package's
`ops/shift.py`; reference: modules/cluster/shift.py).

Channel-shift tricks of TSM / ActionCLIP and TokShift: a 1/fold_div slice
of the channels moves one frame back in time, the next slice one frame
forward, the rest stays.  Pure data movement: the result equals the JAX
package's to the bit, in any dtype.
"""
from __future__ import annotations

import torch


def _shift_frames(x: torch.Tensor, fold: int) -> torch.Tensor:
    """x [B, T, ..., C]: out[:, t, ..., :fold] = x[:, t+1, ..., :fold],
    out[:, t, ..., fold:2fold] = x[:, t-1, ..., fold:2fold] (zeros past the
    ends), the other channels as they are."""
    zeros = torch.zeros_like(x[:, :1])
    left = torch.cat([x[:, 1:], zeros], dim=1)[..., :fold]
    right = torch.cat([zeros, x[:, :-1]], dim=1)[..., fold:2 * fold]
    return torch.cat([left, right, x[..., 2 * fold:]], dim=-1)


def temporal_shift_wo_cls(x: torch.Tensor, n_segment: int,
                          fold_div: int = 8) -> torch.Tensor:
    """Shift every non-CLS token's channels in time (shift.py:15-36).
    x: [B*T, L, C] tokens, CLS at position 0; n_segment = T."""
    nt, hw, c = x.shape
    body = x[:, 1:, :].reshape(nt // n_segment, n_segment, hw - 1, c)
    out = _shift_frames(body, c // fold_div).reshape(nt, hw - 1, c)
    return torch.cat([x[:, 0:1, :], out], dim=1)


def token_shift(x: torch.Tensor, n_segment: int, fold_div: int = 8
                ) -> torch.Tensor:
    """TokShift: the same exchange for the CLS token only
    (shift.py:39-61).  x: [B*T, N, C]; n_segment = T."""
    bt, n, c = x.shape
    xr = x.reshape(bt // n_segment, n_segment, n, c)
    new_cls = _shift_frames(xr[:, :, 0, :], c // fold_div)
    out = torch.cat([new_cls[:, :, None, :], xr[:, :, 1:, :]], dim=2)
    return out.reshape(bt, n, c)
