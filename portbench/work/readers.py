"""What the per-layer readers in `metrics/` share: a roofline share from
a call list and the trace, checked against the program's launch counters,
and the whole work's share of the card's peak."""
from __future__ import annotations

import sys
from typing import List, Optional

from . import counts


def roofline(ctx: dict, family: str, calls: List[tuple],
             checks: dict) -> Optional[float]:
    """100 x the calls' least time over the family's device time in the
    traced window, where the program's launches (`checks`: counter name ->
    direction, None for both) are the ones the call list makes."""
    units = ctx["units"]
    if not units or not calls:
        return None
    for counter, backward in checks.items():
        want = counts.launches(calls, backward) * units
        got = ctx["counts"].get(counter)
        if got != want:
            print(f"portbench: {family}: {got} launches of {counter}, the "
                  f"plan makes {want}; its roofline is not read",
                  file=sys.stderr)
            return None
    seconds = ctx["trace"].family_s().get(family, 0.0)
    if seconds <= 0.0:
        return None
    return 100.0 * counts.total_bound(calls, ctx["peaks"]) * units / seconds


def attention(ctx: dict, backward: bool) -> Optional[float]:
    calls = [(c, n) for c, n in counts.attention_calls(
        ctx["shapes"], ctx["batch"], ctx["training"], ctx["remat"])
        if c.backward == backward]
    return roofline(ctx, "attn_bwd" if backward else "attn_fwd", calls,
                    {"attn_bwd" if backward else "attn_fwd": None})


def layernorm(ctx: dict) -> Optional[float]:
    calls = counts.layernorm_calls(ctx["shapes"], ctx["batch"],
                                   ctx["training"], ctx["remat"],
                                   ctx["frozen_stem"])
    return roofline(ctx, "layernorm", calls,
                    {"ln_fwd": False, "ln_bwd": True})


def kmedoids(ctx: dict) -> Optional[float]:
    calls = counts.kmedoids_calls(ctx["shapes"], ctx["batch"])
    return roofline(ctx, "kmedoids", calls, {"kmedoids": None})


def mfu(ctx: dict) -> Optional[float]:
    """100 x the algorithm's matmul operations in the traced window over
    the window's seconds times the card's bf16 peak times the cards."""
    if not ctx["units"]:
        return None
    flops = counts.model_flops(ctx["shapes"], ctx["batch"],
                               ctx["training"]) * ctx["units"]
    return 100.0 * flops / (ctx["trace"].window_s * ctx["peaks"][1]
                            * ctx["chips"])


def family_ms(ctx: dict, family: str) -> Optional[float]:
    """Device ms of a family a step (or a batch)."""
    seconds = ctx["trace"].family_s().get(family, 0.0)
    if not ctx["units"] or seconds <= 0.0:
        return None
    return 1e3 * seconds / ctx["units"]
