"""The numbers that decide `correct`, each against its limit in
`limits/<cell>.json`.

Training (the first three steps of the object the window drives, against
the reference's three steps from the same weights on the same batches):

* `loss_gap`: the largest relative gap of a step's loss;
* `grad_gap`: over the trainable leaves (the packed q, k, v projections
  as three, `reference.model.parts`), the largest gap between the norm
  of the program's first clipped gradient (its Adam first moment after
  one step over 1 - beta1) and the reference's, over the reference's norm
  of that leaf or of the median leaf, whichever is larger;
* `update_gap`: the same of the norm of each leaf's change after the
  three steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a leaf whose gradient is nought to
  rounding moves under Adam by round-off alone);
* `text_grad_gap_median`, `text_update_gap_median`: the median of the
  same gaps over the text tower's leaves.  The worst leaf is a query or
  key projection of a vision block after the cluster layer: with K near
  N / 2 most clusters hold two tokens, whose medoid is decided by
  rounding, so the bf16 and fp32 streams pick other medoids in every
  segment, and every vision leaf's gradient moves with them (PERF.md, the
  look).  The text tower does not pass through the cluster layer; its
  median leaf is steady from seed to seed, and it is the number that a
  precision below the program's (the fp8 control) fails;
* `vision_update_gap_median`: the median of the change's gaps over the
  vision tower's leaves, which the fp8 control confined to the vision
  tower fails: attention A and B, LayerNorm C and D, the cluster layer
  and the remat recompute are the vision tower's;
* `data_rows_wrong` (from `synth.wrong_rows`, not here): the rows of the
  three batches whose frames are not a clip of the data set, or whose
  caption is not one of that clip's; limit 0.

Encode: `vec_gap`, the largest distance between a gallery vector that a
pass of the window produced and the reference's vector of that clip
(both of unit length), over every pass and clip.
"""
from __future__ import annotations

import math
from statistics import median
from typing import Dict, Sequence

import numpy as np

MOVED = 1e-3


def _gaps(prog: Dict[str, float], ref: Dict[str, float],
          keys: Sequence[str]) -> list:
    """Each leaf's gap of norms over the reference's norm of that leaf or
    of the median leaf, whichever is larger ([inf] where the leaves
    differ)."""
    if set(prog) != set(ref) or not keys:
        return [math.inf]
    floor = median(ref[k] for k in ref)
    return [abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30) for k in keys]


def text_leaf(name: str) -> bool:
    """A leaf of the text tower."""
    return name.startswith(("clip.transformer.", "clip.ln_final.",
                            "clip.text_projection"))


def vision_leaf(name: str) -> bool:
    """A leaf of the vision tower."""
    return name.startswith("clip.visual.")


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """prog and ref: {losses: [...], grad: {leaf: norm}, change: {leaf:
    norm}}."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                   ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]) or not losses:
        losses = [math.inf]
    g = ref["grad"]
    floor = median(g.values()) if g else 0.0
    moved = [k for k in g if g[k] >= MOVED * floor]
    text = [k for k in g if text_leaf(k)]
    return {"loss_gap": max(losses),
            "grad_gap": max(_gaps(prog["grad"], g, list(g))),
            "update_gap": max(_gaps(prog["change"], ref["change"], moved)),
            "text_grad_gap_median": median(_gaps(prog["grad"], g, text)),
            "text_update_gap_median": median(_gaps(
                prog["change"], ref["change"], [k for k in moved
                                                if text_leaf(k)])),
            "vision_update_gap_median": median(_gaps(
                prog["change"], ref["change"], [k for k in moved
                                                if vision_leaf(k)]))}


def encode_numbers(passes: Sequence[np.ndarray],
                   ref: np.ndarray) -> Dict[str, float]:
    if not passes:
        return {"vec_gap": math.inf}
    gap = 0.0
    for p in passes:
        if p.shape != ref.shape:
            return {"vec_gap": math.inf}
        d = np.linalg.norm(p.astype(np.float64) - ref, axis=1)
        gap = max(gap, float(np.max(d)) if np.all(np.isfinite(d))
                  else math.inf)
    return {"vec_gap": gap}
