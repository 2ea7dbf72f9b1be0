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
  caption is not one of that clip's; limit 0;
* `pre_cluster_update_gap_median`, where the plan clusters spectrally: the
  median of the change's gaps over the leaves of the vision blocks before
  the first cluster layer.  Spectral clustering's k-medoids starts at the
  embedding row of largest norm, and the rows are normalised to norm
  1 - 1e-6 / |row|, so rounding picks the start: the bf16 and fp32 streams
  keep other medoids in every segment (PERF.md, the look), and every leaf
  whose gradient passes the tokens after the cluster layer carries that.
  The blocks before it see the same tokens on both sides; their median
  leaf's change is what the fp8 control fails;
* `identity_segments`, where the plan clusters spectrally: the segments
  of step 1's batch whose heat-kernel affinity at the first cluster layer
  has no entry off the diagonal above 1e-6 in the reference
  (`reference/spectral.py`), where spectral clustering has nothing to
  work on; limit 0;
* `cluster_cost_excess`, where the plan clusters spectrally: the
  program's medoid ids of step 1's first cluster layer scored in the
  reference's fp32 spectral embedding of the same segments, their
  k-medoids cost over that of the reference's own ids, less 1.  It reads
  the layer itself (affinity, KNN graph, L_sym, the eigensolve, the
  k-medoids on the embedding), not which of two near-equal medoid sets
  rounding drew: a solve at the wrong end of the spectrum, a graph
  without its KNN cut, or medoids drawn at random cost more.

Encode: `vec_gap`, the largest distance between a gallery vector that a
pass of the window produced and the reference's vector of that clip
(both of unit length), over every pass and clip.
"""
from __future__ import annotations

import math
from statistics import median
from typing import Dict, Optional, Sequence

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


def vision_block(name: str) -> int:
    """The index of a vision block's leaf, else -1."""
    parts = name.split(".")
    if name.startswith("clip.visual.transformer.resblocks."):
        return int(parts[4])
    return -1


def spectral_before(shapes) -> Optional[int]:
    """The block before which the plan first clusters spectrally, or
    None."""
    return next((p.block for p in shapes.plan
                 if p is not None and p.algo == "spectral"), None)


def train_numbers(prog: dict, ref: dict,
                  before: Optional[int] = None) -> Dict[str, float]:
    """prog and ref: {losses: [...], grad: {leaf: norm}, change: {leaf:
    norm}}; `before`: the first spectral cluster layer's block
    (`spectral_before`), which adds `pre_cluster_update_gap_median`."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                   ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]) or not losses:
        losses = [math.inf]
    g = ref["grad"]
    floor = median(g.values()) if g else 0.0
    moved = [k for k in g if g[k] >= MOVED * floor]
    text = [k for k in g if text_leaf(k)]
    extra = {}
    if before is not None:
        extra["pre_cluster_update_gap_median"] = median(_gaps(
            prog["change"], ref["change"],
            [k for k in moved if 0 <= vision_block(k) < before]))
    return {"loss_gap": max(losses),
            "grad_gap": max(_gaps(prog["grad"], g, list(g))),
            "update_gap": max(_gaps(prog["change"], ref["change"], moved)),
            "text_grad_gap_median": median(_gaps(prog["grad"], g, text)),
            "text_update_gap_median": median(_gaps(
                prog["change"], ref["change"], [k for k in moved
                                                if text_leaf(k)])),
            "vision_update_gap_median": median(_gaps(
                prog["change"], ref["change"], [k for k in moved
                                                if vision_leaf(k)])),
            **extra}


def cluster_numbers(layer: dict) -> Dict[str, float]:
    """The spectral cluster layer's numbers from `TrainSetUp.cluster_layer`'s
    readings."""
    return {"identity_segments": layer["identity_segments"],
            "cluster_cost_excess": layer["cost_excess"]}


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
