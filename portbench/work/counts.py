"""Operations and bytes of a step or an encode, from a configuration's
shapes (`plan.Shapes`) alone.

* `model_flops`: the algorithm's matmul operations a clip: the patch
  embedding, each vision block's QKV, Q.K^T, P.V, output projection and
  MLP at the tokens the cluster plan leaves it, the clustering distances
  (one [N, N] Gram matrix a segment over the tokens; spectral clustering
  adds k-medoids' over the K-wide embedding, and its eigensolve, an
  iterative method with no least work, is not counted), ln_post's
  projection, the text tower
  (causal attention counted on the pairs it needs), and the similarity
  matrix's share.  A training step counts three times the forward (the
  backward twice) for everything that has a gradient; the patch embedding
  (frozen, on pixel data) and the clustering distances (no gradient) once.
  Recomputation under `--remat` is not counted.
* `attention_calls`, `layernorm_calls`, `kmedoids_calls`: the list of
  kernel calls that the plan fixes, each with its least time on the card
  (`peaks.bound`), and how many launches of each kernel that list makes
  (checked against the program's launch counters).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from .peaks import (bound, kmedoids_bound, layernorm_bwd_bound,
                    layernorm_fwd_bound)
from .plan import Shapes


def _block_flops(tokens: int, width: int, causal: bool = False) -> float:
    pairs = tokens * (tokens + 1) / 2 if causal else tokens * tokens
    return 24.0 * tokens * width * width + 4.0 * pairs * width


def vision_flops(s: Shapes) -> Dict[str, float]:
    """Forward matmul operations of one clip's vision tower, by part."""
    patch = 2.0 * s.patches * 3 * s.patch * s.patch * s.width * s.frames
    blocks = sum(frames * _block_flops(tokens, s.width)
                 for frames, tokens in s.stream())
    dist = sum(spec.frames_out * 2.0 * spec.n * spec.n * s.width
               for spec in s.plan if spec is not None)
    dist += sum(spec.frames_out * 2.0 * spec.n * spec.n * spec.k
                for spec in s.plan
                if spec is not None and spec.algo == "spectral")
    head = 2.0 * s.width * s.embed * s.final_frames
    return {"patch": patch, "blocks": blocks, "distances": dist,
            "head": head}


def text_flops(s: Shapes) -> float:
    """Forward matmul operations of one caption's text tower."""
    return (s.text_layers * _block_flops(s.words, s.text_width, causal=True)
            + 2.0 * s.text_width * s.embed)


def model_flops(s: Shapes, batch: int, training: bool) -> float:
    """The algorithm's matmul operations of one step (training: forward,
    backward and the loss over `batch` pairs) or of encoding `batch`
    clips (forward of the vision tower and the pooling)."""
    v = vision_flops(s)
    if not training:
        return batch * sum(v.values())
    grad = v["blocks"] + v["head"] + text_flops(s) + 2.0 * batch * s.embed
    return batch * (3.0 * grad + v["patch"] + v["distances"])


@dataclass(frozen=True)
class AttentionCall:
    items: int
    length: int
    heads: int
    head_dim: int
    causal: bool
    backward: bool
    lse: bool            # the forward writes the rows' log-sum-exp
    elem: int = 2

    def flops(self) -> float:
        L = self.length
        pairs = L * (L + 1) / 2 if self.causal else L * L
        per = 10.0 if self.backward else 4.0
        return per * self.items * self.heads * pairs * self.head_dim

    def bytes(self) -> float:
        tok = self.items * self.length * self.heads * self.head_dim
        stats = 4.0 * self.items * self.heads * self.length
        if self.backward:
            # q, k, v, o, dO and the log-sum-exp read; dq, dk, dv written
            return 8.0 * tok * self.elem + stats
        return 4.0 * tok * self.elem + (stats if self.lse else 0.0)

    def bound(self, peaks) -> float:
        mem_rate, bf16_peak, _ = peaks
        return bound(self.bytes(), self.flops(), bf16_peak, mem_rate)


def attention_calls(s: Shapes, batch: int, training: bool, remat: bool
                    ) -> List[tuple]:
    """[(AttentionCall, launches)] of one step or encode of `batch`."""
    out = []
    fwd = 2 if (training and remat) else 1
    hd = s.width // s.heads
    for frames, tokens in s.stream():
        items = batch * frames
        out.append((AttentionCall(items, tokens, s.heads, hd, False, False,
                                  training), fwd))
        if training:
            out.append((AttentionCall(items, tokens, s.heads, hd, False,
                                      True, True), 1))
    if training:
        thd = s.text_width // s.text_heads
        for _ in range(s.text_layers):
            out.append((AttentionCall(batch, s.words, s.text_heads, thd, True,
                                      False, True), fwd))
            out.append((AttentionCall(batch, s.words, s.text_heads, thd, True,
                                      True, True), 1))
    return out


@dataclass(frozen=True)
class LayerNormCall:
    rows: int
    width: int
    backward: bool
    elem: int = 2

    def bound(self, peaks) -> float:
        f = layernorm_bwd_bound if self.backward else layernorm_fwd_bound
        return f(self.rows, self.width, self.elem, peaks)


def layernorm_calls(s: Shapes, batch: int, training: bool, remat: bool,
                    frozen_stem: bool = True) -> List[tuple]:
    """[(LayerNormCall, launches)] of one step or encode.  ln_pre has no
    backward where the stem is frozen (`--freeze_layer_num` >= 0): its
    parameters take no gradient and its input is pixel data."""
    out = []
    fwd = 2 if (training and remat) else 1
    out.append((LayerNormCall(batch * s.frames * (s.patches + 1), s.width,
                              False), 1))
    if training and not frozen_stem:
        out.append((LayerNormCall(batch * s.frames * (s.patches + 1),
                                  s.width, True), 1))
    for frames, tokens in s.stream():
        rows = batch * frames * tokens
        out.append((LayerNormCall(rows, s.width, False), 2 * fwd))
        if training:
            out.append((LayerNormCall(rows, s.width, True), 2))
    post = batch * s.final_frames
    out.append((LayerNormCall(post, s.width, False), 1))
    if training:
        out.append((LayerNormCall(post, s.width, True), 1))
        rows = batch * s.words
        out.append((LayerNormCall(rows, s.text_width, False),
                    2 * fwd * s.text_layers + 1))
        out.append((LayerNormCall(rows, s.text_width, True),
                    2 * s.text_layers + 1))
    return out


@dataclass(frozen=True)
class KMedoidsCall:
    segments: int
    n: int
    k: int

    def bound(self, peaks) -> float:
        return kmedoids_bound(self.segments, self.n, self.k, peaks)


def kmedoids_calls(s: Shapes, batch: int) -> List[tuple]:
    """[(KMedoidsCall, launches)] of one forward (the cluster layers run
    outside the recomputed blocks, so once under `--remat` too)."""
    return [(KMedoidsCall(batch * spec.frames_out, spec.n, spec.k), 1)
            for spec in s.plan if spec is not None]


def launches(calls: List[tuple], backward: bool = None) -> int:
    """Launches of a call list, of one direction where `backward` is set."""
    return sum(n for c, n in calls
               if backward is None or getattr(c, "backward") == backward)


def total_bound(calls: List[tuple], peaks) -> float:
    """Seconds: the calls' least times, summed."""
    return sum(c.bound(peaks) * n for c, n in calls)
