"""A configuration's shapes: the towers' widths and the cluster plan.

The plan is worked out here from the configuration file's own numbers, by
the rule of CenterCLIP's `modules/cluster/cluster.py:23-37`: block i
(1-based) clusters when its cluster count is above 1 and either the
frames or the cluster count shrink against block i - 1.  No import of
the program.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence


@dataclass(frozen=True)
class Cluster:
    """The cluster layer before one vision block."""
    block: int            # 0-based index of the block it runs before
    frames_in: int        # frames a clip entering it
    frames_out: int       # segments a clip leaving it
    tokens_in: int        # patch tokens a frame entering it
    k: int                # medoids a segment leaving it

    @property
    def dur(self) -> int:
        return self.frames_in // self.frames_out

    @property
    def n(self) -> int:
        """Tokens a segment clusters."""
        return self.dur * self.tokens_in


@dataclass(frozen=True)
class Shapes:
    width: int            # vision width
    layers: int
    heads: int
    patch: int
    resolution: int
    embed: int
    text_width: int
    text_layers: int
    text_heads: int
    vocab: int
    context: int
    words: int            # --max_words
    frames: int           # --max_frames
    plan: Sequence[Optional[Cluster]]
    iter_limit: int = 100

    @property
    def patches(self) -> int:
        return (self.resolution // self.patch) ** 2

    def stream(self) -> List[tuple]:
        """(frames a clip, tokens a frame incl. CLS) of each vision block."""
        out, frames, tokens = [], self.frames, self.patches
        for spec in self.plan:
            if spec is not None:
                frames, tokens = spec.frames_out, spec.k
            out.append((frames, tokens + 1))
        return out

    @property
    def final_frames(self) -> int:
        return self.stream()[-1][0]


def _flag(flags: Sequence[str], name: str, count: int = 1):
    """The value(s) after `--name` in a flag list, or None."""
    if name not in flags:
        return None
    i = flags.index(name) + 1
    vals = []
    while i < len(flags) and not flags[i].startswith("--"):
        vals.append(flags[i])
        i += 1
    return vals if count != 1 else vals[0]


def cluster_plan(layers: int, frames: int, num_blocks: Sequence[int],
                 target_frames: Sequence[int]) -> List[Optional[Cluster]]:
    tfb = [frames] + list(target_frames)
    plan: List[Optional[Cluster]] = []
    for b in range(1, layers + 1):
        k = num_blocks[b - 1]
        before_k = num_blocks[max(b - 2, 0)]
        if k > 1 and (tfb[b - 1] > tfb[b] or before_k > k):
            plan.append(Cluster(b - 1, tfb[b - 1], tfb[b], before_k, k))
        else:
            plan.append(None)
    return plan


def shapes(config: dict) -> Shapes:
    """The Shapes of a configuration file's dict (its `arch` and `flags`)."""
    a, flags = config["arch"], config["flags"]
    layers = a["vision_layers"]
    frames = int(_flag(flags, "--max_frames"))
    inter = int(_flag(flags, "--cluster_inter") or 0)
    plan: List[Optional[Cluster]] = [None] * layers
    if inter:
        plan = cluster_plan(
            layers, frames,
            [int(v) for v in _flag(flags, "--cluster_num_blocks", 0)],
            [int(v) for v in _flag(flags, "--target_frames_blocks", 0)])
    return Shapes(
        width=a["vision_width"], layers=layers, heads=a["vision_heads"],
        patch=a["vision_patch_size"], resolution=a["image_resolution"],
        embed=a["embed_dim"], text_width=a["transformer_width"],
        text_layers=a["transformer_layers"],
        text_heads=a["transformer_heads"], vocab=a["vocab_size"],
        context=a["context_length"],
        words=int(_flag(flags, "--max_words")), frames=frames, plan=plan,
        iter_limit=int(_flag(flags, "--cluster_iter_limit") or 100))
