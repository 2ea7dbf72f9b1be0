"""A configuration's shapes: the towers' widths and the cluster plan.

The plan is worked out here from the configuration file's own numbers, by
the rule of CenterCLIP's `modules/cluster/cluster.py:23-37`: block i
(1-based) clusters when its cluster count is above 1 and either the
frames or the cluster count shrink against block i - 1.  Each cluster
layer carries the algorithm and, for spectral clustering, its graph: the
heat kernel's sigma and the KNN graph's k, which by CenterCLIP's rule is 5
neighbours a frame of the segment (5 more where a frame holds 100 tokens
or more) unless `--spectral_knn_k` gives 5 or more.  Missing flags take
the program's CLI defaults.  No import of the program.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

ALGOS = ("kmediods++", "spectral")
GRAPHS = ("HeatKernel", "KNN")


@dataclass(frozen=True)
class Cluster:
    """The cluster layer before one vision block."""
    block: int            # 0-based index of the block it runs before
    frames_in: int        # frames a clip entering it
    frames_out: int       # segments a clip leaving it
    tokens_in: int        # patch tokens a frame entering it
    k: int                # medoids a segment leaving it
    algo: str = "kmediods++"
    graph: str = "HeatKernel"   # spectral: the affinity graph
    knn_k: int = 0        # spectral KNN: neighbours a row keeps
    sigma: float = 2.0    # spectral: the heat kernel's width

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
    stream_scale: float = 1.0   # the vision residual stream's (weights.py)

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


def knn_neighbours(dur: int, tokens_in: int, knn_k: int) -> int:
    """The KNN graph's k of a cluster layer (CenterCLIP's rule)."""
    if knn_k >= 5:
        return knn_k
    return 5 * dur if tokens_in < 100 else 5 * dur + 5


def cluster_plan(layers: int, frames: int, num_blocks: Sequence[int],
                 target_frames: Sequence[int], algo: str = "kmediods++",
                 graph: str = "HeatKernel", knn_k: int = 1,
                 sigma: float = 2.0) -> List[Optional[Cluster]]:
    tfb = [frames] + list(target_frames)
    plan: List[Optional[Cluster]] = []
    for b in range(1, layers + 1):
        k = num_blocks[b - 1]
        before_k = num_blocks[max(b - 2, 0)]
        if k > 1 and (tfb[b - 1] > tfb[b] or before_k > k):
            dur = tfb[b - 1] // tfb[b]
            plan.append(Cluster(b - 1, tfb[b - 1], tfb[b], before_k, k,
                                algo, graph,
                                knn_neighbours(dur, before_k, knn_k), sigma))
        else:
            plan.append(None)
    return plan


def cluster_algo(flags: Sequence[str]) -> dict:
    """The clustering algorithm and its graph from the flags; only those
    the reference knows, or it raises."""
    algo = _flag(flags, "--cluster_algo") or "kmediods++"
    graph = _flag(flags, "--spectral_graph") or "HeatKernel"
    if algo not in ALGOS:
        raise ValueError(f"the reference clusters by {ALGOS}, not {algo!r}")
    if algo == "spectral" and (graph not in GRAPHS or int(
            _flag(flags, "--spectral_spg") or 0)):
        raise ValueError("the reference's spectral clustering takes the "
                         f"graphs {GRAPHS} without a spatial-temporal mask")
    return {"algo": algo, "graph": graph,
            "knn_k": int(_flag(flags, "--spectral_knn_k") or 1),
            "sigma": float(_flag(flags, "--spectral_sigma") or 2.0)}


def shapes(config: dict) -> Shapes:
    """The Shapes of a configuration file's dict (its `arch`, `flags` and
    `stream_scale`, 1 where absent)."""
    a, flags = config["arch"], config["flags"]
    layers = a["vision_layers"]
    frames = int(_flag(flags, "--max_frames"))
    inter = int(_flag(flags, "--cluster_inter") or 0)
    plan: List[Optional[Cluster]] = [None] * layers
    if inter:
        plan = cluster_plan(
            layers, frames,
            [int(v) for v in _flag(flags, "--cluster_num_blocks", 0)],
            [int(v) for v in _flag(flags, "--target_frames_blocks", 0)],
            **cluster_algo(flags))
    return Shapes(
        width=a["vision_width"], layers=layers, heads=a["vision_heads"],
        patch=a["vision_patch_size"], resolution=a["image_resolution"],
        embed=a["embed_dim"], text_width=a["transformer_width"],
        text_layers=a["transformer_layers"],
        text_heads=a["transformer_heads"], vocab=a["vocab_size"],
        context=a["context_length"],
        words=int(_flag(flags, "--max_words")), frames=frames, plan=plan,
        iter_limit=int(_flag(flags, "--cluster_iter_limit") or 100),
        stream_scale=float(config.get("stream_scale", 1.0)))
