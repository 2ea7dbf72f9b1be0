# coding=utf-8
"""Batched k-medoids: a CUDA C++ kernel, with `ops/kmedoids.py` as its plain
version.

Replaces the TPU kernel `centerclip_tpu/ops/kmedoids_pallas.py`
(`_kmedoids_kernel` / `kmedoids_from_distances`, entry
`batch_fast_kmedoids_pallas`).  The kernel, `csrc/kmedoids.cu`, runs one
CTA (or, past N = 512, one thread-block cluster) per segment for KKZ
seeding, every Lloyd step, the id sort and the last assignment.  It is
latency-bound: the steps are a chain of small dependent reductions and
reads, which the design keeps short.  The TPU kernel's
one-hot matmul is replaced by each candidate's sum over its own cluster's
members.  The distance matrix is computed outside the kernel by
`ops/distances.py`, a plain fp32 matmul.

Four variants of that one algorithm, picked by `choose_variant` from N
(and K), that give the same bits on the same distances: SHARED (N <=
SHARED_MAX_N) copies the segment's `[N, N]` matrix into shared memory
once (one bulk asynchronous copy when N is even), runs KKZ in one warp
with no block barrier, and Lloyd steps of three barriers on member lists
built without atomics; GLOBAL (N <= GLOBAL_MAX_N, e.g. ViT-B/16's N = 392)
reads it from device memory and so reads only what changed: KKZ over the
whole CTA also yields the first assignment, a Lloyd step compares each
point with the medoids that moved only (all K where its own medoid
moved), and sums run only for clusters whose members changed; CLUSTER
(past GLOBAL_MAX_N wherever a cluster of at most 16 CTAs holds the
segment: ViT-B/16's segments of 3, 4 and 20 frames, N = 588, 784 and
3920, and whole clips, N = 2352, at any K there) runs GLOBAL's steps on a
thread-block cluster a segment, `cluster_size` CTAs (1-16, the largest at
which the card holds every segment's cluster at once, from
`cudaOccupancyMaxActiveClusters`): each CTA owns a range of 32-point
chunks, KKZ agrees on each pick by one cluster barrier, the points whose
medoid moved are scanned by any warp, and each dirty cluster's blocks of
32 candidates are summed by the warps of the whole cluster, loads in
flight and adds in ascending member order, from member lists every CTA
assembles over distributed shared memory; SCRATCH (past that, e.g.
N = K = 3920) runs GLOBAL's steps with the member masks, and where shared
memory cannot hold it the per-point state too, in a device-memory scratch
a segment that the wrapper allocates from PyTorch's caching allocator.
On an H100 CLUSTER took 0.70-0.94x the time of the one-CTA variants it
replaced (an earlier "large" one and SCRATCH) at ViT-B/16's 3- and 4-frame
segments and 0.10-0.21x at its 20-frame segments and whole clips
(PERF.md).

`kmedoids` takes the plain version for CPU tensors only.  A CUDA tensor
launches the kernel or raises ValueError: only N past MAX_N (whose member
masks 32-bit indices cannot address) does, besides malformed inputs; a
scratch the card cannot hold raises PyTorch's out-of-memory error.
`kmedoids_from_distances.launches` counts launches, and `.variant_launches`
counts them by variant.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import _build
from .kmedoids import batch_fast_kmedoids, kmedoids_inputs

SHARED, GLOBAL, CLUSTER, SCRATCH = "shared", "global", "cluster", "scratch"
VARIANTS = (SHARED, GLOBAL, CLUSTER, SCRATCH)
# the largest N whose [N, N] fp32 matrix, sums, assignment, medoids and
# member masks fit in one CTA's 227 KB of shared memory at any K <= N
SHARED_MAX_N = 235
GLOBAL_MAX_N = 512             # 16 chunks of 32 points, 2 a thread
# the largest N at which the member masks of any K <= N, K * ceil(N / 32)
# words, are indexed by 32-bit ints (D itself takes 64-bit offsets): the
# scratch variant's limit, far past what the card's memory holds of D
MAX_N = 262_143
# the cluster variant: CTAs a segment (past 8 a non-portable cluster
# size) and its static shared memory (the argmax slots, scan partials and
# two counters) bounded
CLUSTER_SIZES = (1, 2, 4, 8, 16)
CLUSTER_STATIC_SMEM = 2304
# K the router assumes where it is not given: ViT-B/16's 2 x 196
DEFAULT_K = 392
_ENTRIES = {SHARED: ("cc_kmedoids", "cc_kmedoids_smem_bytes"),
            GLOBAL: ("cc_kmedoids_global", "cc_kmedoids_global_smem_bytes"),
            CLUSTER: ("cc_kmedoids_cluster", None),
            SCRATCH: ("cc_kmedoids_scratch", "cc_kmedoids_scratch_smem_bytes")}
# the largest N each variant's entry takes (`variant=` may force one below
# the range `choose_variant` gives it; the shared one then still needs its
# shared memory)
_MAX_N = {SHARED: 256, GLOBAL: GLOBAL_MAX_N, CLUSTER: MAX_N,
          SCRATCH: MAX_N}


def cluster_smem_bytes(N: int, K: int, cs: int) -> int:
    """Dynamic shared memory of one CTA of the cluster variant at `cs` CTAs
    a segment, as `cluster_smem_bytes` in csrc/kmedoids.cu computes it: a
    CTA owns at most P = 32 ceil(ceil(N / 32) / cs) points; ceil(N / 32) +
    K blocks' minima (8 bytes each); best, assignment and a point list
    [P]; the own chunks' member masks [K, P / 32]; the member lists [N];
    six K lists and K + 1 block starts (4 bytes each); then P + K bytes
    rounded up to words."""
    nc = -(-N // 32)
    ncr = -(-nc // cs)
    P = 32 * ncr
    return (8 * (nc + K) + 4 * (3 * P + K * ncr + N + 7 * K + 1)
            + (P + K + 3) // 4 * 4)


def cluster_fits(N: int, K: int, cs: int) -> bool:
    """Whether `cs` CTAs can hold a segment of N points into K clusters:
    each owns at least one 32-point chunk, and one CTA's shared memory
    (dynamic and static) is within the opt-in limit."""
    return cs <= -(-N // 32) and cluster_smem_bytes(N, K, cs) \
        + CLUSTER_STATIC_SMEM <= _build.MAX_SMEM_BYTES


def cluster_size(B: int, N: int, K: int, resident: Dict[int, int]) -> int:
    """CTAs a segment of the cluster variant for B segments of N points
    into K clusters, where `resident` maps a size to the clusters the card
    holds at once (`resident_clusters`, from
    `cudaOccupancyMaxActiveClusters`, which knows how the card groups its
    SMs): the largest size in CLUSTER_SIZES that holds the segment and
    keeps all B clusters resident at once, so that few segments still
    spread over the card (48 segments of 3920 points, K = 160: 8 CTAs each
    on an H100) while many keep one CTA each; where no size keeps them
    resident, the size with the most CTAs resident (the smallest of
    those); 0 where none holds the segment."""
    fits = [cs for cs in CLUSTER_SIZES if cluster_fits(N, K, cs)
            and resident.get(cs, 0) > 0]
    for cs in reversed(fits):
        if B <= resident[cs]:
            return cs
    return max(fits, key=lambda cs: (resident[cs] * cs, -cs), default=0)


def choose_variant(N: int, K: Optional[int] = None) -> str:
    """The kernel variant for N points per segment into K clusters: SHARED
    up to SHARED_MAX_N, GLOBAL up to GLOBAL_MAX_N, CLUSTER past that where
    a cluster of at most 16 CTAs holds the segment (K None: DEFAULT_K),
    SCRATCH past that up to MAX_N; ValueError past MAX_N."""
    if N < 1 or N > MAX_N:
        raise ValueError(f"the k-medoids kernel takes 1 <= N <= {MAX_N}; "
                         f"got N={N}")
    if N <= SHARED_MAX_N:
        return SHARED
    if N <= GLOBAL_MAX_N:
        return GLOBAL
    K = min(N, DEFAULT_K) if K is None else K
    if any(cluster_fits(N, K, cs) for cs in CLUSTER_SIZES):
        return CLUSTER
    return SCRATCH


_RESIDENT: Dict[Tuple[int, int, int], Dict[int, int]] = {}


def resident_clusters(device: torch.device, N: int, K: int
                      ) -> Dict[int, int]:
    """{CTAs a segment: clusters of the cluster variant the card holds at
    once} at (N, K), for each size that holds the segment, from the card
    (`cc_kmedoids_cluster_max_active`); cached.  A query the card refuses
    raises RuntimeError with its CUDA error."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if (index, N, K) not in _RESIDENT:
        lib = _build.load("kmedoids")
        fn = lib.cc_kmedoids_cluster_max_active
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 3
        resident = {}
        with torch.cuda.device(index):
            for cs in CLUSTER_SIZES:
                if not cluster_fits(N, K, cs):
                    continue
                n = fn(N, K, cs)
                if n < 0:
                    raise RuntimeError(
                        f"k-medoids cluster variant at N={N}, K={K}, {cs} "
                        f"CTAs a segment: cudaOccupancyMaxActiveClusters "
                        f"failed with CUDA error {-n} "
                        f"({_build.error_string(lib, -n)})")
                resident[cs] = n
        _RESIDENT[index, N, K] = resident
    return _RESIDENT[index, N, K]


def device_cluster_size(device: torch.device, B: int, N: int, K: int) -> int:
    """`cluster_size` on the card `device`, with the clusters it holds."""
    return cluster_size(B, N, K, resident_clusters(device, N, K))


def kmedoids_from_distances(D: torch.Tensor, l2: torch.Tensor, K: int,
                            iter_limit: int = 100, id_sort: bool = True,
                            variant: Optional[str] = None,
                            cluster: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Kernel entry on precomputed distances (both tricks applied).

    D: [B, N, N] fp32 contiguous CUDA tensor; l2: [B, N] fp32 norms.
    `variant` (SHARED, GLOBAL, CLUSTER or SCRATCH) overrides
    `choose_variant(N, K)`, and `cluster` (CTAs a segment) the cluster
    variant's `cluster_size`, to hold them against each other.  Returns
    (assign [B, N] int32, meds [B, K] int32, steps [B] int32 — the Lloyd
    steps each segment ran)."""
    if D.device.type != "cuda":
        raise ValueError("kmedoids_from_distances runs on CUDA tensors only; "
                         "the plain version is ops.kmedoids.batch_fast_kmedoids")
    if D.dim() != 3 or D.shape[1] != D.shape[2]:
        raise ValueError(f"D must be [B, N, N]; got {tuple(D.shape)}")
    B, N, _ = D.shape
    if tuple(l2.shape) != (B, N):
        raise ValueError(f"l2 must be [{B}, {N}]; got {tuple(l2.shape)}")
    for name, t in (("D", D), ("l2", l2)):
        if t.dtype != torch.float32 or t.device != D.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous fp32 tensor on "
                             f"{D.device}")
    if not 1 <= K <= N:
        raise ValueError(f"need 1 <= K <= N; got K={K}, N={N}")
    if variant is None:
        variant = choose_variant(N, K)
    elif variant not in _ENTRIES or N > _MAX_N[variant]:
        raise ValueError(f"no k-medoids variant {variant!r} for N={N}")
    entry, smem_fn = _ENTRIES[variant]
    lib = _build.load("kmedoids")
    extra = []
    if variant == CLUSTER:
        cs = device_cluster_size(D.device, B, N, K) if cluster is None \
            else cluster
        if cs not in CLUSTER_SIZES or not cluster_fits(N, K, cs):
            raise ValueError(f"no cluster of {cs} CTAs holds a segment of "
                             f"N={N}, K={K}")
        smem = _build.smem_bytes(lib, "cc_kmedoids_cluster_smem_bytes", N, K,
                                 cs) + CLUSTER_STATIC_SMEM
        extra.append(cs)
    else:
        smem = _build.smem_bytes(lib, smem_fn, N, K)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"N={N}, K={K} needs {smem} bytes of shared memory "
                         f"in the {variant} variant; a CTA holds at most "
                         f"{_build.MAX_SMEM_BYTES}")
    assign = torch.empty((B, N), dtype=torch.int32, device=D.device)
    meds = torch.empty((B, K), dtype=torch.int32, device=D.device)
    steps = torch.empty((B,), dtype=torch.int32, device=D.device)
    if B == 0:
        return assign, meds, steps
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    ptrs = [D.data_ptr(), l2.data_ptr(), meds.data_ptr(), assign.data_ptr(),
            steps.data_ptr()]
    if variant == SCRATCH:
        # each segment's member masks (and state where shared memory cannot
        # hold it): no contents needed
        words = lib.cc_kmedoids_scratch_words
        words.restype = ctypes.c_longlong
        words.argtypes = [ctypes.c_int, ctypes.c_int]
        scratch = torch.empty((B * words(N, K),), dtype=torch.int32,
                              device=D.device)
        ptrs.append(scratch.data_ptr())
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) \
        + [ctypes.c_int] * (5 + len(extra)) + [ctypes.c_void_p]
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*ptrs, B, N, K, int(iter_limit), int(bool(id_sort)), *extra,
                 stream)
    _build.check(lib, err, f"k-medoids kernel ({variant})")
    kmedoids_from_distances.launches += 1
    kmedoids_from_distances.variant_launches[variant] += 1
    return assign, meds, steps


def reset_counts() -> None:
    """Zero the kernel's launch count, the total and by variant."""
    kmedoids_from_distances.launches = 0
    kmedoids_from_distances.variant_launches = dict.fromkeys(VARIANTS, 0)


reset_counts()


@torch.no_grad()
def kmedoids(X: torch.Tensor, K: int, distance: str = "euclidean",
             threshold: float = 1e-5, iter_limit: int = 100,
             id_sort: bool = True, norm_p: float = 2.0,
             pre_norm: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, N, Dim] points -> (assign [B, N] int32, medoids [B, K] int32).

    CPU tensors take the plain `batch_fast_kmedoids`; CUDA tensors compute
    the distances with `ops/distances.py` and launch the kernel, which
    stops per segment at the medoid fixed point (`threshold` is the plain
    version's batch-mean stop rule and is not read there)."""
    if X.device.type == "cpu":
        return batch_fast_kmedoids(X, K, distance=distance,
                                   threshold=threshold, iter_limit=iter_limit,
                                   id_sort=id_sort, norm_p=norm_p,
                                   pre_norm=pre_norm)
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    choose_variant(X.shape[1], K)      # N past MAX_N raises before D exists
    _, D, l2 = kmedoids_inputs(X, distance, norm_p, pre_norm)
    assign, meds, _ = kmedoids_from_distances(D, l2, K, iter_limit=iter_limit,
                                              id_sort=id_sort)
    return assign, meds
