# coding=utf-8
"""Batched k-medoids: a CUDA C++ kernel, with `ops/kmedoids.py` as its plain
version.

Replaces the TPU kernel `centerclip_tpu/ops/kmedoids_pallas.py`
(`_kmedoids_kernel` / `kmedoids_from_distances`, entry
`batch_fast_kmedoids_pallas`).  The kernel, `csrc/kmedoids.cu`, runs one
CTA per segment for KKZ seeding, every Lloyd step, the id sort and the last
assignment.  It is latency-bound: the steps are a chain of small dependent
reductions and reads, which the design keeps short.  The TPU kernel's
one-hot matmul is replaced by each candidate's sum over its own cluster's
members.  The distance matrix is computed outside the kernel by
`ops/distances.py`, a plain fp32 matmul.

Four variants of that one algorithm, picked by `choose_variant` from N
(and K), that give the same bits on the same distances: SHARED (N <=
SHARED_MAX_N)
copies the segment's `[N, N]` matrix into shared memory once (one bulk
asynchronous copy when N is even), runs KKZ in one warp with no block
barrier, and Lloyd steps of three barriers on member lists built without
atomics; GLOBAL (N <= GLOBAL_MAX_N, e.g. ViT-B/16's N = 392) reads it
from device memory and so reads only what changed: KKZ over the whole CTA
also yields the first assignment, a Lloyd step compares each point with
the medoids that moved only (all K where its own medoid moved), and sums
run only for clusters whose members changed; LARGE (N <= LARGE_MAX_N,
e.g. ViT-B/16's N = 588 and 784 with segments of 3 and 4 frames, or a
whole 12-frame clip's 2352) is GLOBAL's kernel with KKZ's per-point state
in shared memory instead of registers and its chunk count read at run
time; SCRATCH (past LARGE_MAX_N, e.g. a 20-frame segment's 3920, or a K
whose member masks do not fit LARGE's shared memory, e.g. K = N = 2352)
is LARGE's kernel with the member masks, and where shared memory cannot
hold it the per-point state too, in a device-memory scratch a segment
that the wrapper allocates from PyTorch's caching allocator.  Where LARGE
runs it is the faster of the two: on an H100 SCRATCH took 12-23 % longer
at ViT-B/16's segments of 588, 784 and 2352 tokens (`bench_ln_kmedoids.py`),
its member masks read from device memory in every step's sums.

`kmedoids` takes the plain version for CPU tensors only.  A CUDA tensor
launches the kernel or raises ValueError: only N past MAX_N (whose member
masks 32-bit indices cannot address) does, besides malformed inputs; a
scratch the card cannot hold raises PyTorch's out-of-memory error.
`kmedoids_from_distances.launches` counts launches, and `.variant_launches`
counts them by variant.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .kmedoids import batch_fast_kmedoids, kmedoids_inputs

SHARED, GLOBAL, LARGE, SCRATCH = "shared", "global", "large", "scratch"
VARIANTS = (SHARED, GLOBAL, LARGE, SCRATCH)
# the largest N whose [N, N] fp32 matrix, sums, assignment, medoids and
# member masks fit in one CTA's 227 KB of shared memory at any K <= N
SHARED_MAX_N = 235
GLOBAL_MAX_N = 512             # 16 chunks of 32 points, 2 a thread
# 16 frames of 196 ViT-B/16 tokens: the largest N at which the member
# masks of any K <= 392 (2 x 196) fit in shared memory
LARGE_MAX_N = 3136
# the largest N at which the member masks of any K <= N, K * ceil(N / 32)
# words, are indexed by 32-bit ints (D itself takes 64-bit offsets): the
# scratch variant's limit, far past what the card's memory holds of D
MAX_N = 262_143
_ENTRIES = {SHARED: ("cc_kmedoids", "cc_kmedoids_smem_bytes"),
            GLOBAL: ("cc_kmedoids_global", "cc_kmedoids_global_smem_bytes"),
            LARGE: ("cc_kmedoids_large", "cc_kmedoids_large_smem_bytes"),
            SCRATCH: ("cc_kmedoids_scratch", "cc_kmedoids_scratch_smem_bytes")}
# the largest N each variant's entry takes (`variant=` may force one below
# the range `choose_variant` gives it; the shared one then still needs its
# shared memory)
_MAX_N = {SHARED: 256, GLOBAL: GLOBAL_MAX_N, LARGE: LARGE_MAX_N,
          SCRATCH: MAX_N}


def large_smem_bytes(N: int, K: int) -> int:
    """Shared memory of one CTA of the large (and global) variant, as
    `global_smem_bytes` in csrc/kmedoids.cu computes it: best, assignment
    and sums [N], two K lists, the member masks [K, ceil(N / 32)] (4 bytes
    each), and N + 2 K bytes rounded up to words."""
    return (3 * N + 2 * K + K * -(-N // 32)) * 4 + (N + 2 * K + 3) // 4 * 4


def choose_variant(N: int, K: Optional[int] = None) -> str:
    """The kernel variant for N points per segment into K clusters: SHARED
    up to SHARED_MAX_N, GLOBAL up to GLOBAL_MAX_N, LARGE up to LARGE_MAX_N
    where its shared memory holds K's member masks (K None: any K <= 392,
    which it holds up to LARGE_MAX_N), SCRATCH past that up to MAX_N;
    ValueError past MAX_N."""
    if N < 1 or N > MAX_N:
        raise ValueError(f"the k-medoids kernel takes 1 <= N <= {MAX_N}; "
                         f"got N={N}")
    if N <= SHARED_MAX_N:
        return SHARED
    if N <= GLOBAL_MAX_N:
        return GLOBAL
    if N <= LARGE_MAX_N and (K is None or large_smem_bytes(N, K)
                             <= _build.MAX_SMEM_BYTES):
        return LARGE
    return SCRATCH


def kmedoids_from_distances(D: torch.Tensor, l2: torch.Tensor, K: int,
                            iter_limit: int = 100, id_sort: bool = True,
                            variant: Optional[str] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Kernel entry on precomputed distances (both tricks applied).

    D: [B, N, N] fp32 contiguous CUDA tensor; l2: [B, N] fp32 norms.
    `variant` (SHARED, GLOBAL, LARGE or SCRATCH) overrides
    `choose_variant(N, K)`, to hold them against each other.  Returns (assign [B, N] int32, meds [B, K]
    int32, steps [B] int32 — the Lloyd steps each segment ran)."""
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
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*ptrs, B, N, K, int(iter_limit), int(bool(id_sort)), stream)
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
