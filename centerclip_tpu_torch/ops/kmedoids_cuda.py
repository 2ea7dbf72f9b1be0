# coding=utf-8
"""Batched k-medoids: a CUDA C++ kernel, with `ops/kmedoids.py` as its plain
version.

Replaces the TPU kernel `centerclip_tpu/ops/kmedoids_pallas.py`
(`_kmedoids_kernel` / `kmedoids_from_distances`, entry
`batch_fast_kmedoids_pallas`).  The kernel, `csrc/kmedoids.cu`, runs one
CTA per segment with the segment's `[N, N]` distance matrix held in shared
memory for KKZ seeding, every Lloyd step, the id sort and the last
assignment.  It is latency-bound: the matrix is read from device memory
once and the steps are a chain of small dependent reductions.  The TPU
kernel's one-hot matmul is replaced by each candidate's sum over its own
cluster (O(N^2) adds per step instead of O(N^2 K)).  The distance matrix is
computed outside the kernel by `ops/distances.py`, a plain fp32 matmul.

`kmedoids` takes the plain version for CPU tensors only.  A CUDA tensor
launches the kernel or raises; an N whose distance matrix does not fit in
shared memory raises.  `kmedoids_from_distances.launches` counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .kmedoids import batch_fast_kmedoids, kmedoids_inputs


def kmedoids_from_distances(D: torch.Tensor, l2: torch.Tensor, K: int,
                            iter_limit: int = 100, id_sort: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Kernel entry on precomputed distances (both tricks applied).

    D: [B, N, N] fp32 contiguous CUDA tensor; l2: [B, N] fp32 norms.
    Returns (assign [B, N] int32, meds [B, K] int32, steps [B] int32 — the
    Lloyd steps each segment ran)."""
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
    lib = _build.load("kmedoids")
    smem = _build.smem_bytes(lib, "cc_kmedoids_smem_bytes", N, K)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"N={N} needs {smem} bytes of shared memory; the "
                         f"kernel holds at most {_build.MAX_SMEM_BYTES} "
                         f"(N <= ~235)")
    assign = torch.empty((B, N), dtype=torch.int32, device=D.device)
    meds = torch.empty((B, K), dtype=torch.int32, device=D.device)
    steps = torch.empty((B,), dtype=torch.int32, device=D.device)
    if B == 0:
        return assign, meds, steps
    fn = lib.cc_kmedoids
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(D.data_ptr(), l2.data_ptr(), meds.data_ptr(),
                 assign.data_ptr(), steps.data_ptr(), B, N, K,
                 int(iter_limit), int(bool(id_sort)), stream)
    _build.check(lib, err, "k-medoids kernel")
    kmedoids_from_distances.launches += 1
    return assign, meds, steps


kmedoids_from_distances.launches = 0


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
    _, D, l2 = kmedoids_inputs(X, distance, norm_p, pre_norm)
    assign, meds, _ = kmedoids_from_distances(D, l2, K, iter_limit=iter_limit,
                                              id_sort=id_sort)
    return assign, meds
