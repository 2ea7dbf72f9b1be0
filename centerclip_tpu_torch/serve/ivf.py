# coding=utf-8
"""IVF (cluster-pruned) gallery index (port of the JAX package's
`serve/ivf.py`).

The flat `VideoIndex` scores every gallery row per query: its memory
traffic is the whole gallery whatever the batch.  This index groups the
gallery into K spherical k-means cells at build time (the cosine geometry
the scores use), and a query

  1. scores the K centroids           — [Q, K] fp32 matmul,
  2. takes the top-`nprobe` cells     — `torch.topk`,
  3. gathers only those cells' rows   — [Q, nprobe, cap, D],
  4. scores and takes the top-k there — a batched matmul and `torch.topk`.

Everything is plain PyTorch: the JAX package computes the build and the
probe outside any Pallas kernel too.

Design, as the JAX package's:
* **Fixed-capacity cells.**  Rows go to their nearest centroid with space,
  spilling to the next-nearest (`_capacity_assign`, on the host), so the
  grouped gallery is a dense [K, cap, D] array on the device and the probe
  gather is one index.  Empty slots carry row id -1 and score -inf.
* **Build on the device**: k-means++ seeding drawn from a
  `torch.Generator` on the index's device seeded with `seed` (JAX's
  `jax.random` draws cannot be reproduced, so the two packages' centroids
  differ), Lloyd steps as fp32 matmuls (TF32 off), and the [N, K] scores
  taken `ROW_CHUNK` rows at a time, keeping only each row's top
  `PREFERENCES` cells: a 1M-row gallery never holds a 4 GB [N, K] block.
* **Same scoring arithmetic as the flat index**: bf16-rounded queries and
  codes, products exact in fp32, fp32 sums, per-row int8 scales; with
  nprobe == K the ranking equals the flat index's.

`save` / `load` use the JAX package's `.npz` format.
"""
from __future__ import annotations

import json
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from .index import (QUANT_MODES, check_rows, codes_from_numpy,
                    codes_to_numpy, l2_normalize, normalize_rows,
                    quantize_rows, score_operand)

# the probe gathers [Q, nprobe, cap, D] rows, so engines split query
# batches into chunks of this many rows; large batches belong on the flat
# index anyway
MAX_QUERY_BUCKET = 32
# each row keeps its top PREFERENCES cells for the capacity assignment
PREFERENCES = 16
# rows per [chunk, K] score block of the build
ROW_CHUNK = 1 << 16
# fp32 bytes of gathered rows scored at once by a probe
PROBE_BLOCK_BYTES = 256 << 20


def _kmeanspp_init(e: torch.Tensor, k: int, seed: int) -> torch.Tensor:
    """k-means++ seeding on unit rows, on their device: each next seed is
    drawn with probability proportional to its cosine distance from the
    chosen set (one [N] matvec a step)."""
    n = e.shape[0]
    g = torch.Generator(device=e.device).manual_seed(seed)
    pick = torch.randint(n, (1,), generator=g, device=e.device)
    cents = e.new_zeros((k, e.shape[1]))
    ci = e.index_select(0, pick)
    cents[0:1] = ci
    mind = 1.0 - e @ ci[0]
    for i in range(1, k):
        pick = torch.multinomial(mind.clamp_min(1e-9), 1, generator=g)
        ci = e.index_select(0, pick)
        cents[i:i + 1] = ci
        mind = torch.minimum(mind, 1.0 - e @ ci[0])
    return cents


def lloyd_step(e: torch.Tensor, c: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One spherical Lloyd step: each row goes to its most similar centroid
    (fp32 matmul, first index on ties), each centroid becomes the
    renormalised sum of its rows, and an empty cell keeps its centroid.
    The sums are one-hot matmuls `ROW_CHUNK` rows at a time, added in a
    fixed order (no atomics).  Returns (centroids [K, D], assignment
    [N])."""
    k = c.shape[0]
    sums = torch.zeros_like(c)
    assign = torch.empty(e.shape[0], dtype=torch.long, device=e.device)
    for s in range(0, e.shape[0], ROW_CHUNK):
        blk = e[s:s + ROW_CHUNK]
        a = torch.argmax(blk @ c.t(), dim=1)
        assign[s:s + blk.shape[0]] = a
        onehot = torch.zeros((blk.shape[0], k), dtype=e.dtype,
                             device=e.device)
        onehot.scatter_(1, a[:, None], 1.0)
        sums += onehot.t() @ blk
    norms = torch.linalg.vector_norm(sums, dim=1, keepdim=True)
    new = torch.where(norms > 1e-6, sums / (norms + 1e-12), c)
    return new, assign


def spherical_kmeans(emb, k: int, iters: int = 10, seed: int = 0,
                     device=None) -> torch.Tensor:
    """Spherical k-means (cosine geometry) -> [K, D] unit centroids on the
    device: k-means++ seeding, then `iters` Lloyd steps (at least one).
    `emb` is numpy or a tensor; `device` None means the tensor's device,
    or the GPU for numpy input."""
    if device is None and torch.is_tensor(emb):
        device = emb.device
    e = normalize_rows(emb, resolve_device(device))
    n = e.shape[0]
    if not 0 < k <= n:
        raise ValueError(f"need 0 < k <= n rows, got k={k}, n={n}")
    c = _kmeanspp_init(e, k, seed)
    for _ in range(max(1, iters)):
        c, _ = lloyd_step(e, c)
    return c


def _capacity_assign(pref_idx: np.ndarray, pref_val: np.ndarray, k: int,
                     cap: int,
                     initial_counts: Optional[np.ndarray] = None
                     ) -> np.ndarray:
    """Assign each row to its best-scoring cluster that still has space.

    pref_idx/pref_val: [N, R] each row's top-R clusters (best first) and
    their scores.  Returns [N] cluster ids with every cluster holding
    <= cap rows (requires K * cap >= N + existing rows).  Vectorised per
    preference rank: the rank-r pass sends every still-unassigned row to
    its r-th choice, and within each cluster the highest-scoring contenders
    win the remaining slots.  Rows exhausting all R preferences overflow
    into clusters with space.  initial_counts: [K] rows already in each
    cluster (the incremental `add`); None means an empty grouping.
    """
    n, r_max = pref_idx.shape
    counts = (np.zeros(k, np.int64) if initial_counts is None
              else np.asarray(initial_counts, np.int64).copy())
    if k * cap - counts.sum() < n:
        raise ValueError(f"capacity {k}x{cap} < {n} rows")
    out = np.full(n, -1, np.int64)
    for r in range(r_max):
        todo = np.nonzero(out < 0)[0]
        if todo.size == 0:
            break
        cand = pref_idx[todo, r].astype(np.int64)
        score = pref_val[todo, r]
        # group rows by candidate cluster, best score first in each group
        order = np.lexsort((-score, cand))
        cand_sorted = cand[order]
        grp_start = np.searchsorted(cand_sorted, cand_sorted)
        rank_in_grp = np.arange(todo.size) - grp_start
        ok = rank_in_grp < (cap - counts[cand_sorted])
        winners = todo[order[ok]]
        out[winners] = cand_sorted[ok]
        np.add.at(counts, cand_sorted[ok], 1)
    todo = np.nonzero(out < 0)[0]
    if todo.size:   # overflow: any cluster with space
        free = np.repeat(np.arange(k), cap - counts)
        out[todo] = free[:todo.size]
    return out


class IVFVideoIndex:
    """Fixed-capacity inverted-file gallery index.

    Args:
        embeddings: [N, D] pooled video embeddings, numpy or a tensor
            (normalised here).
        video_ids: N identifiers returned by queries.
        quantize: "float32" | "bfloat16" | "int8" storage for cell rows.
        n_clusters: number of k-means cells; default ~sqrt(N) (a multiple
            of 8, clamped to [8, N]).
        nprobe: cells scored per query (overridable per `search`).
        capacity_factor: cell capacity = ceil(factor * N / K) rounded up to
            a multiple of 8.
        iters, seed: k-means build parameters.
        device: None means the GPU (raises without one); "cpu" explicitly.
    """

    # engines chunk query batches to this many rows per search
    max_query_bucket = MAX_QUERY_BUCKET
    # rows placed outside their nearest cell by `add`; past this fraction
    # of the gallery a full re-group restores a balanced layout
    SPILL_REGROUP_FRACTION = 0.10

    def __init__(self, embeddings, video_ids: Sequence[str],
                 quantize: str = "float32", n_clusters: Optional[int] = None,
                 nprobe: int = 8, capacity_factor: float = 1.5,
                 iters: int = 10, seed: int = 0, device=None,
                 _skip_build: bool = False):
        if quantize not in QUANT_MODES:
            raise ValueError(f"quantize must be one of {QUANT_MODES}")
        self.device = resolve_device(device)
        emb = normalize_rows(embeddings, self.device)
        check_rows(emb, len(video_ids))
        self.video_ids: List[str] = [str(v) for v in video_ids]
        self.quantize = quantize
        self.dim = int(emb.shape[1])
        self.n_valid = int(emb.shape[0])
        self.capacity_factor = float(capacity_factor)
        if n_clusters is None:   # ~sqrt(N), at least 8 if possible
            n_clusters = max(int(round(np.sqrt(self.n_valid) / 8)) * 8,
                             min(8, self.n_valid))
        self.n_clusters = int(np.clip(n_clusters, 1, max(self.n_valid, 1)))
        self.nprobe = int(np.clip(nprobe, 1, self.n_clusters))
        self._spilled = 0
        # full re-groups taken by `add` (capacity alone cannot show it)
        self.regroups = 0
        if _skip_build:
            return
        self.centroids = spherical_kmeans(emb, self.n_clusters, iters=iters,
                                          seed=seed)
        self._group(emb)

    # ------------------------------------------------------------- grouping
    def _cap_for(self, n: int) -> int:
        cap = int(np.ceil(self.capacity_factor * n / self.n_clusters))
        return (max(cap, 8) + 7) // 8 * 8

    def _preferences(self, emb: torch.Tensor, r: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Each row's top-r cells and their scores ([N, r] each, best
        first), on the host; the [N, K] scores exist ROW_CHUNK rows at a
        time."""
        idx, val = [], []
        for s in range(0, emb.shape[0], ROW_CHUNK):
            v, i = torch.topk(emb[s:s + ROW_CHUNK] @ self.centroids.t(), r,
                              dim=1)
            idx.append(i)
            val.append(v)
        return (torch.cat(idx).cpu().numpy(), torch.cat(val).cpu().numpy())

    def _group(self, emb: torch.Tensor) -> None:
        """Assign rows to fixed-capacity cells and build the dense grouped
        arrays on the device: [K, cap, D] codes, [K, cap] scales, [K, cap]
        row ids (-1 = empty)."""
        self.n_clusters = k = int(self.centroids.shape[0])
        n = emb.shape[0]
        cap = self._cap_for(n)
        while k * cap < n:   # tiny galleries: grow cap, not K
            cap += 8
        self.capacity = cap
        pref_idx, pref_val = self._preferences(emb, min(k, PREFERENCES))
        assign = torch.from_numpy(
            _capacity_assign(pref_idx, pref_val, k, cap)).to(self.device)

        codes, scales = quantize_rows(emb, self.quantize)
        order = torch.argsort(assign, stable=True)
        cells = assign[order]
        slot = torch.arange(n, device=self.device) - torch.searchsorted(
            cells, cells)
        self._codes = codes.new_zeros((k, cap, self.dim))
        self._codes[cells, slot] = codes[order]
        self._scales = None
        if scales is not None:
            self._scales = torch.ones((k, cap), device=self.device)
            self._scales[cells, slot] = scales[order, 0]
        self._rowids = torch.full((k, cap), -1, dtype=torch.int32,
                                  device=self.device)
        self._rowids[cells, slot] = order.to(torch.int32)
        self._rowids_host = self._rowids.cpu().numpy().copy()
        self._spilled = 0   # a full (re-)group is the balanced reference

    # ---------------------------------------------------------------- search
    def search_device(self, q: torch.Tensor, k: int,
                      nprobe: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Normalised queries [Q, D] on the index's device -> (scores
        [Q, k'] fp32, row ids [Q, k'] int64) on the device, with k' =
        min(k, nprobe * capacity).  Slots past the probed cells' occupancy
        score -inf with id -1."""
        p = int(np.clip(nprobe if nprobe is not None else self.nprobe,
                        1, self.n_clusters))
        k = min(k, p * self.capacity)
        n_q = q.shape[0]
        _, cells = torch.topk(q @ self.centroids.t(), p, dim=1)   # [Q, P]
        ids = self._rowids[cells]                                 # [Q, P, cap]
        qb = score_operand(q)[:, :, None]                         # [Q, D, 1]
        row_bytes = n_q * self.capacity * self.dim * 4
        step = max(1, PROBE_BLOCK_BYTES // row_bytes)
        s = torch.empty((n_q, p, self.capacity), device=q.device)
        for lo in range(0, p, step):
            rows = score_operand(self._codes[cells[:, lo:lo + step]])
            s[:, lo:lo + step] = torch.bmm(
                rows.reshape(n_q, -1, self.dim), qb).reshape(
                n_q, -1, self.capacity)
        if self._scales is not None:
            s = s * self._scales[cells]
        s = s.masked_fill(ids < 0, float("-inf"))
        top, pos = torch.topk(s.reshape(n_q, -1), k, dim=1)
        return top, torch.gather(ids.reshape(n_q, -1), 1, pos).long()

    def search(self, query_emb, k: int = 5, nprobe: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Approximate top-k (exact when nprobe == n_clusters): (scores
        [Q, k], indices [Q, k]) of the original rows.  Tail slots beyond
        the probed cells' rows are no-results (score -inf, index -1), which
        callers must drop (RetrievalEngine does; `lookup` refuses them)."""
        if k <= 0:
            raise ValueError("k must be positive")
        k = min(k, self.n_valid)
        q = l2_normalize(np.asarray(query_emb, np.float32))
        if q.ndim == 1:
            q = q[None]
        parts = [self.search_device(
            torch.from_numpy(q[i:i + MAX_QUERY_BUCKET]).to(self.device), k,
            nprobe) for i in range(0, q.shape[0], MAX_QUERY_BUCKET)]
        return (torch.cat([p[0] for p in parts]).cpu().numpy(),
                torch.cat([p[1] for p in parts]).cpu().numpy())

    # ------------------------------------------------------------------- add
    def add(self, embeddings, video_ids: Sequence[str]) -> None:
        """Append videos incrementally: centroids stay fixed, and the M new
        rows go into the cells' free slots (a host assignment of M rows and
        a device scatter of M rows, no re-upload of the gallery).  At
        nprobe == n_clusters the result stays exactly the flat index over
        the concatenated gallery.  A new row whose nearest cell is full
        spills to the next one with space; once spilled rows pass
        SPILL_REGROUP_FRACTION of the gallery, or the free slots run out,
        everything is re-grouped (`regroups` counts it) from the stored
        codes."""
        emb = normalize_rows(embeddings, self.device)
        check_rows(emb, len(video_ids), self.dim)
        m = int(emb.shape[0])
        if m == 0:
            return
        counts = (self._rowids_host >= 0).sum(axis=1)
        room = self.n_clusters * self.capacity - int(counts.sum())
        if m > room:
            self._add_full_regroup(emb, video_ids)
            return
        val, pref = torch.topk(emb @ self.centroids.t(),
                               min(self.n_clusters, PREFERENCES), dim=1)
        pref, val = pref.cpu().numpy(), val.cpu().numpy()
        assign = _capacity_assign(pref, val, self.n_clusters, self.capacity,
                                  initial_counts=counts)
        spilled = int(np.sum(assign != pref[:, 0]))
        if (self._spilled + spilled
                > self.SPILL_REGROUP_FRACTION * (self.n_valid + m)):
            self._add_full_regroup(emb, video_ids)
            return
        self._spilled += spilled

        # rank-j new row of cell c -> c's j-th free slot
        order = np.argsort(assign, kind="stable")
        cells = assign[order]
        rank = np.arange(m) - np.searchsorted(cells, cells)
        occupied = self._rowids_host[cells] >= 0            # [M, cap]
        slots = np.argsort(occupied, kind="stable", axis=1)[np.arange(m),
                                                            rank]
        new_ids = (self.n_valid + order).astype(np.int32)
        self._rowids_host[cells, slots] = new_ids
        codes, scales = quantize_rows(emb, self.quantize)
        ci, si, oi = (torch.from_numpy(a).to(self.device)
                      for a in (cells, slots, order))
        self._rowids[ci, si] = torch.from_numpy(new_ids).to(self.device)
        self._codes[ci, si] = codes[oi]
        if self._scales is not None:
            self._scales[ci, si] = scales[oi, 0]
        self.video_ids += [str(v) for v in video_ids]
        self.n_valid += m

    def _add_full_regroup(self, emb_new: torch.Tensor,
                          video_ids: Sequence[str]) -> None:
        """Fallback append: re-group everything (the stored rows + the new
        ones) with a freshly computed capacity."""
        self.regroups += 1
        old = self._dequantized_rows()
        self.video_ids += [str(v) for v in video_ids]
        self.n_valid += int(emb_new.shape[0])
        self._group(torch.cat([old, emb_new]))

    def _dequantized_rows(self) -> torch.Tensor:
        """[n_valid, D] fp32 rows in original order from the grouped
        storage (exact given the stored int8 scales)."""
        flat_ids = self._rowids.reshape(-1)
        keep = flat_ids >= 0
        rows = self._codes.reshape(-1, self.dim)[keep].float()
        if self._scales is not None:
            rows = rows * self._scales.reshape(-1)[keep][:, None]
        out = rows.new_zeros((self.n_valid, self.dim))
        out[flat_ids[keep].long()] = rows
        return out

    def lookup(self, indices) -> List[str]:
        """Row indices -> video ids.  A negative index is the no-result
        sentinel of `search`: it raises rather than wrapping to the last
        video."""
        idx = np.asarray(indices).ravel()
        if (idx < 0).any():
            raise ValueError(
                "negative index: -1 is the IVF no-result sentinel — filter "
                "rows with idx < 0 before lookup (RetrievalEngine does)")
        return [self.video_ids[int(i)] for i in idx]

    def __len__(self) -> int:
        return self.n_valid

    # --------------------------------------------------------------- storage
    def save(self, path: str) -> None:
        meta = dict(index_type="ivf", quantize=self.quantize, dim=self.dim,
                    n_valid=self.n_valid, n_clusters=self.n_clusters,
                    nprobe=self.nprobe, capacity=self.capacity,
                    capacity_factor=self.capacity_factor, version=1)
        np.savez_compressed(
            path, codes=codes_to_numpy(self._codes),
            scales=(self._scales.cpu().numpy() if self._scales is not None
                    else np.zeros(0)),
            rowids=self._rowids_host,
            centroids=self.centroids.cpu().numpy(),
            video_ids=np.asarray(self.video_ids), meta=json.dumps(meta))

    @classmethod
    def load(cls, path: str, device=None) -> "IVFVideoIndex":
        """Open an IVF index saved by either package, its codes, cells and
        centroids exactly as stored."""
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            codes, rowids = z["codes"], z["rowids"]
            scales, centroids = z["scales"], z["centroids"]
            ids = [str(v) for v in z["video_ids"]]
        out = cls(np.zeros((0, meta["dim"]), np.float32), [],
                  quantize=meta["quantize"], nprobe=meta["nprobe"],
                  capacity_factor=meta["capacity_factor"], device=device,
                  _skip_build=True)
        out.video_ids = ids
        out.n_valid = meta["n_valid"]
        out.n_clusters = meta["n_clusters"]
        out.nprobe = meta["nprobe"]   # __init__'s clip saw the empty build
        out.capacity = meta["capacity"]
        out.centroids = torch.from_numpy(
            centroids.astype(np.float32)).to(out.device)
        codes, scales = codes_from_numpy(codes, scales, meta["quantize"])
        out._codes = codes.to(out.device)
        out._scales = scales.to(out.device) if scales is not None else None
        out._rowids_host = rowids.astype(np.int32)
        out._rowids = torch.from_numpy(out._rowids_host.copy()).to(
            out.device)
        return out
