# coding=utf-8
"""Flat video-embedding gallery index (port of the JAX package's
`serve/index.py`).

The gallery holds the pooled, L2-normalised video embeddings (the vectors
`loose_similarity` scores against) on the device, stored as fp32, bf16 or
int8 codes with a per-row max-abs scale.  A search is one score matmul and
`torch.topk`, both plain PyTorch: the JAX package computes them outside any
Pallas kernel too.  As there, the matmul takes bf16-rounded queries and
codes and accumulates in fp32 (the operands are upcast to fp32, which is
exact for the products), and padding rows score -inf.

Embeddings may come as numpy arrays (normalised by numpy, the JAX package's
arithmetic, so both packages store the same codes) or as tensors, which are
normalised and quantised where they lie: a gallery drawn on the card never
visits the host.

With `devices` (the cards of `serve.cli --data_parallel N`, JAX's data
mesh, `serve/index.py:105-135` there) the padded rows are split over the
cards in N contiguous parts; a search scores and takes the top k on each
card, and merges the N candidate lists on the first card (one more top
k).  The IVF index takes one device, as JAX's does.

`save` / `load` use the JAX package's `.npz` format, so each package reads
the other's files; `load_index` opens either index type.
"""
from __future__ import annotations

import json
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device

QUANT_MODES = ("float32", "bfloat16", "int8")
ROW_MULTIPLE = 8
# queries are padded up to the nearest bucket, so the set of shapes the text
# tower and the scoring see is small and `RetrievalEngine.warmup` covers it
QUERY_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


def _next_bucket(n: int, buckets: Sequence[int] = QUERY_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return -(-n // buckets[-1]) * buckets[-1]


def l2_normalize(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = np.asarray(x, np.float32)
    return x / (np.linalg.norm(x, axis=axis, keepdims=True) + 1e-12)


def normalize_rows(emb, device: torch.device) -> torch.Tensor:
    """Embeddings -> L2-normalised fp32 tensor on `device`.  A numpy array
    is normalised by numpy first (the JAX package's arithmetic); a tensor
    is normalised on the device."""
    if torch.is_tensor(emb):
        e = emb.to(device=device, dtype=torch.float32)
        return e / (torch.linalg.vector_norm(e, dim=-1, keepdim=True) + 1e-12)
    return torch.from_numpy(l2_normalize(emb)).to(device)


def quantize_rows(emb: torch.Tensor, quantize: str
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """[N, D] normalised fp32 -> (codes, scales [N, 1] or None) on the same
    device; int8 is symmetric per row (round half to even, as numpy's
    `rint`)."""
    if quantize == "int8":
        scale = emb.abs().amax(dim=1, keepdim=True) / 127.0
        scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
        codes = torch.clamp(torch.round(emb / scale), -127, 127)
        return codes.to(torch.int8), scale
    if quantize == "bfloat16":
        return emb.to(torch.bfloat16), None
    return emb.clone(), None


def score_operand(codes: torch.Tensor) -> torch.Tensor:
    """Codes as the fp32 values of their bf16 rounding: a fp32 matmul of
    two such operands multiplies exactly and sums in fp32 (TF32 off).  int8
    values are exact in bf16, so they go to fp32 directly."""
    if codes.dtype in (torch.int8, torch.bfloat16):
        return codes.float()
    return codes.to(torch.bfloat16).float()


def check_rows(emb: torch.Tensor, n_ids: int, dim: Optional[int] = None):
    if emb.dim() != 2 or (dim is not None and emb.shape[1] != dim):
        want = f"[N, {dim}]" if dim is not None else "[N, D]"
        raise ValueError(f"embeddings must be {want}, got "
                         f"{tuple(emb.shape)}")
    if emb.shape[0] != n_ids:
        raise ValueError("len(video_ids) != embeddings rows")


class VideoIndex:
    """Device-resident gallery of normalised video embeddings.

    Args:
        embeddings: [N, D] pooled video embeddings, numpy or a tensor
            (normalised here).
        video_ids: N identifiers returned by queries.
        quantize: "float32" | "bfloat16" | "int8" storage.
        device: None means the GPU (raises without one); "cpu" explicitly
            keeps the gallery on the CPU.
        devices: the cards the rows are split over (module docstring); the
            first is `device`, where results are merged.
    """

    def __init__(self, embeddings, video_ids: Sequence[str],
                 quantize: str = "float32", device=None,
                 devices: Optional[Sequence] = None):
        if quantize not in QUANT_MODES:
            raise ValueError(f"quantize must be one of {QUANT_MODES}")
        self.devices = [resolve_device(d) for d in devices] if devices \
            else [resolve_device(device)]
        self.device = self.devices[0]
        emb = normalize_rows(embeddings, self.device)
        check_rows(emb, len(video_ids))
        self.video_ids: List[str] = [str(v) for v in video_ids]
        self.quantize = quantize
        self.dim = int(emb.shape[1])
        self.n_valid = int(emb.shape[0])
        self._place(*quantize_rows(emb, quantize))

    def _place(self, codes: torch.Tensor, scales: Optional[torch.Tensor]):
        """Pad the rows to a multiple of 8 (and of the card count) and put
        each card's contiguous part on it (`_parts`: codes, scales or
        None, first row)."""
        codes = codes.to(self.device)
        mult = math.lcm(ROW_MULTIPLE, len(self.devices))
        self.n_padded = -(-self.n_valid // mult) * mult
        pad = self.n_padded - codes.shape[0]
        codes = torch.cat([codes, codes.new_zeros((pad, self.dim))])
        if scales is not None:
            scales = scales.to(self.device)
            scales = torch.cat([scales, scales.new_ones((pad, 1))])
        rows = self.n_padded // len(self.devices)
        self._parts = [
            (codes[i * rows:(i + 1) * rows].to(d),
             scales[i * rows:(i + 1) * rows].to(d) if scales is not None
             else None, i * rows) for i, d in enumerate(self.devices)]

    @property
    def _codes(self) -> torch.Tensor:
        """The padded codes, whole, on the first card."""
        return torch.cat([c.to(self.device) for c, _, _ in self._parts])

    @property
    def _scales(self) -> Optional[torch.Tensor]:
        if self._parts[0][1] is None:
            return None
        return torch.cat([s.to(self.device) for _, s, _ in self._parts])

    def search_device(self, q: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Normalised queries [Q, D] on the index's device -> (scores
        [Q, k] fp32, row indices [Q, k] int64), still on the device."""
        found = []
        for codes, scales, first in self._parts:
            qd = q.to(codes.device)
            scores = score_operand(qd) @ score_operand(codes).t()
            if scales is not None:
                scores = scores * scales[:, 0][None, :]
            scores[:, max(self.n_valid - first, 0):] = float("-inf")
            top = torch.topk(scores, min(k, codes.shape[0]), dim=1)
            if len(self._parts) == 1:
                return top
            found.append((top.values.to(self.device),
                          top.indices.to(self.device) + first))
        values = torch.cat([v for v, _ in found], dim=1)
        indices = torch.cat([i for _, i in found], dim=1)
        top = torch.topk(values, k, dim=1)
        return top.values, torch.gather(indices, 1, top.indices)

    def search(self, query_emb: np.ndarray, k: int = 5
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k over the gallery: (scores [Q, k] fp32, indices [Q, k]) of
        the original rows; query_emb need not be normalised."""
        if k <= 0:
            raise ValueError("k must be positive")
        k = min(k, self.n_valid)
        q = l2_normalize(np.asarray(query_emb, np.float32))
        if q.ndim == 1:
            q = q[None]
        scores, idx = self.search_device(
            torch.from_numpy(q).to(self.device), k)
        return scores.cpu().numpy(), idx.cpu().numpy()

    def add(self, embeddings, video_ids: Sequence[str]) -> None:
        """Append videos to a live gallery.  Exact: int8 scales are per
        row, so new rows get their own and existing codes are untouched;
        the padded device arrays are rebuilt once per call (batch adds)."""
        emb = normalize_rows(embeddings, self.device)
        check_rows(emb, len(video_ids), self.dim)
        codes, scales = quantize_rows(emb, self.quantize)
        codes = torch.cat([self._codes[: self.n_valid], codes])
        if scales is not None:
            scales = torch.cat([self._scales[: self.n_valid], scales])
        self.video_ids += [str(v) for v in video_ids]
        self.n_valid = int(codes.shape[0])
        self._place(codes, scales)

    def lookup(self, indices) -> List[str]:
        return [self.video_ids[int(i)] for i in np.asarray(indices).ravel()]

    def __len__(self) -> int:
        return self.n_valid

    def save(self, path: str) -> None:
        """Single-file npz: codes + scales + ids + meta (bf16 codes are
        stored as fp32, an exact superset)."""
        meta = dict(quantize=self.quantize, dim=self.dim,
                    n_valid=self.n_valid, version=1)
        np.savez_compressed(
            path, codes=codes_to_numpy(self._codes[: self.n_valid]),
            scales=(self._scales[: self.n_valid].cpu().numpy()
                    if self._scales is not None else np.zeros(0)),
            video_ids=np.asarray(self.video_ids), meta=json.dumps(meta))

    @classmethod
    def load(cls, path: str, device=None,
             devices: Optional[Sequence] = None) -> "VideoIndex":
        """Open a flat index saved by either package (on `devices`, split as
        a build splits it); the stored codes are restored exactly, not
        re-quantised."""
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            if meta.get("index_type", "flat") != "flat":
                raise ValueError(f"{path} holds a {meta['index_type']} "
                                 "index — use serve.load_index")
            codes, scales = z["codes"], z["scales"]
            ids = [str(v) for v in z["video_ids"]]
        quantize = meta["quantize"]
        emb = codes.astype(np.float32) * scales if quantize == "int8" \
            else codes.astype(np.float32)
        out = cls(emb, ids, quantize=quantize, device=device,
                  devices=devices)
        out._place(*codes_from_numpy(codes, scales, quantize))
        return out


def codes_to_numpy(codes: torch.Tensor) -> np.ndarray:
    codes = codes.cpu()
    return codes.numpy() if codes.dtype == torch.int8 \
        else codes.float().numpy()


def codes_from_numpy(codes: np.ndarray, scales: np.ndarray, quantize: str
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Stored `.npz` codes -> (codes, scales) tensors in the storage dtype."""
    if quantize == "int8":
        return (torch.from_numpy(codes.astype(np.int8)),
                torch.from_numpy(scales.astype(np.float32)))
    t = torch.from_numpy(codes.astype(np.float32))
    return (t.to(torch.bfloat16) if quantize == "bfloat16" else t), None


def load_index(path: str, device=None, devices: Optional[Sequence] = None):
    """Open a saved gallery index of either type: meta's `index_type`
    picks the flat `VideoIndex` (split over `devices` when there are more
    than one) or the cluster-pruned `IVFVideoIndex`, which raises with
    more than one device, as JAX's does with a mesh (`ivf.py:505-508`)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
    if meta.get("index_type", "flat") == "ivf":
        check_single_device(devices)
        from .ivf import IVFVideoIndex
        return IVFVideoIndex.load(path, device=device)
    return VideoIndex.load(path, device=device, devices=devices)


def check_single_device(devices: Optional[Sequence]) -> None:
    """Raise for more than one device: the IVF index lives on one card."""
    if devices is not None and len(devices) > 1:
        raise ValueError("the IVF index is single-device; drop "
                         "--data_parallel or use the flat index")
