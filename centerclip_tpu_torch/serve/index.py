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

`save` / `load` use the JAX package's `.npz` format, so each package reads
the other's files.
"""
from __future__ import annotations

import json
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device

QUANT_MODES = ("float32", "bfloat16", "int8")
ROW_MULTIPLE = 8


def l2_normalize(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = np.asarray(x, np.float32)
    return x / (np.linalg.norm(x, axis=axis, keepdims=True) + 1e-12)


def quantize_rows(emb: np.ndarray, quantize: str
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """[N, D] normalised fp32 -> (codes, scales [N, 1] or None) on the CPU."""
    if quantize == "int8":
        scale = np.max(np.abs(emb), axis=1, keepdims=True) / 127.0
        scale = np.where(scale == 0.0, 1.0, scale)
        codes = np.clip(np.rint(emb / scale), -127, 127).astype(np.int8)
        return torch.from_numpy(codes), torch.from_numpy(
            scale.astype(np.float32))
    t = torch.from_numpy(np.array(emb, np.float32, copy=True))
    return (t.to(torch.bfloat16) if quantize == "bfloat16" else t), None


class VideoIndex:
    """Device-resident gallery of normalised video embeddings.

    Args:
        embeddings: [N, D] pooled video embeddings (normalised here).
        video_ids: N identifiers returned by queries.
        quantize: "float32" | "bfloat16" | "int8" storage.
        device: None means the GPU (raises without one); "cpu" explicitly
            keeps the gallery on the CPU.
    """

    def __init__(self, embeddings: np.ndarray, video_ids: Sequence[str],
                 quantize: str = "float32", device=None):
        if quantize not in QUANT_MODES:
            raise ValueError(f"quantize must be one of {QUANT_MODES}")
        emb = l2_normalize(np.asarray(embeddings, np.float32))
        if emb.ndim != 2:
            raise ValueError(f"embeddings must be [N, D], got {emb.shape}")
        if emb.shape[0] != len(video_ids):
            raise ValueError("len(video_ids) != embeddings rows")
        self.device = resolve_device(device)
        self.video_ids: List[str] = [str(v) for v in video_ids]
        self.quantize = quantize
        self.dim = int(emb.shape[1])
        self.n_valid = int(emb.shape[0])
        self._place(*quantize_rows(emb, quantize))

    def _place(self, codes: torch.Tensor, scales: Optional[torch.Tensor]):
        """Pad the rows to a multiple of 8 and move them to the device."""
        self.n_padded = -(-self.n_valid // ROW_MULTIPLE) * ROW_MULTIPLE
        pad = self.n_padded - codes.shape[0]
        codes = torch.cat([codes, codes.new_zeros((pad, self.dim))])
        self._codes = codes.to(self.device)
        self._scales = None
        if scales is not None:
            scales = torch.cat([scales, scales.new_ones((pad, 1))])
            self._scales = scales.to(self.device)

    def search_device(self, q: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Normalised queries [Q, D] on the index's device -> (scores
        [Q, k] fp32, row indices [Q, k] int64), still on the device."""
        codes = self._codes.to(torch.bfloat16).float()
        scores = q.to(torch.bfloat16).float() @ codes.t()
        if self._scales is not None:
            scores = scores * self._scales[:, 0][None, :]
        scores[:, self.n_valid:] = float("-inf")
        return torch.topk(scores, k, dim=1)

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

    def __len__(self) -> int:
        return self.n_valid

    def save(self, path: str) -> None:
        """Single-file npz: codes + scales + ids + meta (bf16 codes are
        stored as fp32, an exact superset)."""
        meta = dict(quantize=self.quantize, dim=self.dim,
                    n_valid=self.n_valid, version=1)
        codes = self._codes[: self.n_valid].cpu()
        codes = codes.numpy() if codes.dtype == torch.int8 \
            else codes.float().numpy()
        scales = (self._scales[: self.n_valid].cpu().numpy()
                  if self._scales is not None else np.zeros(0))
        np.savez_compressed(path, codes=codes, scales=scales,
                            video_ids=np.asarray(self.video_ids),
                            meta=json.dumps(meta))

    @classmethod
    def load(cls, path: str, device=None) -> "VideoIndex":
        """Open a flat index saved by either package; the stored codes are
        restored exactly, not re-quantised."""
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            if meta.get("index_type", "flat") != "flat":
                raise ValueError(f"{path} holds a {meta['index_type']} index, "
                                 "which the port does not read yet")
            codes, scales = z["codes"], z["scales"]
            ids = [str(v) for v in z["video_ids"]]
        quantize = meta["quantize"]
        emb = codes.astype(np.float32) * scales if quantize == "int8" \
            else codes.astype(np.float32)
        out = cls(emb, ids, quantize=quantize, device=device)
        if quantize == "int8":
            out._place(torch.from_numpy(codes.copy()),
                       torch.from_numpy(scales.astype(np.float32)))
        else:
            t = torch.from_numpy(codes.astype(np.float32))
            out._place(t.to(torch.bfloat16) if quantize == "bfloat16" else t,
                       None)
        return out


def load_index(path: str, device=None) -> VideoIndex:
    """Open a saved gallery index (only the flat type is ported)."""
    return VideoIndex.load(path, device=device)
