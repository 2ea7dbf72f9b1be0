# coding=utf-8
"""Online text -> video retrieval engine (port of the JAX package's
`serve/engine.py`).

Tokenizer -> text tower -> gallery index top-k (flat `VideoIndex` or
`IVFVideoIndex`).  The scores are the model's meanP similarity logits: the
gallery stores the pooled, normalised video vectors, the query gets the
same normalisation, and the scores are scaled by exp(logit_scale).
PyTorch runs eagerly: each call runs the text tower and the index's
scoring and reads its result back to the host once.  Queries are padded to
`QUERY_BUCKETS`: on the card the first search at a row count no call ran
before takes about twice the steady one (`chip_smoke.py`'s serve phase
measures it), so the shapes form a small set that `warmup` runs once each.  Encoding and
search run under `torch.inference_mode()`, entered per call (it is
thread-local, and the HTTP server calls from its handler threads).
"""
from __future__ import annotations

import logging
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models.clip4clip import CLIP4Clip
from ..models.tokenizer import SimpleTokenizer, tokenize_batch
from .index import QUERY_BUCKETS, VideoIndex, _next_bucket

logger = logging.getLogger(__name__)


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    if x.shape[0] == n:
        return x
    return torch.cat([x, x.new_zeros((n - x.shape[0],) + tuple(x.shape[1:]))])


class RetrievalEngine:
    """Query engine over a gallery index.

    Args:
        model: a meanP `CLIP4Clip`; it is moved to `device`.
        index: optional pre-built index (else call `build_index`).
        tokenizer: optional tokenizer (built on first use otherwise).
        device: None means the GPU and raises `RuntimeError` without one;
            pass "cpu" explicitly to run the plain PyTorch versions.
    """

    def __init__(self, model: CLIP4Clip, index: Optional[VideoIndex] = None,
                 tokenizer: Optional[SimpleTokenizer] = None, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.index = index
        self._tokenizer = tokenizer
        self.max_words = model.cfg.max_words
        self.logit_scale = float(model.clip.logit_scale.detach().exp())

    @property
    def tokenizer(self) -> SimpleTokenizer:
        if self._tokenizer is None:
            self._tokenizer = SimpleTokenizer()
        return self._tokenizer

    # ---------------------------------------------------------------- warmup
    def warmup(self, k: int = 5, max_queries: int = 32) -> int:
        """Pay the first-call costs before the first query: on the card,
        the forward path's kernel libraries are loaded (nvcc runs here if
        it must); the tokenizer reads its tables; then each query bucket
        <= max_queries runs the online path once (Triton compiles the
        LayerNorm kernel, cuBLAS and the caching allocator set up for each
        shape).  Returns the number of buckets warmed."""
        if self.device.type == "cuda":
            from ..ops import _build
            for name in _build.FORWARD_SOURCES:
                _build.load(name)
        tokenize_batch(self.tokenizer, ["a"], max_words=self.max_words)
        buckets = [b for b in QUERY_BUCKETS if b <= max_queries] or [1]
        for b in buckets:
            ids = np.ones((b, self.max_words), np.int64)
            if self.index is not None:
                self.search_token_ids(ids, k=k)
            else:
                self.encode_token_ids(ids)
        return len(buckets)

    # ----------------------------------------------------------------- texts
    def _embed_text(self, input_ids: np.ndarray) -> torch.Tensor:
        """Normalised query embeddings [bucket, D] of ids padded to their
        query bucket (the caller keeps the first rows)."""
        ids = torch.from_numpy(np.asarray(input_ids, np.int64))
        ids = _pad_rows(ids, _next_bucket(ids.shape[0])).to(self.device)
        seq = self.model.get_sequence_output(ids)[:, 0, :]
        return seq / (torch.linalg.vector_norm(seq, dim=-1, keepdim=True)
                      + 1e-12)

    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        """[Q] strings -> [Q, D] normalised fp32 query embeddings."""
        ids, _, _ = tokenize_batch(self.tokenizer, list(texts),
                                   max_words=self.max_words)
        return self.encode_token_ids(ids)

    @torch.inference_mode()
    def encode_token_ids(self, input_ids: np.ndarray) -> np.ndarray:
        n = np.asarray(input_ids).shape[0]
        return self._embed_text(input_ids)[:n].cpu().numpy()

    # ---------------------------------------------------------------- search
    def search(self, texts: Sequence[str], k: int = 5
               ) -> List[List[Dict[str, float]]]:
        """Queries -> per-query ranked [{video_id, score}]; scores are the
        model's similarity logits (cosine x exp(logit_scale)).  IVF
        no-result slots (id -1) are dropped."""
        ids, _, _ = tokenize_batch(self.tokenizer, list(texts),
                                   max_words=self.max_words)
        scores, idx = self.search_token_ids(ids, k=k)
        return [[{"video_id": self.index.video_ids[int(i)], "score": float(s)}
                 for s, i in zip(scores[q], idx[q]) if i >= 0]
                for q in range(len(texts))]

    @torch.inference_mode()
    def search_token_ids(self, input_ids: np.ndarray, k: int = 5
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Tokenised queries -> (scores [Q, k] incl. exp(logit_scale),
        gallery row indices [Q, k]); one read back to the host per chunk.
        An index with `max_query_bucket` (IVF: its probe gathers
        [Q, nprobe, cap, D] rows) gets larger batches in chunks of that
        many queries; queries score independently, so the result is the
        same."""
        if self.index is None:
            raise RuntimeError("no index attached — build or load one first")
        if k <= 0:
            raise ValueError("k must be positive")
        k = min(k, self.index.n_valid)
        input_ids = np.asarray(input_ids, np.int64)
        n = input_ids.shape[0]
        chunk = getattr(self.index, "max_query_bucket", None)
        if chunk is not None and n > chunk:
            parts = [self.search_token_ids(input_ids[i:i + chunk], k)
                     for i in range(0, n, chunk)]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        scores, idx = self.index.search_device(
            self._embed_text(input_ids).to(self.index.device), k)
        return ((scores[:n] * self.logit_scale).cpu().numpy(),
                idx[:n].cpu().numpy())

    # ----------------------------------------------------------- index build
    def _embed_video(self, video: torch.Tensor, video_mask: torch.Tensor
                     ) -> torch.Tensor:
        """Pooled, normalised video vectors [B, D] (the video side of
        `loose_similarity`)."""
        m = self.model
        vm = m.video_mask_after_cluster(video_mask)
        return m.pooled_video(m.get_visual_output(video, vm), vm)

    @torch.inference_mode()
    def embed_video_batches(
            self, batches: Iterable[Dict[str, np.ndarray]]) -> np.ndarray:
        """Encode video batches to pooled gallery vectors.

        `batches` yield {"video": [B,1,T,C,H,W] | [B*T,C,H,W],
        "video_mask": [B,T]} as numpy arrays or tensors; a batch in pinned
        memory is copied to the card without blocking the host.  A short
        batch is padded on the device, after the copy, to the bucket of the
        largest batch so far (sticky bucket).  Results stay on the device
        and are read back once, at the end."""
        chunks = []
        target = 0
        for batch in batches:
            vmask = torch.as_tensor(batch["video_mask"])
            video = torch.as_tensor(batch["video"])
            n = vmask.shape[0]
            target = max(target, _next_bucket(n))
            if video.dim() == 6:
                video = video.reshape(-1, *video.shape[-3:])
            frames = video.shape[0] // n
            video = _pad_rows(video.to(self.device, non_blocking=True),
                              target * frames)
            vmask = _pad_rows(vmask.to(self.device, non_blocking=True),
                              target)
            chunks.append(self._embed_video(video, vmask)[:n])
        if not chunks:
            raise ValueError("no video batches")
        return torch.cat(chunks).cpu().numpy()

    def build_index(self, batches: Iterable[Dict[str, np.ndarray]],
                    video_ids: Sequence[str], quantize: str = "float32",
                    index_type: str = "flat", **index_kw):
        """Encode the gallery and attach an index on the engine's device:
        index_type "flat" (exact) or "ivf" (cluster-pruned,
        `serve/ivf.py`); extra keywords go to the index (n_clusters,
        nprobe, ... for ivf)."""
        if index_type not in ("flat", "ivf"):
            raise ValueError(f"unknown index_type {index_type!r}")
        emb = self.embed_video_batches(batches)
        if emb.shape[0] != len(video_ids):
            raise ValueError(f"{emb.shape[0]} embeddings vs "
                             f"{len(video_ids)} ids")
        if index_type == "flat":
            self.index = VideoIndex(emb, video_ids, quantize=quantize,
                                    device=self.device, **index_kw)
        else:
            from .ivf import IVFVideoIndex
            self.index = IVFVideoIndex(emb, video_ids, quantize=quantize,
                                       device=self.device, **index_kw)
        logger.info("gallery index (%s): %d videos, dim=%d, quantize=%s",
                    index_type, len(self.index), self.index.dim, quantize)
        return self.index
