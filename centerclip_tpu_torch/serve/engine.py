# coding=utf-8
"""Online text -> video retrieval engine (port of the JAX package's
`serve/engine.py`).

Tokenizer -> text tower -> flat `VideoIndex` top-k.  The scores are the
model's meanP similarity logits: the gallery stores the pooled, normalised
video vectors, the query gets the same normalisation, and the scores are
scaled by exp(logit_scale).  PyTorch runs eagerly, so there is no compiled
program cache: each call runs the towers and reads its result back to the
host once.  IVF indexes, meshes and warm-up are not ported yet.
"""
from __future__ import annotations

import logging
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models.clip4clip import CLIP4Clip
from ..models.tokenizer import SimpleTokenizer, tokenize_batch
from .index import VideoIndex

logger = logging.getLogger(__name__)

# the tail batch of a gallery build is padded up to one of these sizes
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


def _next_bucket(n: int, buckets: Sequence[int] = BATCH_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return -(-n // buckets[-1]) * buckets[-1]


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    if x.shape[0] == n:
        return x
    return torch.cat([x, x.new_zeros((n - x.shape[0],) + tuple(x.shape[1:]))])


class RetrievalEngine:
    """Query engine over a `VideoIndex`.

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

    # ----------------------------------------------------------------- texts
    def _embed_text(self, input_ids: np.ndarray) -> torch.Tensor:
        ids = torch.from_numpy(np.asarray(input_ids, np.int64)).to(self.device)
        seq = self.model.get_sequence_output(ids)[:, 0, :]
        return seq / (torch.linalg.vector_norm(seq, dim=-1, keepdim=True)
                      + 1e-12)

    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        """[Q] strings -> [Q, D] normalised fp32 query embeddings."""
        ids, _, _ = tokenize_batch(self.tokenizer, list(texts),
                                   max_words=self.max_words)
        return self.encode_token_ids(ids)

    def encode_token_ids(self, input_ids: np.ndarray) -> np.ndarray:
        return self._embed_text(input_ids).cpu().numpy()

    # ---------------------------------------------------------------- search
    def search(self, texts: Sequence[str], k: int = 5
               ) -> List[List[Dict[str, float]]]:
        """Queries -> per-query ranked [{video_id, score}]; scores are the
        model's similarity logits (cosine x exp(logit_scale))."""
        ids, _, _ = tokenize_batch(self.tokenizer, list(texts),
                                   max_words=self.max_words)
        scores, idx = self.search_token_ids(ids, k=k)
        return [[{"video_id": self.index.video_ids[int(i)], "score": float(s)}
                 for s, i in zip(scores[q], idx[q])]
                for q in range(len(texts))]

    def search_token_ids(self, input_ids: np.ndarray, k: int = 5
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Tokenised queries -> (scores [Q, k] incl. exp(logit_scale),
        gallery row indices [Q, k]); one read back to the host."""
        if self.index is None:
            raise RuntimeError("no index attached — build or load one first")
        if k <= 0:
            raise ValueError("k must be positive")
        k = min(k, self.index.n_valid)
        scores, idx = self.index.search_device(
            self._embed_text(input_ids).to(self.index.device), k)
        return (scores * self.logit_scale).cpu().numpy(), idx.cpu().numpy()

    # ----------------------------------------------------------- index build
    def _embed_video(self, video: torch.Tensor, video_mask: torch.Tensor
                     ) -> torch.Tensor:
        """Pooled, normalised video vectors [B, D] (the video side of
        `loose_similarity`)."""
        m = self.model
        vm = m.video_mask_after_cluster(video_mask)
        return m.pooled_video(m.get_visual_output(video, vm), vm)

    def embed_video_batches(
            self, batches: Iterable[Dict[str, np.ndarray]]) -> np.ndarray:
        """Encode video batches to pooled gallery vectors.

        `batches` yield {"video": [B,1,T,C,H,W] | [B*T,C,H,W],
        "video_mask": [B,T]} as numpy arrays or tensors.  A short batch is
        padded to the bucket of the largest batch so far (sticky bucket).
        Results stay on the device and are read back once, at the end."""
        chunks = []
        target = 0
        for batch in batches:
            vmask = torch.as_tensor(np.asarray(batch["video_mask"]))
            video = torch.as_tensor(batch["video"])
            n = vmask.shape[0]
            target = max(target, _next_bucket(n))
            if video.dim() == 6:
                video = video.reshape(-1, *video.shape[-3:])
            frames = video.shape[0] // n
            video = _pad_rows(video, target * frames).to(self.device,
                                                         non_blocking=True)
            vmask = _pad_rows(vmask, target).to(self.device)
            chunks.append(self._embed_video(video, vmask)[:n])
        if not chunks:
            raise ValueError("no video batches")
        return torch.cat(chunks).cpu().numpy()

    def build_index(self, batches: Iterable[Dict[str, np.ndarray]],
                    video_ids: Sequence[str], quantize: str = "float32",
                    index_type: str = "flat") -> VideoIndex:
        """Encode the gallery and attach a flat index on the engine's
        device (the IVF index type is not ported yet)."""
        if index_type != "flat":
            raise NotImplementedError(
                f"index_type {index_type!r} is not ported yet (flat only)")
        emb = self.embed_video_batches(batches)
        if emb.shape[0] != len(video_ids):
            raise ValueError(f"{emb.shape[0]} embeddings vs "
                             f"{len(video_ids)} ids")
        self.index = VideoIndex(emb, video_ids, quantize=quantize,
                                device=self.device)
        logger.info("gallery index (flat): %d videos, dim=%d, quantize=%s",
                    len(self.index), self.index.dim, quantize)
        return self.index
