# coding=utf-8
"""Retrieval evaluation (port of the JAX package's `train/evaluate.py`;
reference: main.py:381-534).

Two phases, like the reference:
1. Feature caching: encode every test batch (multi-sentence datasets encode
   every caption but only the videos at cut-off rows, main.py:427-442).
   Results stay on the device and are read back once, at the end.
2. Similarity assembly: the model's `get_similarity_logits` (meanP,
   seqTransf, or tightTransf's all-pairs cross scoring), `text_block`
   texts at a time.
Metrics: the standard or the multi-sentence protocol (main.py:466-494).
Everything runs under `torch.inference_mode()`.

In a run of more than one process phase 1 is spread over the ranks, as
JAX's single-process evaluation shards it over its local mesh
(`train/evaluate.py:41-47` there): every rank holds a model with whole
parameters (under FSDP or tensor parallelism a copy loaded from the
gathered ones), loads and encodes only every N-th batch of the loader
(`BatchLoader.strided`; the multi-sentence cut-offs are placed by the
batch sizes, which need no loading), and the features are gathered to
rank 0 in the loader's order (`gather_object`, host memory).  Rank 0
alone runs phase 2 and the metrics; `evaluate` returns None on the other
ranks.  A model whose parameters are FSDP shards or tensor-parallel
slices raises here: its forward would need every rank.
"""
from __future__ import annotations

import itertools
import logging
import time
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..models.clip4clip import CLIP4Clip
from ..parallel.mesh import is_sharded, process_index, world_size
from .loop import Batch
from .metrics import (compute_metrics, reshape_multi_sentence_sim,
                      tensor_text_to_video_metrics, tensor_video_to_text_sim)

logger = logging.getLogger(__name__)


class Evaluator:
    """Stateless two-phase evaluator over the model's device; in a run of
    more than one process, phase 1 is spread over its ranks (module
    docstring)."""

    def __init__(self, model: CLIP4Clip):
        if is_sharded(model):
            raise ValueError("the Evaluator takes a model with whole "
                             "parameters, not FSDP shards or tensor-parallel "
                             "slices")
        self.model = model

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.model.device, non_blocking=True)

    @torch.inference_mode()
    def cache_features(self, batches: Iterable[Batch],
                       multi_sentence: bool = False,
                       cut_off_points: Optional[List[int]] = None
                       ) -> Dict[str, Any]:
        """Phase 1 (main.py:416-452).  `batches` yield dicts with
        input_ids / video / video_mask (numpy arrays or tensors;
        attention_mask is not read).  Spread over N ranks, `batches` is a
        `BatchLoader`: each rank loads and encodes only the batches i with
        i % N == its rank, and rank 0 alone returns the features, all
        ranks' in the loader's order (the others None)."""
        m = self.model
        rank, world = process_index(), world_size()
        parts = []      # (batch index, sequence, visual, mask) per batch
        cut0 = [c - 1 for c in (cut_off_points or [])]          # main.py:399
        t0 = time.time()
        if world > 1:
            starts = np.cumsum([0] + batches.batch_sizes())
            indices = range(rank, len(starts) - 1, world)
            batches = batches.strided(rank, world)
        else:
            starts, indices = None, itertools.count()
        total_video_num = 0
        for batch, index in zip(batches, indices):
            ids = torch.as_tensor(batch["input_ids"])
            filt = None
            if multi_sentence:
                # encode only the unique videos at caption cut-offs
                s_ = (total_video_num if starts is None
                      else int(starts[index]))
                e_ = total_video_num = s_ + ids.shape[0]
                filt = [i - s_ for i in cut0 if s_ <= i < e_]
            # numpy arrays or pinned tensors; a pinned tensor (or a view of
            # it) is copied to the card without blocking the host
            seq = m.get_sequence_output(
                self._tensor(ids.reshape(-1, ids.shape[-1])).long())
            if filt is not None and not filt:
                parts.append((index, seq, None, None))
                continue
            video = torch.as_tensor(batch["video"])
            vmask = torch.as_tensor(batch["video_mask"])
            if filt is not None:
                video, vmask = video[filt], vmask[filt]
            vm = m.video_mask_after_cluster(self._tensor(vmask))
            visual = m.get_visual_output(self._tensor(video), vm)
            if m.cfg.pre_visual_pooling:
                # ActivityNet eval memory valve (clip4clip.py:237-243)
                visual = m.pooled_video(visual, vm)
            parts.append((index, seq, visual, vm))
        # one read back to the host at the end
        parts = [(i, *(t.cpu().numpy() if t is not None else None
                       for t in ts)) for i, *ts in parts]
        if world > 1:
            gathered = [None] * world if rank == 0 else None
            torch.distributed.gather_object(parts, gathered, dst=0)
            if rank != 0:
                return None
            parts = sorted((p for ps in gathered for p in ps),
                           key=lambda p: p[0])
        seq = np.concatenate([p[1] for p in parts])
        vis = np.concatenate([p[2] for p in parts if p[2] is not None])
        vmask = np.concatenate([p[3] for p in parts if p[3] is not None])
        return {"sequence": seq, "visual": vis, "video_mask": vmask,
                "infer_time": time.time() - t0}

    @torch.inference_mode()
    def similarity_matrix(self, cached: Dict[str, Any],
                          text_block: int = 512) -> np.ndarray:
        """Phase 2 (main.py:463-464, 502-534): the [n_texts, n_videos]
        logits of the model's header, `text_block` texts at a time (JAX
        package `train/evaluate.py:103-106, 167-180`)."""
        seq = cached["sequence"]
        vis = self._tensor(cached["visual"])
        vmask = self._tensor(cached["video_mask"])
        rows = [self.model.get_similarity_logits(
            self._tensor(seq[s:s + text_block]), vis, None, vmask)
            for s in range(0, seq.shape[0], text_block)]
        return torch.cat(rows).cpu().numpy()

    def evaluate(self, batches: Iterable[Batch], multi_sentence: bool = False,
                 cut_off_points: Optional[List[int]] = None,
                 inference_speed_test: bool = False) -> Dict[str, Any]:
        """Full protocol; returns {'t2v', 'v2t', 'R1', 'sim_matrix',
        'infer_time'} (main.py:381-499), on rank 0 of a spread evaluation
        (None on the other ranks)."""
        cached = self.cache_features(batches, multi_sentence=multi_sentence,
                                     cut_off_points=cut_off_points)
        if cached is None:
            return None
        logger.info("inference time: %.2fs", cached["infer_time"])
        if inference_speed_test:
            return {"R1": 0.0, "infer_time": cached["infer_time"]}
        sim = self.similarity_matrix(cached)
        if multi_sentence:
            packed = reshape_multi_sentence_sim(sim, cut_off_points)
            tv = tensor_text_to_video_metrics(packed)
            vt = compute_metrics(tensor_video_to_text_sim(packed))
        else:
            tv = compute_metrics(sim)
            vt = compute_metrics(sim.T)
        logger.info("Text-to-Video: R@1: %.1f - R@5: %.1f - R@10: %.1f - "
                    "Median R: %.1f - Mean R: %.1f", tv["R1"], tv["R5"],
                    tv["R10"], tv["MR"], tv["MeanR"])
        logger.info("Video-to-Text: R@1: %.1f - R@5: %.1f - R@10: %.1f - "
                    "Median R: %.1f - Mean R: %.1f", vt["R1"], vt["R5"],
                    vt["R10"], vt["MR"], vt["MeanR"])
        return {"t2v": tv, "v2t": vt, "R1": tv["R1"], "sim_matrix": sim,
                "infer_time": cached["infer_time"]}
