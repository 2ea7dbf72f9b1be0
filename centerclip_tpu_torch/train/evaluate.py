# coding=utf-8
"""Retrieval evaluation (port of the JAX package's `train/evaluate.py`;
reference: main.py:381-534).

Two phases, like the reference:
1. Feature caching: encode every test batch (multi-sentence datasets encode
   every caption but only the videos at cut-off rows, main.py:427-442).
   Results stay on the device and are read back once, at the end.
2. Similarity assembly: the meanP logits, `text_block` texts at a time.
Metrics: the standard or the multi-sentence protocol (main.py:466-494).
Everything runs under `torch.inference_mode()`.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..models.clip4clip import CLIP4Clip
from .loop import Batch
from .metrics import (compute_metrics, reshape_multi_sentence_sim,
                      tensor_text_to_video_metrics, tensor_video_to_text_sim)

logger = logging.getLogger(__name__)


class Evaluator:
    """Stateless two-phase evaluator over the model's device."""

    def __init__(self, model: CLIP4Clip):
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
        attention_mask is not read)."""
        m = self.model
        seq_list, vis_list, vmask_list = [], [], []
        total_video_num = 0
        cut0 = [c - 1 for c in (cut_off_points or [])]          # main.py:399
        t0 = time.time()
        for batch in batches:
            # numpy arrays or pinned tensors; a pinned tensor (or a view of
            # it) is copied to the card without blocking the host
            ids = torch.as_tensor(batch["input_ids"])
            seq_list.append(m.get_sequence_output(
                self._tensor(ids.reshape(-1, ids.shape[-1])).long()))
            video = torch.as_tensor(batch["video"])
            vmask = torch.as_tensor(batch["video_mask"])
            if multi_sentence:
                # encode only the unique videos at caption cut-offs
                s_, e_ = total_video_num, total_video_num + ids.shape[0]
                filt = [i - s_ for i in cut0 if s_ <= i < e_]
                total_video_num += ids.shape[0]
                if not filt:
                    continue
                video, vmask = video[filt], vmask[filt]
            vm = m.video_mask_after_cluster(self._tensor(vmask))
            visual = m.get_visual_output(self._tensor(video), vm)
            if m.cfg.pre_visual_pooling:
                # ActivityNet eval memory valve (clip4clip.py:237-243)
                visual = m.pooled_video(visual, vm)
            vis_list.append(visual)
            vmask_list.append(vm)
        seq = torch.cat(seq_list).cpu().numpy()
        vis = torch.cat(vis_list).cpu().numpy()
        vmask = torch.cat(vmask_list).cpu().numpy()
        return {"sequence": seq, "visual": vis, "video_mask": vmask,
                "infer_time": time.time() - t0}

    @torch.inference_mode()
    def similarity_matrix(self, cached: Dict[str, Any],
                          text_block: int = 512) -> np.ndarray:
        """Phase 2 (main.py:463-464, 502-534): the [n_texts, n_videos]
        meanP logits, `text_block` texts at a time."""
        seq = cached["sequence"]
        vis = self._tensor(cached["visual"])
        vmask = self._tensor(cached["video_mask"])
        rows = [self.model.loose_similarity(
            self._tensor(seq[s:s + text_block]), vis, vmask)
            for s in range(0, seq.shape[0], text_block)]
        return torch.cat(rows).cpu().numpy()

    def evaluate(self, batches: Iterable[Batch], multi_sentence: bool = False,
                 cut_off_points: Optional[List[int]] = None,
                 inference_speed_test: bool = False) -> Dict[str, Any]:
        """Full protocol; returns {'t2v', 'v2t', 'R1', 'sim_matrix',
        'infer_time'} (main.py:381-499)."""
        cached = self.cache_features(batches, multi_sentence=multi_sentence,
                                     cut_off_points=cut_off_points)
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
