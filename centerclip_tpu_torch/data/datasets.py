# coding=utf-8
"""Video-caption datasets (port of the JAX package's `data/datasets.py`;
reference: dataloaders/dataloader_*_retrieval.py).

All six classes, producing numpy dict samples with the reference's
exact text/video conventions:
  input_ids      [pair, max_words]  CLS + BPE(<=max_words-2) + SEP, 0-padded
  attention_mask [pair, max_words]
  segment_ids    [pair, max_words]  (zeros)
  video          [pair, T, 3, H, W] uint8 raw pixels by default (normalised
                 on device — 4x less host->device traffic); float32
                 CLIP-normalised with raw_pixels=False
  video_mask     [pair, T]          1 for real frames

Annotation file formats are byte-compatible with the reference so existing
data directories drop in unchanged.  The MSR-VTT CSVs are read with the `csv`
module (`read_csv`), not pandas, with the columns `pd.read_csv` would give.
"""
from __future__ import annotations

import csv
import json
import math
import os
import pickle
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..models.tokenizer import EOT_TOKEN, SOT_TOKEN, SimpleTokenizer
from .decode import VideoDecoder

_INT = re.compile(r"[+-]?\d+")
_FLOAT = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?")


def _column(values: List[str]) -> list:
    """A column typed as `pd.read_csv` types it: int when every value is an
    integer, float when every value is a number, str otherwise."""
    if values and all(_INT.fullmatch(v) for v in values):
        return [int(v) for v in values]
    if values and all(_FLOAT.fullmatch(v) for v in values):
        return [float(v) for v in values]
    return values


def read_csv(path: str) -> Dict[str, list]:
    """{column: values} of a CSV whose first row names the columns (quoted
    fields may hold commas and quotes; blank lines are skipped), typed like
    `pd.read_csv`'s columns."""
    with open(path, newline="", encoding="utf-8") as f:
        rows = [r for r in csv.reader(f) if r]
    header, body = rows[0], rows[1:]
    for i, r in enumerate(body):
        if len(r) != len(header):
            raise ValueError(f"{path}: row {i + 2} has {len(r)} fields, "
                             f"the header {len(header)}")
    return {name: _column([r[j] for r in body])
            for j, name in enumerate(header)}


class VideoTextDataset:
    """Base: shared text encoding + clip extraction."""

    multi_sentence_per_video = False
    cut_off_points: List[int] = []
    sentence_num = -1
    video_num = -1

    def __init__(self, tokenizer: SimpleTokenizer, max_words: int = 30,
                 max_frames: int = 100, image_resolution: int = 224,
                 is_train: bool = True, lmdb_dataset: Optional[str] = None,
                 frame_order: int = 0, slice_framepos: int = 0,
                 video_suffix: str = ".mp4", raw_pixels: bool = True,
                 seed: int = 42):
        self.tokenizer = tokenizer
        self.max_words = max_words
        self.max_frames = max_frames
        self.frame_order = frame_order
        self.slice_framepos = slice_framepos
        self.video_suffix = video_suffix
        self.seed = seed
        self.epoch = 0
        self.decoder = VideoDecoder(size=image_resolution, is_train=is_train,
                                    num_segments=max_frames,
                                    lmdb_dataset=lmdb_dataset,
                                    emit_uint8=raw_pixels)

    def set_epoch(self, epoch: int) -> None:
        """Re-key the per-sample augmentation RNG (DistributedSampler
        set_epoch semantics; forwarded by BatchLoader.set_epoch)."""
        self.epoch = epoch

    def _sample_rng(self, idx: int) -> np.random.Generator:
        """Stateless per-(seed, epoch, sample) generator.

        A single dataset-level Generator shared by the loader's decode
        threads makes every random draw depend on thread interleaving —
        run-to-run nondeterminism whenever num_thread_reader > 1 (found by
        the cross-process strategy-equivalence smoke,
        tests/test_multiprocess.py).  Deriving a fresh generator per sample
        keeps TSN sampling / caption choice / frame-order draws identical
        for any thread count, shard layout, or visit order, while still
        varying across epochs like the reference's per-worker reseeding.
        """
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch, int(idx)]))

    # --- text ---------------------------------------------------------------
    def _get_text(self, sentence: str) -> Tuple[np.ndarray, np.ndarray,
                                                np.ndarray]:
        """reference: dataloader_msrvtt_retrieval.py:56-89"""
        ids = np.zeros((1, self.max_words), np.int32)
        mask = np.zeros((1, self.max_words), np.int32)
        seg = np.zeros((1, self.max_words), np.int32)
        toks = self.tokenizer.encode(sentence)[: self.max_words - 2]
        row = [self.tokenizer.encoder[SOT_TOKEN]] + toks \
            + [self.tokenizer.encoder[EOT_TOKEN]]
        ids[0, : len(row)] = row
        mask[0, : len(row)] = 1
        return ids, mask, seg

    # --- video --------------------------------------------------------------
    def _get_rawvideo(self, video_path: str, start=None, end=None,
                      random_shift=None, rng=None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """reference: dataloader_msrvtt_retrieval.py:91-110"""
        video_mask = np.zeros((1, self.max_frames), np.int32)
        clip, slice_len = self.decoder.get_video_data(
            video_path, start_time=start, end_time=end,
            random_shift=random_shift, rng=rng)
        clip = self.decoder.process_frame_order(clip, self.frame_order,
                                                rng=rng)
        video_mask[0, :slice_len] = 1
        if clip.dtype != np.uint8:  # raw-pixel path ships uint8 untouched
            clip = clip.astype(np.float32)
        return clip[None], video_mask

    def _sample(self, sentence, video_path, start=None, end=None, rng=None):
        ids, mask, seg = self._get_text(sentence)
        video, vmask = self._get_rawvideo(video_path, start, end, rng=rng)
        return {"input_ids": ids, "attention_mask": mask, "segment_ids": seg,
                "video": video, "video_mask": vmask}


# ---------------------------------------------------------------------------
# MSR-VTT (reference: dataloader_msrvtt_retrieval.py)
# ---------------------------------------------------------------------------
class MSRVTTEvalDataset(VideoTextDataset):
    """1k-A eval split: CSV of (video_id, sentence) pairs."""

    def __init__(self, csv_path: str, features_path: str, **kw):
        super().__init__(is_train=False, **kw)
        self.data = read_csv(csv_path)
        self.features_path = features_path

    def __len__(self):
        return len(self.data["video_id"])

    def __getitem__(self, idx):
        video_id = self.data["video_id"][idx]
        sentence = self.data["sentence"][idx]
        path = os.path.join(self.features_path,
                            f"{video_id}{self.video_suffix}")
        return self._sample(sentence, path, rng=self._sample_rng(idx))


class MSRVTTTrainDataset(VideoTextDataset):
    """Train split: video-list CSV + JSON corpus; `unfold_sentences` expands
    to all ~200k pairs, otherwise one random caption per video
    (reference: dataloader_msrvtt_retrieval.py:120-276)."""

    def __init__(self, csv_path: str, json_path: str, features_path: str,
                 unfold_sentences: bool = False, **kw):
        super().__init__(is_train=True, **kw)
        self.csv = read_csv(csv_path)
        with open(json_path) as f:
            self.data = json.load(f)
        self.features_path = features_path
        self.unfold_sentences = unfold_sentences
        if unfold_sentences:
            train_ids = set(self.csv["video_id"])
            self.sentences_dict = {}
            for itm in self.data["sentences"]:
                if itm["video_id"] in train_ids:
                    self.sentences_dict[len(self.sentences_dict)] = (
                        itm["video_id"], itm["caption"])
            self.sample_len = len(self.sentences_dict)
        else:
            self.sentences = defaultdict(list)
            for itm in self.data["sentences"]:
                self.sentences[itm["video_id"]].append(itm["caption"])
            self.sample_len = len(self.csv["video_id"])

    def __len__(self):
        return self.sample_len

    def __getitem__(self, idx):
        rng = self._sample_rng(idx)
        if self.unfold_sentences:
            video_id, caption = self.sentences_dict[idx]
        else:
            video_id = self.csv["video_id"][idx]
            pool = self.sentences[video_id]
            caption = pool[int(rng.integers(len(pool)))]
        path = os.path.join(self.features_path,
                            f"{video_id}{self.video_suffix}")
        return self._sample(caption, path, rng=rng)


# ---------------------------------------------------------------------------
# MSVD (reference: dataloader_msvd_retrieval.py) — multi-sentence eval
# ---------------------------------------------------------------------------
class MSVDDataset(VideoTextDataset):
    def __init__(self, subset: str, data_path: str, features_path: str, **kw):
        assert subset in ("train", "val", "test")
        super().__init__(is_train=(subset == "train"), **kw)
        self.subset = subset
        with open(os.path.join(data_path, f"{subset}_list.txt")) as fp:
            video_ids = [line.strip() for line in fp if line.strip()]
        with open(os.path.join(data_path, "raw-captions.pkl"), "rb") as f:
            captions = pickle.load(f)
        # discover files by walk (dataloader_msvd_retrieval.py:54-62)
        self.video_dict = {}
        for root, _, files in os.walk(features_path):
            for fname in files:
                vid = ".".join(fname.split(".")[:-1])
                if vid in video_ids:
                    self.video_dict[vid] = os.path.join(root, fname)
        self.sentences_dict = {}
        self.cut_off_points = []
        for vid in video_ids:
            assert vid in captions, vid
            for cap in captions[vid]:
                self.sentences_dict[len(self.sentences_dict)] = (
                    vid, " ".join(cap))
            self.cut_off_points.append(len(self.sentences_dict))
        self.multi_sentence_per_video = True
        if subset in ("val", "test"):
            self.sentence_num = len(self.sentences_dict)
            self.video_num = len(video_ids)

    def __len__(self):
        return len(self.sentences_dict)

    def __getitem__(self, idx):
        video_id, caption = self.sentences_dict[idx]
        return self._sample(caption, self.video_dict[video_id],
                            rng=self._sample_rng(idx))


# ---------------------------------------------------------------------------
# LSMDC (reference: dataloader_lsmdc_retrieval.py)
# ---------------------------------------------------------------------------
class LSMDCDataset(VideoTextDataset):
    SPLIT_FILES = {
        "train": "LSMDC16_annos_training.csv",
        "val": "LSMDC16_annos_val.csv",
        "test": "LSMDC16_challenge_1000_publictect.csv",
    }

    def __init__(self, subset: str, data_path: str, features_path: str, **kw):
        assert subset in self.SPLIT_FILES
        super().__init__(is_train=(subset == "train"), **kw)
        video_ids, caption_dict = [], {}
        with open(os.path.join(data_path, self.SPLIT_FILES[subset])) as fp:
            for line in fp:
                parts = line.strip().split("\t")
                if len(parts) != 6:
                    continue
                clip_id, *_times, sentence = parts
                caption_dict[len(caption_dict)] = (clip_id, sentence)
                if clip_id not in video_ids:
                    video_ids.append(clip_id)
        with open(os.path.join(data_path, "video_path.json")) as f:
            all_video = json.load(f)
        self.video_dict = {k: os.path.join(features_path, all_video[k])
                           for k in video_ids if k in all_video}
        self.iter2video_pairs = {}
        for clip_id, sentence in caption_dict.values():
            if clip_id in self.video_dict:
                self.iter2video_pairs[len(self.iter2video_pairs)] = (
                    clip_id, sentence)

    def __len__(self):
        return len(self.iter2video_pairs)

    def __getitem__(self, idx):
        clip_id, sentence = self.iter2video_pairs[idx]
        return self._sample(sentence, self.video_dict[clip_id],
                            rng=self._sample_rng(idx))


# ---------------------------------------------------------------------------
# ActivityNet paragraph retrieval (reference:
# dataloader_activitynet_retrieval.py)
# ---------------------------------------------------------------------------
class ActivityNetDataset(VideoTextDataset):
    BROKEN = ("NHznDFD3V3k", "v_NHznDFD3V3k")

    def __init__(self, subset: str, data_path: str, features_path: str, **kw):
        assert subset in ("train", "val")
        super().__init__(is_train=(subset == "train"), **kw)
        ids_file = os.path.join(data_path, f"{subset}_ids.json")
        json_file = os.path.join(
            data_path, "train.json" if subset == "train" else "val_1.json")
        with open(ids_file) as f:
            pseudo_ids = list(json.load(f))
        video_ids = [p[2:] for p in pseudo_ids]   # strip 'v_'
        with open(json_file) as f:
            corpus = json.load(f)
        # one paragraph per video over [0, ceil(duration)]
        # (dataloader_activitynet_retrieval.py:131-142)
        self.caption_dict = {}
        for pid, v in corpus.items():
            self.caption_dict[pid] = {
                "start": [0],
                "end": [int(math.ceil(float(v["duration"])))],
                "text": [" ".join(v["sentences"])],
            }
        for b in self.BROKEN:
            if b in pseudo_ids:
                i = pseudo_ids.index(b)
                del pseudo_ids[i], video_ids[i]
            if b in video_ids:
                i = video_ids.index(b)
                del pseudo_ids[i], video_ids[i]
        with open(os.path.join(data_path, "video_path.json")) as f:
            all_video = json.load(f)
        self.video_dict = {k: os.path.join(features_path, all_video[k])
                           for k in video_ids if k in all_video}
        self.pairs = {}
        for pid, vid in zip(pseudo_ids, video_ids):
            if pid not in self.caption_dict or vid not in self.video_dict:
                continue
            for sub_id in range(len(self.caption_dict[pid]["start"])):
                self.pairs[len(self.pairs)] = (pid, vid, sub_id)

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx):
        pid, vid, sub_id = self.pairs[idx]
        cap = self.caption_dict[pid]
        start, end = _sanitise_window(cap["start"][sub_id],
                                      cap["end"][sub_id])
        return self._sample(cap["text"][sub_id], self.video_dict[vid],
                            start=start, end=end, rng=self._sample_rng(idx))


# ---------------------------------------------------------------------------
# DiDeMo (reference: dataloader_didemo_retrieval.py)
# ---------------------------------------------------------------------------
class DiDeMoDataset(VideoTextDataset):
    MISSING = ("37996615073@N01_3336195519_579ea4136c.3gp",
               "44124421772@N01_2867159874_e39e716b7e.mpg",
               "59627558@N00_4659075184_253744838b.3gp")

    def __init__(self, subset: str, data_path: str, features_path: str, **kw):
        assert subset in ("train", "val", "test")
        super().__init__(is_train=(subset == "train"), **kw)
        with open(os.path.join(data_path, f"{subset}_list.txt")) as fp:
            video_ids = [l.strip() for l in fp if l.strip()]
        for m in self.MISSING:
            if m in video_ids:
                video_ids.remove(m)
        with open(os.path.join(data_path, f"{subset}_data.json")) as f:
            corpus = json.load(f)
        caption_dict: Dict[str, Dict] = {}
        for itm in corpus:
            video = itm["video"]
            if video not in video_ids:
                continue
            caption_dict.setdefault(video, {"text": []})
            caption_dict[video]["text"].append(itm["description"])
        # whole-video [0, 31]s override (didemo annotations are capped at
        # 30 s; dataloader_didemo_retrieval.py:90-96)
        for v in caption_dict.values():
            v["start"], v["end"] = [0], [31]
            v["text"] = [" ".join(v["text"])]
        self.video_dict = {}
        for root, _, files in os.walk(features_path):
            for fname in files:
                if fname in video_ids:
                    self.video_dict[fname] = os.path.join(root, fname)
                if fname[:-4] in video_ids:
                    self.video_dict[fname[:-4]] = os.path.join(root, fname)
        keep = set(video_ids) & set(caption_dict) & set(self.video_dict)
        self.caption_dict = caption_dict
        self.pairs = {}
        for video_id in caption_dict:
            if video_id not in keep:
                continue
            for sub_id in range(len(caption_dict[video_id]["start"])):
                self.pairs[len(self.pairs)] = (video_id, sub_id)

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx):
        video_id, sub_id = self.pairs[idx]
        cap = self.caption_dict[video_id]
        start, end = _sanitise_window(cap["start"][sub_id],
                                      cap["end"][sub_id])
        return self._sample(cap["text"][sub_id], self.video_dict[video_id],
                            start=start, end=end, rng=self._sample_rng(idx))


def _sanitise_window(start, end):
    """reference: dataloader_activitynet_retrieval.py:192-201"""
    start, end = max(int(start), 0), max(int(end), 0)
    if start > end:
        start, end = end, start
    elif start == end:
        end = end + 1
    return start, end
