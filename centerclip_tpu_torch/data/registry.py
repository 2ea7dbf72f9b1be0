# coding=utf-8
"""Dataloader registry (port of the JAX package's `data/registry.py`;
reference: dataloaders/data_dataloaders.py:12-270).

`DATALOADER_DICT[datatype]` maps to {train, val, test} factories; msrvtt and
activity have `test=None`, so evaluation falls back to the val loader exactly
like the reference (main.py:142-149).  Every factory takes the run's
`device`: on a CUDA device its loader pins the batches' host memory.  The
port runs one process, so the train loader's shard is (0, 1).
"""
from __future__ import annotations

import json

import torch

from ..config import RunConfig
from ..models.tokenizer import SimpleTokenizer
from .datasets import (ActivityNetDataset, DiDeMoDataset, LSMDCDataset,
                       MSRVTTEvalDataset, MSRVTTTrainDataset, MSVDDataset,
                       read_csv)
from .loader import BatchLoader


def _common_kwargs(cfg: RunConfig) -> dict:
    d = cfg.data
    return dict(max_words=d.max_words, max_frames=d.max_frames,
                image_resolution=d.image_resolution,
                lmdb_dataset=d.lmdb_dataset, seed=cfg.seed,
                video_suffix=d.video_suffix, raw_pixels=d.raw_pixels)


def _pin(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def _train_loader(cfg: RunConfig, dataset, device):
    # one process reads the whole global batch: the loader's default shard
    # (0, 1)
    loader = BatchLoader(dataset, cfg.batch_size, shuffle=True,
                         drop_last=True,
                         num_threads=cfg.data.num_thread_reader,
                         seed=cfg.seed, pin_memory=_pin(device))
    return loader, len(dataset), loader


def _eval_loader(cfg: RunConfig, dataset, device):
    loader = BatchLoader(dataset, cfg.batch_size_val, shuffle=False,
                         drop_last=False,
                         num_threads=cfg.data.num_thread_reader,
                         pin_memory=_pin(device))
    return loader, len(dataset)


def _fstore_pairs_msrvtt_train(cfg: RunConfig):
    csv = read_csv(cfg.data.train_csv)
    with open(cfg.data.data_path) as f:
        corpus = json.load(f)
    if cfg.data.expand_msrvtt_sentences:
        ids = set(csv["video_id"])
        return [(i["video_id"], i["caption"]) for i in corpus["sentences"]
                if i["video_id"] in ids]
    first = {}
    for i in corpus["sentences"]:
        first.setdefault(i["video_id"], i["caption"])
    return [(v, first[v]) for v in csv["video_id"] if v in first]


def _maybe_fstore(cfg: RunConfig, tokenizer, pairs_fn, is_train: bool):
    """When --features_path points at a .fstore container, use the native
    C++ fast path (one batched gather per step)."""
    if not cfg.data.features_path.endswith(".fstore"):
        return None
    from .fast_dataset import FrameStoreClipDataset
    return FrameStoreClipDataset(
        cfg.data.features_path, pairs_fn(cfg), tokenizer,
        max_words=cfg.data.max_words, max_frames=cfg.data.max_frames,
        image_resolution=cfg.data.image_resolution, is_train=is_train,
        num_threads=max(cfg.data.num_thread_reader, 1), seed=cfg.seed,
        device_normalize=True)


# --- msrvtt ------------------------------------------------------------------
def dataloader_msrvtt_train(cfg: RunConfig, tokenizer: SimpleTokenizer,
                            device=None):
    ds = _maybe_fstore(cfg, tokenizer, _fstore_pairs_msrvtt_train, True)
    if ds is None:
        ds = MSRVTTTrainDataset(
            csv_path=cfg.data.train_csv, json_path=cfg.data.data_path,
            features_path=cfg.data.features_path,
            unfold_sentences=cfg.data.expand_msrvtt_sentences,
            frame_order=cfg.data.train_frame_order,
            slice_framepos=cfg.data.slice_framepos,
            tokenizer=tokenizer, **_common_kwargs(cfg))
    return _train_loader(cfg, ds, device)


def _fstore_pairs_msrvtt_eval(cfg: RunConfig):
    df = read_csv(cfg.data.val_csv)
    return list(zip(df["video_id"], df["sentence"]))


def dataloader_msrvtt_test(cfg: RunConfig, tokenizer: SimpleTokenizer,
                           subset: str = "test", device=None):
    ds = _maybe_fstore(cfg, tokenizer, _fstore_pairs_msrvtt_eval, False)
    if ds is None:
        ds = MSRVTTEvalDataset(
            csv_path=cfg.data.val_csv, features_path=cfg.data.features_path,
            frame_order=cfg.data.eval_frame_order,
            slice_framepos=cfg.data.slice_framepos,
            tokenizer=tokenizer, **_common_kwargs(cfg))
    return _eval_loader(cfg, ds, device)


# --- msvd --------------------------------------------------------------------
def dataloader_msvd_train(cfg: RunConfig, tokenizer: SimpleTokenizer,
                          device=None):
    ds = MSVDDataset(subset="train", data_path=cfg.data.data_path,
                     features_path=cfg.data.features_path,
                     tokenizer=tokenizer, **_common_kwargs(cfg))
    return _train_loader(cfg, ds, device)


def dataloader_msvd_test(cfg: RunConfig, tokenizer: SimpleTokenizer,
                         subset: str = "test", device=None):
    ds = MSVDDataset(subset=subset, data_path=cfg.data.data_path,
                     features_path=cfg.data.features_path,
                     tokenizer=tokenizer, **_common_kwargs(cfg))
    return _eval_loader(cfg, ds, device)


# --- lsmdc -------------------------------------------------------------------
def dataloader_lsmdc_train(cfg: RunConfig, tokenizer: SimpleTokenizer,
                           device=None):
    ds = LSMDCDataset(subset="train", data_path=cfg.data.data_path,
                      features_path=cfg.data.features_path,
                      tokenizer=tokenizer, **_common_kwargs(cfg))
    return _train_loader(cfg, ds, device)


def dataloader_lsmdc_test(cfg: RunConfig, tokenizer: SimpleTokenizer,
                          subset: str = "test", device=None):
    ds = LSMDCDataset(subset=subset, data_path=cfg.data.data_path,
                      features_path=cfg.data.features_path,
                      tokenizer=tokenizer, **_common_kwargs(cfg))
    return _eval_loader(cfg, ds, device)


# --- activitynet ---------------------------------------------------------------
def dataloader_activity_train(cfg: RunConfig, tokenizer: SimpleTokenizer,
                              device=None):
    ds = ActivityNetDataset(subset="train", data_path=cfg.data.data_path,
                            features_path=cfg.data.features_path,
                            tokenizer=tokenizer, **_common_kwargs(cfg))
    return _train_loader(cfg, ds, device)


def dataloader_activity_val(cfg: RunConfig, tokenizer: SimpleTokenizer,
                            subset: str = "val", device=None):
    ds = ActivityNetDataset(subset="val", data_path=cfg.data.data_path,
                            features_path=cfg.data.features_path,
                            tokenizer=tokenizer, **_common_kwargs(cfg))
    return _eval_loader(cfg, ds, device)


# --- didemo ------------------------------------------------------------------
def dataloader_didemo_train(cfg: RunConfig, tokenizer: SimpleTokenizer,
                            device=None):
    ds = DiDeMoDataset(subset="train", data_path=cfg.data.data_path,
                       features_path=cfg.data.features_path,
                       tokenizer=tokenizer, **_common_kwargs(cfg))
    return _train_loader(cfg, ds, device)


def dataloader_didemo_test(cfg: RunConfig, tokenizer: SimpleTokenizer,
                           subset: str = "test", device=None):
    ds = DiDeMoDataset(subset=subset, data_path=cfg.data.data_path,
                       features_path=cfg.data.features_path,
                       tokenizer=tokenizer, **_common_kwargs(cfg))
    return _eval_loader(cfg, ds, device)


DATALOADER_DICT = {
    "msrvtt": {"train": dataloader_msrvtt_train,
               "val": dataloader_msrvtt_test, "test": None},
    "msvd": {"train": dataloader_msvd_train,
             "val": dataloader_msvd_test, "test": dataloader_msvd_test},
    "lsmdc": {"train": dataloader_lsmdc_train,
              "val": dataloader_lsmdc_test, "test": dataloader_lsmdc_test},
    "activity": {"train": dataloader_activity_train,
                 "val": dataloader_activity_val, "test": None},
    "didemo": {"train": dataloader_didemo_train,
               "val": dataloader_didemo_test,
               "test": dataloader_didemo_test},
}
