"""Synthetic video-text data.

Clips are smooth colour fields that drift from frame to frame, with pixel
noise on top: a 7 x 7 field per clip and a 14 x 14 one per frame,
upsampled bilinearly, so that neighbouring patches and frames are alike
as in real video and k-medoids has structure to find.  Captions are 4 to
24 words drawn from a fixed list.

`ensure_msrvtt` writes a training set in MSR-VTT's layout (a `.fstore`
of the clips, `MSRVTT_data.json` with the captions, the train csv) once
per checkout under `portbench/.cache/data/`, from a fixed seed: the data
set is the same in every run and every checkout, and a run's seed picks
the order in which it is read (and the weights).  Beside them it keeps
each clip's SHA-1 as made here, by which `wrong_rows` holds the batches
that the program's data layer handed out to the clips and captions made
here; `repeated_rows` finds a row that the batches hold twice (a shard read
by two ranks).  `gallery` makes the encode cell's clips from the run's
seed in pinned host memory.
"""
from __future__ import annotations

import csv
import hashlib
import json
import os
import shutil
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch.nn import functional as F

WORDS = (
    "a man woman person child dog cat car bike ball kitchen street park "
    "beach room stage field road river house table plays cooks drives "
    "talks sings dances runs walks jumps rides throws shows explains "
    "red blue green small large old young happy fast slow with on in at "
    "near while the of and to from video clip music game food water snow "
    "night day crowd team song news cartoon animal people group players "
    "guitar piano camera phone screen computer book paper train boat").split()


def clips(n: int, frames: int, size: int, gen: torch.Generator,
          device) -> torch.Tensor:
    """[n, frames, 3, size, size] uint8 clips."""
    base = torch.randn((n, 1, 3, 7, 7), generator=gen, device=device)
    drift = torch.randn((n, frames, 3, 14, 14), generator=gen, device=device)
    noise = torch.randn((n, frames, 3, size, size), generator=gen,
                        device=device)
    up = lambda x: F.interpolate(x.flatten(0, 1), size=(size, size),
                                 mode="bilinear", align_corners=False
                                 ).view(n, -1, 3, size, size)
    x = up(base) + 0.5 * up(drift) + 0.15 * noise
    return (128.0 + 50.0 * x).round().clamp(0, 255).to(torch.uint8)


def captions(n: int, rng: np.random.Generator) -> List[str]:
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(4, 25))))
            for _ in range(n)]


def msrvtt_captions(videos: int, captions_per_clip: int,
                    seed: int = 20) -> Dict[str, List[str]]:
    """{video id: its captions} of the training set."""
    rng = np.random.default_rng(seed)
    return {f"video{i:05d}": captions(captions_per_clip, rng)
            for i in range(videos)}


def _sha1(clip: torch.Tensor) -> str:
    """Of a [T, 3, H, W] uint8 clip."""
    return hashlib.sha1(clip.contiguous().numpy().tobytes()).hexdigest()


def ensure_msrvtt(root: str, videos: int, frames: int, size: int,
                  captions_per_clip: int, seed: int = 20) -> dict:
    """The training set's paths {features_path, data_path, train_csv,
    val_csv}, written under `root` if it is not complete there (a file
    `done` is written last)."""
    paths = {"features_path": os.path.join(root, "videos.fstore"),
             "data_path": os.path.join(root, "MSRVTT_data.json"),
             "train_csv": os.path.join(root, "train.csv"),
             "val_csv": os.path.join(root, "train.csv")}
    if os.path.exists(os.path.join(root, "done")):
        return paths
    from centerclip_tpu_torch.data.framestore import FrameStoreWriter
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    gen = torch.Generator().manual_seed(seed)
    caps = msrvtt_captions(videos, captions_per_clip, seed)
    ids = list(caps)
    sums = {}
    with FrameStoreWriter(paths["features_path"]) as w:
        for a in range(0, videos, 16):
            block = clips(min(16, videos - a), frames, size, gen, "cpu")
            for j, clip in enumerate(block):
                sums[ids[a + j]] = _sha1(clip)
                w.add(ids[a + j], clip.permute(0, 2, 3, 1).numpy())
    with open(os.path.join(root, "clips.json"), "w") as f:
        json.dump(sums, f)
    sentences = [{"video_id": v, "caption": c, "sen_id": i}
                 for i, (v, c) in enumerate(
                     (v, c) for v in ids for c in caps[v])]
    with open(paths["data_path"], "w") as f:
        json.dump({"videos": [{"video_id": v} for v in ids],
                   "sentences": sentences}, f)
    with open(paths["train_csv"], "w", newline="") as f:
        out = csv.writer(f)
        out.writerow(["video_id", "sentence"])
        for v in ids:
            out.writerow([v, "a clip"])
    open(os.path.join(root, "done"), "w").close()
    return paths


def wrong_rows(batches: Sequence[dict], root: str, videos: int,
               captions_per_clip: int, max_words: int,
               seed: int = 20) -> int:
    """The rows of `batches` (the data layer's, as the trainer got them)
    whose frames are not those of a clip of the set under `root` in
    order, whose frames are masked off, or whose token ids are not those
    of one of that clip's captions."""
    from .reference.tokens import Vocab
    with open(os.path.join(root, "clips.json")) as f:
        clip_of = {h: v for v, h in json.load(f).items()}
    vocab = Vocab()
    want = {v: {vocab.caption(c, max_words) for c in cs}
            for v, cs in msrvtt_captions(videos, captions_per_clip,
                                         seed).items()}
    wrong = 0
    for b in batches:
        video = torch.as_tensor(b["video"])
        video = video.reshape(video.shape[0], -1, *video.shape[-3:])
        ids = np.asarray(b["input_ids"])
        mask = np.asarray(b["video_mask"])
        for i in range(video.shape[0]):
            v = clip_of.get(_sha1(video[i]))
            if v is None or not mask[i].all() or \
                    tuple(int(t) for t in ids[i]) not in want[v]:
                wrong += 1
    return wrong


def join_rows(parts: Sequence[dict]) -> dict:
    """One batch of the parts' rows, part after part (each key joined on
    its first axis)."""
    return {k: (torch.cat([torch.as_tensor(p[k]) for p in parts])
                if isinstance(parts[0][k], torch.Tensor)
                else np.concatenate([np.asarray(p[k]) for p in parts]))
            for k in parts[0]}


def repeated_rows(batches: Sequence[dict]) -> int:
    """The rows of `batches` whose frames and token ids are those of a
    row before them: within an epoch the data layer hands out each pair
    once, so a repeat is a shard read twice."""
    seen, repeats = set(), 0
    for b in batches:
        video = torch.as_tensor(b["video"])
        video = video.reshape(video.shape[0], -1, *video.shape[-3:])
        ids = np.asarray(b["input_ids"])
        for i in range(video.shape[0]):
            key = (_sha1(video[i]), ids[i].tobytes())
            repeats += key in seen
            seen.add(key)
    return repeats


def gallery(n: int, frames: int, size: int, batch: int, seed: int,
            device) -> List[dict]:
    """The encode cell's gallery: batches of {"video": [b, 1, T, 3, H, W]
    uint8, "video_mask": [b, T] int32}, in pinned host memory where the
    device is a card, made on the device from `seed`."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed((seed + 1) % (2 ** 63))
    pin = device.type == "cuda"
    out = []
    for a in range(0, n, batch):
        b = min(batch, n - a)
        host = torch.empty((b, 1, frames, 3, size, size), dtype=torch.uint8,
                           pin_memory=pin)
        for c in range(0, b, 32):
            host[c:c + 32, 0].copy_(clips(min(32, b - c), frames, size, gen,
                                          device))
        out.append({"video": host, "video_mask": torch.ones(
            (b, frames), dtype=torch.int32, pin_memory=pin)})
    return out
