# coding=utf-8
"""Train state and checkpoints (port of the JAX package's `train/state.py`).

A checkpoint carries the JAX package's payload (reference: main.py:262-272,
utils/misc.py:14-18): the parameters under their torch keys, the optimizer
state (moments by parameter name and its step) and `{epoch, global_step,
best_r1}`, written with `torch.save` as `<dir>/ckpt_<epoch>`, with
`ckpt_latest` a symlink to the newest and `ckpt_best` a copy of the best.
`export_torch_checkpoint` writes the reference's own `ckpt.pth.tar` schema,
which `import_torch_checkpoint` (and the JAX package's) read back;
`init_from_pretrained_clip` starts a model from OpenAI's CLIP weights.
Both load with `strict=False` and report the missing and unexpected keys.
"""
from __future__ import annotations

import os
import shutil
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..config import ModelConfig
from ..models.weights import (apply_pretrain_tricks, clip4clip_entries,
                              load_torch_checkpoint)
from .optim import GroupedAdam


@dataclass
class TrainState:
    """The model (its parameters), the optimizer (moments and its own
    step) and the number of optimizer steps taken, `global_step`."""
    model: nn.Module
    optimizer: GroupedAdam
    global_step: int = 0


def _replace_link(link: str, target: str) -> None:
    if os.path.islink(link) or os.path.isfile(link):
        os.unlink(link)
    os.symlink(target, link)


def save_checkpoint(ckpt_dir: str, state: TrainState, epoch: int,
                    best_r1: float, is_best: bool = False) -> str:
    """Write `<ckpt_dir>/ckpt_<epoch>`; point `ckpt_latest` at it and copy
    it to `ckpt_best` when `is_best` (misc.py:14-18).  Returns its path."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{epoch}")
    payload = {
        "params": {k: v.detach().cpu().clone()
                   for k, v in state.model.state_dict().items()},
        "opt_state": state.optimizer.state_dict(),
        "meta": {"epoch": int(epoch), "global_step": int(state.global_step),
                 "best_r1": float(best_r1)},
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    _replace_link(os.path.join(ckpt_dir, "ckpt_latest"), path)
    if is_best:
        shutil.copyfile(path, os.path.join(ckpt_dir, "ckpt_best"))
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The payload of a checkpoint written by `save_checkpoint`, on the
    CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def resume(path: str, state: TrainState, load_weights_only: bool = False
           ) -> Tuple[TrainState, int, float]:
    """Resume semantics of the reference (main.py:188-212): a full restore
    of parameters, optimizer state and counters, or the weights only.
    Loads into `state` in place; returns (state, the epoch to start at,
    best_r1).  `ckpt_<e>` is written after epoch e, so a full restore starts
    at e + 1 (the JAX package returns e and trains epoch e a second time);
    the weights alone start at epoch 0."""
    payload = load_checkpoint(path)
    state.model.load_state_dict(payload["params"], strict=True)
    if load_weights_only:
        return state, 0, 0.0
    state.optimizer.load_state_dict(payload["opt_state"])
    meta = payload["meta"]
    state.global_step = int(meta["global_step"])
    return state, int(meta["epoch"]) + 1, float(meta["best_r1"])


def export_torch_checkpoint(model: nn.Module, path: str, epoch: int = 0,
                            global_step: int = 0, best_r1: float = 0.0,
                            arch: str = "CLIP4Clip") -> None:
    """Write a reference-compatible ckpt.pth.tar (main.py:262-272 schema,
    JAX package `train/state.py:124-136`)."""
    torch.save({
        "epoch": epoch, "global_step": global_step, "arch": arch,
        "state_dict": {k: v.detach().cpu().clone()
                       for k, v in model.state_dict().items()},
        "best_acc1": best_r1,
    }, path)


def import_torch_checkpoint(path: str, cfg: ModelConfig,
                            model: Optional[nn.Module] = None
                            ) -> Tuple[Dict[str, torch.Tensor],
                                       Dict[str, List[str]]]:
    """Read a reference torch checkpoint (or raw CLIP weights) for the model
    of `cfg`, with the pretrain tricks applied (JAX package
    `train/state.py:139-144`).  Returns (state dict of the model's keys
    found, {missing, unexpected}); loads it into `model` with
    `strict=False` when one is given."""
    sd = apply_pretrain_tricks(load_torch_checkpoint(path), cfg)
    keys = [key for _, key, _ in clip4clip_entries(cfg)]
    known = set(keys)
    report = {"missing": [k for k in keys if k not in sd],
              "unexpected": [k for k in sd if k not in known]}
    sd = {k: sd[k] for k in keys if k in sd}
    if model is not None:
        model.load_state_dict(sd, strict=False)
    return sd, report


def init_from_pretrained_clip(pretrained_path: str, cfg: ModelConfig,
                              model: Optional[nn.Module] = None,
                              temperature_new: float = 1.0
                              ) -> Tuple[Dict[str, torch.Tensor],
                                         Dict[str, List[str]]]:
    """CLIP4Clip.from_pretrained analogue (clip4clip.py:28-124): OpenAI's CLIP
    weights with the seeding tricks; `temperature_new > 1` overrides the
    logit scale with that value (JAX package `train/state.py:147-159`)."""
    sd, report = import_torch_checkpoint(pretrained_path, cfg)
    if temperature_new > 1.0:
        sd["clip.logit_scale"] = torch.tensor(temperature_new,
                                              dtype=torch.float32)
    if model is not None:
        model.load_state_dict(sd, strict=False)
    return sd, report
