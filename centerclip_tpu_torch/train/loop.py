# coding=utf-8
"""Training loop (port of the JAX package's `train/loop.py`; reference:
main.py:291-378).

A train step is forward (symmetric InfoNCE over the batch), backward
(through the attention, LayerNorm and k-medoids kernels on the card),
global-norm clip, the optimizer update and the logit-scale clamp to
[0.1, ln 100] (main.py:336-340).  PyTorch runs eagerly and updates the
parameters and moments in place.  Gradient accumulation sums the
micro-batches' gradients in `.grad` and divides by however many there
were, so an epoch's tail steps on the mean of what is left.  Losses stay
on the device until they are logged.  Host batches may be numpy arrays or
tensors in pinned memory (the data loader's `pin_memory`), whose copy to
the card is then asynchronous.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, Iterable, List, Mapping, Tuple, Union

import numpy as np
import torch

from ..config import RunConfig
from ..models.clip4clip import CLIP4Clip
from .optim import GroupedAdam, build_optimizer, current_lr
from .state import TrainState

logger = logging.getLogger(__name__)

LOGIT_SCALE_MIN, LOGIT_SCALE_MAX = 0.1, 4.6052  # ln(100), main.py:336-340
LOSS_KEYS = ("loss", "sim_loss", "cluster_loss")

Batch = Mapping[str, Union[np.ndarray, torch.Tensor]]


@torch.no_grad()
def clamp_logit_scale(model: CLIP4Clip) -> None:
    model.clip.logit_scale.clamp_(LOGIT_SCALE_MIN, LOGIT_SCALE_MAX)


def batch_to_device(batch: Batch, device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    """Host batch {input_ids, attention_mask, video, video_mask} (numpy or
    tensors) -> tensors on `device`; token ids become int64 there.  A
    pinned tensor is copied as it is, so the copy does not block the
    host."""
    out = {}
    for key in ("input_ids", "attention_mask", "video", "video_mask"):
        t = torch.as_tensor(batch[key]).to(device, non_blocking=True)
        out[key] = t.long() if key == "input_ids" else t
    return out


def make_train_step(model: CLIP4Clip, optimizer: GroupedAdam,
                    accum_steps: int = 1) -> Callable:
    """The train step.  With `accum_steps <= 1` it takes one batch, else a
    list of micro-batches (any number).  It returns {loss, sim_loss,
    cluster_loss} as device scalars, the means over the micro-batches.
    After it returns, each trainable parameter's `.grad` holds the clipped
    gradient the update used."""
    device = model.device

    def _grad(batch: Batch) -> torch.Tensor:
        out = model(**batch_to_device(batch, device), training=True)
        out["loss"].backward()
        return torch.stack([out[k].detach() for k in LOSS_KEYS])

    def _apply() -> None:
        optimizer.step()
        clamp_logit_scale(model)

    def single_step(batch: Batch) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad()
        losses = _grad(batch)
        _apply()
        return dict(zip(LOSS_KEYS, losses.unbind()))

    if accum_steps <= 1:
        return single_step

    def accum_step(micro_batches: List[Batch]) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad()
        losses = torch.stack([_grad(mb) for mb in micro_batches])
        with torch.no_grad():
            torch._foreach_div_(optimizer.grads(), float(losses.shape[0]))
        _apply()
        return dict(zip(LOSS_KEYS, losses.mean(dim=0).unbind()))

    return accum_step


class Trainer:
    """Epoch loop (reference: main_worker + train_epoch,
    main.py:72-378).  Builds the configured optimizer over `model` (whose
    frozen parameters it marks `requires_grad=False`).  Set
    `metric_writer` (a `utils.logging.MetricWriter`) to record the scalars
    of every displayed step."""

    def __init__(self, cfg: RunConfig, model: CLIP4Clip, total_steps: int):
        self.cfg = cfg
        self.model = model
        self.optimizer = build_optimizer(
            cfg.optim, model, total_steps,
            freeze_layer_num=cfg.freeze_layer_num, freeze_clip=cfg.freeze_clip)
        self.state = TrainState(model, self.optimizer, 0)
        self.total_steps = total_steps
        self.accum = cfg.optim.gradient_accumulation_steps
        self._step_fn = make_train_step(model, self.optimizer, self.accum)
        self.metric_writer = None

    def _log(self, epoch: int, gstep: int, scalars: Dict[str, float]
             ) -> None:
        logger.info(
            "Epoch: %d step %d\tSimLoss: %.4f CLoss %.4f\tData (t) %.3f\t"
            "Batch (t) %.3f\tLR: %.1e\tlogit_scale %.3f", epoch, gstep,
            scalars["train/sim_loss"], scalars["train/cluster_loss"],
            scalars["train/data_time"], scalars["train/batch_time"],
            scalars["train/lr"], scalars["train/scale"])
        if self.metric_writer is not None:
            self.metric_writer.log(scalars, step=gstep)

    def _start_profiler(self):
        """torch.profiler over epoch 0's first `profile_steps` batches
        (the JAX package's `jax.profiler` trace, train/loop.py:161-169)."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.model.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof

    def _stop_profiler(self, prof) -> None:
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)
        prof.stop()
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        path = os.path.join(self.cfg.profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        logger.info("profiler trace of %d steps written to %s",
                    self.cfg.profile_steps, path)

    def train_epoch(self, epoch: int, batches: Iterable[Batch],
                    n_display: int = 100) -> Tuple[float, int]:
        """One pass over host batches (numpy arrays or pinned tensors).
        Returns (mean loss over the optimizer steps, global_step).

        A displayed step (every `n_display`-th) reads its losses back
        before its clock stops, so its `Batch (t)` is the whole step on the
        card, waiting for the batch included, and its `Data (t)` only the
        wait for the batch."""
        loss_log: List[torch.Tensor] = []
        micro: List[Batch] = []
        prof = (self._start_profiler()
                if epoch == 0 and self.cfg.profile_dir else None)
        end = time.time()
        for step, batch in enumerate(batches):
            if prof is not None and step == self.cfg.profile_steps:
                self._stop_profiler(prof)
                prof = None
            data_time = time.time() - end
            if self.accum > 1:
                micro.append(batch)
                if len(micro) < self.accum:
                    continue
                logs = self._step_fn(micro)
                micro = []
            else:
                logs = self._step_fn(batch)
            self.state.global_step += 1
            gstep = self.state.global_step
            loss_log.append(logs["loss"])
            display = gstep % n_display == 0
            if display:
                scalars = {
                    "train/sim_loss": float(logs["sim_loss"]),
                    "train/cluster_loss": float(logs["cluster_loss"]),
                    "train/scale": float(self.model.clip.logit_scale.detach()),
                    "train/lr": current_lr(self.cfg.optim, gstep,
                                           self.total_steps)}
            batch_time = time.time() - end
            end = time.time()
            if display:
                self._log(epoch, gstep, {**scalars,
                                         "train/data_time": data_time,
                                         "train/batch_time": batch_time})
        if prof is not None:
            self._stop_profiler(prof)
        if micro:
            # epoch tail: step on the mean over the micro-batches left
            # (JAX package train/loop.py:210-224)
            logger.info("Epoch %d: flushing %d tail micro-batch(es)", epoch,
                        len(micro))
            loss_log.append(self._step_fn(micro)["loss"])
            self.state.global_step += 1
        total = float(torch.stack(loss_log).sum()) if loss_log else 0.0
        return total / max(len(loss_log), 1), self.state.global_step
