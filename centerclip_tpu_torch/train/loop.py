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
on the device until they are logged.
"""
from __future__ import annotations

import logging
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
    tensors) -> tensors on `device`; token ids become int64."""
    out = {}
    for key in ("input_ids", "attention_mask", "video", "video_mask"):
        t = torch.as_tensor(batch[key])
        if key == "input_ids":
            t = t.long()
        out[key] = t.to(device, non_blocking=True)
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
    frozen parameters it marks `requires_grad=False`)."""

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

    def _log(self, epoch: int, gstep: int, logs: Dict[str, torch.Tensor],
             data_time: float, batch_time: float) -> None:
        logger.info(
            "Epoch: %d step %d\tSimLoss: %.4f CLoss %.4f\tData (t) %.3f\t"
            "Batch (t) %.3f\tLR: %.1e\tlogit_scale %.3f", epoch, gstep,
            float(logs["sim_loss"]), float(logs["cluster_loss"]), data_time,
            batch_time, current_lr(self.cfg.optim, gstep, self.total_steps),
            float(self.model.clip.logit_scale.detach()))

    def train_epoch(self, epoch: int, batches: Iterable[Batch],
                    n_display: int = 100) -> Tuple[float, int]:
        """One pass over host batches of numpy arrays.  Returns (mean loss
        over the optimizer steps, global_step)."""
        loss_log: List[torch.Tensor] = []
        micro: List[Batch] = []
        end = time.time()
        for batch in batches:
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
            loss_log.append(logs["loss"])
            batch_time = time.time() - end
            end = time.time()
            if self.state.global_step % n_display == 0:
                self._log(epoch, self.state.global_step, logs, data_time,
                          batch_time)
        if micro:
            # epoch tail: step on the mean over the micro-batches left
            # (JAX package train/loop.py:210-224)
            logger.info("Epoch %d: flushing %d tail micro-batch(es)", epoch,
                        len(micro))
            loss_log.append(self._step_fn(micro)["loss"])
            self.state.global_step += 1
        total = float(torch.stack(loss_log).sum()) if loss_log else 0.0
        return total / max(len(loss_log), 1), self.state.global_step
