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

Each optimizer step draws its random choices (`sparse_sampling`'s token
columns) from its own `torch.Generator` on the model's device, seeded from
(`cfg.seed`, the global step): the counterpart of the JAX package's
`jax.random.fold_in(rng, step)`, so a resumed run draws what the
uninterrupted run drew.  The draws themselves are not `jax.random`'s.

Under `torchrun` the `Trainer` builds the mesh from the config, `"data"`,
`("data", "model")` with `cfg.tensor_parallel > 1` or `("data", "pipe")`
with `cfg.model.pipeline_parallel > 1`, and wraps the model
(`parallel.shard_params`: the tensor-parallel slices or the towers'
pipe axes, then DDP, or FSDP with `cfg.fsdp`, over the data axis); each
model or pipe group steps on its rows of the global batch, the model's
loss is the global batch's (`CLIP4Clip.forward`), and a step's update is
the one-process update at the global batch.  With
`cfg.model.sequence_parallel` the gradients it leaves partial are summed
over the model group before the update
(`parallel.mesh.reduce_sequence_parallel_grads`); under pipeline
parallelism the pipeline's backward already hands every rank the whole
gradients (`parallel/pipeline.py`), so the clipping sees the gradients
after the pipe sum.  Gradient accumulation reduces the gradients on its
last micro-batch only.  The logged losses are the means over the ranks.
A process count other than the world size raises.

Each optimizer step runs in a `train.step` span holding `train.h2d`,
`train.forward`, `train.backward` and `train.update` (`utils/spans.py`;
recorded when the recorder is on, as over `--profile_dir`'s steps).
"""
from __future__ import annotations

import logging
import os
import time
from typing import (Callable, Dict, Iterable, List, Mapping, Optional,
                    Tuple, Union)

import numpy as np
import torch

from ..config import RunConfig
from ..models.clip4clip import CLIP4Clip
from ..parallel.collectives import psum
from ..parallel.mesh import (block_heads, create_mesh, gradient_sync,
                             reduce_replicated_grads,
                             reduce_sequence_parallel_grads, shard_batch,
                             shard_params, unwrap, world_size)
from ..utils import spans
from .optim import GroupedAdam, build_optimizer, current_lr, set_trainable
from .state import TrainState

logger = logging.getLogger(__name__)

LOGIT_SCALE_MIN, LOGIT_SCALE_MAX = 0.1, 4.6052  # ln(100), main.py:336-340
LOSS_KEYS = ("loss", "sim_loss", "cluster_loss")

Batch = Mapping[str, Union[np.ndarray, torch.Tensor]]


@torch.no_grad()
def clamp_logit_scale(model: CLIP4Clip) -> None:
    model.clip.logit_scale.clamp_(LOGIT_SCALE_MIN, LOGIT_SCALE_MAX)


# host batch {input_ids, attention_mask, video, video_mask} -> tensors on
# the device (`parallel.mesh.shard_batch`)
batch_to_device = shard_batch


def step_generator(seed: int, global_step: int, device) -> torch.Generator:
    """The generator of optimizer step `global_step` (1-based): a function
    of (seed, step) only."""
    state = np.random.SeedSequence([seed, global_step]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def make_train_step(model: torch.nn.Module, optimizer: GroupedAdam,
                    accum_steps: int = 1) -> Callable:
    """The train step of `model`, a `CLIP4Clip` or the module that wraps it
    for data parallelism (`parallel.shard_params`).  With `accum_steps <=
    1` it takes one batch, else a list of micro-batches (any number), and
    an optional generator for the model's random choices (the
    micro-batches draw from it in turn).  It returns {loss, sim_loss,
    cluster_loss} as device scalars, the means over the micro-batches and
    the ranks.  After it returns, each trainable parameter's `.grad` holds
    the clipped gradient the update used (under FSDP, this rank's
    shard; under tensor parallelism, of this rank's slice)."""
    net = unwrap(model)
    device = net.device
    world = world_size()

    def _grad(batch: Batch, generator, sync: bool = True) -> torch.Tensor:
        with gradient_sync(model, sync):
            with spans.span("train.h2d"):
                inputs = batch_to_device(batch, device)
            with spans.span("train.forward"):
                out = model(**inputs, training=True, generator=generator)
            # the card's copy of the batch goes before the backward, whose
            # peak memory it would raise
            del inputs
            with spans.span("train.backward"):
                out["loss"].backward()
        return torch.stack([out[k].detach() for k in LOSS_KEYS])

    def _apply(losses: torch.Tensor) -> Dict[str, torch.Tensor]:
        with spans.span("train.update"):
            reduce_replicated_grads(model)
            reduce_sequence_parallel_grads(model)
            optimizer.step()
            clamp_logit_scale(net)
            if world > 1:
                losses = psum(losses) / world
        return dict(zip(LOSS_KEYS, losses.unbind()))

    def single_step(batch: Batch, generator: Optional[torch.Generator] = None
                    ) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad()
        return _apply(_grad(batch, generator))

    if accum_steps <= 1:
        return single_step

    def accum_step(micro_batches: List[Batch],
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad()
        last = len(micro_batches) - 1
        losses = torch.stack([_grad(mb, generator, sync=i == last)
                              for i, mb in enumerate(micro_batches)])
        with torch.no_grad():
            torch._foreach_div_(optimizer.grads(), float(losses.shape[0]))
        return _apply(losses.mean(dim=0))

    return accum_step


class Trainer:
    """Epoch loop (reference: main_worker + train_epoch,
    main.py:72-378).  Builds the mesh and the wrapper from the config's
    parallel fields (JAX `train/loop.py:133-143`; one process without a
    process group trains unwrapped), then the configured optimizer over
    `model` (whose frozen parameters it marks `requires_grad=False` before
    wrapping).  `model` stays the model (under FSDP its parameters become
    shards, under tensor parallelism slices); `module` is what a step
    calls.  Set `metric_writer` (a `utils.logging.MetricWriter`) to record
    the scalars of every displayed step."""

    def __init__(self, cfg: RunConfig, model: CLIP4Clip, total_steps: int):
        self.cfg = cfg
        self.model = model
        self.mesh = create_mesh(
            cfg.data_parallel, cfg.tensor_parallel,
            cfg.model.pipeline_parallel, cfg.model.sequence_parallel,
            device_type=model.device.type, heads=block_heads(model))
        set_trainable(model, cfg.freeze_layer_num, cfg.freeze_clip)
        self.module = shard_params(
            model, self.mesh, fsdp=cfg.fsdp,
            find_unused_parameters=cfg.freeze_clip,
            sequence_parallel=cfg.model.sequence_parallel,
            microbatches=cfg.model.pipeline_microbatches)
        self.optimizer = build_optimizer(
            cfg.optim, model, total_steps,
            freeze_layer_num=cfg.freeze_layer_num, freeze_clip=cfg.freeze_clip)
        self.state = TrainState(model, self.optimizer, 0)
        self.total_steps = total_steps
        self.accum = cfg.optim.gradient_accumulation_steps
        self._step_fn = make_train_step(self.module, self.optimizer,
                                        self.accum)
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

    def _generator(self) -> torch.Generator:
        """The next optimizer step's generator."""
        return step_generator(self.cfg.seed, self.state.global_step + 1,
                              self.model.device)

    def _start_profiler(self):
        """torch.profiler over epoch 0's first `profile_steps` batches
        (the JAX package's `jax.profiler` trace, train/loop.py:161-169),
        with the program's spans recorded over them."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.model.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        spans.on()
        return prof

    def _stop_profiler(self, prof) -> None:
        """Stop the profiler and write its trace, with the spans recorded
        meanwhile as `user_annotation` events on the trace's clock, to
        `<profile_dir>/trace.json`."""
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)
        prof.stop()
        spans.off()
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        path = os.path.join(self.cfg.profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        spans.write_into_chrome_trace(path, spans.take())
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
                batch, micro = micro, []
            gstep = self.state.global_step + 1
            with spans.span("train.step", step=gstep):
                logs = self._step_fn(batch, self._generator())
                self.state.global_step = gstep
                loss_log.append(logs["loss"])
                display = gstep % n_display == 0
                if display:
                    scalars = {
                        "train/sim_loss": float(logs["sim_loss"]),
                        "train/cluster_loss": float(logs["cluster_loss"]),
                        "train/scale": float(
                            self.model.clip.logit_scale.detach()),
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
            loss_log.append(self._step_fn(micro, self._generator())["loss"])
            self.state.global_step += 1
        total = float(torch.stack(loss_log).sum()) if loss_log else 0.0
        return total / max(len(loss_log), 1), self.state.global_step
