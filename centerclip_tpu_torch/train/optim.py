# coding=utf-8
"""Optimizers and LR schedules (port of the JAX package's `train/optim.py`;
reference: utils/optimization.py, utils/lr_scheduler.py).

Parameters are grouped as in `prep_optim_params_groups` (reference:
optimization.py:174-225): {CLIP, non-CLIP} x {decay, no-decay}, where CLIP
parameters get `lr * coef_lr` and the `NEW_ADDED_MODULES` count as non-CLIP
even under the clip tower.  Labels are decided on the torch key, which is
the reference's own parameter name.

* ``BertAdam``: Adam without bias correction, decoupled weight decay added
  to the update, per-parameter gradient clipping, and the LR schedule
  evaluated inside the step from `step / total_steps` (reference:
  optimization.py:106-171).
* ``AdamW``: torch.optim.AdamW semantics with the iteration-based scheduler
  writing `lr * lr_mult` per group (reference: lr_scheduler.py:65-121).
  `torch.optim.AdamW` itself has no per-group schedule multipliers, so the
  update is written out here over each group's tensors (`torch._foreach_*`,
  a few launches per group instead of per parameter).

`build_optimizer` applies, in order: the freeze mask on the gradients
(frozen parameters get `requires_grad=False`, as the reference's
`freeze_cip_layers` does, so they have no gradient and add nothing to the
norm), the global-norm clip to `clip_grad_norm`, the update rule, and the
freeze mask on the updates (the optimizer holds only trainable parameters,
so weight decay never moves a frozen one).  Every step is plain PyTorch on
the parameters' device; no value is read back to the host.
"""
from __future__ import annotations

import math
import re
from typing import Callable, Dict, Iterable, List, Tuple

import torch
from torch import nn

from ..config import OptimConfig

LabelledParams = Iterable[Tuple[str, nn.Parameter]]


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------
def warmup_cosine(x: float, warmup: float = 0.002) -> float:
    """reference: optimization.py:26-29"""
    return x / warmup if x < warmup else 0.5 * (1.0 + math.cos(math.pi * x))


def warmup_constant(x: float, warmup: float = 0.002) -> float:
    return x / warmup if x < warmup else 1.0


def warmup_linear(x: float, warmup: float = 0.002) -> float:
    return x / warmup if x < warmup else max((x - 1.0) / (warmup - 1.0), 0.0)


BERT_SCHEDULES = {
    "warmup_cosine": warmup_cosine,
    "warmup_constant": warmup_constant,
    "warmup_linear": warmup_linear,
}
LR_MODES = ("cos", "poly", "HTD", "step")


def make_lr_schedule(cfg: OptimConfig, total_steps: int, lr_step: int = 0,
                     lr_step_multiplier: float = 0.1) -> Callable[[int], float]:
    """Iteration-based scheduler used with AdamW (reference:
    lr_scheduler.py:65-110): linear warmup over the fractional
    `warmup_proportion * total_steps` iterations, then cos/poly/HTD/step
    decay, floored at end_lr."""
    if cfg.lr_mode not in LR_MODES:
        raise NotImplementedError(cfg.lr_mode)
    slow_start = cfg.warmup_proportion * total_steps
    slow_start_lr = 1e-8
    total = max(total_steps - slow_start, 1e-9)
    init_lr = cfg.lr

    def schedule(step: int) -> float:
        t = float(step)
        warm = min((t / (slow_start if slow_start > 0 else 1.0))
                   * (init_lr - slow_start_lr) + slow_start_lr, init_lr)
        tt = t - slow_start
        if cfg.lr_mode == "cos":
            decay = 0.5 * init_lr * (1.0 + math.cos(tt / total * math.pi))
        elif cfg.lr_mode == "poly":
            decay = init_lr * max(1.0 - tt / total, 0.0) ** 0.9
        elif cfg.lr_mode == "HTD":
            decay = 0.5 * init_lr * (1.0 - math.tanh(-6.0 + 9.0 * tt / total))
        else:                                    # "step", iteration-based
            k = math.floor(tt / max(lr_step or total, 1))
            decay = init_lr * lr_step_multiplier ** k
        lr = warm if (slow_start > 0 and t <= slow_start) else decay
        return max(lr, cfg.end_lr)

    return schedule


# ---------------------------------------------------------------------------
# param grouping and freezing
# ---------------------------------------------------------------------------
NEW_ADDED_MODULES = ("time_embedding", "frame_embedding", "deepcluster")
# the top layers that train whatever freeze_layer_num says
# (reference: clip4clip.py:449-471)
_ALWAYS_TRAINED = ("clip.ln_final.", "clip.text_projection", "clip.logit_scale",
                   "clip.visual.ln_post.", "clip.visual.proj",
                   "clip.visual.conv2.")
_BLOCK = re.compile(r"\.(?:resblocks\.|deepcluster_)(\d+)\.")


def param_group_label(key: str) -> str:
    """{clip,noclip}_{decay,nodecay} of a torch key (reference:
    optimization.py:180-194).  No decay iff the key's last component ends
    in `bias` (`attn.in_proj_bias`, `ln_1.bias`); every LayerNorm weight,
    embedding and `logit_scale` decays, as in the reference, whose
    'LayerNorm.*' entries match no parameter of CLIP."""
    is_clip = key.startswith("clip.") and not any(
        nd in key for nd in NEW_ADDED_MODULES)
    no_decay = key.rsplit(".", 1)[-1].endswith("bias")
    return (f"{'clip' if is_clip else 'noclip'}_"
            f"{'nodecay' if no_decay else 'decay'}")


def trainable_mask(keys: Iterable[str], freeze_layer_num: int = -1,
                   freeze_clip: bool = False) -> Dict[str, bool]:
    """{torch key: trainable?} (reference: clip4clip.py:449-471).

    With freeze_layer_num in [0, 12], CLIP parameters are frozen except the
    top layers (ln_final, text_projection, logit_scale, visual.ln_post,
    visual.proj, the 3-D patch conv2) and the blocks with index >=
    freeze_layer_num (a cluster module or a DeepCluster head follows its
    block's index): so 0 freezes the embeddings, conv1 and ln_pre and
    trains every block.  -1
    freezes nothing.  `freeze_clip` freezes the whole CLIP tower except the
    `NEW_ADDED_MODULES`.  Everything outside `clip.` always trains."""
    out = {}
    for key in keys:
        if not key.startswith("clip."):
            out[key] = True
        elif freeze_clip:
            out[key] = any(nd in key for nd in NEW_ADDED_MODULES)
        elif freeze_layer_num <= -1:
            out[key] = True
        elif key.startswith(_ALWAYS_TRAINED):
            out[key] = True
        else:
            m = _BLOCK.search(key)
            out[key] = bool(m) and int(m.group(1)) >= freeze_layer_num
    return out


# ---------------------------------------------------------------------------
# the update rules
# ---------------------------------------------------------------------------
class GroupedAdam:
    """BertAdam or grouped AdamW over the trainable parameters.

    `step()` reads each parameter's `.grad` (a trainable parameter the loss
    did not reach counts as a zero gradient), clips them in place, and
    updates the parameters and the moments in place.  `step_count` is the
    optimizer's own step (the JAX package's `opt_state.step`)."""

    def __init__(self, cfg: OptimConfig, named_params: LabelledParams,
                 total_steps: int):
        if cfg.optim not in ("BertAdam", "AdamW"):
            raise NotImplementedError(cfg.optim)
        if cfg.optim == "BertAdam" and cfg.schedule not in BERT_SCHEDULES:
            raise NotImplementedError(cfg.schedule)
        self.cfg, self.total_steps = cfg, total_steps
        named = list(named_params)
        self.names: List[str] = [n for n, _ in named]
        self.params: List[nn.Parameter] = [p for _, p in named]
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]
        self.groups: Dict[str, List[int]] = {}
        for i, name in enumerate(self.names):
            self.groups.setdefault(param_group_label(name), []).append(i)
        self.step_count = 0
        self._schedule = (make_lr_schedule(cfg, total_steps)
                          if cfg.optim == "AdamW" else None)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def grads(self) -> List[torch.Tensor]:
        out = []
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            out.append(p.grad)
        return out

    def _group_lr(self, label: str) -> float:
        return self.cfg.lr * (self.cfg.coef_lr if label.startswith("clip")
                              else 1.0)

    def _group_wd(self, label: str) -> float:
        return self.cfg.weight_decay if label.endswith("_decay") else 0.0

    @torch.no_grad()
    def step(self) -> None:
        cfg = self.cfg
        grads = self.grads()
        if not grads:
            self.step_count += 1
            return
        if cfg.clip_grad_norm and cfg.clip_grad_norm > 0:
            # optax.clip_by_global_norm: g unchanged below the limit, else
            # g / norm * limit
            norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(grads)))
            keep = norm < cfg.clip_grad_norm
            torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
            torch._foreach_mul_(grads, torch.where(keep, 1.0,
                                                   cfg.clip_grad_norm))
        if cfg.optim == "BertAdam":
            self._bert_adam(grads)
        else:
            self._adamw(grads)
        self.step_count += 1

    def _bert_adam(self, grads: List[torch.Tensor]) -> None:
        """reference: optimization.py:106-171, group table :201-208."""
        cfg = self.cfg
        sched = BERT_SCHEDULES[cfg.schedule](
            self.step_count / max(self.total_steps, 1), cfg.warmup_proportion)
        # per-parameter clipping to norm 1 (optimization.py:137-139)
        norms = torch._foreach_norm(grads)
        for g, n in zip(grads, norms):
            g.mul_(torch.clamp(1.0 / n.clamp_min(1e-12), max=1.0))
        for label, idx in self.groups.items():
            ps, gs, ms, vs = self._select(idx, grads)
            torch._foreach_mul_(ms, cfg.beta1)
            torch._foreach_add_(ms, gs, alpha=1.0 - cfg.beta1)
            torch._foreach_mul_(vs, cfg.beta2)
            torch._foreach_addcmul_(vs, gs, gs, value=1.0 - cfg.beta2)
            den = torch._foreach_sqrt(vs)
            torch._foreach_add_(den, cfg.eps)
            upd = torch._foreach_div(ms, den)
            wd = self._group_wd(label)
            if wd:
                torch._foreach_add_(upd, ps, alpha=wd)
            torch._foreach_add_(ps, upd, alpha=-self._group_lr(label) * sched)

    def _adamw(self, grads: List[torch.Tensor]) -> None:
        """torch AdamW with bias correction and lr-coupled decoupled decay;
        the scheduled lr times each group's multiplier."""
        cfg = self.cfg
        lr_t = self._schedule(self.step_count)
        count = self.step_count + 1
        bc1 = 1.0 - cfg.beta1 ** count
        bc2 = 1.0 - cfg.beta2 ** count
        for label, idx in self.groups.items():
            ps, gs, ms, vs = self._select(idx, grads)
            torch._foreach_mul_(ms, cfg.beta1)
            torch._foreach_add_(ms, gs, alpha=1.0 - cfg.beta1)
            torch._foreach_mul_(vs, cfg.beta2)
            torch._foreach_addcmul_(vs, gs, gs, value=1.0 - cfg.beta2)
            den = torch._foreach_div(vs, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, cfg.eps)
            upd = torch._foreach_div(ms, bc1)
            torch._foreach_div_(upd, den)
            wd = self._group_wd(label)
            if wd:
                torch._foreach_add_(upd, ps, alpha=wd)
            step_lr = lr_t * (cfg.coef_lr if label.startswith("clip") else 1.0)
            torch._foreach_add_(ps, upd, alpha=-step_lr)

    def _select(self, idx: List[int], grads: List[torch.Tensor]):
        return ([self.params[i] for i in idx], [grads[i] for i in idx],
                [self.exp_avg[i] for i in idx],
                [self.exp_avg_sq[i] for i in idx])

    def state_dict(self) -> dict:
        """The moments by parameter name (copies on the CPU) and the step."""
        return {"step": self.step_count,
                "exp_avg": {n: t.detach().cpu().clone()
                            for n, t in zip(self.names, self.exp_avg)},
                "exp_avg_sq": {n: t.detach().cpu().clone()
                               for n, t in zip(self.names, self.exp_avg_sq)}}

    def load_state_dict(self, sd: dict) -> None:
        for key in ("exp_avg", "exp_avg_sq"):
            if set(sd[key]) != set(self.names):
                raise KeyError(f"optimizer state names differ from the "
                               f"trainable parameters ({key})")
            for n, t in zip(self.names, getattr(self, key)):
                t.copy_(sd[key][n])
        self.step_count = int(sd["step"])


def build_optimizer(cfg: OptimConfig, model: nn.Module, total_steps: int,
                    freeze_layer_num: int = -1, freeze_clip: bool = False
                    ) -> GroupedAdam:
    """The configured optimizer over `model`'s trainable parameters.  Sets
    `requires_grad` from the freeze mask (see the module docstring)."""
    named = list(model.named_parameters())
    mask = trainable_mask((n for n, _ in named), freeze_layer_num,
                          freeze_clip)
    for name, p in named:
        p.requires_grad_(mask[name])
    return GroupedAdam(cfg, [(n, p) for n, p in named if mask[n]],
                       total_steps)


def current_lr(cfg: OptimConfig, step: int, total_steps: int) -> float:
    """Host-side LR readout for logging (group 0 = clip_decay,
    main.py:351-352)."""
    if cfg.optim == "BertAdam":
        return cfg.lr * cfg.coef_lr * BERT_SCHEDULES[cfg.schedule](
            step / max(total_steps, 1), cfg.warmup_proportion)
    return make_lr_schedule(cfg, total_steps)(step) * cfg.coef_lr
