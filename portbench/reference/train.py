"""Training steps and the gallery encode of the plain reference.

The recipe's update, written from its description (CLIP4Clip's AdamW with
CLIP's parameters at lr x coef_lr, the iteration-based warm-up then cosine
schedule, global-norm clipping at `clip_grad_norm`, decoupled weight decay
on every leaf but biases, the logit scale clamped to [0.1, ln 100] after
each step, and with `--freeze_layer_num 0` the stem frozen: the patch and
token embeddings, both position embeddings, CLS and ln_pre).

A step's loss is over the whole batch, but the vision tower runs in
chunks of clips so that fp32 activations fit on one card: a first pass
without gradients gives every clip's frame features (and records the
medoids), the loss and its gradient to those features are taken over the
batch, then each chunk runs again with gradients, replaying its medoids,
and back-propagates its share.  The gradients are those of one pass over
the batch.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from . import model as M

STEM = ("clip.visual.conv1.", "clip.visual.class_embedding",
        "clip.visual.positional_embedding", "clip.visual.ln_pre.",
        "clip.token_embedding.", "clip.positional_embedding")
LOGIT_SCALE_MAX = math.log(100.0)


def trainable(names: Sequence[str], freeze_layer_num: int) -> List[str]:
    """The leaves the recipe trains: all but the stem where
    `freeze_layer_num` is 0 (every block trains), all where it is -1."""
    if freeze_layer_num not in (-1, 0):
        raise ValueError("the reference knows freeze_layer_num 0 and -1 only")
    if freeze_layer_num == -1:
        return list(names)
    return [n for n in names if not n.startswith(STEM)]


def lr_at(step: int, opt: dict, total_steps: int) -> float:
    """The scheduled lr of optimizer step `step` (0-based): linear from
    1e-8 to lr over the first warmup_proportion of the steps, then half a
    cosine; at least end_lr."""
    lr, end_lr = opt["lr"], opt.get("end_lr", 1e-8)
    warm = opt["warmup_proportion"] * total_steps
    t = float(step)
    if warm > 0 and t <= warm:
        value = min(t / warm * (lr - 1e-8) + 1e-8, lr)
    else:
        value = 0.5 * lr * (1.0 + math.cos((t - warm)
                                           / max(total_steps - warm, 1e-9)
                                           * math.pi))
    return max(value, end_lr)


def _batch_to(batch, device):
    video = torch.as_tensor(batch["video"]).to(device)
    video = video.reshape(video.shape[0], -1, *video.shape[-3:])
    return (torch.as_tensor(batch["input_ids"]).to(device).long(), video,
            torch.as_tensor(batch["video_mask"]).to(device))


def loss_and_grads(W: Dict[str, torch.Tensor], s, batch, num: M.Numerics,
                   chunk: int, rows=None) -> torch.Tensor:
    """The loss of one batch; the gradients of the leaves that require
    them are left in their `.grad`.  `rows` takes the loss over those rows
    of the batch only (a fault: half the batch left out)."""
    dev = W["clip.logit_scale"].device
    ids, video, vmask = _batch_to(batch, dev)
    if rows is not None:
        ids, video, vmask = ids[rows], video[rows], vmask[rows]
    n = ids.shape[0]
    starts = range(0, n, chunk)
    medoids = {}
    with torch.no_grad():
        frames = torch.cat([M.frame_features(W, s, video[a:a + chunk], num,
                                             medoids.setdefault(a, []))
                            for a in starts])
    frames.requires_grad_(True)
    mask = M.frame_mask(s, vmask)
    text = M.text_features(W, s, ids, num.text())
    loss = M.loss(text, M.video_vectors(frames, mask), W["clip.logit_scale"])
    loss.backward()
    for a in starts:
        out = M.frame_features(W, s, video[a:a + chunk], num, medoids[a],
                               replay=True)
        out.backward(frames.grad[a:a + chunk])
    return loss.detach()


def train_steps(W0: Dict[str, torch.Tensor], s, batches, opt: dict,
                total_steps: int, freeze_layer_num: int,
                num: M.Numerics = None, chunk: int = 16, rows=None) -> dict:
    """The recipe's steps from weights W0 on `batches`, in order.  Returns
    {losses: [each step's], grad: {part: norm of step 1's clipped
    gradient}, change: {part: norm of the change after the last step}}
    over the trainable leaves (`model.parts`); `rows` as in `loss_and_grads`."""
    M.strict_fp32()
    num = num or M.Numerics("fp32")
    names = trainable(list(W0), freeze_layer_num)
    W = {k: v.detach().clone().requires_grad_(k in names)
         for k, v in W0.items()}
    m = {k: torch.zeros_like(W[k]) for k in names}
    v = {k: torch.zeros_like(W[k]) for k in names}
    b1, b2, eps = opt["beta1"], opt["beta2"], opt["eps"]
    out = {"losses": [], "grad": {}, "change": {}}
    for step, batch in enumerate(batches):
        for k in names:
            W[k].grad = None
        out["losses"].append(float(loss_and_grads(W, s, batch, num, chunk,
                                                  rows)))
        with torch.no_grad():
            g = {k: (W[k].grad if W[k].grad is not None
                     else torch.zeros_like(W[k])) for k in names}
            norm = torch.sqrt(sum((t.double() ** 2).sum() for t in g.values()))
            if float(norm) >= opt["clip_grad_norm"]:
                g = {k: t * (opt["clip_grad_norm"] / float(norm))
                     for k, t in g.items()}
            if step == 0:
                out["grad"] = M.part_norms(g.items())
            lr = lr_at(step, opt, total_steps) * opt["coef_lr"]
            bc1, bc2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
            for k in names:
                m[k].mul_(b1).add_(g[k], alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                upd = (m[k] / bc1) / ((v[k] / bc2).sqrt() + eps)
                if not k.rsplit(".", 1)[-1].endswith("bias"):
                    upd = upd + opt["weight_decay"] * W[k]
                W[k].sub_(lr * upd)
            W["clip.logit_scale"].clamp_(0.1, LOGIT_SCALE_MAX)
    with torch.no_grad():
        out["change"] = M.part_norms((k, W[k] - W0[k]) for k in names)
    return out


@torch.no_grad()
def encode(W: Dict[str, torch.Tensor], s, video, video_mask,
           num: M.Numerics = None, chunk: int = 16) -> torch.Tensor:
    """[n, T, 3, H, W] uint8 clips -> [n, E] unit gallery vectors (meanP
    over the post-cluster frames)."""
    M.strict_fp32()
    num = num or M.Numerics("fp32")
    dev = W["clip.logit_scale"].device
    out = []
    for a in range(0, video.shape[0], chunk):
        v = torch.as_tensor(video[a:a + chunk]).to(dev)
        v = v.reshape(v.shape[0], -1, *v.shape[-3:])
        m = torch.as_tensor(video_mask[a:a + chunk]).to(dev)
        out.append(M.video_vectors(M.frame_features(W, s, v, num),
                                   M.frame_mask(s, m)))
    return torch.cat(out)
