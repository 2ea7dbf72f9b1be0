"""Random weights for a configuration, made on the device from the seed.

The schema is CLIP's state dict (under `clip.`) as the configuration's
shapes give it; the program's model must hold exactly these leaves.  The
values come from one `torch.randn` of all leaves at once on a generator
on the device, scaled leaf by leaf after CLIP's initialisation
(`initialize_parameters` of OpenAI's `model.py`): token embedding 0.02,
text positions 0.01, attention in-projections width^-1/2, output and MLP
projections width^-1/2 (2 layers)^-1/2, MLP inputs (2 width)^-1/2, the
patch embedding (3 P^2)^-1/2, CLS, vision positions and both projections
width^-1/2.  Where CLIP starts at 0 or 1 (biases, LayerNorm), the weights
here are 0 or 1 plus noise of 0.02, so that every leaf's gradient is
exercised.  The logit scale is ln(1 / 0.07).  The same seed gives the
same weights on the same device.

A configuration's `stream_scale` (alpha, 1 where absent) then multiplies
the leaves that write the vision residual stream (`stream_leaves`: ln_pre's
weight and bias, each vision block's attention and MLP output projections
with their biases).  Every block reads the stream through a LayerNorm and
ln_post normalises it, so the tower's function is unchanged but for
LayerNorm's eps; what changes is the scale of the tokens that spectral
clustering's heat kernel exp(-d^2 / 2 sigma^2) reads, which underflows off
the diagonal for tokens as far apart as CLIP's initialisation puts them.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from .work.plan import Shapes


def _block(prefix: str, w: int) -> List[Tuple[str, tuple]]:
    return [(prefix + k, shape) for k, shape in (
        ("attn.in_proj_weight", (3 * w, w)), ("attn.in_proj_bias", (3 * w,)),
        ("attn.out_proj.weight", (w, w)), ("attn.out_proj.bias", (w,)),
        ("ln_1.weight", (w,)), ("ln_1.bias", (w,)),
        ("mlp.c_fc.weight", (4 * w, w)), ("mlp.c_fc.bias", (4 * w,)),
        ("mlp.c_proj.weight", (w, 4 * w)), ("mlp.c_proj.bias", (w,)),
        ("ln_2.weight", (w,)), ("ln_2.bias", (w,)))]


def schema(s: Shapes) -> List[Tuple[str, tuple]]:
    """[(name, shape)] of every leaf, in a fixed order."""
    w, t, g = s.width, s.text_width, s.resolution // s.patch
    out = [("clip.positional_embedding", (s.context, t)),
           ("clip.text_projection", (t, s.embed)),
           ("clip.logit_scale", ()),
           ("clip.visual.class_embedding", (w,)),
           ("clip.visual.positional_embedding", (g * g + 1, w)),
           ("clip.visual.proj", (w, s.embed)),
           ("clip.visual.conv1.weight", (w, 3, s.patch, s.patch)),
           ("clip.visual.ln_pre.weight", (w,)),
           ("clip.visual.ln_pre.bias", (w,))]
    for i in range(s.layers):
        out += _block(f"clip.visual.transformer.resblocks.{i}.", w)
    out += [("clip.visual.ln_post.weight", (w,)),
            ("clip.visual.ln_post.bias", (w,)),
            ("clip.token_embedding.weight", (s.vocab, t))]
    for i in range(s.text_layers):
        out += _block(f"clip.transformer.resblocks.{i}.", t)
    out += [("clip.ln_final.weight", (t,)), ("clip.ln_final.bias", (t,))]
    return out


def stream_leaves(s: Shapes) -> List[str]:
    """The leaves that `stream_scale` multiplies."""
    out = ["clip.visual.ln_pre.weight", "clip.visual.ln_pre.bias"]
    for i in range(s.layers):
        p = f"clip.visual.transformer.resblocks.{i}."
        out += [p + "attn.out_proj.weight", p + "attn.out_proj.bias",
                p + "mlp.c_proj.weight", p + "mlp.c_proj.bias"]
    return out


def _scale(name: str, shape: tuple, s: Shapes) -> Tuple[float, float]:
    """(mean, std) of a leaf."""
    text = not name.startswith("clip.visual.")
    w = s.text_width if text else s.width
    layers = s.text_layers if text else s.layers
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "bias" or leaf.endswith("_bias"):
        return 0.0, 0.02
    if ".ln_" in name or name.startswith("clip.ln_"):
        return 1.0, 0.02
    if "token_embedding" in name:
        return 0.0, 0.02
    if name == "clip.positional_embedding":
        return 0.0, 0.01
    if "conv1" in name:
        return 0.0, (3 * s.patch * s.patch) ** -0.5
    if leaf == "in_proj_weight":
        return 0.0, w ** -0.5
    if "out_proj" in name or "c_proj" in name:
        return 0.0, w ** -0.5 * (2 * layers) ** -0.5
    if "c_fc" in name:
        return 0.0, (2 * w) ** -0.5
    return 0.0, w ** -0.5   # CLS, positions, projections


def make(s: Shapes, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: fp32 tensor on `device`}, every value from `seed`."""
    device = torch.device(device)
    leaves = schema(s)
    sizes = [math.prod(shape) for _, shape in leaves]
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for (name, shape), n in zip(leaves, sizes):
        mean, std = _scale(name, shape, s)
        out[name] = flat[off:off + n].view(shape).mul_(std).add_(mean)
        off += n
    out["clip.logit_scale"] = torch.full((), math.log(1 / 0.07),
                                         device=device)
    if s.stream_scale != 1.0:
        for name in stream_leaves(s):
            out[name].mul_(s.stream_scale)
    return out
