# coding=utf-8
"""Weights in the reference's torch checkpoint key schema.

The port's `nn.Module`s use the reference's key names as their own
`state_dict` names (`clip.visual.transformer.resblocks.{i}.attn.in_proj_weight`,
...; JAX package `models/weights.py:74-170`), so a reference checkpoint
loads with `load_state_dict(strict=True)`.  This module converts the JAX
package's parameter tree (as numpy arrays) to that schema, reads checkpoint
files, and applies the reference's from_pretrained weight-seeding tricks
(`apply_pretrain_tricks`, JAX package `models/weights.py:187-234`).
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from ..config import ModelConfig

# (JAX parameter path, torch key, transform)
Entry = Tuple[Tuple[str, ...], str, str]


def _block_entries(param_prefix: Tuple[str, ...], torch_prefix: str
                   ) -> List[Entry]:
    """One ResidualAttentionBlock; 'T' marks a 2-D transpose."""
    e = [(param_prefix + ("attn", "in_proj", "kernel"),
          torch_prefix + ".attn.in_proj_weight", "T"),
         (param_prefix + ("attn", "in_proj", "bias"),
          torch_prefix + ".attn.in_proj_bias", ""),
         (param_prefix + ("attn", "out_proj", "kernel"),
          torch_prefix + ".attn.out_proj.weight", "T"),
         (param_prefix + ("attn", "out_proj", "bias"),
          torch_prefix + ".attn.out_proj.bias", "")]
    for ln in ("ln_1", "ln_2"):
        e.append((param_prefix + (ln, "norm", "scale"),
                  torch_prefix + f".{ln}.weight", ""))
        e.append((param_prefix + (ln, "norm", "bias"),
                  torch_prefix + f".{ln}.bias", ""))
    for fc in ("c_fc", "c_proj"):
        e.append((param_prefix + ("mlp", fc, "kernel"),
                  torch_prefix + f".mlp.{fc}.weight", "T"))
        e.append((param_prefix + ("mlp", fc, "bias"),
                  torch_prefix + f".mlp.{fc}.bias", ""))
    return e


def clip4clip_entries(cfg: ModelConfig) -> List[Entry]:
    """The mapping table of the ported model (the CLIP towers of a meanP
    CLIP4Clip, JAX package `models/weights.py:98-141`)."""
    arch = cfg.arch
    v, t = ("clip", "visual"), ("clip", "text")
    e = [(("clip", "logit_scale"), "clip.logit_scale", ""),
         (v + ("conv1",), "clip.visual.conv1.weight", ""),
         (v + ("class_embedding",), "clip.visual.class_embedding", ""),
         (v + ("positional_embedding",), "clip.visual.positional_embedding",
          "")]
    for ln in ("ln_pre", "ln_post"):
        e.append((v + (ln, "norm", "scale"), f"clip.visual.{ln}.weight", ""))
        e.append((v + (ln, "norm", "bias"), f"clip.visual.{ln}.bias", ""))
    e.append((v + ("proj",), "clip.visual.proj", ""))
    for i in range(arch["vision_layers"]):
        e += _block_entries(v + (f"resblocks_{i}",),
                            f"clip.visual.transformer.resblocks.{i}")
    names = []
    if cfg.cluster.cluster_embedding:
        names.append("cluster_embed")
    if cfg.cluster.adaptive_cls:
        names.append("cls_multiplier")
    for i, spec in enumerate(cfg.cluster_plan()):
        if spec is None or spec.algo != "kmediods++":
            continue
        prefix = f"clip.visual.transformer.resblocks.{i}.tokencluster_inter"
        for name in names:
            e.append((v + (f"cluster_{i}", name), f"{prefix}.{name}", ""))
    e += [(t + ("token_embedding",), "clip.token_embedding.weight", ""),
          (t + ("positional_embedding",), "clip.positional_embedding", ""),
          (t + ("ln_final", "norm", "scale"), "clip.ln_final.weight", ""),
          (t + ("ln_final", "norm", "bias"), "clip.ln_final.bias", ""),
          (t + ("text_projection",), "clip.text_projection", "")]
    for i in range(arch["transformer_layers"]):
        e += _block_entries(t + (f"resblocks_{i}",),
                            f"clip.transformer.resblocks.{i}")
    return e


def state_dict_from_jax_params(params: Mapping, cfg: ModelConfig
                               ) -> Dict[str, torch.Tensor]:
    """JAX package parameter tree (nested dict of arrays) -> state dict.

    Every array is copied (`np.array(..., copy=True)` before
    `torch.from_numpy`): a JAX CPU array can share memory with the numpy
    view it hands out, and the result must never alias it."""
    sd = {}
    for path, key, tf in clip4clip_entries(cfg):
        node = params
        for p in path:
            node = node[p]
        val = np.array(node, dtype=np.float32, copy=True)
        if tf == "T":
            val = np.ascontiguousarray(val.T)
        sd[key] = torch.from_numpy(val)
    return sd


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a `.pt` / `.pth.tar` file into the port's key schema: a raw
    state dict, a TorchScript CLIP archive, or the reference's checkpoint
    dict `{epoch, state_dict, ...}`.  DDP `module.` prefixes are stripped,
    a raw CLIP state dict is lifted under `clip.`, and `gamma`/`beta` become
    `weight`/`bias` (reference: main.py:188-212, base.py:205-215)."""
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:
        obj = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(obj, dict) and isinstance(obj.get("state_dict"), dict):
            sd = obj["state_dict"]
        elif isinstance(obj, dict) and isinstance(obj.get("model"), dict):
            sd = obj["model"]
        else:
            sd = obj
    sd = {k: v.detach().float().clone() for k, v in sd.items()
          if isinstance(v, torch.Tensor)}
    if sd and all(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    if not any(k.startswith("clip.") for k in sd):
        sd = {"clip." + k: v for k, v in sd.items()
              if k not in ("input_resolution", "context_length", "vocab_size")}
    return {re.sub(r"\bbeta\b", "bias", re.sub(r"\bgamma\b", "weight", k)): v
            for k, v in sd.items()}


_TEXT_BLOCK = re.compile(r"clip\.transformer\.resblocks\.(\d+)\.(.*)")


def apply_pretrain_tricks(sd: Mapping[str, torch.Tensor], cfg: ModelConfig
                          ) -> Dict[str, torch.Tensor]:
    """The reference's from_pretrained weight-seeding tricks
    (clip4clip.py:46-114, clip.py:617-630), on every branch of the JAX
    package's version: keys the state dict lacks are seeded, keys it has are
    kept.  Returns a new dict; seeded values are copies."""
    sd = dict(sd)
    pos = sd.get("clip.positional_embedding")

    def seed_from_text_blocks(prefix: str) -> None:
        for k in list(sd):
            m = _TEXT_BLOCK.fullmatch(k)
            if m and int(m.group(1)) < cfg.cross_num_hidden_layers:
                sd.setdefault(f"{prefix}.{m.group(1)}.{m.group(2)}",
                              sd[k].clone())
    # seqTransf / seqLSTM seeding (clip4clip.py:97-113)
    if cfg.sim_header in ("seqLSTM", "seqTransf") and pos is not None:
        sd.setdefault("frame_position_embeddings.weight", pos.clone())
    if cfg.sim_header == "seqTransf":
        seed_from_text_blocks("transformerClip.resblocks")
    # tightTransf cross seeding (clip4clip.py:78-96)
    if not cfg.loose_type:
        if pos is not None:
            sd.setdefault("cross.embeddings.position_embeddings.weight",
                          pos.clone())
        seed_from_text_blocks("cross.transformer.resblocks")
    # conv2 3D inflation (clip4clip.py:47-76): conv1 in the middle temporal
    # slice of a 3-deep kernel, zeros elsewhere
    w = sd.get("clip.visual.conv1.weight")
    if cfg.linear_patch == "3d" and w is not None:
        conv2 = w.new_zeros((w.shape[0], w.shape[1], 3, w.shape[2],
                             w.shape[3]))
        conv2[:, :, 1] = w
        sd.setdefault("clip.visual.conv2.weight", conv2)
    # cluster_embed from the visual positional embedding rows 1..K
    # (clip.py:617-630)
    vpos = sd.get("clip.visual.positional_embedding")
    if cfg.cluster.cluster_embedding and cfg.cluster.cluster_embed_from_clip \
            and vpos is not None:
        for i, spec in enumerate(cfg.cluster_plan()):
            if spec is not None:
                sd.setdefault(f"clip.visual.transformer.resblocks.{i}"
                              ".tokencluster_inter.cluster_embed",
                              vpos[1:spec.cluster_num + 1].clone())
    return sd
