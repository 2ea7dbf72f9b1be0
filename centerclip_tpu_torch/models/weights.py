# coding=utf-8
"""Weights in the reference's torch checkpoint key schema.

The port's `nn.Module`s use the reference's key names as their own
`state_dict` names (`clip.visual.transformer.resblocks.{i}.attn.in_proj_weight`,
...; JAX package `models/weights.py:74-170`), so a reference checkpoint
loads with `load_state_dict(strict=True)`.  This module converts the JAX
package's parameter tree (as numpy arrays) to that schema, reads checkpoint
files, and applies the reference's from_pretrained weight-seeding tricks
(`apply_pretrain_tricks`, JAX package `models/weights.py:187-234`).

The reference's torch schema has no names for the DeepCluster heads; the
port names them after the JAX package's tree (`deepcluster_{i}` under the
vision tower): `clip.visual.deepcluster_{i}.{fc1,fc2,fc3,ln1,ln2,ln3}.
{weight,bias}`.

The ResNet towers (RN50, RN101) have the reference's names
(modules/clip.py:40-180): `clip.visual.conv{1,2,3}.weight`,
`clip.visual.bn{1,2,3}.{weight,bias,running_mean,running_var}`,
`clip.visual.layer{l}.{b}.{conv,bn}{1,2,3}.*`, `...downsample.{0,1}.*` and
`clip.visual.attnpool.{positional_embedding,q_proj,k_proj,v_proj,c_proj}`.
The JAX package's table has no ResNet entries; its tree names them
`layer{l}_{b}`, `downsample_conv` / `downsample_bn`, and `FrozenBatchNorm`'s
`scale` / `bias` / `mean` / `var`, with HWIO convolution kernels,
which `state_dict_from_jax_params` transposes to torch's OIHW.
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..ops.cluster_layer import CLUSTERING_ALGOS
from ..ops.deepcluster import deep_cluster_plan

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


def _resnet_entries(arch: dict) -> List[Entry]:
    """The ResNet tower (JAX package `models/resnet.py` tree, the
    reference's torch names); 'HWIO' marks an [H, W, in, out] convolution kernel."""
    v, tv = ("clip", "visual"), "clip.visual"
    e: List[Entry] = []

    def conv(path, key):
        e.append((v + path + ("kernel",), f"{key}.weight", "HWIO"))

    def bn(path, key):
        for leaf, name in (("scale", "weight"), ("bias", "bias"),
                           ("mean", "running_mean"), ("var", "running_var")):
            e.append((v + path + (leaf,), f"{key}.{name}", ""))
    for i in (1, 2, 3):
        conv((f"conv{i}",), f"{tv}.conv{i}")
        bn((f"bn{i}",), f"{tv}.bn{i}")
    width = arch["vision_width"]
    inplanes = width
    for li, blocks in enumerate(arch["vision_layers"]):
        planes = width * 2 ** li
        for b in range(blocks):
            node, key = (f"layer{li + 1}_{b}",), f"{tv}.layer{li + 1}.{b}"
            for i in (1, 2, 3):
                conv(node + (f"conv{i}",), f"{key}.conv{i}")
                bn(node + (f"bn{i}",), f"{key}.bn{i}")
            if b == 0 and (li > 0 or inplanes != planes * 4):
                conv(node + ("downsample_conv",), f"{key}.downsample.0")
                bn(node + ("downsample_bn",), f"{key}.downsample.1")
            inplanes = planes * 4
    pool, key = v + ("attnpool",), f"{tv}.attnpool"
    e.append((pool + ("positional_embedding",),
              f"{key}.positional_embedding", ""))
    for proj in ("q_proj", "k_proj", "v_proj", "c_proj"):
        e += [(pool + (proj, "kernel"), f"{key}.{proj}.weight", "T"),
              (pool + (proj, "bias"), f"{key}.{proj}.bias", "")]
    return e


def _header_entries(cfg: ModelConfig) -> List[Entry]:
    """The similarity headers (JAX package `models/weights.py:146-169`)."""
    e: List[Entry] = []
    if cfg.sim_header in ("seqLSTM", "seqTransf"):
        e.append((("frame_position_embeddings",),
                  "frame_position_embeddings.weight", ""))
    if cfg.sim_header == "seqTransf":
        for i in range(cfg.cross_num_hidden_layers):
            e += _block_entries((f"transformerClip_{i}",),
                                f"transformerClip.resblocks.{i}")
    if not cfg.loose_type:
        e.append((("cross", "position_embeddings"),
                  "cross.embeddings.position_embeddings.weight", ""))
        for i in range(cfg.cross_num_hidden_layers):
            e += _block_entries(("cross", f"resblocks_{i}"),
                                f"cross.transformer.resblocks.{i}")
        e += [(("cross", "ln_pool", "norm", "scale"),
               "cross.pooler.ln_pool.weight", ""),
              (("cross", "ln_pool", "norm", "bias"),
               "cross.pooler.ln_pool.bias", ""),
              (("cross", "pooler_dense", "kernel"),
               "cross.pooler.dense.weight", "T"),
              (("cross", "pooler_dense", "bias"), "cross.pooler.dense.bias",
               ""),
              (("similarity_dense", "kernel"), "similarity_dense.weight",
               "T"),
              (("similarity_dense", "bias"), "similarity_dense.bias", "")]
    return e


def clip4clip_entries(cfg: ModelConfig) -> List[Entry]:
    """The mapping table of the ported model (JAX package
    `models/weights.py:98-170`): the CLIP towers (a ViT with its learned
    cluster extras, the 3-D patchify's `conv2` and the DeepCluster heads,
    or a ResNet), then the similarity headers."""
    arch = cfg.arch
    v, t = ("clip", "visual"), ("clip", "text")
    e = [(("clip", "logit_scale"), "clip.logit_scale", "")]
    if isinstance(arch["vision_layers"], (tuple, list)):
        e += _resnet_entries(arch)
    else:
        e += _vit_entries(cfg)
    e += [(t + ("token_embedding",), "clip.token_embedding.weight", ""),
          (t + ("positional_embedding",), "clip.positional_embedding", ""),
          (t + ("ln_final", "norm", "scale"), "clip.ln_final.weight", ""),
          (t + ("ln_final", "norm", "bias"), "clip.ln_final.bias", ""),
          (t + ("text_projection",), "clip.text_projection", "")]
    for i in range(arch["transformer_layers"]):
        e += _block_entries(t + (f"resblocks_{i}",),
                            f"clip.transformer.resblocks.{i}")
    return e + _header_entries(cfg)


def _vit_entries(cfg: ModelConfig) -> List[Entry]:
    """The ViT tower with the learned cluster extras, `conv2` (3-D
    patchify) and the DeepCluster heads."""
    arch = cfg.arch
    v = ("clip", "visual")
    e = [(v + ("conv1",), "clip.visual.conv1.weight", ""),
         (v + ("class_embedding",), "clip.visual.class_embedding", ""),
         (v + ("positional_embedding",), "clip.visual.positional_embedding",
          "")]
    for ln in ("ln_pre", "ln_post"):
        e.append((v + (ln, "norm", "scale"), f"clip.visual.{ln}.weight", ""))
        e.append((v + (ln, "norm", "bias"), f"clip.visual.{ln}.bias", ""))
    e.append((v + ("proj",), "clip.visual.proj", ""))
    if cfg.linear_patch == "3d":
        e.append((v + ("conv2",), "clip.visual.conv2.weight", ""))
    for i in range(arch["vision_layers"]):
        e += _block_entries(v + (f"resblocks_{i}",),
                            f"clip.visual.transformer.resblocks.{i}")
    names = []
    if cfg.cluster.cluster_embedding:
        names.append("cluster_embed")
    if cfg.cluster.cluster_frame_embedding:
        names.append("cluster_frame_embed")
    if cfg.cluster.adaptive_cls:
        names.append("cls_multiplier")
    for i, spec in enumerate(cfg.cluster_plan()):
        if spec is None or spec.algo not in CLUSTERING_ALGOS:
            continue
        prefix = f"clip.visual.transformer.resblocks.{i}.tokencluster_inter"
        for name in names:
            e.append((v + (f"cluster_{i}", name), f"{prefix}.{name}", ""))
    for i, spec in enumerate(deep_cluster_plan(cfg)):
        if spec is None:
            continue
        head = v + (f"deepcluster_{i}",)
        for n in ("1", "2", "3"):
            e += [(head + (f"fc{n}", "kernel"),
                   f"clip.visual.deepcluster_{i}.fc{n}.weight", "T"),
                  (head + (f"fc{n}", "bias"),
                   f"clip.visual.deepcluster_{i}.fc{n}.bias", ""),
                  (head + (f"ln{n}", "scale"),
                   f"clip.visual.deepcluster_{i}.ln{n}.weight", ""),
                  (head + (f"ln{n}", "bias"),
                   f"clip.visual.deepcluster_{i}.ln{n}.bias", "")]
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
        elif tf == "HWIO":
            val = np.ascontiguousarray(val.transpose(3, 2, 0, 1))
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
