# coding=utf-8
"""CLIP text and vision towers with inter-block token clustering (port of
the JAX package's `models/clip.py`, reference: modules/clip.py:272-512).

* The 2-D patchify is a reshape and one matmul; for uint8 frames the CLIP
  normalisation `(x/255 - mean)/std` is folded into the patch weights, so no
  float copy of the frames exists.  It is a matmul, not a convolution, so
  cuDNN's TF32 default never applies.
* Cluster modules run before the blocks the cluster plan names (and
  `token_shift` once more after its block); a DeepCluster head runs before
  the blocks `deep_cluster_plan` names, and its WCSS loss (training only)
  is summed into `encode_image`'s `cluster_loss`.  A `generator` reaches
  the cluster modules, for `sparse_sampling`'s random columns.
* ln_post and the projection run on the CLS token only.
* Text features are pooled at the EOT token (the largest id).
* With `cfg.remat` every residual block of both towers runs under
  `torch.utils.checkpoint` (its activations are recomputed in the backward,
  as the JAX package's `nn.remat(ResidualAttentionBlock)`); the cluster
  modules and DeepCluster heads run outside the recomputed blocks, so
  clustering runs once per forward.

The 3-D patchify, the ResNet towers and sequence or pipeline parallelism
are not ported; a config that asks for them raises.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from ..ops.cluster_layer import TokenClusterInter
from ..ops.deepcluster import DeepCluster, deep_cluster_plan
from .layers import LayerNormF32, ResidualAttentionBlock, causal_mask

# CLIP's pixel statistics (reference: dataloaders/rawvideo_util.py)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def check_supported(cfg: ModelConfig) -> None:
    """Raise on the parts of a config the port does not implement yet."""
    if isinstance(cfg.arch["vision_layers"], (tuple, list)):
        raise NotImplementedError("ResNet vision towers are not ported yet")
    if cfg.linear_patch != "2d":
        raise NotImplementedError("the 3-D patchify is not ported yet")
    if cfg.sequence_parallel or cfg.pipeline_parallel > 1:
        raise NotImplementedError(
            "sequence and pipeline parallelism are not ported")


class Transformer(nn.Module):
    """A stack of residual blocks (`transformer.resblocks.{i}`)."""

    def __init__(self, width: int, layers: int, heads: int,
                 dtype: torch.dtype, remat: bool = False):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, dtype) for _ in range(layers))
        self.remat = remat

    def run_block(self, block: ResidualAttentionBlock, x: torch.Tensor,
                  attn_mask=None) -> torch.Tensor:
        """One block, recomputed in the backward when `remat` is on and
        gradients are being recorded."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, x, attn_mask, use_reentrant=False)
        return block(x, attn_mask)


class VisionTransformer(nn.Module):
    """CLIP ViT with the cluster modules of `cfg.cluster_plan()` (on their
    blocks, `tokencluster_inter`) and the DeepCluster heads of
    `deep_cluster_plan(cfg)` (`deepcluster_{i}`, the JAX package's names:
    the reference's torch schema has none for them)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        arch = cfg.arch
        width, P = arch["vision_width"], arch["vision_patch_size"]
        grid = arch["image_resolution"] // P
        self.dtype, self.patch = dtype, P
        self.conv1 = nn.Conv2d(3, width, P, P, bias=False)   # weight holder
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(
            torch.empty(grid * grid + 1, width))
        self.ln_pre = LayerNormF32(width)
        self.transformer = Transformer(
            width, arch["vision_layers"],
            arch.get("vision_heads", width // 64), dtype, cfg.remat)
        for block, spec in zip(self.transformer.resblocks, cfg.cluster_plan()):
            if spec is not None:
                block.tokencluster_inter = TokenClusterInter(
                    spec, cfg.cluster, width)
        self.deep_blocks = []
        tokens = grid * grid
        for i, spec in enumerate(deep_cluster_plan(cfg)):
            if spec is not None:
                self.add_module(f"deepcluster_{i}",
                                DeepCluster(spec, cfg.cluster, tokens))
                self.deep_blocks.append(i)
                tokens = spec.cluster_num
        self.ln_post = LayerNormF32(width)
        self.proj = nn.Parameter(torch.empty(width, arch["embed_dim"]))

    def _patchify(self, video: torch.Tensor) -> torch.Tensor:
        """[BT, C, H, W] -> [BT, gh*gw, width] as one matmul."""
        BT, C, H, W = video.shape
        P, dt = self.patch, self.dtype
        gh, gw = H // P, W // P
        patches = video.reshape(BT, C, gh, P, gw, P).permute(0, 2, 4, 1, 3, 5)
        patches = patches.reshape(BT, gh * gw, C * P * P).to(dt)
        kernel = self.conv1.weight.reshape(-1, C, P * P)
        bias = None
        if video.dtype == torch.uint8:
            # x_norm @ K == x_raw @ (K * s_c) + shift_c . sum_p K
            mean = torch.tensor(CLIP_MEAN, device=kernel.device)
            std = torch.tensor(CLIP_STD, device=kernel.device)
            bias = torch.einsum("c,ocp->o", -mean / std, kernel)
            kernel = kernel * (1.0 / (255.0 * std))[None, :, None]
        x = patches @ kernel.reshape(kernel.shape[0], -1).t().to(dt)
        return x if bias is None else x + bias.to(dt)

    def forward(self, video: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B*T, 3, H, W] uint8 or CLIP-normalised float frames ->
        ([B*T_final, embed_dim] fp32 CLS features, fp32 cluster_loss: the
        DeepCluster heads' WCSS with `training`, else 0)."""
        dt = self.dtype
        x = self._patchify(video)
        BT, _, width = x.shape
        cls = self.class_embedding.to(dt).expand(BT, 1, width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        x = self.ln_pre(x)
        cluster_loss = torch.zeros((), device=x.device)
        for i, block in enumerate(self.transformer.resblocks):
            if i in self.deep_blocks:
                x, loss = getattr(self, f"deepcluster_{i}")(x, training)
                cluster_loss = cluster_loss + loss
            inter = block.tokencluster_inter
            if inter is not None:
                x = inter(x, generator)
            x = self.transformer.run_block(block, x)
            if inter is not None and inter.spec.algo == "token_shift":
                # the JAX package's `cluster_post_{i}`: the shift again,
                # after the block (it has no parameters)
                x = inter(x)
        x = self.ln_post(x[:, 0, :].contiguous()).float()
        return x @ self.proj, cluster_loss


class CLIP(nn.Module):
    """CLIP with the video-aware vision tower; the text tower's parameters
    sit on this module, under the reference's names."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_supported(cfg)
        arch = cfg.arch
        dtype = getattr(torch, cfg.compute_dtype)
        width = arch["transformer_width"]
        self.dtype = dtype
        self.visual = VisionTransformer(cfg, dtype)
        self.token_embedding = nn.Embedding(arch["vocab_size"], width)
        self.positional_embedding = nn.Parameter(
            torch.empty(arch["context_length"], width))
        self.transformer = Transformer(width, arch["transformer_layers"],
                                       arch["transformer_heads"], dtype,
                                       cfg.remat)
        self.ln_final = LayerNormF32(width)
        self.text_projection = nn.Parameter(
            torch.empty(width, arch["embed_dim"]))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded initialisation with the JAX package's initialisers."""
        v = self.visual
        vw = v.class_embedding.shape[0]
        tw = self.positional_embedding.shape[1]
        with torch.no_grad():
            v.conv1.weight.normal_(0.0, v.conv1.weight[0].numel() ** -0.5,
                                   generator=generator)
            for p in (v.class_embedding, v.positional_embedding, v.proj):
                p.normal_(0.0, vw ** -0.5, generator=generator)
            self.token_embedding.weight.normal_(0.0, 0.02, generator=generator)
            self.positional_embedding.normal_(0.0, 0.01, generator=generator)
            self.text_projection.normal_(0.0, tw ** -0.5, generator=generator)
            self.logit_scale.fill_(math.log(1 / 0.07))
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters") \
                    and not isinstance(m, (nn.Linear, nn.Conv2d, nn.Embedding,
                                           nn.LayerNorm)):
                m.reset_parameters(generator)

    def encode_text(self, text: torch.Tensor) -> torch.Tensor:
        """[B, L] token ids -> [B, embed_dim] fp32 features, pooled at the
        EOT token (the argmax of the ids)."""
        dt, L = self.dtype, text.shape[1]
        x = self.token_embedding.weight[text].to(dt)
        x = x + self.positional_embedding[:L].to(dt)
        mask = causal_mask(L, device=x.device)
        for block in self.transformer.resblocks:
            x = self.transformer.run_block(block, x, mask)
        x = self.ln_final(x).float()
        eot = text.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return pooled @ self.text_projection

    def encode_image(self, video: torch.Tensor, training: bool = False,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B*T, 3, H, W] -> ([B*T_final, embed_dim] fp32 CLS features,
        cluster_loss)."""
        return self.visual(video, training, generator)
