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
* `linear_patch="3d"`: the tubelet patchify (`patchify_3d`), the JAX
  package's `lax.conv` over [frames, H, W] with a [width, 3, 3, P, P]
  kernel, temporal padding 1 and stride (1, P, P), in the compute dtype,
  computed as one matmul over each frame's and its neighbours' patches.
  It takes CLIP-normalised float frames only: the uint8 fold exists only
  for the 2-D matmul, and uint8 frames raise.
* ResNet archs (`vision_layers` a tuple: RN50, RN101) get
  `resnet.ModifiedResNet` as the vision tower, in fp32, without clustering;
  uint8 frames raise there too (`CLIP4Clip.get_visual_output` normalises
  them first).

* Under tensor parallelism every block holds this rank's slices
  (`parallel.mesh.split_model`).  With sequence parallelism the residual
  stream stays token-split over the model group within a run of blocks
  (`parallel.mesh.shard_tokens`) and is gathered whole at the run's end
  (`unshard_tokens`): before a cluster module, a DeepCluster head or
  token_shift's second shift, before `ln_post` on the CLS token and before
  `ln_final` and the EOT pick, which need every token, and which then run
  replicated on every rank of the group, as JAX's GSPMD reshards there.
  Remat'd blocks replay their forward collectives in the backward, in the
  same order on every rank.

* Under pipeline parallelism (`parallel.mesh.stage_model`) a training
  forward hands each run of blocks to `parallel.pipeline.pipeline_blocks`:
  the text tower's 12 blocks with the causal mask, and in the vision
  tower each run between two cluster modules, DeepCluster heads or
  token_shift's second shift (JAX `models/clip.py:175-195`).  Everything
  between the runs (the patchify, `ln_pre`, the cluster layer, the
  DeepCluster head, `ln_post`, the projections) runs alike on every stage
  of the pipe group, on the stream the last stage's output was broadcast
  into.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from ..ops.cluster_layer import TokenClusterInter
from ..ops.deepcluster import DeepCluster, deep_cluster_plan
from ..parallel.mesh import shard_tokens, unshard_tokens
from ..parallel.pipeline import pipeline_blocks
from .layers import LayerNormF32, ResidualAttentionBlock, causal_mask
from .resnet import ModifiedResNet


def check_supported(cfg: ModelConfig) -> None:
    """Raise on a config the port cannot build.  Every part of the JAX
    package's config is ported; what is left to refuse is a pipeline
    extent below 1 or a negative microbatch count."""
    if cfg.pipeline_parallel < 1 or cfg.pipeline_microbatches < 0:
        raise ValueError(
            f"pipeline_parallel {cfg.pipeline_parallel} must be >= 1 and "
            f"pipeline_microbatches {cfg.pipeline_microbatches} >= 0")


# CLIP's pixel statistics (reference: dataloaders/rawvideo_util.py)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def is_resnet(cfg: ModelConfig) -> bool:
    """True for the ResNet archs (their `vision_layers` is a tuple)."""
    return isinstance(cfg.arch["vision_layers"], (tuple, list))


def patchify_3d(video: torch.Tensor, weight: torch.Tensor, frames: int,
                dtype: torch.dtype) -> torch.Tensor:
    """The tubelet patchify (reference: clip.py:298-321; JAX package
    `models/clip.py:229-260`): [B*frames, C, H, W] float frames and a
    [width, C, 3, P, P] kernel -> [B*frames, gh*gw, width] in `dtype`,
    temporal kernel 3 with padding 1, spatial kernel and stride P.

    The convolution's spatial stride equals its kernel, so it is one
    matmul: each frame's patches beside its two neighbours' (zero frames
    at the clip's ends), [B*frames*gh*gw, 3*C*P*P], times the kernel laid
    out to match, with one fp32 accumulation and one rounding to `dtype`
    as in the convolution.  On the H100 cuDNN's bf16 `F.conv3d` with this
    32 x 32 stride takes 7.6x as long (`chip_smoke.py` times both)."""
    if video.dtype == torch.uint8:
        # the uint8 normalisation fold exists only in the 2-D patchify
        # matmul; raw frames here would be consumed as 0..255
        raise ValueError(
            "uint8 video reached the 3-D patchify — normalise to float "
            "(CLIP mean/std) before encode_image with linear_patch='3d'")
    BT, C, H, W = video.shape
    O, _, kt, P, _ = weight.shape
    B, gh, gw = BT // frames, H // P, W // P
    p = video.to(dtype).reshape(B, frames, C, gh, P, gw, P)
    p = p.permute(0, 1, 3, 5, 2, 4, 6).reshape(B, frames, gh * gw, C * P * P)
    p = F.pad(p, (0, 0, 0, 0, kt // 2, kt // 2))
    taps = torch.cat([p[:, k:k + frames] for k in range(kt)], dim=-1)
    kernel = weight.permute(0, 2, 1, 3, 4).reshape(O, -1).to(dtype)
    return (taps @ kernel.t()).reshape(BT, gh * gw, O)


class Transformer(nn.Module):
    """A stack of residual blocks (`transformer.resblocks.{i}`); `fused`
    picks their attention core (`models/layers.py`).  `token_split` marks
    a tower's stack, whose stream sequence parallelism splits; `axes` is
    set by `parallel.mesh.split_model`."""

    def __init__(self, width: int, layers: int, heads: int,
                 dtype: torch.dtype, remat: bool = False, fused: bool = True,
                 token_split: bool = False):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, dtype, fused)
            for _ in range(layers))
        self.remat = remat
        self.token_split = token_split
        self.axes = None

    @property
    def sp(self) -> bool:
        """True when the stack's stream is token-split over the model
        group."""
        return self.axes is not None and self.axes.sp

    def run_block(self, block: ResidualAttentionBlock, x: torch.Tensor,
                  attn_mask=None, length: Optional[int] = None
                  ) -> torch.Tensor:
        """One block, recomputed in the backward when `remat` is on and
        gradients are being recorded; `length` is the whole stream's under
        sequence parallelism."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, x, attn_mask, length,
                              use_reentrant=False)
        return block(x, attn_mask, length)

    @property
    def pp(self) -> bool:
        """True when a run of blocks takes the GPipe schedule: the stack's
        axes carry a pipe group and the forward records gradients (a train
        step; JAX's `_pp_active`: never in evaluation or encode, which run
        under inference mode)."""
        return self.axes is not None and self.axes.pp \
            and torch.is_grad_enabled()

    def run(self, blocks, x: torch.Tensor, attn_mask=None) -> torch.Tensor:
        """A run of blocks on the whole stream x [B, L, D]: token-split
        within the run under sequence parallelism, whole again after it;
        on the GPipe schedule under pipeline parallelism (each stage's
        blocks recomputed in the backward by the schedule itself, so not
        checkpointed again under `remat`; the remainder blocks are)."""
        if self.pp:
            return pipeline_blocks(
                blocks, lambda b, h: b(h, attn_mask), x,
                self.axes.microbatches, self.axes,
                apply_rest=lambda b, h: self.run_block(b, h, attn_mask))
        if not self.sp:
            for block in blocks:
                x = self.run_block(block, x, attn_mask)
            return x
        length = x.shape[1]
        x = shard_tokens(x, self.axes)
        for block in blocks:
            x = self.run_block(block, x, attn_mask, length)
        return unshard_tokens(x, self.axes, length)


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
        self.frames, self.conv2 = cfg.max_frames, None
        if cfg.linear_patch == "3d":
            self.conv2 = nn.Conv3d(3, width, (3, P, P), (1, P, P), (1, 0, 0),
                                   bias=False)               # weight holder
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(
            torch.empty(grid * grid + 1, width))
        self.ln_pre = LayerNormF32(width)
        self.transformer = Transformer(
            width, arch["vision_layers"],
            arch.get("vision_heads", width // 64), dtype, cfg.remat,
            token_split=True)
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
        if self.conv2 is not None:
            x = patchify_3d(video, self.conv2.weight, self.frames, dt)
        else:
            x = self._patchify(video)
        BT, _, width = x.shape
        cls = self.class_embedding.to(dt).expand(BT, 1, width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        x = self.ln_pre(x)
        cluster_loss = torch.zeros((), device=x.device)
        run = []       # the blocks since the last whole-token module
        for i, block in enumerate(self.transformer.resblocks):
            inter = block.tokencluster_inter
            if i in self.deep_blocks or inter is not None:
                x = self.transformer.run(run, x)
                run = []
            if i in self.deep_blocks:
                x, loss = getattr(self, f"deepcluster_{i}")(x, training)
                cluster_loss = cluster_loss + loss
            if inter is not None:
                x = inter(x, generator)
            run.append(block)
            if inter is not None and inter.spec.algo == "token_shift":
                # the JAX package's `cluster_post_{i}`: the shift again,
                # after the block (it has no parameters)
                x = inter(self.transformer.run(run, x))
                run = []
        x = self.transformer.run(run, x)
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
        if is_resnet(cfg):
            # reference: clip.py:379-387; heads = width * 32 / 64
            self.visual = ModifiedResNet(
                arch["vision_layers"], arch["embed_dim"],
                arch["vision_width"] * 32 // 64, arch["image_resolution"],
                arch["vision_width"])
        else:
            self.visual = VisionTransformer(cfg, dtype)
        self.token_embedding = nn.Embedding(arch["vocab_size"], width)
        self.positional_embedding = nn.Parameter(
            torch.empty(arch["context_length"], width))
        self.transformer = Transformer(width, arch["transformer_layers"],
                                       arch["transformer_heads"], dtype,
                                       cfg.remat, token_split=True)
        self.ln_final = LayerNormF32(width)
        self.text_projection = nn.Parameter(
            torch.empty(width, arch["embed_dim"]))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded initialisation with the JAX package's initialisers."""
        v = self.visual
        tw = self.positional_embedding.shape[1]
        with torch.no_grad():
            if isinstance(v, VisionTransformer):
                vw = v.class_embedding.shape[0]
                for conv in (v.conv1, v.conv2):
                    if conv is not None:
                        conv.weight.normal_(
                            0.0, conv.weight[0].numel() ** -0.5,
                            generator=generator)
                for p in (v.class_embedding, v.positional_embedding, v.proj):
                    p.normal_(0.0, vw ** -0.5, generator=generator)
            self.token_embedding.weight.normal_(0.0, 0.02, generator=generator)
            self.positional_embedding.normal_(0.0, 0.01, generator=generator)
            self.text_projection.normal_(0.0, tw ** -0.5, generator=generator)
            self.logit_scale.fill_(math.log(1 / 0.07))
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters") \
                    and not isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d,
                                           nn.Embedding, nn.LayerNorm)):
                m.reset_parameters(generator)

    def encode_text(self, text: torch.Tensor) -> torch.Tensor:
        """[B, L] token ids -> [B, embed_dim] fp32 features, pooled at the
        EOT token (the argmax of the ids)."""
        dt, L = self.dtype, text.shape[1]
        x = self.token_embedding.weight[text].to(dt)
        x = x + self.positional_embedding[:L].to(dt)
        mask = causal_mask(L, device=x.device)
        x = self.transformer.run(self.transformer.resblocks, x, mask)
        x = self.ln_final(x).float()
        eot = text.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return pooled @ self.text_projection

    def encode_image(self, video: torch.Tensor, training: bool = False,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B*T, 3, H, W] -> ([B*T_final, embed_dim] fp32 CLS features,
        cluster_loss); the ResNet tower's pooled features and a zero
        cluster loss for the ResNet archs."""
        if isinstance(self.visual, ModifiedResNet):
            if video.dtype == torch.uint8:
                # no normalisation fold for the ResNet stem (stride-2 convs)
                raise ValueError(
                    "uint8 video reached the ResNet tower — normalise to "
                    "float (CLIP mean/std) before encode_image")
            return self.visual(video.float()).float(), \
                torch.zeros((), device=video.device)
        return self.visual(video, training, generator)
