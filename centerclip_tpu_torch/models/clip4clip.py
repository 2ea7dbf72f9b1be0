# coding=utf-8
"""CLIP4Clip retrieval model with its similarity headers (port of the JAX
package's `models/clip4clip.py`, reference: modules/clip4clip.py).

`get_sequence_output` and `get_visual_output` encode the two modalities to
fp32 (uint8 frames are normalised explicitly in fp32 for the 3-D patchify
and the ResNet towers; the 2-D patchify folds the normalisation into its
matmul).  The similarity headers (`get_similarity_logits`):

* meanP: masked mean of the normalised frame features (1e-12 norm eps),
  cosine with the normalised text feature, scaled by exp(logit_scale);
* seqTransf: frame-position embeddings, `cross_num_hidden_layers` fp32
  blocks (`transformerClip`) with a [B, 1, 1, T] key-padding mask of -1e6,
  residual back, then meanP's pooling (`seq_transf`);
* seqLSTM: builds, and raises `NotImplementedError` at the similarity, as
  the JAX package and the reference do;
* tightTransf (`loose_type` off): every (text, video) pair's [text | video]
  tokens through the cross model (`models/cross.py`) and `similarity_dense`
  to one logit, `cross_chunk_size` text rows at a time when it is set.

The header blocks are built with `fused=False`: their attention is the
plain fp32 path of the JAX package's blocks, chosen at build time, because
the per-sample mask is one the attention kernel does not take
(`models/layers.py`).  The CLIP towers' attention still runs kernels A / B.
Under tensor parallelism the header blocks are split as the towers' are
(JAX splits them by the same names), without sequence parallelism.

`forward(..., training=True)` adds the symmetric InfoNCE loss over
`get_similarity_logits` and the cluster loss (a DeepCluster head's WCSS; 0
for the other algorithms).  Every path is differentiable: callers that
only encode (the serving engine, the evaluator) run it under
`torch.inference_mode()`.  Building a model sets the process's fp32
numerics (`set_fp32_numerics`: no TF32 in matmuls or convolutions).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .. import resolve_device, set_fp32_numerics
from ..config import ModelConfig
from ..ops.cluster_layer import video_mask_after_cluster
from ..parallel.collectives import all_gather, all_gather_local_grads
from ..parallel.mesh import world_size
from .clip import CLIP, CLIP_MEAN, CLIP_STD, Transformer, is_resnet
from .cross import CrossConfig, CrossModel, key_padding_mask
from .layers import _lecun_normal_
from .losses import cross_entropy


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


class CLIP4Clip(nn.Module):
    """Top-level retrieval model.

    Args:
        cfg: the model configuration.
        device: where the parameters live; None means the GPU, and raises
            `RuntimeError` when there is none (pass "cpu" explicitly to run
            the plain PyTorch versions).
        seed: seed of the random initialisation (a `torch.Generator` on the
            CPU, so the same seed gives the same weights on every device).
    """

    def __init__(self, cfg: ModelConfig, device=None, seed: int = 0):
        super().__init__()
        set_fp32_numerics()
        self.cfg = cfg
        self.clip = CLIP(cfg)
        # the headers run on the embed_dim-wide pooled features (in CLIP's
        # archs embed_dim == transformer_width == 512)
        width, ctx = cfg.arch["embed_dim"], cfg.arch["context_length"]
        if cfg.sim_header in ("seqLSTM", "seqTransf"):
            self.frame_position_embeddings = nn.Embedding(ctx, width)
        if cfg.sim_header == "seqTransf":
            self.transformerClip = Transformer(
                width, cfg.cross_num_hidden_layers,
                cfg.arch["transformer_heads"], torch.float32, fused=False)
        if not cfg.loose_type:
            # the archive's config, then CLIP's widths (clip4clip.py:175-178)
            self.cross = CrossModel(CrossConfig.get_config(
                cfg.cross_model_name, hidden_size=width,
                num_hidden_layers=cfg.cross_num_hidden_layers,
                max_position_embeddings=ctx))
            self.similarity_dense = nn.Linear(width, 1)
        # the mesh's axes (`parallel.mesh.shard_params`); None alone
        self.axes = None
        self.reset_parameters(torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded initialisation with the JAX package's initialisers (the
        CLIP towers first, so a header does not change their weights)."""
        self.clip.reset_parameters(generator)
        with torch.no_grad():
            if hasattr(self, "frame_position_embeddings"):
                self.frame_position_embeddings.weight.normal_(
                    0.0, 0.02, generator=generator)
            if hasattr(self, "similarity_dense"):
                _lecun_normal_(self.similarity_dense.weight,
                               self.similarity_dense.in_features, generator)
                self.similarity_dense.bias.zero_()
        if hasattr(self, "transformerClip"):
            for m in self.transformerClip.modules():
                if hasattr(m, "reset_parameters") \
                        and not isinstance(m, nn.Linear):
                    m.reset_parameters(generator)
        if hasattr(self, "cross"):
            self.cross.reset_parameters(generator)

    @property
    def device(self) -> torch.device:
        return self.clip.logit_scale.device

    def get_sequence_output(self, input_ids: torch.Tensor) -> torch.Tensor:
        """[B, L] ids -> [B, 1, D] fp32 (clip4clip.py:265-272)."""
        return self.clip.encode_text(input_ids).float()[:, None, :]

    def visual_output_and_loss(self, video: torch.Tensor,
                               video_mask: torch.Tensor,
                               training: bool = False,
                               generator: Optional[torch.Generator] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, 1, T, C, H, W] or [B*T, C, H, W] uint8 / float frames ->
        ([B, T_final, D] fp32, cluster_loss) (clip4clip.py:222-243).
        uint8 frames are normalised here, in fp32, for the 3-D patchify and
        the ResNet towers; the 2-D patchify folds the normalisation into
        its matmul."""
        B = video_mask.shape[0]
        if video.dim() == 6:
            video = video.reshape(-1, *video.shape[-3:])
        if video.dtype == torch.uint8 and (self.cfg.linear_patch == "3d"
                                           or is_resnet(self.cfg)):
            mean = video.new_tensor(CLIP_MEAN, dtype=torch.float32)
            std = video.new_tensor(CLIP_STD, dtype=torch.float32)
            video = (video.float() / 255.0 - mean[:, None, None]) \
                / std[:, None, None]
        feats, cluster_loss = self.clip.encode_image(video, training,
                                                     generator)
        return feats.reshape(B, -1, feats.shape[-1]).float(), cluster_loss

    def get_visual_output(self, video: torch.Tensor,
                          video_mask: torch.Tensor) -> torch.Tensor:
        """The eval encode: [B, T_final, D] fp32 features."""
        return self.visual_output_and_loss(video, video_mask)[0]

    def video_mask_after_cluster(self, video_mask: torch.Tensor
                                 ) -> torch.Tensor:
        """The frame mask subsampled to the frames the vision tower keeps,
        for every algorithm that merges frames (clip4clip.py:106-113)."""
        cl = self.cfg.cluster
        if (cl.inter and cl.algo in ("kmediods++", "pooling",
                                     "sparse_sampling", "spectral")) \
                or cl.deep_cluster:
            return video_mask_after_cluster(video_mask, self.cfg.final_frames,
                                            self.cfg.f_frame_duration)
        return video_mask

    @staticmethod
    def mean_pooling_for_similarity_visual(visual_output: torch.Tensor,
                                           video_mask: torch.Tensor
                                           ) -> torch.Tensor:
        """Masked mean over frames with a zero-count guard
        (clip4clip.py:304-316), fp32."""
        m = video_mask.float()[..., None]
        s = (visual_output.float() * m).sum(dim=1)
        cnt = m.sum(dim=1)
        return s / torch.where(cnt == 0.0, torch.ones_like(cnt), cnt)

    def pooled_video(self, visual_output: torch.Tensor,
                     video_mask: torch.Tensor) -> torch.Tensor:
        """meanP's video side: normalise each frame, masked mean, normalise
        again.  [B, T, D] -> [B, D]."""
        pooled = self.mean_pooling_for_similarity_visual(
            _normalize(visual_output.float()), video_mask)
        return _normalize(pooled)

    def seq_transf(self, visual_output: torch.Tensor,
                   video_mask: torch.Tensor) -> torch.Tensor:
        """The seqTransf header (clip4clip.py:335-349): frame-position
        embeddings, the `transformerClip` blocks under a key-padding mask,
        residual back.  [B, T, D] fp32 -> [B, T, D] fp32."""
        B, L, D = visual_output.shape
        pos = self.frame_position_embeddings.weight[:L]
        x = visual_output + pos.to(visual_output.dtype)
        ext = key_padding_mask(video_mask)
        for block in self.transformerClip.resblocks:
            x = block(x, ext)
        return x + visual_output

    def video_vector(self, visual_output: torch.Tensor,
                     video_mask: torch.Tensor) -> torch.Tensor:
        """The video side of the loose similarity in fp32: the seqTransf
        header where the model has it (seqLSTM raises, as in the JAX
        package), then meanP's pooling.  [B, T, D] -> [B, D]; an already
        pooled [B, D] is used as it is.  `video_mask` is the post-cluster
        mask."""
        visual = visual_output.float()
        if self.cfg.sim_header == "seqTransf":
            visual = self.seq_transf(visual, video_mask)
        elif self.cfg.sim_header == "seqLSTM":
            raise NotImplementedError("seqLSTM (parity: clip4clip.py:332-333)")
        if visual.dim() == 3:
            visual = self.pooled_video(visual, video_mask)
        return visual

    def loose_similarity(self, sequence_output: torch.Tensor,
                         visual_output: torch.Tensor,
                         video_mask: torch.Tensor,
                         logit_scale: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """meanP / seqTransf similarity logits [num_texts, num_videos]
        (clip4clip.py:324-367), the video side by `video_vector`."""
        visual = self.video_vector(visual_output, video_mask)
        seq = _normalize(sequence_output.float().reshape(
            -1, sequence_output.shape[-1]))
        if logit_scale is None:
            logit_scale = self.clip.logit_scale.exp()
        return logit_scale * seq @ visual.t()

    def _cross_score_rows(self, seq_rows: torch.Tensor,
                          visual_output: torch.Tensor,
                          video_mask: torch.Tensor) -> torch.Tensor:
        """A block of text rows [c, s_text, D] scored against every video
        [bv, s_vis, D] -> [c, bv] (the loop body of clip4clip.py:389-407).
        The text side carries only its pooled token, with a mask of ones."""
        c, s_text, D = seq_rows.shape
        bv, s_vis, _ = visual_output.shape
        seq_l = seq_rows[:, None].expand(c, bv, s_text, D)
        vis_r = visual_output[None].expand(c, bv, s_vis, D)
        concat = torch.cat([seq_l, vis_r], dim=2).reshape(
            c * bv, s_text + s_vis, D)
        vmask_r = video_mask.float()[None].expand(c, bv, s_vis)
        concat_mask = torch.cat([vmask_r.new_ones((c, bv, s_text)), vmask_r],
                                dim=2).reshape(c * bv, s_text + s_vis)
        _, pooled = self.cross(concat, None, concat_mask)
        dense = self.similarity_dense
        return nn.functional.linear(pooled, dense.weight, dense.bias
                                    ).reshape(c, bv)

    def cross_similarity(self, sequence_output: torch.Tensor,
                         visual_output: torch.Tensor,
                         video_mask: torch.Tensor) -> torch.Tensor:
        """tightTransf all-pairs logits [bt, bv] (clip4clip.py:369-410).
        With `cfg.cross_chunk_size > 0` the text rows are scored that many
        at a time (the reference's `step_size` split), so a large gallery
        never holds the whole [bt * bv, L, D] cross input; the last block
        takes the rows that are left."""
        seq = sequence_output.float()
        vis = visual_output.float()
        chunk = self.cfg.cross_chunk_size
        if chunk <= 0 or chunk >= seq.shape[0]:
            return self._cross_score_rows(seq, vis, video_mask)
        return torch.cat([self._cross_score_rows(seq[s:s + chunk], vis,
                                                 video_mask)
                          for s in range(0, seq.shape[0], chunk)])

    def get_similarity_logits(self, sequence_output: torch.Tensor,
                              visual_output: torch.Tensor,
                              attention_mask: Optional[torch.Tensor],
                              video_mask: torch.Tensor,
                              logit_scale: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
        """The configured header's logits [num_texts, num_videos]
        (clip4clip.py:412-434).  A video mask that does not match the
        visual output's frames yet is subsampled after the cluster plan.
        `attention_mask` is accepted for the reference's signature; no
        header reads it."""
        del attention_mask
        if visual_output.dim() == 3 \
                and video_mask.shape[-1] != visual_output.shape[1]:
            video_mask = self.video_mask_after_cluster(video_mask)
        if self.cfg.loose_type:
            if self.cfg.sim_header not in ("meanP", "seqTransf", "seqLSTM"):
                raise ValueError(f"sim_header={self.cfg.sim_header!r} needs "
                                 f"loose_type off")
            return self.loose_similarity(sequence_output, visual_output,
                                         video_mask, logit_scale)
        if self.cfg.sim_header != "tightTransf":
            raise ValueError(f"loose_type off needs sim_header "
                             f"'tightTransf', not {self.cfg.sim_header!r}")
        return self.cross_similarity(sequence_output, visual_output,
                                     video_mask)

    def forward(self, input_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                video: Optional[torch.Tensor] = None,
                video_mask: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """Joint forward (JAX package `models/clip4clip.py:232-272`).

        Returns sequence_output / visual_output and, with `training`, the
        loss terms: sim_loss = 0.5 (CE(sim) + CE(sim^T)) over
        `get_similarity_logits` with the post-cluster video mask,
        cluster_loss (the DeepCluster heads' WCSS, else 0), loss = their
        sum.  Over more than one data shard, sim_loss is the loss of the
        global batch: the text and video features and the video mask of
        every rank of the data group are gathered before the similarity
        (the headers see all of them), and cluster_loss stays this rank's
        mean.  Without `training` and with `pre_visual_pooling`
        (ActivityNet), the visual output is the pooled, normalised [B, D]
        video vector.  `generator` draws the training step's random choices
        (`sparse_sampling`)."""
        out: Dict[str, torch.Tensor] = {}
        if input_ids is not None:
            out["sequence_output"] = self.get_sequence_output(
                input_ids.reshape(-1, input_ids.shape[-1]))
        cluster_loss = None
        if video is not None:
            video_mask = self.video_mask_after_cluster(
                video_mask.reshape(-1, video_mask.shape[-1]))
            visual, cluster_loss = self.visual_output_and_loss(
                video, video_mask, training=training,
                generator=generator if training else None)
            if not training and self.cfg.pre_visual_pooling:
                # the eval memory valve (clip4clip.py:237-243)
                visual = self.pooled_video(visual, video_mask)
            out["visual_output"] = visual
        if training:
            seq, visual = out["sequence_output"], out["visual_output"]
            group, shards = ((self.axes.data_group, self.axes.data_size)
                             if self.axes is not None else (None,
                                                            world_size()))
            if shards > 1:
                # the loss over the global batch (reference
                # modules/utils.py:47-64): every data shard's features, the
                # gradient through this rank's rows only, times the data
                # extent, so that the gradients averaged over the data
                # group are the one-process gradient of the global-batch
                # loss.  The ranks of a model group hold the same rows:
                # gathering over the world would count each row tp times.
                seq = all_gather_local_grads(seq, group, grad_scale=shards)
                visual = all_gather_local_grads(visual, group,
                                                grad_scale=shards)
                video_mask = all_gather(video_mask, group)
            sim = self.get_similarity_logits(seq, visual, attention_mask,
                                             video_mask)
            sim_loss = 0.5 * (cross_entropy(sim) + cross_entropy(sim.t()))
            if cluster_loss is None:
                cluster_loss = torch.zeros((), device=sim.device)
            out.update(sim_loss=sim_loss, cluster_loss=cluster_loss,
                       loss=sim_loss + cluster_loss)
        return out
