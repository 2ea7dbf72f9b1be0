# coding=utf-8
"""CLIP4Clip retrieval model with the meanP similarity header (port of the
JAX package's `models/clip4clip.py`, reference: modules/clip4clip.py).

`get_sequence_output` and `get_visual_output` encode the two modalities to
fp32; `loose_similarity` is the meanP similarity (masked mean of the
normalised frame features, 1e-12 norm eps, scaled by exp(logit_scale));
`forward(..., training=True)` adds the symmetric InfoNCE loss and the
cluster loss (a DeepCluster head's WCSS; 0 for the other algorithms).
Every path is differentiable: callers that only encode (the serving engine,
the evaluator) run it under `torch.inference_mode()`.  The seqTransf, seqLSTM
and tightTransf headers are not ported yet; a config that asks for them
raises.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .. import resolve_device
from ..config import ModelConfig
from ..ops.cluster_layer import video_mask_after_cluster
from .clip import CLIP
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
        if cfg.sim_header != "meanP" or not cfg.loose_type:
            raise NotImplementedError(
                f"sim_header={cfg.sim_header!r} is not ported yet (meanP only)")
        self.cfg = cfg
        self.clip = CLIP(cfg)
        self.clip.reset_parameters(torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))

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
        ([B, T_final, D] fp32, cluster_loss) (clip4clip.py:222-243)."""
        B = video_mask.shape[0]
        if video.dim() == 6:
            video = video.reshape(-1, *video.shape[-3:])
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
        """The video side of `loose_similarity`: normalise each frame,
        masked mean, normalise again.  [B, T, D] -> [B, D]."""
        pooled = self.mean_pooling_for_similarity_visual(
            _normalize(visual_output.float()), video_mask)
        return _normalize(pooled)

    def loose_similarity(self, sequence_output: torch.Tensor,
                         visual_output: torch.Tensor,
                         video_mask: torch.Tensor,
                         logit_scale: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """meanP similarity logits [num_texts, num_videos]
        (clip4clip.py:324-367); `video_mask` is the post-cluster mask."""
        if visual_output.dim() == 2:
            visual = visual_output.float()
        else:
            visual = self.pooled_video(visual_output, video_mask)
        seq = _normalize(sequence_output.float().reshape(
            -1, sequence_output.shape[-1]))
        if logit_scale is None:
            logit_scale = self.clip.logit_scale.exp()
        return logit_scale * seq @ visual.t()

    def forward(self, input_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                video: Optional[torch.Tensor] = None,
                video_mask: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """Joint forward (JAX package `models/clip4clip.py:232-272`).

        Returns sequence_output / visual_output and, with `training`, the
        loss terms: sim_loss = 0.5 (CE(sim) + CE(sim^T)) over the meanP
        logits with the post-cluster video mask, cluster_loss (the
        DeepCluster heads' WCSS, else 0), loss = their sum.  Without
        `training` and with `pre_visual_pooling` (ActivityNet), the visual
        output is the pooled, normalised [B, D] video vector.  `generator`
        draws the training step's random choices (`sparse_sampling`).
        `attention_mask` is accepted for the reference's signature; meanP
        does not read it."""
        del attention_mask
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
            sim = self.loose_similarity(out["sequence_output"],
                                        out["visual_output"], video_mask)
            sim_loss = 0.5 * (cross_entropy(sim) + cross_entropy(sim.t()))
            if cluster_loss is None:
                cluster_loss = torch.zeros((), device=sim.device)
            out.update(sim_loss=sim_loss, cluster_loss=cluster_loss,
                       loss=sim_loss + cluster_loss)
        return out
