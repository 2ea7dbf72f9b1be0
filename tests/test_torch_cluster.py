# coding=utf-8
"""The port's TokenClusterInter (kmediods++ branch) and
video_mask_after_cluster against the JAX package, on the CPU.

Tiny shapes: 2 clips of 4 frames -> 2 segments, 9 patch tokens per frame
(N = 18 points per segment, the direct distance branch where both packages
compute the same distances), width 16, K = 5.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from centerclip_tpu.config import (BlockClusterSpec as JaxSpec,
                                   ClusterConfig as JaxCluster)
from centerclip_tpu.ops import cluster_layer as jax_cluster
from centerclip_tpu_torch.config import BlockClusterSpec, ClusterConfig
from centerclip_tpu_torch.ops import cluster_layer

B, T, S, P, W, K = 2, 4, 2, 9, 16, 5


def _specs():
    kw = dict(block_id=2, algo="kmediods++", before_cluster_num=P,
              cluster_num=K, before_frames=T, after_frames=S,
              frame_duration=T // S)
    return JaxSpec(**kw), BlockClusterSpec(**kw)


def _tokens(seed):
    g = np.random.default_rng(seed)
    centres = g.standard_normal((4, W)).astype(np.float32) * 3.0
    x = centres[g.integers(0, 4, (B * T, 1 + P))] \
        + 0.3 * g.standard_normal((B * T, 1 + P, W))
    return x.astype(np.float32)


@pytest.mark.parametrize("options", [
    {},
    {"aggregation": "mean"},
    {"cluster_embedding": True},
    {"adaptive_cls": True},
    {"cluster_embedding": True, "adaptive_cls": True, "distance": "cosine"},
])
def test_token_cluster_matches_jax(options):
    jspec, spec = _specs()
    jcfg = JaxCluster(inter=True, **options)
    cfg = ClusterConfig(inter=True, **options)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    x = _tokens(len(options))
    jmod = jax_cluster.TokenClusterInter(spec=jspec, cfg=jcfg, width=W)
    variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params = variables.get("params", {})
    if "cls_multiplier" in params:          # make the multiplier non-trivial
        params = dict(params)
        params["cls_multiplier"] = params["cls_multiplier"] * jnp.asarray(
            np.linspace(0.5, 1.5, T, dtype=np.float32)[None, :, None, None])
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))

    mod = cluster_layer.TokenClusterInter(spec, cfg, W)
    mod.load_state_dict({k: torch.from_numpy(np.array(v, copy=True))
                         for k, v in params.items()}, strict=True)
    out = mod(torch.from_numpy(x.copy()))
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape \
        == (B * S, 1 + K, W)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-6,
                               atol=1e-6)


def test_segment_layout_matches_jax():
    x = np.arange(B * T * 3 * 2, dtype=np.float32).reshape(B, T, 3, 2)
    ref = np.asarray(jax_cluster.segment_major(jnp.asarray(x), S, T // S))
    out = cluster_layer.segment_major(torch.from_numpy(x), S, T // S)
    np.testing.assert_array_equal(out.numpy(), ref)
    back = cluster_layer.segment_interleave(out[:, :3], B, S)
    np.testing.assert_array_equal(
        back.numpy(),
        np.asarray(jax_cluster.segment_interleave(jnp.asarray(ref[:, :3]),
                                                  B, S)))


@pytest.mark.parametrize("T_,final", [(12, 6), (12, 4), (4, 2)])
def test_video_mask_after_cluster_matches_jax(T_, final):
    mask = (np.random.default_rng(T_).random((3, T_)) > 0.3).astype(np.int32)
    ref = np.asarray(jax_cluster.video_mask_after_cluster(
        jnp.asarray(mask), final, T_ // final))
    out = cluster_layer.video_mask_after_cluster(
        torch.from_numpy(mask.copy()), final, T_ // final)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_unported_cluster_algos_raise():
    """Every algorithm of the JAX package is ported
    (tests/test_torch_cluster_algos.py::test_every_cluster_algo_builds);
    a name outside them still raises, and so do the ResNet towers and the
    seqTransf header, which are not ported yet."""
    from centerclip_tpu_torch.config import make_run_config
    from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
    assert set(cluster_layer.PORTED_ALGOS) == {
        "kmediods++", "pooling", "sparse_sampling", "spectral",
        "temporal_shift", "token_shift"}
    spec = dataclasses.replace(_specs()[1], algo="agglomerative")
    with pytest.raises(NotImplementedError):
        cluster_layer.TokenClusterInter(spec, ClusterConfig(inter=True), W)
    for over in (dict(clip_name="RN50"), dict(sim_header="seqTransf")):
        cfg = make_run_config(inter=True, algo="spectral", **over).model
        with pytest.raises(NotImplementedError):
            CLIP4Clip(cfg, device="cpu")
