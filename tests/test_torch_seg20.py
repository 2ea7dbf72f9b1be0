# coding=utf-8
"""k-medoids past N = 3136 on the CPU: ViT-B/16 segments of 20 frames
(ActivityNet's 60 frames in 3 segments: N = 20 x 196 = 3920 tokens a
segment), one segment cut to N = 3137, and K = N = 2352, against the JAX
package.

- Kernel E's scratch variant (csrc/kmedoids.cu `kmedoids_scratch_kernel`)
  runs the large variant's steps in the same order, with its member masks
  (and, where shared memory cannot hold it, its per-point state) in device
  memory: the numpy emulation of those steps in tests/test_torch_long_
  segments.py is its emulation too.  It is held against the port's plain
  `kmedoids_on_distances` and JAX's `batch_fast_kmedoids` on the same
  distances at these N and K: ids, assignment, and the kernel's steps to
  each segment's fixed point.  So is the emulation of the cluster variant
  (`kmedoids_cluster_kernel`, which the router now gives these N and K)
  on clusters of 1, 2, 8 and 16 CTAs.
- The port's cluster layer against JAX's at N = 3920 (narrow width 16,
  tokens on a line at integer positions, so both packages' distances and
  sums are exact and equal: the same medoids, the same gathered tokens).
- The CLIs: both packages parse the path's flags (60 frames, 3 segments,
  K = 160 at ViT-B/16) to the same config, whose N the cluster variant
  takes on clusters of 8 CTAs at a training step's 48 segments.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centerclip_tpu import cli as jax_cli
from centerclip_tpu.config import (BlockClusterSpec as JaxSpec,
                                   ClusterConfig as JaxCluster)
from centerclip_tpu.ops import cluster_layer as jax_cluster
from centerclip_tpu_torch import cli
from centerclip_tpu_torch.config import BlockClusterSpec, ClusterConfig
from centerclip_tpu_torch.ops import cluster_layer, kmedoids_cuda
from tests.test_torch_long_segments import (CLUSTER_SIZES, COMMON, _blobs,
                                            _distances, _line, check_three)


@pytest.mark.parametrize("N,K,data", [
    (3137, 160, "blobs"),         # the first N past the large variant
    (3920, 160, "blobs"),         # a 20-frame ViT-B/16 segment
    (3920, 392, "gaussian"),      # its K = 392
    (2352, 2352, "blobs"),        # a 12-frame clip, every token a medoid
])
def test_scratch_variant_matches_plain_and_jax(N, K, data):
    """The scratch variant's steps (the large variant's emulation) and the
    cluster variant's on clusters of 1, 2, 8 and 16 CTAs, against the plain
    version and JAX's; the router now gives these N and K the cluster
    variant."""
    assert kmedoids_cuda.choose_variant(N, K) == kmedoids_cuda.CLUSTER
    if data == "blobs":
        x = _blobs(N + K, 1, N, 16, centres=60)
    else:
        x = np.random.default_rng(N + K).standard_normal(
            (1, N, 16)).astype(np.float32)
    check_three(x, _distances(x), K, sizes=CLUSTER_SIZES)


def test_scratch_variant_repeated_points_at_n3920():
    """3920 integers drawn from 0-299 on a line (K = 160): points repeat
    and distances tie everywhere; every sum is exact."""
    p = np.random.default_rng(3920).integers(0, 300, (1, 3920))
    X, D = _line(p.astype(np.float32))
    check_three(X, D, 160, sizes=CLUSTER_SIZES)


def test_cluster_layer_matches_jax_at_n3920():
    """TokenClusterInter on one clip of 20 frames as one segment (N =
    3920, K = 160, width 16): the port's (plain k-medoids on the CPU)
    against JAX's.  The patch tokens lie on a line at integers in pairs
    +-h (0 < h < 1000, shuffled; 0 in the other channels): their mean is
    0 however it is computed, so both packages' mean-centred distances by
    matmul (ops/distances.py) are exact and equal, as are their sums."""
    F, P, W, K = 20, 196, 16, 160
    kw = dict(block_id=7, algo="kmediods++", before_cluster_num=P,
              cluster_num=K, before_frames=F, after_frames=1,
              frame_duration=F)
    jspec, spec = JaxSpec(**kw), BlockClusterSpec(**kw)
    jcfg, cfg = JaxCluster(inter=True), ClusterConfig(inter=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    g = np.random.default_rng(F * P)
    x = np.zeros((F, 1 + P, W), np.float32)
    x[:, 0] = g.standard_normal((F, W))                      # CLS
    h = g.integers(1, 1000, F * P // 2)
    x[:, 1:, 0] = g.permutation(np.concatenate([h, -h])).reshape(F, P)
    jmod = jax_cluster.TokenClusterInter(spec=jspec, cfg=jcfg, width=W)
    variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    mod = cluster_layer.TokenClusterInter(spec, cfg, W)
    mod.load_state_dict({k: torch.from_numpy(np.array(v, copy=True))
                         for k, v in variables.get("params", {}).items()},
                        strict=True)
    out = mod(torch.from_numpy(x.copy()))
    assert tuple(out.shape) == ref.shape == (1, 1 + K, W)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-6,
                               atol=1e-6)


def test_clis_parse_the_20_frame_flags_to_the_same_plan():
    """`--max_frames 60 --target_frames_blocks 60 x 6, 3 x 6` with
    `--cluster_num_blocks 196 x 6, 160 x 6` at ViT-B/16 (chip_smoke.py's
    sixteenth path): the same config from both CLIs, a plan that clusters
    20 frames of 196 tokens into 160 before block 7, and an N the cluster
    variant takes, 8 CTAs a segment at a training step's 48 segments."""
    argv = [a if a != "12" else "60" for a in COMMON] + [
        "--cluster_num_blocks", *["196"] * 6, *["160"] * 6,
        "--target_frames_blocks", *["60"] * 6, *["3"] * 6]
    a, b = cli.parse_args(argv), jax_cli.parse_args(argv)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    spec = a.model.cluster_plan()[6]
    N = spec.frame_duration * spec.before_cluster_num
    assert (a.model.max_frames, N, spec.cluster_num, spec.after_frames) == \
        (60, 3920, 160, 3)
    assert kmedoids_cuda.choose_variant(N) == kmedoids_cuda.CLUSTER
    assert kmedoids_cuda.choose_variant(N, 160) == kmedoids_cuda.CLUSTER
    # the H100's resident clusters at N = 3920, K = 160 (see
    # test_torch_ln_kmedoids_design.py's H100_RESIDENT)
    h100 = {1: 132, 2: 132, 4: 92, 8: 62, 16: 28}
    assert kmedoids_cuda.cluster_size(48, N, 160, h100) == 8
