# coding=utf-8
"""The port's clustered CLIP4Clip (meanP) against the JAX package on the CPU.

A tiny clustered model (2 + 2 blocks, width 64, 4 frames -> 2 segments,
9 patch tokens per frame, K = 5) is initialised by the JAX package; its
parameters cross over through `state_dict_from_jax_params` and
`load_state_dict(strict=True)`.  The fp32 budget is rtol 2e-4 / atol 2e-5
(as in tests/test_model_parity.py).
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from centerclip_tpu import config as jax_config
from centerclip_tpu.models.clip4clip import CLIP4Clip as JaxCLIP4Clip
from centerclip_tpu_torch import config as port_config
from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
from centerclip_tpu_torch.models.weights import (load_torch_checkpoint,
                                                 state_dict_from_jax_params)

ARCH = "tiny-port-models"
T, RES, VOCAB, CTX = 4, 24, 100, 12
TINY = dict(embed_dim=32, image_resolution=RES, vision_layers=2,
            vision_width=64, vision_patch_size=8, vision_heads=4,
            context_length=CTX, vocab_size=VOCAB, transformer_width=64,
            transformer_heads=4, transformer_layers=2)
# each package has its own architecture table
jax_config.CLIP_ARCHS[ARCH] = TINY
port_config.CLIP_ARCHS[ARCH] = TINY

FP32 = dict(rtol=2e-4, atol=2e-5)


def config_kw(**over):
    kw = dict(clip_name=ARCH, max_frames=T, max_words=CTX,
              compute_dtype="float32", inter=True, algo="kmediods++",
              cluster_num_blocks=(5, 5), target_frames_blocks=(T, T // 2),
              cluster_embedding=True, adaptive_cls=True)
    kw.update(over)
    return kw


def make_inputs(seed, n=3):
    g = np.random.default_rng(seed)
    ids = g.integers(1, VOCAB - 2, size=(n, CTX)).astype(np.int32)
    ids[:, 0] = VOCAB - 2
    ids[np.arange(n), g.integers(3, CTX, n)] = VOCAB - 1     # EOT
    video = g.integers(0, 256, (n, 1, T, 3, RES, RES), dtype=np.uint8)
    vmask = np.ones((n, T), np.int32)
    vmask[-1, -1] = 0
    return ids, video, vmask


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_config.make_run_config(**config_kw()).model
    cfg = port_config.make_run_config(**config_kw()).model
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = JaxCLIP4Clip(jcfg)
    ids, video, vmask = make_inputs(0)
    params = jmodel.init(jax.random.PRNGKey(0), input_ids=ids,
                         video=video.astype(np.float32), video_mask=vmask,
                         training=True)["params"]
    model = CLIP4Clip(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), cfg), strict=True)
    return jmodel, params, model


def _jax(jmodel, params, method, *args):
    return jmodel.apply({"params": params}, *args, method=method)


def test_state_dict_names_are_the_reference_schema(pair):
    _, _, model = pair
    keys = set(model.state_dict())
    assert "clip.visual.transformer.resblocks.0.attn.in_proj_weight" in keys
    assert "clip.transformer.resblocks.1.mlp.c_proj.bias" in keys
    assert ("clip.visual.transformer.resblocks.1.tokencluster_inter"
            ".cluster_embed") in keys
    assert "clip.token_embedding.weight" in keys


def test_text_features_match_jax(pair):
    jmodel, params, model = pair
    ids, _, _ = make_inputs(1)
    ref = np.asarray(_jax(jmodel, params,
                          JaxCLIP4Clip.get_sequence_output, jnp.asarray(ids)))
    out = model.get_sequence_output(t(ids).long())
    np.testing.assert_allclose(out.detach().numpy(), ref, **FP32)


@pytest.mark.parametrize("pixels", ["uint8", "float32"])
def test_visual_output_matches_jax(pair, pixels):
    jmodel, params, model = pair
    _, video, vmask = make_inputs(2)
    if pixels == "float32":
        mean = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
        std = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
        video = ((video / 255.0 - mean[:, None, None]) / std[:, None, None]
                 ).astype(np.float32)
    vm = model.video_mask_after_cluster(t(vmask))
    ref, _ = _jax(jmodel, params, JaxCLIP4Clip.get_visual_output,
                  jnp.asarray(video), jnp.asarray(np.asarray(vm)))
    out = model.get_visual_output(t(video), vm)
    assert tuple(out.shape) == (3, T // 2, 32)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **FP32)


def test_similarity_matches_jax(pair):
    jmodel, params, model = pair
    ids, video, vmask = make_inputs(3)
    seq = _jax(jmodel, params, JaxCLIP4Clip.get_sequence_output,
               jnp.asarray(ids))
    vm = np.asarray(_jax(jmodel, params,
                         JaxCLIP4Clip.video_mask_after_cluster,
                         jnp.asarray(vmask)))
    vis, _ = _jax(jmodel, params, JaxCLIP4Clip.get_visual_output,
                  jnp.asarray(video), jnp.asarray(vm))
    ref = _jax(jmodel, params, JaxCLIP4Clip.loose_similarity, seq, vis,
               None, jnp.asarray(vm))
    vm_t = model.video_mask_after_cluster(t(vmask))
    np.testing.assert_array_equal(vm_t.numpy(), vm)
    sim = model.loose_similarity(model.get_sequence_output(t(ids).long()),
                                 model.get_visual_output(t(video), vm_t),
                                 vm_t)
    np.testing.assert_allclose(sim.detach().numpy(), np.asarray(ref), **FP32)


def test_bf16_model_tracks_fp32(pair):
    """bf16 towers (fp32 LayerNorm, softmax, clustering, similarity) against
    the same weights in fp32.  bf16 keeps 8 significant bits, so features
    are held by cosine: >= 0.999 for the text tower and for the unclustered
    vision tower.  With clustering on, a bf16 rounding may move a k-medoids
    choice, so the clustered model is held to finite features of the right
    shape only."""
    _, _, model = pair
    ids, video, vmask = make_inputs(4)

    def build(**over):
        m = CLIP4Clip(port_config.make_run_config(**config_kw(**over)).model,
                      device="cpu")
        own = m.state_dict()      # the unclustered model has no cluster keys
        m.load_state_dict({k: v for k, v in model.state_dict().items()
                           if k in own}, strict=True)
        return m

    def cos(a, b):
        return torch.nn.functional.cosine_similarity(a, b, dim=-1)

    bf = build(compute_dtype="bfloat16")
    ids_t = t(ids).long()
    assert cos(bf.get_sequence_output(ids_t),
               model.get_sequence_output(ids_t)).min() >= 0.999
    vm = model.video_mask_after_cluster(t(vmask))
    vis = bf.get_visual_output(t(video), vm)
    assert vis.dtype == torch.float32 and tuple(vis.shape) == (3, T // 2, 32)
    assert torch.isfinite(vis).all()

    flat = dict(inter=False, cluster_num_blocks=(), target_frames_blocks=(),
                cluster_embedding=False, adaptive_cls=False)
    f32, f16 = build(**flat), build(compute_dtype="bfloat16", **flat)
    vmask_t = t(vmask)
    assert cos(f16.get_visual_output(t(video), vmask_t),
               f32.get_visual_output(t(video), vmask_t)).min() >= 0.999


def test_checkpoint_file_roundtrip(pair, tmp_path):
    _, _, model = pair
    path = tmp_path / "ckpt.pth.tar"
    torch.save({"epoch": 1, "state_dict": {
        "module." + k: v for k, v in model.state_dict().items()}}, path)
    sd = load_torch_checkpoint(str(path))
    cfg = port_config.make_run_config(**config_kw()).model
    other = CLIP4Clip(cfg, device="cpu", seed=1)
    other.load_state_dict(sd, strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k


def test_builders_refuse_what_is_not_ported():
    """The builder builds wherever the JAX package builds: the seqTransf,
    seqLSTM and tightTransf headers, the 3-D patchify and the ResNet
    towers, and under sequence parallelism; seqLSTM raises at the
    similarity, as the JAX package's does.  Pipeline parallelism builds
    too (the Trainer stages the model later); a pipeline extent below 1
    raises at build."""
    b = make_inputs(4)
    for over in (dict(sim_header="seqTransf"), dict(sim_header="seqLSTM"),
                 dict(sim_header="tightTransf"), dict(linear_patch="3d"),
                 dict(clip_name="RN50", inter=False, cluster_num_blocks=(),
                      target_frames_blocks=())):
        cfg = port_config.make_run_config(**config_kw(**over)).model
        model = CLIP4Clip(cfg, device="cpu")
        seq = torch.ones(3, 1, cfg.arch["embed_dim"])
        vis = torch.ones(3, 2, cfg.arch["embed_dim"])
        if over.get("sim_header") == "seqLSTM":
            with pytest.raises(NotImplementedError, match="seqLSTM"):
                model.get_similarity_logits(seq, vis, None, t(b[2][:, :2]))
        else:
            sim = model.get_similarity_logits(seq, vis, None, t(b[2][:, :2]))
            assert tuple(sim.shape) == (3, 3)
    # sequence and pipeline parallelism build (the Trainer splits or
    # stages the model later)
    cfg = port_config.make_run_config(**config_kw(
        tensor_parallel=2, sequence_parallel=True)).model
    assert cfg.sequence_parallel
    CLIP4Clip(cfg, device="cpu")
    cfg = port_config.make_run_config(**config_kw(pipeline_parallel=2)).model
    assert cfg.pipeline_parallel == 2
    CLIP4Clip(cfg, device="cpu")
    cfg = port_config.make_run_config(**config_kw(pipeline_parallel=0)).model
    with pytest.raises(ValueError, match="pipeline_parallel 0"):
        CLIP4Clip(cfg, device="cpu")


def test_model_builder_needs_a_gpu_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_config.make_run_config(**config_kw()).model
    with pytest.raises(RuntimeError):
        CLIP4Clip(cfg)
