# coding=utf-8
"""The port's 3-D patchify and ResNet towers against the JAX package, on
the CPU.

* The 3-D tubelet patchify on the `tiny-e2e` arch of tests/test_main_e2e.py
  (4 frames of 32 x 32 at patch 16, fp32), alone against `lax.conv` and
  inside the model: the visual output from float and from uint8 frames
  (normalised explicitly in fp32 by both packages), and one training step's
  loss and every gradient, `conv2` included.
* A narrow ModifiedResNet (layers (1, 1, 1, 1), width 16, 64 x 64 frames,
  8 heads of 64 in the attention pool) with random BatchNorm statistics:
  the visual and text features; RN50's and RN101's key schema against the
  reference's names and sizes.

Weights cross over through `state_dict_from_jax_params` (flax's HWIO
convolution kernels transposed to OIHW) and `load_state_dict(strict=True)`.
fp32 budget: rtol 2e-4 / atol 2e-5, as tests/test_torch_models.py; losses
rtol 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from centerclip_tpu import config as jax_config
from centerclip_tpu.models import resnet as jax_resnet
from centerclip_tpu.models.clip4clip import CLIP4Clip as JaxCLIP4Clip
from centerclip_tpu_torch import config as port_config
from centerclip_tpu_torch.models import resnet
from centerclip_tpu_torch.models.clip import patchify_3d
from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
from centerclip_tpu_torch.models.weights import (clip4clip_entries,
                                                 state_dict_from_jax_params)
from centerclip_tpu_torch.train import loop

T, CTX, VOCAB = 4, 12, 49408
TINY = dict(embed_dim=16, image_resolution=32, vision_layers=2,
            vision_width=32, vision_patch_size=16, vision_heads=2,
            context_length=CTX, vocab_size=VOCAB, transformer_width=32,
            transformer_heads=2, transformer_layers=2)
TINY_RN = dict(embed_dim=16, image_resolution=64, vision_layers=(1, 1, 1, 1),
               vision_width=16, vision_patch_size=None, context_length=CTX,
               vocab_size=VOCAB, transformer_width=32, transformer_heads=2,
               transformer_layers=2)
for name, arch in (("tiny-e2e", TINY), ("tiny-port-rn", TINY_RN)):
    jax_config.CLIP_ARCHS[name] = arch
    port_config.CLIP_ARCHS[name] = arch

FP32 = dict(rtol=2e-4, atol=2e-5)
MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def normalise(u8):
    return ((u8 / 255.0 - MEAN[:, None, None]) / STD[:, None, None]
            ).astype(np.float32)


def make_batch(seed, n=3, res=32):
    g = np.random.default_rng(seed)
    ids = g.integers(1, 1000, size=(n, CTX)).astype(np.int32)
    ids[:, 0] = VOCAB - 2
    ids[np.arange(n), g.integers(3, CTX, n)] = VOCAB - 1     # EOT
    vmask = np.ones((n, T), np.int32)
    vmask[-1, -1] = 0
    return {"input_ids": ids, "attention_mask": np.ones((n, CTX), np.int32),
            "video": g.integers(0, 256, (n, 1, T, 3, res, res),
                                dtype=np.uint8),
            "video_mask": vmask}


def build_pair(arch, res, perturb=None, **over):
    kw = dict(clip_name=arch, max_frames=T, max_words=CTX,
              compute_dtype="float32", lr=1e-3, coef_lr=0.5, **over)
    jrun = jax_config.make_run_config(**kw)
    run = port_config.make_run_config(**kw)
    assert dataclasses.asdict(run) == dataclasses.asdict(jrun)
    jmodel = JaxCLIP4Clip(jrun.model)
    b = make_batch(0, res=res)
    params = jmodel.init(jax.random.PRNGKey(0), input_ids=b["input_ids"],
                         video=normalise(b["video"]),
                         video_mask=b["video_mask"], training=True)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    if perturb is not None:
        params = perturb(params)
    model = CLIP4Clip(run.model, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, run.model),
                          strict=True)
    return jmodel, params, model, run


@pytest.fixture(scope="module")
def patch3d():
    return build_pair("tiny-e2e", 32, linear_patch="3d")


def _random_bn(params):
    """Random BatchNorm statistics and affine parameters in the ResNet
    tower, so the frozen BatchNorm's every term is exercised."""
    g = np.random.default_rng(9)

    def walk(node):
        if isinstance(node, dict):
            if set(node) == {"scale", "bias", "mean", "var"}:
                n = node["scale"].shape[0]
                return {"scale": g.uniform(0.5, 1.5, n).astype(np.float32),
                        "bias": g.normal(0, 0.1, n).astype(np.float32),
                        "mean": g.normal(0, 0.1, n).astype(np.float32),
                        "var": g.uniform(0.5, 2.0, n).astype(np.float32)}
            return {k: walk(v) for k, v in node.items()}
        return node
    return walk(params)


@pytest.fixture(scope="module")
def rn():
    return build_pair("tiny-port-rn", 64, perturb=_random_bn)


def _jax(jmodel, params, fn, *args):
    return np.asarray(jmodel.apply({"params": params}, *args, method=fn))


# ------------------------------------------------------------ 3-D patchify
def test_patchify_3d_alone_matches_lax_conv():
    g = np.random.default_rng(1)
    B, width, P = 2, 8, 16
    video = g.standard_normal((B * T, 3, 32, 48)).astype(np.float32)
    w = g.standard_normal((width, 3, 3, P, P)).astype(np.float32) * 0.05
    x5 = video.reshape(B, T, 3, 32, 48).transpose(0, 2, 1, 3, 4)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x5), jnp.asarray(w), window_strides=(1, P, P),
        padding=((1, 1), (0, 0), (0, 0)),
        dimension_numbers=("NCDHW", "OIDHW", "NCDHW"))
    ref = np.asarray(ref).transpose(0, 2, 3, 4, 1).reshape(B * T, -1, width)
    out = patchify_3d(t(video), t(w), T, torch.float32)
    assert tuple(out.shape) == (B * T, 2 * 3, width)
    np.testing.assert_allclose(out.numpy(), ref, **FP32)
    # the temporal padding: the first frame sees no frame before it
    np.testing.assert_allclose(
        patchify_3d(t(video), t(np.concatenate(
            [np.zeros_like(w[:, :, :1]), w[:, :, 1:]], axis=2)), T,
            torch.float32).numpy()[::T],
        out.numpy()[::T], **FP32)


@pytest.mark.parametrize("pixels", ["uint8", "float32"])
def test_patchify_3d_visual_output_matches_jax(patch3d, pixels):
    jmodel, params, model, _ = patch3d
    b = make_batch(2)
    video = b["video"] if pixels == "uint8" else normalise(b["video"])
    ref = _jax(jmodel, params,
               lambda m, v, vm: m.get_visual_output(v, vm)[0], video,
               b["video_mask"])
    with torch.no_grad():
        out = model.get_visual_output(t(video), t(b["video_mask"]))
    assert tuple(out.shape) == (3, T, 16)
    np.testing.assert_allclose(out.numpy(), ref, **FP32)


def test_patchify_3d_and_resnet_refuse_uint8_as_jax_does(patch3d, rn):
    for jmodel, params, model, _ in (patch3d, rn):
        u8 = make_batch(3, res=model.cfg.arch["image_resolution"])["video"]
        u8 = u8.reshape(-1, *u8.shape[-3:])
        with pytest.raises(ValueError, match="uint8"):
            jmodel.apply({"params": params}, u8,
                         method=lambda m, v: m.clip.encode_image(v))
        with pytest.raises(ValueError, match="uint8"):
            model.clip.encode_image(t(u8))


def test_patchify_3d_step_loss_and_every_gradient_match_jax(patch3d):
    jmodel, params, model, run = patch3d
    batch = make_batch(4)

    def loss_fn(p):
        out = jmodel.apply({"params": p}, input_ids=batch["input_ids"],
                           attention_mask=batch["attention_mask"],
                           video=batch["video"],
                           video_mask=batch["video_mask"], training=True,
                           rng=jax.random.PRNGKey(0))
        return out["loss"]
    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    model.zero_grad()
    out = model(**loop.batch_to_device(batch, torch.device("cpu")),
                training=True)
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), float(jloss),
                               rtol=1e-5)
    named = dict(model.named_parameters())
    for path, key, tf in clip4clip_entries(run.model):
        ref = jgrads
        for p in path:
            ref = ref[p]
        ref = np.asarray(ref)
        grad = named[key].grad
        if grad is None:          # conv1 is not read by the 3-D patchify
            assert key == "clip.visual.conv1.weight" and not ref.any(), key
            continue
        np.testing.assert_allclose(grad.numpy(), ref.T if tf == "T" else ref,
                                   err_msg=key, **FP32)
    assert float(named["clip.visual.conv2.weight"].grad.abs().sum()) > 0


# ------------------------------------------------------------ the ResNets
@pytest.mark.parametrize("pixels", ["uint8", "float32"])
def test_narrow_resnet_visual_output_matches_jax(rn, pixels):
    jmodel, params, model, _ = rn
    b = make_batch(5, res=64)
    video = b["video"] if pixels == "uint8" else normalise(b["video"])
    ref = _jax(jmodel, params,
               lambda m, v, vm: m.get_visual_output(v, vm)[0], video,
               b["video_mask"])
    with torch.no_grad():
        out = model.get_visual_output(t(video), t(b["video_mask"]))
    assert tuple(out.shape) == (3, T, 16)
    np.testing.assert_allclose(out.numpy(), ref, **FP32)


def test_narrow_resnet_text_and_similarity_match_jax(rn):
    jmodel, params, model, _ = rn
    b = make_batch(6, res=64)
    ref_seq = _jax(jmodel, params, lambda m, i: m.get_sequence_output(i),
                   b["input_ids"])
    ref_vis = _jax(jmodel, params,
                   lambda m, v, vm: m.get_visual_output(v, vm)[0],
                   b["video"], b["video_mask"])
    ref = _jax(jmodel, params,
               lambda m, s, v, vm: m.get_similarity_logits(s, v, None, vm),
               ref_seq, ref_vis, b["video_mask"])
    with torch.no_grad():
        seq = model.get_sequence_output(t(b["input_ids"]).long())
        vis = model.get_visual_output(t(b["video"]), t(b["video_mask"]))
        sim = model.get_similarity_logits(seq, vis, None,
                                          t(b["video_mask"]))
    np.testing.assert_allclose(seq.numpy(), ref_seq, **FP32)
    np.testing.assert_allclose(sim.numpy(), ref, **FP32)


def test_bottleneck_stride_goes_through_pool_and_downsample():
    """stride > 1: an average pool after conv2 and a pooled 1 x 1
    downsample (clip.py:50-68), as JAX `tests/test_resnet.py`."""
    x = np.random.default_rng(7).standard_normal((1, 64, 16, 16)
                                                 ).astype(np.float32)
    blk = jax_resnet.Bottleneck(planes=32, stride=2)
    params = jax.tree_util.tree_map(
        np.asarray, blk.init(jax.random.PRNGKey(0), x)["params"])
    ref = np.asarray(blk.apply({"params": params}, x))
    port = resnet.Bottleneck(64, 32, stride=2)
    sd = {}
    for name, node in params.items():
        key = {"downsample_conv": "downsample.0",
               "downsample_bn": "downsample.1"}.get(name, name)
        if "kernel" in node:
            sd[f"{key}.weight"] = t(node["kernel"].transpose(3, 2, 0, 1))
        else:
            sd.update({f"{key}.{k2}": t(node[k1]) for k1, k2 in (
                ("scale", "weight"), ("bias", "bias"),
                ("mean", "running_mean"), ("var", "running_var"))})
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = port(t(x))
    assert tuple(out.shape) == ref.shape == (1, 128, 8, 8)
    np.testing.assert_allclose(out.numpy(), ref, **FP32)


# the reference's RN50 / RN101 visual towers (modules/clip.py:40-180)
RN_SCHEMA = {
    "RN50": dict(blocks=(3, 4, 6, 3), visual_params=38.3e6,
                 shapes={"clip.visual.conv1.weight": (32, 3, 3, 3),
                         "clip.visual.layer4.2.conv3.weight": (2048, 512, 1, 1),
                         "clip.visual.attnpool.positional_embedding":
                             (50, 2048),
                         "clip.visual.attnpool.c_proj.weight": (1024, 2048),
                         "clip.text_projection": (512, 1024)}),
    "RN101": dict(blocks=(3, 4, 23, 3), visual_params=56.3e6,
                  shapes={"clip.visual.layer3.22.bn2.running_var": (256,),
                          "clip.visual.attnpool.c_proj.weight": (512, 2048),
                          "clip.text_projection": (512, 512)})}


@pytest.mark.parametrize("name", ["RN50", "RN101"])
def test_resnet_key_schema_is_the_reference(name):
    spec = RN_SCHEMA[name]
    run = port_config.make_run_config(clip_name=name, max_frames=2)
    model = CLIP4Clip(run.model, device="cpu")
    sd = model.state_dict()
    keys = [k for _, k, _ in clip4clip_entries(run.model)]
    assert set(sd) == set(keys) and len(keys) == len(sd)
    for key, shape in spec["shapes"].items():
        assert tuple(sd[key].shape) == shape, key
    for layer, n in enumerate(spec["blocks"], 1):
        assert f"clip.visual.layer{layer}.{n - 1}.bn3.running_mean" in sd
        assert f"clip.visual.layer{layer}.{n}.conv1.weight" not in sd
        assert f"clip.visual.layer{layer}.0.downsample.0.weight" in sd
        assert f"clip.visual.layer{layer}.0.downsample.1.running_var" in sd
        assert f"clip.visual.layer{layer}.1.downsample.0.weight" not in sd
    for proj in ("q_proj", "k_proj", "v_proj"):
        assert tuple(sd[f"clip.visual.attnpool.{proj}.weight"].shape) \
            == (2048, 2048)
    n = sum(p.numel() for p in model.clip.visual.parameters())
    assert abs(n / spec["visual_params"] - 1) < 0.01, n
    # a reference state dict carries BatchNorm's num_batches_tracked
    ref_sd = dict(sd)
    ref_sd["clip.visual.bn1.num_batches_tracked"] = torch.tensor(0)
    ref_sd["clip.visual.layer1.0.downsample.1.num_batches_tracked"] = \
        torch.tensor(0)
    model.load_state_dict(ref_sd, strict=True)


def test_rn50_encodes_through_clip4clip():
    """JAX `tests/test_resnet.py::test_rn_clip_integration`'s shapes: two
    224 x 224 frames of RN50 give [1, 2, 1024] visual features."""
    run = port_config.make_run_config(clip_name="RN50", max_frames=2)
    model = CLIP4Clip(run.model, device="cpu")
    video = torch.randint(0, 256, (1, 1, 2, 3, 224, 224), dtype=torch.uint8)
    with torch.no_grad():
        vis = model.get_visual_output(video, torch.ones(1, 2))
        feats, closs = model.clip.encode_image(
            torch.zeros(2, 3, 224, 224))
    assert tuple(vis.shape) == (1, 2, 1024) and vis.dtype == torch.float32
    assert bool(torch.isfinite(vis).all())
    assert tuple(feats.shape) == (2, 1024) and float(closs) == 0.0
