# coding=utf-8
"""ViT-B/16 with `--precision fp32` on the CPU, against the JAX package.

A narrow model at ViT-B/16's token geometry, built from the flags both CLIs
take with `--precision fp32` (which makes the towers' compute dtype
float32): 2 vision blocks of width 64 at patch 16 on 224 x 224 frames
(L = 197), k-medoids before block 2 (2 frames as one segment: N = 2 x 196
= 392 tokens into K = 160, so block 2 attends over L = 161), 2 text blocks
of 12 tokens, 2 clips.  The JAX package initialises it; the parameters
cross over through `state_dict_from_jax_params`; the port's own plain
k-medoids ids are replayed in both packages (at K = 160 of N = 392 the two
packages' distance rounding picks other medoids: tests/test_torch_vitb16.py).
The loss, every gradient and both encoders' features are held at fp32 rtol
2e-4 / atol 2e-5 (tests/test_torch_models.py).  On the card these towers'
qkv go to kernels A and B: the attention inputs of a CPU step are recorded
at the model's call site and the variant each takes is held (the vision
blocks' fp32 long one, the text tower's CUDA-core one).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centerclip_tpu import cli as jax_cli
from centerclip_tpu import config as jax_config
from centerclip_tpu.models.clip4clip import CLIP4Clip as JaxCLIP4Clip
from centerclip_tpu.ops import cluster_layer as jax_cluster
from centerclip_tpu_torch import cli
from centerclip_tpu_torch import config as port_config
from centerclip_tpu_torch.models import layers
from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
from centerclip_tpu_torch.models.weights import (clip4clip_entries,
                                                 state_dict_from_jax_params)
from centerclip_tpu_torch.ops import attention_cuda, cluster_layer
from centerclip_tpu_torch.train import loop

ARCH = "narrow-vitb16-fp32"
T, RES, VOCAB, CTX, N_CLIPS = 2, 224, 100, 12, 2
NARROW = dict(embed_dim=32, image_resolution=RES, vision_layers=2,
              vision_width=64, vision_patch_size=16, vision_heads=4,
              context_length=CTX, vocab_size=VOCAB, transformer_width=64,
              transformer_heads=4, transformer_layers=2)
jax_config.CLIP_ARCHS[ARCH] = NARROW
port_config.CLIP_ARCHS[ARCH] = NARROW
N_TOKENS, K = T * 196, 160            # tokens per segment, medoids
FP32 = dict(rtol=2e-4, atol=2e-5)
ARGV = ["--do_train", "1", "--datatype", "msrvtt", "--output_dir", "out/fp32",
        "--max_words", str(CTX), "--max_frames", str(T), "--precision",
        "fp32", "--pretrained_clip_name", ARCH, "--loose_type",
        "--sim_header", "meanP", "--lr", "1e-3", "--coef_lr", "0.5", "--wd",
        "0.2", "--warmup_proportion", "0.0", "--cluster_inter", "1",
        "--cluster_algo", "kmediods++", "--cluster_num_blocks", "196",
        str(K), "--target_frames_blocks", str(T), "1"]


def make_batch(seed):
    g = np.random.default_rng(seed)
    ids = g.integers(1, VOCAB - 2, size=(N_CLIPS, CTX)).astype(np.int32)
    ids[:, 0] = VOCAB - 2
    ids[np.arange(N_CLIPS), g.integers(3, CTX, N_CLIPS)] = VOCAB - 1
    return {"input_ids": ids,
            "attention_mask": np.ones((N_CLIPS, CTX), np.int32),
            "video": g.integers(0, 256, (N_CLIPS, 1, T, 3, RES, RES),
                                dtype=np.uint8),
            "video_mask": np.ones((N_CLIPS, T), np.int32)}


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


@contextlib.contextmanager
def replayed(ids):
    """Both packages' cluster layers take the medoid ids `ids` (assign,
    medoids) on [N_CLIPS, 392, 64] tokens, and count their calls."""
    calls = []

    def port_ids(X, k, **_):
        assert tuple(X.shape) == (N_CLIPS, N_TOKENS, 64) and k == K
        assert X.dtype == torch.float32
        calls.append("port")
        return t(ids[0]), t(ids[1])

    def jax_ids(X, k, **_):
        assert tuple(X.shape) == (N_CLIPS, N_TOKENS, 64) and k == K
        calls.append("jax")
        return jnp.asarray(ids[0]), jnp.asarray(ids[1])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cluster_layer, "kmedoids", port_ids)
        mp.setattr(jax_cluster, "batch_fast_kmedoids", jax_ids)
        yield calls


def port_model(params, cfg):
    model = CLIP4Clip(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, cfg), strict=True)
    return model


@pytest.fixture(scope="module")
def fp32_vitb16():
    """(JAX module, its parameters as numpy, the port's run config, the
    batch, the port's medoid ids on that batch)."""
    run, jrun = cli.parse_args(ARGV), jax_cli.parse_args(ARGV)
    assert dataclasses.asdict(run) == dataclasses.asdict(jrun)
    batch = make_batch(0)
    # init needs some ids; which ones does not matter to the parameters
    arange = (np.zeros((N_CLIPS, N_TOKENS), np.int32),
              np.tile(np.arange(K, dtype=np.int32), (N_CLIPS, 1)))
    jmodel = JaxCLIP4Clip(jrun.model)
    with replayed(arange):
        params = jmodel.init(jax.random.PRNGKey(0),
                             input_ids=batch["input_ids"],
                             video=batch["video"].astype(np.float32),
                             video_mask=batch["video_mask"],
                             training=True)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    chosen = []
    plain = cluster_layer.kmedoids

    def recording(X, k, **kw):
        out = plain(X, k, **kw)
        chosen.append(tuple(o.numpy().copy() for o in out))
        return out
    model = port_model(params, run.model)
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(cluster_layer, "kmedoids", recording)
        model(**loop.batch_to_device(batch, torch.device("cpu")),
              training=True)
    assert len(chosen) == 1 and chosen[0][1].shape == (N_CLIPS, K)
    return jmodel, params, run, batch, chosen[0]


def test_both_clis_give_the_fp32_config():
    """`--precision fp32` makes both packages' towers float32 (amp keeps
    bf16), with the same plan: 392 tokens a segment into 160 before
    block 2."""
    for argv, dtype in ((ARGV, "float32"),
                        ([a if a != "fp32" else "amp" for a in ARGV],
                         "bfloat16")):
        run, jrun = cli.parse_args(argv), jax_cli.parse_args(argv)
        assert dataclasses.asdict(run) == dataclasses.asdict(jrun)
        assert run.model.compute_dtype == dtype
    spec = cli.parse_args(ARGV).model.cluster_plan()[1]
    assert (spec.frame_duration * spec.before_cluster_num,
            spec.cluster_num) == (N_TOKENS, K)


def test_loss_and_every_gradient_match_jax_in_fp32(fp32_vitb16):
    jmodel, params, run, batch, ids = fp32_vitb16

    def loss_fn(p):
        out = jmodel.apply({"params": p}, input_ids=batch["input_ids"],
                           attention_mask=batch["attention_mask"],
                           video=batch["video"],
                           video_mask=batch["video_mask"], training=True,
                           rng=jax.random.PRNGKey(0))
        return out["loss"], out["sim_loss"]
    with replayed(ids) as calls:
        (jloss, jsim), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
    assert calls == ["jax"]
    model = port_model(params, run.model)
    with replayed(ids) as calls:
        out = model(**loop.batch_to_device(batch, torch.device("cpu")),
                    training=True)
        out["loss"].backward()
    assert calls == ["port"]
    assert out["loss"].dtype == torch.float32
    np.testing.assert_allclose(float(out["loss"].detach()), float(jloss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(out["sim_loss"].detach()), float(jsim),
                               rtol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    for path, key, tf in clip4clip_entries(run.model):
        ref = jgrads
        for part in path:
            ref = ref[part]
        ref = np.asarray(ref)
        assert grads[key] is not None, key
        np.testing.assert_allclose(grads[key].numpy(),
                                   ref.T if tf == "T" else ref,
                                   err_msg=key, **FP32)


def test_features_match_jax_in_fp32(fp32_vitb16):
    jmodel, params, run, batch, ids = fp32_vitb16
    model = port_model(params, run.model)

    def jax_apply(method, *args):
        return jmodel.apply({"params": params}, *args, method=method)
    with replayed(ids) as calls:
        vm = model.video_mask_after_cluster(t(batch["video_mask"]))
        ref_v, _ = jax_apply(JaxCLIP4Clip.get_visual_output,
                             jnp.asarray(batch["video"]),
                             jnp.asarray(vm.numpy()))
        ref_t = jax_apply(JaxCLIP4Clip.get_sequence_output,
                          jnp.asarray(batch["input_ids"]))
        with torch.no_grad():
            out_v = model.get_visual_output(t(batch["video"]), vm)
            out_t = model.get_sequence_output(t(batch["input_ids"]).long())
    assert calls == ["jax", "port"]
    assert tuple(out_v.shape) == (N_CLIPS, 1, 32)
    assert out_v.dtype == out_t.dtype == torch.float32
    np.testing.assert_allclose(out_v.numpy(), np.asarray(ref_v), **FP32)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(ref_t), **FP32)


def test_attention_inputs_take_the_fp32_variants(fp32_vitb16):
    """The qkv a training step hands to kernel A (at the model's call
    site) is fp32 at L = 197 (block 1), 161 (block 2, after the cluster
    layer) and 12 (text); on a CUDA tensor each takes TF32X3, the fp32
    tensor-core variant, both ways (the CUDA-core one, slower at every
    length the card was timed at, runs only past head_dim 128), at this
    narrow width and at ViT-B/16's."""
    _, params, run, batch, ids = fp32_vitb16
    model = port_model(params, run.model)
    seen = []
    real = layers.fused_attention

    def recording(qkv, heads, attn_mask=None):
        seen.append((qkv.dtype, qkv.shape[1], qkv.shape[-1] // 3 // heads))
        return real(qkv, heads, attn_mask)
    with replayed(ids), pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "fused_attention", recording)
        model(**loop.batch_to_device(batch, torch.device("cpu")),
              training=True)["loss"].backward()
    assert sorted(set(seen)) == sorted({(torch.float32, 197, 16),
                                        (torch.float32, 1 + K, 16),
                                        (torch.float32, CTX, 16)})
    for dtype, L, hd in set(seen):
        for width_hd in (hd, 64):          # narrow, and ViT-B/16's 64
            for backward in (False, True):
                variant = attention_cuda.choose_variant(dtype, width_hd, L,
                                                        backward)
                assert variant == attention_cuda.TF32X3
