# coding=utf-8
"""The ViT-B/16 path of the port against the JAX package, on the CPU.

A narrow model at ViT-B/16's token geometry: 224 x 224 frames at patch 16
(L = 197), 4 vision blocks of width 64 with k-medoids before block 3
(4 frames -> 2 segments of 2 x 196 = 392 tokens, K = 160, then L = 161),
2 text blocks, 2 clips, fp32.  The JAX package initialises it; the
parameters cross over through `state_dict_from_jax_params`.  Inputs come
from numpy with a seed.

The two packages compute the k-medoids distances by matmuls that agree only
to rounding, and at K = 160 of N = 392 rounding decides medoids, so the
model tests replay one set of medoid ids (the port's plain k-medoids on the
port's tokens) in both packages.  The k-medoids tests hold the algorithm on
the distances JAX computes.  Values and gradients are held at fp32 rtol
2e-4 / atol 2e-5 (tests/test_torch_train.py).
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from centerclip_tpu import config as jax_config
from centerclip_tpu.models.clip4clip import CLIP4Clip as JaxCLIP4Clip
from centerclip_tpu.ops import cluster_layer as jax_cluster
from centerclip_tpu.ops.attention_pallas import _mha_bwd_call
from centerclip_tpu.ops.distances import pairwise_distance as jax_pairwise
from centerclip_tpu.ops.kmedoids import batch_fast_kmedoids as jax_kmedoids
from centerclip_tpu_torch import config as port_config
from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
from centerclip_tpu_torch.models.weights import (clip4clip_entries,
                                                 state_dict_from_jax_params)
from centerclip_tpu_torch.ops import attention_cuda, cluster_layer
from centerclip_tpu_torch.ops.kmedoids import kmedoids_on_distances
from centerclip_tpu_torch.train import loop

ARCH = "narrow-vitb16"
T, RES, VOCAB, CTX, N_CLIPS = 4, 224, 100, 12, 2
NARROW = dict(embed_dim=32, image_resolution=RES, vision_layers=4,
              vision_width=64, vision_patch_size=16, vision_heads=4,
              context_length=CTX, vocab_size=VOCAB, transformer_width=64,
              transformer_heads=4, transformer_layers=2)
jax_config.CLIP_ARCHS[ARCH] = NARROW
port_config.CLIP_ARCHS[ARCH] = NARROW
N_TOKENS, K = 2 * 196, 160            # tokens per segment, medoids

FP32 = dict(rtol=2e-4, atol=2e-5)


def config_kw(**over):
    kw = dict(clip_name=ARCH, max_frames=T, max_words=CTX,
              compute_dtype="float32", inter=True, algo="kmediods++",
              cluster_num_blocks=(196, 196, K, K),
              target_frames_blocks=(T, T, T // 2, T // 2),
              cluster_embedding=True, adaptive_cls=True, lr=1e-3,
              coef_lr=0.5, weight_decay=0.2, warmup_proportion=0.0)
    kw.update(over)
    return kw


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
    medoids), and count their calls."""
    calls = []

    def port_ids(X, k, **_):
        assert tuple(X.shape) == (N_CLIPS * T // 2, N_TOKENS, 64) and k == K
        calls.append("port")
        return t(ids[0]), t(ids[1])

    def jax_ids(X, k, **_):
        assert tuple(X.shape) == (N_CLIPS * T // 2, N_TOKENS, 64) and k == K
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
def vitb16():
    """(JAX module, its parameters as numpy, run configs, the batch, the
    port's medoid ids on that batch)."""
    jrun = jax_config.make_run_config(**config_kw())
    run = port_config.make_run_config(**config_kw())
    assert dataclasses.asdict(run) == dataclasses.asdict(jrun)
    batch = make_batch(0)
    # init needs some ids; which ones does not matter to the parameters
    arange = (np.zeros((N_CLIPS * T // 2, N_TOKENS), np.int32),
              np.tile(np.arange(K, dtype=np.int32), (N_CLIPS * T // 2, 1)))
    jmodel = JaxCLIP4Clip(jrun.model)
    with replayed(arange):
        params = jmodel.init(jax.random.PRNGKey(0),
                             input_ids=batch["input_ids"],
                             video=batch["video"].astype(np.float32),
                             video_mask=batch["video_mask"],
                             training=True)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    # the port's own plain k-medoids on the port's tokens
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
    assert len(chosen) == 1
    assert chosen[0][1].shape == (N_CLIPS * T // 2, K)
    return jmodel, params, jrun, run, batch, chosen[0]


def jax_leaf(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


def port_loss_and_grads(params, run, batch, ids, remat=False):
    cfg = dataclasses.replace(run.model, remat=remat)
    model = port_model(params, cfg)
    with replayed(ids) as calls:
        out = model(**loop.batch_to_device(batch, torch.device("cpu")),
                    training=True)
        out["loss"].backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return out, grads, calls


# ------------------------------------------------------------- the model
def test_loss_and_every_gradient_match_jax_at_vitb16_shapes(vitb16):
    jmodel, params, _, run, batch, ids = vitb16

    def loss_fn(p):          # the loss of the JAX package's make_train_step
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
    out, grads, calls = port_loss_and_grads(params, run, batch, ids)
    assert calls == ["port"]
    np.testing.assert_allclose(float(out["loss"].detach()), float(jloss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(out["sim_loss"].detach()), float(jsim),
                               rtol=1e-5)
    for path, key, tf in clip4clip_entries(run.model):
        ref = jax_leaf(jgrads, path)
        assert grads[key] is not None, key
        np.testing.assert_allclose(grads[key].numpy(),
                                   ref.T if tf == "T" else ref,
                                   err_msg=key, **FP32)


def test_features_match_jax_encoders_at_vitb16_shapes(vitb16):
    jmodel, params, _, run, batch, ids = vitb16
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
    assert tuple(out_v.shape) == (N_CLIPS, T // 2, 32)
    np.testing.assert_allclose(out_v.numpy(), np.asarray(ref_v), **FP32)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(ref_t), **FP32)


def test_vision_tower_geometry_at_patch_16(vitb16):
    """The 2-D patchify at P = 16 gives 196 patch tokens + CLS against the
    [197, width] positional embedding; clustering leaves 1 + K tokens."""
    _, params, _, run, batch, ids = vitb16
    model = port_model(params, run.model)
    visual = model.clip.visual
    assert tuple(visual.positional_embedding.shape) == (197, 64)
    lengths = []
    hooks = [b.register_forward_pre_hook(
        lambda m, a: lengths.append(a[0].shape[1]))
        for b in visual.transformer.resblocks]
    with replayed(ids), torch.no_grad():
        model.get_visual_output(t(batch["video"]), model.video_mask_after_cluster(
            t(batch["video_mask"])))
    for h in hooks:
        h.remove()
    assert lengths == [197, 197, 1 + K, 1 + K]


def test_remat_gives_the_same_loss_and_gradients(vitb16):
    """`remat` recomputes each residual block in the backward; on the CPU
    the recomputation repeats the same operations on the same inputs, so the
    loss and every gradient are equal to the bit (tolerance: none), and the
    cluster layer, outside the recomputed blocks, runs once per forward."""
    _, params, _, run, batch, ids = vitb16
    out0, g0, calls0 = port_loss_and_grads(params, run, batch, ids)
    out1, g1, calls1 = port_loss_and_grads(params, run, batch, ids,
                                           remat=True)
    assert calls0 == calls1 == ["port"]
    assert torch.equal(out0["loss"], out1["loss"])
    assert sorted(g0) == sorted(g1)
    for name, g in g0.items():
        assert (g is None) == (g1[name] is None), name
        if g is not None:
            assert torch.equal(g, g1[name]), name


def test_remat_keeps_fewer_activations(vitb16):
    """What autograd saves for the backward, in bytes, falls with `remat`
    (each block keeps only its input)."""
    _, params, _, run, batch, ids = vitb16

    def saved_bytes(remat):
        model = port_model(params, dataclasses.replace(run.model,
                                                       remat=remat))
        total = [0]

        def pack(x):
            total[0] += x.numel() * x.element_size()
            return x
        with replayed(ids), torch.autograd.graph.saved_tensors_hooks(
                pack, lambda x: x):
            model(**loop.batch_to_device(batch, torch.device("cpu")),
                  training=True)
        return total[0]
    assert saved_bytes(True) < 0.5 * saved_bytes(False)


# -------------------------------------------------------- kernels' plain
@pytest.mark.parametrize("L", [161, 197])
def test_attention_bwd_plain_matches_pallas_bwd_past_128(L):
    """The plain version that kernel B's key-tiled variant is held to, at
    ViT-B/16's lengths, against the Pallas backward in interpret mode."""
    B, H, hd = 2, 2, 16
    D = H * hd
    g = np.random.default_rng(L)
    qkv = g.standard_normal((B, L, 3 * D)).astype(np.float32)
    do = g.standard_normal((B, L, D)).astype(np.float32)
    q, k, v = (jnp.asarray(a) for a in np.split(qkv, 3, axis=-1))
    dq, dk, dv, _ = _mha_bwd_call(q, k, v, None, jnp.asarray(do), H, 1, True)
    dqkv, _ = attention_cuda.attention_bwd_plain(t(qkv), t(do), H)
    ref = np.concatenate([np.asarray(a) for a in (dq, dk, dv)], axis=-1)
    np.testing.assert_allclose(dqkv.numpy(), ref, **FP32)


def test_kmedoids_plain_matches_jax_at_n392_k160():
    """The plain k-medoids at ViT-B/16's N = 392, K = 160 against the JAX
    package's `batch_fast_kmedoids` on the distances JAX computes (the ids
    are held equal on identical distances, as at N = 98)."""
    g = np.random.default_rng(392)
    centres = g.standard_normal((2, 60, 32)).astype(np.float32) * 5.0
    x = (np.take_along_axis(centres, g.integers(0, 60, (2, N_TOKENS))[..., None],
                            1)
         + g.standard_normal((2, N_TOKENS, 32)) * 0.5).astype(np.float32)
    a_ref, m_ref = jax_kmedoids(jnp.asarray(x), K, iter_limit=100)

    @jax.jit
    def prep(X):
        D = jax_pairwise(X, X, all_negative=True, self_nearest=True)
        return X, D, jnp.linalg.norm(X, axis=-1)
    Xj, Dj, lj = prep(jnp.asarray(x))
    a, m = kmedoids_on_distances(t(Xj), t(Dj), t(lj), K, iter_limit=100)
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_ref))
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    assert len(np.unique(m.numpy()[0])) == K
