# coding=utf-8
"""The port's cluster algorithms other than kmediods++ (pooling,
sparse_sampling, spectral, temporal_shift, token_shift, deep_cluster)
against the JAX package, on the CPU.

Layer tests run at 2 clips of 4 frames -> 2 segments, 9 patch tokens per
frame, width 16, K = 5.  Model tests use the tiny clustered model of
tests/test_torch_train.py (2 + 2 blocks, width 64, fp32), initialised by the
JAX package, whose parameters cross over through
`state_dict_from_jax_params`.  Tolerances: data movement (the shifts, the
uniform sparse_sampling pick) equal to the bit; pooling and the DeepCluster
head within 1e-6 (fp32 means of the same values); model losses and
gradients at tests/test_torch_train.py's fp32 rtol 2e-4 / atol 2e-5.
Where the JAX package draws with `jax.random` (sparse_sampling in training)
or picks medoids from near-degenerate eigenvectors (spectral), the port is
handed the JAX package's draw or the port's medoid ids are replayed into
the JAX package, so the two hold the same differentiable path.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from centerclip_tpu import config as jax_config
from centerclip_tpu.models.clip4clip import CLIP4Clip as JaxCLIP4Clip
from centerclip_tpu.ops import cluster_layer as jax_cluster
from centerclip_tpu.ops import deepcluster as jax_deep
from centerclip_tpu.ops import shift as jax_shift
from centerclip_tpu.train import loop as jax_loop
from centerclip_tpu.train import optim as jax_optim
from centerclip_tpu.train import state as jax_state
from centerclip_tpu_torch import config as port_config
from centerclip_tpu_torch.models.clip import check_supported
from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
from centerclip_tpu_torch.models.weights import (clip4clip_entries,
                                                 state_dict_from_jax_params)
from centerclip_tpu_torch.ops import cluster_layer, deepcluster, shift
from centerclip_tpu_torch.train import (Trainer, build_optimizer,
                                        make_train_step, resume,
                                        save_checkpoint)
from centerclip_tpu_torch.train import loop

ARCH = "tiny-port-algos"
T, RES, VOCAB, CTX = 4, 24, 100, 12
TINY = dict(embed_dim=32, image_resolution=RES, vision_layers=2,
            vision_width=64, vision_patch_size=8, vision_heads=4,
            context_length=CTX, vocab_size=VOCAB, transformer_width=64,
            transformer_heads=4, transformer_layers=2)
jax_config.CLIP_ARCHS[ARCH] = TINY
port_config.CLIP_ARCHS[ARCH] = TINY

FP32 = dict(rtol=2e-4, atol=2e-5)
MEAN_TOL = dict(rtol=1e-6, atol=1e-6)
# the DeepCluster head's parameter gradients: three fp32 LayerNorms deep,
# where flax takes the variance as E[x^2] - E[x]^2 (cancellation) and torch
# as E[(x - E[x])^2]; gradients of ~1e2 differ by up to ~3e-4 relative
HEAD_GRAD = dict(rtol=1e-3, atol=1e-4)
LR = 1e-3
STEP_ATOL = 2e-2 * LR             # tests/test_torch_train.py's budget
B, S, P, W, K = 2, 2, 9, 16, 5
ALGOS = ("pooling", "sparse_sampling", "spectral", "temporal_shift",
         "token_shift", "deep_cluster")


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def tokens(seed, n=B * T, p=P, w=W):
    g = np.random.default_rng(seed)
    centres = g.standard_normal((4, w)).astype(np.float32) * 3.0
    x = centres[g.integers(0, 4, (n, 1 + p))] \
        + 0.3 * g.standard_normal((n, 1 + p, w))
    return x.astype(np.float32)


def specs(algo, **over):
    kw = dict(block_id=2, algo=algo, before_cluster_num=P, cluster_num=K,
              before_frames=T, after_frames=S, frame_duration=T // S,
              spectral_knn_k=10)
    kw.update(over)
    return jax_config.BlockClusterSpec(**kw), \
        port_config.BlockClusterSpec(**kw)


# ------------------------------------------------------------------ shifts
@pytest.mark.parametrize("fn", ["temporal_shift_wo_cls", "token_shift"])
@pytest.mark.parametrize("fold_div", [8, 3])
def test_shifts_equal_jax_to_the_bit(fn, fold_div):
    x = tokens(fold_div, n=3 * T, w=24)
    ref = np.asarray(getattr(jax_shift, fn)(jnp.asarray(x), T, fold_div))
    out = getattr(shift, fn)(t(x), T, fold_div)
    np.testing.assert_array_equal(out.numpy(), ref)


# --------------------------------------------------------------- the layer
@pytest.mark.parametrize("algo,tol", [
    ("pooling", MEAN_TOL), ("sparse_sampling", MEAN_TOL),
    ("temporal_shift", None), ("token_shift", None)])
def test_baseline_layers_match_jax(algo, tol):
    """Eval forward (the uniform sparse_sampling pick); the shifts and the
    gather to the bit, the means within 1e-6."""
    jspec, spec = specs(algo)
    x = tokens(len(algo))
    jmod = jax_cluster.TokenClusterInter(spec=jspec,
                                         cfg=jax_config.ClusterConfig(
                                             inter=True, algo=algo), width=W)
    ref = np.asarray(jmod.apply({}, jnp.asarray(x)))
    mod = cluster_layer.TokenClusterInter(
        spec, port_config.ClusterConfig(inter=True, algo=algo), W)
    assert not list(mod.parameters())
    out = mod(t(x)).numpy()
    assert out.shape == ref.shape
    if algo == "sparse_sampling":                 # the gathered tokens
        np.testing.assert_array_equal(out[:, 1:], ref[:, 1:])
    if tol is None:
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, **tol)


@pytest.mark.parametrize("target,total", [(5, 18), (49, 98), (49, 196),
                                          (7, 7), (6, 4)])
def test_uniform_token_indices_equal_jax(target, total):
    np.testing.assert_array_equal(
        cluster_layer.uniform_token_indices(target, total),
        np.minimum(jax_cluster._uniform_token_indices(target, total),
                   total - 1))


@pytest.mark.parametrize("target,total", [(5, 18), (49, 196), (4, 4)])
def test_random_token_indices_invariants(target, total):
    """One column from each run of total // target tokens, in range, the
    same draw from the same (seed, step), another from another step."""
    segs = 3
    draw = [cluster_layer.random_token_indices(
        loop.step_generator(7, step, "cpu"), segs, target, total)
        for step in (1, 1, 2)]
    assert torch.equal(draw[0], draw[1])
    avg = total // target
    runs = torch.arange(target) * avg
    for d in draw:
        assert d.shape == (segs, target) and d.dtype == torch.int64
        assert bool((d >= runs).all()) and bool((d < runs + avg).all())
        assert int(d.max()) < total
    if avg > 1:
        assert not torch.equal(draw[0], draw[2])


def test_random_sparse_sampling_gathers_the_drawn_columns():
    """With a generator the layer gathers the drawn columns, the same ones
    for every clip of a segment (the JAX package's `take_along_axis` with
    one [S, K] draw)."""
    _, spec = specs("sparse_sampling")
    x = tokens(3)
    mod = cluster_layer.TokenClusterInter(
        spec, port_config.ClusterConfig(inter=True, algo="sparse_sampling"),
        W)
    cols = cluster_layer.random_token_indices(
        loop.step_generator(0, 1, "cpu"), S, K, 2 * P)
    out = mod(t(x), loop.step_generator(0, 1, "cpu"))
    res = t(x)[:, 1:].reshape(B, S, 2 * P, W)
    for b in range(B):
        for s in range(S):
            np.testing.assert_array_equal(out[b * S + s, 1:].numpy(),
                                          res[b, s, cols[s]].numpy())


def test_spectral_layer_matches_jax_with_the_same_medoids():
    """The spectral layer's embedding extras (cluster_embed,
    cluster_frame_embed, cls_multiplier, the spg buffer) and its
    gather/CLS path, with JAX's medoid ids handed to the port."""
    opts = dict(inter=True, algo="spectral", spectral_graph="KNN",
                cluster_embedding=True, cluster_frame_embedding=True,
                adaptive_cls=True, spectral_spg=True)
    jspec, spec = specs("spectral", spg_s_kernel=9, spg_t_kernel=7)
    x = tokens(11)
    jmod = jax_cluster.TokenClusterInter(
        spec=jspec, cfg=jax_config.ClusterConfig(**opts), width=W)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    jids = {}

    def jax_cluster_ids(module, res_tmp):
        return jax.tree_util.tree_map(np.asarray, module._cluster(res_tmp))
    jids["v"] = jmod.apply({"params": params}, jnp.asarray(
        jax_cluster.segment_major(jnp.asarray(x[:, 1:].reshape(B, T, P, W)),
                                  S, T // S)), method=jax_cluster_ids)
    mod = cluster_layer.TokenClusterInter(
        spec, port_config.ClusterConfig(**opts), W)
    assert sorted(n for n, _ in mod.named_parameters()) == sorted(params)
    assert "spg" not in mod.state_dict()
    np.testing.assert_array_equal(mod.spg.numpy(), np.asarray(jmod.apply(
        {"params": params}, method=lambda m: m.spg)))
    mod.load_state_dict({k: t(v) for k, v in params.items()}, strict=True)
    mod._cluster = lambda res_tmp: tuple(t(a) for a in jids["v"])
    np.testing.assert_allclose(mod(t(x)).detach().numpy(), ref, **MEAN_TOL)


# ------------------------------------------------------------ deep cluster
@pytest.fixture(scope="module")
def deep_head():
    jspec, spec = specs("deepcluster")
    cfg = jax_config.ClusterConfig(deep_cluster=True)
    x = tokens(21)
    jmod = jax_deep.DeepCluster(spec=jspec, cfg=cfg, width=W)
    params = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x), train=True)
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    # non-trivial LayerNorm parameters
    g = np.random.default_rng(3)
    for ln in ("ln1", "ln2", "ln3"):
        for k in ("scale", "bias"):
            params[ln][k] = (params[ln][k]
                             + 0.1 * g.standard_normal(params[ln][k].shape)
                             ).astype(np.float32)
    mod = deepcluster.DeepCluster(spec, port_config.ClusterConfig(
        deep_cluster=True), P)
    sd = {}
    for n in ("1", "2", "3"):
        sd[f"fc{n}.weight"] = t(params[f"fc{n}"]["kernel"].T)
        sd[f"fc{n}.bias"] = t(params[f"fc{n}"]["bias"])
        sd[f"ln{n}.weight"] = t(params[f"ln{n}"]["scale"])
        sd[f"ln{n}.bias"] = t(params[f"ln{n}"]["bias"])
    mod.load_state_dict(sd, strict=True)
    return jmod, params, mod, x


@pytest.mark.parametrize("train", [False, True])
def test_deep_cluster_head_forward_and_loss_match_jax(deep_head, train):
    jmod, params, mod, x = deep_head
    ref, rloss = jmod.apply({"params": params}, jnp.asarray(x), train=train)
    out, loss = mod(t(x), training=train)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               **MEAN_TOL)
    np.testing.assert_allclose(float(loss.detach()), float(rloss), rtol=1e-5)
    assert (float(loss.detach()) > 0) == train


def test_deep_cluster_head_gradients_match_jax(deep_head):
    jmod, params, mod, x = deep_head
    w = np.random.default_rng(4).standard_normal(
        (B * S, 1 + K, W)).astype(np.float32)

    def jloss(p, xx):
        out, wcss = jmod.apply({"params": p}, xx, train=True)
        return jnp.sum(out * w) + wcss
    gp, gx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    mod.zero_grad()
    xs = t(x).requires_grad_(True)
    out, wcss = mod(xs, training=True)
    ((out * t(w)).sum() + wcss).backward()
    np.testing.assert_allclose(xs.grad.numpy(), np.asarray(gx), **FP32)
    for n in ("1", "2", "3"):
        for layer, name, ref in ((f"fc{n}", "weight",
                                  np.asarray(gp[f"fc{n}"]["kernel"]).T),
                                 (f"ln{n}", "weight",
                                  np.asarray(gp[f"ln{n}"]["scale"]))):
            grad = mod.get_parameter(f"{layer}.{name}").grad.numpy()
            np.testing.assert_allclose(grad, ref, err_msg=layer,
                                       **HEAD_GRAD)


def test_deep_cluster_helpers_match_jax():
    g = np.random.default_rng(5)
    x = g.standard_normal((3, 40, 8)).astype(np.float32)
    c = g.standard_normal((3, 6, 8)).astype(np.float32)
    jl, ja = jax_deep.batch_within_cluster_sse(jnp.asarray(x), jnp.asarray(c))
    pl, pa = deepcluster.batch_within_cluster_sse(t(x), t(c))
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(
        deepcluster.get_medoids(t(x), t(c)).numpy(),
        np.asarray(jax_deep.get_medoids(jnp.asarray(x), jnp.asarray(c))))


@pytest.mark.parametrize("tfb", [(12,) * 6 + (6,) * 6, (12,) * 3 + (4,) * 9])
def test_deep_cluster_plan_matches_jax(tfb):
    kw = dict(deep_cluster=True, cluster_num_blocks=(49,) * 12,
              target_frames_blocks=tfb)
    a = port_config.make_run_config(**kw).model
    b = jax_config.make_run_config(**kw).model
    assert [dataclasses.asdict(s) if s else None
            for s in deepcluster.deep_cluster_plan(a)] == \
        [dataclasses.asdict(s) if s else None
         for s in jax_deep.deep_cluster_plan(b)]


# ------------------------------------------------------------ tiny models
def config_kw(algo, **over):
    kw = dict(clip_name=ARCH, max_frames=T, max_words=CTX,
              compute_dtype="float32", cluster_num_blocks=(P, K),
              target_frames_blocks=(T, T // 2), lr=LR, coef_lr=0.5,
              weight_decay=0.2, warmup_proportion=0.0, optim="AdamW")
    if algo == "deep_cluster":
        kw["deep_cluster"] = True
    else:
        kw.update(inter=True, algo=algo)
    if algo == "spectral":
        kw.update(spectral_graph="KNN", cluster_embedding=True,
                  cluster_frame_embedding=True, adaptive_cls=True)
    kw.update(over)
    return kw


def run_configs(algo, **over):
    jrun = jax_config.make_run_config(**config_kw(algo, **over))
    run = port_config.make_run_config(**config_kw(algo, **over))
    assert dataclasses.asdict(run) == dataclasses.asdict(jrun)
    return jrun, run


def make_batch(seed, n=3):
    g = np.random.default_rng(seed)
    ids = g.integers(1, VOCAB - 2, size=(n, CTX)).astype(np.int32)
    ids[:, 0] = VOCAB - 2
    ids[np.arange(n), g.integers(3, CTX, n)] = VOCAB - 1     # EOT
    vmask = np.ones((n, T), np.int32)
    vmask[-1, -1] = 0
    return {"input_ids": ids, "attention_mask": np.ones((n, CTX), np.int32),
            "video": g.integers(0, 256, (n, 1, T, 3, RES, RES),
                                dtype=np.uint8),
            "video_mask": vmask}


_JAX_INITS = {}


def jax_init(algo):
    """The JAX model and its parameters (numpy), one init per algorithm."""
    if algo not in _JAX_INITS:
        jrun, _ = run_configs(algo)
        jmodel = JaxCLIP4Clip(jrun.model)
        b = make_batch(0)
        params = jmodel.init(
            jax.random.PRNGKey(0), input_ids=b["input_ids"],
            video=b["video"].astype(np.float32), video_mask=b["video_mask"],
            training=True, rng=jax.random.PRNGKey(9))["params"]
        _JAX_INITS[algo] = (jmodel, jax.tree_util.tree_map(np.asarray,
                                                          params))
    return _JAX_INITS[algo]


def port_model(params, cfg):
    model = CLIP4Clip(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, cfg),
                          strict=True)
    return model


def jax_leaf(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


def hand_over_draws(monkeypatch, rng):
    """sparse_sampling's random columns in training: the port takes the
    columns the JAX package draws from `rng` (jax.random.split(rng, S)
    then `_random_token_indices` per segment)."""
    def jax_draw(generator, segments, target, total):
        rngs = jax.random.split(rng, segments)
        return torch.from_numpy(np.stack([np.asarray(
            jax_cluster._random_token_indices(r, target, total))
            for r in rngs]).astype(np.int64))
    monkeypatch.setattr(cluster_layer, "random_token_indices", jax_draw)


def replay_port_medoids(monkeypatch, model):
    """The port's medoid ids, recorded per cluster module, replayed into
    the JAX package's `_cluster` (constants under its tracing)."""
    chosen = []
    for block in model.clip.visual.transformer.resblocks:
        mod = block.tokencluster_inter
        if mod is None:
            continue

        def record(res_tmp, own=mod._cluster):
            out = own(res_tmp)
            chosen.append(tuple(a.numpy() for a in out))
            return out
        mod._cluster = record
    monkeypatch.setattr(jax_cluster.TokenClusterInter, "_cluster",
                        lambda self, res_tmp: tuple(
                            jnp.asarray(a) for a in chosen.pop(0)))


@pytest.mark.parametrize("algo", ALGOS)
def test_train_step_loss_and_every_gradient_match_jax(algo, monkeypatch):
    jmodel, params = jax_init(algo)
    _, run = run_configs(algo)
    batch = make_batch(1)
    rng = jax.random.PRNGKey(5)
    model = port_model(params, run.model)
    if algo == "sparse_sampling":
        hand_over_draws(monkeypatch, rng)
    if algo == "spectral":
        replay_port_medoids(monkeypatch, model)
    out = model(**loop.batch_to_device(batch, torch.device("cpu")),
                training=True, generator=torch.Generator().manual_seed(0))
    out["loss"].backward()

    def loss_fn(p):
        o = jmodel.apply({"params": p}, input_ids=batch["input_ids"],
                         attention_mask=batch["attention_mask"],
                         video=batch["video"], video_mask=batch["video_mask"],
                         training=True, rng=rng)
        return o["loss"], (o["sim_loss"], o["cluster_loss"])
    (jloss, (jsim, jcl)), jgrads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    for key, ref in (("loss", jloss), ("sim_loss", jsim),
                     ("cluster_loss", jcl)):
        np.testing.assert_allclose(float(out[key].detach()), float(ref),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    assert (float(out["cluster_loss"].detach()) > 0) == \
        (algo == "deep_cluster")
    named = dict(model.named_parameters())
    entries = clip4clip_entries(run.model)
    assert len(entries) == len(named)
    for path, key, tf in entries:
        ref = jax_leaf(jgrads, path)
        grad = named[key].grad
        if key.endswith("cluster_frame_embed"):
            # created and never read, in both packages
            assert grad is None and not ref.any(), key
            continue
        assert grad is not None, key
        np.testing.assert_allclose(grad.numpy(), ref.T if tf == "T" else ref,
                                   err_msg=key, **(HEAD_GRAD if "deepcluster"
                                                   in key else FP32))


def test_deep_cluster_optimizer_step_matches_jax():
    """The heads' group (new-added: lr not scaled by coef_lr) and their
    trainable mask at freeze_layer_num 0, through one AdamW step."""
    jmodel, params = jax_init("deep_cluster")
    jrun, run = run_configs("deep_cluster")
    batch = make_batch(2)
    tx = jax_optim.build_optimizer(jrun.optim, params, total_steps=4,
                                   freeze_layer_num=jrun.freeze_layer_num)
    state = jax_state.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, params), tx)
    state, log = jax_loop.make_train_step(jmodel, tx)(
        state, batch, jax.random.PRNGKey(0))
    model = port_model(params, run.model)
    opt = build_optimizer(run.optim, model, total_steps=4,
                          freeze_layer_num=run.freeze_layer_num)
    logs = make_train_step(model, opt)(batch)
    np.testing.assert_allclose(float(logs["loss"]), float(log["loss"]),
                               rtol=1e-5)
    sd = model.state_dict()
    heads = 0
    for path, key, tf in clip4clip_entries(run.model):
        ref = jax_leaf(state.params, path)
        np.testing.assert_allclose(sd[key].numpy(), ref.T if tf == "T"
                                   else ref, rtol=0, atol=STEP_ATOL,
                                   err_msg=key)
        heads += "deepcluster" in key
    assert heads == 12
    assert all(p.requires_grad for n, p in model.named_parameters()
               if "deepcluster" in n)


def test_resumed_sparse_sampling_run_equals_the_uninterrupted_one(tmp_path):
    """Each step draws from the generator of (seed, global step), so a run
    resumed after step 1 draws at step 2 what the uninterrupted run drew."""
    _, params = jax_init("sparse_sampling")
    _, run = run_configs("sparse_sampling")
    batches = [make_batch(3), make_batch(4)]
    whole = Trainer(run, port_model(params, run.model), total_steps=4)
    whole.train_epoch(0, batches, n_display=1)
    first = Trainer(run, port_model(params, run.model), total_steps=4)
    first.train_epoch(0, batches[:1], n_display=1)
    path = save_checkpoint(str(tmp_path), first.state, epoch=0, best_r1=0.0)
    second = Trainer(run, port_model(params, run.model), total_steps=4)
    resume(path, second.state)
    assert second.state.global_step == 1
    second.train_epoch(1, batches[1:], n_display=1)
    other = second.model.state_dict()
    for k, v in whole.model.state_dict().items():
        assert torch.equal(v, other[k]), k
    # the draw is what moves the result: another seed trains otherwise
    third = Trainer(dataclasses.replace(run, seed=run.seed + 1),
                    port_model(params, run.model), total_steps=4)
    third.train_epoch(0, batches, n_display=1)
    assert any(not torch.equal(v, third.model.state_dict()[k])
               for k, v in whole.model.state_dict().items())


@pytest.mark.parametrize("algo", ["spectral", "deep_cluster"])
def test_state_dict_from_jax_params_roundtrips_the_new_parameters(algo):
    _, params = jax_init(algo)
    _, run = run_configs(algo)
    model = port_model(params, run.model)
    sd = model.state_dict()
    new = [key for _, key, _ in clip4clip_entries(run.model)
           if "tokencluster_inter" in key or "deepcluster" in key]
    assert len(new) == (3 if algo == "spectral" else 12)
    for path, key, tf in clip4clip_entries(run.model):
        ref = jax_leaf(params, path)
        np.testing.assert_array_equal(sd[key].numpy(),
                                      ref.T if tf == "T" else ref)


# ------------------------------------------------- the two repairs
@pytest.mark.parametrize("algo", ["pooling", "sparse_sampling", "spectral",
                                  "deep_cluster", "temporal_shift"])
def test_video_mask_after_cluster_matches_jax(algo):
    """[B, S] for every algorithm that merges frames (JAX
    models/clip4clip.py:106-113); the shifts keep [B, T]."""
    jmodel, params = jax_init(algo)
    _, run = run_configs(algo)
    mask = np.array([[1, 1, 1, 0], [1, 1, 0, 0], [1, 0, 0, 0]], np.int32)
    ref = np.asarray(jmodel.apply(
        {"params": params}, jnp.asarray(mask),
        method=JaxCLIP4Clip.video_mask_after_cluster))
    out = port_model(params, run.model).video_mask_after_cluster(t(mask))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert out.shape == ((3, T) if algo == "temporal_shift" else (3, S))


def test_eval_forward_with_pre_visual_pooling_matches_jax():
    """An activity config's eval forward returns the pooled, normalised
    [B, D] video vector, as the JAX package's `__call__` does."""
    jmodel, params = jax_init("kmediods++")
    jrun, run = run_configs("kmediods++", datatype="activity")
    assert run.model.pre_visual_pooling
    b = make_batch(6)
    ref = jmodel.clone(cfg=jrun.model).apply(
        {"params": params}, video=b["video"], video_mask=b["video_mask"])
    model = port_model(params, run.model)
    out = model(video=t(b["video"]), video_mask=t(b["video_mask"]))
    assert tuple(out["visual_output"].shape) == (3, 32)
    np.testing.assert_allclose(out["visual_output"].detach().numpy(),
                               np.asarray(ref["visual_output"]), **FP32)


# ------------------------------------------- the measurement scripts' knob
@pytest.mark.parametrize("algo", ["pooling", "spectral"])
def test_scale_vision_stream_scales_the_stream_not_the_embedding(algo):
    """`profile_train.scale_vision_stream` (how `chip_smoke.py` puts random
    weights' tokens within spectral clustering's sigma): the tokens the
    cluster layer takes scale by alpha, and with the same medoids (replayed)
    the eval video embedding is what it was, both within 1e-3 in norm (fp32
    tower): LayerNorm's eps, 1e-5 against a variance alpha^2 = 1/16 times
    smaller, moves each normalised value by ~1.6e-4 relative."""
    from centerclip_tpu_torch.profile_train import scale_vision_stream
    cfg = port_config.make_run_config(**config_kw(algo)).model
    b = make_batch(7)
    outs, taken, chosen = [], [], []
    for alpha in (1.0, 0.25):
        model = CLIP4Clip(cfg, device="cpu", seed=3).eval()
        scale_vision_stream(model, alpha)
        mod = model.clip.visual.transformer.resblocks[1].tokencluster_inter
        mod.register_forward_pre_hook(
            lambda _, args: taken.append(args[0].detach().clone()))
        if algo == "spectral":
            def record(res_tmp, own=mod._cluster):
                if not chosen:
                    chosen.append(own(res_tmp))
                return chosen[0]
            mod._cluster = record
        with torch.no_grad():
            outs.append(model(video=t(b["video"]),
                              video_mask=t(b["video_mask"]))["visual_output"])
    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))
    assert rel(taken[1], 0.25 * taken[0]) < 1e-3
    assert rel(outs[1], outs[0]) < 1e-3


# ------------------------------------------------- what builds, what raises
@pytest.mark.parametrize("algo", ALGOS)
def test_every_cluster_algo_builds(algo):
    _, run = run_configs(algo)
    check_supported(run.model)
    model = CLIP4Clip(run.model, device="cpu")
    out = model(**loop.batch_to_device(make_batch(7), torch.device("cpu")))
    assert out["visual_output"].shape[:2] == (
        3, T if algo.endswith("shift") else S)
    assert bool(torch.isfinite(out["visual_output"]).all())


BLOCK_FLAGS = ["--cluster_num_blocks", *["49"] * 12,
               "--target_frames_blocks", *["12"] * 6, *["6"] * 6,
               "--loose_type", "--sim_header", "meanP", "--output_dir", "out"]


@pytest.mark.parametrize("flags", [
    ["--cluster_inter", "1", "--cluster_algo", "spectral",
     "--spectral_graph", "KNN", "--spectral_spg", "1",
     "--spectral_solver", "subspace", "--spectral_sigma", "3.0"],
    ["--cluster_inter", "1", "--cluster_algo", "sparse_sampling"]])
def test_cli_cluster_flags_reach_the_model(flags):
    from centerclip_tpu import cli as jax_cli
    from centerclip_tpu_torch import cli
    cfg = cli.parse_args(flags + BLOCK_FLAGS)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_cli.parse_args(flags + BLOCK_FLAGS))
    spec = cfg.model.cluster_plan()[6]
    assert spec.algo == flags[3] and cfg.model.cluster_plan()[5] is None
    check_supported(cfg.model)


def test_cli_deep_cluster_keeps_the_block_plans():
    """`--deep_cluster 1 --cluster_inter 0` keeps the block flags, so the
    heads' plan exists (the JAX package's CLI drops them without
    --cluster_inter, and its deep_cluster_plan then fails)."""
    from centerclip_tpu import cli as jax_cli
    from centerclip_tpu_torch import cli
    flags = ["--cluster_inter", "0", "--deep_cluster", "1"] + BLOCK_FLAGS
    cfg = cli.parse_args(flags)
    assert cfg.model.cluster.cluster_num_blocks == (49,) * 12
    plan = deepcluster.deep_cluster_plan(cfg.model)
    assert [i for i, s in enumerate(plan) if s is not None] == [6]
    assert plan[6].frame_duration == 2 and cfg.model.final_frames == 6
    jcfg = jax_cli.parse_args(flags)
    assert jcfg.model.cluster.cluster_num_blocks == ()
    assert dataclasses.replace(cfg.model.cluster, cluster_num_blocks=(),
                               target_frames_blocks=()) == \
        port_config.ClusterConfig(**dataclasses.asdict(jcfg.model.cluster))
