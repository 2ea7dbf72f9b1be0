# coding=utf-8
"""The port's training path against the JAX package, on the CPU.

The tiny clustered model of tests/test_torch_models.py (2 + 2 blocks, width
64, 4 frames -> 2 segments, 9 patch tokens per frame, K = 5, fp32) is
initialised by the JAX package; its parameters cross over through
`state_dict_from_jax_params`.  Inputs come from numpy with a seed.  The
Pallas backward kernels run in interpret mode.  Forward values and
gradients are held at fp32 rtol 2e-4 / atol 2e-5 (tests/test_model_parity.py).
"""
import dataclasses
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from centerclip_tpu import config as jax_config
from centerclip_tpu.models import losses as jax_losses
from centerclip_tpu.models.clip4clip import CLIP4Clip as JaxCLIP4Clip
from centerclip_tpu.ops import cluster_layer as jax_cluster
from centerclip_tpu.ops.attention_pallas import _mha_bwd_call
from centerclip_tpu.ops.layernorm_pallas import _ln_bwd_call
from centerclip_tpu.train import evaluate as jax_evaluate
from centerclip_tpu.train import loop as jax_loop
from centerclip_tpu.train import optim as jax_optim
from centerclip_tpu.train import state as jax_state
from centerclip_tpu_torch import config as port_config
from centerclip_tpu_torch.models import losses
from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
from centerclip_tpu_torch.models.weights import (clip4clip_entries,
                                                 load_torch_checkpoint,
                                                 state_dict_from_jax_params)
from centerclip_tpu_torch.ops import attention_cuda, cluster_layer
from centerclip_tpu_torch.ops import layernorm_triton
from centerclip_tpu_torch.serve import RetrievalEngine
from centerclip_tpu_torch.train import (Evaluator, TrainState, Trainer,
                                        build_optimizer,
                                        export_torch_checkpoint,
                                        load_checkpoint, make_train_step,
                                        resume,
                                        save_checkpoint)
from centerclip_tpu_torch.train import loop, optim

ARCH = "tiny-port-train"
T, RES, VOCAB, CTX = 4, 24, 100, 12
TINY = dict(embed_dim=32, image_resolution=RES, vision_layers=2,
            vision_width=64, vision_patch_size=8, vision_heads=4,
            context_length=CTX, vocab_size=VOCAB, transformer_width=64,
            transformer_heads=4, transformer_layers=2)
jax_config.CLIP_ARCHS[ARCH] = TINY
port_config.CLIP_ARCHS[ARCH] = TINY

FP32 = dict(rtol=2e-4, atol=2e-5)
# Parameters after optimizer steps, in units of the learning rate.  An Adam
# step moves each element by lr * m / (sqrt(v) + eps), at most a few lr
# (wrong signs, group multipliers, decay or bias correction give errors of
# 0.1-1 lr on most elements).  Where |g| >> eps that ratio is insensitive to
# the fp32 rounding by which the two packages' gradients differ (up to
# ~3e-5 absolute on this model); where |g| is near eps = 1e-6 its slope is
# up to 1/eps, and such elements move by up to ~1e-2 lr (6e-3 lr seen), so
# the tolerance is 2e-2 lr.
LR = 1e-3
STEP_ATOL = 2e-2 * LR


def config_kw(**over):
    kw = dict(clip_name=ARCH, max_frames=T, max_words=CTX,
              compute_dtype="float32", inter=True, algo="kmediods++",
              cluster_num_blocks=(5, 5), target_frames_blocks=(T, T // 2),
              cluster_embedding=True, adaptive_cls=True, lr=LR, coef_lr=0.5,
              weight_decay=0.2, warmup_proportion=0.0)
    kw.update(over)
    return kw


def run_configs(**over):
    jrun = jax_config.make_run_config(**config_kw(**over))
    run = port_config.make_run_config(**config_kw(**over))
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


def t(x):
    """numpy -> torch, never sharing memory with the source."""
    return torch.from_numpy(np.array(x, copy=True))


def causal_np(L):
    return np.triu(np.full((L, L), -np.inf, np.float32), k=1)


@pytest.fixture(scope="module")
def jax_init():
    jrun, _ = run_configs()
    jmodel = JaxCLIP4Clip(jrun.model)
    b = make_batch(0)
    params = jmodel.init(jax.random.PRNGKey(0), input_ids=b["input_ids"],
                         video=b["video"].astype(np.float32),
                         video_mask=b["video_mask"], training=True)["params"]
    return jmodel, jax.tree_util.tree_map(np.asarray, params)


def port_model(params, cfg):
    model = CLIP4Clip(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, cfg), strict=True)
    return model


def jax_leaf(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


def assert_params_match(model, jparams, cfg, **tol):
    sd = model.state_dict()
    for path, key, tf in clip4clip_entries(cfg):
        ref = jax_leaf(jparams, path)
        np.testing.assert_allclose(sd[key].numpy(),
                                   ref.T if tf == "T" else ref,
                                   err_msg=key, **tol)


# ------------------------------------------------------------- kernel B / D
@pytest.mark.parametrize("L,causal", [(32, True), (50, False), (50, True),
                                      (77, False), (77, True)])
def test_attention_bwd_plain_matches_pallas_bwd(L, causal):
    B, H, hd = 3, 2, 16
    D = H * hd
    g = np.random.default_rng(L + causal)
    qkv = g.standard_normal((B, L, 3 * D)).astype(np.float32)
    do = g.standard_normal((B, L, D)).astype(np.float32)
    mask = causal_np(L) if causal else None
    q, k, v = (jnp.asarray(a) for a in np.split(qkv, 3, axis=-1))
    dq, dk, dv, dmask = _mha_bwd_call(
        q, k, v, None if mask is None else jnp.asarray(mask), jnp.asarray(do),
        H, 2, True)
    dqkv, dm = attention_cuda.attention_bwd_plain(
        t(qkv), t(do), H, None if mask is None else t(mask),
        mask_grad=causal)
    ref = np.concatenate([np.asarray(a) for a in (dq, dk, dv)], axis=-1)
    np.testing.assert_allclose(dqkv.numpy(), ref, **FP32)
    if causal:
        np.testing.assert_allclose(dm.numpy(), np.asarray(dmask), **FP32)
        assert np.isfinite(dm.numpy()).all()
        # -inf entries of the mask have P = 0, so dS = 0 there
        assert (dm.numpy()[np.triu_indices(L, 1)] == 0).all()
    else:
        assert dm is None and dmask is None


@pytest.mark.parametrize("causal", [False, True])
def test_attention_function_passes_plain_backward_through(causal):
    """The autograd Function's gradient is the plain backward's output,
    bit for bit; and the plain backward is autograd of the plain forward
    up to fp32 rounding."""
    B, L, H, hd = 2, 20, 2, 8
    D = H * hd
    g = np.random.default_rng(9)
    qkv = t(g.standard_normal((B, L, 3 * D)).astype(np.float32))
    do = t(g.standard_normal((B, L, D)).astype(np.float32))
    mask = t(causal_np(L)) if causal else None
    x = qkv.clone().requires_grad_(True)
    m = mask.clone().requires_grad_(True) if causal else None
    attention_cuda.fused_attention(x, H, m).backward(do)
    dqkv, dmask = attention_cuda.attention_bwd_plain(qkv, do, H, mask,
                                                     mask_grad=causal)
    assert torch.equal(x.grad, dqkv)
    if causal:
        assert torch.equal(m.grad, dmask)
    y = qkv.clone().requires_grad_(True)
    attention_cuda.attention_plain(y, H, mask).backward(do)
    np.testing.assert_allclose(dqkv.numpy(), y.grad.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("R,D", [(37, 768), (20, 512), (600, 64)])
def test_layer_norm_bwd_plain_matches_pallas_bwd(R, D):
    g = np.random.default_rng(R)
    x = (g.standard_normal((R, D)) * 3.0 + 2.0).astype(np.float32)
    w = (g.standard_normal(D) * 0.1 + 1.0).astype(np.float32)
    dy = g.standard_normal((R, D)).astype(np.float32)
    dx_ref, dw_ref, db_ref = _ln_bwd_call(jnp.asarray(x), jnp.asarray(w),
                                          jnp.asarray(dy), 1e-5, True)
    dx, dw, db = layernorm_triton.layer_norm_bwd_plain(t(x), t(w), t(dy))
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_ref), **FP32)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_ref), **FP32)
    np.testing.assert_allclose(db.numpy(), np.asarray(db_ref), **FP32)
    assert dw.dtype == db.dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_function_passes_plain_backward_through(dtype):
    g = np.random.default_rng(3)
    x = t(g.standard_normal((2, 5, 48)).astype(np.float32) * 2).to(dtype)
    w = t(g.standard_normal(48).astype(np.float32))
    b = t(g.standard_normal(48).astype(np.float32))
    dy = t(g.standard_normal((2, 5, 48)).astype(np.float32)).to(dtype)
    xs, ws, bs = (a.clone().requires_grad_(True) for a in (x, w, b))
    y = layernorm_triton.layer_norm(xs, ws, bs)
    assert y.dtype == dtype
    y.backward(dy)
    dx, dw, db = layernorm_triton.layer_norm_bwd_plain(x, w, dy)
    assert xs.grad.dtype == dtype
    assert torch.equal(xs.grad, dx) and torch.equal(ws.grad, dw) \
        and torch.equal(bs.grad, db)


# ---------------------------------------------------------- cluster layer
@pytest.mark.parametrize("options", [
    {}, {"aggregation": "mean"},
    {"cluster_embedding": True, "adaptive_cls": True}])
def test_cluster_layer_input_grad_matches_jax(options):
    """Gradient reaches the tokens of the blocks before the cluster layer
    through the medoid gather (or the cluster means) and the CLS mean."""
    B, S, P, W, K = 2, 2, 9, 16, 5
    kw = dict(block_id=2, algo="kmediods++", before_cluster_num=P,
              cluster_num=K, before_frames=T, after_frames=S,
              frame_duration=T // S)
    jcfg = jax_config.ClusterConfig(inter=True, **options)
    cfg = port_config.ClusterConfig(inter=True, **options)
    g = np.random.default_rng(len(options))
    centres = g.standard_normal((4, W)).astype(np.float32) * 3.0
    x = (centres[g.integers(0, 4, (B * T, 1 + P))]
         + 0.3 * g.standard_normal((B * T, 1 + P, W))).astype(np.float32)
    w = g.standard_normal((B * S, 1 + K, W)).astype(np.float32)
    jmod = jax_cluster.TokenClusterInter(spec=jax_config.BlockClusterSpec(**kw),
                                         cfg=jcfg, width=W)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x)).get("params", {})

    def jloss(p, xx):
        return jnp.sum(jmod.apply({"params": p}, xx) * w)
    gp, gx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))

    mod = cluster_layer.TokenClusterInter(port_config.BlockClusterSpec(**kw),
                                          cfg, W)
    mod.load_state_dict({k: t(v) for k, v in params.items()}, strict=True)
    xs = t(x).requires_grad_(True)
    (mod(xs) * t(w)).sum().backward()
    assert float(xs.grad[:, 1:].abs().sum()) > 0    # the patch tokens
    np.testing.assert_allclose(xs.grad.numpy(), np.asarray(gx), **FP32)
    for name, p in mod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp[name]),
                                   err_msg=name, **FP32)


# ------------------------------------------------------------- model loss
def test_loss_and_every_gradient_match_jax(jax_init):
    jmodel, params = jax_init
    _, run = run_configs()
    batch = make_batch(1)

    def loss_fn(p):          # the loss of the JAX package's make_train_step
        out = jmodel.apply({"params": p}, input_ids=batch["input_ids"],
                           attention_mask=batch["attention_mask"],
                           video=batch["video"],
                           video_mask=batch["video_mask"], training=True,
                           rng=jax.random.PRNGKey(0))
        return out["loss"], out["sim_loss"]
    (jloss, jsim), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)

    model = port_model(params, run.model)
    out = model(**loop.batch_to_device(batch, torch.device("cpu")),
                training=True)
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), float(jloss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(out["sim_loss"].detach()), float(jsim),
                               rtol=1e-5)
    assert float(out["cluster_loss"]) == 0.0
    named = dict(model.named_parameters())
    for path, key, tf in clip4clip_entries(run.model):
        ref = jax_leaf(jgrads, path)
        grad = named[key].grad
        assert grad is not None, key
        np.testing.assert_allclose(grad.numpy(), ref.T if tf == "T" else ref,
                                   err_msg=key, **FP32)


def _jax_steps(jmodel, params, jrun, batches, accum=1):
    tx = jax_optim.build_optimizer(jrun.optim, params, total_steps=4,
                                   freeze_layer_num=jrun.freeze_layer_num,
                                   freeze_clip=jrun.freeze_clip)
    state = jax_state.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, params), tx)
    step = jax_loop.make_train_step(jmodel, tx, accum_steps=accum)
    logs = []
    for i, b in enumerate(batches):
        state, log = step(state, b, jax.random.PRNGKey(i))
        logs.append(float(log["loss"]))
    return jax.tree_util.tree_map(np.asarray, state.params), logs


@pytest.mark.parametrize("optim_name", ["BertAdam", "AdamW"])
@pytest.mark.parametrize("freeze", [0, -1])
def test_two_optimizer_steps_match_jax(jax_init, optim_name, freeze):
    jmodel, params = jax_init
    jrun, run = run_configs(optim=optim_name, freeze_layer_num=freeze)
    batches = [make_batch(2), make_batch(3)]
    jparams, jlogs = _jax_steps(jmodel, params, jrun, batches)
    model = port_model(params, run.model)
    opt = build_optimizer(run.optim, model, total_steps=4,
                          freeze_layer_num=freeze)
    step = make_train_step(model, opt)
    logs = [float(step(b)["loss"]) for b in batches]
    np.testing.assert_allclose(logs, jlogs, rtol=1e-5)
    assert opt.step_count == 2
    assert_params_match(model, jparams, run.model, rtol=0, atol=STEP_ATOL)
    before = state_dict_from_jax_params(params, run.model)
    moved = {k for k, v in model.state_dict().items()
             if not torch.equal(v, before[k])}
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert moved and not moved & frozen
    if freeze == 0:
        assert "clip.visual.conv1.weight" in frozen
        assert "clip.visual.transformer.resblocks.0.ln_1.weight" in moved
    else:
        assert not frozen


def test_accumulation_over_three_micro_batches_matches_jax(jax_init):
    jmodel, params = jax_init
    jrun, run = run_configs(optim="AdamW", gradient_accumulation_steps=3)
    micro = [make_batch(4), make_batch(5), make_batch(6)]
    jparams, jlogs = _jax_steps(jmodel, params, jrun, [micro], accum=3)
    model = port_model(params, run.model)
    opt = build_optimizer(run.optim, model, total_steps=4,
                          freeze_layer_num=run.freeze_layer_num)
    logs = make_train_step(model, opt, accum_steps=3)(micro)
    np.testing.assert_allclose(float(logs["loss"]), jlogs[0], rtol=1e-5)
    assert_params_match(model, jparams, run.model, rtol=0, atol=STEP_ATOL)


def test_trainer_epoch_flushes_the_accumulation_tail(jax_init):
    _, params = jax_init
    _, run = run_configs(optim="BertAdam", gradient_accumulation_steps=2)
    model = port_model(params, run.model)
    trainer = Trainer(run, model, total_steps=10)
    loss, gstep = trainer.train_epoch(
        0, [make_batch(s) for s in range(5)], n_display=1)
    assert gstep == 3 and trainer.optimizer.step_count == 3  # 2 + 1 tail
    assert np.isfinite(loss)


@pytest.mark.parametrize("start", [10.0, -1.0])
def test_logit_scale_is_clamped_after_the_update(jax_init, start):
    _, params = jax_init
    _, run = run_configs()
    model = port_model(params, run.model)
    with torch.no_grad():
        model.clip.logit_scale.fill_(start)
    make_train_step(model, build_optimizer(run.optim, model, 4))(
        make_batch(7))
    ref = jax_loop.clamp_logit_scale(
        {"clip": {"logit_scale": jnp.float32(start)}})["clip"]["logit_scale"]
    scale = float(model.clip.logit_scale.detach())
    assert scale == float(ref)
    assert scale in (np.float32(loop.LOGIT_SCALE_MIN),
                     np.float32(loop.LOGIT_SCALE_MAX))


# ------------------------------------------------- labels, masks, schedules
@pytest.mark.parametrize("freeze,freeze_clip", [(-1, False), (0, False),
                                                (1, False), (2, False),
                                                (-1, True)])
def test_group_labels_and_trainable_mask_match_jax(jax_init, freeze,
                                                   freeze_clip):
    _, params = jax_init
    _, run = run_configs()
    jlabels = jax_optim.group_labels(params)
    jmask = jax_optim.trainable_mask(params, freeze, freeze_clip)
    entries = clip4clip_entries(run.model)
    mask = optim.trainable_mask([k for _, k, _ in entries], freeze,
                                freeze_clip)
    for path, key, _ in entries:
        assert optim.param_group_label(key) == jax_leaf(jlabels, path), key
        assert mask[key] == bool(jax_leaf(jmask, path)), key
    labels = {optim.param_group_label(k) for _, k, _ in entries}
    assert labels == {"clip_decay", "clip_nodecay"}
    assert optim.param_group_label(
        "clip.transformer.resblocks.0.attn.in_proj_bias") == "clip_nodecay"
    assert optim.param_group_label(
        "clip.transformer.resblocks.0.ln_1.weight") == "clip_decay"
    assert optim.param_group_label("frame_position_embeddings") \
        == "noclip_decay"


@pytest.mark.parametrize("mode", ["cos", "poly", "HTD", "step"])
@pytest.mark.parametrize("warmup", [0.0, 0.25])
def test_lr_schedules_match_jax(mode, warmup):
    jrun, run = run_configs(lr_mode=mode, warmup_proportion=warmup,
                            optim="AdamW")
    jsched = jax_optim.make_lr_schedule(jrun.optim, 10, lr_step=3)
    sched = optim.make_lr_schedule(run.optim, 10, lr_step=3)
    for s in range(12):
        # JAX evaluates the schedule in fp32, the port in fp64
        assert sched(s) == pytest.approx(float(jsched(s)), rel=1e-5,
                                         abs=1e-6 * LR), s
        assert optim.current_lr(run.optim, s, 10) == pytest.approx(
            float(jax_optim.current_lr(jrun.optim, s, 10)), rel=1e-5,
            abs=1e-6 * LR)


@pytest.mark.parametrize("name", sorted(optim.BERT_SCHEDULES))
def test_bert_schedules_match_jax(name):
    jrun, run = run_configs(optim="BertAdam", schedule=name,
                            warmup_proportion=0.1)
    for x in [i / 10 for i in range(13)]:
        assert optim.BERT_SCHEDULES[name](float(x), 0.1) == pytest.approx(
            float(jax_optim.BERT_SCHEDULES[name](jnp.float32(x), 0.1)),
            rel=1e-5, abs=1e-7)
    for s in (0, 3, 9):
        assert optim.current_lr(run.optim, s, 10) == pytest.approx(
            float(jax_optim.current_lr(jrun.optim, s, 10)), rel=1e-5)


@pytest.mark.parametrize("overrides", [{}, {"batch_size": 64}])
def test_presets_match_jax(overrides):
    a = port_config.preset("msrvtt_vitb32_k6", **overrides)
    b = jax_config.preset("msrvtt_vitb32_k6", **overrides)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.batch_size == overrides.get("batch_size", 128)


@pytest.mark.parametrize("name,overrides", [
    ("msrvtt_vitb32_k4", {}), ("lsmdc_vitb32_k6", {}), ("msvd_vitb32_k4", {}),
    ("msrvtt_vitb16_k6", {}), ("msrvtt_vitb16_k6", {"remat": True}),
    ("lsmdc_vitb32_spectral6", {}), ("activity_vitb32", {}),
    ("activity_vitb32", {"remat": True})])
def test_ported_presets_match_jax_field_by_field(name, overrides):
    a = port_config.preset(name, **overrides)
    b = jax_config.preset(name, **overrides)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.model.remat == overrides.get("remat", False)
    # the port builds every one of them (no config raises)
    from centerclip_tpu_torch.models.clip import check_supported
    check_supported(a.model)


@pytest.mark.parametrize("name", ["lsmdc_vitb32_spectral6", "activity_vitb32"])
def test_presets_the_port_does_not_run_are_refused(name):
    """The port now has every preset of the JAX package (these two were
    the last); a name that neither package has is refused by both."""
    a, b = port_config.preset(name), jax_config.preset(name)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for config in (port_config, jax_config):
        with pytest.raises(KeyError, match="unknown preset"):
            config.preset(name + "_x")


@pytest.mark.parametrize("freeze", [0, -1])
def test_every_trainable_parameter_gets_a_nonzero_gradient(jax_init, freeze):
    """The backward reaches every trainable tensor; the optimizer's zero fill
    for a missing gradient is never what the update sees."""
    _, params = jax_init
    _, run = run_configs(freeze_layer_num=freeze)
    model = port_model(params, run.model)
    build_optimizer(run.optim, model, 4, freeze_layer_num=freeze)
    model(**loop.batch_to_device(make_batch(13), torch.device("cpu")),
          training=True)["loss"].backward()
    for name, p in model.named_parameters():
        if p.requires_grad:
            assert p.grad is not None and bool(p.grad.abs().max() > 0), name
        else:
            assert p.grad is None, name


# ------------------------------------------------------------------ losses
@pytest.mark.parametrize("loss", ["cross_entropy", "milnce", "max_margin",
                                  "max_margin_weighted"])
def test_losses_match_jax(loss):
    sim = np.random.default_rng(5).standard_normal((6, 6)).astype(
        np.float32) * 4
    if loss == "cross_entropy":
        ref, out = jax_losses.cross_entropy(jnp.asarray(sim)), \
            losses.cross_entropy(t(sim))
    elif loss == "milnce":
        ref, out = jax_losses.milnce_loss(jnp.asarray(sim), 3, 2), \
            losses.milnce_loss(t(sim), 3, 2)
    else:
        kw = dict(margin=0.5, negative_weighting=loss.endswith("weighted"),
                  batch_size=3, n_pair=2)
        ref = jax_losses.max_margin_ranking_loss(jnp.asarray(sim), **kw)
        out = losses.max_margin_ranking_loss(t(sim), **kw)
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)


# ------------------------------------------------------------- checkpoints
def test_checkpoint_roundtrip(jax_init, tmp_path):
    _, params = jax_init
    _, run = run_configs(optim="AdamW")
    model = port_model(params, run.model)
    trainer = Trainer(run, model, total_steps=4)
    trainer.train_epoch(0, [make_batch(8)], n_display=100)
    path = save_checkpoint(str(tmp_path), trainer.state, epoch=0,
                           best_r1=12.5, is_best=True)
    assert os.path.realpath(tmp_path / "ckpt_latest") == path
    assert (tmp_path / "ckpt_best").is_file()

    other = port_model(params, run.model)
    fresh = TrainState(other, build_optimizer(
        run.optim, other, 4, freeze_layer_num=run.freeze_layer_num))
    state, epoch, best = resume(path, fresh)
    assert (epoch, best, state.global_step) == (1, 12.5, 1)   # next epoch
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    a, b = trainer.optimizer.state_dict(), state.optimizer.state_dict()
    assert a["step"] == b["step"] == 1
    for key in ("exp_avg", "exp_avg_sq"):
        for n in a[key]:
            assert torch.equal(a[key][n], b[key][n]), n
    # one more step from each gives the same parameters
    make_train_step(model, trainer.optimizer)(make_batch(9))
    make_train_step(other, state.optimizer)(make_batch(9))
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k

    weights_only = port_model(params, run.model)
    _, epoch, _ = resume(path, TrainState(
        weights_only, build_optimizer(run.optim, weights_only, 4)),
        load_weights_only=True)
    saved = load_checkpoint(path)["params"]
    for k, v in weights_only.state_dict().items():
        assert torch.equal(saved[k], v), k
    assert epoch == 0

    # the reference's ckpt.pth.tar schema, read by the port and by JAX
    tpath = str(tmp_path / "ckpt.pth.tar")
    export_torch_checkpoint(model, tpath, epoch=1, global_step=2)
    sd = load_torch_checkpoint(tpath)
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k
    jparams, report = jax_state.import_torch_checkpoint(tpath, run.model,
                                                        init_params=params)
    assert not report["missing"]
    assert_params_match(model, jparams, run.model, rtol=0, atol=0)


# -------------------------------------------------------------- evaluation
@pytest.mark.parametrize("multi_sentence", [False, True])
def test_evaluator_matches_jax(jax_init, multi_sentence):
    jmodel, params = jax_init
    _, run = run_configs()
    batches = [make_batch(10, n=4), make_batch(11, n=2)]
    kw = (dict(multi_sentence=True, cut_off_points=[2, 4, 6])
          if multi_sentence else {})
    ref = jax_evaluate.Evaluator(jmodel, params).evaluate(
        [dict(b) for b in batches], **kw)
    res = Evaluator(port_model(params, run.model)).evaluate(batches, **kw)
    assert res["sim_matrix"].shape == ref["sim_matrix"].shape \
        == ((6, 3) if multi_sentence else (6, 6))
    np.testing.assert_allclose(res["sim_matrix"], ref["sim_matrix"], **FP32)
    for d in ("t2v", "v2t"):
        for k in ("R1", "R5", "R10", "MR", "MeanR"):
            assert res[d][k] == ref[d][k], (d, k)


def test_model_is_differentiable_and_engine_is_not(jax_init):
    """The model no longer switches gradients off itself; the engine runs
    its calls in inference mode."""
    _, params = jax_init
    _, run = run_configs()
    model = port_model(params, run.model)
    b = make_batch(12)
    assert model.get_sequence_output(t(b["input_ids"]).long()).requires_grad
    vm = model.video_mask_after_cluster(t(b["video_mask"]))
    assert model.get_visual_output(t(b["video"]), vm).requires_grad
    engine = RetrievalEngine(model, device="cpu")
    emb = engine.embed_video_batches([{"video": b["video"],
                                       "video_mask": b["video_mask"]}])
    assert emb.shape == (3, 32) and np.isfinite(emb).all()
    assert engine.encode_token_ids(b["input_ids"]).shape == (3, 32)
    assert all(p.grad is None for p in model.parameters())
