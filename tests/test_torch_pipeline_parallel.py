# coding=utf-8
"""The port's pipe axis (`centerclip_tpu_torch.parallel.pipeline`: the
GPipe schedule, the stage hops, PP + FSDP, PP checkpoints, `main
--pipeline_parallel`) against the JAX package, on the CPU, in a world of 4
gloo processes as a `(data 2, pipe 2)` mesh.

One world (`torch.multiprocessing`, spawn, a free port, a time limit) runs
every multi-rank case and hands its results back through files (each rank
its own); the tests check them against the port's one-process steps and
the JAX package's at the same global batch.  The model is JAX
tests/test_pipeline_parallel.py's tiny-pipe arch: 4 + 4 blocks of width 32
with 2 heads, 4 frames of 16 x 16 (L = 5 tokens), fp32; with clustering
the token count changes at block 2 (4 -> 2 frames, K = 3), so the vision
tower pipelines two runs of 2 blocks, 1 a stage, and the text tower its
4 blocks, 2 a stage.  Ranks 2d and 2d + 1 form pipe group d and take rows
[2 d, 2 d + 2) of each global batch of 4.

Tolerances: tests/test_torch_parallel.py's.  A PP or PP + FSDP step
against the port's one-process step, losses and parameters to 1e-5 (the
microbatches' matmuls and the gradients' sums over them round otherwise);
against JAX, the loss rtol 1e-5, every clipped gradient of the first step
rtol 2e-4 / atol 2e-5, every parameter after it 2e-2 x lr where the
gradient is not within 10 eps of zero.  The toy stack against JAX's
`pipeline_blocks` on the 8-device CPU mesh: forward rtol 1e-6, gradients
rtol 1e-5 / atol 1e-6 (JAX tests/test_pipeline_parallel.py:52-84).  The
replicated parameters of the four ranks: to the bit.

Run as a script, this file is the worker of the 4-process `main` test:
`python -m torch.distributed.run --standalone --nproc_per_node 4
tests/test_torch_pipeline_parallel.py <data root> <out dir> [flags]`.
"""
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from centerclip_tpu import config as jax_config  # noqa: E402
from centerclip_tpu.models.clip4clip import CLIP4Clip as JaxCLIP4Clip  # noqa
from centerclip_tpu.parallel import mesh as jax_mesh  # noqa: E402
from centerclip_tpu.parallel import pipeline as jax_pipeline  # noqa: E402
from centerclip_tpu.train import loop as jax_loop  # noqa: E402
from centerclip_tpu.train import optim as jax_optim  # noqa: E402
from centerclip_tpu.train import state as jax_state  # noqa: E402
from centerclip_tpu_torch import config as port_config  # noqa: E402
from centerclip_tpu_torch import parallel  # noqa: E402
from centerclip_tpu_torch.models import layers  # noqa: E402
from centerclip_tpu_torch.models.clip4clip import CLIP4Clip  # noqa: E402
from centerclip_tpu_torch.models.weights import (  # noqa: E402
    clip4clip_entries, state_dict_from_jax_params)
from centerclip_tpu_torch.parallel import mesh as port_mesh  # noqa: E402
from centerclip_tpu_torch.parallel import pipeline  # noqa: E402
from centerclip_tpu_torch.train import (Trainer, host_state,  # noqa: E402
                                        make_train_step, resume,
                                        save_checkpoint)
from tests.test_torch_parallel import (  # noqa: E402
    ADAM_EPS, PORT_ATOL, STEP_ATOL, assert_state_close, main_argv,
    msrvtt_root, run_main, sim_losses)
from tests.test_torch_tensor_parallel import _free_port  # noqa: E402

ARCH = "tiny-pipe"
TINY = dict(embed_dim=16, image_resolution=16, vision_layers=4,
            vision_width=32, vision_patch_size=8, vision_heads=2,
            context_length=8, vocab_size=64, transformer_width=32,
            transformer_heads=2, transformer_layers=4)
jax_config.CLIP_ARCHS[ARCH] = TINY
port_config.CLIP_ARCHS[ARCH] = TINY
T, RES, CTX, VOCAB = 4, 16, 8, 64
WORLD, PP = 4, 2
DATA = WORLD // PP
GLOBAL_BATCH = 4
LR = 1e-3
WORLD_TIMEOUT = 300                   # seconds for the spawned world
# (clustering, mode, gradient accumulation)
CASES = [(True, "pp", 1), (True, "pp_fsdp", 1), (False, "pp", 1),
         (False, "pp_fsdp", 1), (True, "pp", 2)]
TOY_ROWS, TOY_F, TOY_BLOCKS = 16, 8, 5


def config_kw(cluster=True, **over):
    kw = dict(clip_name=ARCH, max_frames=T, max_words=CTX,
              compute_dtype="float32", sim_header="meanP",
              optim="AdamW", lr=LR, coef_lr=0.5, weight_decay=0.2,
              warmup_proportion=0.0)
    if cluster:
        kw.update(inter=True, algo="kmediods++", cluster_num_blocks=(3,) * 4,
                  target_frames_blocks=(T, T, T // 2, T // 2))
    kw.update(over)
    return kw


def run_config(cluster=True, **over):
    return port_config.make_run_config(**config_kw(cluster, **over))


def pp_config(cluster, mode, accum):
    return run_config(cluster, pipeline_parallel=PP, fsdp=mode == "pp_fsdp",
                      gradient_accumulation_steps=accum)


def make_batch(seed, n=GLOBAL_BATCH):
    g = np.random.default_rng(seed)
    ids = g.integers(1, VOCAB - 2, size=(n, CTX)).astype(np.int32)
    ids[:, 0] = VOCAB - 2
    ids[np.arange(n), g.integers(3, CTX, n)] = VOCAB - 1      # EOT
    vmask = np.ones((n, T), np.int32)
    vmask[-1, -1] = 0
    return {"input_ids": ids, "attention_mask": np.ones((n, CTX), np.int32),
            "video": g.integers(0, 256, (n, 1, T, 3, RES, RES),
                                dtype=np.uint8),
            "video_mask": vmask}


def step_batches(step, accum):
    """Optimizer step `step`'s global batch, or its `accum` micro-batches."""
    mbs = [make_batch(10 * (step + 1) + i) for i in range(accum)]
    return mbs[0] if accum == 1 else mbs


def rank_rows(batch, rank):
    """Pipe group rank // PP's rows of a global batch (or of each
    micro-batch)."""
    if isinstance(batch, list):
        return [rank_rows(b, rank) for b in batch]
    b = len(batch["input_ids"]) // DATA
    d = rank // PP
    return {k: v[d * b:(d + 1) * b] for k, v in batch.items()}


def port_model(cluster, init_sd):
    model = CLIP4Clip(run_config(cluster).model, device="cpu")
    model.load_state_dict(init_sd, strict=True)
    return model


def one_step(trainer, batch, accum):
    logs = make_train_step(trainer.module, trainer.optimizer, accum)(batch)
    trainer.state.global_step += 1
    return {k: float(v) for k, v in logs.items()}


def toy_stack():
    """JAX tests/test_pipeline_parallel.py:52-66's toy stack, as numpy."""
    rng = np.random.default_rng(0)
    params = [dict(w=(rng.normal(size=(TOY_F, TOY_F)) * 0.3).astype(
        np.float32), b=(rng.normal(size=(TOY_F,)) * 0.1).astype(np.float32))
        for _ in range(TOY_BLOCKS)]
    x = rng.normal(size=(TOY_ROWS, 3, TOY_F)).astype(np.float32)
    return params, x


class ToyBlock(torch.nn.Module):
    def __init__(self, p):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(p["w"].copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(p["b"].copy()))

    def forward(self, h):
        return torch.tanh(h @ self.w + self.b)


# ------------------------------------------------------------ the world
def _toy_case(axes, rank):
    """The 5-block stack on this rank's rows (2 blocks a stage, 1 left),
    forward and gradients of sum(y ** 2)."""
    params, x = toy_stack()
    blocks = [ToyBlock(p) for p in params]
    rows = TOY_ROWS // DATA
    xs = torch.from_numpy(x[(rank // PP) * rows:(rank // PP + 1) * rows]
                          ).requires_grad_()
    y = pipeline.pipeline_blocks(blocks, lambda b, h: b(h), xs, 2, axes)
    (y ** 2).sum().backward()
    return dict(y=y.detach(), x_grad=xs.grad,
                grads=[(b.w.grad, b.b.grad) for b in blocks])


def recording(model, store):
    """Record the shapes the towers' attention (kernel A) and block
    LayerNorms (C) took on this rank, and the cluster module's input and
    output.  Returns the function that undoes it."""
    attend = layers.fused_attention

    def attn_rec(qkv, heads, mask=None):
        store["qkv"].add(tuple(qkv.shape))
        return attend(qkv, heads, mask)
    layers.fused_attention = attn_rec
    hooks = []
    for tower in (model.clip.visual, model.clip):
        for block in tower.transformer.resblocks:
            hooks.append(block.ln_1.register_forward_pre_hook(
                lambda m, a: store["ln_rows"].add(tuple(a[0].shape))))
    inter = model.clip.visual.transformer.resblocks[2].tokencluster_inter
    if inter is not None:
        hooks.append(inter.register_forward_hook(
            lambda m, a, o: store.update(cluster_in=a[0].detach().clone(),
                                         cluster_out=o.detach().clone())))

    def undo():
        layers.fused_attention = attend
        for h in hooks:
            h.remove()
    return undo


def _world(rank, world, workdir):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    parallel.init_distributed("cpu")
    inits = torch.load(os.path.join(workdir, "init.pt"))
    with pytest.raises(ValueError, match="pipe extent 3 does not divide"):
        parallel.create_mesh(pipeline_parallel=3, device_type="cpu")
    mesh = parallel.create_mesh(pipeline_parallel=PP, device_type="cpu")
    axes = port_mesh.mesh_axes(mesh)
    out = {"axes": (mesh.mesh_dim_names, axes.data_size, axes.pipe_size,
                    axes.stage, torch.distributed.get_rank(axes.data_group)),
           "toy": _toy_case(axes, rank)}
    steps = {}
    for cluster, mode, accum in CASES:
        model = port_model(cluster, inits[cluster])
        trainer = Trainer(pp_config(cluster, mode, accum), model,
                          total_steps=4)
        store = {"ln_rows": set(), "qkv": set()}
        undo = recording(model, store)
        try:
            logs = [one_step(trainer, rank_rows(step_batches(0, accum),
                                                rank), accum)]
        finally:
            undo()
        grads = parallel.fetch_replicated(
            {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None})
        first = host_state(trainer.state)
        if (cluster, mode, accum) == (True, "pp", 1):
            if rank == 0:
                save_checkpoint(os.path.join(workdir, "pp_ckpt"),
                                trainer.state, 0, 0.0, host=first)
            parallel.process_barrier("pp_ckpt")
        logs.append(one_step(trainer, rank_rows(step_batches(1, accum),
                                                rank), accum))
        steps[(cluster, mode, accum)] = dict(
            logs=logs, grads=grads, first=first, **store,
            **host_state(trainer.state))
    out["steps"] = steps
    # the one-process checkpoint resumed into a PP + FSDP run
    model = port_model(True, inits[True])
    trainer = Trainer(pp_config(True, "pp_fsdp", 1), model, total_steps=4)
    resume(os.path.join(workdir, "single_ckpt", "ckpt_0"), trainer.state)
    logs = one_step(trainer, rank_rows(step_batches(1, 1), rank), 1)
    out["resumed"] = dict(logs=logs, step=trainer.state.global_step,
                          **host_state(trainer.state))
    torch.save(out, os.path.join(workdir, f"world_{rank}.pt"))
    parallel.process_barrier("done")
    torch.distributed.destroy_process_group()


def _world_entry(rank, world, port, workdir):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port))
    _world(rank, world, workdir)


# ---------------------------------------------------------- references
def jax_params(cluster):
    jrun = jax_config.make_run_config(**config_kw(cluster))
    b = make_batch(0, n=2)
    params = JaxCLIP4Clip(jrun.model).init(
        jax.random.PRNGKey(0), input_ids=b["input_ids"],
        video=b["video"].astype(np.float32), video_mask=b["video_mask"],
        training=True)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def jax_steps(cluster, params):
    """The JAX package's two one-process steps: (losses, parameters after
    the first step, gradients of the first step by torch key, before the
    clip)."""
    jrun = jax_config.make_run_config(**config_kw(cluster))
    jmodel = JaxCLIP4Clip(jrun.model)
    tx = jax_optim.build_optimizer(jrun.optim, params, total_steps=4,
                                   freeze_layer_num=jrun.freeze_layer_num,
                                   freeze_clip=jrun.freeze_clip)
    state = jax_state.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, params), tx)
    step = jax_loop.make_train_step(jmodel, tx, accum_steps=1)

    def loss_fn(p, b):
        return jmodel.apply({"params": p}, **b, training=True,
                            rng=jax.random.PRNGKey(0))["loss"]
    g = jax.grad(loss_fn)(state.params, step_batches(0, 1))
    grads = {}
    for path, key, tf in clip4clip_entries(run_config(cluster).model):
        leaf = g
        for p in path:
            leaf = leaf[p]
        leaf = np.asarray(leaf)
        grads[key] = leaf.T if tf == "T" else leaf
    losses = []
    state, log = step(state, step_batches(0, 1), jax.random.PRNGKey(0))
    losses.append(float(log["loss"]))
    first = jax.tree_util.tree_map(np.asarray, state.params)
    state, log = step(state, step_batches(1, 1), jax.random.PRNGKey(0))
    losses.append(float(log["loss"]))
    return losses, first, grads


def jax_toy():
    """JAX's `pipeline_blocks` on the (data 4, pipe 2) mesh of the 8 host
    devices: forward and gradients of sum(y ** 2)."""
    params, x = toy_stack()

    def apply_one(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    def loss(params, x):
        y = jax_pipeline.pipeline_blocks(params, apply_one, x,
                                         microbatches=2)
        return (y ** 2).sum(), y

    mesh = jax_mesh.create_mesh(8, pipeline_parallel=PP)
    with mesh:
        (_, y), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                   has_aux=True))(params, x)
    return np.asarray(y), [(np.asarray(g["w"]), np.asarray(g["b"]))
                           for g in grads[0]], np.asarray(grads[1])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world's results beside the JAX inits and steps and the port's
    one-process steps, computed while the world runs."""
    workdir = str(tmp_path_factory.mktemp("pipeline_parallel_world"))
    jparams = {c: jax_params(c) for c in (True, False)}
    inits = {c: state_dict_from_jax_params(jparams[c], run_config(c).model)
             for c in (True, False)}
    torch.save(inits, os.path.join(workdir, "init.pt"))
    single = {}
    for cluster, accum in {(c, a) for c, _, a in CASES}:
        trainer = Trainer(run_config(cluster, gradient_accumulation_steps=
                                     accum),
                          port_model(cluster, inits[cluster]), total_steps=4)
        logs = [one_step(trainer, step_batches(0, accum), accum)]
        first = host_state(trainer.state)
        if (cluster, accum) == (True, 1):
            save_checkpoint(os.path.join(workdir, "single_ckpt"),
                            trainer.state, 0, 0.0)
        logs.append(one_step(trainer, step_batches(1, accum), accum))
        single[(cluster, accum)] = dict(logs=logs, first=first,
                                        **host_state(trainer.state))
    ctx = mp.start_processes(_world_entry,
                             args=(WORLD, _free_port(), workdir),
                             nprocs=WORLD, join=False, start_method="spawn")
    jax_ref = {c: jax_steps(c, jparams[c]) for c in (True, False)}
    toy = jax_toy()
    deadline = time.time() + WORLD_TIMEOUT
    while not ctx.join(timeout=1.0):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"a world of {WORLD} processes ran past "
                        f"{WORLD_TIMEOUT} s")
    ranks = [torch.load(os.path.join(workdir, f"world_{r}.pt"))
             for r in range(WORLD)]
    return dict(workdir=workdir, jparams=jparams, inits=inits, single=single,
                jax=jax_ref, jax_toy=toy, ranks=ranks, **ranks[0])


# ------------------------------------------------------------ the mesh
def test_mesh_folds_the_pipe_axis_fastest(world):
    """(axis names, data extent, pipe extent, stage, data rank) of each
    rank: ranks 2d and 2d + 1 form pipe group d (JAX's reshape(data,
    pipe)); a pipe extent of 3 does not divide 4 ranks (checked in the
    world)."""
    assert [r["axes"] for r in world["ranks"]] == [
        (("data", "pipe"), DATA, PP, rank % PP, rank // PP)
        for rank in range(WORLD)]


def test_create_mesh_refuses_what_jax_refuses():
    """Tensor and pipeline parallelism together ("combined", as JAX's
    `create_mesh` and config say) and a pipe extent that does not divide
    the processes (one process here)."""
    with pytest.raises(ValueError, match="combined"):
        parallel.create_mesh(tensor_parallel=2, pipeline_parallel=2,
                             device_type="cpu")
    with pytest.raises(ValueError, match="combined"):
        jax_mesh.create_mesh(8, tensor_parallel=2, pipeline_parallel=2)
    with pytest.raises(ValueError, match="pipe extent 2 does not divide"):
        parallel.create_mesh(pipeline_parallel=2, device_type="cpu")


@pytest.mark.parametrize("pc,pi", [(4, 0), (4, 1), (4, 2), (4, 3)])
def test_a_pipe_group_reads_the_same_rows(pc, pi):
    """data_shard_geometry with the pipe extent: the 2 ranks of a pipe
    group get one shard index, as JAX's does."""
    got = parallel.data_shard_geometry(pipeline_parallel=PP, count=pc,
                                       index=pi)
    assert got == (pi // PP, pc // PP)


def test_config_validation_matches_jax():
    """PP + TP raises "combined" in both packages' configs; PP turns
    `fused_attention` off in both (the port does not read it on CUDA
    tensors); the configs compare equal field by field."""
    import dataclasses
    for make in (port_config.make_run_config, jax_config.make_run_config):
        with pytest.raises(ValueError, match="combined"):
            make(**config_kw(pipeline_parallel=2, tensor_parallel=2))
    a = port_config.make_run_config(**config_kw(pipeline_parallel=2,
                                                pipeline_microbatches=4))
    b = jax_config.make_run_config(**config_kw(pipeline_parallel=2,
                                               pipeline_microbatches=4))
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert not a.model.fused_attention
    assert (a.model.pipeline_parallel, a.model.pipeline_microbatches) == \
        (2, 4)


# ------------------------------------------------------------ the toy
def test_toy_stack_matches_jax_and_the_sequential_loop(world):
    """The 5-block stack (2 blocks a stage, the 5th in sequence after the
    pipeline) on each rank's rows: forward and input gradient against
    JAX's `pipeline_blocks` and against the plain loop; the parameter
    gradients summed over the two data shards against JAX's, and equal to
    the bit on the two stages of a pipe group."""
    y_ref, g_ref, gx_ref = world["jax_toy"]
    params, x = toy_stack()
    blocks = [ToyBlock(p) for p in params]
    xs = torch.from_numpy(x).requires_grad_()
    h = xs
    for b in blocks:
        h = b(h)
    (h ** 2).sum().backward()
    rows = TOY_ROWS // DATA
    for rank, res in enumerate(world["ranks"]):
        sl = slice((rank // PP) * rows, (rank // PP + 1) * rows)
        toy = res["toy"]
        np.testing.assert_allclose(toy["y"].numpy(), y_ref[sl], rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(toy["y"].numpy(), h.detach()[sl].numpy(),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(toy["x_grad"].numpy(), gx_ref[sl],
                                   rtol=1e-5, atol=1e-6)
        other = world["ranks"][rank ^ 1]["toy"]
        for a, b in zip(toy["grads"], other["grads"]):
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for i in range(TOY_BLOCKS):
        for j, name in enumerate(("w", "b")):
            total = sum(world["ranks"][d * PP]["toy"]["grads"][i][j]
                        for d in range(DATA)).numpy()
            np.testing.assert_allclose(total, g_ref[i][j], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{i} {name}")
            np.testing.assert_allclose(
                total, getattr(blocks[i], name).grad.numpy(), rtol=1e-5,
                atol=1e-6)


def test_rows_that_do_not_split_raise_microbatch():
    """10 rows in 3 microbatches (JAX tests/test_pipeline_parallel.py:
    87-94): ValueError naming microbatches, before any communication."""
    axes = port_mesh.Axes(None, 1, pipe_group=None, pipe_size=4, stage=0)
    blocks = [ToyBlock(dict(w=np.eye(4, dtype=np.float32),
                            b=np.zeros(4, np.float32))) for _ in range(4)]
    with pytest.raises(ValueError, match="microbatch"):
        pipeline.pipeline_blocks(blocks, lambda b, h: b(h),
                                 torch.ones(10, 4), 3, axes)
    assert pipeline.pick_microbatches(10, 2) == 5
    assert pipeline.pick_microbatches(768, 2) == 8
    assert pipeline.pick_microbatches(7, 2) == 7


# ------------------------------------------------------------ PP steps
@pytest.mark.parametrize("cluster,mode,accum", CASES)
def test_pp_steps_equal_the_one_process_steps(world, cluster, mode, accum):
    """Both losses, and the whole parameters and Adam moments after each
    of the two steps, on every rank."""
    ref = world["single"][(cluster, accum)]
    for rank, res in enumerate(world["ranks"]):
        got = res["steps"][(cluster, mode, accum)]
        for i in range(2):
            for k in ("loss", "sim_loss", "cluster_loss"):
                np.testing.assert_allclose(
                    got["logs"][i][k], ref["logs"][i][k], rtol=PORT_ATOL,
                    atol=1e-7, err_msg=f"{k} step {i} rank {rank}")
        assert_state_close(got["first"], ref["first"], PORT_ATOL)
        assert_state_close(got, ref, PORT_ATOL)


@pytest.mark.parametrize("cluster", [True, False])
def test_pp_steps_equal_the_jax_steps(world, cluster):
    """Both losses, the first step's clipped gradients (whole on every
    rank: gathered over the pipe group by the schedule, averaged over the
    data group) and the parameters after it against JAX's one-process
    steps, at tests/test_torch_parallel.py's tolerances."""
    losses, jfirst, jgrads = world["jax"][cluster]
    got = world["steps"][(cluster, "pp", 1)]
    np.testing.assert_allclose([g["loss"] for g in got["logs"]], losses,
                               rtol=1e-5)
    # clipped to global norm 1 over the trainable parameters, as JAX's
    # optimizer clips them (the embeddings, conv1 and ln_pre are frozen)
    jgrads = {k: g for k, g in jgrads.items() if k in got["grads"]}
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                       for g in jgrads.values()))
    jgrads = {k: g / max(norm, 1.0) for k, g in jgrads.items()}
    assert sorted(got["grads"]) == sorted(jgrads)
    sensitive = 0
    for path, key, tf in clip4clip_entries(run_config(cluster).model):
        ref = jfirst
        for p in path:
            ref = ref[p]
        ref = np.asarray(ref)
        ref = ref.T if tf == "T" else ref
        held = np.ones(ref.shape, bool)
        if key in jgrads:
            np.testing.assert_allclose(got["grads"][key].numpy(),
                                       jgrads[key], rtol=2e-4, atol=2e-5,
                                       err_msg=key)
            held = np.abs(jgrads[key]) >= 10 * ADAM_EPS
            sensitive += int((~held).sum())
        np.testing.assert_allclose(got["first"]["params"][key].numpy()[held],
                                   ref[held], rtol=0, atol=STEP_ATOL,
                                   err_msg=key)
    # every element's gradient is held above; the parameters skip the
    # elements whose gradient is within 10 eps of zero (1.1 % of the
    # tiny-pipe arch's, whose clipped gradient is small)
    assert sensitive < 2e-2 * sum(
        v.numel() for v in got["first"]["params"].values())


@pytest.mark.parametrize("cluster,mode,accum", CASES)
def test_replicated_parameters_are_equal_to_the_bit(world, cluster, mode,
                                                    accum):
    """After the two steps every parameter and moment is the same on all
    four ranks, to the bit: the stages computed what lies between the
    runs alike, and the whole gradients reached every rank."""
    states = [r["steps"][(cluster, mode, accum)] for r in world["ranks"]]
    for other in states[1:]:
        for k, v in states[0]["params"].items():
            assert torch.equal(other["params"][k], v), k
        for key in ("exp_avg", "exp_avg_sq"):
            for k, v in states[0]["opt_state"][key].items():
                assert torch.equal(other["opt_state"][key][k], v), k


@pytest.mark.parametrize("mode", ["pp", "pp_fsdp"])
def test_stages_take_microbatches_and_cluster_the_same_tokens(world, mode):
    """Every stage ran attention and its block LayerNorms on microbatches
    of its rows (vision 2 clips x 4 frames = 8 rows in M = 8, then 4 rows
    after the cluster layer in M = 4; text 2 rows in M = 2: one row
    each), and the cluster layer's input and output are equal to the bit
    on a pipe group's two stages and differ between the two data
    shards."""
    steps = [r["steps"][(True, mode, 1)] for r in world["ranks"]]
    for got in steps:
        assert {s[0] for s in got["qkv"]} == {1}
        assert {s[1] for s in got["qkv"]} == {5, 4, CTX}
        assert {s[0] for s in got["ln_rows"]} == {1}
    for d in range(DATA):
        a, b = steps[d * PP], steps[d * PP + 1]
        assert torch.equal(a["cluster_in"], b["cluster_in"])
        assert torch.equal(a["cluster_out"], b["cluster_out"])
    assert not torch.equal(steps[0]["cluster_in"], steps[PP]["cluster_in"])


def test_pp_fsdp_equals_pp(world):
    """PP + FSDP against PP (clustering on and off): losses, parameters and
    moments to 1e-5."""
    for cluster in (True, False):
        got = world["steps"][(cluster, "pp_fsdp", 1)]
        ref = world["steps"][(cluster, "pp", 1)]
        for i in range(2):
            np.testing.assert_allclose(got["logs"][i]["loss"],
                                       ref["logs"][i]["loss"],
                                       rtol=PORT_ATOL)
        assert_state_close(got, ref, PORT_ATOL)


# --------------------------------------------------------- checkpoints
def test_pp_checkpoint_loads_strict_into_one_process(world):
    path = os.path.join(world["workdir"], "pp_ckpt", "ckpt_0")
    payload = torch.load(path, weights_only=True)
    model = port_model(True, world["inits"][True])
    model.load_state_dict(payload["params"], strict=True)
    ref = world["steps"][(True, "pp", 1)]["first"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, ref["params"][k]), k
    for key in ("exp_avg", "exp_avg_sq"):
        for k, v in ref["opt_state"][key].items():
            assert torch.equal(payload["opt_state"][key][k], v), k


def test_resume_across_the_pp_and_one_process_layouts(world):
    """The one-process checkpoint resumed into a PP + FSDP run, and the PP
    run's checkpoint resumed into one process: each steps on to the
    one-process run's second step."""
    two = world["single"][(True, 1)]
    for res in world["ranks"]:
        assert res["resumed"]["step"] == 2
        np.testing.assert_allclose(res["resumed"]["logs"]["loss"],
                                   two["logs"][1]["loss"], rtol=PORT_ATOL)
        assert_state_close(res["resumed"], two, PORT_ATOL)
    trainer = Trainer(run_config(True), port_model(True, world["inits"][True]),
                      total_steps=4)
    resume(os.path.join(world["workdir"], "pp_ckpt", "ckpt_0"),
           trainer.state)
    one_step(trainer, step_batches(1, 1), 1)
    assert_state_close(host_state(trainer.state), two, PORT_ATOL)


# --------------------------------------------- the 4-process `main`
MAIN_ARCH = "tiny-pipe-main"
port_config.CLIP_ARCHS[MAIN_ARCH] = dict(
    port_config.CLIP_ARCHS["tiny-parallel"], vision_layers=4,
    transformer_layers=4)
MAIN_FLAGS = ["--pretrained_clip_name", MAIN_ARCH,
              "--cluster_num_blocks", "3", "3", "3", "3",
              "--target_frames_blocks", "4", "4", "2", "2"]


@pytest.fixture(scope="module")
def one_process_pipe_main(msrvtt_root, tmp_path_factory):
    out = tmp_path_factory.mktemp("pipe_main_one_process")
    run_main(main_argv(msrvtt_root, out, MAIN_FLAGS))
    return out


def test_four_process_main_with_pipeline_parallelism(
        msrvtt_root, one_process_pipe_main, tmp_path):
    """torchrun with 4 processes as (data 2, pipe 2), `--pipeline_parallel
    2` on a 4 + 4-block arch (two vision runs of 2 blocks): every rank exits
    0 with the same loss, rank 0 alone logs and writes, the evaluation's
    encode is spread over the 4 ranks, and the losses, the R@1 and the
    export are the one-process run's at the same global batch of 8."""
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(WORLD), os.path.abspath(__file__),
           str(msrvtt_root), str(out), "--pipeline_parallel", str(PP)]
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=WORLD_TIMEOUT)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-6000:]
    losses = {int(r): float(v) for r, v in re.findall(
        r"rank (\d) epoch 0 mean_loss=(\d+\.\d+)", res.stdout)}
    assert sorted(losses) == list(range(WORLD)), res.stdout
    assert max(losses.values()) - min(losses.values()) < 1e-4
    r0 = out / "r0"
    log0 = (r0 / "log.txt").read_text()
    assert f"processes: {WORLD}" in log0 and "Text-to-Video: R@1" in log0
    assert {"ckpt_0", "ckpt.pth.tar", "log.txt"} <= set(os.listdir(r0))
    for r in range(1, WORLD):
        assert not {"ckpt_0", "ckpt.pth.tar", "log.txt"} & set(
            os.listdir(out / f"r{r}"))
    np.testing.assert_allclose(sim_losses(r0),
                               sim_losses(one_process_pipe_main), rtol=1e-5)
    r1 = re.findall(r"Text-to-Video: R@1: ([\d.]+)", log0)
    assert r1 == re.findall(r"Text-to-Video: R@1: ([\d.]+)", (
        one_process_pipe_main / "log.txt").read_text())
    sd = torch.load(r0 / "ckpt.pth.tar", weights_only=False)["state_dict"]
    ref = torch.load(one_process_pipe_main / "ckpt.pth.tar",
                     weights_only=False)["state_dict"]
    assert sorted(sd) == sorted(ref)
    from centerclip_tpu_torch.cli import parse_args
    model = CLIP4Clip(parse_args(main_argv(msrvtt_root, out, MAIN_FLAGS)
                                 ).model, device="cpu")
    model.load_state_dict(sd, strict=True)
    for k, v in ref.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0,
                                   atol=PORT_ATOL, err_msg=k)


if __name__ == "__main__":
    # the 4-process `main` worker: each rank writes to <out>/r<rank>
    data_root, out_dir, *flags = sys.argv[1:]
    rank_out = os.path.join(out_dir, f"r{os.environ['RANK']}")
    torch.set_num_threads(1)
    import pathlib
    run_main(main_argv(pathlib.Path(data_root), rank_out,
                       MAIN_FLAGS + flags))
