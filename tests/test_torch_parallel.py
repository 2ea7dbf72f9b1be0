# coding=utf-8
"""The port's data axis (`centerclip_tpu_torch.parallel`: DDP, FSDP, the
global-batch loss, multi-process `main`) against the JAX package, on the
CPU, in worlds of 2 gloo processes.

One world (`torch.multiprocessing`, spawn, a free port, a time limit) runs
every multi-rank case and hands its results back through files; the tests
check them against the port's one-process step and the JAX package's
one-process step at the same global batch.  The model is the tiny-e2e
arch of tests/test_main_e2e.py (2 + 2 blocks of width 32, 4 frames -> 2
segments, K = 3, fp32; k-medoids is deterministic, so no random draw
differs).  Rank r takes rows [r * b, (r + 1) * b) of each global batch of
4, so the gathered batch is the one-process batch in its order.

Tolerances: a DP or FSDP step against the port's one-process step, loss
and parameters to 1e-5 (the same arithmetic; the gradients' sums over the
ranks are taken in another order); against JAX, tests/test_torch_train.py's
(loss rtol 1e-5, gradients rtol 2e-4 / atol 2e-5, parameters 2e-2 x lr,
the last on the elements whose gradient is not within 10 eps of zero:
see `test_dp_step_equals_the_jax_step`).  The collectives against JAX's
under `shard_map` on 2 of the 8 host devices: forward exact, gradient
1e-5.

Run as a script, this file is the worker of the two-process `main` test:
`python -m torch.distributed.run --standalone --nproc_per_node 2
tests/test_torch_parallel.py <data root> <out dir> [flags]`.
"""
import dataclasses
import json
import os
import re
import socket
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
from jax import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from centerclip_tpu import config as jax_config  # noqa: E402
from centerclip_tpu.models.clip4clip import CLIP4Clip as JaxCLIP4Clip  # noqa
from centerclip_tpu.parallel import collectives as jax_collectives  # noqa
from centerclip_tpu.parallel import mesh as jax_mesh  # noqa: E402
from centerclip_tpu.train import loop as jax_loop  # noqa: E402
from centerclip_tpu.train import optim as jax_optim  # noqa: E402
from centerclip_tpu.train import state as jax_state  # noqa: E402
from centerclip_tpu_torch import config as port_config  # noqa: E402
from centerclip_tpu_torch import parallel  # noqa: E402
from centerclip_tpu_torch.data.loader import BatchLoader  # noqa: E402
from centerclip_tpu_torch.models.clip4clip import CLIP4Clip  # noqa: E402
from centerclip_tpu_torch.models.weights import (  # noqa: E402
    clip4clip_entries, state_dict_from_jax_params)
from centerclip_tpu_torch.train import (AverageMeter, Trainer,  # noqa: E402
                                        host_state, make_train_step, resume,
                                        save_checkpoint)
from centerclip_tpu_torch.train.evaluate import Evaluator  # noqa: E402

ARCH = "tiny-parallel"
TINY = dict(embed_dim=16, image_resolution=32, vision_layers=2,
            vision_width=32, vision_patch_size=16, vision_heads=2,
            context_length=12, vocab_size=49408, transformer_width=32,
            transformer_heads=2, transformer_layers=2)
jax_config.CLIP_ARCHS[ARCH] = TINY
port_config.CLIP_ARCHS[ARCH] = TINY
T, RES, CTX, VOCAB = 4, 32, 12, 49408
WORLD, GLOBAL_BATCH = 2, 4
LR = 1e-3
STEP_ATOL = 2e-2 * LR                 # tests/test_torch_train.py:49-60
ADAM_EPS = 1e-6                       # OptimConfig.eps
PORT_ATOL = 1e-5
WORLD_TIMEOUT = 300                   # seconds for one spawned world
HEADERS = ("meanP", "seqTransf")
ACCUMS = (1, 2)
CASES = [(h, a) for h in HEADERS for a in ACCUMS]


def config_kw(**over):
    kw = dict(clip_name=ARCH, max_frames=T, max_words=CTX,
              compute_dtype="float32", inter=True, algo="kmediods++",
              cluster_num_blocks=(3, 3), target_frames_blocks=(T, T // 2),
              optim="AdamW", lr=LR, coef_lr=0.5, weight_decay=0.2,
              warmup_proportion=0.0, cross_num_hidden_layers=2)
    kw.update(over)
    return kw


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


EVAL_CUTS = [2, 5, 6, 9, 12, 15]     # 15 captions of 6 videos


def metrics_json(metrics):
    """A metrics dict as JSON text (numpy scalars and arrays as lists)."""
    return json.dumps(metrics, sort_keys=True, default=lambda o: o.tolist())


def eval_batches():
    """Five evaluation batches of 3 rows (uneven over 2 ranks: 3 + 2)."""
    return [make_batch(30 + i, n=3) for i in range(5)]


def eval_loader():
    """`eval_batches` through a BatchLoader over their 15 rows, as a
    spread evaluation takes them."""
    rows = [{k: v[i] for k, v in b.items()} for b in eval_batches()
            for i in range(3)]
    return BatchLoader(rows, batch_size=3)


def global_step_batches(accum, first_seed=10):
    """One optimizer step's global batches: a batch, or `accum`
    micro-batches."""
    mbs = [make_batch(first_seed + i) for i in range(accum)]
    return mbs[0] if accum == 1 else mbs


def rank_rows(batch, rank, world=WORLD):
    """Rank `rank`'s contiguous rows of a global batch (or of each
    micro-batch)."""
    if isinstance(batch, list):
        return [rank_rows(b, rank, world) for b in batch]
    b = len(batch["input_ids"]) // world
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}


def run_config(header, accum, **over):
    return port_config.make_run_config(**config_kw(
        sim_header=header, gradient_accumulation_steps=accum, **over))


def port_model(header, init_sd):
    model = CLIP4Clip(run_config(header, 1).model, device="cpu")
    model.load_state_dict(init_sd, strict=True)
    return model


def one_step(trainer, batch, accum):
    logs = make_train_step(trainer.module, trainer.optimizer, accum)(batch)
    trainer.state.global_step += 1
    return {k: float(v) for k, v in logs.items()}


# ------------------------------------------------------------ the world
def _collectives_case(rank, world):
    """all_gather_local_grads, all_gather and psum on this rank's rows of
    the inputs the JAX test gives them."""
    x = np.random.default_rng(42).normal(size=(world * 2, 4)).astype(
        np.float32)
    xs = torch.from_numpy(x[rank * 2:(rank + 1) * 2].copy()).requires_grad_()
    g = parallel.all_gather_local_grads(xs)
    (g * g).sum().backward()
    y = np.random.default_rng(7).normal(size=(world, 3)).astype(np.float32)
    ys = torch.from_numpy(y[rank:rank + 1].copy())
    return {"gathered": g.detach(), "grad": xs.grad,
            "all_gather": parallel.all_gather(ys),
            "psum": parallel.psum(ys.sum())}


def _world(rank, world, port, workdir):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(2)
    parallel.init_distributed("cpu")
    out = {"collectives": _collectives_case(rank, world)}
    meter = AverageMeter()
    meter.update(2.0 + 3.0 * rank, n=3 - 2 * rank)
    meter.synchronize_between_processes()
    out["meter"] = (meter.count, meter.sum, meter.avg)
    inits = torch.load(os.path.join(workdir, "init.pt"))
    model = port_model("meanP", inits["meanP"])
    out["eval"] = {}
    for multi in (False, True):
        res = Evaluator(model).evaluate(
            eval_loader(), multi_sentence=multi,
            cut_off_points=EVAL_CUTS if multi else None)
        if rank == 0:       # tensors and floats, for `torch.load`
            out["eval"][multi] = {
                "sim_matrix": torch.from_numpy(res["sim_matrix"]),
                **{k: metrics_json(res[k]) for k in ("t2v", "v2t")}}
        else:
            assert res is None
    steps = {}
    for header, accum in CASES:
        for fsdp in (False, True):
            model = port_model(header, inits[header])
            trainer = Trainer(run_config(header, accum, fsdp=fsdp), model,
                              total_steps=4)
            logs = one_step(trainer, rank_rows(global_step_batches(accum),
                                               rank), accum)
            shards = {n: (parallel.mesh.local(p).numel(), p.numel())
                      for n, p in model.named_parameters()
                      if parallel.mesh.is_shard(p)}
            # the clipped gradients the update used (whole under DDP)
            grads = {} if fsdp else {n: p.grad.clone() for n, p in
                                     model.named_parameters()
                                     if p.grad is not None}
            steps[(header, accum, fsdp)] = dict(
                logs=logs, shards=shards, grads=grads,
                **host_state(trainer.state))
            if fsdp and (header, accum) == ("meanP", 1):
                # an FSDP run's checkpoint, written by rank 0
                host = host_state(trainer.state)
                if rank == 0:
                    save_checkpoint(os.path.join(workdir, "fsdp_ckpt"),
                                    trainer.state, 0, 0.0, host=host)
                parallel.process_barrier("fsdp_ckpt")
    out["steps"] = steps
    # a one-process checkpoint resumed into an FSDP run
    model = port_model("meanP", inits["meanP"])
    trainer = Trainer(run_config("meanP", 1, fsdp=True), model,
                      total_steps=4)
    resume(os.path.join(workdir, "single_ckpt", "ckpt_0"), trainer.state)
    logs = one_step(trainer, rank_rows(make_batch(20), rank), 1)
    out["resumed"] = dict(logs=logs, step=trainer.state.global_step,
                          **host_state(trainer.state))
    if rank == 0:
        torch.save(out, os.path.join(workdir, "world.pt"))
    parallel.process_barrier("done")
    torch.distributed.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_world(fn, *args, world=WORLD, timeout=WORLD_TIMEOUT):
    """Run fn(rank, world, port, *args) in `world` spawned processes; fail
    on an error in any of them or after `timeout` seconds."""
    ctx = mp.start_processes(fn, args=(world, _free_port()) + args,
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.time() + timeout
    while not ctx.join(timeout=1.0):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"a world of {world} processes ran past {timeout} s")


# ---------------------------------------------------------- references
def jax_params(header):
    jrun = jax_config.make_run_config(**config_kw(sim_header=header))
    b = make_batch(0, n=2)
    params = JaxCLIP4Clip(jrun.model).init(
        jax.random.PRNGKey(0), input_ids=b["input_ids"],
        video=b["video"].astype(np.float32), video_mask=b["video_mask"],
        training=True)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def jax_clipped_grads(header, accum, params, keys):
    """The JAX package's gradient of the step at the global batch (the mean
    over the micro-batches), by torch key, clipped to global norm 1 over
    the trainable `keys` as its optimizer clips it."""
    jrun = jax_config.make_run_config(**config_kw(sim_header=header))
    jmodel = JaxCLIP4Clip(jrun.model)
    batches = global_step_batches(accum)
    batches = batches if isinstance(batches, list) else [batches]

    def loss_fn(p, b):
        return jmodel.apply({"params": p}, **b, training=True,
                            rng=jax.random.PRNGKey(0))["loss"]
    grad_fn = jax.jit(jax.grad(loss_fn))
    grads = [grad_fn(params, b) for b in batches]
    mean = jax.tree_util.tree_map(lambda *g: sum(g) / len(g), *grads)
    out = {}
    for path, key, tf in clip4clip_entries(run_config(header, 1).model):
        if key in keys:
            g = mean
            for p in path:
                g = g[p]
            g = np.asarray(g)
            out[key] = g.T if tf == "T" else g
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                       for g in out.values()))
    return {k: g / max(norm, 1.0) for k, g in out.items()}


def jax_step(header, accum, params):
    jrun = jax_config.make_run_config(**config_kw(
        sim_header=header, gradient_accumulation_steps=accum))
    tx = jax_optim.build_optimizer(jrun.optim, params, total_steps=4,
                                   freeze_layer_num=jrun.freeze_layer_num,
                                   freeze_clip=jrun.freeze_clip)
    state = jax_state.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, params), tx)
    step = jax_loop.make_train_step(JaxCLIP4Clip(jrun.model), tx,
                                    accum_steps=accum)
    state, log = step(state, global_step_batches(accum),
                      jax.random.PRNGKey(0))
    return float(log["loss"]), jax.tree_util.tree_map(np.asarray,
                                                      state.params)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Everything the tests compare: the JAX inits and one-process steps,
    the port's one-process steps, and the world's results."""
    workdir = str(tmp_path_factory.mktemp("parallel_world"))
    jparams = {h: jax_params(h) for h in HEADERS}
    inits = {h: state_dict_from_jax_params(
        jparams[h], run_config(h, 1).model) for h in HEADERS}
    torch.save(inits, os.path.join(workdir, "init.pt"))
    single = {}
    for header, accum in CASES:
        trainer = Trainer(run_config(header, accum),
                          port_model(header, inits[header]), total_steps=4)
        logs = one_step(trainer, global_step_batches(accum), accum)
        single[(header, accum)] = dict(logs=logs, **host_state(trainer.state))
        if (header, accum) == ("meanP", 1):
            save_checkpoint(os.path.join(workdir, "single_ckpt"),
                            trainer.state, 0, 0.0)
            one_step(trainer, make_batch(20), 1)
            single["two_steps"] = host_state(trainer.state)
    spawn_world(_world, workdir)
    out = torch.load(os.path.join(workdir, "world.pt"))
    return dict(workdir=workdir, jparams=jparams, inits=inits, single=single,
                **out)


def assert_state_close(got, ref, atol, moments=True):
    assert sorted(got["params"]) == sorted(ref["params"])
    for k, v in ref["params"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(),
                                   rtol=0, atol=atol, err_msg=k)
    if moments:
        assert got["opt_state"]["step"] == ref["opt_state"]["step"]
        for key in ("exp_avg", "exp_avg_sq"):
            for k, v in ref["opt_state"][key].items():
                got_v = got["opt_state"][key][k].numpy()
                np.testing.assert_allclose(
                    got_v, v.numpy(), rtol=1e-5,
                    atol=1e-5 * float(np.abs(v.numpy()).max()) + 1e-30,
                    err_msg=f"{key} {k}")


# --------------------------------------------------------- collectives
def test_all_gather_local_grads_matches_jax(world):
    """Forward: every rank's rows, in rank order; backward: only the local
    slot, so each rank's gradient of sum(g * g) is 2x its rows."""
    mesh = jax_mesh.create_mesh(WORLD)
    x = np.random.default_rng(42).normal(size=(WORLD * 2, 4)).astype(
        np.float32)

    def per_device_loss(xs):
        g = jax_collectives.all_gather_local_grads(xs, "data")
        return jnp.sum(g * g)[None], g[None]

    f = shard_map(per_device_loss, mesh=mesh, in_specs=P("data"),
                  out_specs=(P("data"), P("data")))
    _, gathered = f(jnp.asarray(x))
    grad = jax.grad(lambda xx: f(xx)[0].sum())(jnp.asarray(x))
    got = world["collectives"]
    np.testing.assert_array_equal(got["gathered"].numpy(),
                                  np.asarray(gathered)[0])
    # the world saved rank 0's result: its rows of the JAX gradient
    np.testing.assert_allclose(got["grad"].numpy(), np.asarray(grad)[:2],
                               rtol=1e-5)
    np.testing.assert_allclose(got["grad"].numpy(), 2 * x[:2], rtol=1e-5)


def test_all_gather_and_psum_match_jax(world):
    mesh = jax_mesh.create_mesh(WORLD)
    y = np.random.default_rng(7).normal(size=(WORLD, 3)).astype(np.float32)

    def fn(ys):
        return (jax_collectives.all_gather(ys, "data")[None],
                jax_collectives.psum(jnp.sum(ys), "data")[None])

    g, s = shard_map(fn, mesh=mesh, in_specs=P("data"),
                     out_specs=(P("data"), P("data")))(jnp.asarray(y))
    got = world["collectives"]
    np.testing.assert_array_equal(got["all_gather"].numpy(),
                                  np.asarray(g)[0])
    np.testing.assert_allclose(float(got["psum"]), float(np.asarray(s)[0]),
                               rtol=1e-6)


# (JAX tests/test_collectives.py:60-93: process count, index, local
# devices, tensor / pipeline extent)
GEOMETRY_CASES = [
    (2, 1, 4, {}), (2, 1, 4, {"tensor_parallel": 2}),
    (2, 1, 1, {"tensor_parallel": 2}), (2, 0, 1, {"tensor_parallel": 2}),
    (4, 3, 2, {"pipeline_parallel": 4}), (4, 1, 2, {"pipeline_parallel": 4}),
    (3, 0, 2, {"tensor_parallel": 3}), (1, 0, 8, {"tensor_parallel": 8})]


@pytest.mark.parametrize("pc,pi,local,extents", GEOMETRY_CASES)
def test_data_shard_geometry_matches_jax(monkeypatch, pc, pi, local,
                                         extents):
    monkeypatch.setattr(jax, "process_count", lambda: pc)
    monkeypatch.setattr(jax, "process_index", lambda: pi)
    monkeypatch.setattr(jax, "local_device_count", lambda: local)
    try:
        ref = jax_mesh.data_shard_geometry(**extents)
    except ValueError:
        with pytest.raises(ValueError, match="fractional process"):
            parallel.data_shard_geometry(**extents, count=pc, index=pi,
                                         local_devices=local)
        return
    assert parallel.data_shard_geometry(
        **extents, count=pc, index=pi, local_devices=local) == ref


@pytest.mark.parametrize("multi", [False, True])
def test_spread_evaluation_equals_one_process(world, multi):
    """Phase 1 spread over the 2 ranks (batches 0, 2, 4 on rank 0, 1 and 3
    on rank 1; multi-sentence: 15 captions of 6 videos), gathered to rank 0
    in the loader's order: rank 0's similarity matrix within 1e-6 of one
    process's, and the same metrics."""
    got = world["eval"][multi]
    ref = Evaluator(port_model("meanP", world["inits"]["meanP"])).evaluate(
        eval_batches(), multi_sentence=multi,
        cut_off_points=EVAL_CUTS if multi else None)
    assert got["sim_matrix"].shape == ref["sim_matrix"].shape == (
        (15, 6) if multi else (15, 15))
    np.testing.assert_allclose(got["sim_matrix"].numpy(), ref["sim_matrix"],
                               rtol=0, atol=1e-6)
    for k in ("t2v", "v2t"):
        assert got[k] == metrics_json(ref[k])


def test_average_meter_syncs_over_the_ranks(world):
    # rank 0: 3 x 2.0, rank 1: 1 x 5.0
    assert world["meter"] == (4, 11.0, 2.75)
    meter = AverageMeter()
    meter.update(2.0, n=3)
    meter.synchronize_between_processes()        # one process: no-op
    assert (meter.count, meter.sum) == (3, 6.0)


# ------------------------------------------------------------- DP steps
@pytest.mark.parametrize("header,accum", CASES)
def test_dp_step_equals_the_one_process_step(world, header, accum):
    got = world["steps"][(header, accum, False)]
    ref = world["single"][(header, accum)]
    np.testing.assert_allclose(got["logs"]["loss"], ref["logs"]["loss"],
                               rtol=PORT_ATOL)
    np.testing.assert_allclose(got["logs"]["sim_loss"],
                               ref["logs"]["sim_loss"], rtol=PORT_ATOL)
    assert_state_close(got, ref, PORT_ATOL)
    moved = [k for k, v in got["params"].items()
             if not torch.equal(v, world["inits"][header][k])]
    assert "clip.logit_scale" in moved and len(moved) > 20


@pytest.mark.parametrize("header,accum", CASES)
def test_dp_step_equals_the_jax_step(world, header, accum):
    """Loss (rtol 1e-5), every clipped gradient (fp32: rtol 2e-4, atol
    2e-5) and every updated parameter (2e-2 x lr) against JAX's one-process
    step.  A first Adam step moves an element by lr * g / (|g| + eps): where
    |g| is within a few eps = 1e-6 of zero, fp32 rounding of g moves it by
    up to ~5e-2 lr (the port's one-process step shows the same, 2.66e-5 at
    one of these elements), so those elements are held by their gradient
    alone."""
    loss, jparams = jax_step(header, accum, world["jparams"][header])
    got = world["steps"][(header, accum, False)]
    np.testing.assert_allclose(got["logs"]["loss"], loss, rtol=1e-5)
    jgrads = jax_clipped_grads(header, accum, world["jparams"][header],
                               set(got["grads"]))
    assert sorted(jgrads) == sorted(got["grads"])
    sensitive = 0
    sd = got["params"]
    for path, key, tf in clip4clip_entries(run_config(header, 1).model):
        ref = jparams
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
        np.testing.assert_allclose(sd[key].numpy()[held], ref[held], rtol=0,
                                   atol=STEP_ATOL, err_msg=key)
    assert sensitive < 1e-3 * sum(v.numel() for v in sd.values())


# ---------------------------------------------------------------- FSDP
@pytest.mark.parametrize("header,accum", CASES)
def test_fsdp_step_equals_dp(world, header, accum):
    """Loss, parameters and Adam moments, gathered; each rank holds its
    half of every sharded parameter."""
    got = world["steps"][(header, accum, True)]
    ref = world["steps"][(header, accum, False)]
    for k in ("loss", "sim_loss", "cluster_loss"):
        np.testing.assert_allclose(got["logs"][k], ref["logs"][k],
                                   rtol=PORT_ATOL)
    assert_state_close(got, ref, PORT_ATOL)
    shards = got["shards"]
    assert len(shards) > 20 and "clip.logit_scale" not in shards
    for name, (n_local, n_full) in shards.items():
        rows = got["params"][name].shape[0]
        assert n_local == n_full // rows * -(-rows // WORLD), name


def test_fsdp_checkpoint_loads_strict_into_one_process(world):
    path = os.path.join(world["workdir"], "fsdp_ckpt", "ckpt_0")
    payload = torch.load(path, weights_only=True)
    model = port_model("meanP", world["inits"]["meanP"])
    model.load_state_dict(payload["params"], strict=True)
    ref = world["steps"][("meanP", 1, True)]
    for k, v in model.state_dict().items():
        assert torch.equal(v, ref["params"][k]), k
    assert sorted(payload["opt_state"]["exp_avg"]) == sorted(
        ref["opt_state"]["exp_avg"])


def test_resume_across_the_two_layouts(world, tmp_path):
    """A one-process checkpoint resumed into an FSDP run, and an FSDP run's
    checkpoint resumed into one process, each step on to the one-process
    run's second step."""
    two = world["single"]["two_steps"]
    fsdp = world["resumed"]
    assert fsdp["step"] == 2
    assert_state_close(fsdp, two, PORT_ATOL)
    trainer = Trainer(run_config("meanP", 1),
                      port_model("meanP", world["inits"]["meanP"]),
                      total_steps=4)
    resume(os.path.join(world["workdir"], "fsdp_ckpt", "ckpt_0"),
           trainer.state)
    one_step(trainer, make_batch(20), 1)
    assert_state_close(host_state(trainer.state), two, PORT_ATOL)


# ------------------------------------------------------------------ F1
@pytest.mark.parametrize("over,error,match", [
    ({"tensor_parallel": 2}, ValueError,
     "model extent 2 does not divide the 1 process"),
    ({"tensor_parallel": 3, "sequence_parallel": True}, ValueError,
     r"model extent 3 does not divide the \[2\] heads"),
    ({"pipeline_parallel": 2}, ValueError,
     "pipe extent 2 does not divide the 1 process"),
    ({"data_parallel": 3}, ValueError, "data extent 3")])
def test_trainer_refuses_what_it_does_not_run(over, error, match):
    """The trainer reads the parallel fields: a config from
    `make_run_config` that asks for a model or pipe extent that does not
    divide the world of 1 or the tiny arch's 2 heads, or for 3 processes
    in a world of 1, raises."""
    model = CLIP4Clip(run_config("meanP", 1).model, device="cpu")
    with pytest.raises(error, match=match):
        Trainer(run_config("meanP", 1, **over), model, total_steps=1)


def test_serve_cli_refuses_data_parallel(tmp_path):
    """`--data_parallel 2` runs the flat index over two cards; with an IVF
    index it raises, as JAX's does with a mesh (`serve/engine.py:303-306`,
    `serve/ivf.py:505-508`), for `build` and for a saved IVF index, before
    the model loads."""
    from centerclip_tpu_torch.serve import cli as serve_cli
    from centerclip_tpu_torch.serve.ivf import IVFVideoIndex
    path = str(tmp_path / "ivf.npz")
    emb = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    IVFVideoIndex(emb, [f"v{i}" for i in range(16)], n_clusters=2,
                  device="cpu").save(path)
    for argv in (["query", "--index_path", path],
                 ["build", "--index_path", "unused.npz", "--index_type",
                  "ivf"]):
        with pytest.raises(ValueError, match="single-device"):
            serve_cli.main(argv + ["--output_dir", str(tmp_path / "out"),
                                   "--data_parallel", "2"], device="cpu")


# ------------------------------------------------- two-process `main`
N_VIDEOS, N_CAPTIONS = 9, 3          # 27 pairs: the 2-way shard pads


@pytest.fixture(scope="module")
def msrvtt_root(tmp_path_factory):
    """tests/test_torch_main.py's tiny MSR-VTT with 9 videos and 3 captions
    each: 27 training pairs, so each rank's shard wraps around by one."""
    import pandas as pd
    root = tmp_path_factory.mktemp("msrvtt_parallel")
    rng = np.random.default_rng(0)
    vids = [f"video{i}" for i in range(N_VIDEOS)]
    (root / "videos").mkdir()
    for v in vids:
        np.save(root / "videos" / f"{v}.npy",
                rng.integers(0, 255, size=(10, 40, 48, 3)).astype(np.uint8))
    pd.DataFrame({"video_id": vids,
                  "sentence": [f"a clip about thing {i}" for i in
                               range(len(vids))]}).to_csv(
        root / "test.csv", index=False)
    pd.DataFrame({"video_id": vids}).to_csv(root / "train.csv", index=False)
    corpus = {"sentences": [{"video_id": v, "caption": f"{v} doing stuff {j}"}
                            for v in vids for j in range(N_CAPTIONS)],
              "videos": [{"video_id": v, "url": f"u?v=p{v}"} for v in vids]}
    with open(root / "MSRVTT_data.json", "w") as f:
        json.dump(corpus, f)
    return root


def main_argv(root, out, extra=()):
    return [
        "--do_train", "1", "--do_eval", "1", "--datatype", "msrvtt",
        "--train_csv", str(root / "train.csv"),
        "--val_csv", str(root / "test.csv"),
        "--data_path", str(root / "MSRVTT_data.json"),
        "--features_path", str(root / "videos"), "--video_suffix", ".npy",
        "--output_dir", str(out), "--pretrained_clip_name", ARCH,
        "--pretrained_dir", str(root / "no_weights"),
        "--max_words", "12", "--max_frames", "4",
        "--batch_size", "8", "--batch_size_val", "4", "--epochs", "1",
        "--optim", "AdamW", "--lr", str(LR), "--loose_type",
        "--sim_header", "meanP", "--expand_msrvtt_sentences",
        "--cluster_inter", "1", "--cluster_algo", "kmediods++",
        "--cluster_num_blocks", "3", "3", "--target_frames_blocks", "4", "2",
        "--precision", "fp32", "--num_thread_reader", "2", "--n_display", "1",
    ] + list(extra)


def run_main(argv):
    """The port's `main` on the CPU with the tiny arch's image size (as
    tests/test_main_e2e.py:94-111 forces it)."""
    from centerclip_tpu_torch import cli
    from centerclip_tpu_torch.main import main
    orig = cli.args_to_run_config

    def patched(args):
        cfg = orig(args)
        return dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, image_resolution=RES))
    cli.args_to_run_config = patched
    try:
        return main(argv, device="cpu")
    finally:
        cli.args_to_run_config = orig


def sim_losses(out):
    with open(os.path.join(out, "tensorboard", "scalars.jsonl")) as f:
        return [json.loads(line)["train/sim_loss"] for line in f]


@pytest.fixture(scope="module")
def one_process_main(msrvtt_root, tmp_path_factory):
    out = tmp_path_factory.mktemp("main_one_process")
    run_main(main_argv(msrvtt_root, out))
    return out


@pytest.mark.parametrize("fsdp", [0, 1])
def test_two_process_main(msrvtt_root, one_process_main, tmp_path, fsdp):
    """torchrun with 2 processes on the CPU (JAX
    tests/test_multiprocess.py:70-117): both ranks exit 0 and agree on the
    loss, rank 0 alone logs, evaluates and writes, and the losses are the
    one-process run's at the same global batch of 8."""
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", os.path.abspath(__file__),
           str(msrvtt_root), str(out), "--fsdp", str(fsdp)]
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2"}
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=WORLD_TIMEOUT)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-6000:]
    losses = {int(r): float(v) for r, v in re.findall(
        r"rank (\d) epoch 0 mean_loss=(\d+\.\d+)", res.stdout)}
    assert sorted(losses) == [0, 1], res.stdout
    assert abs(losses[0] - losses[1]) < 1e-4
    r0, r1 = out / "r0", out / "r1"
    log0 = (r0 / "log.txt").read_text()
    assert "processes: 2" in log0 and "Text-to-Video: R@1" in log0
    assert {"ckpt_0", "ckpt.pth.tar", "log.txt"} <= set(os.listdir(r0))
    assert not {"ckpt_0", "ckpt.pth.tar", "log.txt"} & set(os.listdir(r1))
    np.testing.assert_allclose(sim_losses(r0), sim_losses(one_process_main),
                               rtol=1e-5)
    sd = torch.load(r0 / "ckpt.pth.tar", weights_only=False)["state_dict"]
    ref = torch.load(one_process_main / "ckpt.pth.tar",
                     weights_only=False)["state_dict"]
    for k, v in ref.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0,
                                   atol=PORT_ATOL, err_msg=k)


if __name__ == "__main__":
    # the two-process `main` worker: each rank writes to <out>/r<rank>
    data_root, out_dir, *flags = sys.argv[1:]
    rank_out = os.path.join(out_dir, f"r{os.environ['RANK']}")
    torch.set_num_threads(2)
    import pathlib
    run_main(main_argv(pathlib.Path(data_root), rank_out, flags))
