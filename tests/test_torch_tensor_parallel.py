# coding=utf-8
"""The port's model axis (`centerclip_tpu_torch.parallel`: tensor and
sequence parallelism, the Megatron operators, TP-sliced checkpoints,
`main --tensor_parallel`) against the JAX package, on the CPU, in a world
of 4 gloo processes as a `(data 2, model 2)` mesh.

One world (`torch.multiprocessing`, spawn, a free port, a time limit) runs
every multi-rank case and hands its results back through files (each rank
its own); the tests check them against the port's one-process step and
the JAX package's one-process step at the same global batch.  The model is
tests/test_torch_parallel.py's tiny-parallel arch: 2 + 2 blocks of width
32 with 2 heads (1 a rank), 4 frames -> 2 segments, K = 3, fp32.  Its
vision stream has L = 5 tokens (4 patches and CLS), which the model axis
of 2 splits unevenly (3 + 2, padded to 3 + 3), and 4 after the cluster
layer; its text stream 12.  Ranks 2d and 2d + 1 form model group d and
take rows [2 d, 2 d + 2) of each global batch of 4, so the gathered batch
is the one-process batch in its order.  k-medoids is deterministic on
these inputs: no medoid id needs replaying.

Tolerances: tests/test_torch_parallel.py's.  A TP, TP + SP or TP + SP +
FSDP step against the port's one-process step, loss and parameters to
1e-5 (the same arithmetic; the row-parallel products are summed over the
model group in another order); against JAX, loss rtol 1e-5, every
clipped gradient rtol 2e-4 / atol 2e-5, every parameter 2e-2 x lr where
the gradient is not within 10 eps of zero.  The Megatron operators
against the one-process sums: 1e-6; the slices and their gather: to the
bit.

Run as a script, this file is the worker of the 4-process `main` test:
`python -m torch.distributed.run --standalone --nproc_per_node 4
tests/test_torch_tensor_parallel.py <data root> <out dir> [flags]`.
"""
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

from centerclip_tpu_torch import parallel  # noqa: E402
from centerclip_tpu_torch.models import layers  # noqa: E402
from centerclip_tpu_torch.models.weights import (  # noqa: E402
    clip4clip_entries, state_dict_from_jax_params)
from centerclip_tpu_torch.parallel import mesh as port_mesh  # noqa: E402
from centerclip_tpu_torch.train import (Trainer, host_state,  # noqa: E402
                                        resume, save_checkpoint)
from tests.test_torch_parallel import (  # noqa: E402
    ADAM_EPS, PORT_ATOL, STEP_ATOL, assert_state_close,
    jax_clipped_grads, jax_params, jax_step, main_argv, make_batch,
    msrvtt_root, one_process_main, one_step, port_model, run_config,
    run_main, sim_losses)

WORLD, TP = 4, 2
DATA = WORLD // TP
GLOBAL_BATCH = 4
WORLD_TIMEOUT = 300                   # seconds for the spawned world
HEADERS = ("meanP", "seqTransf")
MODES = {"tp": {}, "tp_sp": {"sequence_parallel": True},
         "tp_sp_fsdp": {"sequence_parallel": True, "fsdp": True}}
CASES = [(h, m) for h in HEADERS for m in MODES]
OP_ATOL = 1e-6
L_VISION, WIDTH = 5, 32


def rank_rows(batch, rank):
    """Model group rank // TP's rows of a global batch."""
    b = GLOBAL_BATCH // DATA
    d = rank // TP
    return {k: v[d * b:(d + 1) * b] for k, v in batch.items()}


def tp_config(header, mode):
    return run_config(header, 1, tensor_parallel=TP, **MODES[mode])


# ------------------------------------------------------------ the world
def op_inputs():
    """The operators' inputs, the same on every rank: a whole stream x
    [2, L_VISION, 3], and per model rank r a cotangent w[r] and a partial
    product p[r] of that shape."""
    g = np.random.default_rng(5)
    x = g.normal(size=(2, L_VISION, 3)).astype(np.float32)
    w = g.normal(size=(TP, 2, L_VISION, 3)).astype(np.float32)
    p = g.normal(size=(TP, 2, L_VISION, 3)).astype(np.float32)
    return x, w, p


def _operators_case(axes):
    """Each operator's forward and its input's gradient on this rank, the
    loss being sum(w[model rank] * output) (the rank's own chunk of w for
    an output that is this rank's chunk)."""
    from centerclip_tpu_torch.parallel import collectives as C
    x, w, p = (torch.from_numpy(a) for a in op_inputs())
    r, group = axes.model_rank, axes.model_group
    c = C.token_chunk(L_VISION, TP)
    wr = w[r]
    wpad = torch.cat([wr, wr.new_zeros((2, TP * c - L_VISION, 3))], 1)
    own = wpad[:, r * c:(r + 1) * c]
    out = {}

    def run(name, fn, inp, weight):
        inp = inp.clone().requires_grad_()
        y = fn(inp)
        (y * weight).sum().backward()
        out[name] = (y.detach(), inp.grad)

    run("split_tokens", lambda t: C.split_tokens(t, group), x, own)
    chunk = port_mesh.shard_tokens(x, axes).detach()
    run("gather_whole_tokens",
        lambda t: C.gather_whole_tokens(t, group, L_VISION), chunk, w[0])
    run("gather_tokens", lambda t: C.gather_tokens(t, group, L_VISION),
        chunk, wr)
    run("reduce_scatter_tokens", lambda t: C.reduce_scatter_tokens(t, group),
        p[r], own)
    run("copy_to_model", lambda t: C.copy_to_model(t, group), x, wr)
    run("reduce_from_model", lambda t: C.reduce_from_model(t, group), p[r],
        w[0])
    return out


def _split_case(axes, init_sd):
    """This rank's slices of a split model, and the whole state gathered
    back from them."""
    model = port_model("meanP", init_sd)
    port_mesh.split_model(model, axes)
    sd = model.state_dict()
    slices = {k: sd[k].clone() for k in sd
              if port_mesh.param_shardings([k])[k] is not None}
    heads = {n: b.attn.heads for n, b in zip(
        ("vision", "text"), (model.clip.visual.transformer.resblocks[0],
                             model.clip.transformer.resblocks[0]))}
    return dict(slices=slices, heads=heads,
                whole=parallel.fetch_replicated(sd, axes))


def recording(model, store):
    """Record the shapes each launch took on this rank in the towers'
    blocks: the rows of their LayerNorms (C), the local qkv and heads of
    their attention (A); and the cluster module's input and output.
    Returns the function that undoes it."""
    attend = layers.fused_attention

    def attn_rec(qkv, heads, mask=None):
        store["qkv"].add((tuple(qkv.shape), heads))
        return attend(qkv, heads, mask)
    layers.fused_attention = attn_rec
    hooks = []
    for tower in (model.clip.visual, model.clip):
        for block in tower.transformer.resblocks:
            for ln in (block.ln_1, block.ln_2):
                hooks.append(ln.register_forward_pre_hook(
                    lambda m, a: store["ln_rows"].add(tuple(a[0].shape))))
    inter = model.clip.visual.transformer.resblocks[1].tokencluster_inter
    hooks.append(inter.register_forward_hook(
        lambda m, a, o: store.update(cluster_in=a[0].detach().clone(),
                                     cluster_out=o.detach().clone())))

    def undo():
        layers.fused_attention = attend
        for h in hooks:
            h.remove()
    return undo


def _world(rank, world, port, workdir):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    parallel.init_distributed("cpu")
    inits = torch.load(os.path.join(workdir, "init.pt"))
    mesh = parallel.create_mesh(tensor_parallel=TP, device_type="cpu")
    axes = port_mesh.mesh_axes(mesh)
    out = {"axes": (axes.data_size, axes.model_size, axes.model_rank,
                    torch.distributed.get_rank(axes.data_group)),
           "operators": _operators_case(axes),
           "split": _split_case(axes, inits["meanP"])}
    steps = {}
    for header, mode in CASES:
        model = port_model(header, inits[header])
        trainer = Trainer(tp_config(header, mode), model, total_steps=4)
        store = {"ln_rows": set(), "qkv": set()}
        undo = recording(model, store)
        try:
            logs = one_step(trainer, rank_rows(make_batch(10), rank), 1)
        finally:
            undo()
        grads = parallel.fetch_replicated(
            {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}, axes)
        steps[(header, mode)] = dict(logs=logs, grads=grads, **store,
                                     **host_state(trainer.state))
        if header == "meanP" and mode in ("tp", "tp_sp_fsdp"):
            host = host_state(trainer.state)
            if rank == 0:
                save_checkpoint(os.path.join(workdir, f"{mode}_ckpt"),
                                trainer.state, 0, 0.0, host=host)
            parallel.process_barrier(f"{mode}_ckpt")
    out["steps"] = steps
    # the one-process checkpoint resumed into a TP + FSDP run
    model = port_model("meanP", inits["meanP"])
    trainer = Trainer(tp_config("meanP", "tp_sp_fsdp"), model, total_steps=4)
    resume(os.path.join(workdir, "single_ckpt", "ckpt_0"), trainer.state)
    logs = one_step(trainer, rank_rows(make_batch(20), rank), 1)
    out["resumed"] = dict(logs=logs, step=trainer.state.global_step,
                          **host_state(trainer.state))
    torch.save(out, os.path.join(workdir, f"world_{rank}.pt"))
    parallel.process_barrier("done")
    torch.distributed.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world's results beside the JAX inits, the JAX one-process steps
    and gradients and the port's one-process steps, computed while the
    world runs."""
    workdir = str(tmp_path_factory.mktemp("tensor_parallel_world"))
    jparams = {h: jax_params(h) for h in HEADERS}
    inits = {h: state_dict_from_jax_params(
        jparams[h], run_config(h, 1).model) for h in HEADERS}
    torch.save(inits, os.path.join(workdir, "init.pt"))
    single = {}
    for header in HEADERS:
        trainer = Trainer(run_config(header, 1), port_model(
            header, inits[header]), total_steps=4)
        logs = one_step(trainer, make_batch(10), 1)
        single[header] = dict(logs=logs, **host_state(trainer.state))
        if header == "meanP":
            save_checkpoint(os.path.join(workdir, "single_ckpt"),
                            trainer.state, 0, 0.0)
            one_step(trainer, make_batch(20), 1)
            single["two_steps"] = host_state(trainer.state)
    ctx = mp.start_processes(_world, args=(WORLD, _free_port(), workdir),
                             nprocs=WORLD, join=False, start_method="spawn")
    jax_ref = {h: jax_step(h, 1, jparams[h]) for h in HEADERS}
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
                jax=jax_ref, ranks=ranks, **ranks[0])


# ------------------------------------------------------------ the mesh
def test_mesh_folds_the_model_axis_fastest(world):
    """(data extent, model extent, model rank, data rank) of each rank:
    ranks 2d and 2d + 1 form model group d (JAX's reshape(data, model))."""
    assert [r["axes"] for r in world["ranks"]] == [
        (DATA, TP, rank % TP, rank // TP) for rank in range(WORLD)]


def test_in_proj_is_split_per_head_and_gathers_to_the_bit(world):
    """Rank r's in_proj rows are the q, k and v rows of heads [r H / tp,
    (r + 1) H / tp) of JAX's whole kernel (its columns); c_fc's rows and
    out_proj's and c_proj's columns are contiguous chunks; the gather of
    the slices is the whole tensor, bit for bit, in the [3 D, D] schema."""
    init = world["inits"]["meanP"]
    jp = world["jparams"]["meanP"]["clip"]["visual"]["resblocks_0"]
    kernel, bias = (np.asarray(jp["attn"]["in_proj"][k])
                    for k in ("kernel", "bias"))
    local = WIDTH // TP
    key = "clip.visual.transformer.resblocks.0.attn.in_proj_weight"
    for rank, res in enumerate(world["ranks"]):
        split = res["split"]
        assert split["heads"] == {"vision": 1, "text": 1}
        cols = np.concatenate([part * WIDTH + (rank % TP) * local
                               + np.arange(local) for part in range(3)])
        np.testing.assert_array_equal(split["slices"][key].numpy(),
                                      kernel[:, cols].T)
        np.testing.assert_array_equal(
            split["slices"][key.replace("weight", "bias")].numpy(),
            bias[cols])
        for name, dim in (("mlp.c_fc.weight", 0), ("attn.out_proj.weight", 1),
                          ("mlp.c_proj.weight", 1)):
            k = f"clip.transformer.resblocks.1.{name}"
            assert torch.equal(split["slices"][k], init[k].chunk(
                TP, dim=dim)[rank % TP]), k
        assert sorted(split["whole"]) == sorted(init)
        for k, v in init.items():
            assert torch.equal(split["whole"][k], v), k
    assert tuple(world["split"]["whole"][key].shape) == (3 * WIDTH, WIDTH)


# ---------------------------------------------------------- operators
def _chunk(a, r):
    c = -(-a.shape[1] // TP)
    pad = np.concatenate([a, np.zeros((a.shape[0], TP * c - a.shape[1],
                                       *a.shape[2:]), a.dtype)], 1)
    return pad[:, r * c:(r + 1) * c]


@pytest.mark.parametrize("name", ["split_tokens", "gather_whole_tokens",
                                  "gather_tokens", "reduce_scatter_tokens",
                                  "copy_to_model", "reduce_from_model"])
def test_megatron_operator_matches_one_process(world, name):
    """Each operator's forward and backward on both ranks of a model group
    against the one-process computation of the same sums (L = 5 over 2
    ranks: uneven)."""
    x, w, p = op_inputs()
    for r in range(TP):
        y, g = (t.numpy() for t in world["ranks"][r]["operators"][name])
        if name == "split_tokens":          # own chunk; gradient whole
            want_y = _chunk(x, r)
            want_g = np.concatenate([_chunk(w[q], q) for q in range(TP)],
                                    1)[:, :L_VISION]
        elif name == "gather_whole_tokens":  # whole; own chunk's gradient
            want_y, want_g = x, _chunk(w[0], r)
        elif name == "gather_tokens":       # whole; gradients summed
            want_y, want_g = x, _chunk(w.sum(0), r)
        elif name == "reduce_scatter_tokens":
            want_y = _chunk(p.sum(0), r)
            want_g = np.concatenate([_chunk(w[q], q) for q in range(TP)],
                                    1)[:, :L_VISION]
        elif name == "copy_to_model":
            want_y, want_g = x, w.sum(0)
        else:
            want_y, want_g = p.sum(0), w[0]
        np.testing.assert_allclose(y, want_y, rtol=0, atol=OP_ATOL,
                                   err_msg=f"{name} forward, rank {r}")
        np.testing.assert_allclose(g, want_g, rtol=0, atol=OP_ATOL,
                                   err_msg=f"{name} backward, rank {r}")


# ------------------------------------------------------------ TP steps
@pytest.mark.parametrize("header,mode", CASES)
def test_tp_step_equals_the_one_process_step(world, header, mode):
    """Loss, whole parameters and Adam moments after one step, on every
    rank's gather."""
    ref = world["single"][header]
    for rank, res in enumerate(world["ranks"]):
        got = res["steps"][(header, mode)]
        for k in ("loss", "sim_loss", "cluster_loss"):
            np.testing.assert_allclose(got["logs"][k], ref["logs"][k],
                                       rtol=PORT_ATOL, err_msg=f"{k} {rank}")
        assert_state_close(got, ref, PORT_ATOL)


@pytest.mark.parametrize("header,mode", CASES)
def test_tp_step_equals_the_jax_step(world, header, mode):
    """The loss, every clipped gradient (gathered over both axes) and every
    updated parameter against JAX's one-process step at the global batch,
    at tests/test_torch_parallel.py's tolerances."""
    loss, jparams = world["jax"][header]
    got = world["steps"][(header, mode)]
    np.testing.assert_allclose(got["logs"]["loss"], loss, rtol=1e-5)
    jgrads = jax_clipped_grads(header, 1, world["jparams"][header],
                               set(got["grads"]))
    assert sorted(jgrads) == sorted(got["grads"])
    sensitive = 0
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
        np.testing.assert_allclose(got["params"][key].numpy()[held],
                                   ref[held], rtol=0, atol=STEP_ATOL,
                                   err_msg=key)
    assert sensitive < 1e-3 * sum(v.numel() for v in got["params"].values())


@pytest.mark.parametrize("mode", list(MODES))
def test_kernels_take_local_heads_and_rows(world, mode):
    """Every rank's attention took qkv [N, L, 3 D / tp] with H / tp = 1
    head; with SP every block LayerNorm took ceil(L / tp) tokens a row
    block (vision 5 -> 3, then 4 after the cluster layer -> 2; text 12 ->
    6), without SP the whole L."""
    for res in world["ranks"]:
        got = res["steps"][("meanP", mode)]
        assert {h for _, h in got["qkv"]} == {1}
        assert {s[-1] for s, _ in got["qkv"]} == {3 * WIDTH // TP}
        lengths = {s[1] for s, _ in got["qkv"]}
        assert lengths == {5, 4, 12}
        sp = MODES[mode].get("sequence_parallel", False)
        assert {s[1] for s in got["ln_rows"]} == ({3, 2, 6} if sp
                                                  else {5, 4, 12})


@pytest.mark.parametrize("mode", list(MODES))
def test_model_group_ranks_cluster_the_same_tokens(world, mode):
    """The cluster layer runs replicated on each rank of a model group: its
    input and output (the medoid tokens it keeps) equal to the bit on the
    group's ranks, and differ between the two data shards."""
    for header in HEADERS:
        steps = [r["steps"][(header, mode)] for r in world["ranks"]]
        for d in range(DATA):
            a, b = steps[d * TP], steps[d * TP + 1]
            assert torch.equal(a["cluster_in"], b["cluster_in"])
            assert torch.equal(a["cluster_out"], b["cluster_out"])
        assert not torch.equal(steps[0]["cluster_in"], steps[TP]["cluster_in"])


# --------------------------------------------------------- checkpoints
@pytest.mark.parametrize("mode", ["tp", "tp_sp_fsdp"])
def test_tp_checkpoint_loads_strict_into_one_process(world, mode):
    path = os.path.join(world["workdir"], f"{mode}_ckpt", "ckpt_0")
    payload = torch.load(path, weights_only=True)
    model = port_model("meanP", world["inits"]["meanP"])
    model.load_state_dict(payload["params"], strict=True)
    ref = world["steps"][("meanP", mode)]
    for k, v in model.state_dict().items():
        assert torch.equal(v, ref["params"][k]), k
        assert tuple(v.shape) == tuple(world["inits"]["meanP"][k].shape), k
    for key in ("exp_avg", "exp_avg_sq"):
        for k, v in ref["opt_state"][key].items():
            assert torch.equal(payload["opt_state"][key][k], v), k


def test_resume_across_the_tp_fsdp_and_one_process_layouts(world):
    """A one-process checkpoint resumed into a TP + SP + FSDP run, and a TP
    run's checkpoint resumed into one process: each steps on to the
    one-process run's second step."""
    two = world["single"]["two_steps"]
    for res in world["ranks"]:
        assert res["resumed"]["step"] == 2
        assert_state_close(res["resumed"], two, PORT_ATOL)
    trainer = Trainer(run_config("meanP", 1),
                      port_model("meanP", world["inits"]["meanP"]),
                      total_steps=4)
    resume(os.path.join(world["workdir"], "tp_ckpt", "ckpt_0"),
           trainer.state)
    one_step(trainer, make_batch(20), 1)
    assert_state_close(host_state(trainer.state), two, PORT_ATOL)


# --------------------------------------------- the 4-process `main`
def test_four_process_main_with_tensor_and_sequence_parallelism(
        msrvtt_root, one_process_main, tmp_path):
    """torchrun with 4 processes as (data 2, model 2), `--tensor_parallel
    2 --sequence_parallel 1` (JAX tests/test_multiprocess.py:119-144):
    every rank exits 0 with the same loss, rank 0 alone logs, evaluates and
    writes, and the losses and the export are the one-process run's at the
    same global batch of 8."""
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(WORLD), os.path.abspath(__file__),
           str(msrvtt_root), str(out), "--tensor_parallel", str(TP),
           "--sequence_parallel", "1"]
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
    np.testing.assert_allclose(sim_losses(r0), sim_losses(one_process_main),
                               rtol=1e-5)
    sd = torch.load(r0 / "ckpt.pth.tar", weights_only=False)["state_dict"]
    ref = torch.load(one_process_main / "ckpt.pth.tar",
                     weights_only=False)["state_dict"]
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0,
                                   atol=PORT_ATOL, err_msg=k)


if __name__ == "__main__":
    # the 4-process `main` worker: each rank writes to <out>/r<rank>
    data_root, out_dir, *flags = sys.argv[1:]
    rank_out = os.path.join(out_dir, f"r{os.environ['RANK']}")
    torch.set_num_threads(1)
    import pathlib
    run_main(main_argv(pathlib.Path(data_root), rank_out, flags))
