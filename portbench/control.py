"""Readings that set the limits of `correct`, each judged by the cell's
own limits (`limits/<cell>.json`, `harness.judge`) as a run is: the
program's numbers on many seeds, and on the first `CONTROL_SEEDS` of them
the control's (the reference computed one precision below the program's
bf16: fp8 matmul operands; for training also with fp8 in the vision
tower alone) and, for training, the fault of half the batch left out,
each against the fp32 reference, at the cell's own size.  A multi-rank
cell (`train_ddp`) runs on its ranks as a run does (`ddp.py`), the
reference at the global batch on rank 0's card, and adds the fault of
the exchange between the cards left out (`no_allreduce`: each card
steps on its own rows).  Run on the chip; the benchmark's own runs never
run it.

    python3 portbench/control.py --workload <cell> --seeds 1 2 ...

One JSON line a reading: {workload, seed, reading: program | control |
control_vision | half_batch | no_allreduce | unscaled | random_medoids |
top_spectrum | no_knn | bf16_solve, correct, checks:
{number: {value, limit}}, norms}: a training reading's leaf norms (losses,
first gradient, change) of the program, the reference and the control or
fault, from which any other statistic of the leaves can be worked out
again.  A training cell's program reading is its three first steps (the
window's own trainer and feed, no window); an encode cell's is one pass
of the engine over the gallery.

Where the plan clusters spectrally, the program reading's `norms` carry
`spectral`, the first cluster layer of step 1 judged in the reference
(`TrainSetUp.cluster_layer`): `cost_excess`, of the first step's segments
the share whose medoid ids the program and the reference agree on
(`agreement`), those whose K-th and (K+1)-th eigenvalues lie under 1e-5
apart in the reference (`near_ties`), `identity_segments`, and the median
over segments of the median distance between a segment's tokens in sigma
(`median_sigmas`).  The controls' `cluster_cost_excess` scores the
reference's own ids at their precision.  On the first seeds the faults of
`solve_fault`, planted in the program, are read by the cluster layer's
numbers alone (readings `random_medoids`, `top_spectrum`, `no_knn`,
`bf16_solve`).  Where the configuration scales the vision stream
(`stream_scale`), the fault `unscaled` runs it at 1, where the heat
kernel underflows (W = I).
"""
import argparse
import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
os.environ["TRITON_CACHE_DIR"] = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), ".cache", "triton")

CONTROL_SEEDS = 3
# a rank's seconds a seed, at most, for the timeout of a multi-rank call
SEED_S = 300


@contextlib.contextmanager
def no_allreduce():
    """The fault of the exchange between the cards left out: the DDP
    wrapper that a `Trainer` built meanwhile hands each rank's gradient
    back as it is (a comm hook that reduces nothing), so that each card
    steps on its own rows."""
    import torch
    import centerclip_tpu_torch.train.loop as loop
    wrap = loop.shard_params

    def hook(state, bucket):
        fut = torch.futures.Future()
        fut.set_result(bucket.buffer())
        return fut

    def shard_params(model, mesh, **kw):
        module = wrap(model, mesh, **kw)
        module.register_comm_hook(None, hook)
        return module
    loop.shard_params = shard_params
    try:
        yield
    finally:
        loop.shard_params = wrap


def rank_readings(cell, seed, controls: bool, device, ranks):
    """A multi-rank cell's readings (rank 0 yields them; the other ranks
    take part in the program's runs)."""
    from portbench import compare, kinds
    before = compare.spectral_before(cell.shapes)
    setup = kinds.RankSetUp(cell, seed, device, ranks)
    ref = None
    if setup.close() is not None:
        ref = setup.reference()
        yield "program", setup.numbers(ref), \
            {"program": setup.prog, "reference": ref}
    if not controls:
        return
    with no_allreduce():
        fault = kinds.RankSetUp(cell, seed, device, ranks)
    if fault.close() is None:
        return
    yield "no_allreduce", fault.numbers(ref), {"no_allreduce": fault.prog}
    for name, precision in (("control", "fp8"),
                            ("control_vision", "fp8_vision")):
        ctl = setup.reference(precision)
        yield name, compare.train_numbers(ctl, ref, before), {name: ctl}
    half = setup.reference(rows=slice(0, setup.cfg.batch_size // 2))
    yield "half_batch", compare.train_numbers(half, ref, before), \
        {"half_batch": half}


@contextlib.contextmanager
def solve_fault(name: str):
    """A fault planted in the program's spectral cluster layer
    (`centerclip_tpu_torch.ops.spectral`), for `cluster_cost_excess`:

    * `random_medoids`: each segment's medoids drawn at random;
    * `top_spectrum`: the eigenvectors of the K largest eigenvalues of
      L_sym in place of the K smallest;
    * `no_knn`: the heat-kernel graph without its KNN cut;
    * `bf16_solve`: L_sym rounded to bfloat16 before the eigensolve."""
    import torch
    import centerclip_tpu_torch.ops.spectral as sp
    saved = {k: getattr(sp, k) for k in ("batch_spectral_clustering",
                                          "eigenpairs",
                                          "construct_affinity")}
    call, solve, graph = (saved["batch_spectral_clustering"],
                          saved["eigenpairs"], saved["construct_affinity"])

    def random_medoids(X, K, **kw):
        assign, _ = call(X, K, **kw)
        g = torch.Generator(device=X.device).manual_seed(0)
        pick = torch.rand(X.shape[:2], generator=g, device=X.device)
        ids = pick.argsort(dim=-1)[:, :K].sort(dim=-1).values
        return assign, ids.to(torch.int32)

    def top_spectrum(L, K, solver="eigh"):
        lam, Q = solve(L, K, solver)
        return lam.flip(-1), Q.flip(-1)

    def no_knn(x, y, **kw):
        return graph(x, y, **dict(kw, mode="HeatKernel"))

    def bf16_solve(L, K, solver="eigh"):
        return solve(L.bfloat16().float(), K, solver)
    name_of = {"random_medoids": ("batch_spectral_clustering",
                                  random_medoids),
               "top_spectrum": ("eigenpairs", top_spectrum),
               "no_knn": ("construct_affinity", no_knn),
               "bf16_solve": ("eigenpairs", bf16_solve)}
    attr, fn = name_of[name]
    setattr(sp, attr, fn)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(sp, k, v)


SOLVE_FAULTS = ("random_medoids", "top_spectrum", "no_knn", "bf16_solve")


def readings(cell, seed, controls: bool, device, ranks=None):
    from portbench import compare, kinds, synth, weights
    from portbench.harness import Cell, free, load_weights
    if ranks is not None:
        yield from rank_readings(cell, seed, controls, device, ranks)
        return
    if cell.traffic["kind"] == "train":
        before = compare.spectral_before(cell.shapes)
        setup = kinds.TrainSetUp(cell, seed, device)
        setup.close()
        ref = setup.reference()
        numbers = setup.numbers(ref)
        extra = ({"spectral": setup.cluster_layer()}
                 if before is not None else {})
        yield "program", numbers, \
            {"program": setup.prog, "reference": ref, **extra}
        if controls and before is not None:
            for name in SOLVE_FAULTS:
                with solve_fault(name):
                    fault = kinds.TrainSetUp(cell, seed, device)
                fault.close()
                layer = fault.cluster_layer()
                yield name, compare.cluster_numbers(layer), \
                    {"spectral": layer}
                del fault
                free(device)
        if controls and cell.shapes.stream_scale != 1.0:
            flat = Cell(cell.name, manifest=cell.manifest,
                        config=dict(cell.config, stream_scale=1.0),
                        traffic=cell.traffic, limits=cell.limits)
            fault = kinds.TrainSetUp(flat, seed, device)
            fault.close()
            yield "unscaled", fault.numbers(fault.reference()), \
                {"unscaled": fault.prog}
            del fault
            free(device)
        if controls:
            for name, precision in (("control", "fp8"),
                                    ("control_vision", "fp8_vision")):
                ctl = setup.reference(precision)
                got = compare.train_numbers(ctl, ref, before)
                layer = {}
                if before is not None:
                    layer = setup.cluster_layer(precision)
                    got.update(compare.cluster_numbers(layer))
                yield name, got, {name: ctl, "spectral": layer}
            half = setup.reference(rows=slice(0, setup.cfg.batch_size // 2))
            yield "half_batch", compare.train_numbers(half, ref, before), \
                {"half_batch": half}
        return
    from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
    from centerclip_tpu_torch.serve.engine import RetrievalEngine
    s, t = cell.shapes, cell.traffic
    cfg = cell.run_config(seed)
    gallery = synth.gallery(t["clips"], s.frames, s.resolution,
                            cfg.batch_size_val, seed, device)
    model = CLIP4Clip(cfg.model, device=device, seed=seed)
    load_weights(model, weights.make(s, seed, device))
    engine = RetrievalEngine(model, device=device)
    out = engine.embed_video_batches(gallery)
    del engine, model
    free(device)
    ref = kinds.encode_reference(cell, seed, gallery, device)
    yield "program", compare.encode_numbers([out], ref), {}
    if controls:
        ctl = kinds.encode_reference(cell, seed, gallery, device, "fp8")
        yield "control", compare.encode_numbers([ctl], ref), {}


def main(argv=None):
    from portbench.harness import Cell, judge
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--parent", type=int, help="(set for each rank)")
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    ranks = device = None
    if cell.ranks > 1:
        from portbench import ddp
        if args.parent is None:
            ddp.ensure_data(cell)
            ddp.launch(cell.ranks, os.path.abspath(__file__),
                       ["--workload", args.workload, "--seeds",
                        *map(str, args.seeds)],
                       timeout=SEED_S * len(args.seeds), stdout=None)
            return 0
        ddp.die_with(args.parent)
        from centerclip_tpu_torch.parallel.mesh import init_distributed
        device = init_distributed()
        ranks = ddp.Ranks()
    try:
        for i, seed in enumerate(args.seeds):
            for reading, numbers, norms in readings(
                    cell, seed, i < CONTROL_SEEDS, device or "cuda", ranks):
                correct, checks = judge(numbers, cell.limits)
                print(json.dumps({"workload": args.workload, "seed": seed,
                                  "reading": reading, "correct": correct,
                                  "checks": checks, "norms": norms}),
                      flush=True)
    finally:
        if ranks is not None:
            import torch.distributed as dist
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
