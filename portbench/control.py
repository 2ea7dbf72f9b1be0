"""Readings that set the limits of `correct`, each judged by the cell's
own limits (`limits/<cell>.json`, `harness.judge`) as a run is: the
program's numbers on many seeds, and on the first `CONTROL_SEEDS` of them
the control's (the reference computed one precision below the program's
bf16: fp8 matmul operands; for training also with fp8 in the vision
tower alone) and, for training, the fault of half the batch left out,
each against the fp32 reference, at the cell's own size.  Run on the
chip; the benchmark's own runs never run it.

    python3 portbench/control.py --workload <cell> --seeds 1 2 ...

One JSON line a reading: {workload, seed, reading: program | control |
control_vision | half_batch, correct, checks: {number: {value, limit}},
norms}: a training reading's leaf norms (losses, first gradient, change)
of the program, the reference and the control or fault, from which any
other statistic of the leaves can be worked out again.  A training
cell's program reading is its three first steps (the window's own
trainer and feed, no window); an encode cell's is one pass of the engine
over the gallery.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
os.environ["TRITON_CACHE_DIR"] = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), ".cache", "triton")

CONTROL_SEEDS = 3


def readings(cell, seed, controls: bool, device):
    from portbench import compare, kinds, synth, weights
    from portbench.harness import free, load_weights
    if cell.traffic["kind"] == "train":
        setup = kinds.TrainSetUp(cell, seed, device)
        setup.close()
        ref = setup.reference()
        yield "program", setup.numbers(ref), \
            {"program": setup.prog, "reference": ref}
        if controls:
            for name, precision in (("control", "fp8"),
                                    ("control_vision", "fp8_vision")):
                ctl = setup.reference(precision)
                yield name, compare.train_numbers(ctl, ref), {name: ctl}
            half = setup.reference(rows=slice(0, setup.cfg.batch_size // 2))
            yield "half_batch", compare.train_numbers(half, ref), \
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
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    for i, seed in enumerate(args.seeds):
        for reading, numbers, norms in readings(cell, seed,
                                                i < CONTROL_SEEDS, "cuda"):
            correct, checks = judge(numbers, cell.limits)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "reading": reading, "correct": correct,
                              "checks": checks, "norms": norms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
