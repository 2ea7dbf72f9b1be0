#!/usr/bin/env python3
"""One kernel family of a traced benchmark run, split by kernel name.

    python3 scripts/family_by_kernel.py --workload <cell> --seed <n> \
        [--family elementwise] [--json <out.json>]

Runs one `--trace 1` run of a cell of `BENCHMARK.json` through
`portbench`'s harness in this process (its result line printed as
`portbench/run.py` prints it), keeps the traced window's device events,
and prints the family's device time by kernel name: milliseconds and
launches a unit (a training step, or an encode batch), largest first, each
under a short label (the kernel's function, the functors and kernels named
in its template arguments, its dtypes).  `--json` writes the same with
every kernel's full name.  Families are `portbench/families/*.json`.  Run
from the root of a checkout on a machine with the cell's CUDA devices.
"""
import argparse
import json
import os
import re
import sys
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the names in a kernel's template arguments that say what it computes
_WHAT = re.compile(r"[A-Za-z_]\w*(?:Functor\w*|Epilogue|_kernel_cuda|"
                   r"_kernel_impl|_functor|Op)\b")
_DTYPES = re.compile(r"\b(?:c10::)?(BFloat16|Half|__nv_bfloat16|__half|"
                     r"float|double|bool|long)\b")


def _template_args(rest: str) -> str:
    """The template argument list at the start of `rest` ("<...>"), or
    ""."""
    if not rest.startswith("<"):
        return ""
    depth = 0
    for i, c in enumerate(rest):
        depth += (c == "<") - (c == ">")
        if depth == 0:
            return rest[1:i]
    return rest[1:]


def label(name: str) -> str:
    """A short label of a kernel name: its function's name, then what its
    template arguments name (functors, the kernels that hold a lambda) and
    their dtypes, in order of appearance."""
    full = name[5:] if name.startswith("void ") else name
    full = full.replace("(anonymous namespace)::", "")
    head = re.split(r"[<(]", full, maxsplit=1)[0]
    base = head.split("::")[-1] or head
    args = _template_args(full[len(head):])
    seen = []
    for tok in _WHAT.findall(args) + _DTYPES.findall(args):
        if tok != base and tok not in seen:
            seen.append(tok)
    return base + (f" [{', '.join(seen)}]" if seen else "")


def split(trace, family: str, units: float) -> dict:
    """The device time of `family`'s events in `trace` (a
    `portbench.trace.Trace`), by kernel name: {family, units, ms, kernels:
    [{label, name, ms, launches}] largest first}, ms and launches a
    unit."""
    ms, n = defaultdict(float), defaultdict(int)
    for a, b, name, cat, _ in trace.device:
        if trace.fam(name, cat) == family:
            ms[name] += (b - a) * 1e-3
            n[name] += 1
    rows = [dict(label=label(k), name=k, ms=v / units,
                 launches=n[k] / units)
            for k, v in sorted(ms.items(), key=lambda kv: -kv[1])]
    return dict(family=family, units=units,
                ms=sum(ms.values()) / units, kernels=rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="scripts/family_by_kernel.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--family", default="elementwise")
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    # portbench/run.py sets the kernel caches' paths when imported
    from portbench import harness, run
    kept = {}
    read_metrics = harness.read_metrics

    def keeping(cell, ctx):
        kept.update(ctx)
        return read_metrics(cell, ctx)
    harness.read_metrics = keeping
    rc = harness.main(["--workload", args.workload, "--seed",
                       str(args.seed), "--seconds", "1", "--trace", "1"],
                      start=run.START)
    if rc or "trace" not in kept:
        print(f"family_by_kernel: the traced run failed (rc {rc})",
              file=sys.stderr)
        return rc or 1
    units = kept["units"]       # traced training steps, or encode batches
    out = dict(split(kept["trace"], args.family, units),
               workload=args.workload, seed=args.seed,
               unit="step" if kept["training"] else "batch")
    print(f"{args.workload}: {args.family} {out['ms']:.3f} ms a "
          f"{out['unit']} over {units:g}")
    for r in out["kernels"]:
        print(f"  {r['ms']:9.3f} ms {r['launches']:8.2f} launches  "
              f"{r['label']}")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
