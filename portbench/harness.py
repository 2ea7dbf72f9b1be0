"""One run of one cell of `BENCHMARK.json`.

A cell names a configuration (`configs/<name>.json`: the recipe's flags
for the program's CLI, the towers' widths, the optimizer as the recipe
states it) and a traffic mix (`traffic/<name>.json`, whose `kind` picks
the runner in `kinds.py`: `train`, `encode` or `train_ddp`; its `flags`
follow the configuration's, and its `ranks`, where it has them, are the
processes the cell runs in, one a card: `ddp.py`).  Its limits for
`correct` are in `limits/<cell>.json`; each per-layer metric is read by
`metrics/<metric>.py`.  So a later cell or metric is a new file, and
nothing here changes.

Every run: set-up (data, the program's model with weights made on the
card from the seed, its trainer or engine, the first steps, warm-up of
the cell's own shapes), the window (`--seconds` of the program's own
entry point, or with `--trace 1` the traffic's traced steps under
`torch.profiler`), then, with the program's state freed, the plain
reference on the same inputs, the comparison, and one line of JSON.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "portbench")
CACHE = os.path.join(BENCH, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "centerclip_tpu")
WINDOW = "portbench.window"


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of the manifest with its configuration, traffic, limits
    and the metrics it reports."""

    def __init__(self, name: str, manifest: Optional[dict] = None,
                 config: Optional[dict] = None,
                 traffic: Optional[dict] = None,
                 limits: Optional[dict] = None):
        from .work.plan import shapes
        self.manifest = manifest or _load(os.path.join(ROOT,
                                                       "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.workload = name, cells[name]
        entry = {c["name"]: c for c in self.manifest["configs"]}[
            self.workload["config"]]
        self.config = config or _load(os.path.join(ROOT, entry["file"]))
        self.traffic = traffic or _load(os.path.join(
            BENCH, "traffic", self.workload["traffic"] + ".json"))
        lim = os.path.join(BENCH, "limits", name + ".json")
        self.limits = limits if limits is not None else (
            _load(lim) if os.path.exists(lim) else {})
        self.shapes = shapes(self.config)
        self.chips = self.workload["chips"]
        self.ranks = self.traffic.get("ranks", 1)
        if self.ranks > 1 and self.ranks != self.chips:
            raise ValueError(f"{name}: {self.ranks} ranks on {self.chips} "
                             f"chips; a rank runs on each card")

    def end_to_end(self) -> List[dict]:
        return [m for m in self.manifest["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> List[dict]:
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.manifest["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in mine)]

    def run_config(self, seed: int, paths: Optional[dict] = None):
        """The program's RunConfig, parsed by its own CLI from the
        configuration's flags and the traffic's, with the data paths and
        the seed."""
        from centerclip_tpu_torch.cli import parse_args
        argv = list(self.config["flags"]) + list(
            self.traffic.get("flags", ())) + [
            "--output_dir", os.path.join(CACHE, "out", self.name),
            "--seed", str(seed)]
        for key, path in (paths or {}).items():
            argv += [f"--{key}", path]
        cfg = parse_args(argv)
        size = self.config["arch"]["image_resolution"]
        if cfg.data.image_resolution != size:
            import dataclasses
            cfg = dataclasses.replace(cfg, data=dataclasses.replace(
                cfg.data, image_resolution=size))
        if cfg.freeze_layer_num != self.config["freeze_layer_num"]:
            raise ValueError("the program parsed freeze_layer_num "
                             f"{cfg.freeze_layer_num}, the configuration "
                             f"states {self.config['freeze_layer_num']}")
        want = self.config["optim"]
        got = cfg.optim
        for key in ("lr", "coef_lr", "beta1", "beta2", "eps", "weight_decay",
                    "warmup_proportion", "clip_grad_norm"):
            if not math.isclose(getattr(got, key), want[key]):
                raise ValueError(f"the program parsed {key}={getattr(got, key)}"
                                 f", the configuration states {want[key]}")
        return cfg


def load_weights(model, W: Dict) -> None:
    """Copy the benchmark's weights into the program's model: the same
    leaves, shapes and names, or it raises."""
    import torch
    sd = dict(model.named_parameters())
    if set(sd) != set(W):
        raise ValueError(f"the model's leaves differ from the configuration's"
                         f": {sorted(set(sd) ^ set(W))[:8]}")
    with torch.no_grad():
        for name, p in sd.items():
            if tuple(p.shape) != tuple(W[name].shape):
                raise ValueError(f"{name}: {tuple(p.shape)} against "
                                 f"{tuple(W[name].shape)}")
            p.copy_(W[name])


def counters() -> Dict[str, int]:
    """The program's launch counters of kernels A-E."""
    from centerclip_tpu_torch.ops import (attention_cuda, kmedoids_cuda,
                                          layernorm_triton)
    return {"attn_fwd": attention_cuda.fused_attention.launches,
            "attn_bwd": attention_cuda.attention_backward.launches,
            "ln_fwd": layernorm_triton.layer_norm.launches,
            "ln_bwd": layernorm_triton.layer_norm_backward.launches,
            "kmedoids": kmedoids_cuda.kmedoids_from_distances.launches}


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    """The measured or traced region: the card synchronised at both ends,
    the program's launch counters read at both ends, and when tracing a
    `torch.profiler` trace of the card's activity around it (the
    window's ends and the harness's spans in wall-clock ns).  `meet`, where
    given, is called at both ends once the card is synchronised: the
    barrier at which the ranks of a multi-rank cell start and end the
    window together."""

    def __init__(self, device, trace: bool, path: str, meet=None):
        self.device, self.trace, self.path = device, trace, path
        self.meet = meet
        self.prof = None
        self.spans: List[tuple] = []

    def __enter__(self):
        import torch
        sync(self.device)
        if self.trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.device(self.device).type == "cuda":
                acts = [torch.profiler.ProfilerActivity.CUDA]
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
        if self.meet is not None:
            self.meet()
        self.counts0 = counters()
        self.t0_ns = time.time_ns()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        sync(self.device)
        if self.meet is not None and exc[0] is None:
            self.meet()
        self.t1 = time.perf_counter()
        self.t1_ns = time.time_ns()
        self.counts = {k: v - self.counts0[k] for k, v in counters().items()}
        if self.trace:
            self.prof.__exit__(*exc)
            if exc[0] is None:
                os.makedirs(os.path.dirname(self.path), exist_ok=True)
                self.prof.export_chrome_trace(self.path)
        return False

    def span(self, name: str):
        """A host span of the harness's own, kept when tracing."""
        return _Span(self.spans, name) if self.trace else _NOSPAN

    def read(self):
        """The trace of the window (then its file is removed)."""
        from .trace import Trace
        trace = Trace.from_file(self.path, window_ns=(self.t0_ns, self.t1_ns),
                                spans_ns=self.spans)
        os.remove(self.path)
        return trace

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class _Span:
    def __init__(self, into: list, name: str):
        self.into, self.name = into, "portbench." + name

    def __enter__(self):
        self.t = time.time_ns()

    def __exit__(self, *exc):
        self.into.append((self.t, time.time_ns(), self.name))
        return False


class _NoSpan:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOSPAN = _NoSpan()


def free(device) -> None:
    import torch
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def peak_bytes(device, chips: int) -> int:
    import torch
    if torch.device(device).type != "cuda":
        return 0
    return max(torch.cuda.max_memory_allocated(i) for i in range(chips))


def read_metrics(cell: Cell, ctx: dict) -> Dict[str, dict]:
    """Each per-layer metric of the cell by its reader; a reader that finds
    nothing returns None, and the metric is left out."""
    out = {}
    for m in cell.per_layer():
        path = os.path.join(BENCH, "metrics", m["name"] + ".py")
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + m["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {value, limit}}): every number finite and at or
    under its limit; a number without a limit fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not math.isfinite(value) or value > limit:
            ok = False
    return ok and bool(numbers), checks


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        start: float):
    """One run of `cell` in this process; returns the result's dict
    (without the check of loaded modules) and the set-up's phases."""
    from .kinds import KINDS
    kind = KINDS[cell.traffic["kind"]]
    return outcome(cell, kind(cell, seed, seconds, trace, device, start),
                   trace, device)


def outcome(cell: Cell, out: dict, trace: bool, device):
    """The result's dict and the set-up's phases from a runner's `out`:
    the numbers judged by the cell's limits, the device, and the cell's
    end-to-end metrics, or with `trace` its per-layer ones (`busy_s` is the
    runner's mean over its cards where it gives one, else the trace's)."""
    numbers = out.pop("numbers")
    correct, checks = judge(numbers, cell.limits)
    import torch
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                     else "cpu"),
            "count": cell.chips, "memory_peak_bytes": out.pop("peak")}
    ctx = out.pop("ctx")
    phases = out.pop("phases", [])
    if trace:
        from .work.peaks import card_peaks
        ctx["peaks"] = card_peaks(info["kind"])
        info["busy_s"] = (ctx["busy_s"] if "busy_s" in ctx
                          else ctx["trace"].busy_s())
        info["window_s"] = ctx["trace"].window_s
        metrics = read_metrics(cell, ctx)
    else:
        want = [m["name"] for m in cell.end_to_end()]
        missing = [m for m in want if m not in out["e2e"]]
        if missing:
            raise RuntimeError(f"the run measured no {missing}")
        units = {m["name"]: m["unit"] for m in cell.end_to_end()}
        metrics = {m: {"value": out["e2e"][m], "unit": units[m]}
                   for m in want}
    res = {"correct": correct, "attempted": out["attempted"],
           "failed": out["failed"], "metrics": metrics, "device": info}
    if trace:
        res["breakdown"] = ctx["trace"].breakdown()
    res["checks"] = checks
    return res, phases


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None, start: Optional[float] = None) -> int:
    start = time.time() if start is None else start
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    loaded = []
    if cell.ranks > 1:
        from . import ddp
        try:
            res, phases, loaded = ddp.run(cell, args.seed, args.seconds,
                                          bool(args.trace), start)
        except ddp.RanksFailed as e:
            print(f"portbench: {e}", file=sys.stderr)
            return 1
    else:
        res, phases = run(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda", start)
    bad = sorted(set(loaded) | set(forbidden_modules()))
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, seconds in phases:
        print(f"set-up {name} {seconds:.3f} s", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0
