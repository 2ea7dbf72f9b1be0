"""The traced window's device time and idle gaps put down to the program's
spans.

    python3 portbench/attribution.py --workload <cell> --seed <n>

Runs one cell as `run.py --trace 1` does, with the program's span recorder
(`centerclip_tpu_torch/utils/spans.py`) on over the traced window only, and
prints one line of JSON: the run's result, the window's seconds, and the
window's device time and idle time by span.  The harness's own files are
used as they are; `SpanWindow` is the `Window` the cell's runner gets.

A device event (kernel, copy, memset) goes to the spans that were open at
its launch on the loop's thread (the one that opened `train.step` or
`encode.batch`): the `cuda_runtime` / `cuda_driver` call with the event's
`correlation` id gives the launch's time, and the spans of the loop's
thread open then, outermost first, are its chain.  The time decides, not
the launching thread, because autograd launches the backward's kernels
from its own thread while the loop's thread waits in `train.backward`
(and a CUDA trace names a launching thread by its pthread id, the
recorder by its native id).  An idle gap goes to the innermost span of the
loop's thread that covers half of it or more, else to the span that
covers most of it, else to `none`.  Times are in the trace's microseconds;
the spans' wall-clock ns are placed by the trace's `baseTimeNanoseconds`,
as `Trace.from_file` places the harness's own.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
LOOP_SPANS = ("train.step", "encode.batch")
PHASES = ("train.h2d", "train.forward", "train.backward", "train.update",
          "encode.h2d", "encode.forward", "encode.readback", "data.wait")
TRAIN_PHASES = ("train.forward", "train.backward", "train.update")
INPUT_PHASES = ("data.wait", "train.h2d")

# a program span on the trace's clock: (start us, end us, name, tid, args)
Span = Tuple[float, float, str, int, dict]


def spans_on_trace(records, base_ns: int) -> List[Span]:
    """The recorder's records (`spans.Span`) on the trace's timeline."""
    return [((r.start_ns - base_ns) / 1e3, (r.end_ns - base_ns) / 1e3,
             r.name, r.tid, r.args) for r in records]


class Attribution:
    """One traced window: its device events with their launches, the
    program's spans, and the trace reader of the harness over the same
    events (families, gaps, what the host was doing in a gap)."""

    def __init__(self, events: Sequence[dict], spans: Sequence[Span],
                 window: Tuple[float, float], families=None):
        from portbench.trace import DEVICE_CATS, Trace
        self.trace = Trace(events, families, window)
        w0, w1 = window
        launch: Dict[int, float] = {}
        device = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat, corr = e.get("cat", ""), e.get("args", {}).get("correlation")
            ts = float(e["ts"])
            if cat in LAUNCH_CATS and corr is not None:
                launch[corr] = ts
            elif cat in DEVICE_CATS:
                a, b = max(ts, w0), min(ts + float(e["dur"]), w1)
                if b > a:
                    device.append((a, b, e.get("name", ""), cat, corr))
        self.launch, self.device = launch, device
        self.spans = sorted((s for s in spans if s[1] > w0 and s[0] < w1),
                            key=lambda s: (s[0], -s[1]))
        loop = Counter(s[3] for s in self.spans if s[2] in LOOP_SPANS)
        tid = loop.most_common(1)[0][0] if loop else None
        self.loop = [s for s in self.spans if s[3] == tid]
        self.units = sum(loop.values())

    def chain(self, t: float) -> Tuple[str, ...]:
        """The names of the loop thread's spans open at `t`, outermost
        first."""
        return tuple(s[2] for s in self.loop if s[0] <= t < s[1])

    def device_s_by_span(self) -> Dict[Tuple[str, ...], Dict[str, float]]:
        """Device seconds by the chain of the spans each event was
        launched in (`("none",)` where no span covers its launch, `("no
        launch",)` where the trace holds no call with its correlation id),
        by family."""
        out: Dict[Tuple[str, ...], Counter] = defaultdict(Counter)
        for a, b, name, cat, corr in self.device:
            if corr in self.launch:
                key = self.chain(self.launch[corr]) or ("none",)
            else:
                key = ("no launch",)
            out[key][self.trace.fam(name, cat)] += (b - a) * 1e-6
        return {k: dict(v) for k, v in out.items()}

    def gap_span(self, a: float, b: float) -> Optional[Span]:
        """The span of the loop's thread a gap [a, b] is put down to."""
        over = [(min(b, s[1]) - max(a, s[0]), s) for s in self.loop
                if s[1] > a and s[0] < b]
        half = [s for o, s in over if o >= 0.5 * (b - a)]
        if half:
            return min(half, key=lambda s: s[1] - s[0])
        return max(over, key=lambda x: x[0])[1] if over else None

    def idle_by_span(self) -> Dict[Tuple[Tuple[str, ...], str], float]:
        """Idle seconds of the window's gaps, short ones included, by the
        chain of the span each gap is put down to (`("none",)` for none)
        and what the host was doing as `Trace.idle_by_host` names it."""
        t = self.trace
        own = [s for s in t.host if s[2].startswith("portbench.")]
        ops = sorted(s for s in t.host if not s[2].startswith("portbench."))
        starts = [s[0] for s in ops]
        out: Counter = Counter()
        for a, b in t.gaps():
            s = self.gap_span(a, b)
            chain = tuple(x[2] for x in self.loop
                          if x[0] <= s[0] and s[1] <= x[1]) if s \
                else ("none",)
            host = ("gaps under 20 us" if b - a < 20.0
                    else t._host_label(a, b, own, ops, starts))
            out[(chain, host)] += (b - a) * 1e-6
        return dict(out)

    def report(self) -> dict:
        """The window's device and idle time by span, in ms a unit (a
        step or a gallery batch), and the readings the spans give."""
        units = max(self.units, 1)
        ms = lambda s: 1e3 * s / units
        phase = lambda chain: next((n for n in chain if n in PHASES),
                                   chain[-1])
        dev = self.device_s_by_span()
        dev_leaf: Dict[str, Counter] = defaultdict(Counter)
        dev_phase: Counter = Counter()
        cluster = 0.0
        for chain, fams in dev.items():
            dev_leaf[chain[-1]].update(fams)
            dev_phase[phase(chain)] += sum(fams.values())
            cluster += sum(fams.values()) if "cluster" in chain else 0.0
        idle_phase: Counter = Counter()
        idle_host: Counter = Counter()
        for (chain, host), v in self.idle_by_span().items():
            idle_phase[phase(chain)] += v
            idle_host[(chain[-1], host)] += v
        device_s, idle_s = sum(dev_phase.values()), sum(idle_phase.values())
        waits = [s for s in self.loop if s[2] == "data.wait"]
        return {
            "units": self.units, "window_s": self.trace.window_s,
            "device_s": device_s,
            "device_s_in_a_span": device_s - dev_phase["none"]
            - dev_phase["no launch"],
            "idle_s": idle_s,
            "idle_s_in_a_span": idle_s - idle_phase["none"],
            "device_ms_by_phase": {k: ms(v) for k, v in
                                   dev_phase.most_common()},
            "device_ms_by_span_family": {
                k: {f: ms(v) for f, v in c.most_common()}
                for k, c in dev_leaf.items()},
            "idle_ms_by_phase": {k: ms(v) for k, v in
                                 idle_phase.most_common()},
            "idle_ms_by_span_host": [[s, h, ms(v)] for (s, h), v in
                                     idle_host.most_common()],
            "forward_ms": ms(dev_phase["train.forward"]),
            "backward_ms": ms(dev_phase["train.backward"]),
            "update_ms": ms(dev_phase["train.update"]),
            "h2d_span_ms": ms(dev_phase["train.h2d"]
                              + dev_phase["encode.h2d"]),
            "cluster_ms": ms(cluster),
            "launch_idle_ms": ms(sum(idle_phase[p] for p in TRAIN_PHASES)),
            "input_idle_ms": ms(sum(idle_phase[p] for p in INPUT_PHASES)),
            "data_ready": (100.0 * sum(bool(s[4].get("ready"))
                                       for s in waits) / len(waits)
                           if waits else None),
        }


def span_window(harness, spans, kept: list):
    """A `harness.Window` that turns the recorder on over a traced window
    and keeps the window's trace, its records and its ends in `kept`."""

    class SpanWindow(harness.Window):
        def __enter__(self):
            if self.trace:
                spans.take()
                spans.on()
            return super().__enter__()

        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            spans.off()
            self.records = spans.take()
            return out

        def read(self):
            if os.path.exists(self.path):
                with open(self.path) as f:
                    kept.append((json.load(f), self.records,
                                 (self.t0_ns, self.t1_ns)))
            return super().read()

    return SpanWindow


def attribute(data: dict, records, window_ns: Tuple[int, int]) -> dict:
    """The report of one kept window."""
    events = data["traceEvents"] if isinstance(data, dict) else data
    base = data.get("baseTimeNanoseconds", 0) if isinstance(data, dict) \
        else 0
    us = lambda ns: (ns - base) / 1e3
    window = (us(window_ns[0]), us(window_ns[1]))
    return Attribution(events, spans_on_trace(records, base),
                       window).report()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/attribution.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from centerclip_tpu_torch.utils import spans
    from portbench import harness, kinds
    from portbench import run as entry     # its kernel caches and start
    cell = harness.Cell(args.workload)
    kept: list = []
    kinds.Window = span_window(harness, spans, kept)
    res, _ = harness.run(cell, args.seed, 0.0, True, "cuda", entry.START)
    bad = harness.forbidden_modules()
    if bad or not kept:
        print(f"portbench: the run loaded {bad} or kept no traced window",
              file=sys.stderr)
        return 1
    res["spans"] = attribute(*kept[-1])
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
