"""Reading a chrome trace of `torch.profiler` (Kineto's format).

Device events are the `kernel`, `gpu_memcpy` and `gpu_memset` categories.
The traced window is the host span `portbench.window` where the trace has
one, else the one the caller gives: the harness traces the card's
activity alone (tracing every host operation too slows a host-bound step
by half), and gives the window and its own spans (`portbench.*`) in
wall-clock nanoseconds, which the trace's `baseTimeNanoseconds` maps onto
its timeline.  From them: the device's busy time (the union of its
events' spans inside the window), its idle gaps, each named by what the
host was doing meanwhile (the harness's own spans first, else the longest
host operation or CUDA runtime call under way), device time by kernel
family (the tables in `families/`), and communication kernels' time not
covered by a compute kernel on the same device.
"""
from __future__ import annotations

import bisect
import glob
import json
import os
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime",
             "cuda_driver")
WINDOW = "portbench.window"
SPAN_PREFIX = "portbench."
SHORT_GAP_US = 20.0
FAMILY_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "families")


def load_families(directory: str = FAMILY_DIR) -> List[dict]:
    """Every `families/*.json`, in their `order`: {name, order, match
    (substrings of a kernel name, any case), categories (optional: the
    trace categories the family takes whole)}."""
    fams = []
    for path in glob.glob(os.path.join(directory, "*.json")):
        with open(path) as f:
            fams.append(json.load(f))
    return sorted(fams, key=lambda f: (f["order"], f["name"]))


def family_of(name: str, cat: str, families: Sequence[dict]) -> str:
    low = name.lower()
    for fam in families:
        if cat in fam.get("categories", ()) \
                or any(m.lower() in low for m in fam.get("match", ())):
            return fam["name"]
    return "other"


class Trace:
    """The events of one chrome trace, split into device events and host
    spans, with the traced window."""

    def __init__(self, events: Sequence[dict],
                 families: Optional[Sequence[dict]] = None,
                 window: Optional[Tuple[float, float]] = None,
                 spans: Sequence[Tuple[float, float, str]] = ()):
        self.families = load_families() if families is None else families
        self.device: List[Tuple[float, float, str, str, str]] = []
        self.host: List[Tuple[float, float, str]] = []
        self.window = window
        self._fam: Dict[Tuple[str, str], str] = {}
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            ts, dur = float(e["ts"]), float(e["dur"])
            cat, name = e.get("cat", ""), e.get("name", "")
            if cat in DEVICE_CATS:
                dev = str(e.get("args", {}).get("device", e.get("pid")))
                self.device.append((ts, ts + dur, name, cat, dev))
            elif cat in HOST_CATS:
                if name == WINDOW:
                    self.window = (ts, ts + dur)
                else:
                    self.host.append((ts, ts + dur, name))
        self.host.extend(spans)
        if self.window is None:
            raise ValueError(f"the trace has no {WINDOW!r} span")
        w0, w1 = self.window
        self.device = sorted(
            (max(a, w0), min(b, w1), n, c, d) for a, b, n, c, d in self.device
            if b > w0 and a < w1)

    def fam(self, name: str, cat: str) -> str:
        """The family of a device event (memoised)."""
        key = (name, cat)
        if key not in self._fam:
            self._fam[key] = family_of(name, cat, self.families)
        return self._fam[key]

    @classmethod
    def from_file(cls, path: str, families=None,
                  window_ns: Optional[Tuple[int, int]] = None,
                  spans_ns: Sequence[Tuple[int, int, str]] = ()) -> "Trace":
        """A trace file; `window_ns` and `spans_ns` in wall-clock ns
        (`time.time_ns()`), placed by the file's `baseTimeNanoseconds`."""
        with open(path) as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        base = data.get("baseTimeNanoseconds", 0) if isinstance(data, dict) \
            else 0
        us = lambda ns: (ns - base) / 1e3
        window = (us(window_ns[0]), us(window_ns[1])) if window_ns else None
        return cls(events, families, window,
                   [(us(a), us(b), n) for a, b, n in spans_ns])

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def devices(self) -> List[str]:
        return sorted({d for *_, d in self.device})

    def busy_intervals(self, device: Optional[str] = None,
                       families: Optional[Sequence[str]] = None
                       ) -> List[Tuple[float, float]]:
        """The union of the device's event spans (of `families` only, where
        given), merged and sorted."""
        spans = sorted(
            (a, b) for a, b, n, c, d in self.device
            if (device is None or d == device)
            and (families is None
                 or self.fam(n, c) in families))
        merged: List[List[float]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        """Seconds in which an operation ran, averaged over the devices
        (0 where the trace holds no device event)."""
        devs = self.devices()
        if not devs:
            return 0.0
        return sum(sum(b - a for a, b in self.busy_intervals(d))
                   for d in devs) * 1e-6 / len(devs)

    def idle_share(self) -> float:
        return 1.0 - self.busy_s() / self.window_s

    def family_s(self) -> Dict[str, float]:
        """Device seconds by family (summed over devices and streams)."""
        out: Counter = Counter()
        for a, b, n, c, _ in self.device:
            out[self.fam(n, c)] += (b - a) * 1e-6
        return dict(out)

    def gaps(self, device: Optional[str] = None
             ) -> List[Tuple[float, float]]:
        """The device's idle spans inside the window."""
        w0, w1 = self.window
        out, t = [], w0
        for a, b in self.busy_intervals(device or (self.devices() or [None])[0]):
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if t < w1:
            out.append((t, w1))
        return out

    def _host_label(self, a: float, b: float, own, ops, op_starts) -> str:
        """What the host was doing over [a, b]: the harness span that
        covers most of it, where one covers half or more, else the longest
        host operation among the last 2000 begun before b that overlaps
        it."""
        best = max(((min(s1, b) - max(s0, a), n) for s0, s1, n in own
                    if s1 > a and s0 < b), default=None)
        if best is not None and best[0] >= 0.5 * (b - a):
            return best[1]
        i = bisect.bisect_right(op_starts, b)
        cands = [(s1 - s0, n) for s0, s1, n in ops[max(0, i - 2000):i]
                 if s1 > a]
        return f"host: {max(cands)[1]}" if cands else "host"

    def idle_by_host(self, device: Optional[str] = None
                     ) -> List[Tuple[str, float]]:
        """Idle seconds by what the host was doing, longest first; gaps
        under 20 us are counted together as launch gaps."""
        own = [s for s in self.host if s[2].startswith(SPAN_PREFIX)]
        ops = sorted(s for s in self.host if not s[2].startswith(SPAN_PREFIX))
        op_starts = [s[0] for s in ops]
        out: Counter = Counter()
        for a, b in self.gaps(device):
            if b - a < SHORT_GAP_US:
                out["gaps under 20 us"] += (b - a) * 1e-6
            else:
                out[self._host_label(a, b, own, ops, op_starts)] += \
                    (b - a) * 1e-6
        return out.most_common()

    def exposed_s(self, family: str, device: Optional[str] = None) -> float:
        """Seconds of `family`'s kernels on `device` during which no kernel
        of another family (other than copies) runs on it."""
        dev = device or (self.devices() or [None])[0]
        comm = [(a, b) for a, b, n, c, d in self.device
                if d == dev and self.fam(n, c) == family]
        others = [(a, b) for a, b, n, c, d in self.device
                  if d == dev and c == "kernel"
                  and self.fam(n, c) != family]
        others.sort()
        merged: List[List[float]] = []
        for a, b in others:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        total = 0.0
        for a, b in comm:
            covered = sum(max(0.0, min(b, m1) - max(a, m0))
                          for m0, m1 in merged if m1 > a and m0 < b)
            total += (b - a) - covered
        return total * 1e-6

    def breakdown(self, top: int = 10) -> dict:
        fam = sorted(self.family_s().items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in fam],
                "idle_gaps": [[k, v] for k, v in self.idle_by_host()[:top]]}
