# coding=utf-8
"""Spans of the program's layers, on the host's wall clock.

A device trace names each kernel and copy and the CUDA call that launched
it; a span names the layer of the program the host was in meanwhile:
`train.step` and its `train.h2d`, `train.forward`, `train.backward` and
`train.update`; `cluster` (the token clustering before a ViT block, in the
forward or in remat's recompute); the loader's `data.wait` and
`data.gather`; the gallery encode's `encode.batch` with its `encode.h2d`,
`encode.forward` and `encode.readback`.  Each record holds its name, its
start and end in `time.time_ns()`, the enclosing span of the same thread
(its parent, by name), the thread's native id (the one `torch.profiler`
gives the host operators of that thread) and the span's small arguments.

The recorder is off unless a caller turns it on (`on()`; the `Trainer`
does so over its `--profile_dir` steps, and writes the spans into that
trace).  Off, `span()` reads one module global and hands back a shared
no-op context: no clock is read and nothing is allocated.  `take()`
returns the records kept so far and clears them.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import List, NamedTuple, Optional, Sequence

_on = False
_records: List["Span"] = []
_open = threading.local()          # the open spans of each thread


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    tid: int
    args: dict


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NOSPAN = _NoSpan()


class _Open:
    __slots__ = ("name", "args", "start", "parent", "stack")

    def __init__(self, name: str, args: dict):
        self.name, self.args = name, args

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1].name if stack else None
        self.stack = stack
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.stack.pop()
        _records.append(Span(self.name, self.start, end, self.parent,
                             threading.get_native_id(), self.args))
        return False


def span(name: str, **args):
    """A context that records one span of `name` with `args` while the
    recorder is on, else the shared no-op."""
    if not _on:
        return NOSPAN
    return _Open(name, args)


def on() -> None:
    global _on
    _on = True


def off() -> None:
    """Stop recording; spans open now are still kept when they end."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def take() -> List[Span]:
    """The records kept so far, in the order they ended; clears them."""
    global _records
    out, _records = _records, []
    return out


def write_into_chrome_trace(path: str, records: Sequence[Span]) -> None:
    """Add `records` to the chrome trace at `path` (a `torch.profiler`
    export) as `user_annotation` events of this process, placed on the
    trace's timeline by its `baseTimeNanoseconds`, so that a trace viewer
    shows them beside the kernels."""
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    trace["traceEvents"].extend(
        {"ph": "X", "cat": "user_annotation", "name": r.name, "pid": pid,
         "tid": r.tid, "ts": (r.start_ns - base) / 1e3,
         "dur": (r.end_ns - r.start_ns) / 1e3, "args": r.args}
        for r in records)
    with open(path, "w") as f:
        json.dump(trace, f)
