"""The runs of a multi-rank cell: one process a card, as `torchrun` starts
the program.

The harness's process (`run`) writes the cell's training data once, then
starts the traffic's `ranks` processes of this file, each with the
environment that the program's `parallel/mesh.init_distributed` reads
(`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT` on a
free port of this host) and, as `torchrun` gives it, `OMP_NUM_THREADS=1`
where the environment sets none.  Each rank joins the program's process
group and runs the cell's runner (`kinds.py`, traffic kind `train_ddp`);
rank 0 builds the result and writes it to a file that the harness's
process reads back and prints.  The ranks' standard output goes to the
harness's standard error, so that its own last line of output is the
result.

A rank that exits with another code than 0 ends the run: the harness
kills the other ranks, waits for each, and raises `RanksFailed`; so does a
run whose ranks have not all ended after `timeout` seconds.  Each rank
is killed by the kernel when the harness's process dies
(`PR_SET_PDEATHSIG`), so that no rank outlives a run that was itself
killed.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional, Sequence, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRY = os.path.abspath(__file__)
# a run of a checkout's first compile may take 1200 s; no sound run of a
# rank lasts this long
TIMEOUT = 1140.0
POLL_S = 0.2


class RanksFailed(RuntimeError):
    """A rank exited with another code than 0, or the ranks outlasted the
    run's timeout."""


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(ranks: int, entry: str, argv: Sequence[str],
           timeout: float = TIMEOUT, stdout=2) -> None:
    """Run `ranks` processes of `entry` with `argv` and the process
    group's environment until all have exited with 0 (module docstring);
    `stdout`: where their standard output goes (a file descriptor, or
    None for this process's own)."""
    port = free_port()
    procs: List[subprocess.Popen] = []
    try:
        for rank in range(ranks):
            env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                       WORLD_SIZE=str(ranks), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port))
            env.setdefault("OMP_NUM_THREADS", "1")
            procs.append(subprocess.Popen(
                [sys.executable, entry, *argv, "--parent", str(os.getpid())],
                env=env, stdout=stdout, cwd=ROOT))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                raise RanksFailed(f"rank {bad[0][0]} exited with code "
                                  f"{bad[0][1]}")
            if all(c == 0 for c in codes):
                return
            if time.monotonic() > deadline:
                raise RanksFailed(
                    f"ranks {[r for r, c in enumerate(codes) if c is None]} "
                    f"still ran after {timeout:.0f} s")
            time.sleep(POLL_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()


def ensure_data(cell) -> None:
    """The cell's training data, written once before the ranks start
    (each rank then finds it complete)."""
    from . import kinds, synth
    t, s = cell.traffic, cell.shapes
    synth.ensure_msrvtt(os.path.join(kinds.CACHE, "data", t["dataset"]),
                        t["videos"], s.frames, s.resolution,
                        t["captions_per_clip"])


def run(cell, seed: int, seconds: float, trace: bool, start: float,
        entry: str = ENTRY, extra: Sequence[str] = (),
        timeout: float = TIMEOUT) -> Tuple[dict, list, list]:
    """One run of a multi-rank cell: (result, set-up phases, the modules
    of JAX or the JAX package that any rank had loaded).  `entry` and
    `extra` (more arguments for it) start the ranks."""
    from . import kinds
    ensure_data(cell)
    result = os.path.join(kinds.CACHE, "ddp", cell.name + ".json")
    os.makedirs(os.path.dirname(result), exist_ok=True)
    if os.path.exists(result):
        os.remove(result)
    launch(cell.ranks, entry,
           ["--workload", cell.name, "--seed", str(seed),
            "--seconds", repr(float(seconds)), "--trace", str(int(trace)),
            "--start", repr(float(start)), "--result", result, *extra],
           timeout)
    with open(result) as f:
        got = json.load(f)
    os.remove(result)
    return got["result"], [tuple(p) for p in got["phases"]], got["loaded"]


class Ranks:
    """This rank's place in the program's process group, and a gloo group
    of the harness's own over the same ranks for its exchanges on the
    host (the step count, the barrier at the window's ends, the kept
    batches and readings to rank 0), so that none of them runs on a
    card."""

    def __init__(self):
        import torch.distributed as dist
        self.rank, self.size = dist.get_rank(), dist.get_world_size()
        self.group = dist.new_group(backend="gloo")

    def gather(self, obj) -> Optional[list]:
        """Rank 0: every rank's `obj` in rank order; else None."""
        import torch.distributed as dist
        out = [None] * self.size if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.group)
        return out

    def broadcast(self, value):
        """Rank 0's `value`, on every rank."""
        import torch.distributed as dist
        box = [value]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def barrier(self) -> None:
        import torch.distributed as dist
        dist.barrier(group=self.group)


def die_with(parent: int) -> None:
    """Have the kernel kill this process when its parent dies; exit now if
    `parent` has already gone."""
    import ctypes
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        print(f"portbench: rank {os.environ.get('RANK')}: its harness "
              f"(process {parent}) has gone", file=sys.stderr, flush=True)
        os._exit(1)


def parse(argv=None) -> Tuple[argparse.Namespace, List[str]]:
    """A rank's arguments (`run`'s), and the rest for the caller."""
    ap = argparse.ArgumentParser(prog="portbench/ddp.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--start", type=float, required=True)
    ap.add_argument("--result", required=True)
    ap.add_argument("--parent", type=int, required=True)
    return ap.parse_known_args(argv)


def rank_main(cell, args: argparse.Namespace, device=None) -> int:
    """One rank: join the program's process group (on `cuda:LOCAL_RANK`
    unless `device` names another), run the cell's runner, and on rank 0
    write the result, the phases and the modules that any rank loaded."""
    die_with(args.parent)
    import torch.distributed as dist
    from centerclip_tpu_torch.parallel.mesh import init_distributed
    from .harness import forbidden_modules, outcome
    from .kinds import KINDS
    device = init_distributed(device)
    try:
        out = KINDS[cell.traffic["kind"]](cell, args.seed, args.seconds,
                                          bool(args.trace), device,
                                          args.start)
        if out is None:
            return 0
        loaded = out.pop("loaded")
        res, phases = outcome(cell, out, bool(args.trace), device)
        tmp = args.result + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"result": res, "phases": phases,
                       "loaded": sorted(set(loaded)
                                        | set(forbidden_modules()))}, f)
        os.replace(tmp, args.result)
        return 0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from portbench import ddp
    from portbench.harness import Cell
    _args, _rest = ddp.parse()
    if _rest:
        sys.exit(f"portbench/ddp.py: unknown arguments {_rest}")
    sys.exit(ddp.rank_main(Cell(_args.workload), _args))
