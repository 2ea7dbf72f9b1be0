#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of `BENCHMARK.json`.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Cells: `vitb32_k6.train` (ViT-B/32 training at batch 128 from the
`.fstore` loader), `vitb16_k6.train` (ViT-B/16 with remat) and
`vitb16_k6.encode` (a 1,024-clip gallery in batches of 128), each on one
card, and `vitb16_k6.train_ddp4` (ViT-B/16 under DDP, a process on each of
four cards: `ddp.py`).  Run from the root of a checkout on a machine with
the cell's CUDA devices; the first run of a checkout builds the port's
kernels and writes the training data under `portbench/.cache/`.  The last line of standard
output is the result's JSON; the numbers that decide `correct` are the
last lines of standard error.  See `harness.py`.
"""
import os
import sys
import time


def _process_start() -> float:
    """The wall-clock time this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel caches at fixed paths inside the checkout: only a checkout's
# first run compiles (the port's nvcc libraries go to its own build/)
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "portbench", ".cache",
                                              "triton")
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from portbench.harness import main
    sys.exit(main(sys.argv[1:], start=START))
