"""A rank of the tiny multi-rank cell, for the CPU tests: `ddp.rank_main`
on gloo with the tiny arch, the medoids pinned, the test's cache, and
the fault that `--fault` names on the ranks that `--on` names; with
`--control`, the control's readings of the seed (`control.readings`)
instead of a run, which rank 0 writes to the result file as a JSON list
of [reading, numbers].

    python portbench/tests/ddp_rank.py <ddp.py's arguments> --cache DIR \
        [--fault NAME] [--on RANK ...] [--control]
"""
import argparse
import json
import os
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def raise_in_set_up():
    from portbench import kinds
    init = kinds.RankSetUp.__init__

    def broken(self, *a, **k):
        init(self, *a, **k)
        raise RuntimeError("a rank that raises in its set-up")
    kinds.RankSetUp.__init__ = broken


def hang_in_set_up():
    from portbench import kinds
    kinds.RankSetUp.__init__ = lambda self, *a, **k: time.sleep(3600)


def frozen_clock():
    """This rank's clock stands still: a step count it worked out from
    its own warm-up would divide by nought."""
    from portbench import kinds
    kinds.time = types.SimpleNamespace(time=time.time,
                                       perf_counter=lambda: 0.0)


def same_shard():
    """Every rank reads the first rank's shard."""
    import centerclip_tpu_torch.data.registry as registry
    registry.data_shard_geometry = lambda *a, **k: (0, 4)


def no_allreduce():
    from portbench import control
    global _HELD
    # held for the process's life: its generator restores on being freed
    _HELD = control.no_allreduce()
    _HELD.__enter__()


FAULTS = {"raise": raise_in_set_up, "hang": hang_in_set_up,
          "frozen_clock": frozen_clock, "same_shard": same_shard,
          "no_allreduce": no_allreduce}


def main():
    from portbench import ddp, kinds
    from portbench.tests import tiny
    from portbench.tests.test_pb_faults import LIMITS
    args, rest = ddp.parse()
    ap = argparse.ArgumentParser()
    ap.add_argument("--cache", required=True)
    ap.add_argument("--fault", choices=sorted(FAULTS))
    ap.add_argument("--on", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--control", action="store_true")
    extra = ap.parse_args(rest)
    tiny.register()
    tiny.pin_medoids()
    kinds.CACHE = extra.cache
    if extra.fault and int(os.environ["RANK"]) in extra.on:
        FAULTS[extra.fault]()
    cell = tiny.cell("train_ddp", limits={**LIMITS, "data_rows_repeated": 0})
    if extra.control:
        return control_readings(cell, args)
    return ddp.rank_main(cell, args, device="cpu")


def control_readings(cell, args) -> int:
    import torch.distributed as dist
    from centerclip_tpu_torch.parallel.mesh import init_distributed
    from portbench import control, ddp
    ddp.die_with(args.parent)
    device = init_distributed("cpu")
    try:
        got = [[r, n] for r, n, _ in control.readings(
            cell, args.seed, True, device, ddp.Ranks())]
        if dist.get_rank() == 0:
            with open(args.result, "w") as f:
                json.dump(got, f)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
