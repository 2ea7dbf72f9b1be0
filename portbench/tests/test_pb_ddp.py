"""The multi-rank runner on four gloo ranks at the tiny size: a sound run
is correct, a run with the exchange between the ranks left out or with a
shard read twice is not, a rank that raises or hangs ends the run with
no rank left behind, every rank takes rank 0's step count, and the
control's readings on the ranks separate as on the chip."""
import glob
import json
import os
import sys
import time

import pytest

from portbench import ddp, harness
from portbench.tests import tiny
from portbench.tests.test_pb_faults import LIMITS

ENTRY = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "ddp_rank.py")


def run(cache, fault=None, on=(1,), timeout=300.0):
    cell = tiny.cell("train_ddp")
    extra = ["--cache", cache]
    if fault:
        extra += ["--fault", fault, "--on", *map(str, on)]
    return ddp.run(cell, seed=11, seconds=0.2, trace=False,
                   start=time.time(), entry=ENTRY, extra=extra,
                   timeout=timeout)


def ranks_alive(cache):
    """Processes of this machine started with this test's cache."""
    alive = []
    for path in glob.glob("/proc/[0-9]*/cmdline"):
        try:
            with open(path, "rb") as f:
                words = f.read().split(b"\0")
        except OSError:
            continue
        if ENTRY.encode() in words and cache.encode() in words:
            alive.append(path)
    return alive


def test_four_ranks_run_the_cell_correct(tiny_env):
    res, phases, loaded = run(tiny_env)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {m["name"] for m in
                                   tiny.cell("train_ddp").end_to_end()}
    assert res["metrics"]["ddp_train_clips_per_s"]["value"] > 0
    assert res["device"]["count"] == 4 and res["attempted"] >= 1
    assert res["checks"]["data_rows_repeated"]["value"] == 0
    assert loaded == [] and phases


@pytest.mark.parametrize("fault,on,number", [
    ("no_allreduce", (0, 1, 2, 3), "grad_gap"),
    ("same_shard", (0, 1, 2, 3), "data_rows_repeated")])
def test_a_fault_across_the_ranks_is_not_correct(tiny_env, fault, on,
                                                 number):
    res, _, _ = run(tiny_env, fault, on)
    assert not res["correct"]
    check = res["checks"][number]
    assert check["value"] > check["limit"], res["checks"]


def test_every_rank_takes_rank_0s_step_count(tiny_env):
    """Rank 1's clock stands still, so a count of its own would divide by
    nought; the run takes rank 0's on every rank (it raises where the
    ranks' counts differ)."""
    res, _, _ = run(tiny_env, "frozen_clock", on=(1,))
    assert res["correct"] and res["attempted"] >= 1


@pytest.mark.parametrize("fault,timeout,within", [("raise", 300.0, 150.0),
                                                  ("hang", 45.0, 75.0)])
def test_a_rank_that_raises_or_hangs_ends_the_run(tiny_env, fault, timeout,
                                                  within):
    t = time.monotonic()
    with pytest.raises(ddp.RanksFailed):
        run(tiny_env, fault, on=(1,), timeout=timeout)
    assert time.monotonic() - t < within
    assert ranks_alive(tiny_env) == []


def test_the_control_and_the_faults_on_the_ranks(tiny_env):
    """`control.py`'s readings of a multi-rank cell, at the tiny size: the
    program's are correct; the fp8 control reads three times the program
    on some number; the exchange left out and half the batch fail."""
    cell = tiny.cell("train_ddp")
    ddp.ensure_data(cell)
    result = os.path.join(tiny_env, "control.json")
    ddp.launch(4, ENTRY, ["--workload", cell.name, "--seed", "5",
                          "--seconds", "0", "--start", "0", "--result",
                          result, "--cache", tiny_env, "--control"],
               timeout=300.0)
    with open(result) as f:
        got = dict((r, n) for r, n in json.load(f))
    assert set(got) == {"program", "no_allreduce", "control",
                        "control_vision", "half_batch"}
    limits = {**LIMITS, "data_rows_repeated": 0}
    prog = got["program"]
    assert harness.judge(prog, limits)[0], prog
    assert any(got["control"][k] >= 3 * prog[k] for k in got["control"])
    assert not harness.judge(got["no_allreduce"], limits)[0]
    assert got["half_batch"]["loss_gap"] > LIMITS["loss_gap"]


def test_run_exits_nonzero_and_prints_no_result_when_a_rank_fails(
        monkeypatch, capsys):
    import torch

    def failed(*a, **k):
        raise ddp.RanksFailed("rank 2 exited with code 1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(ddp, "run", failed)
    rc = harness.main(["--workload", "vitb16_k6.train_ddp4", "--seed", "1",
                       "--seconds", "1"])
    assert rc != 0
    out = capsys.readouterr()
    assert out.out == "" and "rank 2" in out.err


def test_fewer_cards_than_ranks_exit_2(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert harness.main(["--workload", "vitb16_k6.train_ddp4", "--seed",
                         "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_a_rank_dies_with_the_harness(tmp_path):
    """A rank whose harness has gone exits at once."""
    import subprocess
    code = ("import sys; sys.path.insert(0, {root!r}); "
            "from portbench import ddp; ddp.die_with(1)").format(
                root=harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], timeout=60)
    assert out.returncode == 1
