"""The control, the reference one precision below the program's bf16
(fp8 matmul operands), reads farther from the fp32 reference than the
program does, and so does the control with fp8 in the vision tower alone
on the vision tower's number: at a tiny size here, and at each cell's own
size on the chip by `portbench/control.py` (PERF.md gives those
readings)."""
import pytest

from portbench import control
from portbench.tests import tiny


@pytest.mark.parametrize("kind", ["train", "encode"])
def test_the_control_reads_three_times_the_program(tiny_env,
                                                   pinned_medoids, kind):
    got = {r: n for r, n, _ in control.readings(tiny.cell(kind), 5, True,
                                                 "cpu")}
    prog, ctl = got["program"], got["control"]
    assert any(ctl[k] >= 3 * prog[k] for k in prog), (prog, ctl)
    if kind == "train":
        half = got["half_batch"]
        assert half["loss_gap"] >= 3 * prog["loss_gap"]
        key = "vision_update_gap_median"
        assert got["control_vision"][key] >= 2 * prog[key]
