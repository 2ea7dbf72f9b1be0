"""The control, the reference one precision below the program's bf16
(fp8 matmul operands), reads farther from the fp32 reference than the
program does, and so does the control with fp8 in the vision tower alone
on the vision tower's number: at a tiny size here, and at each cell's own
size on the chip by `portbench/control.py` (PERF.md gives those
readings)."""
import pytest

from portbench import control, kinds
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


def test_spectral_readings(tiny_env, pinned_medoids):
    """A spectral cell's program reading carries the first step's cluster
    layer judged in the reference, the controls score the reference's own
    ids at their precision, the faults planted in the solve are read, and
    the fault `unscaled` runs the weights at `stream_scale` 1."""
    cell = tiny.cell("train", algo="spectral", stream_scale=0.5)
    got = {r: (n, norms) for r, n, norms in control.readings(cell, 5, True,
                                                             "cpu")}
    assert set(got) == {"program", "unscaled", "control", "control_vision",
                        "half_batch", *control.SOLVE_FAULTS}
    sp = got["program"][1]["spectral"]
    assert sp["segments"] == 16 and sp["identity_segments"] == 0
    # the medoids are pinned on both sides: every segment agrees
    assert sp["agreement"] == 1.0 and 0.0 <= sp["near_ties"] <= 1.0
    assert sp["cost_excess"] == 0.0
    assert got["program"][0]["cluster_cost_excess"] == 0.0
    assert 1.0 < sp["median_sigmas"] < 6.0
    assert "pre_cluster_update_gap_median" in got["control"][0]
    assert "cluster_cost_excess" in got["control"][0]
    for name in control.SOLVE_FAULTS:
        assert set(got[name][0]) == {"identity_segments",
                                     "cluster_cost_excess"}


@pytest.mark.parametrize("fault", ["random_medoids", "top_spectrum"])
def test_a_solve_fault_costs_more_than_the_program(tiny_env, fault):
    """Unpinned, on tokens ~3 sigma apart: the program's medoids cost
    within a few per cent of the reference's own (-0.013 to 0.006 on
    three seeds), medoids drawn at random or from the wrong end of the
    spectrum 70 % more or worse."""
    cell = tiny.cell("train", algo="spectral", stream_scale=0.5)
    setup = kinds.TrainSetUp(cell, 3, "cpu")
    setup.close()
    with control.solve_fault(fault):
        bad = kinds.TrainSetUp(cell, 3, "cpu")
    bad.close()
    sound = setup.cluster_layer()["cost_excess"]
    assert abs(sound) < 0.05
    assert bad.cluster_layer()["cost_excess"] > 0.3
