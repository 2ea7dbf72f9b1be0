"""Device time and idle gaps put down to the program's spans, on a small
synthetic chrome trace with correlation ids, and a traced tiny run with
the recorder on."""
import time

import pytest

from portbench import attribution, harness, kinds
from portbench.tests import tiny
from portbench.trace import Trace

LOOP, AUTOGRAD, WORKER = 11, 12, 13


def ev(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
            "pid": 0, "tid": 7, "args": {"device": 0, "correlation": corr}}


def call(name, ts, dur, corr, tid=LOOP, cat="cuda_runtime"):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
            "pid": 1, "tid": tid, "args": {"correlation": corr}}


EVENTS = [
    call("cudaMemcpyAsync", 12, 4, 1),
    ev("Memcpy HtoD (Pinned -> Device)", 20, 30, 1, "gpu_memcpy"),  # 20-50
    call("cudaLaunchKernel", 62, 3, 2),
    ev("sm90_xmma_gemm_bf16bf16_bf16f32", 70, 60, 2),             # 70-130
    call("cudaLaunchKernel", 132, 3, 3),
    ev("kmedoids_global_kernel<1>", 140, 20, 3),                  # 140-160
    # launched by autograd's thread while the loop waits in the backward
    call("cuLaunchKernelEx", 205, 3, 4, AUTOGRAD, "cuda_driver"),
    ev("attention_bwd_dq_kernel", 210, 50, 4),                    # 210-260
    call("cudaLaunchKernel", 262, 3, 5, AUTOGRAD),
    ev("vectorized_elementwise_kernel", 300, 40, 5),              # 300-340
    call("cudaLaunchKernel", 352, 2, 6),
    ev("multi_tensor_apply_kernel", 360, 20, 6),                  # 360-380
    ev("Memset (Device)", 390, 5, 99, "gpu_memset"),              # no call
]
# (start us, end us, name, tid, args), as `spans_on_trace` gives them
SPANS = [
    (0, 12, "data.wait", LOOP, {"ready": False}),
    (2, 11, "data.gather", WORKER, {}),
    (12, 390, "train.step", LOOP, {"step": 1}),
    (12, 18, "train.h2d", LOOP, {}),
    (60, 200, "train.forward", LOOP, {}),
    (130, 170, "cluster", LOOP, {"algo": "kmediods++", "segments": 6}),
    (200, 350, "train.backward", LOOP, {}),
    (261, 290, "elsewhere", AUTOGRAD, {}),      # not the loop's thread
    (350, 385, "train.update", LOOP, {}),
]
WINDOW = (0.0, 400.0)


def attrib():
    return attribution.Attribution(EVENTS, SPANS, WINDOW)


def test_device_time_goes_to_the_span_of_its_launch():
    dev = attrib().device_s_by_span()
    assert dev[("train.step", "train.h2d")] == {"h2d": pytest.approx(30e-6)}
    assert dev[("train.step", "train.forward")] == \
        {"gemm": pytest.approx(60e-6)}
    assert dev[("train.step", "train.forward", "cluster")] == \
        {"kmedoids": pytest.approx(20e-6)}
    # launched by autograd's thread: the loop's spans at the launch
    assert dev[("train.step", "train.backward")] == \
        {"attn_bwd": pytest.approx(50e-6), "elementwise": pytest.approx(40e-6)}
    assert dev[("train.step", "train.update")] == \
        {"optimizer": pytest.approx(20e-6)}
    assert dev[("no launch",)] == {"copies": pytest.approx(5e-6)}


def test_idle_gaps_go_to_the_innermost_span_of_the_loop_thread():
    idle = {}
    for (chain, _), v in attrib().idle_by_span().items():
        idle[chain] = idle.get(chain, 0.0) + v
    # gaps 0-20, 50-70, 130-140, 160-210, 260-300, 340-360, 380-390, 395-400
    assert idle == pytest.approx({
        ("data.wait",): 20e-6,                          # 12 of its 20 us
        ("train.step", "train.forward"): 20e-6 + 50e-6,
        ("train.step", "train.forward", "cluster"): 10e-6,
        ("train.step", "train.backward"): 40e-6,        # not autograd's
        ("train.step", "train.update"): 20e-6 + 10e-6,
        ("none",): 5e-6})


def test_the_report_reads_the_phases_and_the_loader():
    rep = attrib().report()
    assert rep["units"] == 1
    assert rep["forward_ms"] == pytest.approx(80e-3)
    assert rep["backward_ms"] == pytest.approx(90e-3)
    assert rep["update_ms"] == pytest.approx(20e-3)
    assert rep["h2d_span_ms"] == pytest.approx(30e-3)
    assert rep["cluster_ms"] == pytest.approx(20e-3)
    assert rep["device_s"] == pytest.approx(225e-6)
    assert rep["device_s_in_a_span"] == pytest.approx(220e-6)
    assert rep["idle_s"] == pytest.approx(175e-6)
    assert rep["idle_s_in_a_span"] == pytest.approx(170e-6)
    assert rep["launch_idle_ms"] == pytest.approx(150e-3)
    assert rep["input_idle_ms"] == pytest.approx(20e-3)
    assert rep["data_ready"] == 0.0


def test_the_harness_reader_reads_the_same_with_program_spans():
    base = Trace(EVENTS, window=WINDOW)
    mine = attrib().trace
    assert mine.breakdown() == base.breakdown()
    assert mine.family_s() == base.family_s()
    assert mine.idle_by_host() == base.idle_by_host()
    assert mine.busy_s() == base.busy_s()


def test_a_traced_tiny_run_keeps_the_window_and_its_spans(tiny_env,
                                                         monkeypatch):
    from centerclip_tpu_torch.utils import spans
    kept = []
    monkeypatch.setattr(kinds, "Window",
                        attribution.span_window(harness, spans, kept))
    res, _ = harness.run(tiny.cell("train"), seed=5, seconds=0.2,
                         trace=True, device="cpu", start=time.time())
    assert not spans.enabled() and "breakdown" in res
    (data, records, (t0, t1)), = kept
    steps = [r for r in records if r.name == "train.step"]
    assert len(steps) == tiny.TRAIN["trace_steps"]
    assert all(t0 <= r.start_ns <= r.end_ns <= t1 for r in steps)
    rep = attribution.attribute(data, records, (t0, t1))
    assert rep["units"] == len(steps)
    assert rep["data_ready"] is not None
    assert rep["idle_s"] == pytest.approx(rep["window_s"])    # no card
