"""The trace reader on a small synthetic chrome trace."""
import pytest

from portbench.trace import Trace, load_families


def ev(name, ts, dur, cat="kernel", device=0):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
            "pid": device, "args": {"device": device}}


def host(name, ts, dur, cat="cpu_op"):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
            "pid": 1, "tid": 1}


EVENTS = [
    host("portbench.window", 0, 1000, "user_annotation"),
    ev("attention_fwd_long_kernel<64>", 100, 200),              # 100-300
    ev("sm90_xmma_gemm_bf16bf16_bf16f32", 250, 150),            # 250-400
    ev("ncclDevKernel_AllReduce_Sum_f32", 600, 100),            # 600-700
    ev("vectorized_elementwise_kernel", 650, 30),               # 650-680
    ev("Memcpy HtoD (Pinned -> Device)", 900, 50, "gpu_memcpy"),
    ev("multi_tensor_apply_kernel", 1100, 50),                  # outside
    host("portbench.data_wait", 420, 170, "user_annotation"),   # gap 400-600
    host("aten::mm", 20, 60),                                   # gap 0-100
    host("aten::copy_", 710, 150),                              # gap 700-900
    {"ph": "i", "name": "marker", "ts": 5},
]


def test_busy_idle_and_window():
    t = Trace(EVENTS)
    assert t.window_s == pytest.approx(1e-3)
    # union: 100-400, 600-700, 900-950
    assert t.busy_s() == pytest.approx(450e-6)
    assert t.idle_share() == pytest.approx(0.55)


def test_family_grouping():
    fam = Trace(EVENTS).family_s()
    assert fam["attn_fwd"] == pytest.approx(200e-6)
    assert fam["gemm"] == pytest.approx(150e-6)
    assert fam["nccl"] == pytest.approx(100e-6)
    assert fam["elementwise"] == pytest.approx(30e-6)
    assert fam["h2d"] == pytest.approx(50e-6)
    assert "optimizer" not in fam          # outside the window


def test_exposed_communication():
    # the all-reduce 600-700 is covered by the elementwise kernel 650-680
    assert Trace(EVENTS).exposed_s("nccl") == pytest.approx(70e-6)


def test_idle_gaps_by_what_the_host_did():
    gaps = dict(Trace(EVENTS).idle_by_host())
    assert gaps["portbench.data_wait"] == pytest.approx(200e-6)
    assert gaps["host: aten::mm"] == pytest.approx(100e-6)
    assert gaps["host: aten::copy_"] == pytest.approx(200e-6)
    assert sum(gaps.values()) == pytest.approx(550e-6)


def test_breakdown_lists_at_most_ten_and_sorts():
    b = Trace(EVENTS).breakdown()
    assert [k for k, _ in b["device_ops"]][:2] == ["attn_fwd", "gemm"]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(ValueError):
        Trace([ev("k", 0, 1)])


def test_library_kernels_count_in_the_same_family():
    fams = load_families()
    t = Trace([host("portbench.window", 0, 100, "user_annotation"),
               ev("pytorch_flash::flash_fwd_kernel", 0, 10),
               ev("fmha_cutlassB_bf16_aligned_64x64_k64_sm80", 10, 10),
               ev("ln_fwd_vector_kernel", 20, 10),
               ev("vectorized_layer_norm_kernel", 30, 10),
               ev("kmedoids_global_kernel<1>", 40, 10)], fams)
    fam = t.family_s()
    assert fam == pytest.approx({"attn_fwd": 10e-6, "attn_bwd": 10e-6,
                                 "layernorm": 20e-6, "kmedoids": 10e-6})
