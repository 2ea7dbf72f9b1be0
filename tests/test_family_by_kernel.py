# coding=utf-8
"""`scripts/family_by_kernel.py`: a family's device time split by kernel
name, on a trace made here (the script's traced run needs a card)."""
import importlib.util
import os

import pytest

from portbench.trace import Trace, load_families

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "family_by_kernel", os.path.join(ROOT, "scripts", "family_by_kernel.py"))
fbk = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fbk)

MUL = ("void at::native::vectorized_elementwise_kernel<4, at::native::"
       "BinaryFunctor<c10::BFloat16, c10::BFloat16, c10::BFloat16, "
       "at::native::binary_internal::MulFunctor<float> >, at::detail::"
       "Array<char*, 3> >(int, at::native::BinaryFunctor<c10::BFloat16, "
       "c10::BFloat16, c10::BFloat16, at::native::binary_internal::"
       "MulFunctor<float> >, at::detail::Array<char*, 3>)")
SIGMOID = ("void at::native::vectorized_elementwise_kernel<4, at::native::"
           "sigmoid_kernel_cuda(at::TensorIteratorBase&)::{lambda()#2}::"
           "operator()() const::{lambda()#3}::operator()() const::"
           "{lambda(c10::BFloat16)#1}, at::detail::Array<char*, 2> >(int, "
           "at::native::sigmoid_kernel_cuda(at::TensorIteratorBase&)::"
           "{lambda()#2}::operator()() const::{lambda()#3}::operator()() "
           "const::{lambda(c10::BFloat16)#1}, at::detail::Array<char*, 2>)")
SOFTMAX = ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, "
           "float, float, float, at::native::(anonymous namespace)::"
           "SoftMaxForwardEpilogue>(float*, float const*, int)")
QG_FWD = ("void (anonymous namespace)::qgelu_elementwise_fwd<"
          "__nv_bfloat16>(__nv_bfloat16 const*, __nv_bfloat16*, long)")
QG_BWD = ("void (anonymous namespace)::qgelu_elementwise_bwd<"
          "__nv_bfloat16>(__nv_bfloat16 const*, __nv_bfloat16 const*, "
          "__nv_bfloat16*, long)")
ADD = ("void at::native::vectorized_elementwise_kernel<8, at::native::"
       "CUDAFunctor_add<c10::BFloat16>, std::array<char*, 3ul> >(int, "
       "at::native::CUDAFunctor_add<c10::BFloat16>, std::array<char*, 3ul>)")
GEMM = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64"


@pytest.mark.parametrize("name,want", [
    (MUL, "vectorized_elementwise_kernel [BinaryFunctor, MulFunctor, "
          "BFloat16, float]"),
    (SIGMOID, "vectorized_elementwise_kernel [sigmoid_kernel_cuda, "
              "BFloat16]"),
    (SOFTMAX, "cunn_SoftMaxForward [SoftMaxForwardEpilogue, float]"),
    (QG_FWD, "qgelu_elementwise_fwd [__nv_bfloat16]"),
    (ADD, "vectorized_elementwise_kernel [CUDAFunctor_add, BFloat16]"),
    (GEMM, GEMM),
])
def test_label_names_what_a_kernel_computes(name, want):
    assert fbk.label(name) == want


def _event(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"device": 0}}


def test_split_sums_a_family_by_name_a_unit():
    """Four steps' elementwise kernels: each name's time and launches a
    step, largest first; F's kernels apart from the softmax; the GEMM and
    the events outside the window left out."""
    events = [{"ph": "X", "cat": "user_annotation",
               "name": "portbench.window", "ts": 0.0, "dur": 10_000.0}]
    t = 10.0
    for _ in range(4):
        for name, dur in ((MUL, 300.0), (MUL, 100.0), (QG_FWD, 250.0),
                          (QG_BWD, 350.0), (SOFTMAX, 20.0), (GEMM, 900.0)):
            events.append(_event(name, t, dur))
            t += dur + 5.0
    events.append(_event(MUL, 20_000.0, 500.0))          # after the window
    trace = Trace(events, load_families())
    out = fbk.split(trace, "elementwise", units=4)
    assert out["family"] == "elementwise" and out["units"] == 4
    assert [r["name"] for r in out["kernels"]] == [MUL, QG_BWD, QG_FWD,
                                                   SOFTMAX]
    by = {r["name"]: r for r in out["kernels"]}
    assert by[MUL]["ms"] == pytest.approx(0.4)
    assert by[MUL]["launches"] == 2
    assert by[QG_FWD]["ms"] == pytest.approx(0.25)
    assert by[SOFTMAX]["launches"] == 1
    assert out["ms"] == pytest.approx(0.4 + 0.35 + 0.25 + 0.02)
    assert fbk.label(QG_FWD) != fbk.label(SOFTMAX)
