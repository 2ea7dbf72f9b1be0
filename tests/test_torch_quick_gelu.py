# coding=utf-8
"""QuickGELU's autograd Function (`ops/quick_gelu.py`) on the CPU: its
plain path gives the eager composition's bits both ways, keeps one tensor
for the backward where eager autograd keeps two, and a CUDA tensor without
a card raises instead of falling back.  Kernel F itself is held to the
eager composition on the card (tests/test_torch_gpu.py)."""
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from centerclip_tpu_torch.models import layers
from centerclip_tpu_torch.ops import quick_gelu
from centerclip_tpu_torch.ops.quick_gelu import (launch_plan, quick_gelu_op,
                                                 quick_gelu_plain)

DTYPES = [torch.bfloat16, torch.float32, torch.float16]


def _bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def _input(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * 4
    edge = torch.tensor([0.0, -0.0, 20.0, -20.0, 90.0, -90.0])
    n = min(x.numel(), edge.numel())
    x.view(-1)[:n] = edge[:n]
    return x.to(dtype)


def _eager(x, dy):
    xe = x.detach().clone().requires_grad_()
    y = quick_gelu_plain(xe)
    y.backward(dy)
    return y.detach(), xe.grad


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(64, 3072), (3, 1001), (5,)])
def test_function_equals_eager_bits(dtype, shape):
    x, dy = _input(shape, dtype, 0), _input(shape, dtype, 1)
    y_ref, g_ref = _eager(x, dy)
    xk = x.clone().requires_grad_()
    y = quick_gelu_op(xk)
    assert y.grad_fn is not None and "QuickGelu" in type(y.grad_fn).__name__
    y.backward(dy)
    assert torch.equal(_bits(y.detach()), _bits(y_ref))
    assert torch.equal(_bits(xk.grad), _bits(g_ref))


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_backward_equals_autograd_bits(dtype):
    x, dy = _input((257, 96), dtype, 2), _input((257, 96), dtype, 3)
    _, g_ref = _eager(x, dy)
    g = quick_gelu.quick_gelu_backward(x, dy)
    assert torch.equal(_bits(g), _bits(g_ref))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_function_under_checkpoint_equals_eager_bits(dtype):
    """Under non-reentrant checkpointing (the towers' `remat`) the
    Function's forward is replayed in the backward: same bits."""
    x, dy = _input((32, 768), dtype, 4), _input((32, 3072), dtype, 5)
    w = _input((3072, 768), torch.float32, 6) * 0.05

    def body(h, act):
        return act(torch.nn.functional.linear(h, w.to(dtype)))
    xe = x.clone().requires_grad_()
    ye = body(xe, quick_gelu_plain)
    ye.backward(dy)
    xk = x.clone().requires_grad_()
    yk = checkpoint(body, xk, quick_gelu_op, use_reentrant=False)
    yk.backward(dy)
    assert torch.equal(_bits(yk.detach()), _bits(ye.detach()))
    assert torch.equal(_bits(xk.grad), _bits(xe.grad))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_no_grad_saves_nothing(dtype):
    x = _input((16, 3072), dtype, 7).requires_grad_()
    packed = []
    with torch.no_grad(), torch.autograd.graph.saved_tensors_hooks(
            lambda t: packed.append(t) or t, lambda t: t):
        y = quick_gelu_op(x)
    assert y.grad_fn is None and not packed
    assert torch.equal(_bits(y), _bits(quick_gelu_plain(x.detach())))


def _saved(fn):
    """Distinct storages autograd keeps for fn's backward: {ptr: bytes}."""
    seen = {}

    def pack(t):
        s = t.untyped_storage()
        seen[s.data_ptr()] = s.nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    del out
    return seen


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_function_saves_x_alone(dtype):
    x = _input((16, 3072), dtype, 8)
    h = x.clone().requires_grad_() * 1     # a non-leaf, as c_fc's output
    fused = _saved(lambda: quick_gelu_op(h))
    eager = _saved(lambda: quick_gelu_plain(h))
    assert list(fused) == [h.untyped_storage().data_ptr()]
    assert len(eager) == 2 and h.untyped_storage().data_ptr() in eager


def test_block_saves_one_activation_fewer():
    """A residual block keeps one [rows, 4 * width] tensor fewer for its
    backward than with the eager composition (sigmoid's output)."""
    torch.manual_seed(0)
    block = layers.ResidualAttentionBlock(64, 2, torch.float32, fused=False)
    x = torch.randn(3, 10, 64, requires_grad=True)
    fused = sum(_saved(lambda: block(x)).values())
    orig = layers.quick_gelu_op
    try:
        layers.quick_gelu_op = quick_gelu_plain
        eager = sum(_saved(lambda: block(x)).values())
    finally:
        layers.quick_gelu_op = orig
    assert eager - fused == 3 * 10 * 256 * 4


def test_mlp_runs_the_function():
    mlp = layers.MLP(32, torch.bfloat16)
    x = torch.randn(2, 5, 32, requires_grad=True)
    names, todo = set(), [mlp(x).grad_fn]
    while todo:
        fn = todo.pop()
        names.add(type(fn).__name__)
        todo += [f for f, _ in fn.next_functions if f is not None]
    assert any("QuickGelu" in n for n in names), names
    assert "SigmoidBackward0" not in names


def test_cuda_tensor_without_a_card_raises():
    """A CUDA tensor goes to kernel F or raises: without nvcc or a card
    nothing falls back to the plain version, and no launch is counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        x = torch.empty(4, 8, device="cuda", dtype=torch.bfloat16)
    assert x.device.type == "cuda"
    fwd, bwd = quick_gelu.quick_gelu_forward, quick_gelu.quick_gelu_backward
    f0, b0 = fwd.launches, bwd.launches
    with pytest.raises(Exception) as err:
        quick_gelu_op(x)
    assert not isinstance(err.value, AssertionError)
    with pytest.raises(Exception):
        bwd(x, x)
    assert (fwd.launches, bwd.launches) == (f0, b0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32])
def test_cuda_dtypes_it_cannot_take_raise(dtype):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        x = torch.empty(4, 8, device="cuda", dtype=dtype)
    with pytest.raises(ValueError, match="dtype"):
        quick_gelu.quick_gelu_forward(x)


@pytest.mark.parametrize("n,elem,vector,expect", [
    (1, 2, True, 1),                        # a tail alone
    (8 * 256, 2, True, 1),                  # a vector a thread
    (8 * 256 + 1, 2, True, 1),              # the tail's element too
    (8 * 256 * 5, 2, True, 5),
    (302592 * 3072, 2, True, 132 * 8),      # the card's resident CTAs
    (4 * 256 * 3, 4, True, 3),
    (256 * 3, 2, False, 3),                 # scalar: an element a thread
    (10 ** 9, 4, False, 132 * 8),
])
def test_launch_plan(n, elem, vector, expect):
    assert launch_plan(n, elem, vector, 256, 132 * 8) == expect
