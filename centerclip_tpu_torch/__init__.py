# coding=utf-8
"""centerclip_tpu_torch: the PyTorch / CUDA port of centerclip-tpu for NVIDIA
Hopper (H100).

It sits beside the JAX package `centerclip_tpu`, which stays the reference,
and imports nothing of it.  Importing this package builds no kernel and
imports neither `triton` nor a compiled library: the CUDA C++ kernels are
compiled by `ops/_build.py` and the Triton kernel is compiled by Triton, at
their first launch on a CUDA tensor.
"""
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another one.  With no device given and no CUDA device present this
    raises instead of quietly running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: centerclip_tpu_torch runs on the GPU; pass "
                "device='cpu' explicitly to run the plain PyTorch versions")
        return torch.device("cuda")
    return torch.device(device)


def set_fp32_numerics() -> None:
    """The JAX package's fp32 numerics on the card: fp32 matmuls and
    convolutions in full fp32, never TF32.  PyTorch's defaults differ for
    the two: `torch.backends.cuda.matmul.allow_tf32` is False but
    `torch.backends.cudnn.allow_tf32` is True, which would run the ResNet
    tower's and the 3-D patchify's fp32 convolutions in TF32.  The model
    builder calls this; the flags are process-wide."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
