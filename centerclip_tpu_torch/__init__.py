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
