# coding=utf-8
"""Kernels of the port and the plain PyTorch versions they are held to.

attention_cuda.py     attention forward (CUDA C++, csrc/attention.cu)
kmedoids_cuda.py      k-medoids (CUDA C++, csrc/kmedoids.cu)
layernorm_triton.py   LayerNorm forward (Triton)
distances.py, kmedoids.py, cluster_layer.py   plain PyTorch around them
"""
