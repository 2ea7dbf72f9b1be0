# coding=utf-8
"""Offline tools: pack, check, compress, index, download and visualise
videos (the port's own copies of the JAX package's `preprocess/`)."""
