# coding=utf-8
"""Build and load the port's CUDA C++ kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into
`build/lib<name>.so` inside the package (a directory git ignores) at first
use, and loaded with `ctypes`; it is compiled again when the source or a
`csrc/*.cuh` header it includes is newer than the library.  The sources have a plain C interface (no
PyTorch headers), so a build takes seconds.  Every exported function takes
its pointers and the CUDA stream as `void*` and returns the `cudaError_t`
of its launch; the Python wrappers raise on a non-zero code.

Nothing is compiled when this module is imported.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
KERNEL_SOURCES = ("attention", "attention_bwd", "kmedoids")
# opt-in shared memory one Hopper CTA may use (227 KB)
MAX_SMEM_BYTES = 232_448
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return path


def _paths(name: str):
    return (os.path.join(CSRC_DIR, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def dependencies(src: str) -> list:
    """`src` and every file it includes with `#include "..."`, transitively
    (paths relative to the including file, as nvcc resolves them)."""
    seen, todo = [], [src]
    while todo:
        path = os.path.normpath(todo.pop())
        if path in seen or not os.path.isfile(path):
            continue
        seen.append(path)
        with open(path, encoding="utf-8") as f:
            names = _INCLUDE.findall(f.read())
        todo += [os.path.join(os.path.dirname(path), n) for n in names]
    return seen


def _is_fresh(src: str, lib: str) -> bool:
    """A library is fresh when it is newer than its source and every header
    the source includes."""
    return os.path.isfile(lib) and all(
        os.path.getmtime(lib) >= os.path.getmtime(p) for p in dependencies(src))


def _start(name: str) -> subprocess.Popen:
    """Start one nvcc that writes to a private name; `_finish` renames it."""
    src, lib = _paths(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen) -> str:
    out, _ = proc.communicate()
    _, lib = _paths(name)
    tmp = f"{lib}.{os.getpid()}.tmp"
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, lib)          # atomic: a concurrent loader sees old or new
    return out


def build(names: Iterable[str] = KERNEL_SOURCES, force: bool = False
          ) -> Dict[str, str]:
    """Compile the named sources, one nvcc each, all started together.
    Returns {name: nvcc output (register and shared-memory report)} for the
    sources it compiled; fresh libraries are left as they are."""
    with _lock:
        procs = {}
        for name in names:
            src, lib = _paths(name)
            if force or not _is_fresh(src, lib):
                procs[name] = _start(name)
        outs, errors = {}, []
        for name, proc in procs.items():     # wait for every nvcc started
            try:
                outs[name] = _finish(name, proc)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return outs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(_paths(name)[1])
                _libs[name] = lib
    return lib


def smem_bytes(lib: ctypes.CDLL, fn_name: str, *args: int) -> int:
    """Shared-memory bytes one CTA of a kernel needs for these sizes, from
    the source's own `size_t fn_name(int, ...)`, so the layout is known in
    one place."""
    fn = getattr(lib, fn_name)
    fn.restype = ctypes.c_size_t
    fn.argtypes = [ctypes.c_int] * len(args)
    return fn(*args)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        fn = lib.cc_error_string
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({fn(err).decode()}) at launch")
