# coding=utf-8
"""The port stands alone: it imports nothing of JAX or of the JAX package,
and its tokenizer survives empty `ftfy` / `regex` stand-ins."""
import os
import pathlib
import re
import subprocess
import sys
import types

import numpy as np
import pytest

from centerclip_tpu.models.tokenizer import SimpleTokenizer as JaxTokenizer
from centerclip_tpu.models.tokenizer import tokenize_batch as jax_tokenize
from centerclip_tpu_torch.models import tokenizer as port_tokenizer

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "centerclip_tpu_torch"
CAPTIONS = ["a man is cooking pasta in a kitchen",
            "Two dogs   playing in the park!", "people dancing at night 2021",
            "&amp; it's a cat's toy"]


def test_importing_every_port_module_loads_no_jax():
    """In a fresh interpreter (tests/conftest.py imports jax in this one)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import centerclip_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'centerclip_tpu', 'triton'))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 45, names\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stderr


def test_port_sources_name_no_jax():
    pattern = re.compile(r"import jax|from jax|flax|\bcenterclip_tpu\.")
    files = [f for ext in ("py", "cu", "cuh", "cpp")
             for f in sorted(PORT.rglob(f"*.{ext}"))
             if "build" not in f.relative_to(PORT).parts] \
        + [ROOT / "chip_smoke.py"]
    hits = [f"{f.relative_to(ROOT)}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pattern.search(line)]
    assert not hits, hits
    assert len(files) > 40
    assert {f.suffix for f in files} == {".py", ".cu", ".cuh", ".cpp"}


def test_port_tokenizer_matches_jax_tokenizer():
    ids_ref, mask_ref, _ = jax_tokenize(JaxTokenizer(), CAPTIONS,
                                        max_words=32)
    ids, mask, _ = port_tokenizer.tokenize_batch(
        port_tokenizer.SimpleTokenizer(), CAPTIONS, max_words=32)
    np.testing.assert_array_equal(ids, ids_ref)
    np.testing.assert_array_equal(mask, mask_ref)


def test_tokenizer_treats_empty_stand_in_modules_as_absent(monkeypatch):
    """An empty `ftfy` / `regex` module left in sys.modules by another test
    file in the same worker must not break the port's tokenizer."""
    monkeypatch.setitem(sys.modules, "ftfy", types.ModuleType("ftfy"))
    monkeypatch.setitem(sys.modules, "regex", types.ModuleType("regex"))
    tok = port_tokenizer.SimpleTokenizer()
    assert tok._ftfy is None and tok._re is re
    ids, _, _ = port_tokenizer.tokenize_batch(tok, CAPTIONS, max_words=32)
    monkeypatch.undo()
    ref, _, _ = port_tokenizer.tokenize_batch(
        port_tokenizer.SimpleTokenizer(), CAPTIONS, max_words=32)
    np.testing.assert_array_equal(ids, ref)                 # ASCII captions
    assert tok.decode(tok.encode("a cat")).strip() == "a cat"


@pytest.mark.parametrize("kw", [dict(inter=True, algo="kmediods++",
                                     cluster_num_blocks=(49,) * 12,
                                     target_frames_blocks=(12,) * 6 + (6,) * 6),
                                dict(tensor_parallel=2)])
def test_port_config_matches_jax_config(kw):
    import dataclasses
    from centerclip_tpu import config as jax_config
    from centerclip_tpu_torch import config as port_config
    a = port_config.make_run_config(**kw)
    b = jax_config.make_run_config(**kw)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert [dataclasses.asdict(s) if s else None
            for s in a.model.cluster_plan()] == \
        [dataclasses.asdict(s) if s else None for s in b.model.cluster_plan()]
