"""No run imports JAX or the JAX package; the reference and the
yardstick import nothing of the program."""
import ast
import glob
import os
import subprocess
import sys

import pytest

from portbench import harness
from portbench.harness import BENCH, ROOT


def imported(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources(*parts):
    return glob.glob(os.path.join(BENCH, *parts, "*.py"))


@pytest.mark.parametrize("part", ["reference", "work"])
def test_reference_and_work_import_nothing_of_the_program(part):
    for path in sources(part):
        names = set(imported(path))
        assert not names & {"centerclip_tpu_torch", "centerclip_tpu", "jax",
                            "jaxlib", "flax"}, path


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    for path in sources() + sources("metrics") + sources("tests"):
        assert not set(imported(path)) & set(harness.FORBIDDEN), path


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "centerclip_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert "centerclip_tpu_torch_x" not in harness.forbidden_modules()
    assert "jaxtyping_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "centerclip_tpu.ops.fake", sys)
    assert "centerclip_tpu.ops.fake" in harness.forbidden_modules()


RUN = """
import sys, time, json
sys.path.insert(0, {root!r})
from portbench.tests import tiny
tiny.register()
import portbench.kinds as K
K.CACHE = {cache!r}
from portbench import harness
res, _ = harness.run(tiny.cell("train"), seed=3, seconds=0.2, trace=False,
                  device="cpu", start=time.time())
print(json.dumps(harness.forbidden_modules()))
"""


def test_a_run_loads_no_jax(tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(root=ROOT, cache=str(tmp_path))],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
