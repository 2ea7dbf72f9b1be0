"""The plain reference against the program's CPU path at a tiny size."""
import time

import pytest
import torch

from portbench import harness
from portbench.reference import model as M
from portbench.tests import tiny


@pytest.mark.parametrize("n,k,width", [(32, 12, 64), (98, 49, 48),
                                       (392, 160, 16)])
def test_kmedoids_equals_the_programs_plain_version(n, k, width):
    from centerclip_tpu_torch.ops.kmedoids import batch_fast_kmedoids
    g = torch.Generator().manual_seed(n)
    X = torch.randn(6, n, width, generator=g)
    _, meds = batch_fast_kmedoids(X, k, iter_limit=100)
    assert torch.equal(M.kmedoids(X, k, 100), meds.long())


def test_parts_split_the_packed_projections():
    t = torch.arange(6.0)
    names = [n for n, _ in M.parts("a.attn.in_proj_bias", t)]
    assert names == ["a.attn.in_proj_bias[q]", "a.attn.in_proj_bias[k]",
                     "a.attn.in_proj_bias[v]"]
    assert M.part_norms([("x.weight", torch.ones(4))]) == {"x.weight": 2.0}


def test_caption_ids_equal_the_programs_tokenizer():
    from centerclip_tpu_torch.models.tokenizer import (SimpleTokenizer,
                                                       tokenize_batch)
    from portbench import synth
    from portbench.reference.tokens import Vocab
    caps = [c for cs in synth.msrvtt_captions(64, 20).values() for c in cs]
    caps.append(" ".join(synth.WORDS[:30]))
    ids, _, _ = tokenize_batch(SimpleTokenizer(), caps, max_words=32)
    vocab = Vocab()
    assert [tuple(int(t) for t in row) for row in ids] == \
        [vocab.caption(c, 32) for c in caps]


def run(kind, precision, seed, **config):
    cell = tiny.cell(kind, **config)
    cell.config["flags"] += ["--precision", precision]
    return harness.run(cell, seed=seed, seconds=0.2, trace=False,
                       device="cpu", start=time.time())[0]


@pytest.mark.parametrize("seed,config", [
    (1, {}), (2 ** 33 + 5, {}),
    (3, {"algo": "spectral", "stream_scale": 0.5})])
def test_fp32_program_equals_the_reference(tiny_env, pinned_medoids, seed,
                                           config):
    """The program in fp32 (`--precision fp32`) and the reference agree to
    rounding on three training steps and on the gallery vectors (with
    spectral clustering, its eigensolve run on both sides, the medoids
    pinned)."""
    checks = run("train", "fp32", seed, **config)["checks"]
    assert checks["loss_gap"]["value"] < 1e-5
    assert checks["grad_gap"]["value"] < 1e-5
    assert checks["update_gap"]["value"] < 1e-3
    assert checks.get("identity_segments", {"value": 0})["value"] == 0
    assert run("encode", "fp32", seed, **config)["checks"]["vec_gap"][
        "value"] < 1e-5
