"""The yardstick's counts against figures worked by hand."""
import json
import os

import pytest

from portbench.harness import BENCH
from portbench.work import counts, peaks
from portbench.work.plan import shapes

H100 = peaks.card_peaks("NVIDIA H100 80GB HBM3")


def cfg(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return shapes(json.load(f))


def test_plan_clusters_before_block_7():
    for name, n, k in (("vitb32_k6", 98, 49), ("vitb16_k6", 392, 160)):
        plan = cfg(name).plan
        assert [p.block for p in plan if p] == [6]
        spec = plan[6]
        assert (spec.frames_in, spec.frames_out, spec.n, spec.k) == \
            (12, 6, n, k)


# per clip, forward: a block is 24 L W^2 + 4 L^2 W
B32_BLOCK = 24 * 50 * 768 ** 2 + 4 * 50 ** 2 * 768               # 715.5 M
B16_BLOCK_197 = 24 * 197 * 768 ** 2 + 4 * 197 ** 2 * 768
B16_BLOCK_161 = 24 * 161 * 768 ** 2 + 4 * 161 ** 2 * 768
TEXT = 12 * (24 * 32 * 512 ** 2 + 4 * (32 * 33 / 2) * 512) + 2 * 512 * 512


@pytest.mark.parametrize("name,blocks,patches,n", [
    ("vitb32_k6", 6 * 12 * B32_BLOCK + 6 * 6 * B32_BLOCK, 49 * 3072, 98),
    ("vitb16_k6", 6 * 12 * B16_BLOCK_197 + 6 * 6 * B16_BLOCK_161,
     196 * 768, 392)])
def test_model_flops_by_hand(name, blocks, patches, n):
    s = cfg(name)
    patch = 2.0 * patches * 768 * 12
    dist = 6 * 2.0 * n * n * 768
    head = 2.0 * 768 * 512 * 6
    assert counts.model_flops(s, 1, False) == pytest.approx(
        blocks + patch + dist + head, rel=1e-12)
    train = 3 * (blocks + head + TEXT + 2 * 128 * 512) + patch + dist
    assert counts.model_flops(s, 128, True) == pytest.approx(
        128 * train, rel=1e-12)


def test_model_flops_magnitudes():
    assert counts.model_flops(cfg("vitb32_k6"), 1, False) / 1e9 == \
        pytest.approx(80.14, abs=0.01)
    assert counts.model_flops(cfg("vitb16_k6"), 1, False) / 1e9 == \
        pytest.approx(298.48, abs=0.01)


def test_attention_call_bytes_and_flops():
    # ViT-B/16's first blocks at batch 128: [1536, 197, 2304] bf16
    c = counts.AttentionCall(1536, 197, 12, 64, False, False, False)
    assert c.bytes() == 4 * 1536 * 197 * 768 * 2
    assert c.flops() == 4 * 1536 * 12 * 197 ** 2 * 64
    assert c.bound(H100) * 1e3 == pytest.approx(0.5550, abs=2e-4)
    b = counts.AttentionCall(1536, 197, 12, 64, False, True, True)
    assert b.bytes() == 8 * 1536 * 197 * 768 * 2 + 4 * 1536 * 12 * 197
    assert b.flops() == 10 * 1536 * 12 * 197 ** 2 * 64
    causal = counts.AttentionCall(128, 32, 8, 64, True, False, True)
    assert causal.flops() == 4 * 128 * 8 * (32 * 33 / 2) * 64


def test_layernorm_and_kmedoids_bounds():
    # kernel C at [302592, 768] bf16: 2 x 465 MB over 3.35 TB/s
    assert counts.LayerNormCall(302592, 768, False).bound(H100) * 1e3 == \
        pytest.approx(0.2775, abs=2e-4)
    assert counts.LayerNormCall(76800, 768, True).bound(H100) * 1e3 == \
        pytest.approx(0.1056, abs=2e-4)
    by, ops = peaks.kmedoids_fixed_work(768, 392, 160)
    assert by == 4.0 * (768 * 160 * 392 + 2 * 768 * 392 + 768 * 160 + 768)
    assert ops == 768 * 2 * 160 * 392 + 768 * 392 * 160


@pytest.mark.parametrize("name,remat,train,a,b,c,d,e", [
    ("vitb32_k6", False, True, 24, 24, 51, 50, 1),
    ("vitb16_k6", True, True, 48, 24, 99, 50, 1),
    ("vitb16_k6", False, False, 12, 0, 26, 0, 1),
    ("vitb32_k6", False, False, 12, 0, 26, 0, 1)])
def test_launch_counts_match_the_programs_known_counts(name, remat, train,
                                                       a, b, c, d, e):
    s = cfg(name)
    att = counts.attention_calls(s, 128, train, remat)
    ln = counts.layernorm_calls(s, 128, train, remat)
    assert counts.launches(att, False) == a
    assert counts.launches(att, True) == b
    assert counts.launches(ln, False) == c
    assert counts.launches(ln, True) == d
    assert counts.launches(counts.kmedoids_calls(s, 128)) == e


def test_unknown_card_takes_the_h100s_peaks():
    assert peaks.card_peaks("some card") == peaks.CARD_PEAKS["H100"]
    assert peaks.card_peaks("NVIDIA H100 PCIe") == \
        peaks.CARD_PEAKS["H100 PCIe"]
