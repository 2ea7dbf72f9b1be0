"""Spectral clustering in the benchmark: the plan's reading of the flags,
the plain reference against the program's plain path on planted token
groups (so that the affinity is not the identity), the weights'
`stream_scale`, the work counts, and a run whose tokens lie so far apart
that the heat kernel underflows."""
import dataclasses
import hashlib
import json
import os
import time

import pytest
import torch

from portbench import harness, weights
from portbench.harness import BENCH
from portbench.reference import model as M
from portbench.reference import spectral as RS
from portbench.tests import tiny
from portbench.work import counts, peaks
from portbench.work.plan import Cluster, shapes

H100 = peaks.card_peaks("NVIDIA H100 80GB HBM3")


def config(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


def planted(seed, segments, sizes, width=16, spread=1.0, apart=1.0):
    """[segments, sum(sizes), width] tokens in groups of `sizes` around
    random centres, shuffled."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(segments):
        cent = torch.randn(len(sizes), width, generator=g) * apart
        pts = torch.cat([c + spread * torch.randn(n, width, generator=g)
                         for c, n in zip(cent, sizes)])
        out.append(pts[torch.randperm(len(pts), generator=g)])
    return torch.stack(out)


# ------------------------------------------------------------------ the plan
def test_plan_equals_the_programs_for_the_spectral_preset():
    from centerclip_tpu_torch.config import preset
    want = [p for p in preset("lsmdc_vitb32_spectral6").model.cluster_plan()
            if p is not None]
    got = [p for p in shapes(config("spectral6")).plan if p is not None]
    assert [(p.block_id - 1, p.algo, p.spectral_knn_k, p.frame_duration,
             p.before_cluster_num, p.cluster_num) for p in want] == \
        [(p.block, p.algo, p.knn_k, p.dur, p.tokens_in, p.k) for p in got]
    assert [(p.graph, p.sigma, p.n) for p in got] == [("KNN", 2.0, 98)]


@pytest.mark.parametrize("frames,blocks,knn_k", [
    (12, [49] * 12, 1), (12, [196] * 12, 1), (12, [49] * 6 + [30] * 6, 1),
    (12, [49] * 12, 7), (12, [196] * 12, 4)])
def test_knn_k_follows_the_programs_rule(frames, blocks, knn_k):
    from centerclip_tpu_torch.config import ClusterConfig, build_cluster_plan
    target = [frames] * 6 + [frames // 4] * 6
    want = build_cluster_plan(ClusterConfig(
        inter=True, algo="spectral", cluster_num_blocks=tuple(blocks),
        target_frames_blocks=tuple(target), spectral_knn_k=knn_k),
        frames, 12)
    flags = ["--max_frames", str(frames), "--max_words", "32",
             "--cluster_inter", "1", "--cluster_algo", "spectral",
             "--spectral_knn_k", str(knn_k), "--cluster_num_blocks",
             *map(str, blocks), "--target_frames_blocks", *map(str, target)]
    got = shapes({"arch": config("vitb32_k6")["arch"], "flags": flags}).plan
    assert [p and p.knn_k for p in got] == \
        [p and p.spectral_knn_k for p in want]


@pytest.mark.parametrize("extra", [["--cluster_algo", "pooling"],
                                   ["--cluster_algo", "spectral",
                                    "--spectral_spg", "1"]])
def test_plan_refuses_what_the_reference_does_not_know(extra):
    c = config("vitb32_k6")
    flags = [f for f in c["flags"]]
    i = flags.index("--cluster_algo")
    del flags[i:i + 2]
    with pytest.raises(ValueError):
        shapes({"arch": c["arch"], "flags": flags + extra})


def test_kmedoids_configurations_keep_their_plan():
    for name in ("vitb32_k6", "vitb16_k6"):
        spec = shapes(config(name)).plan[6]
        assert (spec.algo, spec.graph, spec.sigma) == \
            ("kmediods++", "HeatKernel", 2.0)


# ------------------------------------------------------------ the reference
@pytest.mark.parametrize("graph", ["KNN", "HeatKernel"])
@pytest.mark.parametrize("sizes,k", [([4, 6, 6, 8], 4), ([3, 3, 4, 4, 5, 5],
                                                         6)])
def test_embedding_equals_the_programs(graph, sizes, k):
    """At 24 tokens a segment both sides sum the distances from the
    differences, so every step after them (the KNN graph, L_sym, `eigh`,
    the sign correction, the rows' norms) has to give the same bits."""
    from centerclip_tpu_torch.ops import spectral as P
    X = planted(len(sizes), 6, sizes)
    spec = Cluster(0, 2, 1, 12, k, "spectral", graph, 10, 2.0)
    got = RS.embedding(X, spec)
    want = P.spectral_embedding(X, k, mode=graph, knn_k=10, sigma=2.0)
    assert torch.equal(got, want)
    ids = RS.medoids(X, spec, 100, M.kmedoids)
    read = RS.layer_readings(X, spec, ids, 100, M.kmedoids)
    assert read["identity_segments"] == 0 and read["segments"] == 6
    assert read["cost_excess"] == 0.0 and read["agreement"] == 1.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_medoids_at_the_cells_size_are_the_programs_kmedoids(seed):
    """N = 98, K = 49, k = 10: the reference's medoid ids are the program's
    plain k-medoids on the reference's embedding, and the embedding's
    distances between rows are the program's to rounding where the K-th
    eigenvalue stands apart from the next."""
    from centerclip_tpu_torch.ops import spectral as P
    from centerclip_tpu_torch.ops.kmedoids import batch_fast_kmedoids
    X = planted(seed, 4, [3, 5, 7, 9, 11, 13, 15, 17, 18], spread=1.5)
    spec = Cluster(6, 12, 6, 49, 49, "spectral", "KNN", 10, 2.0)
    ids = RS.medoids(X, spec, 100, M.kmedoids)
    emb = RS.embedding(X, spec)
    _, want = batch_fast_kmedoids(emb, 49, iter_limit=100)
    assert torch.equal(ids, want.long())
    read = RS.layer_readings(X, spec, want, 100, M.kmedoids)
    assert read["identity_segments"] == 0 and read["near_ties"] == 0
    assert read["cost_excess"] == 0.0
    other = P.spectral_embedding(X, 49, mode="KNN", knn_k=10, sigma=2.0)
    gap = (torch.cdist(emb, emb) - torch.cdist(other, other)).abs().max()
    assert gap < 5e-3


def test_identity_segments_counts_an_underflowing_heat_kernel():
    X = planted(0, 5, [4, 4, 4, 4], apart=1.0, spread=1.0)
    X[:2] *= 100.0                      # two segments ~ 300 sigma apart
    spec = Cluster(0, 2, 1, 8, 4, "spectral", "KNN", 10, 2.0)
    ids = RS.medoids(X, spec, 100, M.kmedoids)
    read = RS.layer_readings(X, spec, ids, 100, M.kmedoids)
    assert read["identity_segments"] == 2 and read["segments"] == 5
    assert read["median_sigmas"] > 1.0


@pytest.mark.parametrize("seed", [0, 1])
def test_cost_excess_reads_the_layer_not_the_draw(seed):
    """The k-medoids cost of medoid ids in the reference's embedding: the
    reference's own ids read 0; another fixed point of k-medoids on the
    embedding (started elsewhere) about as much; ids drawn at random, or
    taken from the eigenvectors at the wrong end of the spectrum, far
    more."""
    X = planted(seed, 8, [3, 5, 7, 9, 11, 13, 15, 17, 18], spread=1.5)
    spec = Cluster(6, 12, 6, 49, 49, "spectral", "KNN", 10, 2.0)
    emb = RS.embedding(X, spec)
    other = M.kmedoids(emb.flip(1), 49, 100)        # rows in reverse order
    other = (X.shape[1] - 1 - other).sort(dim=1).values
    g = torch.Generator().manual_seed(seed)
    drawn = torch.rand(X.shape[:2], generator=g).argsort(-1)[:, :49]
    top = M.kmedoids(RS.embedding(X, dataclasses.replace(spec, k=98))[
        ..., 49:], 49, 100)
    read = {name: RS.layer_readings(X, spec, ids, 100, M.kmedoids)
            for name, ids in (("other", other), ("drawn", drawn),
                              ("top", top))}
    assert abs(read["other"]["cost_excess"]) < 0.05
    assert read["drawn"]["cost_excess"] > 0.3
    assert read["top"]["cost_excess"] > 0.3


# -------------------------------------------------------------- the weights
# sha-256 of every leaf (sorted by name) at seed 12345 on the CPU, the
# configurations' shapes with 2 vision and 2 text layers and a vocabulary
# of 1,000, as the weights were made before `stream_scale` existed
DIGESTS = {
    "vitb32_k6":
        "bd7fae908fb838b2fa01c0fdb3ec244c25cf96d6583e3f6d0c6e063eb87c6dd1",
    "vitb16_k6":
        "15d12788e38c92e31c5694ba64a8912b60ca7a83fde482b48b00c822624506bc"}


def small(name, **kw):
    return dataclasses.replace(shapes(config(name)), layers=2,
                               text_layers=2, vocab=1000, **kw)


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_weights_of_the_kmedoids_configurations_are_unchanged(name):
    W = weights.make(small(name), 12345, "cpu")
    h = hashlib.sha256()
    for k in sorted(W):
        h.update(k.encode())
        h.update(W[k].numpy().tobytes())
    assert h.hexdigest() == DIGESTS[name]


def test_stream_scale_multiplies_exactly_the_listed_leaves():
    base = weights.make(small("spectral6", stream_scale=1.0), 7, "cpu")
    alpha = 0.0625
    s = small("spectral6", stream_scale=alpha)
    scaled = weights.make(s, 7, "cpu")
    listed = set(weights.stream_leaves(s))
    assert len(listed) == 2 + 4 * 2 and listed <= set(base)
    for name in base:
        want = base[name] * alpha if name in listed else base[name]
        assert torch.equal(scaled[name], want), name


def test_the_spectral_configuration_states_its_stream_scale():
    s = shapes(config("spectral6"))
    assert 0.0 < s.stream_scale < 1.0
    assert shapes(config("vitb32_k6")).stream_scale == 1.0


# --------------------------------------------------------------- the counts
PINNED = {  # (train, remat): (model_flops, attention, layernorm, kmedoids)
    "vitb32_k6": {
        (True, False): (30973150887936.0, 0.004004083314626866,
                        0.0033980877564179102, 4.629091343283582e-06),
        (True, True): (30973150887936.0, 0.005342235510447761,
                       0.004725940040597015, 4.629091343283582e-06),
        (False, False): (10257714118656.0, 0.0012676814328358209,
                         0.0013388601313432836, 4.629091343283582e-06)},
    "vitb16_k6": {
        (True, False): (114475836899328.0, 0.014325783231044777,
                        0.012161992062089552, 5.8381755223880594e-05),
        (True, True): (114475836899328.0, 0.01911341545074627,
                       0.016912584214925374, 5.8381755223880594e-05),
        (False, False): (38205236183040.0, 0.004690421301492538,
                         0.004968654634029851, 5.8381755223880594e-05)}}


@pytest.mark.parametrize("name,mode", [(n, m) for n in sorted(PINNED)
                                       for m in PINNED[n]])
def test_counts_of_the_kmedoids_configurations_are_unchanged(name, mode):
    s = shapes(config(name))
    train, remat = mode
    got = (counts.model_flops(s, 128, train),
           counts.total_bound(counts.attention_calls(s, 128, train, remat),
                              H100),
           counts.total_bound(counts.layernorm_calls(s, 128, train, remat),
                              H100),
           counts.total_bound(counts.kmedoids_calls(s, 128), H100))
    assert got == PINNED[name][mode]


def test_spectral_adds_kmedoids_distances_over_the_embedding():
    s = shapes(config("spectral6"))
    k = shapes(config("vitb32_k6"))
    extra = 6 * 2.0 * 98 * 98 * 49
    assert counts.vision_flops(s)["distances"] == \
        counts.vision_flops(k)["distances"] + extra
    assert counts.model_flops(s, 128, True) == \
        counts.model_flops(k, 128, True) + 128 * extra
    assert counts.kmedoids_calls(s, 128) == counts.kmedoids_calls(k, 128)


# ------------------------------------------------------------------ a run
@pytest.mark.parametrize("alpha,flat", [(0.5, False), (10.0, True)])
def test_a_run_whose_heat_kernel_underflows_is_not_correct(
        tiny_env, pinned_medoids, alpha, flat):
    """Spectral clustering in a tiny training run: at alpha 0.5 the tokens
    lie a median ~3 sigma apart; at 10, ~60, where every affinity off the
    diagonal underflows and the run times a diagonal matrix."""
    from portbench.tests.test_pb_faults import LIMITS
    cell = tiny.cell("train", algo="spectral", stream_scale=alpha,
                     limits=dict(LIMITS, identity_segments=0))
    res = harness.run(cell, seed=5, seconds=0.2, trace=False, device="cpu",
                      start=time.time())[0]
    assert (res["checks"]["identity_segments"]["value"] > 0) == flat
    assert res["correct"] == (not flat)
