# coding=utf-8
"""The port's IVF index (`centerclip_tpu_torch/serve/ivf.py`) on the CPU:
the JAX package's IVF tests (tests/test_serve_ivf.py) on the same inputs,
each also held against the JAX package where both compute the same thing;
indexes saved by either package load in the other with the same answers;
and one Lloyd step equals JAX's from the same centroids.

The two packages seed k-means++ from different generators (a
`torch.Generator` against `jax.random`), so their centroids differ; every
comparison that needs the same cells goes through a saved index or through
explicit centroids.
"""
import numpy as np
import pytest
import torch

from centerclip_tpu.serve import ivf as jax_ivf
from centerclip_tpu.serve import IVFVideoIndex as JaxIVF
from centerclip_tpu.serve import VideoIndex as JaxIndex
from centerclip_tpu_torch import config as port_config
from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
from centerclip_tpu_torch.serve import (IVFVideoIndex, RetrievalEngine,
                                        VideoIndex, load_index)
from centerclip_tpu_torch.serve.ivf import (MAX_QUERY_BUCKET,
                                            _capacity_assign, lloyd_step,
                                            spherical_kmeans)

CPU = dict(device="cpu")
# fp32 sums of the same exact bf16 products in another order (a batched
# matmul over gathered rows against a flat matmul, or against XLA's)
SCORE_TOL = dict(rtol=1e-5, atol=1e-6)


def _clustered_gallery(rng, n=512, d=32, n_centers=16, noise=0.15):
    centers = rng.normal(size=(n_centers, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    which = rng.integers(0, n_centers, size=n)
    emb = centers[which] + noise * rng.normal(size=(n, d)).astype(np.float32)
    return emb.astype(np.float32)


# ------------------------------------------------------------------- builds
def test_spherical_kmeans_unit_centroids(rng):
    emb = _clustered_gallery(rng)
    c = spherical_kmeans(emb, 16, iters=8, **CPU)
    assert c.shape == (16, 32) and c.device.type == "cpu"
    np.testing.assert_allclose(np.linalg.norm(c.numpy(), axis=1), 1.0,
                               atol=1e-4)
    # the same seed draws the same centroids; another seed other ones
    torch.testing.assert_close(spherical_kmeans(emb, 16, iters=8, **CPU), c,
                               rtol=0, atol=0)
    assert not torch.equal(spherical_kmeans(emb, 16, iters=8, seed=1, **CPU),
                           c)
    with pytest.raises(ValueError):
        spherical_kmeans(emb, 0, **CPU)
    with pytest.raises(ValueError):
        spherical_kmeans(emb[:4], 5, **CPU)


@pytest.mark.parametrize("iters", [1, 3])
def test_lloyd_steps_equal_jax_from_the_same_centroids(rng, monkeypatch,
                                                       iters):
    """JAX's `spherical_kmeans` with its seeding replaced by the given
    centroids runs exactly `iters` of its Lloyd steps."""
    emb = _clustered_gallery(rng, n=300)
    e = jax_ivf.l2_normalize(emb)
    c0 = e[rng.choice(len(e), 16, replace=False)]
    monkeypatch.setattr(jax_ivf, "_kmeanspp_init",
                        lambda e_, k, seed: e_[:0].sum() + c0)
    ref = jax_ivf.spherical_kmeans(emb, 16, iters=iters)
    c = torch.from_numpy(c0)
    for _ in range(iters):
        c, assign = lloyd_step(torch.from_numpy(e), c)
    np.testing.assert_allclose(c.numpy(), ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        lloyd_step(torch.from_numpy(e), torch.from_numpy(c0))[1].numpy(),
        np.argmax(e @ c0.T, axis=1))


def test_capacity_assign_respects_cap_and_prefers_best(rng):
    sims = rng.normal(size=(40, 4)).astype(np.float32)
    pref = np.argsort(-sims, axis=1)
    val = np.take_along_axis(sims, pref, axis=1)
    out = _capacity_assign(pref, val, k=4, cap=10)
    assert out.min() >= 0
    assert np.bincount(out, minlength=4).max() <= 10
    np.testing.assert_array_equal(
        out, jax_ivf._capacity_assign(pref, val, k=4, cap=10))
    # uncapped rows go to their argmax
    loose = _capacity_assign(pref, val, k=4, cap=40)
    np.testing.assert_array_equal(loose, np.argmax(sims, axis=1))
    # truncated preference list: overflow rows still land in open cells
    trunc = _capacity_assign(pref[:, :1], val[:, :1], k=4, cap=10)
    assert trunc.min() >= 0
    assert np.bincount(trunc, minlength=4).max() <= 10
    np.testing.assert_array_equal(
        trunc, jax_ivf._capacity_assign(pref[:, :1], val[:, :1], k=4,
                                        cap=10))
    with pytest.raises(ValueError, match="capacity"):
        _capacity_assign(pref, val, k=4, cap=9)


@pytest.mark.parametrize("quant", ["float32", "int8"])
def test_ivf_full_probe_matches_flat_exact(rng, quant):
    """nprobe == n_clusters scores every row: the flat index's ranking and
    scores, the port's and the JAX package's."""
    emb = _clustered_gallery(rng)
    ids = [f"v{i}" for i in range(len(emb))]
    q = rng.normal(size=(5, emb.shape[1])).astype(np.float32)
    flat = VideoIndex(emb, ids, quantize=quant, **CPU)
    ivf = IVFVideoIndex(emb, ids, quantize=quant, n_clusters=16, **CPU)
    s0, i0 = flat.search(q, k=7)
    s1, i1 = ivf.search(q, k=7, nprobe=16)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_allclose(s0, s1, **SCORE_TOL)
    js, ji = JaxIndex(emb, ids, quantize=quant).search(q, k=7)
    np.testing.assert_array_equal(i1, ji)
    np.testing.assert_allclose(s1, js, **SCORE_TOL)


def test_ivf_recall_and_pruning(rng):
    """Recall@10 at nprobe 4 of 16 depends on the k-means++ draw (0.85-0.92
    over seeds 0-4 in either package on these inputs), and the packages
    draw from different generators: the port's mean over five seeds must
    be within 0.05 of the JAX package's over the same seeds."""
    emb = _clustered_gallery(rng, n=1024, n_centers=16)
    ids = [str(i) for i in range(len(emb))]
    flat = VideoIndex(emb, ids, **CPU)
    q = _clustered_gallery(rng, n=32, n_centers=16)
    _, exact = flat.search(q, k=10)

    def recall(index):
        _, approx = index.search(q, k=10)      # default nprobe=4 of 16
        assert approx.min() >= 0 and approx.max() < len(emb)
        return np.mean([len(set(a) & set(e)) / 10.0
                        for a, e in zip(approx, exact)])
    port = [recall(IVFVideoIndex(emb, ids, n_clusters=16, nprobe=4,
                                 seed=s, **CPU)) for s in range(5)]
    ref = [recall(JaxIVF(emb, ids, n_clusters=16, nprobe=4, seed=s))
           for s in range(5)]
    assert np.mean(port) >= np.mean(ref) - 0.05, (port, ref)
    assert min(port) >= 0.8, port               # clusterable data
    ivf = IVFVideoIndex(emb, ids, n_clusters=16, nprobe=4, **CPU)
    # probing fewer cells can only lower the returned scores
    s1, _ = ivf.search(q[:1], k=5, nprobe=1)
    s16, _ = ivf.search(q[:1], k=5, nprobe=16)
    assert np.all(s16 + 1e-5 >= s1)
    # k beyond the reachable rows clamps to nprobe * capacity; slots past
    # the probed cells' occupancy are explicit no-results (-inf, id -1)
    s, i = ivf.search(q[:1], k=2 * ivf.capacity, nprobe=1)
    assert s.shape[1] == ivf.capacity
    finite = np.isfinite(s)
    assert np.all(i[finite] >= 0) and np.all(i[~finite] == -1)
    assert finite.sum() > 0


def test_ivf_default_clusters_and_tiny_gallery(rng):
    emb = rng.normal(size=(12, 16)).astype(np.float32)
    ivf = IVFVideoIndex(emb, [str(i) for i in range(12)], **CPU)
    jivf = JaxIVF(emb, [str(i) for i in range(12)])
    assert 1 <= ivf.n_clusters <= 12
    assert (ivf.n_clusters, ivf.nprobe, ivf.capacity) == \
        (jivf.n_clusters, jivf.nprobe, jivf.capacity)
    s, i = ivf.search(emb[3], k=3, nprobe=ivf.n_clusters)
    assert i[0, 0] == 3                         # self-match survives
    assert len(ivf) == 12


@pytest.mark.parametrize("quant", ["float32", "bfloat16", "int8"])
def test_ivf_save_load_roundtrip(rng, tmp_path, quant):
    emb = _clustered_gallery(rng, n=256)
    ids = [f"v{i}" for i in range(256)]
    ivf = IVFVideoIndex(emb, ids, quantize=quant, n_clusters=8, nprobe=3,
                        **CPU)
    path = str(tmp_path / f"ivf_{quant}.npz")
    ivf.save(path)
    back = IVFVideoIndex.load(path, **CPU)
    assert back.n_clusters == 8 and back.nprobe == 3
    assert back.video_ids == ids and back.capacity == ivf.capacity
    assert isinstance(load_index(path, **CPU), IVFVideoIndex)
    q = rng.normal(size=(3, emb.shape[1])).astype(np.float32)
    s0, i0 = ivf.search(q, k=5)
    s1, i1 = back.search(q, k=5)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(s0, s1)
    with pytest.raises(ValueError, match="load_index"):
        VideoIndex.load(path, **CPU)


def _same_search(a, b, q, nprobe):
    sa, ia = a.search(q, k=6, nprobe=nprobe)
    sb, ib = b.search(q, k=6, nprobe=nprobe)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_allclose(sa, sb, **SCORE_TOL)


@pytest.mark.parametrize("quant", ["float32", "bfloat16", "int8"])
def test_jax_saved_ivf_loads_in_the_port(rng, tmp_path, quant):
    emb = _clustered_gallery(rng, n=256)
    ids = [f"v{i}" for i in range(256)]
    jivf = JaxIVF(emb, ids, quantize=quant, n_clusters=8, nprobe=3)
    path = str(tmp_path / "jax_ivf.npz")
    jivf.save(path)
    port = load_index(path, **CPU)
    assert isinstance(port, IVFVideoIndex) and port.video_ids == ids
    np.testing.assert_array_equal(port._rowids.numpy(), jivf._rowids_host)
    np.testing.assert_array_equal(port.centroids.numpy(), jivf.centroids)
    q = rng.normal(size=(4, emb.shape[1])).astype(np.float32)
    for nprobe in (1, 3, 8):
        _same_search(port, jivf, q, nprobe)


@pytest.mark.parametrize("quant", ["float32", "bfloat16", "int8"])
def test_port_saved_ivf_loads_in_jax(rng, tmp_path, quant):
    emb = _clustered_gallery(rng, n=256)
    ids = [f"v{i}" for i in range(256)]
    port = IVFVideoIndex(emb, ids, quantize=quant, n_clusters=8, nprobe=3,
                         **CPU)
    path = str(tmp_path / "port_ivf.npz")
    port.save(path)
    jivf = jax_ivf.IVFVideoIndex.load(path)
    assert jivf.video_ids == ids and jivf.capacity == port.capacity
    np.testing.assert_array_equal(jivf._rowids_host, port._rowids_host)
    q = rng.normal(size=(4, emb.shape[1])).astype(np.float32)
    for nprobe in (1, 3, 8):
        _same_search(port, jivf, q, nprobe)


def test_ivf_add_matches_fresh_build(rng, tmp_path):
    """Incremental add (a scatter into free slots, no re-group) stays exact
    at nprobe == n_clusters: the flat index over the whole gallery.  Whether
    100 rows fit without passing the spill limit depends on the k-means
    draw, so the port adds into the JAX package's build (saved and loaded:
    the same cells) and must place every row where the JAX package's `add`
    places it."""
    emb = _clustered_gallery(rng, n=300)
    ids = [f"v{i}" for i in range(300)]
    jivf = JaxIVF(emb[:200], ids[:200], quantize="int8", n_clusters=8,
                  seed=1)
    jivf.save(str(tmp_path / "ivf.npz"))
    ivf = load_index(str(tmp_path / "ivf.npz"), **CPU)
    cap_before = ivf.capacity
    ivf.add(emb[200:], ids[200:])
    jivf.add(emb[200:], ids[200:])
    np.testing.assert_array_equal(ivf._rowids_host, jivf._rowids_host)
    assert len(ivf) == 300 and ivf.video_ids == ids and ivf.regroups == 0
    assert ivf.capacity == cap_before
    occ = (ivf._rowids_host >= 0).sum(axis=1)
    assert occ.sum() == 300 and occ.max() <= ivf.capacity
    present = np.sort(ivf._rowids_host[ivf._rowids_host >= 0])
    np.testing.assert_array_equal(present, np.arange(300))
    # host and device grouped arrays agree after the scatter
    np.testing.assert_array_equal(ivf._rowids.numpy(), ivf._rowids_host)
    flat = VideoIndex(emb, ids, quantize="int8", **CPU)
    q = rng.normal(size=(4, emb.shape[1])).astype(np.float32)
    s0, i0 = ivf.search(q, k=6, nprobe=8)
    s1, i1 = flat.search(q, k=6)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_allclose(s0, s1, **SCORE_TOL)
    np.testing.assert_array_equal(JaxIndex(emb, ids, quantize="int8")
                                  .search(q, k=6)[1], i0)


def test_ivf_add_regroups_when_out_of_room(rng):
    """More rows than the cells' free slots: the full re-group fallback
    (capacity recomputed), still exact at full probe."""
    emb = _clustered_gallery(rng, n=400)
    ids = [f"v{i}" for i in range(400)]
    ivf = IVFVideoIndex(emb[:64], ids[:64], n_clusters=4,
                        capacity_factor=1.0, seed=1, **CPU)
    room = ivf.n_clusters * ivf.capacity - 64
    assert room < 336   # the add below cannot fit incrementally
    ivf.add(emb[64:], ids[64:])
    assert len(ivf) == 400 and ivf.regroups == 1
    assert ivf.n_clusters * ivf.capacity >= 400
    s0, i0 = ivf.search(emb[:3], k=5, nprobe=ivf.n_clusters)
    s1, i1 = VideoIndex(emb, ids, **CPU).search(emb[:3], k=5)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_allclose(s0, s1, rtol=1e-3, atol=1e-3)


def test_ivf_add_spill_threshold_regroups(rng):
    """Once the rows spilled by adds pass SPILL_REGROUP_FRACTION the add
    re-groups everything and resets the spill count."""
    emb = _clustered_gallery(rng, n=256, n_centers=4)
    ids = [f"v{i}" for i in range(256)]
    ivf = IVFVideoIndex(emb[:128], ids[:128], n_clusters=4,
                        capacity_factor=3.0, seed=1, **CPU)
    assert ivf._spilled == 0
    # every appended row aims at the most loaded cell
    occ = (ivf._rowids_host >= 0).sum(axis=1)
    hot = int(np.argmax(occ))
    hot_vec = ivf.centroids[hot][None].numpy()
    n_fill = int(ivf.capacity - occ[hot])
    fill = np.repeat(hot_vec, n_fill + 40, axis=0)
    fill += 0.01 * rng.normal(size=fill.shape).astype(np.float32)
    cap_before = ivf.capacity
    ivf.add(fill, [f"fill{i}" for i in range(len(fill))])
    # 40 rows spilled > 10% of the gallery: a full re-group
    assert ivf._spilled == 0 and ivf.regroups == 1
    assert ivf.capacity > cap_before
    occ = (ivf._rowids_host >= 0).sum(axis=1)
    assert occ.max() <= ivf.capacity and occ.sum() == len(ivf)


def test_ivf_large_batch_chunks_and_negative_lookup(rng):
    """Batches above MAX_QUERY_BUCKET are chunked with identical results,
    and lookup refuses the -1 no-result sentinel."""
    emb = _clustered_gallery(rng, n=256)
    ids = [f"v{i}" for i in range(256)]
    ivf = IVFVideoIndex(emb, ids, n_clusters=8, nprobe=3, **CPU)
    big = rng.normal(size=(MAX_QUERY_BUCKET + 9, emb.shape[1]))
    big = big.astype(np.float32)
    s, i = ivf.search(big, k=5)
    assert s.shape == (MAX_QUERY_BUCKET + 9, 5)
    s0, i0 = ivf.search(big[:MAX_QUERY_BUCKET], k=5)
    s1, i1 = ivf.search(big[MAX_QUERY_BUCKET:], k=5)
    np.testing.assert_array_equal(i, np.concatenate([i0, i1]))
    np.testing.assert_allclose(s, np.concatenate([s0, s1]), rtol=1e-6)
    assert ivf.lookup(np.array([3, 0])) == ["v3", "v0"]
    with pytest.raises(ValueError, match="sentinel"):
        ivf.lookup(np.array([2, -1]))


# ------------------------------------------------------------------- engine
ARCH = "tiny-port-ivf"
TINY = dict(embed_dim=32, image_resolution=24, vision_layers=2,
            vision_width=64, vision_patch_size=8, vision_heads=4,
            context_length=16, vocab_size=49408, transformer_width=64,
            transformer_heads=4, transformer_layers=2)


def tiny_engine(monkeypatch):
    monkeypatch.setitem(port_config.CLIP_ARCHS, ARCH, TINY)
    cfg = port_config.make_run_config(
        clip_name=ARCH, max_frames=4, max_words=16,
        compute_dtype="float32").model
    return RetrievalEngine(CLIP4Clip(cfg, device="cpu"), **CPU)


def video_batches(n_batches=2, n=8, frames=4, res=24):
    for s in range(n_batches):
        g = np.random.default_rng(s)
        yield {"video": g.integers(0, 256, (n, 1, frames, 3, res, res),
                                   dtype=np.uint8),
               "video_mask": np.ones((n, frames), np.int32)}


def test_engine_search_with_ivf(monkeypatch):
    """RetrievalEngine.search over an IVF index at nprobe = K equals the
    same engine over the flat index."""
    engine = tiny_engine(monkeypatch)
    gallery = engine.embed_video_batches(video_batches())
    ids = [f"v{i}" for i in range(16)]
    texts = ["a man cooking", "a dog"]
    engine.index = VideoIndex(gallery, ids, **CPU)
    flat_out = engine.search(texts, k=4)
    engine.index = IVFVideoIndex(gallery, ids, n_clusters=4, nprobe=4, **CPU)
    ivf_out = engine.search(texts, k=4)
    for a, b in zip(flat_out, ivf_out):
        assert [r["video_id"] for r in a] == [r["video_id"] for r in b]
        np.testing.assert_allclose([r["score"] for r in a],
                                   [r["score"] for r in b], rtol=1e-5)
