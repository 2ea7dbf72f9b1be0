# coding=utf-8
"""ViT-B/16 on segments of 3 and 4 frames (N = 588 and 784 tokens a
segment) and a whole 12-frame clip (N = 2352), on the CPU, against the JAX
package.

- Kernel E's one-CTA steps past N = 512 (`global_body`, which the
  scratch variant runs, as an earlier "large" variant did), emulated here with
  numpy step for step as `csrc/kmedoids.cu` computes them:
  KKZ with each point's mindist, nearest chosen medoid and tie flag (the
  kernel keeps them in shared memory), each step's pick by the kernel's
  reduction tree (a thread's points, a warp's lanes, the CTA's warps);
  Lloyd steps that compare a point with the medoids that moved only (all K
  where its own medoid moved), sums in ascending member order and argmins
  for the clusters whose member set changed only; the last assignment by
  rank where no medoid may tie.  It is held against the port's plain
  `kmedoids_on_distances` and the JAX package's own route at these N,
  `ops/kmedoids.py:batch_fast_kmedoids`, all three on the same distances
  (JAX's are handed to its `batch_fast_kmedoids` in place of the ones it
  would compute): ids, assignment, and the kernel's steps to the fixed
  point.  Inputs: blobs, an unplanted Gaussian (at K = N / 2 too, where
  two-member clusters tie exactly), and the exact-tie, equidistant,
  repeated-point and iteration-limit cases.
- Kernel E's cluster variant (`kmedoids_cluster_kernel`, the router's past
  N = 512), emulated on clusters of 1, 2, 8 and 16 CTAs: each CTA's chunk
  range, KKZ's pick by each CTA's warps' slots then the cluster's, the
  orphans and moved medoids visited in shuffled orders, the member lists
  each CTA assembles from the counts and mask words, and each block of 32
  candidates' sums as loads then a fold in member order; its ids,
  assignment and steps equal the one-CTA emulation's, the plain version's
  and JAX's on the same inputs.
- The whole path: the narrow ViT-B/16 of tests/test_torch_vitb16.py with 4
  frames as one segment (N = 784) at K = 160 and at K = 392 (blocks 3-4
  then attend over L = 393 > 256): the loss and every gradient against
  JAX's, the port's medoid ids replayed into JAX (tests/test_torch_
  vitb16.py explains why).
- The CLIs: both packages parse the path's flags to the same config.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centerclip_tpu import cli as jax_cli
from centerclip_tpu import config as jax_config
from centerclip_tpu.models.clip4clip import CLIP4Clip as JaxCLIP4Clip
from centerclip_tpu.ops import cluster_layer as jax_cluster
from centerclip_tpu.ops import kmedoids as jax_kmedoids
from centerclip_tpu.ops.distances import pairwise_distance as jax_pairwise
from centerclip_tpu_torch import cli
from centerclip_tpu_torch import config as port_config
from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
from centerclip_tpu_torch.models.weights import (clip4clip_entries,
                                                 state_dict_from_jax_params)
from centerclip_tpu_torch.ops import _build, cluster_layer, kmedoids_cuda
from centerclip_tpu_torch.ops.kmedoids import (fixed_point_steps,
                                               kmedoids_on_distances)
from centerclip_tpu_torch.train import loop

# ----------------------------------------------- E's large variant, emulated
THREADS, WARPS = 256, 8           # csrc/kmedoids.cu kGlobalThreads, warps
INT_MIN, INT_MAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max


def _ordered(f):
    """The kernel's `ordered`: fp32 -> int32 of the same order, -0 as +0."""
    f = np.where(f == 0, np.float32(0), f).astype(np.float32)
    b = f.view(np.int32)
    return np.where(b >= 0, b, b ^ np.int32(0x7fffffff)).astype(np.int64)


def _pick(v):
    """The first index of the largest ordered value in v [N], by the
    kernel's tree: each thread t its points t, t + 256, ... in ascending
    order (a strictly larger value replaces), then the lanes of each warp
    (the largest value, then the lowest index holding it), then the warps
    in order (`block_argmax`)."""
    N = len(v)
    P = -(-N // THREADS)
    grid = np.full((P, THREADS), INT_MIN, np.int64)
    grid.reshape(-1)[:N] = v
    tv = grid.max(axis=0)
    ti = grid.argmax(axis=0) * THREADS + np.arange(THREADS)
    ti = np.where(tv > INT_MIN, ti, INT_MAX)
    wv = tv.reshape(WARPS, 32).max(axis=1)
    wi = np.where(tv.reshape(WARPS, 32) == wv[:, None],
                  ti.reshape(WARPS, 32), INT_MAX).min(axis=1)
    bv, bi = wv[0], wi[0]
    for w in range(1, WARPS):
        if wv[w] > bv or (wv[w] == bv and wi[w] < bi):
            bv, bi = wv[w], wi[w]
    return int(bi)


def _take_all(vals, ks, bv, bk, tie):
    """`take` of the candidates (vals[i], ks[i]) into each point's running
    (bv, bk, tie), in any order (the kernel lists moved medoids in the
    order of its atomics): the lowest value wins, the first k among equal
    ones; tie is set where two candidates hold a new minimum, or one holds
    the old one, and kept where the minimum did not move."""
    lo = vals.min(axis=0)
    first_k = np.where(vals == lo, ks[:, None], INT_MAX).min(axis=0)
    n_lo = (vals == lo).sum(axis=0)
    lower = lo < bv
    equal = lo == bv
    return (np.where(lower, lo, bv),
            np.where(lower, first_k, np.where(equal, np.minimum(bk, first_k),
                                              bk)),
            np.where(lower, n_lo > 1, tie | equal))


def _scan_all(key, order):
    """`warp_scan_all` of every point over the medoids `order`: (value,
    first k, tie) of its nearest."""
    vals = key[order]                                   # [K, N]
    lo = vals.min(axis=0)
    return lo, (vals == lo).argmax(axis=0), (vals == lo).sum(axis=0) > 1


def emulated_large_kmedoids(D, l2, K, iter_limit=100, id_sort=True):
    """One segment as `global_body` computes it on one CTA (the scratch
    variant, and the earlier large one): (assign [N], medoids [K], Lloyd
    steps)."""
    N = D.shape[0]
    key = _ordered(D)
    # ---- KKZ: best, assign, tie per point, as the kernel's shared arrays
    idx = _pick(_ordered(l2))
    meds = [idx]
    best, assign = key[idx].copy(), np.zeros(N, np.int64)
    tie = np.zeros(N, bool)
    for k in range(1, K):
        idx = _pick(best)
        meds.append(idx)
        d = key[idx]
        lt, eq = d < best, d == best
        best = np.where(lt, d, best)
        assign = np.where(lt, k, assign)
        tie = np.where(lt, False, tie | eq)
    meds = np.array(meds)

    def reassign(moved):
        """Bring (best, assign, tie) up to date after `moved` moved;
        returns the clusters whose member set changed."""
        nonlocal best, assign, tie
        orphan = np.isin(assign, moved)
        mk = np.array(moved)
        bv, bk, t = _take_all(key[meds[mk]], mk, best, assign, tie)
        sv, sk, st = _scan_all(key, meds)
        bv, bk, t = (np.where(orphan, a, b) for a, b in
                     ((sv, bv), (sk, bk), (st, t)))
        changed = bk != assign
        dirty = set(assign[changed]) | set(bk[changed])
        best, assign, tie = bv, bk, t
        return dirty

    dirty = np.ones(K, bool)
    sums = np.zeros(N, np.float32)
    moved, steps = [], 0
    while steps < iter_limit:
        if moved:
            for k in reassign(moved):
                dirty[k] = True
        moved = []
        for k in np.flatnonzero(dirty):
            mem = np.flatnonzero(assign == k)        # ascending, as the masks
            if len(mem):
                # each candidate's fp32 sum over its members, in order
                sums[mem] = np.add.accumulate(D[np.ix_(mem, mem)], axis=1,
                                              dtype=np.float32)[:, -1]
            nm = int(mem[np.argmin(sums[mem])]) if len(mem) else 0
            if nm != meds[k]:
                meds[k] = nm
                moved.append(int(k))
        dirty[:] = False
        steps += 1
        if not moved:
            break
    if moved:
        reassign(moved)
    if not id_sort:
        return assign, meds, steps
    order = np.argsort(meds, kind="stable")
    rank_of = np.empty(K, np.int64)
    rank_of[order] = np.arange(K)
    sorted_meds = meds[order]
    return (np.where(tie, _scan_all(key, sorted_meds)[1], rank_of[assign]),
            sorted_meds, steps)


# ------------------------------------------- E's cluster variant, emulated
def cta_ranges(N, cs):
    """The own points [p0, p1) of each CTA of a cluster of `cs`: CTA r owns
    the 32-point chunks [r nc / cs, (r + 1) nc / cs), nc = ceil(N / 32)."""
    nc = -(-N // 32)
    return [(32 * (r * nc // cs), min(32 * ((r + 1) * nc // cs), N))
            for r in range(cs)]


def _warp_slots(v, p0, p1):
    """One CTA's 8 warps' (largest value, lowest index holding it) of its
    own points' values v[p0:p1], thread t holding p0 + t + 256 i in
    ascending order (a strictly larger value replaces)."""
    n = p1 - p0
    grid = np.full((max(1, -(-n // THREADS)), THREADS), INT_MIN, np.int64)
    grid.reshape(-1)[:n] = v[p0:p1]
    tv = grid.max(axis=0)
    ti = np.where(tv > INT_MIN, grid.argmax(axis=0) * THREADS
                  + np.arange(THREADS) + p0, INT_MAX)
    wv = tv.reshape(WARPS, 32).max(axis=1)
    wi = np.where(tv.reshape(WARPS, 32) == wv[:, None],
                  ti.reshape(WARPS, 32), INT_MAX).min(axis=1)
    return list(zip(wv.tolist(), wi.tolist()))


def _cluster_pick(v, ranges):
    """`cluster_argmax`: every CTA's warp slots, slot rank x 8 + warp; each
    lane of a warp takes the slots lane, lane + 32, ... in order (a larger
    value, or an equal one at a lower index, replaces), then the lanes
    agree (the largest value, then the lowest index holding it)."""
    slots = [s for p0, p1 in ranges for s in _warp_slots(v, p0, p1)]
    lanes = []
    for lane in range(32):
        bv, bi = INT_MIN, INT_MAX
        for sv, si in slots[lane::32]:
            if sv > bv or (sv == bv and si < bi):
                bv, bi = sv, si
        lanes.append((bv, bi))
    top = max(lv for lv, _ in lanes)
    return min(li for lv, li in lanes if lv == top)


def _take_in_order(vals, ks, bv, bk, tie):
    """The kernel's `take` of the candidates (vals[i], ks[i]) one after
    another, in the order given, into each point's (bv, bk, tie)."""
    for d, k in zip(vals, ks):
        lt, eq = d < bv, d == bv
        bk = np.where(lt, k, np.where(eq, np.minimum(bk, k), bk))
        tie = np.where(lt, False, tie | eq)
        bv = np.where(lt, d, bv)
    return bv, bk, tie


def _member_lists(assign, dirty, K, ranges):
    """Every CTA's member lists after a step's assignment, as the kernel
    builds them: each CTA's own-chunk member masks and counts; each dirty
    cluster's size, its members in lower CTAs and (scans over k) its list's
    offset and its first block of 32 candidates; each own member of a dirty
    cluster at offset + members in lower CTAs + its rank among the CTA's own
    members (the popcounts of its mask words below it).  Returns (size,
    offsets, block starts, lists)."""
    N = len(assign)
    counts = np.zeros((len(ranges), K), np.int64)
    for r, (p0, p1) in enumerate(ranges):
        counts[r] = np.bincount(assign[p0:p1], minlength=K)
    size = np.where(dirty, counts.sum(0), -1)
    lens = np.maximum(size, 0)
    blocks = -(-lens // 32)
    off, start = np.cumsum(lens) - lens, np.cumsum(blocks) - blocks
    below = np.cumsum(counts, axis=0) - counts
    lists = np.full(N, -1, np.int64)
    for r, (p0, p1) in enumerate(ranges):
        j = np.arange(p1 - p0)
        chunk, lane = j // 32, j % 32
        masks = np.zeros((K, -(-(p1 - p0) // 32)), np.uint32)
        np.bitwise_or.at(masks, (assign[p0:p1], chunk),
                         (np.uint32(1) << lane.astype(np.uint32)))
        words = np.bitwise_count(masks).astype(np.int64)
        before = np.cumsum(words, axis=1) - words      # words below a chunk
        a = assign[p0:p1]
        rank = before[a, chunk] + np.bitwise_count(
            masks[a, chunk] & ((np.uint32(1) << lane.astype(np.uint32))
                               - np.uint32(1))).astype(np.int64)
        mine = size[a] > 0
        lists[(off[a] + below[r, a] + rank)[mine]] = (p0 + j)[mine]
    return size, off, start, lists


def emulated_cluster_kmedoids(D, l2, K, cs, iter_limit=100, id_sort=True,
                              seed=0):
    """One segment as `kmedoids_cluster_kernel` computes it on a cluster of
    `cs` CTAs: (assign [N], medoids [K], Lloyd steps).  The orders the
    kernel leaves to its warps (each CTA's moved-medoid list, which
    orphans a warp scans, which blocks of candidates a warp sums) are drawn
    from `seed`."""
    rng = np.random.default_rng(seed)
    N = D.shape[0]
    key = _ordered(D)
    ranges = cta_ranges(N, cs)
    # ---- KKZ: each CTA its own points' best, assign and tie; the pick by
    # the cluster's tree
    idx = _cluster_pick(_ordered(l2), ranges)
    meds = [idx]
    best, assign = key[idx].copy(), np.zeros(N, np.int64)
    tie = np.zeros(N, bool)
    for k in range(1, K):
        idx = _cluster_pick(best, ranges)
        meds.append(idx)
        d = key[idx]
        lt, eq = d < best, d == best
        best = np.where(lt, d, best)
        assign = np.where(lt, k, assign)
        tie = np.where(lt, False, tie | eq)
    meds = np.array(meds)

    def reassign(moved):
        """Each CTA's own points after `moved` moved; returns the clusters
        whose member set changed."""
        nonlocal best, assign, tie
        dirty = set()
        for p0, p1 in ranges:
            own = np.arange(p0, p1)
            orphan = np.isin(assign[own], moved)
            stay = own[~orphan]
            order = rng.permutation(np.array(moved))
            bv, bk, t = _take_in_order(key[meds[order]][:, stay], order,
                                       best[stay], assign[stay], tie[stay])
            dirty |= set(assign[stay][bk != assign[stay]].tolist())
            dirty |= set(bk[bk != assign[stay]].tolist())
            best[stay], assign[stay], tie[stay] = bv, bk, t
            for j in rng.permutation(own[orphan]):     # any warp, any order
                col = key[meds, j]
                lo = col.min()
                k = int(np.argmax(col == lo))
                if k != assign[j]:
                    dirty |= {int(assign[j]), k}
                best[j], assign[j], tie[j] = lo, k, (col == lo).sum() > 1
        return dirty

    dirty = np.ones(K, bool)
    moved, steps = [], 0
    while steps < iter_limit:
        if moved:
            for k in reassign(moved):
                dirty[k] = True
        size, off, start, lists = _member_lists(assign, dirty, K, ranges)
        least = {}
        for it in rng.permutation(int(start[-1] + -(-max(size[-1], 0) // 32))):
            k = int(np.searchsorted(start, it, side="right") - 1)
            mem = lists[off[k]:off[k] + size[k]]
            cand = mem[32 * (it - start[k]):32 * (it - start[k] + 1)]
            loads = D[np.ix_(cand, mem)]
            # each lane's adds in ascending member order
            sums = np.add.accumulate(loads, axis=1, dtype=np.float32)[:, -1]
            o = _ordered(sums)
            block = (int(o.min()), int(cand[o == o.min()].min()))
            least[k] = min(least.get(k, block), block)
        moved = []
        for k in np.flatnonzero(dirty):
            nm = least[k][1] if size[k] else 0
            if nm != meds[k]:
                meds[k] = nm
                moved.append(int(k))
        dirty[:] = False
        steps += 1
        if not moved:
            break
    if moved:
        reassign(moved)
    if not id_sort:
        return assign, meds, steps
    order = np.argsort(meds, kind="stable")
    rank_of = np.empty(K, np.int64)
    rank_of[order] = np.arange(K)
    sorted_meds = meds[order]
    return (np.where(tie, _scan_all(key, sorted_meds)[1], rank_of[assign]),
            sorted_meds, steps)


def jax_on_distances(X, D, K, iter_limit=100, id_sort=True):
    """The JAX package's `batch_fast_kmedoids` (its route at N past the
    Pallas kernel's VMEM) with the distances D in place of the ones it
    computes from X; and the norms its KKZ takes.  Returns numpy (assign,
    medoids, l2)."""
    def run(X, D):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_kmedoids, "pairwise_distance", lambda *_, **__: D)
            a, m = jax_kmedoids.batch_fast_kmedoids.__wrapped__(
                X, K, iter_limit=iter_limit, id_sort=id_sort)
        return a, m, jnp.linalg.norm(X, axis=-1)
    return tuple(np.asarray(o) for o in jax.jit(run)(jnp.asarray(X),
                                                      jnp.asarray(D)))


def check_three(X, D, K, iter_limit=100, id_sort=True, sizes=()):
    """Emulation, the port's plain version and JAX's route agree on the
    same distances: ids and assignment in every segment, and the emulated
    steps are the plain version's steps to each segment's fixed point
    (when it reached one).  With `sizes`, the cluster variant's emulation
    on clusters of each of those CTA counts gives the large variant's
    emulation's ids, assignment and steps too."""
    ja, jm, l2 = jax_on_distances(X, D, K, iter_limit, id_sort)
    Xt, Dt, lt = (torch.from_numpy(np.array(a, np.float32))
                  for a in (X, D, l2))
    pa, pm = kmedoids_on_distances(Xt, Dt, lt, K, iter_limit=iter_limit,
                                   id_sort=id_sort)
    want_steps = fixed_point_steps(Dt, lt, K, iter_limit).numpy()
    for b in range(D.shape[0]):
        a, m, steps = emulated_large_kmedoids(D[b], l2[b], K, iter_limit,
                                              id_sort)
        np.testing.assert_array_equal(m, pm[b].numpy())
        np.testing.assert_array_equal(m, jm[b])
        np.testing.assert_array_equal(a, pa[b].numpy())
        np.testing.assert_array_equal(a, ja[b])
        assert steps == want_steps[b]
        for cs in sizes:
            ca, cm, csteps = emulated_cluster_kmedoids(D[b], l2[b], K, cs,
                                                       iter_limit, id_sort,
                                                       seed=cs + b)
            np.testing.assert_array_equal(cm, m, err_msg=f"{cs} CTAs")
            np.testing.assert_array_equal(ca, a, err_msg=f"{cs} CTAs")
            assert csteps == steps, cs


def _distances(x):
    """JAX's distances with both tricks, the ones every side takes."""
    return np.asarray(jax.jit(lambda x: jax_pairwise(
        x, x, all_negative=True, self_nearest=True))(jnp.asarray(x)))


def _blobs(seed, B, N, Dim, centres):
    g = np.random.default_rng(seed)
    c = g.standard_normal((B, centres, Dim)).astype(np.float32) * 5.0
    pick = g.integers(0, centres, (B, N))
    return (np.take_along_axis(c, pick[..., None], 1)
            + g.standard_normal((B, N, Dim)) * 0.5).astype(np.float32)


def _line(p):
    """Points p [B, N] on a line: (X [B, N, 1], D with both tricks), every
    distance and every sum of them exact in fp32."""
    dis = np.abs(p[:, :, None] - p[:, None, :])
    N = p.shape[1]
    D = (dis - dis.max(axis=(1, 2), keepdims=True) - 1.0
         - np.eye(N, dtype=np.float32)).astype(np.float32)
    return p[..., None].astype(np.float32), D


@pytest.mark.parametrize("N,K,data", [
    (588, 160, "blobs"),          # ViT-B/16, segments of 3 frames
    (784, 160, "blobs"),          # segments of 4 frames
    (784, 160, "gaussian"),
    (588, 294, "gaussian"),       # K = N / 2: two-member clusters tie
    (784, 392, "blobs"),          # the most medoids the path takes
    (2352, 160, "blobs"),         # a whole 12-frame clip
])
def test_large_variant_matches_plain_and_jax(N, K, data):
    if data == "blobs":
        x = _blobs(N + K, 2, N, 16, centres=60)
    else:
        x = np.random.default_rng(N + K).standard_normal(
            (2, N, 16)).astype(np.float32)
    if N == 2352:
        x = x[:1]
    check_three(x, _distances(x), K)


def test_large_variant_first_index_wins_exact_ties():
    """160 groups of 4 consecutive integers on a line, far apart (N = 640):
    the two middle points of each group tie exactly as medoid, and the one
    with the lower index must win (the second segment shuffles the
    points)."""
    K = 160
    p = (50 * np.arange(K)[:, None] + np.arange(4)).reshape(-1)
    p = np.stack([p, np.random.default_rng(K).permutation(p)])
    X, D = _line(p.astype(np.float32))
    for b in range(2):
        a, m, _ = emulated_large_kmedoids(D[b], np.abs(p[b]).astype(
            np.float32), K)
        for k in range(K):
            group = np.flatnonzero(a == k)
            assert len(group) == 4
            assert m[k] == group[np.argsort(p[b, group])[1:3]].min()
    check_three(X, D, K)


def test_large_variant_points_equidistant_from_two_medoids():
    """180 runs of 3 consecutive integers, K = 360 (N = 540): KKZ takes both
    ends of each run, so each middle point lies exactly as near to two
    medoids; the first index must win before and after the id sort."""
    G = 180
    p = (50 * np.arange(G)[:, None] + np.arange(3)).reshape(-1)
    g = np.random.default_rng(G)
    X, D = _line(np.stack([g.permutation(p) for _ in range(2)]).astype(
        np.float32))
    for id_sort in (True, False):
        check_three(X, D, 2 * G, id_sort=id_sort)


@pytest.mark.parametrize("K", [6, 160])
def test_large_variant_repeated_points(K):
    """600 integers drawn from 0-199 (K = 160) or 0-11 (K = 6) on a line:
    points repeat and distances tie everywhere."""
    span = 200 if K == 160 else 12
    p = np.random.default_rng(K).integers(0, span, (2, 600))
    X, D = _line(p.astype(np.float32))
    check_three(X, D, K)


@pytest.mark.parametrize("iter_limit", [0, 1, 2])
def test_large_variant_iteration_limits(iter_limit):
    """Stopped before the fixed point: the assignment brought up to date
    after the last update, then sorted."""
    x = _blobs(9, 2, 784, 16, centres=60)
    check_three(x, _distances(x), 160, iter_limit=iter_limit)


# E's cluster variant (csrc/kmedoids.cu `kmedoids_cluster_kernel`): its
# emulation on clusters of these CTA counts against the large variant's
# emulation, the plain version and JAX's
CLUSTER_SIZES = (1, 2, 8, 16)


@pytest.mark.parametrize("N,K,data", [
    (784, 160, "blobs"),          # segments of 4 frames
    (784, 392, "gaussian"),       # the most medoids the path takes
    (2352, 160, "blobs"),         # a whole 12-frame clip
])
def test_cluster_design_matches_large_plain_and_jax(N, K, data):
    if data == "blobs":
        x = _blobs(N + K + 1, 1, N, 16, centres=60)
    else:
        x = np.random.default_rng(N + K + 1).standard_normal(
            (1, N, 16)).astype(np.float32)
    check_three(x, _distances(x), K, sizes=CLUSTER_SIZES)


def test_cluster_design_first_index_wins_exact_ties():
    """test_large_variant_first_index_wins_exact_ties's 160 groups of 4
    consecutive integers, on clusters of 1-16 CTAs: the tied medoids'
    lower index wins whichever CTA holds it."""
    K = 160
    p = (50 * np.arange(K)[:, None] + np.arange(4)).reshape(-1)
    p = np.stack([p, np.random.default_rng(K).permutation(p)])
    X, D = _line(p.astype(np.float32))
    check_three(X, D, K, sizes=CLUSTER_SIZES)


@pytest.mark.parametrize("id_sort", [True, False])
def test_cluster_design_points_equidistant_from_two_medoids(id_sort):
    G = 180
    p = (50 * np.arange(G)[:, None] + np.arange(3)).reshape(-1)
    g = np.random.default_rng(G)
    X, D = _line(np.stack([g.permutation(p)]).astype(np.float32))
    check_three(X, D, 2 * G, id_sort=id_sort, sizes=CLUSTER_SIZES)


@pytest.mark.parametrize("K", [6, 160])
def test_cluster_design_repeated_points(K):
    """Integers drawn from a short span on a line, N = 784: points repeat,
    distances tie everywhere, the orphans of a step are many."""
    span = 200 if K == 160 else 12
    p = np.random.default_rng(K + 1).integers(0, span, (1, 784))
    X, D = _line(p.astype(np.float32))
    check_three(X, D, K, sizes=CLUSTER_SIZES)


@pytest.mark.parametrize("iter_limit", [0, 1, 2])
def test_cluster_design_iteration_limits(iter_limit):
    x = _blobs(10, 1, 784, 16, centres=60)
    check_three(x, _distances(x), 160, iter_limit=iter_limit,
                sizes=CLUSTER_SIZES)


def test_cluster_design_member_lists_ascend():
    """Every CTA's member lists, assembled from each CTA's own counts, the
    counts of the CTAs below it and the popcounts of its mask words, are
    each dirty cluster's members in ascending order, at every size."""
    g = np.random.default_rng(0)
    N, K = 3137, 160
    assign = g.integers(0, K, N)
    dirty = g.random(K) < 0.5
    for cs in CLUSTER_SIZES:
        size, off, start, lists = _member_lists(assign, dirty, K,
                                                cta_ranges(N, cs))
        for k in range(K):
            mem = np.flatnonzero(assign == k)
            if dirty[k]:
                assert size[k] == len(mem)
                np.testing.assert_array_equal(
                    lists[off[k]:off[k] + size[k]], mem)
            else:
                assert size[k] == -1
        assert start[-1] == sum(-(-len(np.flatnonzero(assign == k)) // 32)
                                for k in range(K - 1) if dirty[k])


def test_cta_ranges_split_the_chunks():
    """CTA r owns the chunks [r nc / cs, (r + 1) nc / cs): together every
    point once, in order, at most ceil(nc / cs) chunks each."""
    for N in (513, 784, 2352, 3137, 3920):
        for cs in CLUSTER_SIZES:
            ranges = cta_ranges(N, cs)
            assert ranges[0][0] == 0 and ranges[-1][1] == N
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
            most = 32 * -(-(-(-N // 32)) // cs)
            assert max(p1 - p0 for p0, p1 in ranges) <= most
            assert min(p1 - p0 for p0, p1 in ranges) > 0


# ------------------------------------------------------------ the whole path
ARCH = "narrow-vitb16-long"
T, RES, VOCAB, CTX, N_CLIPS = 4, 224, 100, 12, 2
NARROW = dict(embed_dim=32, image_resolution=RES, vision_layers=4,
              vision_width=64, vision_patch_size=16, vision_heads=4,
              context_length=CTX, vocab_size=VOCAB, transformer_width=64,
              transformer_heads=4, transformer_layers=2)
jax_config.CLIP_ARCHS[ARCH] = NARROW
port_config.CLIP_ARCHS[ARCH] = NARROW
N_TOKENS = T * 196                 # 4 frames as one segment
FP32 = dict(rtol=2e-4, atol=2e-5)  # tests/test_torch_vitb16.py


def config_kw(K):
    return dict(clip_name=ARCH, max_frames=T, max_words=CTX,
                compute_dtype="float32", inter=True, algo="kmediods++",
                cluster_num_blocks=(196, 196, K, K),
                target_frames_blocks=(T, T, 1, 1), cluster_embedding=True,
                adaptive_cls=True, lr=1e-3, coef_lr=0.5, weight_decay=0.2,
                warmup_proportion=0.0)


def make_batch(seed):
    g = np.random.default_rng(seed)
    ids = g.integers(1, VOCAB - 2, size=(N_CLIPS, CTX)).astype(np.int32)
    ids[:, 0] = VOCAB - 2
    ids[np.arange(N_CLIPS), g.integers(3, CTX, N_CLIPS)] = VOCAB - 1
    return {"input_ids": ids,
            "attention_mask": np.ones((N_CLIPS, CTX), np.int32),
            "video": g.integers(0, 256, (N_CLIPS, 1, T, 3, RES, RES),
                                dtype=np.uint8),
            "video_mask": np.ones((N_CLIPS, T), np.int32)}


@contextlib.contextmanager
def replayed(ids, K):
    """Both packages' cluster layers take the medoid ids `ids` (assign,
    medoids) on [N_CLIPS, 784, 64] tokens, and count their calls."""
    calls = []

    def port_ids(X, k, **_):
        assert tuple(X.shape) == (N_CLIPS, N_TOKENS, 64) and k == K
        calls.append("port")
        return (torch.from_numpy(ids[0].copy()),
                torch.from_numpy(ids[1].copy()))

    def jax_ids(X, k, **_):
        assert tuple(X.shape) == (N_CLIPS, N_TOKENS, 64) and k == K
        calls.append("jax")
        return jnp.asarray(ids[0]), jnp.asarray(ids[1])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cluster_layer, "kmedoids", port_ids)
        mp.setattr(jax_cluster, "batch_fast_kmedoids", jax_ids)
        yield calls


@pytest.mark.parametrize("K", [160, 392])
def test_loss_and_every_gradient_match_jax_on_4_frame_segments(K):
    """One training step's loss and every gradient, port against JAX, with
    the port's own plain k-medoids ids (on its tokens, at N = 784)
    replayed in both; blocks 3-4 run at L = 1 + K."""
    jrun = jax_config.make_run_config(**config_kw(K))
    run = port_config.make_run_config(**config_kw(K))
    assert dataclasses.asdict(run) == dataclasses.asdict(jrun)
    batch = make_batch(K)
    arange = (np.zeros((N_CLIPS, N_TOKENS), np.int32),
              np.tile(np.arange(K, dtype=np.int32), (N_CLIPS, 1)))
    jmodel = JaxCLIP4Clip(jrun.model)
    with replayed(arange, K):
        params = jmodel.init(jax.random.PRNGKey(0),
                             input_ids=batch["input_ids"],
                             video=batch["video"].astype(np.float32),
                             video_mask=batch["video_mask"],
                             training=True)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)

    def port_model():
        model = CLIP4Clip(run.model, device="cpu")
        model.load_state_dict(state_dict_from_jax_params(params, run.model),
                              strict=True)
        return model
    # the port's own plain k-medoids on the port's tokens
    chosen, lengths = [], []
    plain = cluster_layer.kmedoids

    def recording(X, k, **kw):
        out = plain(X, k, **kw)
        chosen.append(tuple(o.numpy().copy() for o in out))
        return out
    model = port_model()
    hooks = [b.register_forward_pre_hook(
        lambda m, a: lengths.append(a[0].shape[1]))
        for b in model.clip.visual.transformer.resblocks]
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(cluster_layer, "kmedoids", recording)
        model(**loop.batch_to_device(batch, torch.device("cpu")),
              training=True)
    for h in hooks:
        h.remove()
    assert lengths == [197, 197, 1 + K, 1 + K]
    ids = chosen[0]
    assert ids[1].shape == (N_CLIPS, K)
    assert all(len(np.unique(m)) == K for m in ids[1])

    def loss_fn(p):
        out = jmodel.apply({"params": p}, input_ids=batch["input_ids"],
                           attention_mask=batch["attention_mask"],
                           video=batch["video"],
                           video_mask=batch["video_mask"], training=True,
                           rng=jax.random.PRNGKey(0))
        return out["loss"], out["sim_loss"]
    with replayed(ids, K) as calls:
        (jloss, jsim), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
    assert calls == ["jax"]
    model = port_model()
    with replayed(ids, K) as calls:
        out = model(**loop.batch_to_device(batch, torch.device("cpu")),
                    training=True)
        out["loss"].backward()
    assert calls == ["port"]
    np.testing.assert_allclose(float(out["loss"].detach()), float(jloss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(out["sim_loss"].detach()), float(jsim),
                               rtol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    for path, key, tf in clip4clip_entries(run.model):
        ref = jgrads
        for part in path:
            ref = ref[part]
        ref = np.asarray(ref)
        assert grads[key] is not None, key
        np.testing.assert_allclose(grads[key].numpy(),
                                   ref.T if tf == "T" else ref,
                                   err_msg=key, **FP32)


# ------------------------------------------------------------------ the CLIs
COMMON = [
    "--do_train", "1", "--do_eval", "1", "--datatype", "msrvtt",
    "--train_csv", "d/train.csv", "--val_csv", "d/test.csv",
    "--data_path", "d/MSRVTT_data.json", "--features_path", "d/videos",
    "--output_dir", "out/b16", "--max_words", "32", "--max_frames", "12",
    "--feature_framerate", "3", "--batch_size", "128", "--batch_size_val",
    "128", "--epochs", "5", "--optim", "AdamW", "--lr", "2e-3", "--coef_lr",
    "1e-3", "--wd", "0.2", "--warmup_proportion", "0.1", "--loose_type",
    "--sim_header", "meanP", "--slice_framepos", "2",
    "--expand_msrvtt_sentences", "--precision", "amp",
    "--pretrained_clip_name", "ViT-B/16", "--remat", "1",
    "--num_thread_reader", "8", "--cluster_inter", "1", "--cluster_algo",
    "kmediods++"]


@pytest.mark.parametrize("segments,K", [(3, 160), (4, 160), (3, 392)])
def test_clis_parse_the_path_flags_to_the_same_plan(segments, K):
    """`--target_frames_blocks 12 x 6, S x 6` with `--cluster_num_blocks
    196 x 6, K x 6` at ViT-B/16: the same config from both CLIs, and a
    plan that clusters 12 / S frames of 196 tokens into K before block 7,
    whose N the kernel takes with its cluster variant."""
    argv = COMMON + ["--cluster_num_blocks", *["196"] * 6, *[str(K)] * 6,
                     "--target_frames_blocks", *["12"] * 6,
                     *[str(segments)] * 6]
    a, b = cli.parse_args(argv), jax_cli.parse_args(argv)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    plan = a.model.cluster_plan()
    assert [dataclasses.asdict(s) if s else None for s in plan] == \
        [dataclasses.asdict(s) if s else None for s in b.model.cluster_plan()]
    assert list(plan[:6]) == [None] * 6
    spec = plan[6]
    N = spec.frame_duration * spec.before_cluster_num
    assert (N, spec.cluster_num, spec.after_frames) == \
        (196 * 12 // segments, K, segments)
    assert kmedoids_cuda.choose_variant(N) == kmedoids_cuda.CLUSTER
    assert a.model.remat and a.model.clip_name == "ViT-B/16"
