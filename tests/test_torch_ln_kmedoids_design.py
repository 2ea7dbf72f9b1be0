# coding=utf-8
"""The designs of the LayerNorm kernels (C forward, D backward) and the
k-medoids kernel (E), held on the CPU.

- C's launch plan: a warp a row, every row covered once, the CTA cap, and
  which rows take the vector path.
- C's arithmetic: each lane's fp32 sum of its elements in column order,
  then the warp's xor tree, fmaf for the squares and the output, emulated
  here and held against `layer_norm_plain` and the JAX package's
  `_ln_fwd_call` (interpret mode).
- D's launch plan: the rows each program takes, and the program cap.
- D's sums: per-program fp32 partials over the plan's row ranges, summed
  per ticket group and then over the groups, each in program order,
  emulated here and held against `layer_norm_bwd_plain` and the JAX
  package's `_ln_bwd_call` (interpret mode).
- E's Lloyd update on member masks: KKZ on order-preserving int keys, the
  assignment, each 32-point chunk's member masks (what `__match_any_sync`
  gives the chunk's lanes), each candidate's sum over its own cluster's
  members in ascending order, and each cluster's first-index argmin,
  emulated here with numpy and held against the port's
  `kmedoids_on_distances` and the JAX package's `kmedoids_from_distances`
  (interpret mode) on the same distances.  The shared-memory variant runs
  it step by step; the global variant (D read from device memory) reaches
  the same ids, assignment and steps by reading only what changed, which
  is emulated too.  Which variant a segment size takes is a pure function
  of N and K, and the cluster variant's CTAs a segment one of B, N, K and
  the clusters the card holds at once; its layout and E's two bounds (4-byte
  entries, 32-byte sectors) are held too.
"""
import contextlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from centerclip_tpu.ops.distances import pairwise_distance as jax_pairwise
from centerclip_tpu.ops.kmedoids_pallas import kmedoids_from_distances
from centerclip_tpu.ops.layernorm_pallas import _ln_bwd_call, _ln_fwd_call
from centerclip_tpu_torch import kernel_timing
from centerclip_tpu_torch.ops import _build, kmedoids_cuda, layernorm_triton
from centerclip_tpu_torch.ops.kmedoids import kmedoids_on_distances
from centerclip_tpu_torch.ops.layernorm_triton import (
    _BWD_SM_WARPS, _FWD_WARPS, bwd_launch_plan, fwd_launch_plan, fwd_vecs,
    layer_norm_bwd_plain, layer_norm_plain)

# the H100's SM count
N_SM = 132
# chip_smoke.py's tolerance for fp32 sums over rows taken in another order
SUM_RTOL = 1e-5


# -------------------------------------------------------------- C's plan
@pytest.mark.parametrize("R", [1, 7, 128, 4096, 4800, 76800])
@pytest.mark.parametrize("D", [512, 768])
def test_fwd_plan_covers_every_row_once(R, D):
    ctas_per_sm = 5
    plan = fwd_launch_plan(R, D, 2, N_SM, ctas_per_sm)
    W = plan.ctas * _FWD_WARPS
    assert 1 <= plan.ctas <= N_SM * ctas_per_sm
    if R <= N_SM * ctas_per_sm * _FWD_WARPS:      # a warp a row
        assert plan.ctas == -(-R // _FWD_WARPS)
    # warp w takes rows w, w + W, ... (csrc/layernorm.cu): the warps of one
    # step read neighbouring rows
    seen = np.zeros(R, np.int64)
    for w in range(W):
        seen[w:R:W] += 1
    assert (seen == 1).all()
    assert (plan.ctas - 1) * _FWD_WARPS < R    # no CTA without a row


@pytest.mark.parametrize("D,elem,aligned,vecs", [
    (768, 2, True, 3), (512, 2, True, 2), (768, 4, True, 6), (512, 4, True, 4),
    (2048, 2, True, 8), (2304, 2, True, 0), (1000, 2, True, 0),
    (1000, 4, True, 0), (100, 2, True, 0), (768, 2, False, 0),
    (256, 2, True, 1), (128, 2, True, 0), (1024, 4, True, 8)])
def test_fwd_vector_path_from_width_and_alignment(D, elem, aligned, vecs):
    """16-byte vectors a lane on the vector path (a row a whole number of
    512-byte warp-wide pieces, at most 8); 0 takes the scalar path (any
    other width, or a pointer not 16-byte aligned)."""
    assert fwd_vecs(D, elem, aligned) == vecs


# -------------------------------------------------------------- C's sums
def _fma32(a, b, c):
    """fmaf in float32: the product of two float32 values is exact in
    float64; one rounding of the sum (double rounding cannot arise here
    except in ties, far below the tolerances these tests hold)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _emulated_ln_fwd(x, w, b, elem_bytes, eps=1e-5):
    """Rows as csrc/layernorm.cu normalises them: lane l's fp32 sums (on
    the vector path each of its 16-byte vectors l, l + 32, ... summed in
    order, then those sums in order; on the scalar path its columns l,
    l + 32, ... in order), then the xor tree over the 32 lanes, which
    leaves every lane the same bits."""
    R, D = x.shape
    vecs = fwd_vecs(D, elem_bytes)
    per = 16 // elem_bytes
    if vecs:      # lane -> its vectors -> their columns
        groups = [[[(lane + 32 * v) * per + e for e in range(per)]
                   for v in range(vecs)] for lane in range(32)]
    else:         # one group a lane: its columns
        groups = [[list(range(lane, D, 32))] for lane in range(32)]
    assert sorted(c for lane in groups for g in lane for c in g) \
        == list(range(D))
    lanes = np.arange(32)

    def warp_sum(terms_of, first):
        part = np.zeros((R, 32), np.float32)
        for lane in range(32):
            sums = []
            for cols in groups[lane]:
                acc = first(cols[0])
                for c in cols[1:]:
                    acc = terms_of(acc, c)
                sums.append(acc)
            acc = sums[0]
            for t in sums[1:]:
                acc = acc + t
            part[:, lane] = acc
        for o in (16, 8, 4, 2, 1):
            part = part + part[:, lanes ^ o]
        assert (part == part[:, :1]).all()
        return part[:, 0]
    mean = warp_sum(lambda acc, c: acc + x[:, c],
                    lambda c: x[:, c].copy()) / np.float32(D)
    d = x - mean[:, None]

    def square(acc, c):
        return _fma32(d[:, c], d[:, c], acc)
    var = warp_sum(square, lambda c: square(np.zeros(R, np.float32), c)) \
        / np.float32(D)
    rstd = (1.0 / np.sqrt(var.astype(np.float64) + eps)).astype(np.float32)
    return _fma32(d * rstd[:, None], w[None, :], b[None, :])


@pytest.mark.parametrize("R,D,dtype", [
    (6, 768, torch.bfloat16), (5, 512, torch.bfloat16),
    (4, 768, torch.float32), (3, 1000, torch.bfloat16),
    (3, 100, torch.float16)])
def test_fwd_emulation_matches_plain_and_jax(R, D, dtype):
    """Vector path (bf16 768 / 512, fp32 768) and scalar path (1000, 100):
    the emulation's fp32 output within 1e-5 of the plain version's and of
    the Pallas forward's (interpret mode) on the same fp32 inputs."""
    g = np.random.default_rng(R * D)
    x = torch.from_numpy((g.standard_normal((R, D)) * 3 + 1.5).astype(
        np.float32)).to(dtype).float()
    w = (g.standard_normal(D) * 0.1 + 1).astype(np.float32)
    b = g.standard_normal(D).astype(np.float32)
    out = _emulated_ln_fwd(x.numpy(), w, b, torch.tensor([], dtype=dtype)
                           .element_size())
    ref = layer_norm_plain(x, torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(out, ref.numpy(), rtol=1e-5, atol=1e-5)
    jref = _ln_fwd_call(jnp.asarray(x.numpy()), jnp.asarray(w),
                        jnp.asarray(b), layernorm_triton.EPS, True)
    np.testing.assert_allclose(out, np.asarray(jref), rtol=1e-5, atol=1e-5)


# -------------------------------------------------------------- D's plan
@pytest.mark.parametrize("R", [1, 7, 768, 4096, 38400, 76800])
@pytest.mark.parametrize("D", [512, 768])
def test_bwd_plan_covers_every_row_once(R, D):
    plan = bwd_launch_plan(R, D, N_SM)
    assert 1 <= plan.programs <= N_SM * max(1, _BWD_SM_WARPS
                                           // plan.num_warps)
    assert plan.rows_per_program % plan.rows == 0
    assert plan.block_d >= D and plan.block_d & (plan.block_d - 1) == 0
    seen = np.zeros(R, np.int64)
    for p in range(plan.programs):
        lo = p * plan.rows_per_program
        hi = min(R, lo + plan.rows_per_program)
        assert lo < hi                     # no idle program
        seen[lo:hi] += 1
    assert (seen == 1).all()
    assert (plan.groups - 1) * plan.group < plan.programs \
        <= plan.groups * plan.group


# -------------------------------------------------------------- D's sums
def _emulated_bwd(x, w, dy, plan):
    """D's arithmetic on the CPU: dx as the plain version computes it, and
    dgamma/dbeta as the kernel orders its fp32 sums (each program's rows,
    then each group's programs in order, then the groups in order)."""
    D = x.shape[-1]
    xf = x.float().reshape(-1, D)
    dyf = dy.float().reshape(-1, D)
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True)
                       + layernorm_triton.EPS)
    xhat = xc * rstd
    dx, _, _ = layer_norm_bwd_plain(x, w, dy)
    terms = (dyf * xhat, dyf)
    R = xf.shape[0]
    out = []
    for t in terms:
        parts = [t[p * plan.rows_per_program:
                   min(R, (p + 1) * plan.rows_per_program)].sum(0)
                 for p in range(plan.programs)]
        groups = []
        for g in range(plan.groups):
            acc = torch.zeros(D)
            for part in parts[g * plan.group:(g + 1) * plan.group]:
                acc = acc + part
            groups.append(acc)
        acc = torch.zeros(D)
        for part in groups:
            acc = acc + part
        out.append(acc)
    return dx, out[0], out[1], [t.abs().sum(0) for t in terms]


def _inputs(R, D, seed, dtype=torch.bfloat16):
    g = np.random.default_rng(seed)
    x = torch.from_numpy((g.standard_normal((R, D)) * 3 + 1).astype(
        np.float32)).to(dtype)
    w = torch.from_numpy((g.standard_normal(D) * 0.1 + 1).astype(np.float32))
    dy = torch.from_numpy(g.standard_normal((R, D)).astype(np.float32)).to(
        dtype)
    return x, w, dy


@pytest.mark.parametrize("R,D", [(768, 768), (4096, 512)])
def test_bwd_sums_in_plan_order_match_plain(R, D):
    x, w, dy = _inputs(R, D, seed=R)
    plan = bwd_launch_plan(R, D, N_SM, x.element_size())
    assert plan.groups > 1
    _, dw, db, abs_terms = _emulated_bwd(x, w, dy, plan)
    _, rw, rb = layer_norm_bwd_plain(x, w, dy)
    for out, ref, terms in ((dw, rw, abs_terms[0]), (db, rb, abs_terms[1])):
        assert bool(((out - ref).abs() <= SUM_RTOL * terms + 1e-6).all())


def test_bwd_emulation_matches_jax_kernel():
    """At a shape whose plan has two ticket groups, against the Pallas
    backward in interpret mode, fp32 in and out."""
    R, D = 300, 64
    x, w, dy = _inputs(R, D, seed=3, dtype=torch.float32)
    plan = bwd_launch_plan(R, D, N_SM, x.element_size())
    assert plan.groups == 2
    dx, dw, db, abs_terms = _emulated_bwd(x, w, dy, plan)
    jdx, jdw, jdb = _ln_bwd_call(jnp.asarray(x.numpy()), jnp.asarray(
        w.numpy()), jnp.asarray(dy.numpy()), layernorm_triton.EPS, True)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-5)
    for out, ref, terms in ((dw, jdw, abs_terms[0]), (db, jdb, abs_terms[1])):
        err = np.abs(out.numpy() - np.asarray(ref))
        assert (err <= SUM_RTOL * terms.numpy() + 1e-6).all()


# ---------------------------------------------------- E's member-mask Lloyd
def _ordered(f):
    """The kernel's `ordered`: fp32 -> int32 of the same order, -0 as +0."""
    f = np.where(f == 0, np.float32(0), f).astype(np.float32)
    b = f.view(np.int32)
    return np.where(b >= 0, b, b ^ np.int32(0x7fffffff))


def _emulated_kmedoids(D, l2, K, iter_limit=100, id_sort=True):
    """One segment as csrc/kmedoids.cu computes it."""
    N = D.shape[0]
    C = -(-N // 32)
    idx = int(np.argmax(l2))               # first index of the largest
    meds = [idx]
    md = _ordered(D[idx])
    for _ in range(1, K):
        idx = int(np.flatnonzero(md == md.max())[0])
        meds.append(idx)
        md = np.minimum(md, _ordered(D[idx]))
    meds = np.array(meds)

    def nearest(meds):
        return np.array([int(np.argmin(D[meds, n])) for n in range(N)])

    steps = 0
    while steps < iter_limit:
        assign = nearest(meds)
        members = np.zeros((K, C), np.uint64)
        for c in range(C):
            lanes = range(min(32, N - 32 * c))
            for lane in lanes:
                a = assign[32 * c + lane]
                peers = sum(1 << q for q in lanes
                            if assign[32 * c + q] == a)
                if lane == min(q for q in lanes if peers >> q & 1):
                    members[a, c] = peers          # the group's leader

        def member_ids(k):
            return [32 * c + j for c in range(C) for j in range(32)
                    if int(members[k, c]) >> j & 1]
        s = np.zeros(N, np.float32)
        for n in range(N):
            acc = np.float32(0)
            for m in member_ids(assign[n]):
                acc = np.float32(acc + D[n, m])
            s[n] = acc
        new = meds.copy()
        for k in range(K):
            best, bn = np.float32(np.inf), -1
            for m in member_ids(k):
                if s[m] < best:
                    best, bn = s[m], m
            new[k] = bn if bn >= 0 else 0
        steps += 1
        changed = not np.array_equal(new, meds)
        meds = new
        if not changed:
            break
    if id_sort:
        meds = np.sort(meds, kind="stable")
    return nearest(meds), meds, steps


def _emulated_global_kmedoids(D, l2, K, iter_limit=100, id_sort=True,
                              seed=0):
    """One segment as csrc/kmedoids.cu's global variant computes it: KKZ
    that keeps each point's nearest chosen medoid, a Lloyd assignment that
    reads only the medoids that moved (a full scan for a point whose own
    medoid moved), sums and argmins for the clusters whose member set
    changed only, and the last assignment by rank where no medoid may tie.
    The kernel lists the moved medoids in the order of its atomics: here
    in a random order (`seed`), which must not change a bit."""
    rng = np.random.default_rng(seed)
    N = D.shape[0]
    key = _ordered(D)
    idx = int(np.argmax(_ordered(l2)))
    meds = [idx]
    best, assign = key[idx].copy(), np.zeros(N, np.int64)
    tie = np.zeros(N, bool)
    for k in range(1, K):
        idx = int(np.flatnonzero(best == best.max())[0])
        meds.append(idx)
        d = key[idx]
        lt, eq = d < best, d == best
        best = np.where(lt, d, best)
        assign = np.where(lt, k, assign)
        tie = np.where(lt, False, tie | eq)
    meds = np.array(meds)

    def take(d, k, bv, bk, t):
        if d < bv:
            return d, k, False
        if d == bv:
            return bv, min(k, bk), True
        return bv, bk, t

    def scan(order, n):
        bv, bk, t = np.iinfo(np.int32).max, 0, False
        for k, m in enumerate(order):
            bv, bk, t = take(key[m, n], k, bv, bk, t)
        return bv, bk, t

    def reassign(moved):
        flags = np.zeros(K, bool)
        flags[moved] = True
        changed = set()
        for n in range(N):
            bv, bk, t = best[n], assign[n], tie[n]
            if flags[bk]:
                bv, bk, t = scan(meds, n)
            else:
                for k in moved:
                    bv, bk, t = take(key[meds[k], n], k, bv, bk, t)
            if bk != assign[n]:
                changed |= {assign[n], bk}
            best[n], assign[n], tie[n] = bv, bk, t
        return changed

    dirty = np.ones(K, bool)
    sums = np.zeros(N, np.float32)
    moved, steps = [], 0
    while steps < iter_limit:
        for k in reassign(moved) if moved else ():
            dirty[k] = True
        members = [np.flatnonzero(assign == k) for k in range(K)]
        for n in range(N):
            if dirty[assign[n]]:
                acc = np.float32(0)
                for m in members[assign[n]]:
                    acc = np.float32(acc + D[n, m])
                sums[n] = acc
        moved = []
        for k in np.flatnonzero(dirty):
            mem = members[k]
            nm = int(mem[np.argmin(sums[mem])]) if len(mem) else 0
            if nm != meds[k]:
                meds[k] = nm
                moved.append(k)
        dirty[:] = False
        moved = list(rng.permutation(moved))
        steps += 1
        if not moved:
            break
    if moved:
        reassign(moved)
    if not id_sort:
        return assign.copy(), meds, steps
    order = np.argsort(meds, kind="stable")
    rank_of = np.empty(K, np.int64)
    rank_of[order] = np.arange(K)
    sorted_meds = meds[order]
    out = np.array([scan(sorted_meds, n)[1] if tie[n] else rank_of[assign[n]]
                    for n in range(N)])
    return out, sorted_meds, steps


def _blobs(seed, B, N, Dim, centres=8):
    g = np.random.default_rng(seed)
    out = np.zeros((B, N, Dim), np.float32)
    for b in range(B):
        c = g.standard_normal((centres, Dim)).astype(np.float32) * 5.0
        out[b] = c[g.integers(0, centres, N)] \
            + g.standard_normal((N, Dim)) * 0.05
    return out


def _check_three(X, D, l2, K):
    """Emulation, port plain version and JAX Pallas kernel agree."""
    a_ref, m_ref = kmedoids_on_distances(*(torch.from_numpy(np.array(t))
                                           for t in (X, D, l2)), K,
                                         iter_limit=100)
    a_jax, m_jax = kmedoids_from_distances(jnp.asarray(D), jnp.asarray(l2), K,
                                           iter_limit=100, interpret=True)
    for b in range(D.shape[0]):
        a, m, steps = _emulated_kmedoids(D[b], l2[b], K)
        assert 1 <= steps <= 100
        np.testing.assert_array_equal(m, m_ref[b].numpy())
        np.testing.assert_array_equal(a, a_ref[b].numpy())
        np.testing.assert_array_equal(m, np.asarray(m_jax)[b])
        np.testing.assert_array_equal(a, np.asarray(a_jax)[b])


@pytest.mark.parametrize("N,K", [(20, 4), (98, 49), (392, 160)])
def test_member_mask_lloyd_matches_plain_and_jax(N, K):
    """Both kernel variants run this one algorithm (the global variant at
    ViT-B/16's N = 392, K = 160)."""
    x = _blobs(N + K, 2, N, 16, centres=8 if N < 256 else 60)
    D = np.asarray(jax_pairwise(jnp.asarray(x), jnp.asarray(x),
                                all_negative=True, self_nearest=True))
    l2 = np.linalg.norm(x, axis=-1).astype(np.float32)
    _check_three(x, D, l2, K)


@pytest.mark.parametrize("K", [5, 16])
def test_member_mask_lloyd_first_index_wins_exact_ties(K):
    """K groups of 4 consecutive integers on a line, far apart: every
    distance and every candidate's sum is exact in fp32, and the two middle
    points of each group tie exactly, so all three must take the one with
    the lower index (the second segment shuffles the points' order)."""
    N = 4 * K
    p = (50 * np.arange(K)[:, None] + np.arange(4)).reshape(-1)
    p = np.stack([p, np.random.default_rng(K).permutation(p)]).astype(
        np.float32)                                            # [2, N]
    dis = np.abs(p[:, :, None] - p[:, None, :])
    D = (dis - dis.max(axis=(1, 2), keepdims=True) - 1.0
         - np.eye(N, dtype=np.float32)).astype(np.float32)
    l2 = np.abs(p).astype(np.float32)
    for b in range(2):
        a, m, _ = _emulated_kmedoids(D[b], l2[b], K)
        assert (np.bincount(a, minlength=K) == 4).all()
        for k in range(K):                 # the lower-index middle point
            group = np.flatnonzero(a == k)
            middle = group[np.argsort(p[b, group])[1:3]]
            assert m[k] == middle.min()
    _check_three(p[..., None].copy(), D, l2, K)


def _check_global_design(X, D, l2, K, iter_limit=100, id_sort=True):
    """The global variant's emulation gives the member-mask emulation's
    ids, assignment and steps, segment by segment."""
    for b in range(D.shape[0]):
        a, m, steps = _emulated_kmedoids(D[b], l2[b], K, iter_limit, id_sort)
        ga, gm, gsteps = _emulated_global_kmedoids(D[b], l2[b], K, iter_limit,
                                                   id_sort, seed=b)
        np.testing.assert_array_equal(gm, m)
        np.testing.assert_array_equal(ga, a)
        assert gsteps == steps


@pytest.mark.parametrize("N,K", [(98, 49), (392, 160)])
def test_global_design_matches_member_mask_plain_and_jax(N, K):
    """At ViT-B/16's N = 392, K = 160 (and a shared-variant size): equal to
    the member-mask emulation in ids, assignment and steps, and through it
    to the plain version and the Pallas kernel."""
    x = _blobs(N + K, 2, N, 16, centres=8 if N < 256 else 60)
    D = np.asarray(jax_pairwise(jnp.asarray(x), jnp.asarray(x),
                                all_negative=True, self_nearest=True))
    l2 = np.linalg.norm(x, axis=-1).astype(np.float32)
    _check_global_design(x, D, l2, K)
    _check_three(x, D, l2, K)


@pytest.mark.parametrize("K", [5, 16])
def test_global_design_first_index_wins_exact_ties(K):
    """The tie-heavy line of `test_member_mask_lloyd_first_index_wins_exact_
    ties`: every KKZ row and every medoid row ties for some points, so the
    last assignment must scan the sorted medoids there."""
    N = 4 * K
    p = (50 * np.arange(K)[:, None] + np.arange(4)).reshape(-1)
    p = np.stack([p, np.random.default_rng(K).permutation(p)]).astype(
        np.float32)
    dis = np.abs(p[:, :, None] - p[:, None, :])
    D = (dis - dis.max(axis=(1, 2), keepdims=True) - 1.0
         - np.eye(N, dtype=np.float32)).astype(np.float32)
    l2 = np.abs(p).astype(np.float32)
    _check_global_design(p[..., None], D, l2, K)
    _check_three(p[..., None].copy(), D, l2, K)


@pytest.mark.parametrize("G", [4, 9])
def test_global_design_points_equidistant_from_two_medoids(G):
    """G runs of 3 consecutive integers on a line, far apart, K = 2 G, the
    points' order shuffled per segment: KKZ takes both ends of each run,
    so the middle point lies exactly as near to two medoids, and a
    medoid that moves can tie another one.  The first index must win in
    the order of the medoid list and, after the id sort, in the sorted
    order."""
    N, K = 3 * G, 2 * G
    p = (50 * np.arange(G)[:, None] + np.arange(3)).reshape(-1)
    g = np.random.default_rng(G)
    p = np.stack([g.permutation(p) for _ in range(6)]).astype(np.float32)
    dis = np.abs(p[:, :, None] - p[:, None, :])
    D = (dis - dis.max(axis=(1, 2), keepdims=True) - 1.0
         - np.eye(N, dtype=np.float32)).astype(np.float32)
    l2 = np.abs(p).astype(np.float32)
    for id_sort in (True, False):
        _check_global_design(p[..., None], D, l2, K, id_sort=id_sort)
    _check_three(p[..., None].copy(), D, l2, K)


@pytest.mark.parametrize("K", [3, 6])
def test_global_design_repeated_points(K):
    """Segments of 14 integers drawn from 0-11 on a line, so points repeat
    and distances tie everywhere: a medoid that moves can land exactly as
    near a point as its current one, with a lower index, which must then
    win."""
    p = np.random.default_rng(K).integers(0, 12, (48, 14)).astype(
        np.float32)
    dis = np.abs(p[:, :, None] - p[:, None, :])
    D = (dis - dis.max(axis=(1, 2), keepdims=True) - 1.0
         - np.eye(14, dtype=np.float32)).astype(np.float32)
    l2 = np.abs(p).astype(np.float32)
    _check_global_design(p[..., None], D, l2, K)
    _check_three(p[..., None].copy(), D, l2, K)


@pytest.mark.parametrize("iter_limit,id_sort", [(0, True), (1, True),
                                                (2, False), (100, False)])
def test_global_design_iteration_limits_and_no_sort(iter_limit, id_sort):
    """Stopped before the fixed point (the assignment brought up to date
    after the last update) and without the id sort (each point's first
    index in the unsorted order)."""
    N, K = 300, 120
    x = _blobs(7, 2, N, 16, centres=40)
    D = np.asarray(jax_pairwise(jnp.asarray(x), jnp.asarray(x),
                                all_negative=True, self_nearest=True))
    l2 = np.linalg.norm(x, axis=-1).astype(np.float32)
    _check_global_design(x, D, l2, K, iter_limit, id_sort)


@pytest.mark.parametrize("N,variant", [
    (1, kmedoids_cuda.SHARED), (98, kmedoids_cuda.SHARED),
    (147, kmedoids_cuda.SHARED), (235, kmedoids_cuda.SHARED),
    (236, kmedoids_cuda.GLOBAL), (392, kmedoids_cuda.GLOBAL),
    (512, kmedoids_cuda.GLOBAL), (513, kmedoids_cuda.CLUSTER),
    (588, kmedoids_cuda.CLUSTER), (784, kmedoids_cuda.CLUSTER),
    (1024, kmedoids_cuda.CLUSTER), (2352, kmedoids_cuda.CLUSTER),
    (3136, kmedoids_cuda.CLUSTER), (3137, kmedoids_cuda.CLUSTER),
    (3920, kmedoids_cuda.CLUSTER), (18_000, kmedoids_cuda.CLUSTER),
    (26_463, kmedoids_cuda.CLUSTER), (26_464, kmedoids_cuda.SCRATCH),
    (262_143, kmedoids_cuda.SCRATCH)])
def test_kmedoids_variant_from_n(N, variant):
    """Past the global variant, the cluster variant wherever a cluster of
    at most 16 CTAs holds the segment at K = 392 (up to N = 26 463: its
    member lists, N words, are the most of it), the scratch one past
    that."""
    assert kmedoids_cuda.choose_variant(N) == variant


@pytest.mark.parametrize("N", [0, 262_144])
def test_kmedoids_variant_raises_past_its_range(N):
    """Past MAX_N (262 143) the member masks of K = N, K ceil(N / 32)
    words, pass what 32-bit indices address."""
    with pytest.raises(ValueError, match="262143"):
        kmedoids_cuda.choose_variant(N)


@pytest.mark.parametrize("N,K,variant", [
    (98, 98, kmedoids_cuda.SHARED), (512, 512, kmedoids_cuda.GLOBAL),
    (784, 784, kmedoids_cuda.CLUSTER),
    (2352, 392, kmedoids_cuda.CLUSTER),
    (2352, 1000, kmedoids_cuda.CLUSTER),
    (2352, 2352, kmedoids_cuda.CLUSTER),  # 16 CTAs hold every K at 2352
    (3136, 392, kmedoids_cuda.CLUSTER), (3137, 160, kmedoids_cuda.CLUSTER),
    (3281, 3281, kmedoids_cuda.CLUSTER),
    (3282, 3282, kmedoids_cuda.SCRATCH),  # blocks' minima and K lists
    (3920, 160, kmedoids_cuda.CLUSTER), (3920, 392, kmedoids_cuda.CLUSTER),
    (3920, 3920, kmedoids_cuda.SCRATCH),
    (35_363, 160, kmedoids_cuda.CLUSTER),
    (35_364, 160, kmedoids_cuda.SCRATCH)])
def test_kmedoids_variant_from_n_and_k(N, K, variant):
    """Past the global variant, K decides too: CLUSTER where a cluster of
    at most 16 CTAs holds the segment (`cluster_fits`), SCRATCH else."""
    assert kmedoids_cuda.choose_variant(N, K) == variant
    if N > kmedoids_cuda.GLOBAL_MAX_N:
        fits = any(kmedoids_cuda.cluster_fits(N, K, cs)
                   for cs in kmedoids_cuda.CLUSTER_SIZES)
        assert fits == (variant == kmedoids_cuda.CLUSTER)


def _cluster_smem(N, K, cs):
    """csrc/kmedoids.cu `cluster_smem_bytes`, counted array by array: P =
    32 ceil(ceil(N / 32) / cs) own points at most."""
    chunks = -(-(-(-N // 32)) // cs)
    P = 32 * chunks
    arrays = {"blocks' minima": 8 * (-(-N // 32) + K), "best": 4 * P, "assign": 4 * P, "plist": 4 * P,
              "members": 4 * K * chunks, "lists": 4 * N,
              "meds, moved, counts, sizes, below, offsets": 6 * 4 * K,
              "block starts": 4 * (K + 1),
              "tie, moved flags": (P + K + 3) // 4 * 4}
    return sum(arrays.values())


@pytest.mark.parametrize("N,K,cs,nbytes", [
    (3920, 160, 8, 39_484),       # a 20-frame segment, 8 CTAs
    (3920, 392, 8, 62_916),
    (3920, 160, 4, 55_324),
    (2352, 2352, 16, 146_148),    # K = N at a 12-frame clip
    (2352, 160, 16, 21_204),
    (784, 160, 1, 35_660),        # one CTA a segment
    (588, 160, 1, 28_492),
    (18_000, 160, 16, 120_444)])
def test_cluster_variant_layout(N, K, cs, nbytes):
    """The cluster variant's shared memory a CTA (`cluster_smem_bytes`,
    csrc/kmedoids.cu's own; tests/test_torch_gpu.py holds it against the
    source's): the own points' state, the own chunks' member masks, every
    cluster's member lists and the K lists; at 8 CTAs the masks of a
    20-frame segment's 392 clusters are 25 KB a CTA."""
    assert kmedoids_cuda.cluster_smem_bytes(N, K, cs) == _cluster_smem(
        N, K, cs) == nbytes
    assert kmedoids_cuda.cluster_fits(N, K, cs)
    assert 4 * 392 * -(-123 // 8) == 25_088


def test_cluster_variant_fits_up_to_its_limit():
    """A cluster holds a segment where each CTA owns a chunk and its shared
    memory with the static 2304 bytes fits the 227 KB a CTA may opt into;
    N = K = 3920 fits no cluster (the scratch variant's), one CTA cannot
    hold a 20-frame segment at K = 392, and 17 CTAs are never taken."""
    limit = _build.MAX_SMEM_BYTES - kmedoids_cuda.CLUSTER_STATIC_SMEM
    for N, K, cs in ((3920, 392, 2), (2352, 2352, 16), (26_463, 392, 16)):
        assert kmedoids_cuda.cluster_smem_bytes(N, K, cs) <= limit
    assert not kmedoids_cuda.cluster_fits(3920, 392, 1)
    assert not any(kmedoids_cuda.cluster_fits(3920, 3920, cs)
                   for cs in kmedoids_cuda.CLUSTER_SIZES)
    assert not kmedoids_cuda.cluster_fits(600, 6, 32)   # 19 chunks
    assert not kmedoids_cuda.cluster_fits(513, 160, 32)
    assert kmedoids_cuda.cluster_fits(513, 160, 16)
    assert max(kmedoids_cuda.CLUSTER_SIZES) == 16


# clusters of each size the H100 (NVIDIA H100 80GB HBM3) holds at once,
# `cudaOccupancyMaxActiveClusters` as `cc_kmedoids_cluster_max_active` read
# it: it packs clusters into the card's groups of SMs, so 16 CTAs of one
# an SM fit 7 times, not 132 / 16
H100_RESIDENT = {
    (3920, 160): {1: 132, 2: 132, 4: 92, 8: 62, 16: 28},
    (3920, 392): {2: 66, 4: 62, 8: 45, 16: 28},
    (2352, 160): {1: 264, 2: 264, 4: 124, 8: 62, 16: 28},
    (2352, 2352): {8: 15, 16: 7},
    (784, 160): {1: 528, 2: 264, 4: 124, 8: 62, 16: 28},
}


@pytest.mark.parametrize("B,N,K,cs", [
    (48, 3920, 160, 8),           # the 20-frame training step
    (96, 3920, 160, 2),           # the 20-frame encode batch: 4 fit 92
    (48, 3920, 392, 4),
    (8, 2352, 160, 16),           # 8 whole 12-frame clips
    (8, 2352, 2352, 8),           # K = N: 16 CTAs of one an SM fit 7 times
    (384, 784, 160, 1),           # 4-frame segments: the step fills the card
    (96, 784, 160, 4),
    (6, 784, 160, 16),
    (1000, 784, 160, 1)])         # past one wave: the most CTAs resident
def test_cluster_size_from_the_cards_clusters(B, N, K, cs):
    """CTAs a segment: the largest size whose clusters all stay resident
    at once on the card, else the size with the most CTAs resident."""
    assert kmedoids_cuda.cluster_size(B, N, K, H100_RESIDENT[N, K]) == cs


@pytest.mark.parametrize("B,N,K,cs", [
    (28, 3920, 160, 16), (63, 3920, 160, 4),
    (768, 3920, 160, 8),          # past one wave at every size
    (1, 3920, 392, 16), (46, 3920, 392, 4),
    (67, 3920, 392, 16),          # past one wave: 16 x 28 CTAs resident
    (1, 2352, 2352, 16), (16, 2352, 2352, 8),
    (264, 2352, 160, 2),
    (529, 784, 160, 1)])          # 1 and 2 tie at 528 CTAs: the smaller
def test_cluster_size_at_the_edges_of_the_cards_clusters(B, N, K, cs):
    """Either side of each size's resident clusters on the H100: one
    segment more than a size holds at once takes the next smaller size,
    and past one wave the most CTAs resident decide."""
    assert kmedoids_cuda.cluster_size(B, N, K, H100_RESIDENT[N, K]) == cs


def test_cluster_size_none_where_no_cluster_holds_it():
    """0 where no size holds the segment or the card holds none of those
    that do; a size the card holds no cluster of is passed over."""
    assert kmedoids_cuda.cluster_size(1, 3920, 3920, {}) == 0
    assert kmedoids_cuda.cluster_size(8, 2352, 2352, {8: 0, 16: 0}) == 0
    assert kmedoids_cuda.cluster_size(
        48, 3920, 160, {**H100_RESIDENT[3920, 160], 8: 0}) == 4


class _FakeClusterLib:
    """The two entries of the kernel library that `resident_clusters`
    calls, answering `answers[cs]` for a cluster of cs CTAs."""

    def __init__(self, answers):
        lib = self

        def max_active(N, K, cs):
            lib.asked.append(cs)
            return answers[cs]

        def error_string(err):
            return b"invalid value" if err == 1 else b"other"

        self.asked = []
        self.cc_kmedoids_cluster_max_active = _Entry(max_active)
        self.cc_error_string = _Entry(error_string)


class _Entry:
    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)


@pytest.mark.parametrize("answers,raises", [
    ({1: 132, 2: 132, 4: 92, 8: 62, 16: 28}, False),
    ({1: 132, 2: 132, 4: 92, 8: 62, 16: 0}, False),   # a real zero
    ({1: 132, 2: 132, 4: 92, 8: 62, 16: -1}, True)])  # a failed query
def test_resident_clusters_raises_where_the_query_fails(monkeypatch, answers,
                                                        raises):
    """The card's counts are kept as they come, a zero included; an error
    from `cudaOccupancyMaxActiveClusters` (a negative answer) raises with
    CUDA's name for it and never routes to a smaller cluster."""
    lib = _FakeClusterLib(answers)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda index: contextlib.nullcontext())
    monkeypatch.setattr(kmedoids_cuda, "_RESIDENT", {})
    dev = torch.device("cuda", 0)
    if raises:
        with pytest.raises(RuntimeError, match=r"16 CTAs.*CUDA error 1 "
                                               r"\(invalid value\)"):
            kmedoids_cuda.resident_clusters(dev, 3920, 160)
        assert kmedoids_cuda._RESIDENT == {}
        return
    assert kmedoids_cuda.resident_clusters(dev, 3920, 160) == answers
    assert kmedoids_cuda.resident_clusters(dev, 3920, 160) == answers
    assert lib.asked == [1, 2, 4, 8, 16]            # asked once, then cached
    assert kmedoids_cuda.cluster_size(
        48, 3920, 160, kmedoids_cuda.resident_clusters(dev, 3920, 160)) == 8


def test_scratch_variant_layout():
    """The scratch variant (csrc/kmedoids.cu `scratch_state_bytes`,
    `scratch_words`): its per-point and per-cluster state, 13 N + 10 K
    bytes, stays in shared memory up to the limit beside its static 256
    bytes, its member masks, K ceil(N / 32) words a segment, go to the
    device-memory scratch (with the state where shared memory cannot hold
    it), in multiples of 16 bytes."""
    def state(N, K):
        return (3 * N + 2 * K) * 4 + (N + 2 * K + 3) // 4 * 4

    def words(N, K):
        w = K * -(-N // 32) + (0 if state(N, K) <= _build.MAX_SMEM_BYTES
                               - 256 else state(N, K) // 4)
        return (w + 3) // 4 * 4
    assert state(3920, 160) == 52_560 and words(3920, 160) == 160 * 123
    assert words(2352, 2352) == 2352 * 74           # 691 KB, state shared
    assert state(17_000, 17_000) > _build.MAX_SMEM_BYTES   # state to scratch
    assert words(17_000, 17_000) == (17_000 * 532 + state(17_000, 17_000)
                                     // 4 + 3) // 4 * 4


def test_shared_variant_fits_at_any_k():
    """SHARED_MAX_N is the largest N whose shared-memory layout
    (csrc/kmedoids.cu `smem_bytes`: D, sums, assignment, two medoid lists,
    member masks and 16 words) fits the 227 KB a CTA may opt into at K = N;
    one more point does not."""
    def smem(N, K):
        return (N * N + 2 * N + 2 * K + K * -(-N // 32) + 16) * 4
    n = kmedoids_cuda.SHARED_MAX_N
    assert smem(n, n) <= _build.MAX_SMEM_BYTES < smem(n + 1, n + 1)


def test_ordered_keys_keep_the_float_order():
    v = np.array([-np.inf, -3e38, -2.5, -1.0, -1e-30, -0.0, 0.0, 1e-30,
                  1.0, 3e38, np.inf], np.float32)
    k = _ordered(v)
    assert (np.diff(k.astype(np.int64)) >= 0).all()
    assert k[5] == k[6]                     # -0 and +0 are equal floats
    assert (np.diff(k.astype(np.int64))[np.arange(len(v) - 1) != 5] > 0).all()


# ------------------------------------------------------------ the bounds
def test_kmedoids_bound_counts_medoid_rows_and_member_sums():
    """E's bytes: the K medoid rows of D, each cluster's member entries
    beyond its medoid's row in a segment that took a Lloyd step, l2 and
    the int32 outputs; at a memory rate of 1 KB/ms the bound in ms is the
    byte count over 1000."""
    assign = torch.tensor([[0, 0, 0, 1, 1, 1], [0, 1, 1, 1, 1, 1]])
    steps = torch.tensor([1, 0], dtype=torch.int32)
    B, N, K = 2, 6, 2
    members = (3 * 2 + 3 * 2) + 0         # segment 1 took no Lloyd step
    nbytes = 4 * (B * K * N + members + B * N + B * N + B * K + B)
    ms, by = kernel_timing.kmedoids_bound(K, assign, steps, (1e6, 1.0, 1e30))
    assert by == "bytes" and ms == pytest.approx(nbytes / 1e3)


def test_kmedoids_bound_at_vitb16_training_reads_medoid_rows_not_all_of_d():
    """At [768, 392, 392], K = 160, the bound is about 0.058 ms (the K rows,
    251 KB a segment), not the 0.142 ms that reading all of D would take."""
    B, N, K = 768, 392, 160
    g = np.random.default_rng(0)
    assign = torch.from_numpy(g.integers(0, K, (B, N)))
    steps = torch.from_numpy(g.integers(3, 8, B)).int()
    ms, by = kernel_timing.kmedoids_bound(
        K, assign, steps, kernel_timing.card_peaks("NVIDIA H100 80GB HBM3"))
    assert by == "bytes"
    assert B * K * N * 4 / 3.35e12 * 1e3 < ms < 0.060
    assert ms < 0.5 * B * N * N * 4 / 3.35e12 * 1e3


@pytest.mark.parametrize("assign,K,sectors", [
    ([0] * 8 + [1] * 8, 2, 2 * (8 - 1)),      # each row's members: 1 sector
    ([n % 2 for n in range(16)], 2, 2 * 2 * (8 - 1)),   # 2 sectors a row
    ([0] * 12, 1, 12 * 2 - 2),                # rows of 12 entries: unaligned
])
def test_kmedoids_sector_bound_counts_touched_sectors(assign, K, sectors):
    """E's second bound: each member row's distinct 32-byte sectors over
    its cluster's member columns (row n of N = 12 entries starts at element
    12 n, at 0 or 4 within a sector), less one member row a cluster; the
    medoid rows, l2 and the outputs as bytes.  Where members are
    contiguous and rows aligned (the first case) it is the 4-byte bound."""
    a = torch.tensor([assign])
    B, N = a.shape
    steps = torch.tensor([1], dtype=torch.int32)
    nbytes = 4 * (B * K * N + 2 * B * N + B * K + B) + 32 * sectors
    peaks = (1e6, 1.0, 1e30)
    ms, by = kernel_timing.kmedoids_sector_bound(K, a, steps, peaks)
    assert by == "bytes" and ms == pytest.approx(nbytes / 1e3)
    plain, _ = kernel_timing.kmedoids_bound(K, a, steps, peaks)
    assert (ms == pytest.approx(plain)) == (sectors == 14)
    # a segment that took no Lloyd step reads its medoid rows only
    ms0, _ = kernel_timing.kmedoids_sector_bound(
        K, a, torch.tensor([0], dtype=torch.int32), peaks)
    assert ms0 == pytest.approx((nbytes - 32 * sectors) / 1e3)


def test_kmedoids_sector_bound_at_least_the_byte_bound():
    """On scattered clusters (random assignment, [48, 3920], K = 160) each
    gathered entry moves its own sector: the sector bound is above the
    4-byte one, and at most 8 x its member part."""
    g = np.random.default_rng(0)
    a = torch.from_numpy(g.integers(0, 160, (48, 3920)))
    steps = torch.from_numpy(g.integers(3, 8, 48)).int()
    peaks = kernel_timing.card_peaks("NVIDIA H100 80GB HBM3")
    ms, _ = kernel_timing.kmedoids_sector_bound(160, a, steps, peaks)
    plain, _ = kernel_timing.kmedoids_bound(160, a, steps, peaks)
    rows = 4 * (48 * 160 * 3920 + 2 * 48 * 3920 + 48 * 160 + 48) \
        / peaks[0] * 1e3
    assert plain < ms <= rows + 8 * (plain - rows)


@pytest.mark.parametrize("R,D,dtype,elem", [(4800, 768, torch.bfloat16, 2),
                                            (768, 512, torch.float32, 4)])
def test_layernorm_bound_reads_x_and_writes_y_once(R, D, dtype, elem):
    x = torch.zeros((R, D), dtype=dtype)
    ms, by = kernel_timing.layernorm_bound(x, (1e6, 1.0, 1e30))
    assert by == "bytes"
    assert ms == pytest.approx((2 * R * D * elem + 2 * D * 4) / 1e3)


def test_layernorm_fwd_shapes_are_distinct():
    keys = [s[1:] for s in kernel_timing.LAYERNORM_FWD_SHAPES]
    assert len(set(keys)) == len(keys)
    assert {s[3] for s in kernel_timing.LAYERNORM_FWD_SHAPES} \
        == {torch.bfloat16, torch.float32}
