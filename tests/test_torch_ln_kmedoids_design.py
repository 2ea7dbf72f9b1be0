# coding=utf-8
"""The designs of the LayerNorm backward kernel (D) and the k-medoids
kernel (E), held on the CPU.

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
  (interpret mode) on the same distances.  Both kernel variants (D in
  shared memory, or read from device memory) run it; which one a segment
  size takes is a pure function of N.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from centerclip_tpu.ops.distances import pairwise_distance as jax_pairwise
from centerclip_tpu.ops.kmedoids_pallas import kmedoids_from_distances
from centerclip_tpu.ops.layernorm_pallas import _ln_bwd_call
from centerclip_tpu_torch.ops import _build, kmedoids_cuda, layernorm_triton
from centerclip_tpu_torch.ops.kmedoids import kmedoids_on_distances
from centerclip_tpu_torch.ops.layernorm_triton import (
    _BWD_SM_WARPS, bwd_launch_plan, layer_norm_bwd_plain)

# the H100's SM count
N_SM = 132
# chip_smoke.py's tolerance for fp32 sums over rows taken in another order
SUM_RTOL = 1e-5


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


@pytest.mark.parametrize("N,variant", [
    (1, kmedoids_cuda.SHARED), (98, kmedoids_cuda.SHARED),
    (147, kmedoids_cuda.SHARED), (235, kmedoids_cuda.SHARED),
    (236, kmedoids_cuda.GLOBAL), (392, kmedoids_cuda.GLOBAL),
    (512, kmedoids_cuda.GLOBAL)])
def test_kmedoids_variant_from_n(N, variant):
    assert kmedoids_cuda.choose_variant(N) == variant


@pytest.mark.parametrize("N", [0, 513, 1024])
def test_kmedoids_variant_raises_past_its_range(N):
    with pytest.raises(ValueError):
        kmedoids_cuda.choose_variant(N)


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
