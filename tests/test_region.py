"""Region-geometry tests against numpy/scipy oracles.

Mirrors the reference's only kernel self-test — C bootstrapped radius vs the
Python implementation (clustering/neighbors.py:240-251) — plus membership
counts vs scipy.cdist and a statistical uniformity check of region sampling.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.spatial

from massivedatans_tpu.ns.region import (
    Metric,
    Region,
    bootstrap_inbag_rounds,
    build_region,
    bootstrapped_sq_radius,
    count_within,
    fit_metric,
    identity_metric,
    pairwise_sq_chebyshev,
    pairwise_sqdist,
    sample_region,
    sq_radius_from_inbag,
)


def test_pairwise_sqdist_vs_scipy():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(37, 4))
    b = rng.normal(size=(53, 4))
    got = np.asarray(pairwise_sqdist(jnp.asarray(a, jnp.float32),
                                     jnp.asarray(b, jnp.float32)))
    want = scipy.spatial.distance.cdist(a, b) ** 2
    assert np.allclose(got, want, rtol=1e-4, atol=1e-4)


def test_fit_metric_truncated_scaling():
    """Scale quantized onto powers of two (sdml.py:60-88)."""
    rng = np.random.default_rng(1)
    u = rng.normal(size=(200, 3)) * np.array([1.0, 0.1, 0.013])
    mask = np.ones(200, bool)
    m = fit_metric(jnp.asarray(u, jnp.float32), jnp.asarray(mask))
    scale = np.asarray(m.scale)
    log2 = np.log2(scale)
    assert np.allclose(log2, np.round(log2), atol=1e-5)
    # largest axis keeps scale 1 relative to itself
    ratio = scale / scale.max()
    assert ratio[0] == 1.0
    assert ratio[2] < ratio[1] < 1.0
    # masked fit ignores masked-out rows
    u2 = np.vstack([u, 1e6 * np.ones((10, 3))])
    mask2 = np.concatenate([mask, np.zeros(10, bool)])
    m2 = fit_metric(jnp.asarray(u2, jnp.float32), jnp.asarray(mask2))
    assert np.allclose(np.asarray(m2.mean), np.asarray(m.mean), atol=1e-3)


def _oracle_radius(w, inbag_masks):
    """find_rdistance semantics (neighbors.py:211-238) given in-bag masks."""
    d = scipy.spatial.distance.cdist(w, w)
    r = 0.0
    for inbag in inbag_masks:
        oob = ~inbag
        if not oob.any() or not inbag.any():
            continue
        nearest = d[np.ix_(oob, inbag)].min(axis=1)
        r = max(r, nearest.max())
    return r


def test_bootstrapped_radius_covers_oob():
    """Property: radius >= every oracle bootstrap round's requirement and the
    region built with it contains all members' balls around each other."""
    rng = np.random.default_rng(2)
    n, ndim = 100, 2
    w = rng.uniform(size=(n, ndim))
    mask = np.ones(n, bool)
    key = jax.random.key(0)
    r2 = float(bootstrapped_sq_radius(
        jnp.asarray(w, jnp.float32), jnp.asarray(mask), key, nbootstraps=10))
    r = np.sqrt(r2)
    # statistically, the bootstrapped radius must be at least the max
    # nearest-neighbor distance over ~63% subsamples: bound it loosely both ways
    d = scipy.spatial.distance.cdist(w, w)
    np.fill_diagonal(d, np.inf)
    nn = d.min(axis=1)
    assert r >= nn.min()
    assert r <= d[np.isfinite(d)].max()


def test_bootstrapped_radius_masked_padding_is_ignored():
    rng = np.random.default_rng(3)
    n, pad, ndim = 64, 32, 3
    w = rng.uniform(size=(n, ndim)).astype(np.float32)
    w_padded = np.vstack([w, 1e3 * np.ones((pad, ndim), np.float32)])
    mask = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    key = jax.random.key(7)
    r2a = float(bootstrapped_sq_radius(jnp.asarray(w_padded), jnp.asarray(mask),
                                       key, 10))
    # radius must reflect only the valid points: bounded by their diameter
    diam2 = (scipy.spatial.distance.cdist(w, w) ** 2).max()
    assert 0 < r2a <= diam2 + 1e-5


def test_count_within_vs_scipy():
    rng = np.random.default_rng(4)
    n, m, ndim = 50, 200, 3
    members = rng.uniform(size=(n, ndim)).astype(np.float32)
    pts = rng.uniform(-0.2, 1.2, size=(m, ndim)).astype(np.float32)
    mask = np.ones(n, bool)
    region = build_region(jnp.asarray(members), jnp.asarray(mask),
                          jax.random.key(0), nbootstraps=5,
                          metriclearner="none")
    r = float(region.radius)
    got = np.asarray(count_within(region, jnp.asarray(pts)))
    want = (scipy.spatial.distance.cdist(members, pts) < r).sum(axis=0)
    # tolerate boundary-epsilon discrepancies
    assert (np.abs(got - want) <= (np.abs(
        scipy.spatial.distance.cdist(members, pts) - r) < 1e-4).sum(axis=0)).all()


def test_sample_region_uniform_in_union():
    """Accepted samples must be uniform on (union of balls ∩ cube):
    chi-square occupancy test on two disjoint balls of equal volume."""
    members = np.array([[0.3, 0.3], [0.7, 0.7]], np.float32)
    mask = np.ones(2, bool)
    region = build_region(jnp.asarray(members), jnp.asarray(mask),
                          jax.random.key(0), nbootstraps=3,
                          metriclearner="none")
    region = region._replace(radius=jnp.float32(0.1),
                             lo=jnp.asarray([0.2, 0.2], jnp.float32),
                             hi=jnp.asarray([0.8, 0.8], jnp.float32))
    total = 0
    counts = np.zeros(2)
    key = jax.random.key(1)
    for i in range(40):
        key, k = jax.random.split(key)
        u, ok = sample_region(region, k, 512)
        u = np.asarray(u)[np.asarray(ok)]
        d0 = np.linalg.norm(u - members[0], axis=1)
        d1 = np.linalg.norm(u - members[1], axis=1)
        assert ((d0 < 0.1) | (d1 < 0.1)).all()
        counts[0] += (d0 < 0.1).sum()
        counts[1] += (d1 < 0.1).sum()
        total += len(u)
    assert total > 2000
    # equal-volume balls -> 50/50 occupancy within 5 sigma
    p = counts[0] / total
    sigma = 0.5 / np.sqrt(total)
    assert abs(p - 0.5) < 5 * sigma, (p, total)


def test_pairwise_chebyshev_vs_scipy():
    rng = np.random.default_rng(6)
    a = rng.normal(size=(41, 5))
    b = rng.normal(size=(29, 5))
    got = np.asarray(pairwise_sq_chebyshev(jnp.asarray(a, jnp.float32),
                                           jnp.asarray(b, jnp.float32)))
    want = scipy.spatial.distance.cdist(a, b, metric="chebyshev") ** 2
    assert np.allclose(got, want, rtol=1e-4, atol=1e-5)


def test_count_within_chebyshev_vs_scipy():
    """SupFriends box membership (friends.py:129-143 semantics)."""
    rng = np.random.default_rng(7)
    n, m, ndim = 50, 200, 3
    members = rng.uniform(size=(n, ndim)).astype(np.float32)
    pts = rng.uniform(-0.2, 1.2, size=(m, ndim)).astype(np.float32)
    mask = np.ones(n, bool)
    region = build_region(jnp.asarray(members), jnp.asarray(mask),
                          jax.random.key(0), nbootstraps=5,
                          metriclearner="none", norm="chebyshev")
    r = float(region.radius)
    got = np.asarray(count_within(region, jnp.asarray(pts), norm="chebyshev"))
    d = scipy.spatial.distance.cdist(members, pts, metric="chebyshev")
    want = (d < r).sum(axis=0)
    assert (np.abs(got - want) <= (np.abs(d - r) < 1e-4).sum(axis=0)).all()


def test_sample_region_chebyshev_stays_in_union():
    """Accepted SupFriends samples land inside the union of boxes, and both
    equal-volume boxes are occupied evenly."""
    members = np.array([[0.3, 0.3], [0.7, 0.7]], np.float32)
    mask = np.ones(2, bool)
    region = build_region(jnp.asarray(members), jnp.asarray(mask),
                          jax.random.key(0), nbootstraps=3,
                          metriclearner="none", norm="chebyshev")
    region = region._replace(radius=jnp.float32(0.1),
                             lo=jnp.asarray([0.2, 0.2], jnp.float32),
                             hi=jnp.asarray([0.8, 0.8], jnp.float32))
    total = 0
    counts = np.zeros(2)
    key = jax.random.key(1)
    for _ in range(20):
        key, k = jax.random.split(key)
        u, ok = sample_region(region, k, 512, norm="chebyshev")
        u = np.asarray(u)[np.asarray(ok)]
        d0 = np.abs(u - members[0]).max(axis=1)
        d1 = np.abs(u - members[1]).max(axis=1)
        assert ((d0 < 0.1) | (d1 < 0.1)).all()
        counts[0] += (d0 < 0.1).sum()
        counts[1] += (d1 < 0.1).sum()
        total += len(u)
    assert total > 1000
    p = counts[0] / total
    sigma = 0.5 / np.sqrt(total)
    assert abs(p - 0.5) < 5 * sigma, (p, total)


def test_force_shrink_caps_radius():
    rng = np.random.default_rng(5)
    members = rng.uniform(size=(80, 2)).astype(np.float32)
    mask = np.ones(80, bool)
    r1 = build_region(jnp.asarray(members), jnp.asarray(mask),
                      jax.random.key(0), nbootstraps=8, metriclearner="none")
    small = jnp.float32(float(r1.radius) * 0.5)
    r2 = build_region(jnp.asarray(members), jnp.asarray(mask),
                      jax.random.key(1), nbootstraps=8, metriclearner="none",
                      prev_scale=r1.metric.scale, prev_radius=small)
    assert float(r2.radius) <= float(small) + 1e-7


# --- fixed-bag and large-member-set oracles for the radius and membership
# reductions (cneighbors.c:95-179 semantics) -------------------------------


def _region_from(members, mask, r):
    """A Region around fixed members with a given radius (identity metric)."""
    members = jnp.asarray(members)
    ndim = members.shape[1]
    return Region(
        members_w=members, member_mask=jnp.asarray(mask),
        n_members=jnp.int32(int(np.sum(mask))),
        metric=identity_metric(ndim), radius=jnp.float32(r),
        lo=jnp.zeros(ndim), hi=jnp.ones(ndim),
    )


def _assert_counts_match(members, mask, pts, r):
    got = np.asarray(count_within(_region_from(members, mask, r),
                                  jnp.asarray(pts)))
    d = scipy.spatial.distance.cdist(pts, members[mask])
    want = (d < r).sum(axis=1)
    # a pair within f32 rounding of the radius may fall either way
    boundary = (np.abs(d - r) < 1e-4).sum(axis=1)
    assert (np.abs(got - want) <= boundary).all()


def _oracle_sq_radius(w, mask, inbag):
    d = scipy.spatial.distance.cdist(w, w) ** 2
    want = 0.0
    for b in range(inbag.shape[0]):
        oob = mask & ~inbag[b]
        if not oob.any() or not inbag[b].any():
            continue
        want = max(want, d[np.ix_(oob, inbag[b])].min(axis=1).max())
    return want


def test_count_within_masked_members_vs_scipy():
    rng = np.random.default_rng(0)
    M, N, ndim = 128, 300, 3
    members = rng.uniform(size=(M, ndim)).astype(np.float32)
    mask = np.arange(M) < 100
    pts = rng.uniform(-0.2, 1.2, size=(N, ndim)).astype(np.float32)
    _assert_counts_match(members, mask, pts, 0.2)


def test_count_within_large_member_set():
    """M=8192 with a valid count that is no power of two."""
    rng = np.random.default_rng(3)
    M, N, ndim = 8192, 640, 3
    members = rng.uniform(size=(M, ndim)).astype(np.float32)
    mask = np.arange(M) < 7000
    pts = rng.uniform(size=(N, ndim)).astype(np.float32)
    _assert_counts_match(members, mask, pts, 0.05)


def test_radius_from_inbag_matches_dispatch():
    """bootstrapped_sq_radius is the fixed-bag reduction applied to the
    bags that bootstrap_inbag_rounds draws from the same key."""
    rng = np.random.default_rng(7)
    M, ndim, nb = 96, 3, 10
    w = jnp.asarray(rng.uniform(size=(M, ndim)), jnp.float32)
    mask = jnp.asarray(np.arange(M) < 80)
    key = jax.random.key(3)
    want = float(bootstrapped_sq_radius(w, mask, key, nb))
    inbag = bootstrap_inbag_rounds(mask, key, nb)
    got = float(sq_radius_from_inbag(w, mask, inbag))
    assert got == want, (got, want)


@pytest.mark.parametrize("M,ndim,nb,n_valid,seed", [
    (64, 2, 8, 50, 1),
    (4096, 3, 10, 3500, 4),
])
def test_radius_from_inbag_matches_oracle(M, ndim, nb, n_valid, seed):
    rng = np.random.default_rng(seed)
    w = rng.uniform(size=(M, ndim)).astype(np.float32)
    mask = np.arange(M) < n_valid
    inbag = rng.random((nb, M)) < 0.6
    inbag[:, ~mask] = False
    got = float(sq_radius_from_inbag(jnp.asarray(w), jnp.asarray(mask),
                                     jnp.asarray(inbag)))
    want = _oracle_sq_radius(w, mask, inbag)
    assert np.isclose(got, want, rtol=1e-4, atol=1e-5), (got, want)


def test_radius_empty_bag_round_is_ignored():
    rng = np.random.default_rng(5)
    M, ndim = 64, 2
    w = rng.uniform(size=(M, ndim)).astype(np.float32)
    mask = np.ones(M, bool)
    inbag = np.zeros((3, M), bool)
    inbag[1] = rng.random(M) < 0.5
    got = float(sq_radius_from_inbag(jnp.asarray(w), jnp.asarray(mask),
                                     jnp.asarray(inbag)))
    want = _oracle_sq_radius(w, mask, inbag)
    assert want > 0
    assert np.isclose(got, want, rtol=1e-4), (got, want)
