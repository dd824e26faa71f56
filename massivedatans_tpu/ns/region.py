"""MLFriends region geometry, fully on-device.

Re-implements reference layer L2/L3 (survey §1) as static-shape jnp:

- metric learning (reference ``clustering/sdml.py:25-88``: identity /
  simple / truncated power-of-two scaling) as pure jnp,
- the bootstrapped RadFriends radius (reference ``clustering/neighbors.py:
  211-238`` and C kernel ``clustering/cneighbors.c:125-179``) as one masked
  pairwise-distance matrix plus a vmap over bootstrap rounds,
- region membership counts (reference ``cneighbors.c:95-119``) as a
  distance matmul with a compare-and-sum reduction,
- uniform sampling of (union-of-balls ∩ unit cube) (reference
  ``clustering/radfriendsregion.py:117-182``: dual box/ball proposal with
  1/n_near multiplicity correction) as fixed-size masked batches.

Everything is static-shape: member sets are padded to a capacity ``M`` with a
validity mask, so regions can live inside ``jit``/``scan``/``while_loop``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_NEG_BIG = -1e30
_POS_BIG = 1e30


class Metric(NamedTuple):
    """Diagonal whitening transform (reference sdml.py)."""

    mean: jax.Array   # [ndim]
    scale: jax.Array  # [ndim]

    def transform(self, u):
        return (u - self.mean) / self.scale

    def untransform(self, w):
        return w * self.scale + self.mean


def identity_metric(ndim: int) -> Metric:
    return Metric(mean=jnp.zeros(ndim), scale=jnp.ones(ndim))


def fit_metric(u, mask, kind: str = "truncatedscaling") -> Metric:
    """Masked mean/std whitening; ``truncatedscaling`` quantizes the scale
    onto powers of two to avoid metric random-walk (sdml.py:60-88)."""
    mask_f = mask.astype(u.dtype)[:, None]
    n = jnp.maximum(mask_f.sum(), 1.0)
    mean = (u * mask_f).sum(axis=0) / n
    var = (jnp.square(u - mean) * mask_f).sum(axis=0) / n
    scale = jnp.sqrt(jnp.maximum(var, 1e-24))
    if kind == "none":
        return Metric(mean=jnp.zeros_like(mean), scale=jnp.ones_like(scale))
    if kind == "simplescaling":
        return Metric(mean=mean, scale=scale)
    if kind == "truncatedscaling":
        # round onto a discrete log2 scale relative to the largest axis
        scalemax = scale.max() * 1.001
        logscale = jnp.floor(-jnp.log2(scale / scalemax)).astype(jnp.int32)
        return Metric(mean=mean, scale=2.0 ** (-logscale.astype(u.dtype)))
    raise ValueError(f"unknown metriclearner {kind!r}")


class Region(NamedTuple):
    """Union-of-balls region around (whitened) member points."""

    members_w: jax.Array   # [M, ndim] whitened members (rows beyond mask: junk)
    member_mask: jax.Array  # [M] bool
    n_members: jax.Array   # scalar int32
    metric: Metric
    radius: jax.Array      # scalar; ball radius in whitened space
    lo: jax.Array          # [ndim] whitened bounding box (members +- radius)
    hi: jax.Array          # [ndim]


def pairwise_sqdist(a, b, precision=jax.lax.Precision.HIGHEST):
    """[N, M] squared euclidean distances as one f32 matrix product."""
    cross = jnp.dot(a, b.T, precision=precision, preferred_element_type=jnp.float32)
    ssa = jnp.sum(jnp.square(a), axis=1)
    ssb = jnp.sum(jnp.square(b), axis=1)
    return jnp.maximum(ssa[:, None] - 2.0 * cross + ssb[None, :], 0.0)


def pairwise_sq_chebyshev(a, b):
    """[N, M] squared Chebyshev (max-norm) distances.

    The box metric of the reference's SupFriends variant (``friends.py:
    14-21,129-143``, ``clustering/neighbors.py:22-63``: ``dist = max_k
    |a_k - b_k|``). Squared so the bootstrapped-radius and membership code
    paths are shared with the euclidean norm. Unrolled over the (small,
    static) coordinate axis to avoid materializing an [N, M, ndim] cube.
    """
    ndim = a.shape[1]
    out = jnp.square(a[:, 0][:, None] - b[None, :, 0])
    for k in range(1, ndim):
        out = jnp.maximum(out, jnp.square(a[:, k][:, None] - b[None, :, k]))
    return out


def _pairwise(a, b, norm: str):
    if norm == "euclidean":
        return pairwise_sqdist(a, b)
    if norm == "chebyshev":
        return pairwise_sq_chebyshev(a, b)
    raise ValueError(f"unknown norm {norm!r}")


def bootstrap_inbag_rounds(mask, key, nbootstraps: int) -> jax.Array:
    """[nb, M] in-bag flags: each round draws n members with replacement
    (``neighbors.py:170-177`` builds the same matrix host-side)."""
    M = mask.shape[0]
    n = mask.sum().astype(jnp.int32)
    logits = jnp.where(mask, 0.0, _NEG_BIG)
    draw_valid = jnp.arange(M) < n  # exactly n draws per round

    def one(k):
        choice = jax.random.categorical(k, logits, shape=(M,))  # uniform over valid
        hits = jnp.zeros((M,), jnp.int32).at[choice].add(draw_valid.astype(jnp.int32))
        return hits > 0

    return jax.vmap(one)(jax.random.split(key, nbootstraps))


def bootstrapped_sq_radius(
    w, mask, key, nbootstraps: int, norm: str = "euclidean"
) -> jax.Array:
    """Squared RadFriends radius: max over bootstrap rounds of the largest
    nearest-in-bag distance of any out-of-bag member.

    Mirrors ``cneighbors.c:125-179`` / ``neighbors.py:211-238``: each round
    draws n samples with replacement; points never drawn are out-of-bag and
    must be covered by a ball around some in-bag point.
    With ``norm="chebyshev"`` this is the SupFriends box radius
    (``clustering/neighbors.py:65-86`` find_maxdistance semantics, with the
    same bootstrap protocol instead of the plain max-NN estimate).
    """
    inbag = bootstrap_inbag_rounds(mask, key, nbootstraps)
    return sq_radius_from_inbag(w, mask, inbag, norm=norm)


def sq_radius_from_inbag(w, mask, inbag, norm: str = "euclidean") -> jax.Array:
    """Squared radius for given in-bag flags ``inbag[nb, M]``: the largest
    distance from an out-of-bag member to its nearest in-bag member, maxed
    over rounds. A round with an empty bag has no ball to cover anything
    and contributes nothing (the reference skips it)."""
    with jax.named_scope("region_bootstrap_radius"):
        d2 = _pairwise(w, w, norm)  # [M, M]; shared by all bootstrap rounds

        def one_round(inbag_b):
            oob = mask & ~inbag_b
            nearest = jnp.min(jnp.where(inbag_b[None, :], d2, _POS_BIG), axis=1)
            rmax = jnp.max(jnp.where(oob, nearest, 0.0))
            return jnp.where(rmax >= _POS_BIG, 0.0, rmax)

        return jnp.max(jax.vmap(one_round)(inbag))


def jackknife_sq_radius(w, mask, norm: str = "euclidean") -> jax.Array:
    """Squared leave-one-out radius: the largest nearest-OTHER-neighbor
    distance over the members.

    The reference's ``jackknife=True`` estimator (friends.py:30-33,71-75 →
    ``nearest_rdistance_guess``, clustering/neighbors.py:185-194, C kernel
    ``most_distant_nearest_neighbor``, cneighbors.c:32-75): instead of
    bootstrap rounds that leave out a random group, each point is left out
    in turn and must be covered by a ball around its nearest neighbor.
    Cheaper (one pairwise pass, no bootstrap axis) and less conservative
    (radii come out smaller, trading robustness for acceptance rate).
    """
    M = mask.shape[0]
    d2 = _pairwise(w, w, norm)
    self_or_invalid = jnp.eye(M, dtype=bool) | ~mask[None, :]
    nearest = jnp.min(jnp.where(self_or_invalid, _POS_BIG, d2), axis=1)
    # a single valid member has no neighbor: fall back to radius 0 (the
    # caller's box proposal still covers the point itself)
    nearest = jnp.where(nearest >= _POS_BIG, 0.0, nearest)
    return jnp.max(jnp.where(mask, nearest, 0.0))


def build_region(
    members_u,
    member_mask,
    key,
    nbootstraps: int = 10,
    metriclearner: str = "truncatedscaling",
    prev_scale=None,
    prev_radius=None,
    norm: str = "euclidean",
    estimator: str = "bootstrap",
    extra_u=None,
    extra_mask=None,
) -> Region:
    """Whiten + bootstrap-radius region build (hiermetriclearn.py:48-92).

    ``force_shrink`` semantics: when the (quantized) metric scale is unchanged
    from the previous build, the radius may only shrink
    (hiermetriclearn.py:88-91). ``norm="chebyshev"`` gives the SupFriends
    union-of-boxes region (friends.py:14-21). ``estimator="jackknife"``
    selects the leave-one-out radius (friends.py jackknife option).

    ``extra_u``/``extra_mask``: phantom points (friends.py:79-84) appended
    as additional ball centers AFTER the metric is fit and the radius is
    estimated + force-shrunk from the live members alone — matching the
    reference's ordering, where phantoms only EXTEND the union's coverage
    and never inflate the fitted scale or radius.
    """
    metric = fit_metric(members_u, member_mask, metriclearner)
    w = metric.transform(members_u)
    if estimator == "jackknife":
        r2 = jackknife_sq_radius(w, member_mask, norm=norm)
    elif estimator == "bootstrap":
        r2 = bootstrapped_sq_radius(w, member_mask, key, nbootstraps, norm=norm)
    else:
        raise ValueError(f"unknown radius estimator {estimator!r}")
    radius = jnp.sqrt(r2)
    if prev_scale is not None and prev_radius is not None:
        same_metric = jnp.all(prev_scale == metric.scale)
        radius = jnp.where(
            same_metric & (prev_radius > 0.0), jnp.minimum(radius, prev_radius), radius
        )
    if extra_u is not None:
        w = jnp.concatenate([w, metric.transform(extra_u)], axis=0)
        member_mask = jnp.concatenate([member_mask, extra_mask])
    big = jnp.where(member_mask[:, None], w, jnp.nan)
    lo = jnp.nanmin(big, axis=0) - radius
    hi = jnp.nanmax(big, axis=0) + radius
    return Region(
        members_w=w,
        member_mask=member_mask,
        n_members=member_mask.sum().astype(jnp.int32),
        metric=metric,
        radius=radius,
        lo=lo,
        hi=hi,
    )


def count_within(region: Region, w_points, norm: str = "euclidean") -> jax.Array:
    """Number of member balls containing each point (cneighbors.c:95-119)."""
    with jax.named_scope("region_count_within"):
        d2 = _pairwise(w_points, region.members_w, norm)  # [N, M]
        near = (d2 < jnp.square(region.radius)) & region.member_mask[None, :]
        return near.sum(axis=1)


def ball_offsets(key, n: int, ndim: int, radius, norm: str = "euclidean"):
    """Uniform offsets within a radius-``radius`` ball: unit direction times
    ``R * U^(1/ndim)`` (radial density ~ volume, radfriendsregion.py:157).
    A Chebyshev ball is an axis-aligned cube, so that norm draws uniform
    per-coordinate offsets instead."""
    if norm == "chebyshev":
        return jax.random.uniform(
            key, (n, ndim), minval=-radius, maxval=radius
        )
    k_dir, k_rad = jax.random.split(key)
    direction = jax.random.normal(k_dir, (n, ndim))
    direction = direction / jnp.linalg.norm(direction, axis=1, keepdims=True)
    rr = radius * jax.random.uniform(k_rad, (n, 1)) ** (1.0 / ndim)
    return direction * rr


def sample_region(region: Region, key, nprop: int, norm: str = "euclidean"):
    """Draw ``nprop`` candidates uniform on (union-of-balls ∩ unit cube).

    Half the batch uses the whitened-bounding-box proposal, half the
    ball-around-random-member proposal with the 1/n_near multiplicity
    correction — the same dual scheme as ``radfriendsregion.py:129-182``,
    but as one fixed-size masked batch. Returns ``(u, ok)`` where ``ok``
    marks candidates that landed inside the region and the unit cube.
    """
    ndim = region.members_w.shape[1]
    n_box = nprop // 2
    n_ball = nprop - n_box
    k_box, k_mem, k_ball, k_coin = jax.random.split(key, 4)

    # --- box proposals ---
    w_box = jax.random.uniform(
        k_box, (n_box, ndim), minval=region.lo, maxval=region.hi
    )
    ok_box = count_within(region, w_box, norm=norm) > 0

    # --- ball proposals ---
    logits = jnp.where(region.member_mask, 0.0, _NEG_BIG)
    mem = jax.random.categorical(k_mem, logits, shape=(n_ball,))
    center = region.members_w[mem]  # [n_ball, ndim]
    w_ball = center + ball_offsets(k_ball, n_ball, ndim, region.radius, norm=norm)
    nnear = count_within(region, w_ball, norm=norm)
    coin = jax.random.uniform(k_coin, (n_ball,))
    ok_ball = coin * nnear.astype(coin.dtype) < 1.0  # accept w.p. 1/nnear; nnear >= 1

    w_all = jnp.concatenate([w_box, w_ball], axis=0)
    ok = jnp.concatenate([ok_box, ok_ball], axis=0)
    u = region.metric.untransform(w_all)
    in_cube = jnp.all((u > 0.0) & (u < 1.0), axis=1)
    return u, ok & in_cube
