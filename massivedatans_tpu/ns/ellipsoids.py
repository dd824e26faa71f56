"""Multi-ellipsoid bounding geometry (MultiNest-style), from scratch in JAX.

Capability equivalent of reference ``elldrawer.py:25-102``, which delegates to
the external ``nestle`` package (``bounding_ellipsoids``/``sample_ellipsoids``)
and enlarges volumes 3x. This implementation is static-shape jnp:

- a fixed budget of E ellipsoids assigned by a few Lloyd iterations of
  k-means on the whitened members,
- per-cluster mean/covariance, scaled so every assigned point lies inside,
  then volume-enlarged by ``enlarge`` (elldrawer.py:26,41-42),
- sampling: pick an ellipsoid by volume, draw uniform inside it, accept with
  probability 1/(number of containing ellipsoids) — the same multiplicity
  correction as the union-of-balls sampler.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# [M, ndim]-sized products: full f32 costs nothing here, and on a GPU the
# DEFAULT precision would run them in TF32
_HIGHEST = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HIGHEST)


_NEG_BIG = -1e30


class Ellipsoids(NamedTuple):
    mean: jax.Array      # [E, ndim]
    cov_chol: jax.Array  # [E, ndim, ndim] Cholesky of scaled covariance
    inv_chol: jax.Array  # [E, ndim, ndim] inverse Cholesky (for Mahalanobis)
    log_vol: jax.Array   # [E] log volume (up to a common constant)
    valid: jax.Array     # [E] bool


def _kmeans_assign(w, mask, key, n_clusters: int, iters: int = 8):
    """Masked Lloyd iterations; returns hard assignments [M]."""
    M, ndim = w.shape
    # init centers from random valid members
    logits = jnp.where(mask, 0.0, _NEG_BIG)
    init_idx = jax.random.categorical(key, logits, shape=(n_clusters,))
    centers = w[init_idx]

    def step(centers, _):
        d2 = (
            jnp.sum(jnp.square(w), axis=1)[:, None]
            - 2.0 * _mm(w, centers.T)
            + jnp.sum(jnp.square(centers), axis=1)[None, :]
        )  # [M, E]
        assign = jnp.argmin(d2, axis=1)
        onehot = (
            jax.nn.one_hot(assign, n_clusters, dtype=w.dtype)
            * mask[:, None].astype(w.dtype)
        )  # [M, E]
        counts = onehot.sum(axis=0)  # [E]
        sums = _mm(onehot.T, w)  # [E, ndim]
        new_centers = jnp.where(
            counts[:, None] > 0, sums / jnp.maximum(counts[:, None], 1.0), centers
        )
        return new_centers, None

    centers, _ = jax.lax.scan(step, centers, None, length=iters)
    d2 = (
        jnp.sum(jnp.square(w), axis=1)[:, None]
        - 2.0 * _mm(w, centers.T)
        + jnp.sum(jnp.square(centers), axis=1)[None, :]
    )
    return jnp.argmin(d2, axis=1)


def fit_ellipsoids(w, mask, key, n_ellipsoids: int = 4,
                   enlarge: float = 3.0) -> Ellipsoids:
    M, ndim = w.shape
    E = n_ellipsoids
    assign = _kmeans_assign(w, mask, key, E)
    onehot = (
        jax.nn.one_hot(assign, E, dtype=w.dtype) * mask[:, None].astype(w.dtype)
    )  # [M, E]
    counts = onehot.sum(axis=0)
    valid = counts >= (ndim + 1)
    # degenerate clusters fall back to the global cluster statistics
    global_w = mask[:, None].astype(w.dtype)
    g_n = jnp.maximum(global_w.sum(), 1.0)
    g_mean = (w * global_w).sum(axis=0) / g_n
    g_cov = _mm(((w - g_mean) * global_w).T, w - g_mean) / g_n

    means = jnp.where(
        valid[:, None],
        _mm(onehot.T, w) / jnp.maximum(counts[:, None], 1.0),
        g_mean[None, :],
    )  # [E, ndim]

    def cov_for(e):
        diff = w - means[e]
        wts = onehot[:, e]
        c = _mm((diff * wts[:, None]).T, diff) / jnp.maximum(counts[e], 1.0)
        return jnp.where(valid[e], c, g_cov)

    covs = jax.vmap(cov_for)(jnp.arange(E))  # [E, ndim, ndim]
    covs = covs + 1e-10 * jnp.eye(ndim)[None, :, :]

    # scale each ellipsoid so all its assigned points are inside:
    # f = max Mahalanobis^2 over assigned points, then enlarge volume
    chol = jnp.linalg.cholesky(covs)
    inv_chol = jax.vmap(
        lambda L: jax.scipy.linalg.solve_triangular(L, jnp.eye(ndim), lower=True)
    )(chol)

    def maxdist(e):
        diff = w - means[e]
        z = _mm(diff, inv_chol[e].T)  # [M, ndim]
        m2 = jnp.sum(jnp.square(z), axis=1)
        sel = (assign == e) & mask
        return jnp.max(jnp.where(sel, m2, 0.0))

    f2 = jax.vmap(maxdist)(jnp.arange(E))  # [E]
    f2 = jnp.maximum(f2, 1e-12)
    # radius scale: sqrt(f2) covers the points; enlarge multiplies volume
    scale = jnp.sqrt(f2) * enlarge ** (1.0 / ndim)
    chol = chol * scale[:, None, None]
    inv_chol = inv_chol / scale[:, None, None]
    logdet = jnp.sum(
        jnp.log(jnp.maximum(jnp.abs(jnp.diagonal(chol, axis1=1, axis2=2)), 1e-30)),
        axis=1,
    )
    log_vol = jnp.where(valid | (jnp.arange(E) == 0), logdet, -jnp.inf)
    return Ellipsoids(
        mean=means, cov_chol=chol, inv_chol=inv_chol, log_vol=log_vol,
        valid=valid | (jnp.arange(E) == 0),
    )


def count_containing(ells: Ellipsoids, u) -> jax.Array:
    """Number of ellipsoids containing each point [N]."""

    def per_ell(mean, inv_chol, valid):
        z = _mm(u - mean, inv_chol.T)
        return ((jnp.sum(jnp.square(z), axis=1) <= 1.0) & valid).astype(jnp.int32)

    counts = jax.vmap(per_ell)(ells.mean, ells.inv_chol, ells.valid)  # [E, N]
    return counts.sum(axis=0)


def sample_ellipsoids(ells: Ellipsoids, key, nprop: int):
    """Draw ``nprop`` candidates uniform on the union of ellipsoids.

    Returns whitened-space points [nprop, ndim] and an accept mask with the
    1/n multiplicity correction applied.
    """
    ndim = ells.mean.shape[1]
    k_pick, k_dir, k_rad, k_coin = jax.random.split(key, 4)
    pick = jax.random.categorical(
        k_pick, jnp.where(ells.valid, ells.log_vol, _NEG_BIG), shape=(nprop,)
    )
    direction = jax.random.normal(k_dir, (nprop, ndim))
    direction = direction / jnp.linalg.norm(direction, axis=1, keepdims=True)
    radius = jax.random.uniform(k_rad, (nprop, 1)) ** (1.0 / ndim)
    z = direction * radius
    w = ells.mean[pick] + jnp.einsum("nij,nj->ni", ells.cov_chol[pick], z,
                                     precision=_HIGHEST)
    n = count_containing(ells, w)  # >= 1 by construction
    coin = jax.random.uniform(k_coin, (nprop,))
    ok = coin * n.astype(coin.dtype) < 1.0
    return w, ok
