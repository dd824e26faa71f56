"""Constrained-draw strategies (reference layer L3, survey §1).

The reference ships three constrainers selected by ``CONSTRAINER``
(sample.py:131-155): MLFriends (hiermetriclearn.py), multi-ellipsoid
(elldrawer.py via nestle) and whitened slice sampling (whitenedmcmc.py).
Here each is a triple of jax-traceable functions used inside the engine's
fill loop:

- ``build(members_u, member_mask, key, prev_scale, prev_radius)`` →
  geometry pytree (rebuilt at NS-iteration start and on refocus),
- ``init_chains(geom, key)`` → per-fill mutable strategy state,
- ``propose(geom, sstate, key)`` → ``(cand_u[B, ndim], valid[B], sstate)``,
- ``observe(sstate, cand_u, chain_accept)`` → sstate (likelihood feedback,
  used by the slice strategy's accept/shrink rule).

All three produce fixed-size candidate batches, so the engine's matmul
scoring and shelf scatter are strategy-independent.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from massivedatans_tpu.config import RunConfig
from massivedatans_tpu.ns import ellipsoids as ell_lib
from massivedatans_tpu.ns import region as region_lib

_NEG_BIG = -1e30


def _no_refresh(geom, sstate, key, chain_accept):
    return sstate


class Strategy(NamedTuple):
    build: Callable        # geometry from member points
    init_chains: Callable  # per-fill strategy state
    propose: Callable      # fixed-size candidate batch
    observe: Callable      # likelihood feedback (slice shrink/advance)
    refresh: Callable = _no_refresh  # post-feedback direction/restart update
    norm: str = "euclidean"  # ball norm when the geometry is a Region (the
                             # engine's column proposals must sample the same
                             # ball shape the region's radius was fit in)


def _compact(u_prop, ok, B):
    """Move in-geometry proposals to the front of a fixed eval batch."""
    order = jnp.argsort(~ok)
    take = order[:B]
    return u_prop[take], ok[take]


# --------------------------------------------------------------------------
# MLFriends: metric-learned union-of-balls (hiermetriclearn.py:30-213)
# --------------------------------------------------------------------------

def make_mlfriends(
    cfg: RunConfig,
    norm: str = "euclidean",
    metriclearner: str | None = None,
) -> Strategy:
    """Union-of-balls/boxes constrained draws.

    Defaults give MLFriends (hiermetriclearn.py). ``norm="chebyshev"`` gives
    the SupFriends box-metric variant and ``metriclearner="none"`` the plain
    RadFriends variant of the reference's ``friends.py:8-334`` (there
    vestigial — its external ``nested_sampling`` import is broken — but its
    euclidean/chebyshev capability is carried here as a working strategy).
    """
    learner = cfg.metriclearner if metriclearner is None else metriclearner

    def build(members_u, member_mask, key, prev_scale, prev_radius,
              extra_u=None, extra_mask=None):
        return region_lib.build_region(
            members_u, member_mask, key,
            nbootstraps=cfg.nbootstraps,
            metriclearner=learner,
            prev_scale=prev_scale if cfg.force_shrink else None,
            prev_radius=prev_radius if cfg.force_shrink else None,
            norm=norm,
            estimator=cfg.radius_estimator,
            extra_u=extra_u,
            extra_mask=extra_mask,
        )

    def init_chains(geom, key):
        return ()

    def propose(geom, sstate, key):
        u_prop, ok = region_lib.sample_region(
            geom, key, cfg.proposal_batch, norm=norm
        )
        cand_u, valid = _compact(u_prop, ok, cfg.eval_batch)
        return cand_u, valid, sstate

    def observe(sstate, cand_u, chain_accept):
        return sstate

    return Strategy(build, init_chains, propose, observe, norm=norm)


# --------------------------------------------------------------------------
# Multi-ellipsoid (elldrawer.py:25-102, own fit instead of nestle)
# --------------------------------------------------------------------------

class EllGeom(NamedTuple):
    ells: ell_lib.Ellipsoids
    members_u: jax.Array
    member_mask: jax.Array


def make_multiellipsoids(cfg: RunConfig, n_ellipsoids: int = 4,
                         enlarge: float = 3.0) -> Strategy:
    def build(members_u, member_mask, key, prev_scale, prev_radius,
              extra_u=None, extra_mask=None):
        # phantom extras are a friends-family feature (friends.py:54-59);
        # the ellipsoid fit uses live members only, as the reference does
        ells = ell_lib.fit_ellipsoids(
            members_u, member_mask, key,
            n_ellipsoids=n_ellipsoids, enlarge=enlarge,
        )
        return EllGeom(ells=ells, members_u=members_u, member_mask=member_mask)

    def init_chains(geom, key):
        return ()

    def propose(geom, sstate, key):
        u_prop, ok = ell_lib.sample_ellipsoids(
            geom.ells, key, cfg.proposal_batch
        )
        in_cube = jnp.all((u_prop > 0.0) & (u_prop < 1.0), axis=1)
        cand_u, valid = _compact(u_prop, ok & in_cube, cfg.eval_batch)
        return cand_u, valid, sstate

    def observe(sstate, cand_u, chain_accept):
        return sstate

    return Strategy(build, init_chains, propose, observe)


# --------------------------------------------------------------------------
# Whitened slice sampling (whitenedmcmc.py:127-324)
# --------------------------------------------------------------------------

class SliceGeom(NamedTuple):
    members_u: jax.Array   # [M, ndim] chain restart points (live points)
    member_mask: jax.Array  # [M]
    metric: region_lib.Metric
    chol: jax.Array        # [ndim, ndim] live-point covariance Cholesky
                           # (Mahalanobis directions, whitenedmcmc.py:200-215)


class SliceChains(NamedTuple):
    u: jax.Array          # [C, ndim] current chain positions
    direction: jax.Array  # [C, ndim] unit direction (whitened space)
    lo: jax.Array         # [C] interval bounds along direction
    hi: jax.Array         # [C]
    t: jax.Array          # [C] last proposed offset
    steps: jax.Array      # [C] accepted direction-steps since restart
    axis: jax.Array       # [C] iterating coordinate index


def _cube_bracket(u, direction):
    """Exact [lo, hi] of {t : u + t*d in (0,1)^ndim}.

    Replaces the reference's stepping-out doubling loop
    (whitenedmcmc.py:144-174), whose inside-filter is the unit cube
    (sample.py:150-152 wires FilteredUnitIterateSliceProposal with
    is_inside_unit_filter): the bracket has a closed form on a box.
    """
    eps = 1e-12
    d = jnp.where(jnp.abs(direction) < eps, eps, direction)
    t0 = (0.0 - u) / d
    t1 = (1.0 - u) / d
    t_min = jnp.minimum(t0, t1)
    t_max = jnp.maximum(t0, t1)
    return jnp.max(t_min, axis=1), jnp.min(t_max, axis=1)


def make_slice(cfg: RunConfig, nsteps: int | None = None,
               direction: str | None = None) -> Strategy:
    """Batched slice sampler: C = eval_batch parallel chains, each advanced
    one proposal per fill round; every proposal is scored against all
    datasets by the shared matmul (the reference evaluates per proposal too,
    whitenedmcmc.py:291-294, but discards non-final accepts — we shelve
    them once the chain is past burn-in).

    ``direction`` selects the reference's proposal-direction family:
    ``iterate`` cycles whitened coordinates (FilteredUnitIterateSlice,
    whitenedmcmc.py:232-249, the default), ``random`` draws random whitened
    coordinates-free directions (:217-230), ``mahalanobis`` draws from the
    live-point covariance Cholesky (FilteredMahalanobisSliceProposal,
    :200-215) — the variant that helps on correlated posteriors.
    """
    C = cfg.eval_batch
    direction = (direction or cfg.slice_direction).lower()
    if direction not in ("iterate", "random", "mahalanobis"):
        raise ValueError(f"unknown slice_direction {direction!r}")

    def build(members_u, member_mask, key, prev_scale, prev_radius,
              extra_u=None, extra_mask=None):
        metric = region_lib.fit_metric(
            members_u, member_mask, cfg.metriclearner
        )
        # masked live-point covariance -> Cholesky (whitenedmcmc.py:204-206
        # uses numpy.cov of the live points); jitter keeps it SPD when the
        # points collapse onto a subspace
        ndim = members_u.shape[1]
        mf = member_mask.astype(members_u.dtype)[:, None]
        n = jnp.maximum(mf.sum(), 2.0)
        mean = (members_u * mf).sum(axis=0) / n
        centered = (members_u - mean) * mf
        cov = jnp.matmul(centered.T, centered,
                         precision=jax.lax.Precision.HIGHEST) / (n - 1.0)
        cov = cov + 1e-10 * jnp.eye(ndim, dtype=cov.dtype)
        chol = jnp.linalg.cholesky(cov)
        return SliceGeom(members_u=members_u, member_mask=member_mask,
                         metric=metric, chol=chol)

    def _restart_points(geom, key, n):
        logits = jnp.where(geom.member_mask, 0.0, _NEG_BIG)
        pick = jax.random.categorical(key, logits, shape=(n,))
        return geom.members_u[pick]

    def _new_direction(geom, key, axis, ndim):
        if direction == "iterate":
            # iterative component-wise direction in the whitened metric
            # (FilteredUnitIterateSliceProposal, whitenedmcmc.py:232-249)
            new_axis = (axis + 1) % ndim
            d = jax.nn.one_hot(new_axis, ndim, dtype=jnp.float32)
            d = d * geom.metric.scale[None, :]
            d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
            return d, new_axis
        d = jax.random.normal(key, (axis.shape[0], ndim))
        if direction == "mahalanobis":
            # live-point-covariance direction (whitenedmcmc.py:200-215)
            d = jnp.matmul(d, geom.chol.T,
                           precision=jax.lax.Precision.HIGHEST)
        else:
            d = d * geom.metric.scale[None, :]
        d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
        return d, axis

    def init_chains(geom, key):
        ndim = geom.members_u.shape[1]
        k1, k2 = jax.random.split(key)
        u0 = _restart_points(geom, k1, C)
        axis0 = jnp.zeros((C,), jnp.int32)
        d0, axis0 = _new_direction(geom, k2, axis0, ndim)
        lo, hi = _cube_bracket(u0, d0)
        return SliceChains(
            u=u0, direction=d0, lo=lo, hi=hi,
            t=jnp.zeros((C,)), steps=jnp.zeros((C,), jnp.int32), axis=axis0,
        )

    n_burn = nsteps  # resolved lazily per-problem ndim below

    def propose(geom, sstate, key):
        t = jax.random.uniform(key, (C,), minval=sstate.lo, maxval=sstate.hi)
        cand = sstate.u + sstate.direction * t[:, None]
        cand = jnp.clip(cand, 1e-7, 1.0 - 1e-7)
        ndim = cand.shape[1]
        burn = (5 * ndim) if n_burn is None else n_burn
        valid = sstate.steps >= burn
        return cand, valid, sstate._replace(t=t)

    def observe(sstate, cand_u, chain_accept):
        # slice accept/shrink (whitenedmcmc.py:176-191): on accept move the
        # chain; on reject shrink the interval toward the current point
        new_u = jnp.where(chain_accept[:, None], cand_u, sstate.u)
        lo = jnp.where(chain_accept | (sstate.t >= 0), sstate.lo, sstate.t)
        hi = jnp.where(chain_accept | (sstate.t < 0), sstate.hi, sstate.t)
        steps = sstate.steps + chain_accept.astype(jnp.int32)
        return sstate._replace(u=new_u, lo=lo, hi=hi, steps=steps)

    # direction refresh happens in observe2 (needs geom + key); engine calls
    # refresh after observe
    def refresh(geom, sstate, key, chain_accept):
        ndim = geom.members_u.shape[1]
        k_dir, k_restart = jax.random.split(key)
        d_new, axis_new = _new_direction(geom, k_dir, sstate.axis, ndim)
        direction = jnp.where(chain_accept[:, None], d_new, sstate.direction)
        axis = jnp.where(chain_accept, axis_new, sstate.axis)
        # interval collapse -> also refresh direction
        collapsed = (sstate.hi - sstate.lo) < 1e-9
        direction = jnp.where(collapsed[:, None], d_new, direction)
        lo_new, hi_new = _cube_bracket(sstate.u, direction)
        lo = jnp.where(chain_accept | collapsed, lo_new, sstate.lo)
        hi = jnp.where(chain_accept | collapsed, hi_new, sstate.hi)
        # periodic restart from a random live point to decorrelate
        burn = 5 * ndim
        restart = sstate.steps >= (burn + 8)
        u_r = _restart_points(geom, k_restart, C)
        u = jnp.where(restart[:, None], u_r, sstate.u)
        steps = jnp.where(restart, 0, sstate.steps)
        lo_r, hi_r = _cube_bracket(u, direction)
        lo = jnp.where(restart, lo_r, lo)
        hi = jnp.where(restart, hi_r, hi)
        return sstate._replace(u=u, direction=direction, axis=axis,
                               lo=lo, hi=hi, steps=steps)

    return Strategy(build, init_chains, propose, observe, refresh)


# --------------------------------------------------------------------------
# Galilean / adaptive random-walk MCMC (whitenedmcmc.py:44-124)
# --------------------------------------------------------------------------

class WalkGeom(NamedTuple):
    members_u: jax.Array    # [M, ndim] chain restart points (live points)
    member_mask: jax.Array  # [M]
    metric: region_lib.Metric


class WalkChains(NamedTuple):
    u: jax.Array        # [C, ndim] current chain positions
    v: jax.Array        # [C, ndim] unit velocity (whitened-metric direction)
    eps: jax.Array      # [C] step scale (unit-cube units)
    steps: jax.Array    # [C] accepted steps since restart
    rejects: jax.Array  # [C] consecutive rejections


def _reflect_cube(u):
    """Fold positions back into (0,1)^ndim by mirror reflection at the walls
    (period-2 triangle wave), the Galilean treatment of the prior boundary."""
    r = jnp.abs(jnp.mod(u, 2.0))
    r = jnp.where(r > 1.0, 2.0 - r, r)
    return jnp.clip(r, 1e-7, 1.0 - 1e-7)


def make_galilean(cfg: RunConfig, nsteps: int | None = None) -> Strategy:
    """Batched Galilean-style MCMC: C = eval_batch parallel chains coast with
    a persistent velocity; rejection reverses the velocity (Skilling's
    gradient-free Galilean move), repeated rejection resamples it.

    Covers the reference's random-walk proposal family
    (``BaseProposal`` Sivia-style step-scale adaptation, whitenedmcmc.py:
    44-96, and the DNest ``MultiScaleProposal``, whitenedmcmc.py:98-124):
    the per-chain ``eps`` grows on acceptance and shrinks on rejection, so
    the chain population spans many step scales at once. Every proposal is
    scored against all datasets by the engine's shared matmul; a proposal
    counts as accepted when it beats *any* running dataset's constraint
    (the reference's accept rule, whitenedmcmc.py:305).
    """
    C = cfg.eval_batch
    grow = jnp.float32(jnp.exp(0.12))    # Sivia-style asymmetric adaptation
    shrink = jnp.float32(jnp.exp(-0.3))  # targets ~70% acceptance

    def build(members_u, member_mask, key, prev_scale, prev_radius,
              extra_u=None, extra_mask=None):
        metric = region_lib.fit_metric(
            members_u, member_mask, cfg.metriclearner
        )
        return WalkGeom(members_u=members_u, member_mask=member_mask,
                        metric=metric)

    def _restart_points(geom, key, n):
        logits = jnp.where(geom.member_mask, 0.0, _NEG_BIG)
        pick = jax.random.categorical(key, logits, shape=(n,))
        return geom.members_u[pick]

    def _new_velocity(geom, key, n):
        d = jax.random.normal(key, (n, geom.members_u.shape[1]))
        d = d * geom.metric.scale[None, :]
        return d / jnp.linalg.norm(d, axis=1, keepdims=True)

    def init_chains(geom, key):
        k1, k2 = jax.random.split(key)
        u0 = _restart_points(geom, k1, C)
        v0 = _new_velocity(geom, k2, C)
        # initial step ~ half the live-point cloud's metric scale; the
        # multiplicative adaptation reaches any useful scale within a few
        # fill rounds (whitenedmcmc.py:60-77 semantics)
        ndim = geom.members_u.shape[1]
        eps0 = 0.5 * jnp.linalg.norm(geom.metric.scale) / jnp.sqrt(
            jnp.float32(ndim)
        )
        return WalkChains(
            u=u0, v=v0,
            eps=jnp.full((C,), eps0, jnp.float32),
            steps=jnp.zeros((C,), jnp.int32),
            rejects=jnp.zeros((C,), jnp.int32),
        )

    def propose(geom, sstate, key):
        cand = _reflect_cube(sstate.u + sstate.eps[:, None] * sstate.v)
        ndim = cand.shape[1]
        burn = (2 * ndim) if nsteps is None else nsteps
        valid = sstate.steps >= burn
        return cand, valid, sstate

    def observe(sstate, cand_u, chain_accept):
        new_u = jnp.where(chain_accept[:, None], cand_u, sstate.u)
        eps = jnp.clip(
            sstate.eps * jnp.where(chain_accept, grow, shrink), 1e-6, 0.5
        )
        return sstate._replace(
            u=new_u,
            eps=eps,
            steps=sstate.steps + chain_accept.astype(jnp.int32),
            rejects=jnp.where(chain_accept, 0, sstate.rejects + 1),
        )

    def refresh(geom, sstate, key, chain_accept):
        ndim = geom.members_u.shape[1]
        k_vel, k_restart = jax.random.split(key)
        # Galilean move: first rejection reverses the velocity (coast back
        # into the constraint); persistent rejection resamples it
        v_new = _new_velocity(geom, k_vel, C)
        v = jnp.where(
            (sstate.rejects >= 2)[:, None], v_new,
            jnp.where((sstate.rejects == 1)[:, None], -sstate.v, sstate.v),
        )
        burn = 2 * ndim
        restart = sstate.steps >= (burn + 8)
        u_r = _restart_points(geom, k_restart, C)
        return sstate._replace(
            u=jnp.where(restart[:, None], u_r, sstate.u),
            v=jnp.where(restart[:, None], v_new, v),
            steps=jnp.where(restart, 0, sstate.steps),
            rejects=jnp.where(restart, 0, sstate.rejects),
        )

    return Strategy(build, init_chains, propose, observe, refresh)


def make_strategy(cfg: RunConfig) -> Strategy:
    """Resolve cfg.constrainer (reference CONSTRAINER env, sample.py:131)."""
    name = cfg.constrainer.upper()
    if name == "MLFRIENDS":
        return make_mlfriends(cfg)
    if name == "RADFRIENDS":
        return make_mlfriends(cfg, norm="euclidean", metriclearner="none")
    if name == "SUPFRIENDS":
        return make_mlfriends(cfg, norm="chebyshev", metriclearner="none")
    if name == "MULTIELLIPSOIDS":
        return make_multiellipsoids(cfg)
    if name == "SLICE":
        return make_slice(cfg, direction=cfg.slice_direction)
    if name in ("GALILEAN", "MCMC"):
        return make_galilean(cfg)
    raise ValueError(f"unknown constrainer {cfg.constrainer!r}")
