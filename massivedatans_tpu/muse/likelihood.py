"""Scale-marginalized spectral likelihood as batched matmuls.

Reference ``cmuselike.c:34-66`` computes, per dataset, the LePhare-style
best-fit amplitude ``s = sum(y*m/var) / sum(m^2/var)`` and then
``-chi^2/2``. For a batch of B model spectra against D spaxels this is three
matmuls:

    s1[b,d] = ypred[b] . (y/var)[:, d]
    s2[b,d] = ypred^2[b] . (1/var)[:, d]
    chi2[b,d] = yy[d] - 2 s s1 + s^2 s2,  s = s1/(s2 + 1e-10)

NaN spaxels (the reference's nansum, musefuse.py:379-382) are handled by
zeroing their weights in the precomputed (y/var), (1/var), yy arrays.

f32 underflow guard: the chi^2 is exactly invariant under a per-candidate
rescaling m -> c*m (s1 -> c*s1, s2 -> c^2*s2, the best-fit scale absorbs
c), but the raw template amplitudes are NOT safe to square in f32 — a
high-EBV candidate's Calzetti factor drives m to ~1e-20 and m^2 ~ 1e-40
flushes to zero, collapsing the likelihood to the no-star branch and
silently erasing the high-extinction corner of the prior (the reference
computes in C doubles, cmuselike.c:48-64, and never sees this). Every
entry point therefore normalizes each candidate spectrum by its max |m|
before the matmuls — bitwise harmless for well-scaled templates, exact by
the scale invariance for everything else.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp

from massivedatans_tpu.models.base import Problem
from massivedatans_tpu.muse.model import (
    MuseModelData,
    muse_prior_transform,
    muse_prior_transform_zsol,
    predict_batch,
)

_PREC = jax.lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MuseLikeData:
    md: MuseModelData
    y_over_v: Any   # [nspec, D] f32, zeroed where masked
    inv_v: Any      # [nspec, D]
    yy: Any         # [D] = sum y^2/var over valid spaxels
    zsol: bool = dataclasses.field(default=False, metadata=dict(static=True))


def _unit_scale(ypred, axis=1):
    """Rescale each candidate spectrum to max |m| = 1 (see module note:
    the profiled-scale chi^2 is invariant; this prevents f32 m^2 underflow
    for high-extinction candidates). All-zero rows pass through unchanged
    (the dead guard catches them)."""
    norm = jnp.max(jnp.abs(ypred), axis=axis, keepdims=True)
    return ypred / jnp.where(norm > 0.0, norm, 1.0)


def scaled_loglike_batch(data: MuseLikeData, x_batch):
    ypred = predict_batch(data.md, x_batch, zsol=data.zsol)  # [B, nspec]
    dead = jnp.all(ypred == 0.0, axis=1)
    ypred = _unit_scale(ypred)
    s1 = jnp.dot(ypred, data.y_over_v, precision=_PREC,
                 preferred_element_type=jnp.float32)
    s2 = jnp.dot(jnp.square(ypred), data.inv_v, precision=_PREC,
                 preferred_element_type=jnp.float32) + 1e-10
    s = s1 / s2
    chi2 = data.yy[None, :] - 2.0 * s * s1 + jnp.square(s) * s2
    L = -0.5 * chi2
    # "no stars" guard (musefuse.py:363-366): all-zero model -> -1e100
    return jnp.where(dead[:, None], -1e100, L)


def scaled_loglike_batch_mp(data: MuseLikeData, x_batch, axis_name):
    """Model-parallel scale-marginalized likelihood: ``y_over_v``/``inv_v``
    are sharded on the spectral axis over mesh axis ``axis_name`` (the SP/CP
    analog — MUSE's nx=3600 is the long axis, survey §5). Template synthesis
    is cheap and runs replicated; each shard contracts its local wavelength
    slice and the inner products ``s1``/``s2`` are psum-reduced before the
    nonlinear best-fit-scale combination."""
    ypred_full = predict_batch(data.md, x_batch, zsol=data.zsol)  # [B, nspec]
    dead = jnp.all(ypred_full == 0.0, axis=1)
    # normalize on the FULL spectrum (replicated synthesis) so every shard
    # applies the identical scale
    ypred_full = _unit_scale(ypred_full)
    nloc = data.y_over_v.shape[0]
    i = jax.lax.axis_index(axis_name)
    ypred = jax.lax.dynamic_slice_in_dim(ypred_full, i * nloc, nloc, axis=1)
    s1p = jnp.dot(ypred, data.y_over_v, precision=_PREC,
                  preferred_element_type=jnp.float32)
    s2p = jnp.dot(jnp.square(ypred), data.inv_v, precision=_PREC,
                  preferred_element_type=jnp.float32)
    s1, s2 = jax.lax.psum((s1p, s2p), axis_name)
    s2 = s2 + 1e-10
    s = s1 / s2
    chi2 = data.yy[None, :] - 2.0 * s * s1 + jnp.square(s) * s2
    return jnp.where(dead[:, None], -1e100, -0.5 * chi2)


def scaled_loglike_paired(data: MuseLikeData, x):
    """``L[d]`` of spaxel d under its own parameter vector ``x[d]`` —
    O(D * nspec) (one synthesis + reduction per spaxel), for the gradient
    backends (infer/)."""
    ypred = predict_batch(data.md, x, zsol=data.zsol)  # [D, nspec]
    dead = jnp.all(ypred == 0.0, axis=1)
    ypred = _unit_scale(ypred)
    s1 = jnp.einsum("dn,nd->d", ypred, data.y_over_v, precision=_PREC)
    s2 = jnp.einsum("dn,nd->d", jnp.square(ypred), data.inv_v,
                    precision=_PREC) + 1e-10
    s = s1 / s2
    chi2 = data.yy - 2.0 * s * s1 + jnp.square(s) * s2
    return jnp.where(dead, -1e100, -0.5 * chi2)


def scaled_predict_one(data: MuseLikeData, params):
    """One (unscaled) template spectrum on the data grid; the best-fit
    amplitude against a given spaxel is ``s = s1/s2`` (cmuselike.c:48-64),
    applied by the plotting layer."""
    return predict_batch(data.md, params[None, :], zsol=data.zsol)[0]


def make_muse_problem(md: MuseModelData, y, var, zsol: bool = False,
                      name: str = "muse") -> Problem:
    """Build the MUSE Problem from [nspec, D] flux and variance arrays."""
    y64 = np.asarray(y, np.float64)
    v64 = np.asarray(var, np.float64)
    valid = np.isfinite(y64) & np.isfinite(v64) & (v64 > 0)
    inv_v = np.where(valid, 1.0 / v64, 0.0)
    y_over_v = np.where(valid, y64 * inv_v, 0.0)
    yy = np.where(valid, y64 ** 2 * inv_v, 0.0).sum(axis=0)
    data = MuseLikeData(
        md=md,
        y_over_v=jnp.asarray(y_over_v, jnp.float32),
        inv_v=jnp.asarray(inv_v, jnp.float32),
        yy=jnp.asarray(yy, jnp.float32),
        zsol=zsol,
    )

    if zsol:
        def prior(u, _md=md):
            return muse_prior_transform_zsol(_md, u)
        ndim = 4
    else:
        def prior(u, _md=md):
            return muse_prior_transform(_md, u)
        ndim = 5

    return Problem(
        data=data,
        prior_transform=prior,
        loglike_batch=scaled_loglike_batch,
        ndim=ndim,
        ndata=int(y64.shape[1]),
        name=name,
        loglike_paired_fn=scaled_loglike_paired,
        loglike_mp_fn=scaled_loglike_batch_mp,
        predict_fn=scaled_predict_one,
    )


def _muse_model_pspecs(data: MuseLikeData, data_axis, model_axis):
    """Spectral-axis sharding layout: only the [nspec, D] data products are
    sharded on nspec; the template grids (md) stay replicated because
    synthesis (redshift interpolation) needs the full wavelength axis."""
    from jax.sharding import PartitionSpec as P

    return MuseLikeData(
        md=jax.tree.map(lambda _: P(), data.md),
        y_over_v=P(model_axis, data_axis),
        inv_v=P(model_axis, data_axis),
        yy=P(data_axis),
        zsol=data.zsol,
    )


from massivedatans_tpu.models.base import MODEL_PSPEC_REGISTRY  # noqa: E402

MODEL_PSPEC_REGISTRY[MuseLikeData] = _muse_model_pspecs
