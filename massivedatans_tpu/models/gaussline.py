"""Gaussian emission-line model over many spectra.

Reference: ``sample.py:44-108`` (3-parameter line fit) and its C kernel
``clike.c:34-89``, which evaluates one model curve and accumulates chi^2
against all masked datasets.

Batched form: for a batch of B parameter vectors, predict ``ypred[B, nx]``
once, then score against all D spectra via

    chi2[b, d] = (||ypred_b||^2 - 2 ypred_b . y_d + ||y_d||^2) / noise^2

so the D-fan-out — the entire point of collaborative nested sampling — is a
single ``[B, nx] @ [nx, D]`` matmul.

Precision note (why there is no bf16 fast path): nested sampling orders
candidates by logL, so chi^2 needs absolute accuracy ~0.1 on a magnitude
of ~2*nx (hundreds) — a relative accuracy of ~5e-4, i.e. >= 11 mantissa
bits on the matmul *inputs*. bf16's 8-bit mantissa rounds y/ypred at 0.4%,
which propagates to O(10-100) logL errors through the 1/noise^2 = 1e4
amplification; f32 accumulation cannot repair input rounding. TF32 (10-bit
mantissa, a GPU's DEFAULT f32 matmul precision) is as coarse. The matmul
therefore stays f32 with ``Precision.HIGHEST``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from massivedatans_tpu.models.base import Problem


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GaussLineData:
    x: Any       # [nx] wavelength grid
    y: Any       # [nx, D] spectra
    ysq: Any     # [D] = sum_j y[j, d]^2, precomputed in float64 on host
    noise_level: Any  # scalar


def gaussline_prior_transform(u):
    """Reference ``priortransform`` (sample.py:52-58): A, mu, log10(sigma)."""
    A = 10.0 ** (u[0] * 2.0 - 2.0)
    mu = u[1] * 400.0 + 400.0
    log_sig = u[2] * 2.0
    return jnp.stack([A, mu, log_sig])


def gaussline_predict(x_grid, params):
    """One model curve (sample.py:64-68): ``A * exp(-((mu - x)/sig)^2 / 2)``."""
    A, mu, log_sig = params[0], params[1], params[2]
    sig = 10.0 ** log_sig
    return A * jnp.exp(-0.5 * jnp.square((mu - x_grid) / sig))


def chi2_loglike_batch(data: GaussLineData, x_batch):
    """``L[B, D]`` for all datasets at once as one matmul (replaces
    clike.c)."""
    ypred = jax.vmap(lambda p: gaussline_predict(data.x, p))(x_batch)  # [B, nx]
    cross = jnp.dot(
        ypred, data.y,
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )  # [B, D]
    ssp = jnp.sum(jnp.square(ypred), axis=1)  # [B]
    chi2 = ssp[:, None] - 2.0 * cross + data.ysq[None, :]
    inv_var = 1.0 / jnp.square(data.noise_level)
    return -0.5 * chi2 * inv_var


def chi2_loglike_batch_mp(data: GaussLineData, x_batch, axis_name):
    """Model-parallel ``L[B, D]``: the wavelength grid ``x`` and spectra
    ``y`` are sharded over mesh axis ``axis_name`` (the SP/CP analog);
    each shard contracts its local nx slice and the partial
    ``||ypred||^2 - 2 ypred . y`` terms are psum-reduced. ``ysq`` holds the
    full-spectrum sums (host float64) and is applied once after the psum."""
    ypred = jax.vmap(lambda p: gaussline_predict(data.x, p))(x_batch)
    cross = jnp.dot(
        ypred, data.y,
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    ssp = jnp.sum(jnp.square(ypred), axis=1)
    part = ssp[:, None] - 2.0 * cross  # [B, D] local partial
    chi2 = jax.lax.psum(part, axis_name) + data.ysq[None, :]
    return -0.5 * chi2 / jnp.square(data.noise_level)


def chi2_loglike_paired(data: GaussLineData, x):
    """``L[d]`` of dataset d under its own parameter vector ``x[d]`` —
    O(D * nx) (one curve per dataset), for the gradient backends (infer/)."""
    ypred = jax.vmap(lambda p: gaussline_predict(data.x, p))(x)  # [D, nx]
    cross = jnp.einsum(
        "dn,nd->d", ypred, data.y, precision=jax.lax.Precision.HIGHEST
    )
    ssp = jnp.sum(jnp.square(ypred), axis=1)
    chi2 = ssp - 2.0 * cross + data.ysq
    return -0.5 * chi2 / jnp.square(data.noise_level)


def gaussline_predict_one(data: GaussLineData, params):
    """One model curve on the data grid (for best-fit plots)."""
    return gaussline_predict(data.x, params)


def make_gaussline_problem(x_grid, y, noise_level=0.01) -> Problem:
    """Build the line-fit problem from a ``[nx]`` grid and ``[nx, D]`` spectra."""
    import numpy as np

    x_grid = np.asarray(x_grid, dtype=np.float64)
    y64 = np.asarray(y, dtype=np.float64)
    nx, ndata = y64.shape
    data = GaussLineData(
        x=jnp.asarray(x_grid, dtype=jnp.float32),
        y=jnp.asarray(y64, dtype=jnp.float32),
        ysq=jnp.asarray((y64 ** 2).sum(axis=0), dtype=jnp.float32),
        noise_level=jnp.float32(noise_level),
    )
    return Problem(
        data=data,
        prior_transform=gaussline_prior_transform,
        loglike_batch=chi2_loglike_batch,
        ndim=3,
        ndata=ndata,
        name="gaussline",
        loglike_paired_fn=chi2_loglike_paired,
        loglike_mp_fn=chi2_loglike_batch_mp,
        predict_fn=gaussline_predict_one,
    )


def _gaussline_model_pspecs(data, data_axis, model_axis):
    """Spectral-axis sharding layout under a (data, model) mesh."""
    from jax.sharding import PartitionSpec as P

    return GaussLineData(
        x=P(model_axis),
        y=P(model_axis, data_axis),
        ysq=P(data_axis),
        noise_level=P(),
    )


from massivedatans_tpu.models.base import MODEL_PSPEC_REGISTRY  # noqa: E402

MODEL_PSPEC_REGISTRY[GaussLineData] = _gaussline_model_pspecs
