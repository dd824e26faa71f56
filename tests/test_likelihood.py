"""Likelihood-kernel equivalence tests.

The reference validates its C likelihood against a pure-Python version by
eye/commented asserts (sample.py:64-112, musefuse.py:544-574). Here the
matmul form is checked against a float64 numpy direct-difference oracle.
"""

import numpy as np
import jax.numpy as jnp

from massivedatans_tpu.models.gaussline import (
    make_gaussline_problem,
    gaussline_prior_transform,
)
from massivedatans_tpu.models.analytic import (
    make_analytic_gaussian_problem,
    true_logZ,
)


def _oracle_gaussline(x, y, noise, params):
    """Reference multi_loglikelihood (sample.py:64-71) in float64."""
    A, mu, log_sig = params
    sig = 10.0 ** log_sig
    ypred = A * np.exp(-0.5 * ((mu - x) / sig) ** 2)
    return -0.5 * (((ypred.reshape(-1, 1) - y) / noise) ** 2).sum(axis=0)


def test_gaussline_matches_numpy_oracle():
    rng = np.random.default_rng(0)
    nx, D, B = 200, 64, 16
    x = np.linspace(400, 800, nx)
    y = rng.normal(0, 0.01, size=(nx, D))
    y[:, : D // 2] += 0.5 * np.exp(-0.5 * ((x[:, None] - 650) / 5.0) ** 2)
    problem = make_gaussline_problem(x, y, noise_level=0.01)

    u = rng.uniform(size=(B, 3))
    xb = np.asarray(problem.transform_batch(jnp.asarray(u, jnp.float32)))
    L = np.asarray(problem.loglike(jnp.asarray(xb)))
    for b in range(B):
        expected = _oracle_gaussline(x, y, 0.01, xb[b].astype(np.float64))
        # absolute tolerance driven by f32 cancellation in the matmul form
        assert np.allclose(L[b], expected, rtol=1e-4, atol=0.15), (
            b, np.abs(L[b] - expected).max())


def test_gaussline_prior_transform():
    u = jnp.asarray([0.5, 0.5, 0.5])
    x = np.asarray(gaussline_prior_transform(u))
    assert np.isclose(x[0], 10 ** (0.5 * 2 - 2))
    assert np.isclose(x[1], 0.5 * 400 + 400)
    assert np.isclose(x[2], 1.0)


def test_analytic_gaussian_loglike_and_logZ():
    rng = np.random.default_rng(1)
    D, ndim, B = 8, 3, 32
    centers = rng.uniform(0.3, 0.7, size=(D, ndim))
    problem = make_analytic_gaussian_problem(centers, sigma=0.05)
    xb = rng.uniform(size=(B, ndim)).astype(np.float32)
    L = np.asarray(problem.loglike(jnp.asarray(xb)))
    d2 = ((xb[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    expected = -0.5 * d2 / 0.05 ** 2
    assert np.allclose(L, expected, rtol=1e-4, atol=1e-2)

    # closed-form evidence sanity: well-centered narrow Gaussian
    lz = true_logZ(np.full((1, 2), 0.5), sigma=0.01)
    assert np.isclose(lz[0], 2 * np.log(0.01 * np.sqrt(2 * np.pi)), atol=1e-6)
