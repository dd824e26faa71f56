"""Float64 reference checks of the likelihood and region reductions.

Each check runs the package's jitted f32 function on the default JAX device
at the widths the sampler uses, recomputes the same quantity in float64
numpy from the same inputs, and returns a dict of errors with ``ok`` set
against the tolerance stated below. ``chip_smoke.py`` calls them on the GPU;
``tests/test_refcheck.py`` calls them on the CPU at the same widths.

Tolerances and why:

- logL (both likelihoods): ``|dL| <= 0.1 + 1e-5 S``, where ``S`` is half
  the sum of the magnitudes of the terms that the expanded chi^2 cancels
  (``||m||^2``, ``2 m.y``, ``||y||^2`` over the noise variance). Nested
  sampling orders candidates by logL, so near the likelihood contour an
  absolute error of ~0.1 is what the sampler can afford
  (``models/gaussline.py`` module note). The f32 expanded form cannot do
  better than a few f32 ulps of ``S`` times the square root of the
  contraction length (nx=200, nspec=3600: 1e-6 to 4e-6 of ``S``), which
  for bright MUSE spaxels (``S`` ~ 1e7) is tens in logL on any device;
  1e-5 covers that with margin.
- squared radius: ``rtol 1e-4`` — the f32 expanded-distance form
  (``region.pairwise_sqdist``) loses ~|w|^2 eps to cancellation.
- MUSE synthesis: ``1e-4`` of each spectrum's peak; the f32 log-space
  star-formation weights and the 110-age contraction keep ~1e-5.
- membership counts: a point may differ only by the number of its member
  pairs whose distance lies within 1e-4 of the radius (f32 rounding can put
  those on either side of the strict ``<``).

Every product runs at ``Precision.HIGHEST``: on the GPU that is full f32,
where ``DEFAULT`` would be TF32 (10-bit mantissa).
"""

from __future__ import annotations

import tempfile

import numpy as np

import jax
import jax.numpy as jnp

LOGL_ATOL = 0.1
LOGL_RTOL = 1e-5
RADIUS_RTOL = 1e-4
BOUNDARY_EPS = 1e-4
SYNTH_RTOL = 1e-4


def _logl_errors(got, want, scale):
    got = np.asarray(got, np.float64)
    err = np.abs(got - want)
    bound = LOGL_ATOL + LOGL_RTOL * scale
    return dict(
        max_abs_err=float(err.max()),
        max_err_over_scale=float((err / scale).max()),
        worst_err_over_bound=float((err / bound).max()),
        ok=bool(np.all(np.isfinite(got)) and np.all(err <= bound)),
    )


def _horns_candidates(data, B, rng):
    """B parameter vectors: half drawn from the prior, half at datasets'
    true line parameters, so both far and near-contour logL are covered."""
    from massivedatans_tpu.models.gaussline import gaussline_prior_transform

    u = rng.uniform(size=(B, 3)).astype(np.float32)
    x = np.array(jax.vmap(gaussline_prior_transform)(jnp.asarray(u)))
    n_true = min(B // 2, len(data["height_narrow"]))
    x[:n_true, 0] = data["height_narrow"][:n_true]
    x[:n_true, 1] = data["mean_narrow"][:n_true]
    x[:n_true, 2] = np.log10(data["width_narrow"][:n_true])
    return x.astype(np.float32)


def check_gaussline(B: int, D: int, seed: int = 0) -> dict:
    """``gaussline.chi2_loglike_batch`` on the horns grid (nx=200) at batch B
    against D spectra, vs float64 numpy. Also reports, for information, the
    error the same product gives at ``Precision.DEFAULT``."""
    from massivedatans_tpu.datagen.generators import gen_horns
    from massivedatans_tpu.models import gaussline

    data = gen_horns(D)
    problem = gaussline.make_gaussline_problem(
        data["x"], data["y"], data["noise_level"])
    x = _horns_candidates(data, B, np.random.default_rng(seed))
    got = jax.jit(gaussline.chi2_loglike_batch)(problem.data, jnp.asarray(x))

    x64 = x.astype(np.float64)
    grid = np.asarray(problem.data.x, np.float64)
    ypred = x64[:, 0:1] * np.exp(
        -0.5 * ((x64[:, 1:2] - grid[None, :]) / 10.0 ** x64[:, 2:3]) ** 2)
    y64 = np.asarray(problem.data.y, np.float64)
    ssp, cross = (ypred ** 2).sum(axis=1)[:, None], ypred @ y64
    ysq = (y64 ** 2).sum(axis=0)[None, :]
    inv_var = 1.0 / float(problem.data.noise_level) ** 2
    want = -0.5 * (ssp - 2.0 * cross + ysq) * inv_var
    scale = 0.5 * (ssp + 2.0 * np.abs(cross) + ysq) * inv_var
    out = dict(check="gaussline", B=B, D=D, nx=int(grid.shape[0]),
               **_logl_errors(got, want, scale))

    def default_precision(d, xb):
        ypred = jax.vmap(lambda p: gaussline.gaussline_predict(d.x, p))(xb)
        cross = jnp.dot(ypred, d.y, precision=jax.lax.Precision.DEFAULT)
        chi2 = jnp.sum(jnp.square(ypred), axis=1)[:, None] - 2.0 * cross \
            + d.ysq[None, :]
        return -0.5 * chi2 / jnp.square(d.noise_level)

    got_default = jax.jit(default_precision)(problem.data, jnp.asarray(x))
    out["default_precision_max_abs_err"] = float(
        np.abs(np.asarray(got_default, np.float64) - want).max())
    return out


def check_region(M: int, N: int, ndim: int = 3, nbootstraps: int = 10,
                 seed: int = 0) -> dict:
    """``region.count_within`` and the bootstrapped squared radius at member
    capacity M with N proposals, vs float64 numpy on the same members,
    in-bag draws and radius."""
    from scipy.spatial.distance import cdist

    from massivedatans_tpu.ns import region as region_lib

    rng = np.random.default_rng(seed)
    n_valid = M - M // 8  # a padded member set, as the engine builds it
    members_u = rng.normal(0.5, 0.05, size=(M, ndim)).astype(np.float32)
    mask = np.arange(M) < n_valid
    key = jax.random.key(seed)
    reg = jax.jit(lambda m, k: region_lib.build_region(
        m, jnp.asarray(mask), k, nbootstraps=nbootstraps))(
            jnp.asarray(members_u), key)
    w = np.asarray(reg.members_w, np.float64)
    inbag = np.asarray(region_lib.bootstrap_inbag_rounds(
        jnp.asarray(mask), key, nbootstraps))

    d2 = cdist(w, w, "sqeuclidean")
    want_r2 = 0.0
    for b in range(nbootstraps):
        oob = mask & ~inbag[b]
        if oob.any() and inbag[b].any():
            want_r2 = max(want_r2, d2[np.ix_(oob, inbag[b])].min(axis=1).max())
    got_r2 = float(reg.radius) ** 2
    r2_rel = abs(got_r2 - want_r2) / want_r2

    # proposals around the members and across the whitened bounding box
    lo, hi = np.asarray(reg.lo), np.asarray(reg.hi)
    pts = rng.uniform(lo, hi, size=(N, ndim)).astype(np.float32)
    got_n = np.asarray(jax.jit(region_lib.count_within)(reg, jnp.asarray(pts)))
    r = float(reg.radius)
    d = cdist(pts.astype(np.float64), w[mask])
    want_n = (d < r).sum(axis=1)
    boundary = (np.abs(d - r) < BOUNDARY_EPS * r).sum(axis=1)
    miss = np.abs(got_n - want_n)
    return dict(
        check="region", M=M, N=N, ndim=ndim, nbootstraps=nbootstraps,
        sq_radius=got_r2, sq_radius_rel_err=r2_rel,
        count_mismatches=int((miss > 0).sum()),
        count_mismatches_beyond_boundary=int((miss > boundary).sum()),
        mean_count=float(want_n.mean()),
        ok=bool(r2_rel <= RADIUS_RTOL and (miss <= boundary).all()),
    )


def _muse_predict_f64(md, x):
    """Float64 numpy synthesis of ``muse.model.predict_batch`` (FULL model)
    on ``md``'s own (f32) grids: SFH weights, template contraction at the
    candidate's metallicity, normalisation, Calzetti extinction, linear
    interpolation onto the redshifted data grid."""
    f = lambda a: np.asarray(a, np.float64)  # noqa: E731
    zg, ages, aw = f(md.z_grid), f(md.ages), f(md.age_weight)
    templates, model_wl = f(md.templates), f(md.model_wl)
    Z, logtau, sfage, z, ebv = (f(x)[:, i] for i in range(5))
    iz = np.clip(np.searchsorted(zg, Z, side="right") - 1, 0, len(zg) - 1)
    tsince = np.maximum(sfage[:, None] * 1e9 - ages[None, :], 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        log_sfh = np.where(tsince > 0.0,
                           np.log(np.maximum(tsince, 1e-30)), -np.inf)
        log_sfh = log_sfh - tsince / 10.0 ** logtau[:, None]
        sfh = np.exp(log_sfh - log_sfh.max(axis=1, keepdims=True))
    sfh = np.where(np.isfinite(sfh), sfh, 0.0)
    w = sfh[:, :-1] * aw[None, :]
    template = np.einsum("ba,baw->bw", w, templates[iz][:, :-1, :])
    template = template / (1e-10 + template[:, int(md.norm_index)][:, None])
    template = template * 10.0 ** (-2.5 * f(md.calzetti)[None, :]
                                   * ebv[:, None])
    q = f(md.data_wl)[None, :] / (1.0 + z)[:, None]
    return np.stack([np.interp(q[b], model_wl, template[b])
                     for b in range(len(z))])


def _muse_loglike_f64(ypred, y, var):
    """Scale-marginalised logL (cmuselike.c:34-66) in float64, with the same
    unit-max candidate scaling as ``muse.likelihood``; returns ``(logL,
    S)`` with ``S = (yy + s1^2/s2) / 2`` the cancelled magnitude."""
    norm = np.abs(ypred).max(axis=1, keepdims=True)
    m = ypred / np.where(norm > 0.0, norm, 1.0)
    inv_v = 1.0 / var
    s1 = m @ (y * inv_v)
    s2 = (m ** 2) @ inv_v + 1e-10
    yy = (y ** 2 * inv_v).sum(axis=0)[None, :]
    dead = np.all(ypred == 0.0, axis=1)
    logl = np.where(dead[:, None], -1e100, -0.5 * (yy - s1 ** 2 / s2))
    return logl, 0.5 * (yy + s1 ** 2 / s2)


def muse_problem(nspec: int, D: int, seed: int = 3, noise: float = 0.05):
    """MUSE problem at ``nspec`` MUSE-native bins (1.25 A from 4750 A) over
    ``D`` model-family spaxels from synthetic templates. Returns
    ``(problem, y, var, theta)``."""
    from massivedatans_tpu.muse.likelihood import make_muse_problem
    from massivedatans_tpu.muse.model import load_template_grid
    from massivedatans_tpu.muse.synth import (
        make_model_spectra, make_template_files,
    )

    wl_nm = (4750.0 + 1.25 * np.arange(nspec)) / 10.0
    with tempfile.TemporaryDirectory() as td:
        md = load_template_grid(make_template_files(td), data_wl_nm=wl_nm,
                                zlo=0.0, zhi=0.5)
    y, theta, _, _ = make_model_spectra(md, D, seed=seed, noise=noise)
    var = np.full_like(y, noise ** 2)
    return make_muse_problem(md, y, var), y, var, theta


def check_muse(nspec: int, B: int, D: int, seed: int = 0) -> dict:
    """``muse.likelihood.scaled_loglike_batch`` at ``nspec`` bins, batch B,
    D spaxels, vs float64 numpy synthesis and likelihood. The synthesised
    spectra are also compared alone (``synth_max_rel_err``, per spectrum
    relative to its peak; bound ``SYNTH_RTOL``)."""
    from massivedatans_tpu.muse.likelihood import scaled_loglike_batch
    from massivedatans_tpu.muse.model import muse_prior_transform, predict_batch

    problem, y, var, theta = muse_problem(nspec, D)
    md = problem.data.md
    rng = np.random.default_rng(seed)
    u = jnp.asarray(rng.uniform(size=(B, 5)), jnp.float32)
    x = np.array(jax.vmap(lambda ui: muse_prior_transform(md, ui))(u))
    n_true = min(B // 2, D)
    x[:n_true] = theta[:n_true]
    got = jax.jit(scaled_loglike_batch)(problem.data, jnp.asarray(x))
    ypred = _muse_predict_f64(md, x)
    want, scale = _muse_loglike_f64(ypred, y.astype(np.float64),
                                    var.astype(np.float64))
    got_pred = np.asarray(jax.jit(predict_batch)(md, jnp.asarray(x)),
                          np.float64)
    synth_err = float((np.abs(got_pred - ypred).max(axis=1)
                       / np.abs(ypred).max(axis=1)).max())
    out = dict(check="muse", nspec=nspec, B=B, D=D,
               synth_max_rel_err=synth_err, **_logl_errors(got, want, scale))
    out["ok"] = out["ok"] and synth_err <= SYNTH_RTOL
    return out
