"""MUSE stellar-population model, jittable and batch-first.

Re-design of the reference model (``musefuse.py:160-346``): a 5-parameter
(Z, logSFtau, SFage, z, EBV) delayed-exponential star-formation-history
synthesis over a metallicity/age template grid, Calzetti extinction, and a
redshift interpolation onto the instrument wavelength grid.

Batched translation (survey §7):
- the per-metallicity template list becomes one dense tensor
  ``templates[nZ, n_ages, n_wl]`` gathered by a data-dependent index,
- the SFH weighting is a batched matvec ``sfh @ templates[iZ]``,
- ``numpy.interp`` onto the shifted grid becomes ``jnp.interp`` (jittable),
- NaN handling moves into precomputed masks (likelihood side).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp

# The published BC03 age grid (years), exactly as hardcoded by the reference
# (musefuse.py:190). The reference takes every second entry (``[::2]``);
# template files must carry one column per subsampled age.
REFERENCE_AGES = np.array([
    0.000E+00, 1.000E+05, 1.412E+05, 1.585E+05, 1.778E+05, 1.995E+05,
    2.239E+05, 2.512E+05, 2.818E+05, 3.162E+05, 3.548E+05, 3.981E+05,
    4.467E+05, 5.012E+05, 5.623E+05, 6.310E+05, 7.080E+05, 7.943E+05,
    8.913E+05, 1.000E+06, 1.047E+06, 1.096E+06, 1.148E+06, 1.202E+06,
    1.259E+06, 1.318E+06, 1.380E+06, 1.445E+06, 1.514E+06, 1.585E+06,
    1.660E+06, 1.738E+06, 1.820E+06, 1.906E+06, 1.995E+06, 2.089E+06,
    2.188E+06, 2.291E+06, 2.399E+06, 2.512E+06, 2.630E+06, 2.754E+06,
    2.884E+06, 3.020E+06, 3.162E+06, 3.311E+06, 3.467E+06, 3.631E+06,
    3.802E+06, 3.981E+06, 4.169E+06, 4.365E+06, 4.571E+06, 4.786E+06,
    5.012E+06, 5.248E+06, 5.495E+06, 5.754E+06, 6.026E+06, 6.310E+06,
    6.607E+06, 6.918E+06, 7.244E+06, 7.586E+06, 7.943E+06, 8.318E+06,
    8.710E+06, 9.120E+06, 9.550E+06, 1.000E+07, 1.047E+07, 1.096E+07,
    1.148E+07, 1.202E+07, 1.259E+07, 1.318E+07, 1.380E+07, 1.445E+07,
    1.514E+07, 1.585E+07, 1.660E+07, 1.738E+07, 1.820E+07, 1.906E+07,
    1.995E+07, 2.089E+07, 2.188E+07, 2.291E+07, 2.399E+07, 2.512E+07,
    2.630E+07, 2.754E+07, 2.900E+07, 3.000E+07, 3.100E+07, 3.200E+07,
    3.300E+07, 3.400E+07, 3.500E+07, 3.600E+07, 3.700E+07, 3.800E+07,
    3.900E+07, 4.000E+07, 4.250E+07, 4.500E+07, 4.750E+07, 5.000E+07,
    5.250E+07, 5.500E+07, 5.709E+07, 6.405E+07, 7.187E+07, 8.064E+07,
    9.048E+07, 1.015E+08, 1.139E+08, 1.278E+08, 1.434E+08, 1.609E+08,
    1.805E+08, 2.026E+08, 2.273E+08, 2.550E+08, 2.861E+08, 3.210E+08,
    3.602E+08, 4.042E+08, 4.535E+08, 5.088E+08, 5.709E+08, 6.405E+08,
    7.187E+08, 8.064E+08, 9.048E+08, 1.015E+09, 1.139E+09, 1.278E+09,
    1.434E+09, 1.609E+09, 1.680E+09, 1.700E+09, 1.800E+09, 1.900E+09,
    2.000E+09, 2.100E+09, 2.200E+09, 2.300E+09, 2.400E+09, 2.500E+09,
    2.600E+09, 2.750E+09, 3.000E+09, 3.250E+09, 3.500E+09, 3.750E+09,
    4.000E+09, 4.250E+09, 4.500E+09, 4.750E+09, 5.000E+09, 5.250E+09,
    5.500E+09, 5.750E+09, 6.000E+09, 6.250E+09, 6.500E+09, 6.750E+09,
    7.000E+09, 7.250E+09, 7.500E+09, 7.750E+09, 8.000E+09, 8.250E+09,
    8.500E+09, 8.750E+09, 9.000E+09, 9.250E+09, 9.500E+09, 9.750E+09,
    1.000E+10, 1.025E+10, 1.050E+10, 1.075E+10, 1.100E+10, 1.125E+10,
    1.150E+10, 1.175E+10, 1.200E+10, 1.225E+10, 1.250E+10, 1.275E+10,
    1.300E+10, 1.325E+10, 1.350E+10, 1.375E+10, 1.400E+10, 1.425E+10,
    1.450E+10, 1.475E+10, 1.500E+10, 1.525E+10, 1.550E+10, 1.575E+10,
    1.600E+10, 1.625E+10, 1.650E+10, 1.675E+10, 1.700E+10, 1.725E+10,
    1.750E+10, 1.775E+10, 1.800E+10, 1.825E+10, 1.850E+10, 1.875E+10,
    1.900E+10, 1.925E+10, 1.950E+10, 1.975E+10, 2.000E+10,
])


def default_age_grid() -> np.ndarray:
    """The reference's full age list (before its ``[::2]`` subsampling)."""
    return REFERENCE_AGES.copy()


_Z_GRID = np.log10([0.0001, 0.0004, 0.004, 0.008, 0.02, 0.05, 0.1])
_SFTAU_GRID = np.log10(np.array([1, 4, 10, 40, 100, 400, 1000, 4000]) * 1e6)
_SFAGE_MAX = 13.0


def calzetti_curve(wavelength_nm: np.ndarray) -> np.ndarray:
    """Calzetti (2000) attenuation k(lambda) (musefuse.py:257-266)."""
    wl = np.asarray(wavelength_nm, np.float64)
    out = np.zeros_like(wl)
    blue = wl < 630.0
    out[blue] = 2.659 * (
        -2.156 + 1.509e3 / wl[blue] - 0.198e6 / wl[blue] ** 2
        + 0.011e9 / wl[blue] ** 3
    ) + 4.05
    red = ~blue
    out[red] = 2.659 * (-1.857 + 1.040e3 / wl[red]) + 4.05
    return out


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MuseModelData:
    templates: Any      # [nZ, n_ages, n_wl] f32
    ages: Any           # [n_ages] f32 (years)
    age_weight: Any     # [n_ages - 1] f32
    model_wl: Any       # [n_wl] f32 (nm, ascending)
    calzetti: Any       # [n_wl] f32
    data_wl: Any        # [nspec] f32 (nm)
    z_grid: Any         # [nZ] log10 metallicities
    norm_index: Any     # scalar int32: normalization pixel on the model grid
    zlo: Any            # scalar: redshift prior bounds
    zhi: Any


def load_template_grid(filenames, ages=None, data_wl_nm=None,
                       zlo=0.0, zhi=0.5,
                       uniform_oversample: int = 2) -> MuseModelData:
    """Build the dense model tensor from per-metallicity template files
    (reference loadtxt loop, musefuse.py:173-179: column 0 = wavelength in
    Angstrom, columns 1.. = one spectrum per age).

    The library is resampled onto a UNIFORM wavelength grid
    (``uniform_oversample`` × the native point count, host-side numpy):
    ``predict_spectrum``'s redshift lookup then reduces to arithmetic
    indexing + two gathers instead of the searchsorted over a non-uniform
    grid that the general ``jnp.interp`` needs. 2× oversampling keeps the
    re-gridding error second-order and far below the instrument's LSF
    scale."""
    grids = []
    model_wl = None
    for fn in filenames:
        data = np.loadtxt(fn)
        model_wl = data[:, 0] / 10.0  # Angstrom -> nm (musefuse.py:255-256)
        grids.append(data[:, 1:].T)   # [n_ages, n_wl]
    templates = np.stack(grids)       # [nZ, n_ages, n_wl]
    if uniform_oversample:
        wl_u = np.linspace(model_wl[0], model_wl[-1],
                           uniform_oversample * len(model_wl))
        templates = np.stack([
            np.stack([np.interp(wl_u, model_wl, row) for row in g])
            for g in templates
        ])
        model_wl = wl_u
    else:
        # predict_spectrum/predict_batch index the model grid arithmetically
        # (pos = (q - wl0)/dwl) — only valid on a uniform grid. The native
        # BC03 grid is NOT uniform, so skipping the resample must fail
        # loudly rather than silently corrupt every interpolated spectrum.
        dwl = np.diff(model_wl)
        if not np.allclose(dwl, dwl[0], rtol=1e-4):
            raise ValueError(
                "uniform_oversample=0 requires an already-uniform template "
                f"wavelength grid (spacing varies {dwl.min():.4g}.."
                f"{dwl.max():.4g} nm); the redshift lookup uses arithmetic "
                "uniform-grid indexing and would return wrong spectra — "
                "leave uniform_oversample>=1 for non-uniform libraries"
            )
    n_ages = templates.shape[1]
    if ages is None:
        ages = REFERENCE_AGES[::2]  # musefuse.py:190
        if n_ages != len(ages):
            raise ValueError(
                f"template files carry {n_ages} age columns but the "
                f"reference BC03 grid (musefuse.py:190, [::2]) has "
                f"{len(ages)} entries; pass ages= / --ages-file with the "
                "grid matching your template library — silently guessing "
                "ages would mis-weight the SFH synthesis"
            )
    ages = np.asarray(ages, np.float64)
    if len(ages) != n_ages:
        raise ValueError(
            f"ages grid has {len(ages)} entries but template files carry "
            f"{n_ages} age columns"
        )
    # normalize near 656nm rest frame (reference index 2050 on its grid)
    norm_index = int(np.argmin(np.abs(model_wl - 656.0)))
    return MuseModelData(
        templates=jnp.asarray(templates, jnp.float32),
        ages=jnp.asarray(ages, jnp.float32),
        age_weight=jnp.asarray(np.diff(ages), jnp.float32),
        model_wl=jnp.asarray(model_wl, jnp.float32),
        calzetti=jnp.asarray(calzetti_curve(model_wl), jnp.float32),
        data_wl=jnp.asarray(
            np.asarray(data_wl_nm if data_wl_nm is not None else model_wl),
            jnp.float32,
        ),
        z_grid=jnp.asarray(_Z_GRID, jnp.float32),
        norm_index=jnp.int32(norm_index),
        zlo=jnp.float32(zlo),
        zhi=jnp.float32(zhi),
    )


def muse_prior_transform(md: MuseModelData, u):
    """FULL model prior (musefuse.py:490-500): Z, logSFtau, SFage, z, EBV."""
    zg, tg = md.z_grid, jnp.asarray(_SFTAU_GRID, jnp.float32)
    return jnp.stack([
        u[0] * (zg[-1] - zg[0]) + zg[0],
        u[1] * (tg[-1] - tg[0]) + tg[0],
        u[2] * _SFAGE_MAX,
        u[3] * (md.zhi - md.zlo) + md.zlo,
        u[4] * 2.0,
    ])


def muse_prior_transform_zsol(md: MuseModelData, u):
    """ZSOL model prior (musefuse.py:502-510): logSFtau, SFage, z, EBV."""
    tg = jnp.asarray(_SFTAU_GRID, jnp.float32)
    return jnp.stack([
        u[0] * (tg[-1] - tg[0]) + tg[0],
        u[1] * _SFAGE_MAX,
        u[2] * (md.zhi - md.zlo) + md.zlo,
        u[3] * 2.0,
    ])


def predict_spectrum(md: MuseModelData, Z, logSFtau, sfage, z, EBV):
    """One model spectrum on the data wavelength grid (musefuse.py:268-346)."""
    # metallicity bin: largest grid Z <= Z (reference iZ selection, :224)
    iZ = jnp.clip(
        jnp.searchsorted(md.z_grid, Z, side="right") - 1, 0,
        md.z_grid.shape[0] - 1,
    )
    model_templates = md.templates[iZ]  # [n_ages, n_wl]

    SFtau = 10.0 ** logSFtau
    tsince = jnp.maximum(sfage * 1e9 - md.ages, 0.0)
    # sfh = t/tau^2 exp(-t/tau), normalized to max 1 (musefuse.py:237-239);
    # computed in log space so extreme sfage/tau corners do not underflow f32
    log_sfh = jnp.where(tsince > 0.0, jnp.log(jnp.maximum(tsince, 1e-30)),
                        -jnp.inf) - tsince / SFtau
    sfh = jnp.exp(log_sfh - jnp.max(log_sfh))
    sfh = jnp.where(jnp.isfinite(sfh), sfh, 0.0)

    w = sfh[:-1] * md.age_weight  # [n_ages - 1]
    template = jnp.dot(
        w, model_templates[:-1],
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )  # [n_wl] — matvec; HIGHEST: chi2 weights amplify model error
    template = template / (1e-10 + template[md.norm_index])
    template = template * 10.0 ** (-2.5 * md.calzetti * EBV)
    # redshift: sample the restframe model at data_wl / (1 + z). The model
    # grid is uniform (load_template_grid resamples it), so the lookup is
    # arithmetic indexing + two gathers, with no searchsorted over a
    # non-uniform grid. Edge behavior matches jnp.interp:
    # queries outside the grid clamp to the endpoint values.
    q = md.data_wl / (1.0 + z)
    n = md.model_wl.shape[0]
    wl0 = md.model_wl[0]
    dwl = (md.model_wl[n - 1] - wl0) / (n - 1)
    pos = jnp.clip((q - wl0) / dwl, 0.0, n - 1.0)
    i0 = jnp.minimum(pos.astype(jnp.int32), n - 2)
    frac = pos - i0.astype(pos.dtype)
    return template[i0] * (1.0 - frac) + template[i0 + 1] * frac


def _sfh_weights(md: MuseModelData, logSFtau, sfage):
    """[B, n_ages] delayed-exponential SFH weights (musefuse.py:237-251),
    max-normalized per candidate; the trailing age column is dropped by the
    synthesis contraction (predict_spectrum's ``[:-1]``)."""
    SFtau = 10.0 ** logSFtau                              # [B]
    tsince = jnp.maximum(sfage[:, None] * 1e9 - md.ages[None, :], 0.0)
    log_sfh = jnp.where(
        tsince > 0.0, jnp.log(jnp.maximum(tsince, 1e-30)), -jnp.inf
    ) - tsince / SFtau[:, None]
    sfh = jnp.exp(log_sfh - jnp.max(log_sfh, axis=1, keepdims=True))
    return jnp.where(jnp.isfinite(sfh), sfh, 0.0)


def predict_batch(md: MuseModelData, x_batch, zsol: bool = False):
    """[B, nspec] model spectra for a parameter batch.

    Batch-first synthesis: the metallicity selection is a one-hot
    contraction ``(ba,zaw->bzw) x (bz->bw)`` rather than a per-candidate
    ``templates[iZ]`` gather — the gather materializes a
    [B, n_ages, n_wl] block (~0.5 GB at B=512 on the 2× uniform grid)
    inside the fill-loop graph; the einsum keeps the peak at
    [B, nZ, n_wl] and is one matmul."""
    if zsol:
        # fixed Z = 0.004 (Patricio2018; musefuse.py:540-543)
        Zp = jnp.full((x_batch.shape[0],), np.log10(0.004), jnp.float32)
        logSFtau, sfage, z, EBV = (x_batch[:, 0], x_batch[:, 1],
                                   x_batch[:, 2], x_batch[:, 3])
    else:
        Zp, logSFtau, sfage, z, EBV = (x_batch[:, 0], x_batch[:, 1],
                                       x_batch[:, 2], x_batch[:, 3],
                                       x_batch[:, 4])
    nZ = md.z_grid.shape[0]
    iZ = jnp.clip(
        jnp.searchsorted(md.z_grid, Zp, side="right") - 1, 0, nZ - 1
    )
    zhot = jax.nn.one_hot(iZ, nZ, dtype=jnp.float32)      # [B, nZ]
    w = _sfh_weights(md, logSFtau, sfage)[:, :-1] * md.age_weight[None, :]
    per_z = jnp.einsum(
        "ba,zaw->bzw", w, md.templates[:, :-1, :],
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )                                                     # [B, nZ, n_wl]
    # exact one-hot selection: multiply-by-{0,1} + sum over the tiny nZ
    # axis (7) keeps full f32 — a dot_general here would run at DEFAULT
    # matmul precision (TF32 on a GPU), rounding per_z at ~0.1% which the
    # 1/noise^2 chi2 amplifies into O(10) logL errors
    template = jnp.sum(per_z * zhot[:, :, None], axis=1)  # [B, n_wl]
    template = template / (1e-10 + template[:, md.norm_index][:, None])
    template = template * 10.0 ** (-2.5 * md.calzetti[None, :]
                                   * EBV[:, None])
    q = md.data_wl[None, :] / (1.0 + z)[:, None]          # [B, nspec]
    n = md.model_wl.shape[0]
    wl0 = md.model_wl[0]
    dwl = (md.model_wl[n - 1] - wl0) / (n - 1)
    pos = jnp.clip((q - wl0) / dwl, 0.0, n - 1.0)
    i0 = jnp.minimum(pos.astype(jnp.int32), n - 2)
    frac = pos - i0.astype(pos.dtype)
    t0 = jnp.take_along_axis(template, i0, axis=1)
    t1 = jnp.take_along_axis(template, i0 + 1, axis=1)
    return t0 * (1.0 - frac) + t1 * frac
