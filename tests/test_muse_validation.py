"""Model-family MUSE truth recovery, tiny CPU version.

The flagship-scale artifact is MUSE_VALIDATION.json (tools/muse_validate.py,
run at >=100 spaxels). This test asserts the same properties hold on
a miniature of the exact fixture: every non-empty spaxel is drawn from the
fit prior of the 5-parameter family (muse.synth.make_model_cube), so
posterior truth recovery is well-defined (the reference's standard,
plotposterior.py:28-62) and the empty-spaxel evidence has a closed form.
"""

import json

import numpy as np
import pytest

from massivedatans_tpu.muse.synth import make_model_cube, make_template_files


@pytest.fixture(scope="module")
def model_cube(tmp_path_factory):
    d = tmp_path_factory.mktemp("muse_model_cube")
    tpl = make_template_files(str(d / "templates"))
    # cd3=22.5 A/bin: a flagship-like 450 nm span with only 200 bins — the
    # span (not the bin count) is what keeps parameters identifiable under
    # the profiled amplitude (see make_model_cube)
    cube, reg, truths = make_model_cube(
        str(d / "cube.fits"), str(d / "sel.reg"), tpl,
        str(d / "truths.json"), ny=4, nx=4, nspec=200, seed=7,
        frac_empty=0.25, cd3=22.5,
    )
    return tpl, cube, reg, truths


def test_model_cube_fixture_is_family_exact(model_cube):
    """The cube's non-empty spaxels must equal amp * predict_batch(truth)
    + noise under the SAME template grid the pipeline will load — i.e. the
    residual at the injected truth is pure noise at the STAT level."""
    import jax.numpy as jnp

    from massivedatans_tpu.muse.model import load_template_grid, predict_batch
    from massivedatans_tpu.muse.pipeline import load_muse_cube

    tpl, cube_path, reg, truths_path = model_cube
    with open(truths_path) as fh:
        truths = json.load(fh)
    cube = load_muse_cube(cube_path, reg)
    md = load_template_grid(tpl, data_wl_nm=cube.wavelength_nm,
                            zlo=truths["zlo"], zhi=truths["zhi"])
    theta = np.asarray(truths["params"], np.float32)
    amp = np.asarray(truths["amp"])
    empty = np.asarray(truths["empty"], bool)
    model = np.asarray(predict_batch(md, jnp.asarray(theta))).T  # [nspec, D]
    resid = cube.y - np.where(empty[None, :], 0.0, amp[None, :] * model)
    z = resid / np.sqrt(cube.var)
    # standardized residuals ~ N(0,1): per-spaxel mean ~ 1/sqrt(nspec)
    assert np.abs(z.mean(axis=0)).max() < 5.0 / np.sqrt(cube.y.shape[0])
    assert abs(float(z.std()) - 1.0) < 0.05


@pytest.mark.slow
def test_truth_recovery_and_empty_evidence(model_cube, tmp_path):
    """Run the pipeline on the model-family cube; assert bounded truth
    recovery, the no-star evidence identity, and chi2/dof ~ 1."""
    from massivedatans_tpu import postprocess
    from massivedatans_tpu.io.hdf5io import read_results
    from massivedatans_tpu.muse.pipeline import run_musefit

    tpl, cube_path, reg, truths_path = model_cube
    with open(truths_path) as fh:
        truths = json.load(fh)
    result, problem, cube = run_musefit(
        cube_path, reg, zlo=0.0, zhi=0.5, template_files=tpl,
        nlive=100, tolerance=0.5, max_samples=40000,
        out_prefix=str(tmp_path / "mv"), progress=False,
    )
    assert not result.stats.get("interrupted")
    out = read_results(str(tmp_path / "mv"))
    D = len(out["logZ"])
    theta = np.asarray(truths["params"])[:D]
    empty = np.asarray(truths["empty"], bool)[:D]
    yy = np.asarray(truths["yy"])[:D]
    nspec = int(truths["nspec"])
    rng = np.random.default_rng(0)

    # empty-spaxel evidence identity: logZ ~= -yy/2 (+O(1) from the
    # profiled-amplitude reduction s1^2/s2 ~ chi2_1)
    assert empty.sum() >= 2
    dz = out["logZ"][empty] + 0.5 * yy[empty]
    assert np.abs(dz).max() < 6.0, dz

    # goodness of fit at the truth family: best chi2 within the chi2 band
    mask = out.get("mask", np.ones_like(out["L"], bool))
    Lbest = np.where(mask, out["L"], -np.inf).max(axis=0)
    chi2_best = -2.0 * Lbest[~empty]
    zscore = (chi2_best - (nspec - 6)) / np.sqrt(2.0 * nspec)
    assert np.median(zscore) < 3.0, chi2_best
    assert (zscore < 8.0).all(), chi2_best

    # truth recovery: redshift is the sharpest parameter; for spaxels whose
    # posterior is clearly narrower than the prior, the truth must lie
    # within 5 posterior sigma (loose: few-spaxel tiny-nlive statistics)
    n_checked = 0
    for d in np.where(~empty)[0]:
        s = postprocess.posterior_samples(out, int(d), size=800, rng=rng)
        zs = s[:, 3]
        if zs.std() < 0.5 / np.sqrt(12.0) * 0.5:
            n_checked += 1
            pull = abs(zs.mean() - theta[d, 3]) / max(zs.std(), 1e-9)
            assert pull < 5.0, (d, zs.mean(), theta[d, 3], zs.std())
    assert n_checked >= 3, n_checked
