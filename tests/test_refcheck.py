"""The float64 reference checks that chip_smoke.py runs on the GPU, run
here on the CPU at the same widths (refcheck.py states the tolerances)."""

import pytest

import refcheck


@pytest.mark.parametrize("B", [128, 512])
def test_gaussline_matches_float64(B):
    r = refcheck.check_gaussline(B, 10_000)
    assert r["ok"], r


def test_region_matches_float64():
    r = refcheck.check_region(1664, 512)
    assert r["ok"], r
    assert r["mean_count"] > 1  # proposals actually land inside the balls


def test_muse_matches_float64():
    r = refcheck.check_muse(3600, 128, 100)
    assert r["ok"], r
