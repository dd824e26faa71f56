"""What chip_smoke.py decides without a GPU."""

import json
import os

import jax
import numpy as np
import pytest

import chip_smoke


def test_refuses_cpu_device():
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        chip_smoke.require_gpu(jax.devices())


def test_quadrature_criterion():
    with open(os.path.join(chip_smoke.HERE, "quad_logZ.json")) as fh:
        quad = np.asarray(json.load(fh)["logZ"])
    err = np.full(100, 0.4)
    assert chip_smoke.quad_misses(quad, err) == (100, [])
    off = quad.copy()
    off[[46, 78]] -= 5.0
    assert chip_smoke.quad_misses(off, err) == (100, [46, 78])
