"""Subset decomposition vs a brute-force oracle (the reference's only
fixture-based test is exactly this cross-check, profile_generate_subsets.py)."""

import os

import numpy as np
import pytest

from massivedatans_tpu.ns import subsets


def _oracle_components(live_idx, selected):
    """Brute-force: datasets connected iff they share any live point."""
    D = live_idx.shape[1]
    sel = np.where(selected)[0]
    adj = {d: set() for d in sel}
    for i, a in enumerate(sel):
        for b in sel[i + 1:]:
            if np.intersect1d(live_idx[:, a], live_idx[:, b]).size:
                adj[a].add(b)
                adj[b].add(a)
    seen, groups = set(), []
    for d in sel:
        if d in seen:
            continue
        stack, grp = [d], set()
        while stack:
            v = stack.pop()
            if v in grp:
                continue
            grp.add(v)
            stack.extend(adj[v] - grp)
        seen |= grp
        groups.append(frozenset(grp))
    return set(groups)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_components_match_oracle(seed):
    rng = np.random.default_rng(seed)
    K, D = 8, 30
    n_groups = rng.integers(1, 5)
    # build datasets whose live points come from disjoint pools per group
    group_of = rng.integers(0, n_groups, size=D)
    live_idx = np.zeros((K, D), np.int32)
    for d in range(D):
        pool = np.arange(group_of[d] * 100, group_of[d] * 100 + 40)
        live_idx[:, d] = rng.choice(pool, size=K, replace=True)
    labels, n = subsets.component_labels(live_idx)
    got = set()
    for g in range(n):
        got.add(frozenset(np.where(labels == g)[0]))
    want = _oracle_components(live_idx, np.ones(D, bool))
    assert got == want


def test_components_with_selection_and_bridge():
    K, D = 4, 6
    live_idx = np.array([
        [0, 0, 10, 10, 20, 20],
        [1, 1, 11, 11, 21, 21],
        [2, 2, 12, 12, 22, 22],
        [3, 9, 13, 9, 23, 23],   # point 9 bridges datasets 1 and 3
    ], dtype=np.int32)
    labels, n = subsets.component_labels(live_idx)
    # point 9 bridges {0,1} with {2,3} (via dataset 3's pool): one component,
    # plus the disjoint {4,5} pool
    assert n == 2
    assert labels[0] == labels[1] == labels[2] == labels[3]
    assert labels[4] == labels[5] != labels[0]
    # selecting only disconnected columns
    sel = np.array([True, False, False, False, True, False])
    labels2, n2 = subsets.component_labels(live_idx, sel)
    assert n2 == 2
    assert labels2[0] != labels2[4]
    assert labels2[1] == -1


def test_short_circuits():
    K, D = 4, 10
    rng = np.random.default_rng(0)
    live_idx = rng.integers(0, 5, size=(K, D)).astype(np.int32)
    # fewer than 2*nlive unique points -> connected (reference :218-224)
    labels, n = subsets.component_labels(live_idx, nlive_points=K)
    assert n == 1
    # superpoint shared by all -> connected (reference :226-231)
    live_idx2 = np.arange(K * D, dtype=np.int32).reshape(K, D)
    live_idx2[0, :] = 99999
    labels2, n2 = subsets.component_labels(live_idx2)
    assert n2 == 1


def test_native_matches_numpy():
    rng = np.random.default_rng(5)
    K, D = 16, 100
    group_of = rng.integers(0, 7, size=D)
    live_idx = np.zeros((K, D), np.int32)
    for d in range(D):
        live_idx[:, d] = rng.choice(
            np.arange(group_of[d] * 50, group_of[d] * 50 + 30), size=K)
    sel = np.ones(D, bool)
    live_local, uniq = subsets._localize(live_idx, sel)
    labels_np, n_np = subsets._components_numpy(
        live_local, sel, K, D, len(uniq))
    lib = subsets._load_native()
    if lib is None:
        pytest.skip("native unionfind unavailable")
    out = np.zeros(D, np.int32)
    n_c = lib.decompose_components(
        np.asfortranarray(live_local, np.int32),
        np.ascontiguousarray(sel, np.uint8), K, D, len(uniq), out)
    assert n_c == n_np
    # same partition up to label permutation
    for g in range(n_c):
        cols = np.where(out == g)[0]
        assert len(set(labels_np[cols])) == 1


def _copy_native(tmp_path):
    import shutil

    for name in ("Makefile", "unionfind.cpp"):
        shutil.copy(os.path.join(subsets._NATIVE_DIR, name), tmp_path / name)
    return str(tmp_path)


def test_native_library_rebuilds_when_source_is_newer(tmp_path):
    native = _copy_native(tmp_path)
    so = subsets.build_native(native)
    assert os.path.exists(so)
    built = os.path.getmtime(so)
    assert subsets.build_native(native) == so  # up to date: no rebuild
    assert os.path.getmtime(so) == built
    src = os.path.join(native, "unionfind.cpp")
    os.utime(src, (built + 10, built + 10))
    subsets.build_native(native)
    assert os.path.getmtime(so) > built
