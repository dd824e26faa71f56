"""Bring-up check: the joint nested sampler end to end on NVIDIA GPUs.

    python chip_smoke.py           # one GPU: phases A-E below
    python chip_smoke.py --multi   # four GPUs: the mesh path only

One process drives every phase, so only one JAX process holds the card.
The script runs on a GPU only: on any other platform it exits non-zero
before doing any work. Every phase runs; a phase that fails is reported
with its traceback and the script then exits non-zero without printing a
result. The last line of a passing run is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

Phases (one card):
  A  device, card name and power limit, native union-find status
  B  f32 likelihood and region reductions vs float64 references at real
     widths (``refcheck.py``)
  C  horns, 1,000 spectra, to convergence; evidences vs the quadrature
     oracle ``quad_logZ.json``; bit-exact host replay of the volume ledger
  D  horns, 10,000 spectra (the reference's canonical protocol)
  E  MUSE datacube likelihood, nspec=3600, 100 spaxels

Everything runs through the Python API. The command line's ``fit`` and
``check`` read and write the reference's HDF5 schema through ``h5py``,
which the GPU machine this was brought up on does not have.

With ``--multi`` (four cards): one horns chunk on a 4-way dataset mesh and
one MUSE chunk on a (data=2, model=2) mesh, each against the same chunk on
one card, then a full 1,000-spectrum horns run on the 4-way mesh.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# the run settings of the reference protocol (nlive=400, tolerance=0.5) with
# the engine's batch sizes as bench.py runs them
RUN_SETTINGS = dict(nlive_points=400, tolerance=0.5, proposal_batch=512,
                    eval_batch=128, eval_batch_max=512, shelf_capacity=8,
                    pipeline_lookahead=1)
QUAD_MIN_PASS = 98  # of the first 100 datasets (46 and 78 are known bimodal)


def log(msg: str) -> None:
    print(msg, flush=True)


def require_gpu(devices) -> None:
    """Exit non-zero unless JAX's first device is a GPU."""
    platform = devices[0].platform if devices else "none"
    if platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs an NVIDIA GPU; JAX found platform {platform!r}")


def card_lines() -> list[str]:
    """``name, power.limit`` of each card as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def run_config(**overrides):
    from massivedatans_tpu.config import RunConfig

    return RunConfig(**{**RUN_SETTINGS, **overrides})


def horns_problem(n_gen: int, D: int):
    from massivedatans_tpu.datagen.generators import gen_horns
    from massivedatans_tpu.models.gaussline import make_gaussline_problem

    data = gen_horns(n_gen)
    return make_gaussline_problem(data["x"], data["y"][:, :D],
                                  data["noise_level"])


def quad_misses(logZ, logZerr) -> tuple[int, list[int]]:
    """Compare the first datasets of the 1,000-spectrum horns stream with
    the quadrature oracle (bench.py's criterion |dlogZ| < 3 logZerr + 0.5);
    returns (number compared, indices that miss)."""
    with open(os.path.join(HERE, "quad_logZ.json")) as fh:
        quad = np.asarray(json.load(fh)["logZ"], float)
    n = min(len(quad), len(logZ))
    dz = np.abs(np.asarray(logZ[:n], float) - quad[:n])
    miss = np.where(dz >= 3.0 * np.asarray(logZerr[:n], float) + 0.5)[0]
    return n, [int(i) for i in miss]


def check_run(tag: str, result, wall: float, card: str) -> list[str]:
    """Print a run's counters; return what is wrong with it."""
    st = result.stats
    D = len(result.logZ)
    log(f"[{tag}] wall {wall:.2f} s (compilation included) on {card}; "
        f"niter {result.niterations} ndraws {result.ndraws} "
        f"evals/dataset {result.ndraws / D:.1f} fill_rounds "
        f"{st.get('fill_rounds')} big_batch_chunks "
        f"{st.get('big_batch_chunks')} stalled "
        f"{int(np.sum(st.get('stalled_mask', 0)))} member_overflow "
        f"{st.get('member_overflow')} ledger_drift_chunks "
        f"{st.get('ledger_drift_chunks')}")
    log(f"[{tag}] host timing {json.dumps(st.get('timing'))}")
    problems = []
    if st.get("interrupted"):
        problems.append("run was interrupted before every dataset terminated")
    if not np.all(np.isfinite(result.logZ)):
        problems.append(f"{int((~np.isfinite(result.logZ)).sum())} "
                        "non-finite logZ")
    if st.get("ledger_drift_chunks") != 0:
        problems.append(f"ledger drift in {st.get('ledger_drift_chunks')} "
                        "chunks")
    return problems


def check_quad(tag: str, result) -> list[str]:
    n, miss = quad_misses(result.logZ, result.logZerr)
    log(f"[{tag}] quadrature oracle: {n - len(miss)}/{n} within "
        f"3 logZerr + 0.5; misses at {miss}")
    if n - len(miss) < min(QUAD_MIN_PASS, n - 2):
        return [f"only {n - len(miss)}/{n} evidences agree with quadrature"]
    return []


def peak_memory(tag: str) -> None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    log(f"[{tag}] device 0 peak_bytes_in_use so far "
        f"{stats.get('peak_bytes_in_use')} of limit "
        f"{stats.get('bytes_limit')}")


# --- phases on one card --------------------------------------------------


def phase_device(ctx) -> list[str]:
    import jax
    import jaxlib

    from massivedatans_tpu.ns import subsets

    d = jax.devices()[0]
    log(f"[A] platform {d.platform} kind {d.device_kind} count "
        f"{len(jax.devices())}; jax {jax.__version__} jaxlib "
        f"{jaxlib.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    lines = card_lines()
    for ln in lines:
        log(f"nvidia-smi: {ln}")
    ctx["card"] = lines[0]
    log(f"[A] component labels: {subsets.native_status()}")
    log(f"[A] g++ {shutil.which('g++')}; h5py "
        f"{importlib.util.find_spec('h5py') is not None}")
    return []


def phase_refcheck(ctx, gauss_D=10_000, region_M=1664, region_N=512,
                   muse_nspec=3600, muse_D=100) -> list[str]:
    import refcheck

    results = [refcheck.check_gaussline(128, gauss_D),
               refcheck.check_gaussline(512, gauss_D),
               refcheck.check_region(region_M, region_N),
               refcheck.check_muse(muse_nspec, 128, muse_D)]
    log(f"[B] precision HIGHEST; logL bound {refcheck.LOGL_ATOL} + "
        f"{refcheck.LOGL_RTOL} x cancelled magnitude; radius rtol "
        f"{refcheck.RADIUS_RTOL}; synthesis rtol {refcheck.SYNTH_RTOL}")
    for r in results:
        log(f"[B] {json.dumps(r)}")
    return [f"{r['check']} outside tolerance" for r in results if not r["ok"]]


def _horns_run(tag, ctx, n_gen, D, oracle, mesh=None, **cfg_overrides):
    import jax

    from massivedatans_tpu.ns.integrator import multi_nested_integrator

    problem = horns_problem(n_gen, D)
    cfg = run_config(**cfg_overrides)
    log(f"[{tag}] horns n_gen={n_gen} D={D} "
        f"{json.dumps(dataclasses.asdict(cfg))}")
    t0 = time.time()
    result = multi_nested_integrator(problem, cfg, key=jax.random.key(1),
                                     progress=False, mesh=mesh)
    problems = check_run(tag, result, time.time() - t0, ctx.get("card", "unknown card"))
    if oracle:
        problems += check_quad(tag, result)
    peak_memory(tag)
    return problems


def phase_horns_1000(ctx, D=1000, **cfg) -> list[str]:
    return _horns_run("C", ctx, 1000, D, oracle=True,
                      **{"chunk_iters": 8192, **cfg})


def phase_horns_10000(ctx, D=10_000, **cfg) -> list[str]:
    return _horns_run("D", ctx, D, D, oracle=False,
                      **{"chunk_iters": 256, **cfg})


def phase_muse(ctx, nspec=3600, D=100, nlive=400,
               max_samples=2000) -> list[str]:
    import jax

    import refcheck
    from massivedatans_tpu.config import RunConfig
    from massivedatans_tpu.ns.integrator import multi_nested_integrator

    problem, _, _, _ = refcheck.muse_problem(nspec, D)
    cfg = RunConfig(nlive_points=nlive, max_samples=max_samples)
    log(f"[E] muse nspec={nspec} D={D} nlive={nlive} "
        f"max_samples={max_samples}")
    t0 = time.time()
    result = multi_nested_integrator(problem, cfg, key=jax.random.key(1),
                                     progress=False)
    problems = check_run("E", result, time.time() - t0, ctx.get("card", "unknown card"))
    peak_memory("E")
    return problems


SINGLE_PHASES = [("A", phase_device), ("B", phase_refcheck),
                 ("C", phase_horns_1000), ("D", phase_horns_10000),
                 ("E", phase_muse)]


# --- phases on four cards ------------------------------------------------


def _shard_layout(arr) -> list[tuple[int, tuple]]:
    return sorted((s.device.id, tuple(s.data.shape))
                  for s in arr.addressable_shards)


def _check_layout(tag, name, arr, n_dev, axis) -> list[str]:
    layout = _shard_layout(arr)
    log(f"[{tag}] {name} {arr.shape} {arr.sharding.spec}: {layout}")
    want = list(arr.shape)
    want[axis] //= n_dev
    ids = [i for i, _ in layout]
    if len(set(ids)) != len(ids) or any(list(s) != want for _, s in layout):
        return [f"{name} is not split into one {want} shard per device"]
    return []


def _chunk_pair(tag, problem, cfg, devices, model_parallel, n_iters):
    """One chunk on device 0 and the same chunk on a mesh of ``devices``."""
    import jax

    from massivedatans_tpu.ns import engine as engine_lib
    from massivedatans_tpu.parallel.sharded import (
        make_mesh, make_sharded_run_chunk, shard_problem, shard_state,
    )

    mc = cfg.resolve_member_capacity(problem.ndata)
    key = jax.random.key(0)
    t0 = time.time()
    single, _ = engine_lib.run_chunk(
        problem, engine_lib.init_state(problem, key, cfg), cfg, mc, n_iters)
    jax.block_until_ready(single.logZ)
    t1 = time.time()
    mesh = make_mesh(devices, model_parallel=model_parallel)
    p_sh = shard_problem(problem, mesh)
    st_sh = shard_state(engine_lib.init_state(problem, key, cfg), mesh)
    runner = make_sharded_run_chunk(p_sh, mesh, cfg, mc, n_iters)
    sharded, dead = runner(p_sh, st_sh)
    jax.block_until_ready(sharded.logZ)
    log(f"[{tag}] mesh {dict(mesh.shape)}; one chunk of {n_iters}: "
        f"single {t1 - t0:.2f} s, mesh {time.time() - t1:.2f} s "
        "(compilation included)")
    counters = {k: (int(getattr(single, k)), int(getattr(sharded, k)))
                for k in ("iteration", "ndraws", "pile_size")}
    dz = np.abs(np.asarray(single.logZ) - np.asarray(sharded.logZ))
    same_live = bool(np.array_equal(np.asarray(single.live_idx),
                                    np.asarray(sharded.live_idx)))
    log(f"[{tag}] single vs mesh counters {counters}; max |dlogZ| "
        f"{dz.max():.3g}; live sets equal {same_live}")
    return single, sharded, dead, p_sh, mesh, counters, dz


def phase_multi_horns_chunk(ctx, devices, D=1000, n_iters=256):
    problem = horns_problem(1000, D)
    cfg = run_config(chunk_iters=n_iters)
    single, sharded, dead, p_sh, mesh, counters, dz = _chunk_pair(
        "M1", problem, cfg, devices, 1, n_iters)
    n = len(devices)
    problems = _check_layout("M1", "live_idx", sharded.live_idx, n, 1)
    problems += _check_layout("M1", "spectra y", p_sh.data.y, n, 1)
    problems += _check_layout("M1", "dead L", dead.L, n, 1)
    if any(a != b for a, b in counters.values()):
        # a shard's narrower [nx, D/n] product may round differently at a
        # contour boundary; then the trajectories part and only the
        # evidences can be compared, statistically, in the full mesh run
        log("[M1] counters differ: comparing evidences statistically "
            "in the full mesh run (M3) instead")
    elif not np.allclose(np.asarray(single.logZ), np.asarray(sharded.logZ),
                         rtol=1e-4, atol=1e-4):
        problems.append(f"logZ differs by up to {dz.max():.3g}")
    return problems


def phase_multi_muse_chunk(ctx, devices, nspec=3600, D=100, n_iters=50):
    import refcheck
    from massivedatans_tpu.config import RunConfig

    problem, _, _, _ = refcheck.muse_problem(nspec, D)
    cfg = RunConfig(nlive_points=400, chunk_iters=n_iters)
    single, sharded, _, p_sh, mesh, counters, dz = _chunk_pair(
        "M2", problem, cfg, devices, 2, n_iters)
    problems = []
    spec = p_sh.data.y_over_v
    layout = _shard_layout(spec)
    log(f"[M2] y/var {spec.shape} {spec.sharding.spec}: {layout}")
    want = (spec.shape[0] // 2, spec.shape[1] // 2)
    if len({i for i, _ in layout}) != len(devices) or any(
            s != want for _, s in layout):
        problems.append(f"y/var is not split into one {want} block per "
                        "device")
    if counters["iteration"][0] != counters["iteration"][1]:
        problems.append(f"iteration differs: {counters['iteration']}")
    if not np.allclose(np.asarray(sharded.logZ), np.asarray(single.logZ),
                       rtol=1e-3, atol=0.05):
        problems.append(f"logZ differs by up to {dz.max():.3g}")
    return problems


def phase_multi_horns_run(ctx, devices, D=1000, **cfg):
    from massivedatans_tpu.parallel.sharded import make_mesh

    mesh = make_mesh(devices)
    return _horns_run("M3", ctx, 1000, D, oracle=True, mesh=mesh,
                      **{"chunk_iters": 8192, **cfg})


MULTI_PHASES = [("M1", phase_multi_horns_chunk),
                ("M2", phase_multi_muse_chunk),
                ("M3", phase_multi_horns_run)]
N_MULTI = 4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help=f"run the {N_MULTI}-card mesh phases instead")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    require_gpu(devices)
    # the host replays the device's f32 volume ledger and must agree bit
    # for bit: a drift is an error here, not a warning
    os.environ["MDT_STRICT_LEDGER"] = "1"
    from massivedatans_tpu.utils.cache import enable_compilation_cache

    log(f"compilation cache: {enable_compilation_cache()}")
    ctx = {}
    if args.multi:
        if len(devices) < N_MULTI:
            raise SystemExit(f"--multi needs {N_MULTI} GPUs, found "
                             f"{len(devices)}")
        phase_device(ctx)
        phases = [(name, lambda c, f=fn: f(c, devices[:N_MULTI]))
                  for name, fn in MULTI_PHASES]
    else:
        phases = SINGLE_PHASES
    failed = []
    for name, fn in phases:
        t0 = time.time()
        try:
            problems = fn(ctx)
        except Exception:
            traceback.print_exc()
            sys.stdout.flush()
            problems = ["raised (traceback on stderr)"]
        status = "FAILED: " + "; ".join(problems) if problems else "passed"
        log(f"phase {name} {status} ({time.time() - t0:.1f} s)")
        if problems:
            failed.append(name)
    if failed:
        log(f"chip_smoke: phases {failed} failed")
        return 1
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
