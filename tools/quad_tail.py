"""Investigate the horns-vs-quadrature evidence tail (VERDICT r4 weak #3).

Round 4's bench recorded 2/100 datasets outside 3 sigma against the
brute-force quadrature oracle (max 4.58 sigma-equivalent) where ~0.3 are
expected. This tool decides between the two candidate explanations:

- MC fluctuation: rerun the same workload at several RNG seeds; if the
  outlier datasets differ per seed and each seed's outlier count is small,
  the tail is ordinary nested-sampling scatter and the 3-sigma criterion
  (3 * logZerr + 0.5 safety) is simply tight for ~0.45-nat error bars.
- systematic bias: the same datasets land outside at every seed, pointing
  at a dataset-specific defect (e.g. a missed mode).

Writes ``quad_tail.json`` with per-seed per-outlier detail and a verdict.

    python tools/quad_tail.py [out.json]

Runs ndata=100 of the N_GEN=1000 horns stream at nlive=400 tol=0.5,
3 seeds; works on CPU or GPU (CPU takes ~15 min).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

OUT = sys.argv[1] if len(sys.argv) > 1 else "quad_tail.json"
SEEDS = [1, 2, 3]
NDATA = 100


def main():
    import numpy as np

    from massivedatans_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    import jax

    from massivedatans_tpu.config import RunConfig
    from massivedatans_tpu.datagen.generators import gen_horns
    from massivedatans_tpu.models.gaussline import make_gaussline_problem
    from massivedatans_tpu.ns.integrator import multi_nested_integrator

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, os.pardir, "quad_logZ.json")) as fh:
        quad = json.load(fh)
    quad_lz = np.asarray(quad["logZ"], float)[:NDATA]

    data = gen_horns(1000)
    problem = make_gaussline_problem(data["x"], data["y"][:, :NDATA],
                                     data["noise_level"])
    cfg = RunConfig(nlive_points=400, tolerance=0.5, chunk_iters=512,
                    eval_batch=128, proposal_batch=512, shelf_capacity=8,
                    pipeline_lookahead=1)

    runs = []
    for seed in SEEDS:
        t0 = time.time()
        r = multi_nested_integrator(problem, cfg, key=jax.random.key(seed),
                                    progress=False)
        lz = np.asarray(r.logZ, float)
        err = np.asarray(r.logZerr, float)
        dz = np.abs(lz - quad_lz)
        out_idx = np.where(dz > 3 * err + 0.5)[0]
        runs.append({
            "seed": seed,
            "wall_s": round(time.time() - t0, 1),
            "median_abs_dlogZ": round(float(np.median(dz)), 3),
            "max_abs_dlogZ": round(float(dz.max()), 3),
            "frac_within_3sigma": round(float((dz <= 3 * err + 0.5).mean()),
                                        3),
            "outliers": [
                {"dataset": int(i), "quad": round(float(quad_lz[i]), 3),
                 "logZ": round(float(lz[i]), 3),
                 "logZerr": round(float(err[i]), 3),
                 "sigma_equiv": round(float(dz[i] / max(err[i], 1e-9)), 2)}
                for i in out_idx
            ],
        })
        print(json.dumps(runs[-1]), flush=True)

    # systematic iff some dataset is an outlier in every seed
    sets = [set(o["dataset"] for o in run["outliers"]) for run in runs]
    common = set.intersection(*sets) if sets else set()
    payload = {
        "protocol": f"horns ndata={NDATA} nlive=400 tol=0.5, "
                    f"seeds={SEEDS}, criterion |dlogZ| > 3*logZerr + 0.5",
        "runs": runs,
        "outliers_common_to_all_seeds": sorted(common),
        "verdict": (
            "systematic: dataset(s) %s fail at every seed" % sorted(common)
            if common else
            "MC scatter: outlier identities change with the RNG seed; the "
            "per-seed counts are consistent with ~0.45-nat error bars and "
            "a 100-dataset tail"
        ),
    }
    with open(OUT, "w") as fh:
        json.dump(payload, fh, indent=1)
    print(f"wrote {OUT}: {payload['verdict']}")


if __name__ == "__main__":
    main()
