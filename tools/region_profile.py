"""Region-membership cost on the GPU: standalone timings and trace share.

1. Times the plain ``region.count_within`` (N=512 proposals against M=1,664
   and M=16,384 members, ndim=3) and the bootstrapped radius (M=1,664,
   nb=10): warm jitted calls, each ending in ``block_until_ready``.
2. Traces a steady window of the horns D=1,000 run at the bench settings
   (chunks after the first, which compiles) with ``jax.profiler`` and
   attributes device kernel time to the ``region_count_within`` and
   ``region_bootstrap_radius`` named scopes through the compiled HLO's
   op_name metadata.

    python tools/region_profile.py [out_dir]

Prints one JSON summary line; writes it, plus the top kernels of the window,
to ``out_dir/region_profile.json`` (default: the current directory).
"""

from __future__ import annotations

import collections
import glob
import json
import os
import re
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

SCOPES = ("region_count_within", "region_bootstrap_radius")


def _time_call(fn, *args, reps=50):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), float(np.min(ts))


def standalone_timings():
    import jax
    import jax.numpy as jnp

    from massivedatans_tpu.ns import region as R

    rng = np.random.default_rng(0)
    out = {}
    count = jax.jit(R.count_within)
    radius = jax.jit(R.bootstrapped_sq_radius, static_argnums=(3,))
    for M in (1664, 16384):
        members = jnp.asarray(rng.normal(0.5, 0.05, (M, 3)), jnp.float32)
        mask = jnp.asarray(np.arange(M) < M - M // 8)
        reg = R.build_region(members, mask, jax.random.key(0))
        pts = jnp.asarray(rng.uniform(0.3, 0.7, (512, 3)), jnp.float32)
        med, best = _time_call(count, reg, pts)
        out[f"count_within_N512_M{M}_s"] = dict(median=med, min=best)
        if M == 1664:
            med, best = _time_call(radius, reg.members_w, mask,
                                   jax.random.key(1), 10)
            out["bootstrap_radius_M1664_nb10_s"] = dict(median=med, min=best)
    return out


def _hlo_scope_map(hlo_text: str) -> dict:
    """instruction name -> the region scopes its ops (or the ops of the
    computations it calls) carry in their op_name metadata."""
    comp_scopes = collections.defaultdict(set)
    inst_scopes, inst_calls = {}, {}
    comp = None
    for line in hlo_text.splitlines():
        m = re.match(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->.*\{\s*$", line)
        if m:
            comp = m.group(1)
            continue
        m = re.match(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=", line)
        if not m:
            continue
        name = m.group(1)
        scopes = {s for s in SCOPES if s in line}
        comp_scopes[comp] |= scopes
        inst_scopes[name] = scopes
        inst_calls[name] = re.findall(
            r"(?:calls|to_apply|body|condition)=%([\w.\-]+)", line)
    out = {}
    for name, scopes in inst_scopes.items():
        s = set(scopes)
        for c in inst_calls[name]:
            s |= comp_scopes.get(c, set())
        out[name] = s
        out[name.replace(".", "_")] = s
    return out


def trace_window(D=1000, chunk_iters=256, warm_chunks=2, traced_chunks=2):
    import jax

    from massivedatans_tpu.config import RunConfig
    from massivedatans_tpu.datagen.generators import gen_horns
    from massivedatans_tpu.models.gaussline import make_gaussline_problem
    from massivedatans_tpu.ns import engine as E

    data = gen_horns(1000)
    problem = make_gaussline_problem(data["x"], data["y"][:, :D],
                                     data["noise_level"])
    cfg = RunConfig(nlive_points=400, tolerance=0.5, proposal_batch=512,
                    eval_batch=128, shelf_capacity=8, chunk_iters=chunk_iters)
    mc = cfg.resolve_member_capacity(D)
    st = E.init_state(problem, jax.random.key(1), cfg)
    hlo = E.run_chunk.lower(problem, st, cfg, mc, chunk_iters).compile() \
        .as_text()
    scope_of = _hlo_scope_map(hlo)
    walls = []
    for _ in range(warm_chunks):
        t0 = time.perf_counter()
        st, _ = E.run_chunk(problem, st, cfg, mc, chunk_iters)
        jax.block_until_ready(st.logZ)
        walls.append(time.perf_counter() - t0)
    it0, rounds0 = int(st.iteration), int(st.fill_rounds)
    tdir = tempfile.mkdtemp()
    jax.profiler.start_trace(tdir)
    t0 = time.perf_counter()
    for _ in range(traced_chunks):
        st, _ = E.run_chunk(problem, st, cfg, mc, chunk_iters)
    jax.block_until_ready(st.logZ)
    traced_wall = time.perf_counter() - t0
    jax.profiler.stop_trace()
    path = glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                     recursive=True)[0]
    pd = jax.profiler.ProfileData.from_file(path)

    per_name = collections.defaultdict(lambda: [0, 0, ""])
    total = 0
    scoped = collections.Counter()
    intervals = []
    stat_keys = set()
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                stat_keys |= set(stats)
                hlo_op = str(stats.get("hlo_op", ev.name))
                dur = float(ev.duration_ns)
                total += dur
                intervals.append((float(ev.start_ns), float(ev.end_ns)))
                rec = per_name[ev.name]
                rec[0] += dur
                rec[1] += 1
                rec[2] = hlo_op
                found = scope_of.get(hlo_op) or scope_of.get(ev.name) or {
                    s for s in SCOPES if any(s in str(v)
                                             for v in stats.values())}
                for s in found:
                    scoped[s] += dur
                if found:
                    scoped["either"] += dur
    intervals.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:40]
    return dict(
        D=D, chunk_iters=chunk_iters, warm_chunk_walls_s=walls,
        traced_chunks=traced_chunks, traced_wall_s=traced_wall,
        traced_iterations=int(st.iteration) - it0,
        traced_fill_rounds=int(st.fill_rounds) - rounds0,
        device_kernel_sum_s=total / 1e9, device_busy_s=busy / 1e9,
        region_kernel_s={k: v / 1e9 for k, v in scoped.items()},
        region_share_of_kernel_time=(scoped["either"] / total
                                     if total else None),
        n_kernel_names=len(per_name), device_stat_keys=sorted(stat_keys),
        hlo_instructions_with_region_scope=sum(
            1 for v in scope_of.values() if v) // 2,
        top_kernels=[dict(name=n, s=v[0] / 1e9, n=v[1], hlo_op=v[2],
                          scopes=sorted(scope_of.get(v[2], set())))
                     for n, v in top],
    )


def main():
    import jax

    out_dir = sys.argv[1] if len(sys.argv) > 1 else "."
    os.makedirs(out_dir, exist_ok=True)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, found {dev.platform}")
    res = dict(device=dev.device_kind, timings=standalone_timings())
    res["trace"] = trace_window()
    with open(os.path.join(out_dir, "region_profile.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    summary = {k: v for k, v in res["trace"].items() if k != "top_kernels"}
    print(json.dumps(dict(device=res["device"], timings=res["timings"],
                          trace=summary)))


if __name__ == "__main__":
    main()
