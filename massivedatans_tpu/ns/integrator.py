"""Host-side nested-sampling driver.

Mirrors reference ``multi_nested_integrator.py:80-175``, but the per-iteration
work (fill/advance/logZ/H) runs on-device in chunks of ``cfg.chunk_iters``
iterations per dispatch (engine.run_chunk); the host only:

- accumulates the dead-point stream into the posterior 'weights' record,
- evaluates the termination criterion every chunk (the reference's every-50
  cadence, multi_nested_integrator.py:136),
- captures remainder tails for terminating datasets and masks them out
  (replacing ``cut_down``'s array reshapes with a ``running`` mask),
- compacts the point pile when it nears capacity.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from massivedatans_tpu.config import RunConfig
from massivedatans_tpu.models.base import Problem
from massivedatans_tpu.ns import engine as engine_lib
from massivedatans_tpu.ns.engine import EngineState
from massivedatans_tpu.utils.progress import ProgressReporter, shelf_sparkline

log = logging.getLogger("massivedatans_tpu")


@dataclasses.dataclass
class NSResult:
    """Reference output contract (sample.py:202-217)."""

    logZ: np.ndarray        # [D]
    logZerr: np.ndarray     # [D]
    u: np.ndarray           # [niter + nlive, D, ndim]
    x: np.ndarray           # [niter + nlive, D, ndim]
    L: np.ndarray           # [niter + nlive, D]
    w: np.ndarray           # [niter + nlive, D] log-widths
    mask: np.ndarray        # [niter + nlive, D] running mask per record
    information: np.ndarray  # [D] H
    niterations: int
    ndraws: int
    duration: float
    stats: dict


def compact_pile(state: EngineState) -> EngineState:
    """Drop pile entries no longer referenced by live points or shelves.

    The reference pile grows without bound (multi_nested_sampler.py:479);
    dead points here are streamed out per chunk, so only live/shelved points
    need to stay resident (survey §7 'pile growth / memory').
    """
    live_idx = np.asarray(state.live_idx)
    shelf_idx = np.asarray(state.shelves.idx)
    phantom_idx = np.asarray(state.phantom_idx)
    refs = np.unique(np.concatenate([
        live_idx.ravel(), shelf_idx[shelf_idx >= 0],
        phantom_idx[phantom_idx >= 0],
    ]))
    n = len(refs)
    P = state.pile_u.shape[0]
    # pad the gather to a bucketed size so repeat compactions reuse one
    # compiled executable (fresh shapes retrace and recompile)
    n_pad = min(P, ((n + 65535) // 65536) * 65536)
    refs_padded = np.concatenate(
        [refs, np.zeros(n_pad - n, dtype=refs.dtype)])
    refs_dev = jnp.asarray(refs_padded, dtype=jnp.int32)
    new_pile_u = jnp.zeros_like(state.pile_u).at[:n_pad].set(
        state.pile_u[refs_dev])
    new_pile_x = jnp.zeros_like(state.pile_x).at[:n_pad].set(
        state.pile_x[refs_dev])
    new_live = np.searchsorted(refs, live_idx).astype(np.int32)
    new_shelf = np.where(
        shelf_idx >= 0, np.searchsorted(refs, np.maximum(shelf_idx, 0)), -1
    ).astype(np.int32)
    new_phantom = np.where(
        phantom_idx >= 0,
        np.searchsorted(refs, np.maximum(phantom_idx, 0)),
        -1,
    ).astype(np.int32)
    log.info("pile compaction: %d -> %d (cap %d)", int(state.pile_size), n, P)
    return state._replace(
        pile_u=new_pile_u,
        pile_x=new_pile_x,
        pile_size=jnp.int32(n),
        live_idx=jnp.asarray(new_live),
        shelves=state.shelves._replace(idx=jnp.asarray(new_shelf)),
        phantom_idx=jnp.asarray(new_phantom),
    )


def multi_nested_integrator(
    problem: Problem,
    cfg: Optional[RunConfig] = None,
    key=None,
    tolerance: Optional[float] = None,
    max_samples: Optional[int] = None,
    min_samples: Optional[int] = None,
    progress: bool = True,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 10,
    max_chunks: Optional[int] = None,
    dispatch_target_s: Optional[float] = None,
) -> NSResult:
    """Run the joint sampler to termination (or graceful preemption).

    ``max_chunks``: stop after this many device chunks, checkpoint, and
    return the partial result with ``stats['interrupted'] = True`` — the
    preemptible-worker path (requires ``checkpoint_dir``). Resuming
    continues the dispatch chain deterministically: with
    ``cfg.pipeline_lookahead == 0`` the resumed run's outputs are
    bit-identical to an uninterrupted run (with lookahead, the advisory
    group labels steer dispatches one chunk later, so the label *phase*
    shifts across a resume — statistically immaterial, labels never affect
    correctness).

    ``dispatch_target_s``: enable ADAPTIVE per-dispatch fill budgets
    targeting this many seconds of device wall per chunk. The fill budget
    is a traced operand of the chunk executable (engine.run_chunk
    ``fill_budget``), so re-tuning costs no recompiles: each chunk's
    measured wait and fill-round consumption give a per-round cost
    estimate, and the next dispatch's budget is set to target/cost
    (growth damped 1.5x/chunk, floor 256 rounds, ceiling
    cfg.chunk_fill_budget or 65536). This bounds single-dispatch wall
    time even when late-run fill escalation makes per-round cost drift by
    orders of magnitude. The
    budget sequence depends on measured wall-clock, so resumes are NOT
    bit-identical with this enabled (truncated fills are bias-free —
    per-dataset volume ledger). Single-device path only (ignored with
    ``mesh``)."""
    cfg = cfg or RunConfig()
    # termination parameters are baked into the jitted step (the check runs
    # on-device, engine.device_termination), so fold overrides into cfg
    overrides = {}
    if tolerance is not None:
        overrides["tolerance"] = tolerance
    if max_samples is not None:
        overrides["max_samples"] = max_samples
    if min_samples is not None:
        overrides["min_samples"] = min_samples
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if key is None:
        key = jax.random.key(cfg.seed)

    D = problem.ndata
    K = cfg.nlive_points
    ndim = problem.ndim
    member_capacity = cfg.resolve_member_capacity(D)
    t0 = time.time()
    # wall-clock decomposition (stats['timing']): where host time goes —
    # init/resume, blocked-on-device, host streaming, group labels, tails
    timing = dict(init_s=0.0, block_s=0.0, host_s=0.0, groups_s=0.0,
                  tail_s=0.0)
    ledger_drift_chunks = 0  # chunks whose host f32 ledger replay drifted

    state = engine_lib.init_state(problem, key, cfg)
    run_big = None
    big_active = False
    big_batch_chunks = 0
    if mesh is not None:
        from massivedatans_tpu.parallel import sharded as sharded_lib

        problem = sharded_lib.shard_problem(problem, mesh)
        state = sharded_lib.shard_state(state, mesh)
        run = sharded_lib.make_sharded_run_chunk(
            problem, mesh, cfg, member_capacity, cfg.chunk_iters
        )
    else:
        def make_run(c):
            def _run(pr, st, fill_budget=None):
                return engine_lib.run_chunk(
                    pr, st, c, member_capacity, c.chunk_iters,
                    fill_budget=fill_budget,
                )
            return _run

        run = make_run(cfg)
        if cfg.eval_batch_max > cfg.eval_batch:
            # eval-batch escalation (cfg.eval_batch_max): a second chunk
            # executable with a larger candidate batch, selected per
            # dispatch from the measured fill-rounds/iteration. Per-round
            # device cost is nearly flat in the batch size (the fixed
            # [*, D] shelf/threshold work dominates the [B, nx] @ [nx, D]
            # matmul), so hard phases finish in ~scale fewer rounds for the
            # same wall per round; easy phases stay at the small batch so
            # model-evaluation counts keep parity with the reference's
            # one-candidate-at-a-time protocol.
            scale = max(1, cfg.eval_batch_max // cfg.eval_batch)
            cfg_big = dataclasses.replace(
                cfg,
                eval_batch=cfg.eval_batch_max,
                proposal_batch=cfg.proposal_batch * scale,
                column_proposal_batch=(
                    cfg.column_proposal_batch * scale
                    if cfg.column_proposal_batch else 0
                ),
            )
            run_big = make_run(cfg_big)
    pile_cap = state.pile_u.shape[0]

    # --- adaptive dispatch-length controller ---
    # The first dispatch must be safe UNMEASURED: a resume into a deep-run
    # state (fill escalation, 10-100x early-run per-round cost) with a
    # saturated static budget can make one dispatch run for minutes before
    # any timing is observed. Start small and let the controller grow
    # 1.5x/chunk toward the target.
    adaptive = dispatch_target_s is not None and mesh is None
    budget_ceil = cfg.chunk_fill_budget or 65536
    budget_floor = min(256, budget_ceil)
    cur_budget = budget_ceil if not adaptive else max(
        budget_floor, min(budget_ceil, 512)
    )

    dead_u, dead_x, dead_L, dead_w, dead_mask = [], [], [], [], []
    # dead-point coordinates are reconstructed host-side from pile snapshots
    # (chunks stream pile *indices* only — see engine.DeadChunk); pending
    # index chunks are flushed before any event that invalidates indices
    # (pile compaction) and at end of run
    pending_idx = []

    pile_cache = {}

    def fetch_pile_prefix(st):
        # Cached per state so the end-of-run tail reconstruction reuses the
        # fetch the dead-point resolution just made. Two strategies:
        # - checkpointing runs fetch at cadence, so slice only the used
        #   prefix (bucketed to 64Ki rows: a handful of slice executables,
        #   each compiled once and reused many times);
        # - without checkpoints this fires ONCE at end of run, where
        #   compiling a slice executable would cost more than fetching the
        #   raw full-capacity buffers (~84 MB, no compile).
        n = int(st.pile_size)
        cap = st.pile_u.shape[0]
        n_pad = min(cap, ((n + 65535) // 65536) * 65536) or min(cap, 65536)
        key = (id(st.pile_u), n_pad)
        if pile_cache.get("key") != key:
            pile_cache["key"] = key
            if checkpoint_dir is None:
                pile_cache["u"] = jax.device_get(st.pile_u)[:n_pad]
                pile_cache["x"] = jax.device_get(st.pile_x)[:n_pad]
            else:
                pile_cache["u"] = np.asarray(st.pile_u[:n_pad])
                pile_cache["x"] = np.asarray(st.pile_x[:n_pad])
        return pile_cache["u"], pile_cache["x"]

    def resolve_pending(st):
        if not pending_idx:
            return
        # Every pending index is < pile_size by construction (indices were
        # written before this state).
        pile_u, pile_x = fetch_pile_prefix(st)
        for idx in pending_idx:
            safe = np.maximum(idx, 0)
            u = pile_u[safe]
            x = pile_x[safe]
            u[idx < 0] = 0.0
            x[idx < 0] = 0.0
            dead_u.append(u)
            dead_x.append(x)
        pending_idx.clear()

    running = np.ones(D, bool)
    reporter = ProgressReporter(enabled=progress, ndata=D)
    chunk_index = 0
    prev_it = 0
    saved_chunks = 0
    interrupted = False
    resumed_pile_size = None
    resumed_growth = None
    if max_chunks is not None and checkpoint_dir is None:
        raise ValueError("max_chunks (graceful preemption) requires "
                         "checkpoint_dir to persist the partial run")

    if checkpoint_dir is not None:
        from massivedatans_tpu.io import checkpoint as ckpt

        if ckpt.has_checkpoint(checkpoint_dir):
            log.info("resuming from checkpoint %s", checkpoint_dir)
            state = ckpt.load_state(checkpoint_dir, state)
            if mesh is not None:
                from massivedatans_tpu.parallel import sharded as sharded_lib

                state = sharded_lib.shard_state(state, mesh)
            host = ckpt.load_host(checkpoint_dir)
            running = host["running"]
            if "prev_pile_size" in host:  # compaction predictor continuity
                resumed_pile_size = int(host["prev_pile_size"])
                resumed_growth = int(host["growth_est"])
            meta = ckpt.load_meta(checkpoint_dir)
            chunk_index = int(meta["chunk_index"])
            prev_it = int(meta["iteration"])
            saved_chunks = chunk_index
            for c in ckpt.load_chunks(checkpoint_dir)[:chunk_index]:
                dead_u.append(c["u"]); dead_x.append(c["x"])
                dead_L.append(c["L"]); dead_w.append(c["w"])
                dead_mask.append(c["mask"])
            if cfg.use_groups and D > 1 and running.any():
                # re-derive the advisory group labels the original run
                # applied right after this state's report (they are applied
                # to newest_state post-save, so the saved pytree carries the
                # previous labels) — keeps a lookahead-0 resume bit-identical
                from massivedatans_tpu.ns import subsets as subsets_lib

                labels, n_groups = subsets_lib.component_labels(
                    np.asarray(state.live_idx), selected=running,
                    nlive_points=K,
                )
                state = state._replace(
                    group_id=jnp.asarray(np.maximum(labels, 0), jnp.int32),
                    n_groups=jnp.int32(max(n_groups, 1)),
                )

    final_logZ = np.full(D, -np.inf, np.float64)
    final_H = np.zeros(D, np.float64)
    rep = None
    debug_timing = bool(int(os.environ.get("MDT_DEBUG_TIMING", "0")))
    debug_prev_rounds = 0
    show_shelves = bool(int(os.environ.get("MDT_SHELF_STATUS", "0")))
    # tracing hook (survey §5): MDT_PROFILE_DIR=<dir> captures a jax
    # profiler trace of the first few chunks for xprof/tensorboard
    profile_dir = os.environ.get("MDT_PROFILE_DIR")
    profile_chunks = int(os.environ.get("MDT_PROFILE_CHUNKS", "3"))
    if profile_dir:
        jax.profiler.start_trace(profile_dir)

    timing["init_s"] = time.time() - t0

    # --- pipelined chunk dispatch ---
    # `pipeline` holds chunks already dispatched to the device; with
    # cfg.pipeline_lookahead > 0 the device computes chunk k+1 while the host
    # blocks on chunk k's packed report, hiding the dispatch/transfer round
    # trip. Dispatch order is a pure chain of states, so
    # results are identical to synchronous execution — the only costs are up
    # to `lookahead` wasted no-op chunks after on-device termination (the
    # fill loop exits immediately once nothing is running) and group labels
    # steering dispatches one chunk later.
    from collections import deque

    pipeline = deque()  # (state, report_buf) in dispatch order
    newest_state = state
    compact_due = False
    lookahead = max(0, cfg.pipeline_lookahead)
    # Compaction must trigger EARLY enough that the pile cannot fill while
    # the pipeline drains: a report is up to `lookahead` chunks stale, and the
    # in-flight chunks keep appending points after the threshold is observed.
    # Track the largest per-chunk pile growth seen and compact once the
    # predicted post-drain size (with a 2x safety factor) would exceed
    # capacity, in addition to the static 85% floor.
    prev_pile_size = resumed_pile_size
    growth_est = resumed_growth or 0

    ctl_prev_rounds = None  # fill_rounds counter at the previous report

    # Host ledger mirror for dead-row reconstruction: per-row running masks
    # and slab widths are NOT streamed (engine.chunk_report_parts) — the
    # host replays the device's f32 ledger recurrence from the chunk-start
    # values (end values of the previous chunk / the resumed state), using
    # the device's own f32 constants from the meta buffer, so the replay is
    # bit-identical IEEE arithmetic.
    led_vol = np.asarray(state.logVolremaining, np.float32).copy()
    led_lw = np.asarray(state.logwidth, np.float32).copy()

    # group-label refresh cadence: live_idx is the dominant meta payload at
    # large D and labels are advisory — see config.group_refresh_chunks
    group_every = cfg.group_refresh_chunks or (1 if K * D <= 1 << 20 else 4)
    dispatch_counter = 0

    def dispatch_chunk():
        nonlocal newest_state, dispatch_counter, big_batch_chunks
        use_run = run_big if (run_big is not None and big_active) else run
        if use_run is run_big:
            big_batch_chunks += 1
        if adaptive:
            st, dead = use_run(problem, newest_state, jnp.int32(cur_budget))
        else:
            st, dead = use_run(problem, newest_state)
        with_live_idx = (
            cfg.use_groups and D > 1
            and dispatch_counter % group_every == 0
        )
        dispatch_counter += 1
        # split report: a small meta buffer (fetched per chunk) plus the
        # [2, T, D] dead block, of which only the executed-row prefix is
        # fetched once the meta reveals the row count — the block is the
        # dominant device->host payload (T x D x 8 bytes), and a
        # single-dispatch run executes only ~half its buffer.
        # Termination itself runs on-device (engine.device_termination),
        # so the host loop only streams results and handles
        # compaction/checkpoints/progress.
        meta_buf, block = engine_lib.chunk_report_parts(
            st, dead, K, with_live_idx=with_live_idx)
        # start the D2H copy as soon as the chunk finishes computing: with
        # lookahead > 0 several chunks are in flight, and each fetch's round
        # trip would otherwise serialize on the blocking np.asarray below
        try:
            meta_buf.copy_to_host_async()
            # large-D runs execute their full chunk buffer every chunk
            # (rows == T until global termination), so the whole block can
            # start its transfer now and overlap the host's ledger
            # replay of the previous chunk; at small D only the executed
            # prefix is worth fetching, decided after the meta arrives
            if D >= 1024:
                block.copy_to_host_async()
        except AttributeError:  # non-jax array (tests stubbing run())
            pass
        newest_state = st
        pipeline.append((st, meta_buf, block))

    while running.any() or pipeline:
        if running.any() and not compact_due:
            while len(pipeline) < 1 + lookahead:
                dispatch_chunk()
        elif not pipeline:
            break
        state, meta_buf, block = pipeline.popleft()
        t_c0 = time.time()
        meta = np.asarray(meta_buf)  # blocks until the chunk finishes
        t_meta = time.time()
        # the meta buffer is O(D) bytes (~RTT to fetch), so this wait is
        # almost entirely the device still computing the chunk: report it
        # separately from the block transfer so "transfer-bound" vs
        # "device-bound" is a measurement, not an inference
        timing["compute_wait_s"] = timing.get("compute_wait_s", 0.0) + (
            t_meta - t_c0)
        rep = engine_lib.parse_meta(meta, D, K)
        it = rep["iteration"]
        # the chunk's while_loop exits early once every dataset terminates:
        # only the first (iteration delta) dead-buffer rows were written
        rows = it - prev_it
        it_base = prev_it
        prev_it = it
        if rows > 0:
            # bucketed prefix fetch: power-of-two row counts (>= 64) so the
            # device slice reuses a handful of executables across chunks
            T = cfg.chunk_iters
            rows_pad = 64
            while rows_pad < rows:
                rows_pad *= 2
            rows_pad = min(rows_pad, T)
            t_f0 = time.time()
            blk = np.asarray(block[:, :rows_pad] if rows_pad < T else block)
            timing["fetch_s"] = timing.get("fetch_s", 0.0) + (
                time.time() - t_f0)
            timing["fetch_bytes"] = timing.get("fetch_bytes", 0.0) + float(
                blk.nbytes + meta.nbytes)
            rep.update(engine_lib.parse_dead_block(blk, rows))
            # --- reconstruct running masks: running is monotone; a dead
            # row at global iteration I was recorded BEFORE that
            # iteration's termination check, so the dataset counts as
            # running iff it had not terminated at an earlier iteration
            term = rep["term_iter"]  # [D]; -1 while still running
            r_glob = it_base + 1 + np.arange(rows)  # iteration value per row
            rep["running"] = (term < 0)[None, :] | (
                r_glob[:, None] <= term[None, :])
            # --- replay the f32 volume-ledger recurrence for slab widths
            adv = rep["idx"] >= 0
            C = rep["lw_const"]
            dv = rep["dv_const"]
            led_vol0, led_lw0 = led_vol.copy(), led_lw.copy()
            w_rows = np.empty((rows, D), np.float32)
            for r in range(rows):
                a = adv[r]
                led_lw = np.where(a, C + led_vol, led_lw).astype(np.float32)
                w_rows[r] = led_lw
                led_vol = np.where(a, led_vol - dv, led_vol)
            rep["logwidth"] = w_rows
            if not (np.array_equal(led_vol, rep["logVol_end"])
                    and np.array_equal(led_lw, rep["logwidth_end"])):
                # The replay is supposed to be BIT-exact (same f32 ops, same
                # constants); drift means an XLA fusion/precision change
                # broke that contract and the per-row widths just appended
                # are approximate. Escalate: recompute this chunk's widths
                # by a float64 replay anchored so the chunk END matches the
                # device (error then ~f32 ulp per row instead of
                # compounding), count the event into stats, and raise under
                # MDT_STRICT_LEDGER so CI catches a systematic mismatch.
                ledger_drift_chunks += 1
                log.warning(
                    "ledger replay drifted from device values "
                    "(max dvol=%.3g, dlw=%.3g) — recomputing chunk widths "
                    "in f64 and resyncing",
                    np.abs(led_vol - rep["logVol_end"]).max(),
                    np.abs(led_lw - rep["logwidth_end"]).max(),
                )
                if os.environ.get("MDT_STRICT_LEDGER", "0") == "1":
                    raise RuntimeError(
                        "volume-ledger host replay drifted from device "
                        "values (MDT_STRICT_LEDGER=1)"
                    )
                vol64 = led_vol0.astype(np.float64)
                lw64 = led_lw0.astype(np.float64)
                for r in range(rows):
                    a = adv[r]
                    lw64 = np.where(a, np.float64(C) + vol64, lw64)
                    w_rows[r] = lw64.astype(np.float32)
                    vol64 = np.where(a, vol64 - np.float64(dv), vol64)
            # resync to the device's end-of-chunk ledger either way: drift
            # can never compound across chunks
            led_vol = rep["logVol_end"].copy()
            led_lw = rep["logwidth_end"].copy()
        else:  # no-op chunk after on-device termination (lookahead tail)
            rep.update(dict(
                logwidth=np.zeros((0, D), np.float32),
                running=np.zeros((0, D), bool),
                L=np.zeros((0, D), np.float32),
                idx=np.zeros((0, D), np.int32),
            ))
        t_c1 = time.time()
        d_run = rep["running"][:rows]
        pending_idx.append(rep["idx"][:rows])
        dead_L.append(rep["L"][:rows])
        dead_w.append(
            np.where(d_run, rep["logwidth"][:rows], -np.inf).astype(np.float32)
        )
        dead_mask.append(d_run)
        chunk_index += 1
        rounds_used = (rep.get("fill_rounds", 0) - ctl_prev_rounds
                       if ctl_prev_rounds is not None else None)
        ctl_prev_rounds = rep.get("fill_rounds", 0)
        if adaptive:
            # per-round device cost from THIS chunk's blocked wait and
            # fill-round consumption -> budget that fits the target wall.
            # Under lookahead the wait underestimates device time when
            # compute overlaps host work, so growth is damped (1.5x) while
            # decrease is immediate; the first chunk (compile-carrying) is
            # skipped via ctl_prev_rounds None-init on resume boundaries.
            if rounds_used and rounds_used > 0 and chunk_index > 1:
                per_round = max(t_c1 - t_c0, 1e-4) / rounds_used
                want = int(dispatch_target_s / per_round)
                cur_budget = int(
                    max(budget_floor,
                        min(budget_ceil, int(cur_budget * 1.5), want))
                )
        if (run_big is not None and rounds_used is not None
                and rounds_used >= 0 and rows > 0):
            # escalate once fills need clearly more than one round per
            # iteration; de-escalate when the big batch is back to ~1
            # round/iter (the small batch then needs <= scale wall-flat
            # rounds, and evaluates proportionally fewer candidates).
            # Reports lag dispatches by `lookahead` chunks, so switches
            # apply a chunk late — purely a throughput heuristic, the
            # trajectory stays correct under either executable.
            rpi = rounds_used / rows
            if not big_active and rpi > 2.5:
                big_active = True
                log.info(
                    "fill rounds/iter %.1f: escalating eval_batch %d -> %d",
                    rpi, cfg.eval_batch, cfg.eval_batch_max,
                )
            elif big_active and rpi <= 1.05:
                big_active = False
                log.info(
                    "fill rounds/iter %.2f: back to eval_batch %d",
                    rpi, cfg.eval_batch,
                )
        final_logZ, final_H = rep["logZ"], rep["H"]
        newly_done = running & ~rep["running_final"]
        running = rep["running_final"].copy()
        stalled_out = newly_done & (
            rep["stall_count"] > engine_lib.resolve_stall_limit(cfg)
        )
        if stalled_out.any():
            log.warning(
                "%d datasets force-terminated on device after stalling "
                "(stall counts up to %d)", int(stalled_out.sum()),
                int(rep["stall_count"][stalled_out].max()),
            )
        reporter.update(
            it=it,
            ndraws=rep["ndraws"],
            running=int(running.sum()),
            logZ0=float(np.logaddexp(rep["logZ"][0], rep["rem_logZ"][0]))
            if D else 0.0,
            # shelf-occupancy sparkline (reference shelf_status). Opt-in:
            # reading shelves.count costs one extra device fetch per chunk
            shelves=shelf_sparkline(
                np.asarray(state.shelves.count), cfg.shelf_capacity
            ) if show_shelves else "",
        )
        # compaction predictor (updated before checkpointing so a resumed
        # run continues it rather than re-learning, keeping the compaction
        # schedule — and therefore the dispatch chain — deterministic)
        ps = rep["pile_size"]
        if prev_pile_size is not None and ps >= prev_pile_size:
            growth_est = max(growth_est, ps - prev_pile_size)
        prev_pile_size = ps

        hit_max_chunks = (
            max_chunks is not None and chunk_index >= max_chunks
            and running.any()
        )
        if checkpoint_dir is not None and (
            chunk_index % checkpoint_every == 0 or not running.any()
            or hit_max_chunks
        ):
            # chunk files persist coordinates, so pending indices are
            # resolved (one pile fetch) only at checkpoint cadence — resume
            # reads exactly the chunks up to meta's chunk_index, so files
            # written in batches here are equivalent to per-chunk writes
            resolve_pending(state)
            while saved_chunks < chunk_index:
                ckpt.save_chunk(checkpoint_dir, saved_chunks, dict(
                    u=dead_u[saved_chunks], x=dead_x[saved_chunks],
                    L=dead_L[saved_chunks], w=dead_w[saved_chunks],
                    mask=dead_mask[saved_chunks],
                ))
                saved_chunks += 1
            ckpt.save_state(
                checkpoint_dir, state,
                host_ctx=dict(running=running,
                              prev_pile_size=np.int64(prev_pile_size),
                              growth_est=np.int64(growth_est)),
                meta=dict(chunk_index=chunk_index, ndata=D,
                          nlive=K, iteration=it),
            )
        if hit_max_chunks:
            # graceful preemption: in-flight pipeline chunks are discarded
            # (they are beyond the checkpoint); resume re-runs them
            log.info("max_chunks=%d reached: checkpointed and stopping",
                     max_chunks)
            interrupted = True
            break
        if not running.any() and not pipeline:
            break
        # compaction must see every in-flight chunk's indices first (they
        # reference the pre-compaction pile): stop dispatching, drain the
        # pipeline, then compact the newest state
        predicted_peak = ps + 2 * (len(pipeline) + 1) * max(growth_est, 1)
        compact_due = compact_due or (ps > 0.85 * pile_cap) or (
            predicted_peak > pile_cap
        )
        if ps >= pile_cap:
            log.warning(
                "point pile hit capacity (%d); accepted candidates were "
                "dropped on device — raise cfg.pile_capacity", pile_cap,
            )
        if compact_due and not pipeline and running.any():
            resolve_pending(state)  # indices reference the pre-compaction pile
            state = compact_pile(state)
            newest_state = state
            compact_due = False
        if profile_dir and chunk_index == profile_chunks:
            jax.profiler.stop_trace()
            profile_dir = None
        t_c2 = time.time()
        timing["block_s"] += t_c1 - t_c0
        timing["host_s"] += t_c2 - t_c1
        if (cfg.use_groups and D > 1 and running.any()
                and "live_idx" in rep):
            # advisory group decomposition for focused draws (ns/subsets.py);
            # replaces reference igraph clusters(); live_idx rides in the
            # packed report on the group_refresh_chunks cadence (16 MB +
            # ~3 s of host union-find per chunk at D=10^4 otherwise).
            # Labels steer the NEXT dispatch (under lookahead, one chunk
            # later) — purely advisory, correctness never depends on them.
            from massivedatans_tpu.ns import subsets as subsets_lib

            labels, n_groups = subsets_lib.component_labels(
                rep["live_idx"], selected=running, nlive_points=K
            )
            newest_state = newest_state._replace(
                group_id=jnp.asarray(np.maximum(labels, 0), jnp.int32),
                n_groups=jnp.int32(max(n_groups, 1)),
            )
        timing["groups_s"] += time.time() - t_c2
        if debug_timing:
            import sys

            # under pipelining, device compute overlaps the host: `wait` is
            # the time blocked on this chunk's packed report (residual device
            # time + transfer), `host` the stream/checkpoint/compact work,
            # `groups` the advisory decomposition
            # `adv`: dataset-advances this chunk vs the ideal
            # rows x running — the gap is ledger-skipped iterations
            # (fills truncated by the round budget), the real progress
            # rate when fills escalate
            n_adv = int((np.asarray(rep["idx"][:rows]) >= 0).sum())
            print(
                "chunk %d: wait=%.0fms host=%.0fms groups=%.0fms rounds=%d"
                " adv=%d/%d"
                % (chunk_index, 1e3 * (t_c1 - t_c0),
                   1e3 * (t_c2 - t_c1), 1e3 * (time.time() - t_c2),
                   rep.get("fill_rounds", 0) - debug_prev_rounds,
                   n_adv, rows * max(int(running.sum()), 1)),
                file=sys.stderr, flush=True,
            )
            debug_prev_rounds = rep.get("fill_rounds", 0)

    if profile_dir:
        jax.profiler.stop_trace()

    if rep is None:  # resumed checkpoint that was already complete
        rep = dict(
            iteration=int(state.iteration),
            ndraws=int(state.ndraws),
            pile_size=int(state.pile_size),
            stall_max=int(np.asarray(state.stall_count).max(initial=0)),
            stall_count=np.asarray(state.stall_count, np.int64),
            member_overflow=int(state.member_overflow),
            fill_rounds=int(state.fill_rounds),
            last_logwidth=np.asarray(state.last_logwidth, np.float64),
            rem_logZ=np.asarray(state.rem_logZ, np.float64),
            rem_logZerr=np.asarray(state.rem_logZerr, np.float64),
        )
        final_logZ = np.asarray(state.logZ, np.float64)
        final_H = np.asarray(state.H, np.float64)
        if not dead_u:
            dead_u.append(np.zeros((0, D, ndim), np.float32))
            dead_x.append(np.zeros((0, D, ndim), np.float32))
            dead_L.append(np.zeros((0, D), np.float32))
            dead_w.append(np.zeros((0, D), np.float32))
            dead_mask.append(np.zeros((0, D), bool))

    t_tail0 = time.time()
    resolve_pending(state)

    # Terminated datasets' live points are frozen by the running mask, so
    # every posterior tail (multi_nested_sampler.py remainder(), integrator
    # :149-151,163-171) is captured once here. Only the sorted [K, D]
    # indices + L are fetched; coordinates are gathered from the
    # host-side pile prefix (the fetch resolve_pending just made/cached) —
    # the [K, D, ndim] device blocks would be ~100 MB at D=10^4.
    ti, tL = engine_lib.capture_tails_idx(state)
    tails_idx = np.asarray(ti)
    tails_L = np.asarray(tL)
    pile_u_host, pile_x_host = fetch_pile_prefix(state)
    tails_u = pile_u_host[tails_idx]
    tails_x = pile_x_host[tails_idx]
    timing["tail_s"] = time.time() - t_tail0
    if timing.get("fetch_s", 0) > 0:
        timing["fetch_MBps"] = (
            timing["fetch_bytes"] / 1e6) / timing["fetch_s"]
    tails_w = rep["last_logwidth"].astype(np.float32)
    last_remainderZ = rep["rem_logZ"]
    last_remainderZerr = rep["rem_logZerr"]
    logZerr_running = np.sqrt(np.maximum(final_H, 0.0) / K)

    niter = int(rep["iteration"])
    u = np.concatenate(dead_u, axis=0)[:niter]
    x = np.concatenate(dead_x, axis=0)[:niter]
    L = np.concatenate(dead_L, axis=0)[:niter]
    w = np.concatenate(dead_w, axis=0)[:niter]
    mask = np.concatenate(dead_mask, axis=0)[:niter]

    # --- append live-point tail rows (multi_nested_integrator.py:163-169) ---
    tail_mask = np.ones((K, D), bool)
    tail_w = np.broadcast_to(tails_w[None, :], (K, D)).astype(np.float32)
    u = np.concatenate([u, tails_u], axis=0)
    x = np.concatenate([x, tails_x], axis=0)
    L = np.concatenate([L, tails_L], axis=0)
    w = np.concatenate([w, tail_w], axis=0)
    mask = np.concatenate([mask, tail_mask], axis=0)

    logZ_final = np.logaddexp(final_logZ, last_remainderZ)
    logZerr_final = logZerr_running + last_remainderZerr
    duration = time.time() - t0
    reporter.finish(niter=niter, ndraws=rep["ndraws"], duration=duration)

    return NSResult(
        logZ=logZ_final,
        logZerr=logZerr_final,
        u=u,
        x=x,
        L=L,
        w=w,
        mask=mask,
        information=final_H,
        niterations=niter,
        ndraws=rep["ndraws"],
        duration=duration,
        stats=dict(
            ndraws=rep["ndraws"],
            duration=duration,
            ndata=D,
            niter=niter,
            stalled=rep["stall_max"],
            member_overflow=rep["member_overflow"],
            fill_rounds=rep.get("fill_rounds", 0),
            pile_peak=rep["pile_size"],
            interrupted=interrupted,
            # per-dataset quality flags (VERDICT r1 #5): evidences of
            # datasets force-terminated after stalling are truncated and
            # must be identifiable in the output files
            stall_count=np.asarray(
                rep.get("stall_count", np.zeros(D)), np.int64),
            stalled_mask=np.asarray(
                rep.get("stall_count", np.zeros(D))
                > engine_lib.resolve_stall_limit(cfg)
            ),
            timing={k: round(v, 3) for k, v in timing.items()},
            ledger_drift_chunks=ledger_drift_chunks,
            fill_budget_last=int(cur_budget) if adaptive else None,
            # chunks dispatched at the escalated eval batch (cfg.eval_batch_max)
            big_batch_chunks=big_batch_chunks,
        ),
    )
