"""The joint nested-sampling engine: one jitted step over all datasets.

Accelerator re-design of reference ``multi_nested_sampler.py:49-569``:

- The point pile, live-point index matrix and shelves are static-shape
  device arrays inside one state pytree (survey §7 design translation).
- The reference's scalar rejection loop ("draw one candidate, test
  ``any(L > Lmins)``", hiermetriclearn.py:179-196) becomes a
  ``lax.while_loop`` over *proposal batches*: each round proposes a batch
  from the region, scores it against every dataset in one matmul, and
  scatters all acceptances into all shelves at once — strictly more
  evaluation re-use than the reference.
- Superset draws for the first ``nsuperset_draws`` rounds, then focused
  draws whose region is rebuilt from only the empty-shelf datasets' live
  points (reference ``__next__`` policy, multi_nested_sampler.py:365-392).
- The streaming logZ/H update (reference ``multi_nested_integrator.py:
  105-161``) runs on-device as part of the same step, so a whole chunk of
  NS iterations is one device dispatch.

Race-free by construction: all shelf/pile writes are pure functional
scatters (the reference's OpenMP likelihood had a shared-index race and is
disabled, clike.c:32).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from massivedatans_tpu.config import RunConfig
from massivedatans_tpu.models.base import Problem
from massivedatans_tpu.ns import shelves as shelves_lib
from massivedatans_tpu.ns.region import Region, ball_offsets
from massivedatans_tpu.ns.shelves import Shelves

_NEG_INF = -jnp.inf


class EngineState(NamedTuple):
    key: jax.Array
    # --- point pile (multi_nested_sampler.py:106-107) ---
    pile_u: jax.Array      # [P, ndim]
    pile_x: jax.Array      # [P, ndim]
    pile_size: jax.Array   # scalar int32
    # --- live points (multi_nested_sampler.py:108-111) ---
    live_idx: jax.Array    # [K, D] int32 indices into the pile
    live_L: jax.Array      # [K, D]
    shelves: Shelves
    running: jax.Array     # [D] bool (replaces cut_down reshapes; survey §7)
    Lmax: jax.Array        # [D]
    # --- integration state (multi_nested_integrator.py:90-122) ---
    logZ: jax.Array        # [D]
    H: jax.Array           # [D]
    # Per-dataset volume ledger. The reference shares one logwidth across
    # datasets (multi_nested_integrator.py:107-110) because every dataset
    # advances every iteration; here a dataset can SKIP an iteration (shelf
    # unfilled within the fill budget/round cap), and a shared ledger would
    # silently drop that dataset's volume shell — a logZ-low bias. Each
    # dataset's prior volume therefore shrinks only when it advances.
    logVolremaining: jax.Array  # [D]
    logwidth: jax.Array    # [D], current slab width at each dataset's depth
    last_logwidth: jax.Array    # [D], frozen at termination
    rem_logZ: jax.Array    # [D] remainder logZ, frozen at termination
    rem_logZerr: jax.Array  # [D] remainder logZerr, frozen at termination
    iteration: jax.Array   # scalar int32
    ndraws: jax.Array      # scalar int32: likelihood-evaluated candidates
    # --- region cache (force_shrink memory, hiermetriclearn.py:53-55) ---
    prev_scale: jax.Array  # [ndim]
    prev_radius: jax.Array  # scalar
    # --- group decomposition advisory (host-computed, ns/subsets.py) ---
    group_id: jax.Array    # [D] int32 connected-component label
    n_groups: jax.Array    # scalar int32 (>= 1)
    # --- phantom points (friends.py:54-59,81-84 keep_phantom_points) ---
    phantom_idx: jax.Array  # [Q] int32 pile rows; -1 = empty slot
    phantom_L: jax.Array    # [Q] their likelihoods (top-Q dead points)
    # --- termination record (host reconstructs per-row running masks) ---
    term_iter: jax.Array    # [D] int32: iteration at which the dataset left
                            # ``running`` (-1 while running). Running is
                            # monotone, so dead-row masks need not be
                            # streamed: row r is running iff term_iter < 0
                            # or r+1 <= term_iter.
    # --- diagnostics ---
    stall_count: jax.Array  # [D] int32: fill rounds exhausted with empty shelf
    member_overflow: jax.Array  # scalar int32: unique live points > capacity events
    fill_rounds: jax.Array  # scalar int32: cumulative fill rounds (each one
                            # proposal batch evaluated) — the unit of device
                            # work the per-chunk budget meters
    draws_at_rebuild: jax.Array  # scalar int32: ndraws at the last main-
                            # geometry rebuild (draw-based rebuild cadence,
                            # reference rebuild_every=1000 draws,
                            # hiermetriclearn.py:200-211)


class DeadChunk(NamedTuple):
    """Per-iteration dead points streamed back to the host integrator.

    Coordinates are NOT streamed: ``idx`` references the (replicated) point
    pile, and the host reconstructs ``u``/``x`` from a single pile snapshot
    fetched at compaction boundaries / end of run — at 10^4 datasets the
    per-chunk transfer would otherwise be dominated by redundant coordinate
    copies (every dataset's dead point is some shared pile row).
    """

    idx: jax.Array       # [T, D] int32 pile rows (-1 where not advanced)
    L: jax.Array         # [T, D] (-inf where not advanced)
    logwidth: jax.Array  # [T, D] per-dataset slab widths
    running: jax.Array   # [T, D]


def _safe_logaddexp_update(logZ, H, wi, Li):
    """One streaming (logZ, H) nested-sampling update, -inf-safe."""
    logZnew = jnp.logaddexp(logZ, wi)
    t1 = jnp.exp(wi - logZnew) * Li
    old = jnp.exp(logZ - logZnew) * (H + logZ)
    t2 = jnp.where(jnp.isfinite(logZ), old, 0.0)
    Hnew = t1 + t2 - logZnew
    return logZnew, Hnew


def _global_any(x, axis_name):
    """any() over the local array, then over the dataset mesh axis."""
    local = jnp.any(x)
    if axis_name is None:
        return local
    return jax.lax.psum(local.astype(jnp.int32), axis_name) > 0


def _global_or_rows(x, axis_name):
    """Elementwise OR of a per-candidate bool vector across shards.

    Used for the pile-replication vote: a candidate accepted by *any* shard's
    datasets is appended to every shard's (identical) pile, keeping pile
    indices globally consistent without gathering point coordinates.
    """
    if axis_name is None:
        return x
    return jax.lax.psum(x.astype(jnp.int32), axis_name) > 0


def _dedup_random(flat, capacity: int, key):
    """Compact the unique non-negative entries of an int vector, ordered by
    a bijective pseudo-random hash. When more than ``capacity`` unique
    values exist, the kept subset is therefore a uniform RANDOM subsample —
    a random subsample of live points plus the bootstrapped cover radius is
    still a valid RadFriends region (the out-of-bag members are covered by
    construction), whereas any deterministic (e.g. oldest-first) subset can
    systematically miss whole modes and collapse the proposal acceptance."""
    a = jax.random.bits(key, dtype=jnp.uint32) | jnp.uint32(1)  # odd
    # Invalid slots carry flat=-1; the bijection maps it to a*0 = 0 and the
    # final complement sends it to 0xFFFFFFFF, which sorts last. Because the
    # composite map flat -> ~(a*(flat+1)) is itself bijective mod 2^32 and
    # the sentinel is the IMAGE of the out-of-domain input -1, no valid
    # flat (flat+1 >= 1) can ever collide with it. (A where()-assigned
    # sentinel would be reachable by its one valid preimage and silently
    # drop that member from the region, ~n/2^32 per rebuild.)
    h = ~(a * (jnp.where(flat >= 0, flat, -1).astype(jnp.uint32)
               + jnp.uint32(1)))
    # sort the KEYS ALONE and recover the values through the hash's modular
    # inverse: h is bijective (odd multiplier mod 2^32), so
    # flat = h * a^-1 - 1 exactly in u32 arithmetic. An argsort carries a
    # payload through the comparator network and the two 400k-element
    # random gathers it implies measured 15.5 ms per geometry rebuild at
    # D=1000 (the single dominant engine cost, ~60% of steady-state chunk
    # time at the default rebuild cadence); jnp.sort of bare u32 keys is
    # 1.8 ms. Newton iteration gives the inverse of an odd a mod 2^32 in
    # 5 multiplies (x_{k+1} = x_k (2 - a x_k) doubles correct bits).
    a_inv = a
    for _ in range(5):
        a_inv = a_inv * (jnp.uint32(2) - a * a_inv)
    sh = jnp.sort(h)
    sv_u = (~sh) * a_inv - jnp.uint32(1)
    valid = sh != jnp.uint32(0xFFFFFFFF)
    sv = jnp.where(valid, sv_u, jnp.uint32(0)).astype(jnp.int32)
    first = jnp.concatenate([valid[:1], (sh[1:] != sh[:-1]) & valid[1:]])
    pos = jnp.cumsum(first) - 1
    n_unique = first.sum().astype(jnp.int32)
    write_pos = jnp.where(first & (pos < capacity), pos, capacity)
    members_idx = jnp.zeros((capacity,), jnp.int32).at[write_pos].max(
        jnp.where(first, sv, 0), mode="drop"
    )
    n_kept = jnp.minimum(n_unique, capacity)
    member_mask = jnp.arange(capacity) < n_kept
    # canonical (ascending) order of the kept subset: the RANDOMNESS decides
    # which points survive an overflow, but the output ordering must not
    # depend on the hash, so single-device and mesh paths (whose dedups use
    # different keys) emit bit-identical member arrays when no overflow
    # occurred
    order = jnp.argsort(jnp.where(member_mask, members_idx, jnp.int32(1 << 30)))
    members_idx = jnp.where(member_mask, members_idx[order], 0)
    return members_idx, member_mask, (n_unique > capacity).astype(jnp.int32)


def unique_members(live_idx, col_mask, capacity: int, key, axis_name=None,
                   extra_idx=None):
    """Compacted unique pile indices over the selected dataset columns.

    Replaces ``get_unique_pointsp`` (multi_nested_sampler.py:130-132). Returns
    ``(members_idx[M], member_mask[M], overflowed)``; when more than
    ``capacity`` unique points exist a random subset is kept (see
    ``_dedup_random``) and ``overflowed`` is set.

    ``extra_idx``: additional pile rows (phantom points, friends.py:81-84)
    deduplicated into the member set alongside the live columns; slots
    holding -1 are ignored.

    Under a dataset mesh (``axis_name``), the per-shard unique sets are
    all-gathered (pile indices are globally consistent because the pile is
    replicated) and re-deduplicated, so every shard builds the same region
    from the union of live points — the multi-host region construction of
    survey §5. The key is derived from the replicated state key, so the
    random subsample is identical on every shard.
    """
    k1, k2 = jax.random.split(key)
    flat = jnp.where(col_mask[None, :], live_idx, -1).reshape(-1)
    if extra_idx is not None:
        flat = jnp.concatenate([flat, extra_idx])
    members_idx, member_mask, overflow = _dedup_random(flat, capacity, k1)
    if axis_name is None:
        return members_idx, member_mask, overflow
    gathered = jax.lax.all_gather(
        jnp.where(member_mask, members_idx, -1), axis_name
    ).reshape(-1)
    g_idx, g_mask, g_overflow = _dedup_random(gathered, capacity, k2)
    overflow = jnp.maximum(
        jax.lax.pmax(overflow, axis_name), g_overflow
    )
    return g_idx, g_mask, overflow


def _build_geometry_from(strategy, state: EngineState, col_mask, key,
                         cfg: RunConfig, member_capacity: int, axis_name=None,
                         carry_cap: bool = True):
    """Build the strategy geometry from the selected datasets' live points.

    ``carry_cap``: whether to pass the previous *global* build's force-shrink
    cap (``prev_scale``/``prev_radius``). The reference applies the cap only
    across rebuilds of the SAME constrainer instance (hiermetriclearn.py:
    88-91); a focused rebuild corresponds to a FRESH per-mask constrainer
    (cachedconstrainer.py:92-109, prev_maxdistance=None), so its — typically
    larger — subset radius must not be clamped by the global one. The cap is
    likewise dropped when the member set overflowed capacity: the random
    subsample is sparser than the full live set, and its bootstrapped radius
    must be allowed to GROW to keep the union-of-balls covering the contour.
    """
    key, k_dedup = jax.random.split(key)
    members_idx, member_mask, overflow = unique_members(
        state.live_idx, col_mask, member_capacity, k_dedup, axis_name,
    )
    members_u = state.pile_u[members_idx]
    if carry_cap:
        # build_region disables the cap when prev_radius == 0
        prev_radius = jnp.where(overflow > 0, 0.0, state.prev_radius)
    else:
        prev_radius = jnp.float32(0.0)
    # phantom members (the top-Q dead points, friends.py:79-84): appended as
    # extra ball centers AFTER the metric fit and radius estimate, which use
    # live members only — phantoms may only EXTEND the union's coverage,
    # never inflate the fitted scale or radius (the reference adds phantoms
    # to the member set only after maxdistance is computed and force-shrunk)
    Q = state.phantom_idx.shape[0]
    if Q > 0:
        extra_u = state.pile_u[jnp.maximum(state.phantom_idx, 0)]
        extra_mask = state.phantom_idx >= 0
    else:
        extra_u = extra_mask = None
    geom = strategy.build(
        members_u, member_mask, key, state.prev_scale, prev_radius,
        extra_u=extra_u, extra_mask=extra_mask,
    )
    return geom, overflow


def init_state(problem: Problem, key, cfg: RunConfig) -> EngineState:
    """Draw the initial live points, shared across all datasets
    (multi_nested_sampler.py:91-104: the same u serves every dataset)."""
    K = cfg.nlive_points
    D = problem.ndata
    ndim = problem.ndim
    P = cfg.resolve_pile_capacity(D)
    key, k_init = jax.random.split(key)
    u0 = jax.random.uniform(k_init, (K, ndim), dtype=jnp.float32)
    x0 = problem.transform_batch(u0)
    L0 = problem.loglike(x0)  # [K, D]

    pile_u = jnp.zeros((P, ndim), jnp.float32).at[:K].set(u0)
    pile_x = jnp.zeros((P, ndim), jnp.float32).at[:K].set(x0)
    live_idx = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32)[:, None], (K, D))

    return EngineState(
        key=key,
        pile_u=pile_u,
        pile_x=pile_x,
        pile_size=jnp.int32(K),
        live_idx=live_idx,
        live_L=L0.astype(jnp.float32),
        shelves=shelves_lib.init_shelves(cfg.shelf_capacity, D),
        running=jnp.ones((D,), bool),
        Lmax=L0.max(axis=0),
        logZ=jnp.full((D,), _NEG_INF, jnp.float32),
        H=jnp.zeros((D,), jnp.float32),
        logVolremaining=jnp.zeros((D,), jnp.float32),
        logwidth=jnp.full((D,), jnp.log1p(-jnp.exp(-1.0 / K)), jnp.float32),
        last_logwidth=jnp.zeros((D,), jnp.float32),
        rem_logZ=jnp.full((D,), _NEG_INF, jnp.float32),
        rem_logZerr=jnp.zeros((D,), jnp.float32),
        iteration=jnp.int32(0),
        ndraws=jnp.int32(K),
        prev_scale=jnp.zeros((ndim,), jnp.float32),
        prev_radius=jnp.float32(0.0),
        group_id=jnp.zeros((D,), jnp.int32),
        n_groups=jnp.int32(1),
        phantom_idx=jnp.full((cfg.phantom_capacity,), -1, jnp.int32),
        phantom_L=jnp.full((cfg.phantom_capacity,), _NEG_INF, jnp.float32),
        term_iter=jnp.full((D,), -1, jnp.int32),
        stall_count=jnp.zeros((D,), jnp.int32),
        member_overflow=jnp.int32(0),
        fill_rounds=jnp.int32(0),
        draws_at_rebuild=jnp.int32(0),
    )


def _column_proposals(pile_u, live_idx, empty, key, B: int,
                      norm: str = "euclidean", n_slots: int = 128):
    """Candidates drawn directly from empty-shelf datasets' own RadFriends
    regions (per-column union of balls around that dataset's live points).

    The group-cycled focused rebuilds visit one connected component per
    refocus; once the datasets decouple into hundreds of components (late
    MUSE runs, large-N tails) a single NS iteration would need O(groups)
    fill rounds. This proposal needs no member gather cap: pick an empty
    dataset, sample ITS ball union — every candidate lands in somebody's
    constrained region, and the shared [B, D] scoring still reuses it for
    every dataset. Equivalent to per-subset RadFriends sampling when
    components are singletons (the regime it activates in).

    Dual proposal per candidate, mirroring radfriendsregion.py:129-178 at
    per-column granularity: half the batch samples the column's whitened
    bounding box (+r) and keeps points inside the union; half samples a
    ball around a random live point with the 1/n_near multiplicity
    correction. The box half is load-bearing for throughput: late in a run
    a dataset's live points collapse into one tight cluster, every ball
    contains ~all K members, and ball-only sampling would thin acceptance
    to ~1/K (~0.25% at nlive=400) — the box path accepts at the
    union-to-box volume ratio, which is O(1) for a tight cluster.

    Slot structure: per-column geometry (jackknife radius, whitened bounds)
    is computed once for ``n_slots`` sampled empty columns, and the B raw
    candidates fan out over those slots. This bounds the O(K²·slots)
    jackknife pass independently of both B and D, so B can be 8-32×
    eval_batch (the caller compacts valid candidates to the front of the
    likelihood batch) without growing the K×K work or materializing
    [K, K, B] distance tensors.

    Per-slot whitening (NOT the caller's union metric): the reference fits
    a fresh metric on each member subset before building its region
    (hiermetriclearn.py:48-92 via cachedconstrainer); a union metric fitted
    across decoupled datasets is anisotropic relative to any single
    column's cluster (tight posterior dims look wide), so an isotropic
    ball/box in union coordinates over-covers each tight dim by the
    scale ratio — measured 1e-5 net acceptance on MUSE at iteration 5400
    vs ~1e-1 with per-column scaling.
    """
    K, D = live_idx.shape
    ndim = pile_u.shape[1]
    C = max(1, min(n_slots, D))
    kd, kslot, kslotb, kk, kball, kcoin, kbox = jax.random.split(key, 7)
    # slot assignment: a RANDOM subset of the empty columns (random
    # tiebreak within the empty/non-empty partition), padded with random
    # non-empty columns when fewer than C are empty (their unions just
    # join the proposal mixture — harmless). The tiebreak matters when
    # more than C columns are empty (plausible at D=4223, n_slots=128):
    # a stable index-order pick would starve high-indexed empty columns
    # of proposal mass until every lower-indexed one fills. When every
    # empty column is a slot (D <= n_slots, the common case), the ball
    # mixture is the full joint union over all unfilled datasets — the
    # reference's memberset union with per-column metrics.
    tiebreak = jax.random.uniform(kslotb, (D,))
    slot_cols = jnp.argsort(jnp.where(empty, tiebreak, 2.0 + tiebreak))[:C]
    U_slot = pile_u[live_idx[:, slot_cols]]               # [K, C, ndim]
    mean_c = jnp.mean(U_slot, axis=0)                     # [C, ndim]
    scale_c = jnp.std(U_slot, axis=0) + 1e-12             # [C, ndim]
    W = (U_slot - mean_c[None]) / scale_c[None]           # [K, C, ndim]

    # Per-column jackknife radius (the friends.py leave-one-out estimator,
    # per dataset) in the slot's own whitened frame: the caller's
    # union-region radius is fit on a — possibly overflow-subsampled —
    # union of separated clusters, so it can exceed one column's own
    # live-point scale by orders of magnitude, inflating the box volume by
    # (2r/cluster)^d and collapsing acceptance. One batched matmul over
    # the sampled columns' own points gives each column a cover radius at
    # its own scale.
    if norm == "chebyshev":
        d2_col = jnp.zeros((K, K, C), W.dtype)
        for dim in range(ndim):  # static, tiny; avoids a [K,K,C,ndim] temp
            diff = W[:, None, :, dim] - W[None, :, :, dim]
            d2_col = jnp.maximum(d2_col, jnp.square(diff))
    else:
        cross = jnp.einsum(
            "kcd,lcd->klc", W, W,
            precision=jax.lax.Precision.HIGHEST,
        )
        ss = jnp.sum(jnp.square(W), axis=-1)              # [K, C]
        d2_col = jnp.maximum(
            ss[:, None, :] + ss[None, :, :] - 2.0 * cross, 0.0
        )                                                 # [K, K, C]
    d2_col = d2_col + (1e30 * jnp.eye(K))[:, :, None]
    nn = jnp.min(d2_col, axis=1)                          # [K, C]
    radius_c = jnp.sqrt(jnp.maximum(jnp.max(nn, axis=0), 1e-24))  # [C]

    lo_c = jnp.min(W, axis=0) - radius_c[:, None]         # [C, ndim]
    hi_c = jnp.max(W, axis=0) + radius_c[:, None]

    # Slot choice restricted to slots whose column is STILL empty: slots
    # are assigned deterministically (argsort pads with non-empty columns
    # when few are empty), and candidates sent to already-full columns
    # are pure waste in the tail regime where only a handful of hard
    # columns keep the fill loop alive.
    #
    # Design note — candidates are corrected per-slot (own n_near) and
    # credit ONLY their source column, i.e. per-column RadFriends draws
    # batched across columns, the reference's per-subset constrained draw
    # (cachedconstrainer.py:92-109). Joint-uniform sampling over the
    # union of all slot unions (volume-weighted mixture + global n_near)
    # was tried and measured: the columns' unions overlap ~10^2-10^4-fold
    # in volume while their likelihood zones are disjoint islands, so the
    # global correction thinned ball validity to ~1e-4 (0 valid of 4096
    # at MUSE it=7800) — cross-dataset sharing is worthless exactly where
    # these rounds run, and single-credit keeps validity at the
    # per-column ~10-20%.
    slot_logits = jnp.where(empty[slot_cols], 0.0, -1e30)  # [C]
    slot = jax.random.categorical(kslot, slot_logits, shape=(B,))
    rad = radius_c[slot]                                  # [B]

    # box half: uniform in the column's whitened bounding box (+r)
    w_box = lo_c[slot] + (hi_c - lo_c)[slot] * jax.random.uniform(
        kbox, (B, ndim)
    )

    # ball half: around a random member of the column
    rows = jax.random.randint(kk, (B,), 0, K)
    c_w = W[rows, slot]                                   # [B, ndim]
    w_ball = c_w + ball_offsets(kball, B, ndim, rad[:, None], norm=norm)

    use_box = jnp.arange(B) < (B // 2)
    w = jnp.where(use_box[:, None], w_box, w_ball)
    u = w * scale_c[slot] + mean_c[slot]                  # per-slot unwhiten

    mem_w = W[:, slot, :]                                 # [K, B, ndim]
    sq = jnp.square(mem_w - w[None, :, :])
    if norm == "chebyshev":
        d2 = jnp.max(sq, axis=-1)  # [K, B]
    else:
        d2 = jnp.sum(sq, axis=-1)  # [K, B]
    nnear = (d2 < jnp.square(rad)).sum(axis=0)
    # box candidates: uniform-over-box ∩ union -> uniform over the union;
    # ball candidates: 1/n_near correction (n_near >= 1 by construction)
    ok_box = nnear > 0
    ok_ball = jax.random.uniform(kcoin, (B,)) * jnp.maximum(
        nnear, 1
    ).astype(jnp.float32) < 1.0
    ok = jnp.where(use_box, ok_box, ok_ball)
    in_cube = jnp.all((u > 0.0) & (u < 1.0), axis=1)
    cols = slot_cols[slot]
    return u, ok & in_cube & jnp.any(empty), cols.astype(jnp.int32)


def _fill_shelves(problem: Problem, state: EngineState, strategy, geom,
                  sstate, cfg: RunConfig, member_capacity: int,
                  axis_name=None, model_axis_name=None,
                  budget_left=None, live_bot=None):
    """Propose/evaluate/scatter until every running dataset has a queued
    candidate (reference __next__ fill loop, multi_nested_sampler.py:365-489).

    Under a dataset mesh, proposal batches are *replicated* (identical RNG on
    every shard) — that is the shared-evaluation trick across chips: each
    shard scores the same candidates against its own dataset shard. The only
    collectives are the fill-loop vote and the pile-replication vote.

    ``budget_left`` (int32 scalar) meters total fill rounds across a chunk:
    the loop also exits when it reaches zero, leaving shelves partially
    filled — datasets without a queued candidate simply skip this NS
    iteration (shelves persist, so the fill resumes next iteration/chunk).
    It bounds the device time of one dispatch. Returns
    ``(state, budget_left)``.
    """
    S = cfg.shelf_capacity
    # the reference's nsuperset_draws counts single candidates
    # (multi_nested_sampler.py:373); our rounds evaluate eval_batch at once
    nsuperset_rounds = max(1, -(-cfg.nsuperset_draws // cfg.eval_batch))
    focus_every = 8
    if live_bot is None:  # standalone use; ns_iteration passes the fused one
        live_bot = shelves_lib.live_bottom(state.live_L, S)
    # column-focused proposals need a Region geometry (radius + metric) and,
    # under a mesh, would break the replicated-proposal invariant (local
    # empties differ per shard) — static gate on both
    col_capable = (
        cfg.use_column_focus
        and axis_name is None
        and isinstance(geom, Region)
    )

    def need_more(shelves):
        return _global_any(state.running & (shelves.count == 0), axis_name)

    def cond(carry):
        (key, pile_u, pile_x, pile_size, shelves, ndraws, rnd, budget, geom,
         sstate, overflow, more) = carry
        return (rnd < cfg.max_fill_rounds) & (budget > 0) & more

    def body(carry):
        (key, pile_u, pile_x, pile_size, shelves, ndraws, rnd, budget, geom,
         sstate, overflow, more) = carry
        key, k_focus, k_prop, k_refresh = jax.random.split(key, 4)

        # Focused draws: after nsuperset_draws rounds, rebuild the geometry
        # from only the empty-shelf datasets' live points (the reference's
        # data_mask = empty_mask policy, multi_nested_sampler.py:375-381).
        def refocus(_):
            empty = state.running & (shelves.count == 0)
            # cycle focused rebuilds through host-computed connected
            # components (the reference's per-memberset regions,
            # multi_nested_sampler.py:415-460) — one group per refocus.
            # Past column_focus_groups components, cycling would visit each
            # component too rarely; rebuild from the UNION of empty datasets
            # instead — its bootstrapped radius/metric is a conservative
            # (larger) covering scale for every column's ball proposals.
            #
            # Design note — why refocus rebuilds do NOT carry a per-group
            # force-shrink radius (the reference's mask-keyed region cache,
            # cachedconstrainer.py:35-90, keeps one radius per dataset-mask
            # generation): group labels here are advisory and UNSTABLE —
            # the host recomputes connected components each chunk, so label
            # g can name a different (e.g. freshly merged) dataset set at
            # the next refocus. Capping that set's radius with the previous
            # label-g radius could under-cover the new contour, which biases
            # evidences; a from-scratch bootstrap is always a valid cover.
            # The rebuild itself is cheap next to a fill round (the
            # bootstrap pairwise pass is O(nb·M²) ≪ the B×nx×D likelihood
            # matmul), so correctness wins over the cache.
            grp = ((rnd - nsuperset_rounds) // focus_every) % jnp.maximum(
                state.n_groups, 1
            )
            grp_mask = empty & (state.group_id == grp)
            use_grp = (
                _global_any(grp_mask, axis_name)
                & (state.n_groups <= cfg.column_focus_groups)
            )
            col_mask = jnp.where(use_grp, grp_mask, empty)
            st = state._replace(pile_u=pile_u)
            g, ovf = _build_geometry_from(
                strategy, st, col_mask, k_focus, cfg, member_capacity,
                axis_name, carry_cap=False,
            )
            return g, overflow + ovf

        do_refocus = (
            cfg.use_focus
            & (rnd >= nsuperset_rounds)
            & ((rnd - nsuperset_rounds) % focus_every == 0)
        )
        geom2, overflow = jax.lax.cond(
            do_refocus, refocus, lambda _: (geom, overflow), None
        )

        if col_capable:
            # alternate region rounds with direct empty-column rounds once
            # the datasets have decoupled past the group-cycling regime —
            # or, fallback, once THIS fill loop has burned
            # column_focus_fallback_rounds rounds without filling: datasets
            # sharing ancient pile points still count as one "group" while
            # their likelihood contours have long separated, and a union
            # region over separated tight clusters samples at ~V_union/V_box
            # (observed 1.25% valid at MUSE iteration 22k, saturating the
            # fill budget); the per-column box proposal is O(1)-efficient
            # there
            fallback = (
                (cfg.column_focus_fallback_rounds > 0)
                & (rnd >= nsuperset_rounds + cfg.column_focus_fallback_rounds)
            )
            # group-gated regime alternates region/column rounds; once the
            # fallback trips (the union region has demonstrably failed for
            # 12+ rounds) 3 of 4 rounds go to columns — the union rounds
            # only remain to serve whatever cross-dataset sharing is left
            grp_cols = (
                (state.n_groups > cfg.column_focus_groups)
                & ((rnd - nsuperset_rounds) % 2 == 1)
            )
            fb_cols = fallback & (((rnd - nsuperset_rounds) % 4) != 0)
            use_cols = (grp_cols | fb_cols) & (rnd >= nsuperset_rounds)
            empty_now = state.running & (shelves.count == 0)

            def prop_cols(k):
                # oversampled raw pool compacted to the front of the
                # likelihood batch: proposals + membership tests are ~us
                # next to the [B, nx, D] likelihood contraction, so matmul
                # occupancy stays ~100% even at ~1% per-proposal validity
                # (late-run explosion regime)
                B_raw = max(cfg.column_proposal_batch or cfg.proposal_batch,
                            cfg.eval_batch)
                u, ok, cols = _column_proposals(
                    pile_u, state.live_idx, empty_now, k, B_raw,
                    norm=strategy.norm, n_slots=cfg.column_slots,
                )
                order = jnp.argsort(~ok)
                take = order[:cfg.eval_batch]
                return u[take], ok[take], cols[take], sstate

            def prop_region(k):
                u, ok, st = strategy.propose(geom2, sstate, k)
                return u, ok, jnp.full((cfg.eval_batch,), -1, jnp.int32), st

            cand_u, valid, src_col, sstate = jax.lax.cond(
                use_cols, prop_cols, prop_region, k_prop
            )
        else:
            cand_u, valid, sstate = strategy.propose(geom2, sstate, k_prop)
            src_col = jnp.full((cand_u.shape[0],), -1, jnp.int32)
        cand_x = problem.transform_batch(cand_u)
        # [B, D] — the likelihood matmul; psum over the model axis when the
        # spectral dimension is sharded (SP/CP analog)
        L = problem.loglike_sharded(cand_x, model_axis_name)

        thresh = shelves_lib.insertion_thresholds(live_bot, shelves)  # [D]
        space = shelves.count < S
        above = state.running[None, :] & (L > thresh[None, :])
        acc = valid[:, None] & space[None, :] & above
        # column-round candidates only fill their source column: their
        # density is uniform on that column's ball union (1/n_near
        # corrected there), so cross-column acceptance would bias. The
        # measured overlap structure (see _column_proposals design note)
        # makes cross-column sharing worthless in this regime anyway.
        acc = acc & (
            (src_col[:, None] < 0)
            | (src_col[:, None] == jnp.arange(L.shape[1])[None, :])
        )

        # strategy feedback: e.g. slice chains advance when the candidate
        # beats any running dataset's constraint (whitenedmcmc.py:305)
        chain_accept = _global_or_rows(jnp.any(above, axis=1), axis_name)
        sstate = strategy.observe(sstate, cand_u, chain_accept)
        sstate = strategy.refresh(geom2, sstate, k_refresh, chain_accept)

        # pile append for candidates accepted anywhere (on any shard, so the
        # pile stays bit-identical across the mesh)
        newpt = _global_or_rows(jnp.any(acc, axis=1), axis_name)
        newpt_i = newpt.astype(jnp.int32)
        slots = pile_size + jnp.cumsum(newpt_i) - newpt_i
        P = pile_u.shape[0]
        can_store = newpt & (slots < P)
        write_slots = jnp.where(can_store, slots, P)  # OOB rows dropped
        pile_u = pile_u.at[write_slots].set(cand_u, mode="drop")
        pile_x = pile_x.at[write_slots].set(cand_x, mode="drop")
        acc = acc & can_store[:, None]
        cand_pile_idx = jnp.where(can_store, slots, -1).astype(jnp.int32)

        shelves = shelves_lib.append_batch(shelves, cand_pile_idx, L, acc)
        ndraws = ndraws + valid.sum().astype(jnp.int32)
        pile_size = pile_size + can_store.sum().astype(jnp.int32)
        return (key, pile_u, pile_x, pile_size, shelves, ndraws, rnd + 1,
                budget - 1, geom2, sstate, overflow, need_more(shelves))

    if budget_left is None:
        budget_left = jnp.int32(2**30)
    carry = (state.key, state.pile_u, state.pile_x, state.pile_size,
             state.shelves, state.ndraws, jnp.int32(0), budget_left, geom,
             sstate, jnp.int32(0), need_more(state.shelves))
    (key, pile_u, pile_x, pile_size, shelves, ndraws, rounds, budget_left,
     _geom, _sstate, overflow, _more) = jax.lax.while_loop(cond, body, carry)
    return state._replace(
        key=key, pile_u=pile_u, pile_x=pile_x, pile_size=pile_size,
        shelves=shelves, ndraws=ndraws,
        member_overflow=state.member_overflow + overflow,
        fill_rounds=state.fill_rounds + rounds,
    ), budget_left


def ns_iteration(problem: Problem, state: EngineState, cfg: RunConfig,
                 member_capacity: int, axis_name=None, strategy=None,
                 geom_carry=None, model_axis_name=None, budget_left=None):
    """One joint NS iteration: clean shelves, fill, advance every dataset,
    update the streaming evidence (reference __next__ + integrator body).

    ``geom_carry``: previous iteration's geometry; reused (the reference's
    region-caching, cachedconstrainer.py) unless the rebuild cadence fires.
    ``budget_left``: chunk-wide fill-round budget (see ``_fill_shelves``);
    None means unlimited. Returns ``((state, geom, budget_left), dead)``.
    """
    if strategy is None:
        from massivedatans_tpu.ns.strategies import make_strategy

        strategy = make_strategy(cfg)
    D = state.live_L.shape[1]  # local shard width under a mesh
    K = cfg.nlive_points

    # ONE [K, D] top_k pass over values only (no index payload, so the
    # sort carries no s32 companion array) supplies every live_L statistic
    # this iteration needs: the sorted bottom (shelf insertion thresholds) and the
    # per-dataset minimum (shelf cleaning + the dead point's likelihood).
    # The argmin ROW is recovered as a one-hot mask by exact f32 equality —
    # top_k returns the element itself, so `live_L == Lmins` is exact; the
    # cumsum guard resolves ties to the first row (argmin's tie rule).
    k_bot = min(cfg.shelf_capacity + 1, K)
    live_bot = -jax.lax.top_k(-state.live_L.T, k_bot)[0].T  # [k, D] ascending
    Lmins = live_bot[0]
    hit_raw = state.live_L == Lmins[None, :]
    worst_hit = hit_raw & (jnp.cumsum(hit_raw, axis=0) == 1)  # [K, D] one-hot
    shelves = shelves_lib.clean(state.shelves, Lmins)
    state = state._replace(shelves=shelves)

    key, k_geom, k_chains = jax.random.split(state.key, 3)
    state = state._replace(key=key)

    def rebuild(_):
        return _build_geometry_from(
            strategy, state, state.running, k_geom, cfg, member_capacity,
            axis_name,
        )

    if geom_carry is None or (
        cfg.region_rebuild_draws <= 0 and cfg.region_rebuild_every <= 1
    ):
        geom, overflow = rebuild(None)
        state = state._replace(draws_at_rebuild=state.ndraws)
    else:
        if cfg.region_rebuild_draws > 0:
            # reference cadence: rebuild after region_rebuild_draws
            # likelihood-evaluated candidates (sample.py:134) — self-tuning
            # in iteration terms, and far cheaper than a fixed iteration
            # cadence in easy phases (the rebuild's member dedup sorts the
            # [K*D] live-index set)
            do = (
                state.ndraws - state.draws_at_rebuild
                >= cfg.region_rebuild_draws
            ) & _global_any(state.running, axis_name)
        else:
            do = (
                (state.iteration % cfg.region_rebuild_every) == 0
            ) & _global_any(state.running, axis_name)
        geom, overflow = jax.lax.cond(
            do, rebuild, lambda _: (geom_carry, jnp.int32(0)), None
        )
        state = state._replace(
            draws_at_rebuild=jnp.where(do, state.ndraws,
                                       state.draws_at_rebuild)
        )
    if isinstance(geom, Region):  # force_shrink memory (MLFriends only)
        state = state._replace(
            prev_scale=geom.metric.scale, prev_radius=geom.radius
        )
    state = state._replace(member_overflow=state.member_overflow + overflow)
    sstate = strategy.init_chains(geom, k_chains)

    state, budget_left = _fill_shelves(
        problem, state, strategy, geom, sstate, cfg, member_capacity,
        axis_name, model_axis_name, budget_left, live_bot=live_bot,
    )
    # a drained budget means the fill was truncated, not that the contour is
    # unfillable — empty shelves then must not count toward stall
    # force-termination
    budget_out = budget_left <= 0

    # --- advance: replace each dataset's worst live point (.:494-534) ---
    # Dense one-hot select instead of a [worst, cols] gather/scatter: two
    # streaming passes over the [K, D] arrays, with no per-column indexed
    # access.
    filled = state.shelves.count > 0
    adv = state.running & filled
    dead_p = jnp.max(jnp.where(worst_hit, state.live_idx, -1), axis=0)
    dead_L = Lmins  # live_L[worst, d] IS the per-column minimum, bit-exactly

    head_idx, head_L, shelves = shelves_lib.pop(state.shelves, adv)
    upd = worst_hit & adv[None, :]
    live_idx = jnp.where(upd, head_idx[None, :], state.live_idx)
    live_L = jnp.where(upd, head_L[None, :], state.live_L)

    # --- phantom-point memory (friends.py keep_phantom_points) ---
    # merge this iteration's dead points into the top-Q-by-L buffer so the
    # most recently vacated contour neighborhoods stay covered by region
    # builds. Under a mesh the dead set is all-gathered first, keeping the
    # (replicated) buffer bit-identical on every shard.
    Q = state.phantom_idx.shape[0]
    if Q > 0:
        cand_L = jnp.where(adv, dead_L, _NEG_INF)
        cand_i = jnp.where(adv, dead_p, -1)
        if axis_name is not None:
            cand_L = jax.lax.all_gather(cand_L, axis_name).reshape(-1)
            cand_i = jax.lax.all_gather(cand_i, axis_name).reshape(-1)
        all_L = jnp.concatenate([state.phantom_L, cand_L])
        all_i = jnp.concatenate([state.phantom_idx, cand_i])
        top_L, sel = jax.lax.top_k(all_L, Q)
        state = state._replace(phantom_idx=all_i[sel], phantom_L=top_L)

    # --- streaming evidence update (multi_nested_integrator.py:105-161) ---
    # Per-dataset volume ledger: each dataset's slab width comes from ITS
    # remaining volume and shrinks only when it advances, so skipped
    # iterations (fill truncated by budget/round cap) cost time, not
    # evidence. `active` gates the global iteration counter so trailing
    # no-op iterations inside a chunk (after every dataset terminated on
    # device) leave the counter untouched.
    active = _global_any(state.running, axis_name)
    logwidth = jnp.where(
        adv,
        jnp.log1p(-jnp.exp(-1.0 / K)) + state.logVolremaining,
        state.logwidth,
    )
    wi = logwidth + dead_L
    logZnew, Hnew = _safe_logaddexp_update(state.logZ, state.H, wi, dead_L)
    logZ = jnp.where(adv, logZnew, state.logZ)
    H = jnp.where(adv, Hnew, state.H)
    last_logwidth = jnp.where(state.running, logwidth, state.last_logwidth)

    state = state._replace(
        shelves=shelves,
        live_idx=live_idx,
        live_L=live_L,
        # only the per-dataset MINIMUM live point is ever replaced, so for
        # K >= 2 the live maximum is monotone: an O(D) update replaces the
        # [K, D] reduction (state.Lmax is exact from init_state onward)
        Lmax=(live_L.max(axis=0) if K == 1 else
              jnp.where(adv, jnp.maximum(state.Lmax, head_L), state.Lmax)),
        logZ=logZ,
        H=H,
        logwidth=logwidth,
        last_logwidth=last_logwidth,
        logVolremaining=state.logVolremaining
        - jnp.where(adv, 1.0 / K, 0.0),
        iteration=state.iteration + active.astype(jnp.int32),
        stall_count=state.stall_count
        + (state.running & ~filled & ~budget_out),
    )
    dead = DeadChunk(
        idx=jnp.where(adv, dead_p, -1),
        L=jnp.where(adv, dead_L, _NEG_INF),
        logwidth=logwidth,
        running=state.running,
    )
    state = device_termination(state, cfg, K)
    return (state, geom, budget_left), dead


@functools.partial(
    jax.jit,
    static_argnames=(
        "cfg", "member_capacity", "n_iters", "axis_name", "model_axis_name"
    ),
)
def run_chunk(problem: Problem, state: EngineState, cfg: RunConfig,
              member_capacity: int, n_iters: int, axis_name=None,
              model_axis_name=None, fill_budget=None):
    """Run ``n_iters`` NS iterations in one device dispatch.

    ``fill_budget``: optional TRACED int32 scalar overriding the static
    ``cfg.chunk_fill_budget`` — the host can re-tune the per-dispatch
    fill-round budget every chunk (bounding the device time of one
    dispatch) without recompiling: all budget values share one
    executable.
    """
    return run_chunk_inner(problem, state, cfg, member_capacity, n_iters,
                           axis_name, model_axis_name, fill_budget)


def run_chunk_inner(problem: Problem, state: EngineState, cfg: RunConfig,
                    member_capacity: int, n_iters: int, axis_name=None,
                    model_axis_name=None, fill_budget=None):
    """Un-jitted chunk body, for wrapping in shard_map (parallel/sharded.py).

    A ``while_loop`` over NS iterations with an EARLY EXIT once every dataset
    has terminated on-device (rather than a fixed-length scan padded with
    no-op iterations): ``n_iters`` is the dead-buffer capacity and upper
    bound, not the exact trip count. This makes very large ``chunk_iters``
    free — a whole run to termination can be ONE device dispatch, so the
    host↔device round-trip count is O(1) instead of O(niter / chunk_iters).
    Rows
    of the dead buffer beyond the executed iteration count are unwritten
    (idx=-1, running=False); the host slices them off via the iteration
    delta in the packed report.
    """
    from massivedatans_tpu.ns.strategies import make_strategy

    strategy = make_strategy(cfg)

    # build the initial geometry so the loop carry has a fixed structure
    key0, k_geom0 = jax.random.split(state.key)
    geom0, overflow0 = _build_geometry_from(
        strategy, state._replace(key=key0), state.running, k_geom0, cfg,
        member_capacity, axis_name,
    )
    state = state._replace(
        key=key0, member_overflow=state.member_overflow + overflow0,
        draws_at_rebuild=state.ndraws,  # chunk-start build resets the cadence
    )
    # fresh fill-round budget per dispatch (0 = unlimited); shared across
    # the chunk's iterations so one hard contour cannot stretch a single
    # device execution without bound. A traced fill_budget operand
    # (integrator adaptive dispatch) takes precedence.
    if fill_budget is None:
        budget0 = jnp.int32(cfg.chunk_fill_budget or 2**30)
    else:
        budget0 = jnp.asarray(fill_budget, jnp.int32)
    D = state.live_L.shape[1]
    dead0 = DeadChunk(
        idx=jnp.full((n_iters, D), -1, jnp.int32),
        L=jnp.full((n_iters, D), _NEG_INF, jnp.float32),
        logwidth=jnp.zeros((n_iters, D), jnp.float32),
        running=jnp.zeros((n_iters, D), bool),
    )

    def cond(carry):
        st, _geom, _budget, _dead, cursor = carry
        # every executed iteration has some dataset running, so the global
        # iteration counter advances exactly once per body execution and the
        # cursor tracks it (the host relies on this to slice written rows)
        return (cursor < n_iters) & _global_any(st.running, axis_name)

    def body(carry):
        st, geom, budget, dead, cursor = carry
        (st, geom, budget), row = ns_iteration(
            problem, st, cfg, member_capacity, axis_name, strategy, geom,
            model_axis_name, budget,
        )
        dead = DeadChunk(
            idx=dead.idx.at[cursor].set(row.idx),
            L=dead.L.at[cursor].set(row.L),
            logwidth=dead.logwidth.at[cursor].set(row.logwidth),
            running=dead.running.at[cursor].set(row.running),
        )
        return (st, geom, budget, dead, cursor + 1)

    carry = (state, geom0, budget0, dead0, jnp.int32(0))
    state, _geom, _budget, dead, _cursor = jax.lax.while_loop(cond, body, carry)
    return state, dead


@functools.partial(jax.jit, static_argnames=("nlive",))
def integrate_remainder(live_L, logZ, H, logwidth, Lmax, nlive: int):
    """Jitted wrapper around :func:`remainder_core` (host/test entry)."""
    return remainder_core(live_L, logZ, H, logwidth, Lmax, nlive)


def remainder_core(live_L, logZ, H, logwidth, Lmax, nlive: int):
    """Vectorized remainder integration + termination criterion
    (reference ``integrate_remainder``, multi_nested_integrator.py:26-59).

    Returns (remainderZ, remainderZerr, totalZ, totalZerr), each [D].

    Sort-free: the reference sorts the live points (remainder()), but every
    quantity here depends only on sums and the min/max —
    ``Ls[1:].sum + Ls[-1] = sum - min + max`` etc. — and the telescoped H
    update below is order-independent.
    """
    L0 = Lmax
    Ls = jnp.exp(live_L - L0[None, :])  # [K, D]
    Ls_sum = Ls.sum(axis=0)
    Ls_min = jnp.exp(live_L.min(axis=0) - L0)
    Ls_max = jnp.exp(0.0 * L0)  # == 1: the max live point equals Lmax
    Lmax_sum = Ls_sum - Ls_min + Ls_max
    Lmin_sum = Ls_sum - Ls_max + Ls_min
    logLmid = jnp.log(Ls_sum) + L0
    logZmid = jnp.logaddexp(logZ, logwidth + logLmid)
    logZup = jnp.logaddexp(logZ, logwidth + jnp.log(Lmax_sum) + L0)
    logZlo = jnp.logaddexp(logZ, logwidth + jnp.log(Lmin_sum) + L0)
    logZerr = logZup - logZlo

    # The reference's sequential H update over the K live points
    # (multi_nested_integrator.py:47-55) telescopes: with
    # G_k = exp(logZ_k) * (H_k + logZ_k), each step adds exp(w_k) * L_k, so
    #   H_final = sum_k exp(logw + L_k - Zf) * L_k
    #           + exp(logZ - Zf) * (H + logZ) - Zf
    # — a closed form, no scan (a 400-step scan is brutal to compile).
    Zf = logZmid
    wgt = jnp.exp(logwidth + live_L - Zf[None, :])
    contrib = jnp.where(wgt > 0.0, wgt * live_L, 0.0)  # 0 * -1e100 guard
    prev = jnp.where(
        jnp.isfinite(logZ), jnp.exp(logZ - Zf) * (H + logZ), 0.0
    )
    Hf = jnp.maximum(contrib.sum(axis=0) + prev - Zf, 0.0)
    totalZerr = logZerr + jnp.sqrt(Hf / nlive)
    return logwidth + logLmid, logZerr, logZmid, totalZerr


def resolve_stall_limit(cfg: RunConfig) -> int:
    """Iterations a dataset may sit with an unfillable shelf before being
    force-terminated (single source of truth for device + host diagnostics)."""
    return cfg.stall_limit or 2 * max(cfg.check_every, 50)


def device_termination(state: EngineState, cfg: RunConfig, nlive: int):
    """On-device termination check (the reference host loop's check,
    multi_nested_integrator.py:136-155) so a whole run needs only a few
    host round trips.

    Tolerance checks run every ``cfg.check_every`` iterations (reference
    cadence: 50); the ``max_samples`` cap is enforced immediately.
    Newly-terminated datasets freeze their remainder estimate
    (``rem_logZ``/``rem_logZerr``, reference ``remainder_tails`` capture at
    :149-151) and leave ``running`` (the ``cut_down`` equivalent). Their live
    points are frozen by the running mask, so the posterior tail can be read
    from ``live_idx`` once at the very end. Per-dataset termination state is
    purely column-local, so this runs unchanged under a dataset-sharded mesh.
    """
    past_min = state.iteration > cfg.min_samples
    if cfg.max_samples:
        force_all = state.iteration > cfg.max_samples
    else:
        force_all = jnp.bool_(False)

    def check(st):
        remZ, remZerr, _totalZ, totalZerr = remainder_core(
            st.live_L, st.logZ, st.H, st.logwidth, st.Lmax, nlive
        )
        newly = st.running & (totalZerr < cfg.tolerance) & past_min
        newly = jnp.where(force_all, st.running, newly)
        # force-terminate datasets the sampler cannot fill (diagnostic; the
        # reference would spin forever here)
        newly = newly | (st.running & (st.stall_count > resolve_stall_limit(cfg)))
        return st._replace(
            running=st.running & ~newly,
            rem_logZ=jnp.where(st.running, remZ, st.rem_logZ),
            rem_logZerr=jnp.where(st.running, remZerr, st.rem_logZerr),
            term_iter=jnp.where(newly, st.iteration, st.term_iter),
        )

    if cfg.check_every <= 1:
        return check(state)
    at_check = (state.iteration % cfg.check_every) == 0
    do = (at_check & past_min) | force_all
    return jax.lax.cond(do, check, lambda st: st, state)


@functools.partial(jax.jit, static_argnames=("nlive", "with_live_idx"))
def chunk_report_parts(state: EngineState, dead: DeadChunk, nlive: int,
                       with_live_idx: bool = True):
    """Split report: a small meta buffer plus the [2, T, D] dead block.

    The dead block is T = chunk_iters rows but only ``iteration delta``
    rows are written (the while_loop exits early at termination); packing
    it separately lets the host fetch ``meta`` first (O(D) bytes), read
    the executed row count, and fetch only a bucketed row prefix of the
    block. Only ``L`` and ``idx`` are streamed: the per-row ``running``
    masks and slab widths are exactly reconstructible host-side —
    running is monotone (``term_iter`` records each dataset's
    termination iteration) and logwidth follows the deterministic f32
    ledger recurrence from the previous chunk's end state (the meta
    carries the device's own f32 constants so the host replays identical
    IEEE ops — see integrator._reconstruct_rows). This halves the block's
    device-to-host bytes: at D=10^4 and 256-row chunks the two-channel
    block is ~20 MB per chunk.
    """
    T, D = dead.L.shape
    ndraws = state.ndraws
    rounds = state.fill_rounds
    it = state.iteration
    K = nlive
    header = jnp.stack([
        # iteration split into exact 16-bit halves like ndraws/fill_rounds:
        # a single f32 lane is exact only below 2^24 global iterations and
        # the row count sliced from the dead block must never be corrupted
        (it // 65536).astype(jnp.float32),
        (it % 65536).astype(jnp.float32),
        (ndraws // 65536).astype(jnp.float32),
        (ndraws % 65536).astype(jnp.float32),
        state.pile_size.astype(jnp.float32),
        state.stall_count.max().astype(jnp.float32),
        state.member_overflow.astype(jnp.float32),
        jnp.float32(T),
        jnp.float32(D),
        (rounds // 65536).astype(jnp.float32),
        (rounds % 65536).astype(jnp.float32),
        # the device's own f32 ledger constants, so host reconstruction
        # replays bit-identical arithmetic
        jnp.log1p(-jnp.exp(-1.0 / K)).astype(jnp.float32),
        jnp.float32(1.0 / K),
    ])
    meta = jnp.concatenate([
        header,
        state.logZ, state.H, state.last_logwidth,
        state.rem_logZ, state.rem_logZerr,
        state.running.astype(jnp.float32),
        state.stall_count.astype(jnp.float32),
        # term_iter split into exact 16-bit halves (floor semantics keep
        # the -1 "still running" sentinel exact: -1 -> (-1, 65535))
        (state.term_iter // 65536).astype(jnp.float32),
        (state.term_iter % 65536).astype(jnp.float32),
        state.logVolremaining,
        state.logwidth,
    ] + (
        # live-point indices feed the host's ADVISORY group decomposition
        # (subsets.component_labels). At D=10^4 this [K, D] payload is
        # 16 MB — as large as the dead block itself — for labels that only
        # steer column-focus cycling. The integrator therefore requests it
        # on a cadence (cfg.group_refresh_chunks), not every chunk.
        [state.live_idx.astype(jnp.float32).reshape(-1)]
        if with_live_idx else []
    ))
    block = jnp.stack([
        dead.L,
        dead.idx.astype(jnp.float32),  # exact: pile capacity << 2^24
    ])
    return meta, block


def parse_meta(buf, D: int, nlive: int) -> dict:
    """Host-side unpack of the chunk_report_parts meta buffer."""
    import numpy as np

    out = {}
    o = 13
    h = buf[:o]
    out["iteration"] = int(h[0]) * 65536 + int(h[1])
    out["ndraws"] = int(h[2]) * 65536 + int(h[3])
    out["pile_size"] = int(h[4])
    out["stall_max"] = int(h[5])
    out["member_overflow"] = int(h[6])
    out["fill_rounds"] = int(h[9]) * 65536 + int(h[10])
    out["lw_const"] = np.float32(h[11])
    out["dv_const"] = np.float32(h[12])
    for name in ("logZ", "H", "last_logwidth", "rem_logZ", "rem_logZerr"):
        out[name] = buf[o:o + D].astype(np.float64)
        o += D
    out["running_final"] = buf[o:o + D] > 0.5
    o += D
    out["stall_count"] = buf[o:o + D].astype(np.int64)
    o += D
    out["term_iter"] = (buf[o:o + D].astype(np.int64) * 65536
                        + buf[o + D:o + 2 * D].astype(np.int64))
    o += 2 * D
    out["logVol_end"] = buf[o:o + D].astype(np.float32)
    o += D
    out["logwidth_end"] = buf[o:o + D].astype(np.float32)
    o += D
    if len(buf) > o:  # live_idx present only on group-refresh chunks
        out["live_idx"] = (
            buf[o:o + nlive * D].reshape(nlive, D).astype(np.int32))
    return out


def parse_dead_block(block, rows: int) -> dict:
    """Unpack the first ``rows`` rows of a (possibly prefix-sliced)
    [2, T', D] dead block into the rep dict fields."""
    import numpy as np

    return {
        "L": block[0][:rows],
        "idx": block[1][:rows].astype(np.int32),
    }


@jax.jit
def capture_tails(state: EngineState):
    """Sorted live points (ascending L) for every dataset — the remainder
    tail saved at termination (multi_nested_integrator.py:149-151, sampler
    ``remainder()``, multi_nested_sampler.py:536-562). Terminated datasets'
    live points are frozen by the running mask, so one capture at the end of
    the run is exact for all of them."""
    idx_sorted, L_sorted = capture_tails_idx(state)
    u = state.pile_u[idx_sorted]             # [K, D, ndim]
    x = state.pile_x[idx_sorted]
    return u, x, L_sorted


@jax.jit
def capture_tails_idx(state: EngineState):
    """Index-only tail capture: ``(idx_sorted [K, D], L_sorted [K, D])``.

    The integrator reconstructs u/x from its host-side pile prefix (the
    same fetch the dead-point stream already needs) — the [K, D, ndim]
    coordinate blocks would be ~100 MB at D=10^4, for data the host can
    gather from ~16 MB of pile rows it already holds."""
    order = jnp.argsort(state.live_L, axis=0)
    idx_sorted = jnp.take_along_axis(state.live_idx, order, axis=0)
    L_sorted = jnp.take_along_axis(state.live_L, order, axis=0)
    return idx_sorted, L_sorted
