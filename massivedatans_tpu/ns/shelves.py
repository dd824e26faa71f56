"""Per-dataset candidate shelves (queues) as static-shape vector ops.

The reference keeps one Python list of ``(pile_idx, u, x, L)`` tuples per
dataset (``multi_nested_sampler.py:117,481-488,521``). Here a shelf is three
arrays — ``idx[S, D]``, ``L[S, D]``, ``count[D]`` — FIFO within the first
``count[d]`` slots, so cleaning, threshold computation, batched append and the
synchronized pop are all masked jnp ops over the full dataset axis.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_NEG_INF = -jnp.inf


class Shelves(NamedTuple):
    idx: jax.Array    # [S, D] int32 pile indices (valid in slots < count)
    L: jax.Array      # [S, D] float32 log-likelihoods
    count: jax.Array  # [D] int32


def init_shelves(capacity: int, ndata: int) -> Shelves:
    return Shelves(
        idx=jnp.full((capacity, ndata), -1, jnp.int32),
        L=jnp.full((capacity, ndata), _NEG_INF, jnp.float32),
        count=jnp.zeros((ndata,), jnp.int32),
    )


def clean(shelves: Shelves, Lmins) -> Shelves:
    """Drop entries with L <= Lmin(d), preserving FIFO order
    (reference ``prepare()``, multi_nested_sampler.py:134-143).

    Stable compaction WITHOUT argsort/gather: the S-unrolled one-hot
    writes below are plain [S, D] vector passes, with no per-column
    indexed access.
    """
    S = shelves.L.shape[0]
    slot = jnp.arange(S)[:, None]
    keep = (slot < shelves.count[None, :]) & (shelves.L > Lmins[None, :])
    pos = jnp.cumsum(keep, axis=0) - keep  # exclusive prefix: output slot
    new_idx = shelves.idx
    new_L = shelves.L
    for s in range(S):  # static unroll over the small capacity axis
        match = keep & (pos == s)  # [S, D]; at most one True per column
        has = jnp.any(match, axis=0)
        iv = jnp.max(jnp.where(match, shelves.idx, -1), axis=0)
        lv = jnp.max(jnp.where(match, shelves.L, _NEG_INF), axis=0)
        new_idx = new_idx.at[s].set(jnp.where(has, iv, -1))
        new_L = new_L.at[s].set(jnp.where(has, lv, _NEG_INF))
    return Shelves(
        idx=new_idx,
        L=new_L,
        count=keep.sum(axis=0).astype(jnp.int32),
    )


def live_bottom(live_L, capacity: int) -> jax.Array:
    """Sorted smallest ``capacity + 1`` live L's per dataset — the only part
    of live_L the insertion thresholds can ever reference (n <= capacity).
    Computed once per NS iteration so the per-fill-round threshold sort is
    O(S) instead of O(K + S) deep."""
    k = min(capacity + 1, live_L.shape[0])
    return -jax.lax.top_k(-live_L.T, k)[0].T  # [k, D] ascending


def insertion_thresholds(live_bot, shelves: Shelves) -> jax.Array:
    """Corrected acceptance threshold per dataset.

    Reference ``Lmins_higher``/``find_nsmallest`` (multi_nested_sampler.py:
    44-47, 438-447): to be useful at queue position n = count(d), a new entry
    must exceed the n-th smallest of live L's and shelved L's combined.
    For empty shelves this is exactly Lmin(d). ``live_bot`` is the
    ``live_bottom`` precomputation (n never exceeds the shelf capacity).
    """
    S = shelves.L.shape[0]
    slot = jnp.arange(S)[:, None]
    shelf_vals = jnp.where(slot < shelves.count[None, :], shelves.L, jnp.inf)
    cat = jnp.concatenate([live_bot, shelf_vals], axis=0)  # [S+1+S, D]
    cat = jnp.sort(cat, axis=0)
    return jnp.take_along_axis(cat, shelves.count[None, :], axis=0)[0]


def append_batch(shelves: Shelves, cand_idx, cand_L, accept) -> Shelves:
    """Append accepted candidates (in batch order) to each dataset's shelf.

    ``cand_idx[B]`` are pile indices, ``cand_L[B, D]`` scores, ``accept[B, D]``
    the acceptance mask. Appends are capped at capacity; order within the
    batch is preserved (FIFO like the reference's list.append).
    """
    S, D = shelves.L.shape
    pos = shelves.count[None, :] + jnp.cumsum(accept, axis=0) - accept  # exclusive
    write = accept & (pos < S)
    new_idx, new_L = shelves.idx, shelves.L
    for s in range(S):  # static unroll over the small capacity axis
        match = write & (pos == s)  # [B, D]; at most one True per column
        has = jnp.any(match, axis=0)
        idx_val = jnp.max(jnp.where(match, cand_idx[:, None], -1), axis=0)
        L_val = jnp.sum(jnp.where(match, cand_L, 0.0), axis=0)
        new_idx = new_idx.at[s].set(jnp.where(has, idx_val, new_idx[s]))
        new_L = new_L.at[s].set(jnp.where(has, L_val, new_L[s]))
    new_count = shelves.count + write.sum(axis=0).astype(jnp.int32)
    return Shelves(idx=new_idx, L=new_L, count=new_count)


def pop(shelves: Shelves, active):
    """Pop the FIFO head for every active dataset (multi_nested_sampler.py:521).

    Returns ``(head_idx[D], head_L[D], new_shelves)``. Datasets with
    ``active=False`` (or empty shelves) are left untouched and return junk.
    """
    head_idx = shelves.idx[0]
    head_L = shelves.L[0]
    do = active & (shelves.count > 0)
    shifted_idx = jnp.concatenate([shelves.idx[1:], jnp.full_like(shelves.idx[:1], -1)])
    shifted_L = jnp.concatenate([shelves.L[1:], jnp.full_like(shelves.L[:1], _NEG_INF)])
    new = Shelves(
        idx=jnp.where(do[None, :], shifted_idx, shelves.idx),
        L=jnp.where(do[None, :], shifted_L, shelves.L),
        count=jnp.where(do, shelves.count - 1, shelves.count),
    )
    return head_idx, head_L, new
