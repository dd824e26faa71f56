"""Checkpoint / resume of the batched sampler state.

The reference has no checkpointing — a crash loses the whole run because
results are only written after integration completes (survey §5;
sample.py:200-217). Here the full engine state pytree plus the host-side
integrator context is persisted at chunk boundaries, so a 140-hour-class run
(the reference's MUSE workload) survives preemption.

Layout: ``<dir>/state.npz`` (engine pytree leaves), ``<dir>/host.npz``
(tails, termination context), ``<dir>/chunk_NNNN.npz`` (dead-point stream),
``<dir>/meta.json``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import jax
import jax.numpy as jnp

from massivedatans_tpu.ns.engine import EngineState
from massivedatans_tpu.ns.shelves import Shelves

_STATE = "state.npz"
_HOST = "host.npz"
_META = "meta.json"

# Bump whenever EngineState gains/loses/reorders fields: leaves are stored
# positionally, so silently loading an old layout would scramble the state.
FORMAT_VERSION = 6  # v6: draws_at_rebuild scalar (draw-based region rebuild
                    # cadence); v5: term_iter[D] (per-dataset termination
                    # iteration, host-side dead-row mask reconstruction)


def _flatten_state(state: EngineState) -> dict:
    # The pile arrays are sized for the worst case (capacity 2^21 rows,
    # ~84 MB at ndim=5) but only pile_size rows are live, so persist
    # only the used prefix, bucketed to 64 Ki rows so the device slice
    # reuses a handful of executables; load_state zero-pads back.
    n = int(state.pile_size)
    cap = state.pile_u.shape[0]
    n_pad = min(cap, ((n + 65535) // 65536) * 65536) or min(cap, 65536)
    state = state._replace(
        pile_u=state.pile_u[:n_pad], pile_x=state.pile_x[:n_pad]
    )
    flat = {"format_version": np.int64(FORMAT_VERSION),
            "pile_capacity": np.int64(cap)}
    leaves, treedef = jax.tree.flatten(state)
    for i, leaf in enumerate(leaves):
        if jnp.issubdtype(getattr(leaf, "dtype", None), jax.dtypes.prng_key):
            flat[f"leaf_{i:03d}__key"] = np.asarray(jax.random.key_data(leaf))
        else:
            flat[f"leaf_{i:03d}"] = np.asarray(jax.device_get(leaf))
    return flat


def save_state(path: str, state: EngineState, host_ctx: dict, meta: dict):
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, "state.tmp.npz")  # np.savez requires .npz suffix
    np.savez(tmp, **_flatten_state(state))
    os.replace(tmp, os.path.join(path, _STATE))
    tmp = os.path.join(path, "host.tmp.npz")
    np.savez(tmp, **host_ctx)
    os.replace(tmp, os.path.join(path, _HOST))
    with open(os.path.join(path, _META + ".tmp"), "w") as fh:
        json.dump(meta, fh)
    os.replace(os.path.join(path, _META + ".tmp"), os.path.join(path, _META))


def save_chunk(path: str, chunk_index: int, arrays: dict):
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, f"chunk_{chunk_index:05d}.npz"), **arrays)


def load_state(path: str, template: EngineState):
    """Rebuild an EngineState from disk using a freshly-initialized template
    for the pytree structure."""
    data = np.load(os.path.join(path, _STATE))
    found = int(data["format_version"]) if "format_version" in data else 1
    if found != FORMAT_VERSION:
        raise ValueError(
            f"checkpoint {path} has state format v{found}, this build "
            f"expects v{FORMAT_VERSION}; finish the run with the matching "
            "code version or restart without --resume"
        )
    leaves, treedef = jax.tree.flatten(template)
    # jax.tree.flatten returns the leaf array objects themselves, so the two
    # pile arrays can be pinned by identity. The prefix-padding branch below
    # must apply ONLY to them: any other leaf with a smaller leading dim
    # (e.g. live_L from a checkpoint written with a smaller nlive) would be
    # silently zero-padded with fake likelihoods / pile-row-0 indices —
    # shape mismatches outside the pile must fail loudly instead.
    pile_ids = {id(template.pile_u), id(template.pile_x)}
    new_leaves = []
    for i, leaf in enumerate(leaves):
        if f"leaf_{i:03d}__key" in data:
            new_leaves.append(jax.random.wrap_key_data(
                jnp.asarray(data[f"leaf_{i:03d}__key"])))
        else:
            arr = data[f"leaf_{i:03d}"]
            shape = getattr(leaf, "shape", None)
            if shape is not None and arr.shape != tuple(shape):
                if (id(leaf) in pile_ids and arr.ndim == len(shape)
                        and arr.shape[0] < shape[0]
                        and arr.shape[1:] == tuple(shape[1:])):
                    # pile arrays persisted as used-prefix only: pad rows
                    # back to this build's capacity (rows >= pile_size are
                    # never referenced by live/shelf/phantom indices)
                    pad = np.zeros(shape, dtype=arr.dtype)
                    pad[: arr.shape[0]] = arr
                    arr = pad
                else:
                    raise ValueError(
                        f"checkpoint {path} leaf {i} has shape "
                        f"{tuple(arr.shape)} but this run's configuration "
                        f"expects {tuple(shape)} — the checkpoint was "
                        "written with different run parameters (e.g. "
                        "nlive/ndata/chunk size); resume with the original "
                        "settings or restart without --resume"
                    )
            new_leaves.append(jnp.asarray(arr, dtype=leaf.dtype))
    return jax.tree.unflatten(treedef, new_leaves)


def load_host(path: str) -> dict:
    return dict(np.load(os.path.join(path, _HOST), allow_pickle=False))


def load_meta(path: str) -> dict:
    with open(os.path.join(path, _META)) as fh:
        return json.load(fh)


def load_chunks(path: str):
    names = sorted(
        n for n in os.listdir(path)
        if n.startswith("chunk_") and n.endswith(".npz")
    )
    return [dict(np.load(os.path.join(path, n))) for n in names]


def has_checkpoint(path: str) -> bool:
    return (
        path is not None
        and os.path.isdir(path)
        and os.path.exists(os.path.join(path, _STATE))
        and os.path.exists(os.path.join(path, _META))
    )
