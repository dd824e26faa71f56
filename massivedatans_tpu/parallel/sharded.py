"""Dataset-parallel execution over a device mesh.

The reference's only parallelism is OpenMP threads inside C kernels fanned
over datasets (survey §2 accounting). The equivalent here shards the
dataset axis D over a 1-D ``jax.sharding.Mesh``:

- per-dataset state (live points, shelves, logZ/H, running masks) and the
  spectra ``y[:, D]`` are sharded on D;
- the point pile and all proposal batches are *replicated* — identical RNG
  on every shard means one shared model evaluation per candidate across the
  whole machine, which is exactly the collaborative-sampling trick across
  devices;
- the only communication is (i) a psum vote for the fill loop, (ii) a psum
  vote to keep the pile bit-identical, and (iii) an all_gather of unique
  live-point *indices* for region construction — a few KB per iteration,
  over the device interconnect (NVLink between GPUs).
"""

from __future__ import annotations

import functools

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from massivedatans_tpu.config import RunConfig
from massivedatans_tpu.models.base import Problem
from massivedatans_tpu.ns import engine as engine_lib
from massivedatans_tpu.ns.engine import DeadChunk, EngineState
from massivedatans_tpu.ns.region import Metric, Region
from massivedatans_tpu.ns.shelves import Shelves

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(devices=None, model_parallel: int = 1) -> Mesh:
    """1-D dataset mesh, or — with ``model_parallel`` > 1 — a 2-D
    (data, model) mesh that additionally shards the spectral axis nx across
    ``model_parallel`` devices (the SP/CP analog, survey §5: relevant for
    MUSE's nx=3600). Models opt in via ``Problem.loglike_mp_fn`` +
    ``MODEL_PSPEC_REGISTRY``; the engine's collectives stay on the data
    axis, the likelihood psums its partial contractions over the model
    axis."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if model_parallel <= 1:
        return Mesh(devices, (DATA_AXIS,))
    if devices.size % model_parallel:
        raise ValueError(
            f"{devices.size} devices not divisible by "
            f"model_parallel={model_parallel}"
        )
    return Mesh(devices.reshape(-1, model_parallel), (DATA_AXIS, MODEL_AXIS))


def mesh_model_axis(mesh: Mesh):
    """The model axis name if the mesh shards it, else None."""
    if MODEL_AXIS in mesh.axis_names and mesh.shape[MODEL_AXIS] > 1:
        return MODEL_AXIS
    return None


def state_pspecs() -> EngineState:
    """PartitionSpec pytree for EngineState: shard on the dataset axis where
    a dataset dimension exists, replicate everything else."""
    d = P(DATA_AXIS)
    kd = P(None, DATA_AXIS)
    r = P()
    return EngineState(
        key=r,
        pile_u=r, pile_x=r, pile_size=r,
        live_idx=kd, live_L=kd,
        shelves=Shelves(idx=kd, L=kd, count=d),
        running=d, Lmax=d,
        logZ=d, H=d,
        logVolremaining=d, logwidth=d, last_logwidth=d,
        rem_logZ=d, rem_logZerr=d,
        iteration=r, ndraws=r,
        prev_scale=r, prev_radius=r,
        group_id=d, n_groups=r,
        phantom_idx=r, phantom_L=r,  # replicated: merged from all-gathered dead
        term_iter=d,
        stall_count=d, member_overflow=r, fill_rounds=r,
        draws_at_rebuild=r,
    )


def dead_pspecs() -> DeadChunk:
    return DeadChunk(
        idx=P(None, DATA_AXIS),
        L=P(None, DATA_AXIS),
        logwidth=P(None, DATA_AXIS),
        running=P(None, DATA_AXIS),
    )


def problem_pspecs(problem: Problem, mesh: Mesh | None = None):
    """PartitionSpec pytree for a Problem: any array with a trailing
    dataset-sized axis is sharded on it; everything else replicated. Under a
    2-D (data, model) mesh, models registered in ``MODEL_PSPEC_REGISTRY``
    additionally shard their spectral axis on the model axis."""
    import dataclasses

    from massivedatans_tpu.models.base import MODEL_PSPEC_REGISTRY

    D = problem.ndata

    def spec_for(leaf):
        shape = getattr(leaf, "shape", ())
        if len(shape) >= 1 and shape[-1] == D and D > 1:
            return P(*([None] * (len(shape) - 1) + [DATA_AXIS]))
        if len(shape) >= 1 and shape[0] == D and D > 1:
            return P(*([DATA_AXIS] + [None] * (len(shape) - 1)))
        return P()

    specs = jax.tree.map(spec_for, problem)
    if mesh is not None and mesh_model_axis(mesh) is not None:
        fn = MODEL_PSPEC_REGISTRY.get(type(problem.data))
        if fn is None:
            raise ValueError(
                f"mesh has a model axis but {type(problem.data).__name__} "
                "has no model-parallel sharding registered"
            )
        specs = dataclasses.replace(
            specs, data=fn(problem.data, DATA_AXIS, MODEL_AXIS)
        )
    return specs


def shard_problem(problem: Problem, mesh: Mesh) -> Problem:
    specs = problem_pspecs(problem, mesh)
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), problem, specs
    )


def shard_state(state: EngineState, mesh: Mesh) -> EngineState:
    specs = state_pspecs()
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), state, specs
    )


def make_sharded_run_chunk(problem: Problem, mesh: Mesh, cfg: RunConfig,
                           member_capacity: int, n_iters: int):
    """Build a jitted dataset-sharded chunk runner with the same signature
    behavior as engine.run_chunk(problem, state)."""
    p_specs = problem_pspecs(problem, mesh)
    s_specs = state_pspecs()

    inner = functools.partial(
        engine_lib.run_chunk_inner,
        cfg=cfg,
        member_capacity=member_capacity,
        n_iters=n_iters,
        axis_name=DATA_AXIS,
        model_axis_name=mesh_model_axis(mesh),
    )

    mapped = jax.shard_map(
        lambda pr, st: inner(pr, st),
        mesh=mesh,
        in_specs=(p_specs, s_specs),
        out_specs=(s_specs, dead_pspecs()),
        check_vma=False,
    )
    return jax.jit(mapped)
