"""Problem definition layer.

Reference layer L6 ("problem definition", survey §1) defines a problem as a
``priortransform(cube)`` plus ``multi_loglikelihood(params, data_mask)``
(reference ``sample.py:52-108``). The equivalent here is batch-first and
mask-free: the log-likelihood takes a *batch* of parameter vectors and returns
the full ``[B, D]`` matrix against every dataset in one XLA fusion — masking
out finished datasets is the integrator's job, and costs nothing because the
work is a matmul.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Problem:
    """A many-dataset inference problem.

    ``data`` is an arbitrary pytree of device arrays (spectra, grids,
    precomputed sums). The two callables are pure jittable functions taking
    ``data`` explicitly, so a ``Problem`` is itself a pytree that can cross
    ``jit``/``shard_map`` boundaries with the arrays as leaves.

    - ``prior_transform(u[ndim]) -> x[ndim]`` mirrors reference
      ``priortransform`` (sample.py:52-58).
    - ``loglike_batch(data, x[B, ndim]) -> L[B, D]`` replaces reference
      ``multi_loglikelihood(params, data_mask)`` (sample.py:101-108 /
      clike.c:34-89), vectorized over a proposal batch as one matmul.
    """

    data: Any
    prior_transform: Callable = dataclasses.field(metadata=dict(static=True))
    loglike_batch: Callable = dataclasses.field(metadata=dict(static=True))
    ndim: int = dataclasses.field(metadata=dict(static=True))
    ndata: int = dataclasses.field(metadata=dict(static=True))
    name: str = dataclasses.field(default="problem", metadata=dict(static=True))
    # optional fast path ``loglike_paired_fn(data, x[D, ndim]) -> L[D]``:
    # dataset d scored against ITS OWN parameter vector x[d]. Used by the
    # per-dataset gradient backends (infer/), which need one likelihood per
    # dataset rather than the NS engine's full [B, D] fan-out.
    loglike_paired_fn: Any = dataclasses.field(
        default=None, metadata=dict(static=True)
    )
    # optional model-parallel kernel ``loglike_mp_fn(data, x[B, ndim],
    # model_axis_name) -> L[B, D]``: the spectral axis nx is sharded over a
    # mesh axis (the SP/CP analog, survey §2/§5 — relevant for MUSE nx=3600);
    # the kernel contracts its local nx slice and psums the partial sums.
    # Activated only when the engine runs under a mesh with a >1 "model"
    # axis (parallel/sharded.py); inert otherwise.
    loglike_mp_fn: Any = dataclasses.field(
        default=None, metadata=dict(static=True)
    )
    # optional ``predict_fn(data, x[ndim]) -> ypred[nx]``: one model curve,
    # for best-fit/posterior-predictive plots (postprocess.plot_bestfit —
    # the reference emits best-fit plots from inside the MUSE likelihood,
    # musefuse.py:385-404; here they render post-hoc from recorded samples)
    predict_fn: Any = dataclasses.field(
        default=None, metadata=dict(static=True)
    )

    def loglike(self, x_batch):
        return self.loglike_batch(self.data, x_batch)

    def loglike_sharded(self, x_batch, model_axis_name=None):
        """Likelihood with optional spectral-axis model parallelism: under a
        2-D (data, model) mesh the nx contraction is computed from each
        shard's local slice and psum-reduced over ``model_axis_name``."""
        if model_axis_name is not None and self.loglike_mp_fn is not None:
            return self.loglike_mp_fn(self.data, x_batch, model_axis_name)
        return self.loglike(x_batch)

    def loglike_paired(self, x):
        """``L[d] = loglike(x[d])[d]`` for ``x[D, ndim]``.

        Falls back to the full ``[D, D]`` cross-evaluation diagonal when no
        model-specific paired kernel is registered — fine for D up to a few
        thousand, O(D^2) beyond.
        """
        if self.loglike_paired_fn is not None:
            return self.loglike_paired_fn(self.data, x)
        return jax.numpy.diagonal(self.loglike_batch(self.data, x))

    def transform_batch(self, u_batch):
        return jax.vmap(self.prior_transform)(u_batch)

    def predict(self, x):
        """One model curve for parameter vector ``x`` (None-capable)."""
        if self.predict_fn is None:
            return None
        return self.predict_fn(self.data, x)

    def with_data(self, data) -> "Problem":
        return dataclasses.replace(self, data=data)


# data-pytree type -> fn(data, data_axis, model_axis) returning a pytree of
# ``jax.sharding.PartitionSpec`` with the same structure as ``data``,
# describing how the model family shards under a 2-D (data, model) mesh.
# Model modules register themselves here; ``parallel/sharded.py`` consults it
# when the mesh has a model axis. Unregistered models fall back to
# dataset-only sharding.
MODEL_PSPEC_REGISTRY: dict = {}
