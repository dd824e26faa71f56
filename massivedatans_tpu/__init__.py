"""massivedatans_tpu — collaborative nested sampling on an accelerator.

A from-scratch JAX framework with the capabilities of
JohannesBuchner/massivedatans (arXiv:1707.04476): fit one parametric model
independently to N datasets, running the N nested-sampling runs jointly so a
single model evaluation is shared across all datasets whose likelihood
constraint it satisfies.

Design highlights (vs. the reference's Python + C/ctypes stack):

- The shared-evaluation likelihood (reference ``clike.c:34-89``) is a single
  ``[B, nx] @ [nx, D]`` matmul: one proposal *batch* is scored against
  *all* datasets at once.
- The joint sampler state (reference ``multi_nested_sampler.py:49-569``:
  point pile, live-point index matrix, per-dataset shelves) is a static-shape
  device-resident pytree advanced by one jitted step function; queues are
  masked vector ops, not Python lists.
- RadFriends region construction and membership (reference
  ``clustering/cneighbors.c``) are distance matmuls with compare-and-reduce
  epilogues that XLA fuses.
- Scaling is dataset-parallel over a ``jax.sharding.Mesh``: proposal batches
  are replicated (that *is* the shared-draw trick), data and sampler state are
  sharded over datasets, and the few global quantities (fill-loop votes,
  region member sets) ride ``psum``/``all_gather`` collectives.
"""

__version__ = "0.1.0"

from massivedatans_tpu.config import RunConfig  # noqa: F401
