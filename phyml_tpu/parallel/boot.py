"""Distributed bootstrap farming (the mpi_boot.c replacement).

Reference flow (mpi_boot.c:27 Bootstrap_MPI): every MPI rank runs the
full replicate pipeline for replicates r, r+P, r+2P... with per-rank
seeds (srand(seed+rank), main.c:84); replicate tree strings travel to
rank 0 (MPI_Ssend/Recv, mpi_boot.c:313-314) and the per-edge
bipartition counts reduce with MPI_Reduce(SUM) (mpi_boot.c:335-342).

Design: processes come from `jax.distributed.initialize`, one per
GPU (the launcher pins each to its card, e.g. with
CUDA_VISIBLE_DEVICES, and gives every process the coordinator's
address, the process count and its id).  Every process runs the ML
search; process 0's tree and parameters are then broadcast so all
replicate counts refer to one tree.  Replicates are round-robin over
process ids with per-REPLICATE seeds (stronger than the reference's
per-rank seeds: counts are identical regardless of the farming
layout).  The count reduction is a single psum-equivalent over a
dense per-edge vector via multihost allgather; no strings cross the
wire.

Single-process (including the virtual CPU mesh) this degrades to the
serial loop and returns identical counts — the layout-independence
contract is tested in tests/test_multichip.py.
"""

from __future__ import annotations

import numpy as np


def replicate_shard(n_replicates: int, process_index: int,
                    process_count: int) -> list[int]:
    """Round-robin replicate ids for one process
    (mpi_boot.c:106-117: rank r handles r, r+P, r+2P, ...)."""
    return list(range(process_index, n_replicates, process_count))


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           **kwargs) -> tuple[int, int]:
    """jax.distributed.initialize with the coordinator address,
    process count and process id given here; any left None come from
    the environment or a cluster scheduler JAX detects.  Must run
    before the first device use.  Returns (process_index,
    process_count); raises RuntimeError when initialization fails."""
    import jax

    given = dict(coordinator_address=coordinator_address,
                 num_processes=num_processes, process_id=process_id)
    kwargs.update({k: v for k, v in given.items() if v is not None})
    try:
        jax.distributed.initialize(**kwargs)
    except Exception as exc:
        raise RuntimeError(
            f"jax.distributed.initialize({kwargs}) failed: {exc}") from exc
    return jax.process_index(), jax.process_count()


def share_from_process0(topo, params):
    """Process 0's topology and parameters on every process.  Each
    process runs the same search, but XLA may choose other algorithms
    per process and rounding can then steer two searches apart; the
    replicate counts must all refer to one tree."""
    import jax
    import jax.numpy as jnp

    from phyml_tpu.topology import Topology

    if jax.process_count() == 1:
        return topo, params
    from jax.experimental import multihost_utils

    edges, blen, leaves = multihost_utils.broadcast_one_to_all(
        (topo.edges, topo.blen, params))
    return (Topology(topo.n_otu, np.asarray(edges), np.asarray(blen)),
            jax.tree_util.tree_map(jnp.asarray, leaves))


def run_bootstrap_distributed(
    engine,
    model,
    params,
    best_topo,
    n_replicates: int = 100,
    search: str = "nni",
    seed: int = 0,
    bayesian: bool = False,
    tbe: bool = False,
    verbose: bool = False,
):
    """Bootstrap supports with replicates farmed over jax processes.

    Every process calls this with identical arguments (SPMD, like the
    reference's phyml-mpi binary); the returned {edge id: support}
    dict is identical on every process.
    """
    import jax

    from phyml_tpu.search.support import bootstrap_supports

    pid = jax.process_index()
    nproc = jax.process_count()
    mine = replicate_shard(n_replicates, pid, nproc)
    counts = bootstrap_supports(
        engine, model, params, best_topo,
        n_replicates=n_replicates, search=search, seed=seed,
        bayesian=bayesian, tbe=tbe,
        verbose=verbose and pid == 0,
        replicate_indices=mine,
    )
    eids = sorted(counts.keys())
    local = np.asarray([counts[e] for e in eids], dtype=np.float64)
    total = _sum_across_processes(local)
    return {e: float(c) / n_replicates for e, c in zip(eids, total)}


def _sum_across_processes(local: np.ndarray) -> np.ndarray:
    """Global SUM of a small per-edge count vector across jax
    processes (≙ MPI_Reduce(..., MPI_SUM, 0) mpi_boot.c:335, but
    allreduce-style so every process holds the result)."""
    import jax

    if jax.process_count() == 1:
        return local
    from jax.experimental import multihost_utils

    gathered = multihost_utils.process_allgather(local)
    return np.asarray(gathered).sum(axis=0)
