"""Device-mesh plumbing: site sharding + bootstrap farming axes.

Replaces the reference's MPI layer (mpi_boot.c — Bcast/Ssend/Recv/
Reduce of strings and count vectors between ranks).  Design
(SURVEY.md §2.3):

  * 2-level mesh ("boot", "sites").  Bootstrap replicates ride the
    outer axis, site patterns ride the inner axis.
  * Sharding is declarative: the engine's pattern-axis arrays are
    placed with a NamedSharding and XLA's SPMD partitioner turns the
    jitted likelihood programs into collective-communicating programs
    automatically — the per-site terms stay local, the weighted
    reduction becomes one psum.  No hand-written collectives.
  * Multi-host: jax.distributed.initialize() then the same code; the
    mesh spans all processes' devices.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_boot: int = 1, n_sites: int | None = None,
              devices=None) -> Mesh:
    """Mesh over (boot, sites).  Defaults: all devices on the sites
    axis (pure site-sharding)."""
    devices = np.asarray(devices if devices is not None
                         else jax.devices())
    if n_sites is None:
        n_sites = len(devices) // n_boot
    assert n_boot * n_sites == len(devices), (
        f"{n_boot} x {n_sites} != {len(devices)} devices"
    )
    return Mesh(devices.reshape(n_boot, n_sites), ("boot", "sites"))


def pattern_sharding(mesh: Mesh, ndim: int, axis: str = "sites"):
    """NamedSharding splitting the LAST of `ndim` axes over `axis`."""
    return NamedSharding(mesh, P(*([None] * (ndim - 1) + [axis])))


def boot_sharding(mesh: Mesh, ndim: int):
    """NamedSharding splitting the FIRST of `ndim` axes over 'boot'
    (replicate-weight matrices [R, P] for bootstrap farming)."""
    return NamedSharding(
        mesh, P(*(["boot"] + [None] * (ndim - 2) + ["sites"]))
    )


def shard_pattern_arrays(engine, mesh: Mesh, axis: str = "sites"):
    """Re-place the engine's pattern-axis arrays with the mesh
    sharding (last axis split over `axis`)."""
    put = lambda x: jax.device_put(
        x, pattern_sharding(mesh, x.ndim, axis)
    )
    engine.tips = put(engine.tips)
    engine.weights = put(engine.weights)
    engine.invar_state = put(engine.invar_state)
    engine.invar_ok = put(engine.invar_ok)
    return engine


def sharded_engine(aln, model, mesh: Mesh, dtype=None, axis="sites"):
    """Build a LikelihoodEngine whose pattern axis is sharded over
    `axis` of `mesh`.  Pads patterns so the axis divides evenly; the
    only collective is the weighted lnL reduction, mirroring the
    reference's site independence (mpi_boot.c)."""
    import jax.numpy as jnp
    from phyml_tpu.ops.likelihood import LikelihoodEngine

    dtype = dtype or jnp.float32
    n_shards = mesh.shape[axis]
    eng = LikelihoodEngine(
        aln, model, dtype=dtype,
        pattern_pad=128 * n_shards,
    )
    return shard_pattern_arrays(eng, mesh, axis)
