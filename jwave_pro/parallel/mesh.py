"""Device mesh helpers.

The reference's entire parallel story is intra-JVM ForkJoinPool work stealing
(SURVEY §2.4); the JAX equivalent is a ``jax.sharding.Mesh`` whose axes map
the library's parallelism dimensions:

  * ``data``   — batch axis (P4 row/col decorator, embarrassingly parallel)
  * ``signal`` — the time axis of long signals (sequence-parallel analog;
                 halo exchanges are ``lax.ppermute`` collectives, which XLA
                 hands to NCCL on GPUs)
  * ``scale``  — CWT scale axis (P2) / WPT packet axis (P1)

The GPUs of one host are joined all to all (NVLink), so every device
reaches every other at the same rate and the mesh follows the algorithm
alone.

Meshes are cheap metadata; build one per topology and pass it around.
"""
from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "P", "NamedSharding", "shard_batch", "shard_signal",
           "init_distributed"]


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Initialize multi-process JAX (``jax.distributed.initialize``
    wrapper).

    Pass the coordinator address (``host:port``), the process count and
    this process's id; call once per process before any backend use, then
    build meshes over ``jax.devices()`` (global).  Put the ``signal`` halo
    ring within a host and the ``data`` (batch) axis across processes: the
    batch axis needs no collectives.
    """
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def make_mesh(shape: dict[str, int] | None = None,
              devices=None) -> Mesh:
    """Build a mesh; default: all local devices on one ``data`` axis.

    ``shape`` maps axis name → size, e.g. ``{"data": 2, "signal": 4}``.
    """
    devices = devices if devices is not None else jax.devices()
    if shape is None:
        shape = {"data": len(devices)}
    sizes = list(shape.values())
    if int(np.prod(sizes)) != len(devices):
        raise ValueError(f"mesh {shape} needs {np.prod(sizes)} devices, "
                         f"have {len(devices)}")
    arr = np.asarray(devices).reshape(sizes)
    return Mesh(arr, tuple(shape.keys()))


def shard_batch(x, mesh: Mesh, axis: str = "data"):
    """Place ``x`` with its leading axis sharded over ``axis``."""
    spec = P(axis, *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))


def shard_signal(x, mesh: Mesh, axis: str = "signal"):
    """Place ``x`` with its last axis sharded over ``axis``."""
    spec = P(*([None] * (x.ndim - 1)), axis)
    return jax.device_put(x, NamedSharding(mesh, spec))
