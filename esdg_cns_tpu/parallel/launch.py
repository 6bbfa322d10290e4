"""Multi-host / multi-process bootstrap (SURVEY.md §2.4 launcher row).

The reference is a single-process serial code; its "cluster" is one
Julia VM.  Multi-process runs are SPMD: every process runs the same
program, ``jax.distributed.initialize`` wires up the coordination
service, and ``jax.devices()`` then reports the GLOBAL device set so a
``jax.sharding.Mesh`` spans every process's devices.  One process can
also drive all the GPUs of one host, which needs no initialization.

Usage (same script on every host)::

    from esdg_cns_tpu.parallel import launch

    launch.maybe_initialize()          # no-op on a single host
    mesh = launch.make_device_mesh()   # 1D element-axis mesh over all
                                       # global devices
    disc_s, q_s = shard_discretization(mesh, "e", disc, q0)

For several processes pass the coordinator explicitly or set the
variables consumed here:

    JAX_COORDINATOR_ADDRESS  host:port of process 0
    JAX_NUM_PROCESSES        total process count
    JAX_PROCESS_ID           this process's rank

Element-axis note: GPUs of one host are joined all to all, so the mesh
is a plain reshape of ``jax.devices()``.  Jobs spanning several hosts
should pass ``shape=(n_hosts, devs_per_host)`` and put the element axis
(the halo ring of parallel/halo.py) on the inner, intra-host mesh axis,
using the outer axis for the ensemble/data-parallel dimension
(parallel/ensemble.py).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def maybe_initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> bool:
    """Initialize the JAX distributed runtime when running multi-process.

    Arguments default to the ``JAX_COORDINATOR_ADDRESS`` /
    ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID`` environment variables.

    Returns True when ``jax.distributed.initialize`` was called, False
    for the single-process case (no coordinator configured).  Safe to
    call unconditionally at the top of a driver script; calling twice is
    a no-op.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])

    # an explicit coordinator is required to go multi-process; its
    # absence means single-process (no-op)
    if coordinator_address is None:
        return False

    if jax.distributed.is_initialized():
        return True  # already initialized
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    return True


def make_device_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("e",),
    devices=None,
) -> Mesh:
    """Build a ``jax.sharding.Mesh`` over the global device set.

    Default: a 1D mesh named ``'e'`` (the element/domain-decomposition
    axis) over every global device — the layout every sharded RHS
    builder in parallel/sharding.py expects.  Pass ``shape`` (and
    matching ``axis_names``) for multi-axis layouts, e.g.
    ``shape=(n_hosts, devs_per_host), axis_names=("ens", "e")`` to
    keep the halo ring inside a host and the ensemble axis across hosts.
    """
    devices = np.asarray(jax.devices() if devices is None else devices)
    if shape is None:
        shape = (devices.size,)
    if len(shape) != len(axis_names):
        raise ValueError(
            f"shape {tuple(shape)} and axis_names {tuple(axis_names)} "
            f"must have equal length"
        )
    if int(np.prod(shape)) != devices.size:
        raise ValueError(
            f"mesh shape {tuple(shape)} needs {int(np.prod(shape))} "
            f"devices, have {devices.size}"
        )
    return Mesh(devices.reshape(shape), tuple(axis_names))
