"""Device-mesh helpers for multi-device and multi-host execution.

The reference has NO distributed execution (single-process CPU library,
optional OpenMP; SURVEY.md §2.6 last row) -- this subsystem is new,
constrained only by the semantics "sharded result == single-device
result".  Meshes are 1-D ('shards') for the point/constraint dimension;
batched proving adds a 'batch' axis on top (dist design per SURVEY.md
§7 step 7).

Multi-host: `init_distributed()` wires `jax.distributed` process groups
from an explicit coordinator, process count and rank, after which
`jax.devices()` spans every host and the same mesh constructors produce
global meshes.  `make_host_mesh()` builds the 2-D (host, chip) mesh
grouping devices by process; on one host it is (1, n).
"""

from __future__ import annotations

import os

import numpy as np

import jax
from jax.sharding import Mesh

_DIST_STATE = {"initialized": False}


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize the multi-host process group (idempotent).

    Resolution order per argument: explicit parameter, then env vars
    ZKLAIM_COORDINATOR / ZKLAIM_NUM_PROCESSES / ZKLAIM_PROCESS_ID.
    Nothing is detected: single-process runs (nothing configured) are a
    no-op returning False, so every entry point may call this
    unconditionally.
    """
    if _DIST_STATE["initialized"]:
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "ZKLAIM_COORDINATOR"
    )
    env_np = os.environ.get("ZKLAIM_NUM_PROCESSES")
    env_pid = os.environ.get("ZKLAIM_PROCESS_ID")
    num_processes = num_processes if num_processes is not None else (
        int(env_np) if env_np else None
    )
    process_id = process_id if process_id is not None else (
        int(env_pid) if env_pid else None
    )
    if coordinator_address is None and num_processes is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _DIST_STATE["initialized"] = True
    return True


def make_mesh(n_devices: int | None = None, axis: str = "shards") -> Mesh:
    """1-D mesh over the first n (global) devices."""
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]), (axis,))


def make_host_mesh(axes: tuple[str, str] = ("host", "chip")) -> Mesh:
    """2-D (num_hosts, chips_per_host) mesh from the global device set.

    Devices are grouped by owning process so the trailing axis is always
    intra-host; collectives over `axes[0]` cross hosts.  A single-process
    run gives a (1, n) mesh, so the sharding layouts are the same on one
    host as on several.
    """
    devs = jax.devices()
    by_proc: dict[int, list] = {}
    for d in devs:
        by_proc.setdefault(d.process_index, []).append(d)
    counts = {len(v) for v in by_proc.values()}
    if len(counts) != 1:
        raise ValueError(f"uneven devices per host: { {k: len(v) for k, v in by_proc.items()} }")
    grid = np.array(
        [by_proc[p] for p in sorted(by_proc)], dtype=object
    )
    return Mesh(grid, axes)


def flat_shard_axis(mesh: Mesh) -> tuple[str, ...]:
    """The axis names to shard a 1-D data dimension over `mesh` --
    ('host', 'chip') for host meshes, ('shards',) for flat ones -- in
    PartitionSpec order (host-major keeps one host's data adjacent)."""
    return tuple(mesh.axis_names)
