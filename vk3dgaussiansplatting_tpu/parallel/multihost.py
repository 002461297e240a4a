"""Multi-host initialization and process-level helpers.

On a pod slice, call `initialize()` once per process before building meshes;
`jax.distributed` wires the hosts together and `jax.devices()` then spans the
slice, so `parallel.mesh.make_mesh()` / `parallel.dist` work unchanged — the
all_to_all tile exchange rides ICI within a slice and DCN across slices, laid
out by XLA from the same `shard_map` program (SURVEY.md §5 "distributed
communication backend").

Single-process (CPU mesh / single chip) callers skip this entirely.
"""

from __future__ import annotations

import jax


def initialize(coordinator_address: str | None = None, **kwargs) -> None:
    """jax.distributed.initialize; GPU and CPU clusters pass
    coordinator_address, num_processes and process_id."""
    jax.distributed.initialize(coordinator_address=coordinator_address, **kwargs)


def is_multi_process() -> bool:
    return jax.process_count() > 1


def process_info() -> dict:
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def assert_mesh_spans_processes(mesh) -> None:
    """Sanity check: the mesh must cover every process's devices exactly once."""
    devs = set(d.id for d in mesh.devices.flat)
    expect = set(d.id for d in jax.devices())
    if devs != expect:
        raise ValueError(
            f"mesh devices {sorted(devs)} != global devices {sorted(expect)}"
        )
