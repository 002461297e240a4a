"""Device mesh management for multi-chip / multi-host rendering.

The reference is strictly single-GPU (SURVEY.md §2.4): its only
"communication" is Vulkan pipeline barriers.  This framework introduces a
distributed layer with no reference counterpart: a 1-D `jax.sharding.Mesh`
over all devices ("shard" axis), gaussians data-sharded across it, screen
tiles row-partitioned across it, and the per-frame global sort realized as a
local-sort + all-to-all tile-ownership exchange (parallel/dist.py).

On a pod slice the same mesh spans hosts transparently (jax.distributed);
tests fake an 8-device mesh with XLA's host-platform device count.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SHARD_AXIS = "shard"


def make_mesh(num_devices: int | None = None) -> Mesh:
    devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (SHARD_AXIS,))


def sharded(mesh: Mesh, *axes) -> NamedSharding:
    return NamedSharding(mesh, P(*axes))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
