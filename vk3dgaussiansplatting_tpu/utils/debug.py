"""Debug / observability utilities.

Equivalents of the reference's debug facilities (SURVEY.md §5):
  * `memory_snapshot` — the VMA memory dump (`generateMemoryDump` ->
    VmaDump.json on hotkey T, Renderer.cpp:517-529): a JSON-able listing of
    live device arrays and allocator stats.
  * `nan_guard` — the Vulkan validation layer's closest numerical analogue:
    enables jax's NaN debugging for a scope (data-race validation has no
    analogue — XLA dataflow cannot race).
  * `profiler_trace` — GPU timestamp queries (QueryPoolArray) equivalent:
    wraps `jax.profiler.trace` for a scope; view with TensorBoard/XProf.
"""

from __future__ import annotations

import contextlib
import json

import jax


def memory_snapshot(limit: int = 200) -> dict:
    """Live device-array snapshot (the VmaDump.json equivalent)."""
    arrays = []
    total = 0
    for i, arr in enumerate(jax.live_arrays()):
        if i >= limit:
            break
        nbytes = arr.size * arr.dtype.itemsize
        total += nbytes
        arrays.append(
            {
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "nbytes": int(nbytes),
                "committed": getattr(arr, "committed", None),
            }
        )
    stats = {}
    try:
        raw = jax.devices()[0].memory_stats()
        if raw:
            stats = {k: int(v) for k, v in raw.items()}
    except Exception:  # platform without memory_stats
        pass
    return {"total_tracked_bytes": int(total), "arrays": arrays, "device_stats": stats}


def write_memory_dump(path: str = "MemDump.json") -> str:
    """Write the snapshot to disk (reference writes VmaDump.json)."""
    with open(path, "w") as f:
        json.dump(memory_snapshot(), f, indent=1)
    return path


@contextlib.contextmanager
def nan_guard():
    """Raise on NaN-producing ops within the scope (debug builds only — the
    reference's validation layers are likewise debug-only)."""
    old = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", old)


@contextlib.contextmanager
def profiler_trace(logdir: str = "/tmp/vk3dgs_trace"):
    """Capture an XProf trace of the scope (GPU timestamp equivalent)."""
    with jax.profiler.trace(logdir):
        yield
