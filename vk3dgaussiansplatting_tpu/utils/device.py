"""Device capability reporting and the one platform decision.

The reference gates on device capabilities at startup
(GpuProperties::isPhysicalDeviceSuitable, GpuProperties.cpp:193-280: Vulkan
1.3, shaderInt64, subgroup size >= 16) and exposes a static registry
(timestamp period etc.).  Here the analogue is a platform report, a
suitability check, and the single place that maps the JAX backend to the
blend tier:

  * ``gpu`` -> the Pallas tile-blend kernel, compiled (ops/pallas);
  * ``cpu`` -> the plain-XLA tier (tests, and an explicit ``--cpu``);
  * anything else -> an error: there is no silent fallback.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

from . import log

SUPPORTED_PLATFORMS = ("gpu", "cpu")
# Persistent compile cache used when JAX_COMPILATION_CACHE_DIR is unset:
# a fixed directory in the checkout (listed in .gitignore).
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def platform(backend: str | None = None) -> str:
    """The JAX backend if the renderer supports it, else RuntimeError."""
    backend = jax.default_backend() if backend is None else backend
    if backend not in SUPPORTED_PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX backend {backend!r}: the renderer runs on an "
            f"NVIDIA GPU ('gpu') or, for tests, on the CPU ('cpu')"
        )
    return backend


def blend_uses_kernel(backend: str | None = None) -> bool:
    """True on the GPU (tile-blend kernel), False on the CPU (XLA tier)."""
    return platform(backend) == "gpu"


def kernel_interpret(backend: str | None = None) -> bool:
    """Pallas interpret mode: only on the CPU backend, never on a GPU."""
    return platform(backend) == "cpu"


def setup_compile_cache() -> str:
    """Point JAX's persistent compile cache at one directory.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already reads it and no
    other directory is set here; otherwise the cache goes to
    ``DEFAULT_CACHE_DIR``.  Returns the directory in use.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return str(DEFAULT_CACHE_DIR)


def device_report() -> dict:
    d = jax.devices()[0]
    info = {
        "platform": d.platform,
        "device": str(d),
        "device_kind": getattr(d, "device_kind", "unknown"),
        "num_devices": len(jax.devices()),
        "process_count": jax.process_count(),
    }
    try:
        stats = d.memory_stats()
        if stats:
            info["bytes_limit"] = int(stats.get("bytes_limit", 0))
            info["bytes_in_use"] = int(stats.get("bytes_in_use", 0))
    except Exception:
        pass
    return info


def check_suitability(min_devices: int = 1) -> bool:
    """Suitability gate (the isPhysicalDeviceSuitable analogue): a
    supported backend (GPU, or the CPU for tests) with enough devices."""
    devs = jax.devices()
    if len(devs) < min_devices:
        log.warning(f"only {len(devs)} device(s), wanted >= {min_devices}")
        return False
    if jax.default_backend() not in SUPPORTED_PLATFORMS:
        log.warning(f"unsupported backend {jax.default_backend()}")
        return False
    return True
