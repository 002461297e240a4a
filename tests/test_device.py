"""The one platform decision (utils/device.py), the compile-cache helper,
and the refusal of a non-GPU backend by bench.py and chip_smoke.py."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from vk3dgaussiansplatting_tpu.utils import device

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize(
    "backend, kernel", [("gpu", True), ("cpu", False)]
)
def test_blend_tier_by_platform(backend, kernel):
    assert device.blend_uses_kernel(backend) is kernel
    # interpret mode only ever on the CPU, never on a GPU
    assert device.kernel_interpret(backend) is (not kernel)


@pytest.mark.parametrize("backend", ["rocm", "metal", "neuron"])
def test_other_backends_are_refused(backend):
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        device.blend_uses_kernel(backend)
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        device.kernel_interpret(backend)


def test_renderer_default_tier_on_cpu():
    from vk3dgaussiansplatting_tpu.core.config import RenderConfig
    from vk3dgaussiansplatting_tpu.pipeline import Renderer

    assert jax.default_backend() == "cpu"
    assert Renderer(RenderConfig(width=64, height=64)).use_pallas_blend is False


def test_compile_cache_env_dir_wins(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert device.setup_compile_cache() == str(tmp_path)
    assert not [c for c in calls if c[0] == "jax_compilation_cache_dir"]


def test_compile_cache_defaults_to_checkout(monkeypatch):
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    path = device.setup_compile_cache()
    assert path == str(REPO / ".jax_cache")
    assert ("jax_compilation_cache_dir", path) in calls
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def _run(args, cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("VK3D_TESTS_ON_GPU", None)
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def _no_result(stdout):
    for line in stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        assert not isinstance(obj, dict), f"printed a result: {line}"


def test_bench_refuses_cpu_without_flag():
    proc = _run([str(REPO / "bench.py"), "--scene", "debug_small"], REPO)
    assert proc.returncode != 0
    assert "needs an NVIDIA GPU" in proc.stderr
    _no_result(proc.stdout)


def test_chip_smoke_refuses_cpu():
    proc = _run([str(REPO / "chip_smoke.py")], REPO)
    assert proc.returncode != 0
    assert "needs an NVIDIA GPU" in proc.stderr
    _no_result(proc.stdout)


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository the script cannot pass."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], tmp_path)
    assert proc.returncode != 0
    _no_result(proc.stdout)
