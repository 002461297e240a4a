"""Smoke test of the renderer on one NVIDIA GPU — the quickest proof that the
system still starts on the card.

    python chip_smoke.py           # phases 1-4 on one GPU
    python chip_smoke.py --multi   # phase 5 only, on 4 GPUs of one host

Phases (each prints its own line; any failure exits non-zero):
  1. device: the JAX backend must be ``gpu``; prints the device kind and
     count and nvidia-smi's name and power limit;
  2. the tests marked ``gpu`` (pytest, in this process);
  3. garden30k_1080p: keygen -> sort -> ranges on the card, every tile
     blended by the tile-blend kernel, and three strips of tile rows (top,
     middle, bottom) by the plain-XLA tier at highest matmul precision;
     max |d| <= 1 8-bit step (docs/TOLERANCES.md); prints the frame
     program's compiled memory analysis;
  4. the main path: Renderer.init_for_scene + draw for several frames at
     garden30k_1080p; live elements within 5% of the reference's
     13,098,506, a non-blank image, compile time and median ms/frame;
  5. (--multi) parallel/dist.py's distributed render over a 1-D mesh of 4
     cards against a single-card render_frame of the same camera, +-1.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SCENE = "garden30k_1080p"
REFERENCE_ELEMENTS = 13_098_506


def say(*a):
    print(*a, flush=True)


def phase_device(want_count):
    import jax

    from bench import gpu_identity

    devs = jax.devices()
    say(f"phase 1 device: backend={jax.default_backend()} "
        f"kind={devs[0].device_kind} count={len(devs)}")
    say(f"phase 1 nvidia-smi: {gpu_identity()}")
    if len(devs) < want_count:
        raise RuntimeError(f"need {want_count} GPUs, found {len(devs)}")


def phase_gpu_tests():
    import pytest

    os.environ["VK3D_TESTS_ON_GPU"] = "1"  # tests/conftest.py: keep the GPU
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider",
         os.path.join(REPO, "tests")]
    )
    say(f"phase 2 gpu tests: pytest exit code {int(rc)}")
    if rc != 0:
        raise RuntimeError(f"gpu-marked tests failed (pytest exit {rc})")


def garden_inputs():
    """Calibrated garden30k_1080p scene on the card: (config, capacity,
    device table, camera)."""
    import jax
    import jax.numpy as jnp

    import bench

    args = argparse.Namespace(seed=42, scene_gen="cloud",
                              opacity_mode="capture")
    n, _w, _h, target = bench.SCENES[SCENE]
    config = bench.build_config(SCENE)
    capacity = config.sort_capacity(n)
    cam = bench.bench_camera(SCENE)
    host = bench.build_scene(args, SCENE)
    mult, live = bench.calibrate_scale(host, cam, config, capacity, target)
    table = jax.device_put(
        jax.tree.map(jnp.asarray, bench.scaled_table(host, mult))
    )
    return config, capacity, table, cam, live


def _u8(x):
    return np.round(np.clip(np.asarray(x), 0.0, 1.0) * 255.0).astype(np.int32)


def strip_reference(se, rg_host, rg, fr, config, row):
    """XLA-tier colors of tile row `row`: [16, W, 3] pixels, from the
    sorted elements sliced to the row's contiguous range."""
    import jax
    import jax.numpy as jnp

    from vk3dgaussiansplatting_tpu.ops import blend as blend_ops
    from vk3dgaussiansplatting_tpu.ops.keygen import SortElements

    gw, ts = config.grid_width, config.tile_size
    t0 = row * gw
    seg = rg_host[t0:t0 + gw]
    ne = seg[:, 1] > seg[:, 0]
    if not ne.any():
        return np.zeros((ts, gw * ts, 3), np.float32), 0
    e0, e1 = int(seg[ne, 0].min()), int(seg[ne, 1].max())
    cap = se.tile.shape[0]
    pad = min(1 << max(10, (e1 - e0 - 1).bit_length()), cap)
    s0 = min(e0, cap - pad)
    el = SortElements(
        tile=se.tile[s0:s0 + pad], depth=se.depth[s0:s0 + pad],
        index=se.index[s0:s0 + pad], count=se.count,
    )
    local = jnp.clip(rg.astype(jnp.int32) - s0, 0, pad).astype(jnp.uint32)
    with jax.default_matmul_precision("highest"):
        colors, _ = jax.jit(
            lambda e, r, f: blend_ops.blend_strip_colors_xla(
                e, r, f, config, tile_base=t0, num_strip_tiles=gw
            )
        )(el, local, fr)
    colors = np.asarray(colors).reshape(gw, ts, ts, 3)
    return colors.transpose(1, 0, 2, 3).reshape(ts, gw * ts, 3), e1 - e0


def phase_kernel_vs_reference(config, capacity, table, cam):
    import jax
    import jax.numpy as jnp

    from vk3dgaussiansplatting_tpu.ops import keygen as keygen_ops
    from vk3dgaussiansplatting_tpu.ops import ranges as ranges_ops
    from vk3dgaussiansplatting_tpu.ops import sort as sort_ops
    from vk3dgaussiansplatting_tpu.ops.pallas import blend_kernel
    from vk3dgaussiansplatting_tpu.pipeline import render_frame

    view, proj = cam.matrices()
    args = (table, jnp.asarray(view), jnp.asarray(proj),
            jnp.asarray(cam.position, dtype=jnp.float32))
    t0 = time.time()
    compiled = render_frame.lower(
        *args, config=config, capacity=capacity, use_pallas_blend=True
    ).compile()
    say(f"phase 3 frame program compiled in {time.time() - t0}s, "
        f"memory_analysis: {compiled.memory_analysis()}")

    @jax.jit
    def passes(t, v, p, c):
        el, fr = keygen_ops.generate_sort_elements(
            t, v, p, c, config, capacity
        )
        el = sort_ops.sort_elements(el, config)
        return el, ranges_ops.find_ranges(el, config.num_tiles), fr

    se, rg, fr = passes(*args)
    img = np.asarray(blend_kernel.blend_tiles_kernel(se, rg, fr, config))
    rg_host = np.asarray(rg)
    ts = config.tile_size
    worst = 0
    for row in (0, config.grid_height // 2, config.grid_height - 1):
        ref, n = strip_reference(se, rg_host, rg, fr, config, row)
        h = min(ts, config.height - row * ts)
        got = _u8(img[row * ts:row * ts + h])
        want = _u8(ref[:h, :config.width])
        d = np.abs(got - want)
        worst = max(worst, int(d.max()))
        say(f"phase 3 tile row {row} ({n} elements): kernel vs XLA tier "
            f"max |d| {int(d.max())}, mean {float(d.mean())}, differing "
            f"pixels {int((d > 0).any(-1).sum())}")
    if worst > 1:
        raise RuntimeError(f"kernel differs from the XLA tier by {worst}")


def phase_main_path(config, table, cam, frames=8):
    import jax

    import bench
    from vk3dgaussiansplatting_tpu.pipeline import Renderer

    renderer = Renderer(config)
    if not renderer.use_pallas_blend:
        raise RuntimeError("Renderer did not pick the kernel on the GPU")
    renderer.init_for_scene(table)
    t0 = time.time()
    out = renderer.draw(cam)
    jax.block_until_ready(out.image_u8)
    compile_s = time.time() - t0
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        out = renderer.draw(cam)
        jax.block_until_ready(out.image_u8)
        times.append((time.perf_counter() - t0) * 1e3)
    count = int(out.num_elements)
    img = np.asarray(out.image_u8)[..., :3]
    lit = float((img.max(-1) > 0).mean())
    say(f"phase 4 main path: live elements {count} (reference "
        f"{REFERENCE_ELEMENTS}), lit pixels {lit}, compile+first frame "
        f"{compile_s}s, median {float(np.median(times))} ms/frame over "
        f"{frames} frames on {bench.gpu_identity()} (information only)")
    if abs(count - REFERENCE_ELEMENTS) > 0.05 * REFERENCE_ELEMENTS:
        raise RuntimeError(f"live elements {count} off the reference by >5%")
    if lit < 0.01:
        raise RuntimeError("blank image")


def phase_multi(config, capacity, table, cam):
    import jax
    import jax.numpy as jnp

    from vk3dgaussiansplatting_tpu.models.gaussians import GaussianTable
    from vk3dgaussiansplatting_tpu.parallel import dist
    from vk3dgaussiansplatting_tpu.parallel.mesh import make_mesh
    from vk3dgaussiansplatting_tpu.pipeline import render_frame

    ndev = len(jax.devices())
    view, proj = cam.matrices()
    cams = (jnp.asarray(view), jnp.asarray(proj),
            jnp.asarray(cam.position, dtype=jnp.float32))
    ref = render_frame(table, *cams, config=config, capacity=capacity,
                       use_pallas_blend=True)
    ref_u8 = np.asarray(ref.image_u8)[..., :3].astype(np.int32)
    host = GaussianTable(*[np.asarray(x) for x in (
        table.position, table.scale, table.rot, table.sh, table.opacity)])
    del ref, table
    padded = dist._pad_table(host, ndev)
    plan = dist.plan_distribution(config, padded.num_gaussians, ndev)
    fn = dist.make_distributed_render(make_mesh(ndev), config, plan,
                                      use_pallas_blend=True)
    t0 = time.time()
    img, dropped = fn(jax.tree.map(jnp.asarray, padded), *cams)
    img = jax.block_until_ready(img)
    compile_s = time.time() - t0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(jax.tree.map(jnp.asarray, padded), *cams)[0])
        times.append((time.perf_counter() - t0) * 1e3)
    got = _u8(np.asarray(img)[:config.height, :config.width])
    d = np.abs(got - ref_u8)
    n_drop = int(np.sum(np.asarray(dropped)))
    say(f"phase 5 multi: {ndev} devices, mesh {dict(make_mesh(ndev).shape)},"
        f" dropped {n_drop}, vs single card max |d| {int(d.max())}, mean "
        f"{float(d.mean())}, differing pixels {int((d > 0).any(-1).sum())};"
        f" compile+first {compile_s}s, median "
        f"{float(np.median(times))} ms (table upload included)")
    if n_drop or int(d.max()) > 1:
        raise RuntimeError("distributed render diverged from single card")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-GPU distributed phase")
    args = ap.parse_args(argv)

    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke.py needs an NVIDIA GPU; JAX backend is "
              f"{backend!r}", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from vk3dgaussiansplatting_tpu.utils.device import setup_compile_cache

    setup_compile_cache()
    want = 4 if args.multi else 1
    phase_device(want)
    if args.multi:
        config, capacity, table, cam, _live = garden_inputs()
        phase_multi(config, capacity, table, cam)
    else:
        phase_gpu_tests()
        config, capacity, table, cam, _live = garden_inputs()
        phase_kernel_vs_reference(config, capacity, table, cam)
        phase_main_path(config, table, cam)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
