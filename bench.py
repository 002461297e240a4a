"""Benchmark entry point — prints ONE JSON line.

Headline metric: ms per settled frame of the Garden-30k-scale scene at
1920x1080 through `Renderer.draw` on one NVIDIA GPU (reference: 28.499 ms on
an RTX 3080 Ti, BASELINE.md row Garden-30k@1080p).  A default garden run also
records train7k_720p.

Protocol:
  * The real Garden .ply is not redistributable; the scene is a procedural
    cloud with the same gaussian count whose scale distribution is
    calibrated on the device so the frame's live sort-element count matches
    the reference row (13.1M) within a few percent.
  * Each frame is timed on the host clock around `draw` and
    `block_until_ready` of its image, after a warm-up that compiles the
    frame program; the median frame is reported.  This mirrors the
    reference's warmup+average protocol (Renderer.cpp:477-487).
  * The two-part image check certifies one frame against the CPU float64
    reference (docs/ARCHITECTURE.md, "At-scale image verification").  Its
    CPU children run with JAX_PLATFORMS=cpu and CUDA_VISIBLE_DEVICES= so
    they never open the card.
  * The measurement path needs a GPU: with another backend the bench exits
    non-zero unless --cpu is given explicitly (then no device metric is
    claimed; the line says platform "cpu").

Usage:
  python bench.py                          # garden30k_1080p + train7k_720p
  python bench.py --scene train7k_720p --single-scene --blend xla
  python bench.py --cpu --scene debug_small --frames 3
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

BASELINES_MS = {
    "garden30k_1080p": 28.499,
    "garden30k_720p": 19.052,
    "train30k_1080p": 22.034,
    "train7k_720p": 8.581,
    "debug_small": 1.0,
}
SCENES = {
    # name: (num_gaussians, width, height, target_elements)
    "garden30k_1080p": (5_834_784, 1920, 1080, 13_098_506),
    "garden30k_720p": (5_834_784, 1280, 720, 8_903_222),
    "train30k_1080p": (1_026_508, 1920, 1080, 10_145_054),
    "train7k_720p": (559_263, 1280, 720, 3_487_911),
    # tiny smoke config (baseline scaled from train7k)
    "debug_small": (20_000, 256, 256, 60_000),
}
REPO = os.path.dirname(os.path.abspath(__file__))
# Scratch files of the image check (listed in .gitignore).
WORK_DIR = os.path.join(REPO, ".bench_tmp")
CPU_CHILD_ENV = {"JAX_PLATFORMS": "cpu", "CUDA_VISIBLE_DEVICES": ""}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def gpu_identity():
    """`name, power.limit` of the card as nvidia-smi reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


def build_config(scene, slack=None):
    from vk3dgaussiansplatting_tpu.core.config import RenderConfig, SortAlgorithm

    _n, width, height, _t = SCENES[scene]
    return RenderConfig(
        width=width,
        height=height,
        sort_algorithm=SortAlgorithm.XLA_SORT,
        # Skip the reference's pow2 rounding of the capacity (only its
        # bitonic backend needs it; it nearly doubles every per-slot pass).
        capacity_pow_two=False,
        **({"capacity_slack_per_tile": slack} if slack is not None else {}),
    )


def bench_camera(scene):
    from vk3dgaussiansplatting_tpu.render.camera import Camera

    _n, width, height, _t = SCENES[scene]
    cam = Camera(width / height)
    cam.set_position((0.0, 0.0, 2.0))
    cam.set_rotation(math.pi, 0.0)
    return cam


def build_scene(args, scene):
    from vk3dgaussiansplatting_tpu.scenes.synthetic import (
        procedural_cloud_table,
        procedural_surface_table,
    )

    n = SCENES[scene][0]
    if args.scene_gen == "surface":
        return procedural_surface_table(n, seed=args.seed)
    return procedural_cloud_table(
        n, seed=args.seed, opacity_mode=args.opacity_mode
    )


def calibrate_scale(host_table, cam, config, capacity, target_elements):
    """Binary-search a scale multiplier so live elements ~= target.

    Runs only the count half of keygen (projection, extents, sum); the
    table is a jit argument, never a constant."""
    import jax
    import jax.numpy as jnp

    from vk3dgaussiansplatting_tpu.ops import keygen as keygen_ops
    from vk3dgaussiansplatting_tpu.render import project as prj

    view, proj = cam.matrices()
    vj, pj = jnp.asarray(view), jnp.asarray(proj)
    pos = jnp.asarray(host_table.position)
    scale = jnp.asarray(host_table.scale)
    rot = jnp.asarray(host_table.rot)

    @jax.jit
    def count_at(mult, pos, scale, rot):
        pos_view = prj.view_transform(pos, vj)
        ndc = prj.ndc_position(pos_view, pj)
        visible = keygen_ops.cull_mask(pos_view, ndc, config)
        cov2d = prj.compute_cov2d(scale * mult, rot, pos_view, vj, config)
        sp = prj.screen_space_position(pos_view, pj, config)
        ext = prj.tile_extents(sp, cov2d, config)
        counts = jnp.where(
            visible, (ext[:, 2] - ext[:, 0]) * (ext[:, 3] - ext[:, 1]), 0
        ).astype(jnp.int32)
        return jnp.minimum(jnp.sum(counts), capacity)

    lo, hi = 0.05, 20.0
    mult = 1.0
    for _ in range(16):
        mult = math.sqrt(lo * hi)
        c = int(count_at(jnp.float32(mult), pos, scale, rot))
        if abs(c - target_elements) / target_elements < 0.01:
            break
        if c < target_elements:
            lo = mult
        else:
            hi = mult
    return mult, int(count_at(jnp.float32(mult), pos, scale, rot))


def scaled_table(host_table, mult):
    from vk3dgaussiansplatting_tpu.models.gaussians import GaussianTable

    return GaussianTable(
        position=host_table.position,
        scale=host_table.scale * np.float32(mult),
        rot=host_table.rot,
        sh=host_table.sh,
        opacity=host_table.opacity,
    )


def checked_frame(table, view, proj, cam_pos, *, config, capacity):
    """The frame of `render_frame` (kernel tier) returning its sorted
    elements, ranges and frame data as well, for the blend certification
    on identical inputs."""
    from vk3dgaussiansplatting_tpu.ops import blend as blend_ops
    from vk3dgaussiansplatting_tpu.ops import keygen as keygen_ops
    from vk3dgaussiansplatting_tpu.ops import ranges as ranges_ops
    from vk3dgaussiansplatting_tpu.ops import sort as sort_ops
    from vk3dgaussiansplatting_tpu.ops.pallas import blend_kernel

    el, fr = keygen_ops.generate_sort_elements(
        table, view, proj, cam_pos, config, capacity
    )
    el = sort_ops.sort_elements(el, config)
    rg = ranges_ops.find_ranges(el, config.num_tiles)
    img = blend_kernel.blend_tiles_kernel(el, rg, fr, config)
    return blend_ops.quantize_image(img), el, rg, fr


def spawn_cpu(cmd, **kw):
    return subprocess.Popen(
        [sys.executable, "-u", os.path.abspath(__file__), "--cpu", *cmd],
        env={**os.environ, **CPU_CHILD_ENV},
        **kw,
    )


def compute_apps():
    """PIDs holding the card (logged to show the CPU children do not)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return None


def run_scene(args, scene):
    import jax
    import jax.numpy as jnp

    from vk3dgaussiansplatting_tpu.pipeline import Renderer

    n_gauss, width, height, target = SCENES[scene]
    config = build_config(scene, args.slack)
    capacity = config.sort_capacity(n_gauss)
    cam = bench_camera(scene)
    t0 = time.time()
    host_table = build_scene(args, scene)
    mult, live = calibrate_scale(host_table, cam, config, capacity, target)
    setup_s = time.time() - t0
    log(f"bench scene={scene} n={n_gauss} {width}x{height} capacity="
        f"{capacity} scale x{mult:.4f} -> {live} live (target {target}), "
        f"set-up {setup_s:.1f}s")
    table = scaled_table(host_table, mult)
    del host_table

    image_check = not args.no_image_check
    os.makedirs(WORK_DIR, exist_ok=True)
    ref_path = os.path.join(WORK_DIR, f"ref_{scene}_{args.seed}.npy")
    ref_proc = None
    if image_check:
        # Part 2's CPU reference renders the same scene meanwhile.
        ref_proc = spawn_cpu(
            ["--scene", scene, "--seed", str(args.seed),
             "--scene-gen", args.scene_gen, "--opacity-mode",
             args.opacity_mode, "--scale-mult", repr(mult),
             "--ref-frame-out", ref_path]
            + (["--slack", str(args.slack)] if args.slack is not None else []),
            stdout=subprocess.DEVNULL,
        )
        _REF_PROCS.append(ref_proc)
        log(f"image-check: CPU reference pid {ref_proc.pid}; card holders: "
            f"{compute_apps()}")

    use_kernel = args.blend == "kernel" and jax.default_backend() == "gpu"
    renderer = Renderer(config, use_pallas_blend=use_kernel)
    renderer.init_for_scene(table)
    t0 = time.time()
    out = renderer.draw(cam)
    jax.block_until_ready(out.image_u8)
    compile_s = time.time() - t0
    count = int(out.num_elements)
    for _ in range(2):
        jax.block_until_ready(renderer.draw(cam).image_u8)
    times = []
    for _ in range(args.frames):
        t0 = time.perf_counter()
        out = renderer.draw(cam)
        jax.block_until_ready(out.image_u8)
        times.append((time.perf_counter() - t0) * 1e3)
    ms = float(np.median(times))
    stats = jax.devices()[0].memory_stats() or {}
    passes = pass_times(renderer, cam, config, capacity, use_kernel)
    log(f"{scene}: compile+first frame {compile_s:.1f}s, frames ms "
        f"{[round(t, 3) for t in times]} -> median {ms:.3f}")
    result = {
        "metric": f"{scene}_ms_per_frame",
        "value": ms,
        "unit": "ms",
        "vs_baseline": BASELINES_MS[scene] / ms,
        "blend": "kernel" if use_kernel else "xla",
        "live_elements": count,
        "capacity": capacity,
        "compile_s": compile_s,
        "setup_s": setup_s,
        "frame_ms_min": float(np.min(times)),
        "frame_ms_max": float(np.max(times)),
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "pass_ms": passes,
    }
    if image_check:
        result.update(image_check_scene(
            args, scene, renderer, cam, config, capacity,
            np.asarray(out.image_u8), ref_proc, ref_path,
        ))
    return result


def pass_times(renderer, cam, config, capacity, use_kernel, reps=5):
    """Median host-clock ms of each pass run as its own jitted program
    (keygen, sort, ranges, blend): a breakdown, not the frame's time,
    since one program lets XLA overlap and fuse across passes."""
    import jax
    import jax.numpy as jnp

    from vk3dgaussiansplatting_tpu.ops import blend as blend_ops
    from vk3dgaussiansplatting_tpu.ops import keygen as keygen_ops
    from vk3dgaussiansplatting_tpu.ops import ranges as ranges_ops
    from vk3dgaussiansplatting_tpu.ops import sort as sort_ops
    from vk3dgaussiansplatting_tpu.ops.pallas import blend_kernel

    view, proj = cam.matrices()
    args = (renderer.table, jnp.asarray(view), jnp.asarray(proj),
            jnp.asarray(cam.position, dtype=jnp.float32))
    blend = blend_kernel.blend_tiles_kernel if use_kernel else (
        blend_ops.blend_tiles_xla
    )
    kg = jax.jit(lambda t, v, p, c: keygen_ops.generate_sort_elements(
        t, v, p, c, config, capacity))
    so = jax.jit(lambda e: sort_ops.sort_elements(e, config))
    rg = jax.jit(lambda e: ranges_ops.find_ranges(e, config.num_tiles))
    bl = jax.jit(lambda e, r, f: blend(e, r, f, config))
    el, fr = kg(*args)
    se = so(el)
    r = rg(se)
    out = {}
    for name, fn in (("keygen", lambda: kg(*args)), ("sort", lambda: so(el)),
                     ("ranges", lambda: rg(se)),
                     ("blend", lambda: bl(se, r, fr))):
        jax.block_until_ready(fn())
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            ts.append((time.perf_counter() - t0) * 1e3)
        out[name] = float(np.median(ts))
    log(f"pass ms (separate programs): {out}")
    return out


def image_check_scene(args, scene, renderer, cam, config, capacity, img_u8,
                      ref_proc, ref_path):
    """Two-part image check of one settled frame.

    Part 1 (tight): the check frame's sorted elements, ranges and frame
    data are fetched and blended by the CPU float64 reference tier; the
    kernel image of the same inputs must match (mean |d| <= 0.75, max <= 8).
    Part 2 (loose): the drawn image against an independent CPU render of
    the same scene (keygen included): cross-platform transcendental drift
    in per-gaussian frame data is expected, a keygen miscompile is not
    (mean |d| <= 9, fraction of pixels off by > 16 <= 0.3).
    """
    import jax
    import jax.numpy as jnp

    out = {}
    view, proj = cam.matrices()
    fn = jax.jit(checked_frame, static_argnames=("config", "capacity"))
    u8, el, rg, fr = fn(
        renderer.table, jnp.asarray(view), jnp.asarray(proj),
        jnp.asarray(cam.position, dtype=jnp.float32),
        config=config, capacity=capacity,
    )
    xd_path = os.path.join(WORK_DIR, f"xd_{scene}.npz")
    np.savez(
        xd_path,
        tile=np.asarray(el.tile), index=np.asarray(el.index),
        ranges=np.asarray(rg),
        screen_pos=np.asarray(fr.screen_pos),
        color_alpha=np.asarray(fr.color_alpha),
        cov_inv=np.asarray(fr.cov_inv),
        img_u8=np.asarray(u8),
    )
    del u8, el, rg, fr
    t0 = time.time()
    proc = spawn_cpu(["--scene", scene, "--crossdata", xd_path],
                     stdout=subprocess.PIPE, text=True)
    log(f"image-check: crossdata pid {proc.pid}; card holders: "
        f"{compute_apps()}")
    stdout, _ = proc.communicate(timeout=args.check_timeout)
    try:
        verdict = json.loads(stdout.strip().splitlines()[-1])
        blend_ok = bool(verdict["mean"] <= 0.75 and verdict["max"] <= 8)
    except (IndexError, KeyError, ValueError):
        verdict, blend_ok = None, False
    log(f"image-check blend (+{time.time() - t0:.0f}s): {verdict} -> "
        f"{'OK' if blend_ok else 'FAIL'}")
    out["image_check_blend"] = verdict

    t0 = time.time()
    rc = ref_proc.wait(timeout=args.check_timeout)
    drift_ok = False
    if rc == 0 and os.path.exists(ref_path):
        ref_u8 = np.load(ref_path)
        d = np.abs(img_u8[..., :3].astype(np.int32)
                   - ref_u8[..., :3].astype(np.int32))
        frac_gt16 = float((d > 16).any(axis=-1).mean())
        drift_ok = bool(d.mean() <= 9.0 and frac_gt16 <= 0.3)
        out["image_check_drift"] = {
            "mean": float(d.mean()), "frac_gt16": frac_gt16,
            "max": int(d.max()),
        }
    log(f"image-check drift (CPU reference rc={rc}, +{time.time() - t0:.0f}s "
        f"wait): {out.get('image_check_drift')} -> "
        f"{'OK' if drift_ok else 'FAIL'}")
    out["image_ok"] = blend_ok and drift_ok
    return out


def crossdata_main(args):
    """CPU child: blend the fetched check-frame arrays with the float64
    reference tier; print a one-line JSON diff against the kernel image."""
    import jax
    import jax.numpy as jnp

    from vk3dgaussiansplatting_tpu.ops import blend as blend_ops

    jax.config.update("jax_enable_x64", True)
    z = np.load(args.crossdata)
    config = build_config(args.scene, args.slack)
    img = blend_strips_f64(
        z["tile"], z["index"], z["ranges"], z["screen_pos"],
        z["color_alpha"], z["cov_inv"], config,
    )
    u8 = np.asarray(blend_ops.quantize_image(jnp.asarray(img, jnp.float32)))
    d = np.abs(u8[..., :3].astype(np.int32)
               - z["img_u8"][..., :3].astype(np.int32))
    print(json.dumps({
        "mean": float(d.mean()),
        "max": int(d.max()),
        "frac_gt1": float((d > 1).any(-1).mean()),
    }), flush=True)


def blend_strips_f64(tile_h, idx_h, ranges, sp, ca, ci, config):
    """Full-image reference blend, one tile row at a time (CPU, float64).

    The sorted element list is sliced per tile row (elements are
    tile-contiguous after the sort).  Alpha and eligibility are computed
    in f32 with the kernel's op order (pre-scaled coefficients), so the
    f <= 0 knife-edge matches it; the transmittance accumulation runs in
    float64 so the reference is numerically stronger than the tier it
    certifies.  Needs jax_enable_x64."""
    import jax
    import jax.numpy as jnp

    from vk3dgaussiansplatting_tpu.core.config import SENTINEL
    from vk3dgaussiansplatting_tpu.ops import blend as blend_ops

    gw, gh = config.grid_width, config.grid_height
    ts = config.tile_size
    p = ts * ts
    r_host = np.asarray(ranges).astype(np.int64)
    sp, ca, ci = jnp.asarray(sp), jnp.asarray(ca), jnp.asarray(ci)

    def strip64(tile, gid, rg, t0t):
        e = tile.shape[0]
        live = tile != jnp.uint32(SENTINEL)
        tile_i = jnp.where(live, tile, 0).astype(jnp.int32)
        tile_loc = tile_i - t0t
        in_strip = live & (tile_loc >= 0) & (tile_loc < gw)
        gidx = gid.astype(jnp.int32)
        screen_pos, color_alpha, cov_inv = sp[gidx], ca[gidx], ci[gidx]
        lu, lv = blend_ops._pixel_coords(config)
        u = (tile_i % gw)[:, None].astype(jnp.float32) * ts + lu[None, :]
        v = (tile_i // gw)[:, None].astype(jnp.float32) * ts + lv[None, :]
        a = cov_inv[:, 0:1] * jnp.float32(-0.5)
        b = cov_inv[:, 1:2] * jnp.float32(-1.0)
        c = cov_inv[:, 2:3] * jnp.float32(-0.5)
        dx = screen_pos[:, 0:1] - u
        dy = v - screen_pos[:, 1:2]
        f = (a * dx * dx + c * dy * dy) + b * dx * dy
        alpha = color_alpha[:, 3:4] * jnp.exp(f)
        eligible = (f <= 0.0) & (alpha >= jnp.float32(config.alpha_cutoff))
        in_range = (jnp.arange(e)[:, None] >= rg[tile_i, 0][:, None]) & (
            jnp.arange(e)[:, None] < rg[tile_i, 1][:, None]
        )
        alpha64 = alpha.astype(jnp.float64)
        log_term = jnp.where(
            eligible & in_range & live[:, None],
            jnp.maximum(jnp.log1p(-alpha64), blend_ops.LOG_T_MIN),
            0.0,
        )
        cs_excl = jnp.cumsum(log_term, axis=0) - log_term
        seg_start = jnp.clip(rg[tile_i, 0], 0, e - 1)
        t_excl = jnp.exp(cs_excl - cs_excl[seg_start])
        w = jnp.where(
            eligible & in_range & in_strip[:, None]
            & (t_excl >= config.transmittance_stop),
            t_excl * alpha64,
            0.0,
        )
        contrib = w[:, :, None] * color_alpha[:, None, :3].astype(jnp.float64)
        tgt = jnp.where(in_strip, tile_loc, gw)
        colors = jnp.zeros((gw + 1, p, 3), jnp.float64).at[tgt].add(
            contrib, mode="drop"
        )
        return colors[:gw].astype(jnp.float32)

    strip_jit = jax.jit(strip64)
    colors_out = np.zeros((config.num_tiles, p, 3), np.float32)
    for row in range(gh):
        t0t = row * gw
        seg = r_host[t0t:t0t + gw]
        ne = seg[:, 1] > seg[:, 0]
        if not ne.any():
            continue
        e0, e1 = int(seg[ne, 0].min()), int(seg[ne, 1].max())
        pad = 1 << max(14, (e1 - e0 - 1).bit_length())
        tiles = np.full(pad, SENTINEL, np.uint32)
        tiles[:e1 - e0] = tile_h[e0:e1]
        gids = np.zeros(pad, np.uint32)
        gids[:e1 - e0] = idx_h[e0:e1]
        rg = jnp.asarray(np.clip(r_host - e0, 0, pad))
        colors_out[t0t:t0t + gw] = np.asarray(
            strip_jit(jnp.asarray(tiles), jnp.asarray(gids), rg, t0t)
        )
    return np.asarray(
        blend_ops.assemble_tile_colors(jnp.asarray(colors_out), config)
    )


def ref_frame_main(args):
    """CPU child: render ONE frame of --scene at --scale-mult through the
    CPU keygen/sort/ranges and the float64 reference blend; save the
    quantized u8 image."""
    import jax
    import jax.numpy as jnp

    from vk3dgaussiansplatting_tpu.ops import blend as blend_ops
    from vk3dgaussiansplatting_tpu.ops import keygen as keygen_ops
    from vk3dgaussiansplatting_tpu.ops import ranges as ranges_ops
    from vk3dgaussiansplatting_tpu.ops import sort as sort_ops

    # Every production dtype is explicit, so x64 only widens the
    # reference blend's accumulation.
    jax.config.update("jax_enable_x64", True)
    scene = args.scene
    config = build_config(scene, args.slack)
    capacity = config.sort_capacity(SCENES[scene][0])
    cam = bench_camera(scene)
    table = jax.tree.map(
        jnp.asarray, scaled_table(build_scene(args, scene), args.scale_mult)
    )
    view, proj = cam.matrices()

    @jax.jit
    def passes(t, v, p, c):
        el, fr = keygen_ops.generate_sort_elements(
            t, v, p, c, config, capacity
        )
        el = sort_ops.sort_elements(el, config)
        return el, ranges_ops.find_ranges(el, config.num_tiles), fr

    el, rg, fr = passes(table, jnp.asarray(view), jnp.asarray(proj),
                        jnp.asarray(cam.position, dtype=jnp.float32))
    img = blend_strips_f64(
        np.asarray(el.tile), np.asarray(el.index), rg, fr.screen_pos,
        fr.color_alpha, fr.cov_inv, config,
    )
    u8 = np.asarray(blend_ops.quantize_image(jnp.asarray(img)))
    tmp = args.ref_frame_out + ".tmp.npy"
    np.save(tmp, u8)
    os.replace(tmp, args.ref_frame_out)


_REF_PROCS = []  # CPU reference children (killed if the bench dies)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="garden30k_1080p", choices=SCENES)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--blend", default="kernel", choices=["kernel", "xla"],
                    help="blend tier on the GPU: the tile-blend kernel "
                         "(production) or the plain-XLA tier")
    ap.add_argument("--opacity-mode", default="capture",
                    choices=["capture", "translucent"])
    ap.add_argument("--scene-gen", default="cloud",
                    choices=["cloud", "surface"])
    ap.add_argument("--slack", type=int, default=None,
                    help="capacity_slack_per_tile override (reference: 1024)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU backend (smoke runs; no device "
                         "metric); without it a non-GPU backend is refused")
    ap.add_argument("--single-scene", action="store_true",
                    help="bench only --scene (a default garden run also "
                         "records train7k_720p)")
    ap.add_argument("--no-image-check", action="store_true")
    ap.add_argument("--check-timeout", type=float, default=2400.0)
    # Internal modes of the CPU children.
    ap.add_argument("--ref-frame-out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--scale-mult", type=float, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--crossdata", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.ref_frame_out is not None:
        ref_frame_main(args)
        return 0
    if args.crossdata is not None:
        crossdata_main(args)
        return 0

    backend = jax.default_backend()
    if backend != "gpu" and not args.cpu:
        log(f"bench.py needs an NVIDIA GPU (JAX backend is {backend!r}); "
            f"pass --cpu for a CPU smoke run")
        return 2

    from vk3dgaussiansplatting_tpu.utils.device import setup_compile_cache

    log(f"compile cache: {setup_compile_cache()}")
    scenes = [args.scene]
    if not args.single_scene and args.scene == "garden30k_1080p":
        scenes.append("train7k_720p")
    results = []
    try:
        for s in scenes:
            results.append(run_scene(args, s))
    finally:
        for p in _REF_PROCS:
            if p.poll() is None:
                p.kill()
    dev = jax.devices()[0]
    result = dict(results[0])
    result["device"] = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }
    result["gpu"] = gpu_identity() if dev.platform == "gpu" else None
    if len(results) > 1:
        result["scenes"] = {r["metric"]: r for r in results}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
