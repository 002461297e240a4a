"""Sequential numpy oracle of the full 9-pass reference pipeline.

An *independent* reimplementation of the reference renderer's math
(Common.glsl / InitSortList.comp / FindRanges.comp / RenderGaussians.comp) in
plain float32 numpy, structured like the GLSL (per-gaussian 3x3 matrix
products, per-tile sequential front-to-back blend with the exact per-pixel
early-out recurrence).  The JAX/Pallas pipeline is validated against this
oracle in tests; the reference has no test suite (SURVEY.md §4), so this
oracle *is* the golden model.

Determinism note: the reference allocates sort elements with an atomicAdd
whose order is nondeterministic (InitSortList.comp:131); both this oracle and
the JAX pipeline use the deterministic prefix-sum order (gaussian index order,
row-major tiles within a gaussian).  Since the sort is stable on the 64-bit
key, the blended output is identical for any allocation order when no
(tile, depth) ties exist between different gaussians, and deterministic here
even when they do.

Tolerance story (see also ops/blend.py): the oracle blend is the sequential
recurrence, as is the GPU tile-blend kernel; the XLA tier uses the
log-space product.  Integer outputs (keys,
sorted order, ranges) must match exactly; float images to ~1e-3 absolute,
quantized images to +-1 8-bit step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..core.config import SENTINEL, RenderConfig, SphericalHarmonicsMode

F = np.float32


def _f(x):
    return np.float32(x)


def quat_rot_matrix_np(rot):
    """getRotMat (Common.glsl:17-30) -> [N,3,3] math matrices (see
    render.project.quat_rot_matrix for the layout discussion)."""
    r, x, y, z = rot[:, 0], rot[:, 1], rot[:, 2], rot[:, 3]
    one, two = _f(1.0), _f(2.0)
    m = np.empty((rot.shape[0], 3, 3), dtype=F)
    m[:, 0, 0] = one - two * y * y - two * z * z
    m[:, 1, 0] = two * x * y - two * r * z
    m[:, 2, 0] = two * x * z + two * r * y
    m[:, 0, 1] = two * x * y + two * r * z
    m[:, 1, 1] = one - two * x * x - two * z * z
    m[:, 2, 1] = two * y * z - two * r * x
    m[:, 0, 2] = two * x * z - two * r * y
    m[:, 1, 2] = two * y * z + two * r * x
    m[:, 2, 2] = one - two * x * x - two * y * y
    return m


def compute_cov2d_glsl_np(scale, rot, pos_view, view, config: RenderConfig):
    """getCovarianceMatrix (Common.glsl:32-78), full 3x3 products exactly as
    the GLSL associates them.  Used to validate (to float32 tolerance) the
    restructured canonical formulation below — reassociation shifts ~1e-6
    relative, which can flip the ceil() in the tile radius, so the *canonical*
    pipeline formulation is `compute_cov2d_np` and this one is the tolerance
    cross-check (see TOLERANCES in tests)."""
    n = scale.shape[0]
    rmat = quat_rot_matrix_np(rot)
    smat = np.zeros((n, 3, 3), dtype=F)
    smat[:, 0, 0] = scale[:, 0]
    smat[:, 1, 1] = scale[:, 1]
    smat[:, 2, 2] = scale[:, 2]
    rs = np.einsum("nij,njk->nik", rmat, smat).astype(F)
    sigma = np.einsum("nij,nkj->nik", rs, rs).astype(F)

    w3 = view[:3, :3].astype(F)

    tan_fov_y = _f(math.tan(config.shader_fov_y * 0.5))
    tan_fov_x = _f(tan_fov_y * config.width / config.height)
    focal_x = _f(config.width / (2.0 * float(tan_fov_x)))
    focal_y = _f(config.height / (2.0 * float(tan_fov_y)))

    x, y, z = pos_view[:, 0].copy(), pos_view[:, 1].copy(), pos_view[:, 2]
    lim_x = tan_fov_x * _f(config.in_view_limit)
    lim_y = tan_fov_y * _f(config.in_view_limit)
    x = np.clip(x / z, -lim_x, lim_x) * z
    y = np.clip(y / z, -lim_y, lim_y) * z

    j = np.zeros((n, 3, 3), dtype=F)
    j[:, 0, 0] = focal_x / z
    j[:, 0, 2] = -(focal_x * x) / (z * z)
    j[:, 1, 1] = focal_y / z
    j[:, 1, 2] = -(focal_y * y) / (z * z)

    jw = np.einsum("nij,jk->nik", j, w3).astype(F)
    sp = np.einsum("nij,njk,nlk->nil", jw, sigma, jw).astype(F)
    cov = np.stack([sp[:, 0, 0], sp[:, 0, 1], sp[:, 1, 1]], axis=-1)
    cov[:, 0] += _f(config.covariance_dilation)
    cov[:, 2] += _f(config.covariance_dilation)
    return cov


def compute_cov2d_np(scale, rot, pos_view, view, config: RenderConfig):
    """Canonical 2D covariance — numpy mirror of render.project.compute_cov2d
    (same A = W·R·S decomposition and operation order, so integer-derived
    quantities like the tile radius agree exactly with the XLA path)."""
    rmat = quat_rot_matrix_np(rot)
    rs = (rmat * scale[:, None, :]).astype(F)
    w3 = view[:3, :3].astype(F)
    a = np.einsum("rc,ncd->nrd", w3, rs).astype(F)

    # Same float64 pre-computation + single f32 rounding as
    # render.project.focal_lengths, so constants match the XLA path bit-wise.
    tan_fov_y64 = math.tan(config.shader_fov_y * 0.5)
    tan_fov_x64 = tan_fov_y64 * config.width / config.height
    tan_fov_x, tan_fov_y = _f(tan_fov_x64), _f(tan_fov_y64)
    focal_x = _f(config.width / (2.0 * tan_fov_x64))
    focal_y = _f(config.height / (2.0 * tan_fov_y64))

    x, y, z = pos_view[:, 0], pos_view[:, 1], pos_view[:, 2]
    lim_x = _f(float(tan_fov_x) * config.in_view_limit)
    lim_y = _f(float(tan_fov_y) * config.in_view_limit)
    tx = np.clip(x / z, -lim_x, lim_x) * z
    ty = np.clip(y / z, -lim_y, lim_y) * z

    inv_z = _f(1.0) / z
    j00 = focal_x * inv_z
    j02 = -(focal_x * tx) * inv_z * inv_z
    j11 = focal_y * inv_z
    j12 = -(focal_y * ty) * inv_z * inv_z

    b0 = (j00[:, None] * a[:, 0, :] + j02[:, None] * a[:, 2, :]).astype(F)
    b1 = (j11[:, None] * a[:, 1, :] + j12[:, None] * a[:, 2, :]).astype(F)

    cov_x = np.sum(b0 * b0, axis=-1, dtype=F) + _f(config.covariance_dilation)
    cov_y = np.sum(b0 * b1, axis=-1, dtype=F)
    cov_z = np.sum(b1 * b1, axis=-1, dtype=F) + _f(config.covariance_dilation)
    return np.stack([cov_x, cov_y, cov_z], axis=-1).astype(F)


def screen_space_position_np(pos_view, proj, config: RenderConfig):
    clip = (pos_view @ proj[:3, :3].T.astype(F) + proj[:3, 3].astype(F)).astype(F)
    w = -pos_view[:, 2]
    ndc = clip[:, :2] / w[:, None]
    sx = (ndc[:, 0] + _f(1.0)) * _f(0.5) * _f(config.width)
    sy = (-ndc[:, 1] + _f(1.0)) * _f(0.5) * _f(config.height)
    return np.stack([sx, sy], axis=-1).astype(F)


def depth_key_np(z_view, config: RenderConfig):
    near, far = _f(config.near_plane), _f(config.far_plane)
    d = np.clip((-z_view - near) / (far - near), _f(0.0), _f(1.0))
    f = d * _f(4294967295.0)
    out = np.empty(d.shape, dtype=np.uint32)
    hi = f >= _f(4294967296.0)
    out[hi] = np.uint32(SENTINEL)
    out[~hi] = np.minimum(f[~hi], _f(4294967040.0)).astype(np.uint32)
    return out


def sh_basis16_np(eval_dir):
    fx = -eval_dir[:, 0]
    fy = -eval_dir[:, 1]
    fz = eval_dir[:, 2]
    fz2 = fz * fz
    p = np.zeros((eval_dir.shape[0], 16), dtype=F)
    p[:, 0] = _f(0.2820947917738781)
    p[:, 2] = _f(0.4886025119029199) * fz
    p[:, 6] = _f(0.9461746957575601) * fz2 + _f(-0.31539156525252)
    p[:, 12] = fz * (_f(1.865881662950577) * fz2 + _f(-1.119528997770346))
    fc0, fs0 = fx, fy
    tmp_a = _f(-0.48860251190292)
    p[:, 3] = tmp_a * fc0
    p[:, 1] = tmp_a * fs0
    tmp_b = _f(-1.092548430592079) * fz
    p[:, 7] = tmp_b * fc0
    p[:, 5] = tmp_b * fs0
    tmp_c = _f(-2.285228997322329) * fz2 + _f(0.4570457994644658)
    p[:, 13] = tmp_c * fc0
    p[:, 11] = tmp_c * fs0
    fc1 = fx * fc0 - fy * fs0
    fs1 = fx * fs0 + fy * fc0
    tmp_a = _f(0.5462742152960395)
    p[:, 8] = tmp_a * fc1
    p[:, 4] = tmp_a * fs1
    tmp_b = _f(1.445305721320277) * fz
    p[:, 14] = tmp_b * fc1
    p[:, 10] = tmp_b * fs1
    fc0b = fx * fc1 - fy * fs1
    fs0b = fx * fs1 + fy * fc1
    tmp_c = _f(-0.5900435899266435)
    p[:, 15] = tmp_c * fc0b
    p[:, 9] = tmp_c * fs0b
    return p


def sh_color_np(eval_dir, sh_coeffs, mode: SphericalHarmonicsMode):
    basis = sh_basis16_np(eval_dir)
    n = eval_dir.shape[0]
    result = np.zeros((n, 3), dtype=F)
    if mode == SphericalHarmonicsMode.ALL_BANDS:
        for i in range(16):  # sequential sum order like the GLSL loop
            result += basis[:, i : i + 1] * sh_coeffs[:, i, :]
    elif mode == SphericalHarmonicsMode.SKIP_FIRST_BAND:
        for i in range(1, 16):
            result += basis[:, i : i + 1] * sh_coeffs[:, i, :]
        result -= _f(0.5)
    elif mode == SphericalHarmonicsMode.ONLY_FIRST_BAND:
        result += basis[:, 0:1] * sh_coeffs[:, 0, :]
    result += _f(0.5)
    return np.maximum(result, _f(0.0))


@dataclass
class OracleFrame:
    """All intermediates of one oracle frame (for per-op parity tests)."""

    visible: np.ndarray
    depth_key: np.ndarray
    cov2d: np.ndarray
    cov_inv: np.ndarray
    screen_pos: np.ndarray
    color_alpha: np.ndarray
    extents: np.ndarray
    counts: np.ndarray
    total: int
    tile: np.ndarray
    depth: np.ndarray
    index: np.ndarray
    order: np.ndarray
    ranges: np.ndarray
    image: np.ndarray
    image_u8: np.ndarray


def render_frame_oracle(table, camera, config: RenderConfig) -> OracleFrame:
    """Run the whole 9-pass pipeline sequentially in numpy float32."""
    view, proj = camera.matrices()
    view = view.astype(F)
    proj = proj.astype(F)
    cam_pos = camera.position.astype(F)

    pos = np.asarray(table.position, dtype=F)
    scale = np.asarray(table.scale, dtype=F)
    rot = np.asarray(table.rot, dtype=F)
    sh = np.asarray(table.sh, dtype=F)
    opacity = np.asarray(table.opacity, dtype=F)
    n = pos.shape[0]

    # --- InitSortList ----------------------------------------------------
    pos_view = (pos @ view[:3, :3].T + view[:3, 3]).astype(F)
    clip = (pos_view @ proj[:3, :3].T + proj[:3, 3]).astype(F)
    ndc = clip / (-pos_view[:, 2])[:, None]
    visible = (-pos_view[:, 2] > _f(config.near_plane)) & (
        np.abs(ndc[:, 0]) <= _f(config.culling_ndc_limit)
    ) & (np.abs(ndc[:, 1]) <= _f(config.culling_ndc_limit))

    dkey = depth_key_np(pos_view[:, 2], config)
    cov2d = compute_cov2d_np(scale, rot, pos_view, view, config)
    screen_pos = screen_space_position_np(pos_view, proj, config)

    # tile extents (InitSortList.comp:47-68)
    cx, cy, cz = cov2d[:, 0], cov2d[:, 1], cov2d[:, 2]
    det = cx * cz - cy * cy
    m = (cx + cz) * _f(0.5)
    s = np.sqrt(np.maximum(m * m - det, _f(0.0)))
    radius = np.ceil(_f(3.0) * np.sqrt(np.maximum(m + s, m - s)))
    ts = _f(config.tile_size)
    gw, gh = config.grid_width, config.grid_height
    min_x = np.clip(((screen_pos[:, 0] - radius) / ts).astype(np.int32), 0, gw)
    min_y = np.clip(((screen_pos[:, 1] - radius) / ts).astype(np.int32), 0, gh)
    max_x = np.clip(((screen_pos[:, 0] + radius) / ts).astype(np.int32) + 1, 0, gw)
    max_y = np.clip(((screen_pos[:, 1] + radius) / ts).astype(np.int32) + 1, 0, gh)
    extents = np.stack([min_x, min_y, max_x, max_y], axis=-1)

    with np.errstate(invalid="ignore", divide="ignore"):
        dirs = pos - cam_pos[None, :]
        dirs = dirs / np.sqrt((dirs * dirs).sum(axis=-1, keepdims=True))
        rgb = sh_color_np(np.nan_to_num(dirs), sh, config.sh_mode)
    color_alpha = np.concatenate([rgb, opacity[:, None]], axis=-1).astype(F)

    det_ok = det != _f(0.0)
    with np.errstate(divide="ignore"):
        det_inv = np.where(det_ok, _f(1.0) / det, _f(0.0)).astype(F)
    cov_inv = (np.stack([cz, -cy, cx], axis=-1) * det_inv[:, None]).astype(F)
    color_alpha[~det_ok, 3] = _f(0.0)

    counts = np.where(visible, (max_x - min_x) * (max_y - min_y), 0).astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    total = int(counts.sum())
    capacity = config.sort_capacity(n)

    tile = np.full(capacity, SENTINEL, dtype=np.uint32)
    depth = np.full(capacity, SENTINEL, dtype=np.uint32)
    index = np.full(capacity, SENTINEL, dtype=np.uint32)
    for g in range(n):
        if counts[g] == 0:
            continue
        o = offsets[g]
        k = 0
        for ty in range(min_y[g], max_y[g]):
            for tx in range(min_x[g], max_x[g]):
                slot = o + k
                if slot < capacity:  # overflow drop (InitSortList.comp:143)
                    tile[slot] = np.uint32(ty * gw + tx)
                    depth[slot] = dkey[g]
                    index[slot] = np.uint32(g)
                k += 1

    # --- sort (stable by 64-bit (tile << 32) | depth) --------------------
    order = np.lexsort((depth, tile))  # stable: last key primary
    tile_s, depth_s, index_s = tile[order], depth[order], index[order]

    # --- FindRanges ------------------------------------------------------
    num_tiles = config.num_tiles
    ranges = np.zeros((num_tiles, 2), dtype=np.uint32)
    e = capacity
    # Exactly the reference's three thread cases (FindRanges.comp:44-70):
    # interior boundary threads write end[prev]=i / start[cur]=i; thread 0
    # writes only a start; thread e-1 writes only end = e-1 (quirk: the final
    # slot is excluded — benign because it is sentinel padding in practice).
    for i in range(e):
        t = tile_s[i]
        if 0 < i < e - 1:
            tp = tile_s[i - 1]
            if tp != t:
                if tp != SENTINEL:
                    ranges[tp, 1] = i
                if t != SENTINEL:
                    ranges[t, 0] = i
        elif i == 0:
            if t != SENTINEL:
                ranges[t, 0] = i
        elif i == e - 1:
            if t != SENTINEL:
                ranges[t, 1] = i

    # --- RenderGaussians (sequential blend) ------------------------------
    tsz = config.tile_size
    height, width = config.height, config.width
    img = np.zeros((gh * tsz, gw * tsz, 3), dtype=F)
    one = _f(1.0)
    for tile_id in range(num_tiles):
        r0, r1 = int(ranges[tile_id, 0]), int(ranges[tile_id, 1])
        if r1 <= r0:
            continue
        ty, tx = divmod(tile_id, gw)
        px = (np.arange(tsz, dtype=F) + _f(tx * tsz))[None, :]  # u along cols
        py = (np.arange(tsz, dtype=F) + _f(ty * tsz))[:, None]  # v along rows
        color = np.zeros((tsz, tsz, 3), dtype=F)
        t_i = np.full((tsz, tsz), one, dtype=F)
        done = np.zeros((tsz, tsz), dtype=bool)
        for slot in range(r0, r1):
            g = index_s[slot]
            if g == SENTINEL:
                continue
            gx, gy = screen_pos[g, 0], screen_pos[g, 1]
            a, b, c = cov_inv[g, 0], cov_inv[g, 1], cov_inv[g, 2]
            galpha = color_alpha[g, 3]
            dx = gx - px
            dy = py - gy  # evalX.y = -evalX.y
            f = _f(-0.5) * (a * dx * dx + c * dy * dy) - b * dx * dy
            alpha = galpha * np.exp(f)
            skip = (f > _f(0.0)) | (alpha < _f(config.alpha_cutoff))
            active = (~done) & (~skip)
            if not active.any():
                if done.all():
                    break
                continue
            color += np.where(active, t_i * alpha, _f(0.0))[:, :, None] * color_alpha[
                g, :3
            ][None, None, :]
            next_t = (t_i * (one - alpha)).astype(F)
            newly_done = active & (next_t < _f(config.transmittance_stop))
            t_i = np.where(active & ~newly_done, next_t, t_i).astype(F)
            done |= newly_done
        img[ty * tsz : (ty + 1) * tsz, tx * tsz : (tx + 1) * tsz] = color

    img = np.clip(img[:height, :width], 0.0, 1.0).astype(F)
    img_u8 = np.concatenate(
        [
            np.round(img * _f(255.0)).astype(np.uint8),
            np.full((height, width, 1), 255, dtype=np.uint8),
        ],
        axis=-1,
    )
    return OracleFrame(
        visible=visible,
        depth_key=dkey,
        cov2d=cov2d,
        cov_inv=cov_inv,
        screen_pos=screen_pos,
        color_alpha=color_alpha,
        extents=extents,
        counts=counts,
        total=total,
        tile=tile_s,
        depth=depth_s,
        index=index_s,
        order=order,
        ranges=ranges,
        image=img,
        image_u8=img_u8,
    )
