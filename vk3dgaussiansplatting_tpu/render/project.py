"""Per-gaussian projection math, vectorized over the whole table.

Re-derivation of the reference's GLSL math (Common.glsl +
InitSortList.comp): instead of one thread per gaussian, every function here is
a pure `jax.numpy` map over `[N]` arrays that XLA fuses into a handful of
elementwise loops.  All math is float32, matching the GLSL precision.

Faithfulness notes:
  * `quat_rot_matrix` reproduces getRotMat (Common.glsl:17-30) including its
    column-major literal layout — the resulting *math* matrix is the transpose
    of the textbook quaternion rotation; sigma = R S (R S)^T is insensitive to
    the convention only through the full product, so the exact layout is kept.
  * The EWA projection (Common.glsl:32-78) is restructured: instead of forming
    J·W·Sigma·W^T·J^T as 3x3 matmuls per gaussian, we build A = W·R·S (one
    [N,3,3] batch) and contract the two non-zero Jacobian rows against it —
    the 2x2 output covariance comes out as three dot products, all
    elementwise (no tiny matrix products).
  * View-space xy is clamped to +-tanFov*IN_VIEW_LIMIT before the Jacobian
    (Common.glsl:58-63) and cov.x/cov.z are dilated by +0.3 (Common.glsl:73-75).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from ..core.config import MAX_UINT32, RenderConfig, SphericalHarmonicsMode

F32 = jnp.float32


def view_transform(position, view):
    """World -> view space: rows of `view` [4,4] applied to [N,3] positions."""
    return position @ view[:3, :3].T + view[:3, 3]


def quat_rot_matrix(rot):
    """getRotMat (Common.glsl:17-30) for [N,4] quaternions (r,x,y,z).

    Returns [N,3,3] math matrices equal to the GLSL column-major literal, i.e.
    M[n, row, col]; M is the transpose of the textbook rotation matrix.
    """
    r, x, y, z = rot[:, 0], rot[:, 1], rot[:, 2], rot[:, 3]
    one = jnp.float32(1.0)
    two = jnp.float32(2.0)
    # GLSL constructor columns -> math matrix columns.
    col0 = jnp.stack(
        [one - two * y * y - two * z * z, two * x * y - two * r * z, two * x * z + two * r * y],
        axis=-1,
    )
    col1 = jnp.stack(
        [two * x * y + two * r * z, one - two * x * x - two * z * z, two * y * z - two * r * x],
        axis=-1,
    )
    col2 = jnp.stack(
        [two * x * z - two * r * y, two * y * z + two * r * x, one - two * x * x - two * y * y],
        axis=-1,
    )
    return jnp.stack([col0, col1, col2], axis=-1)  # [N, row, col]


def focal_lengths(config: RenderConfig):
    """Focal lengths from the hard-coded shader FOV (Common.glsl:53-56)."""
    tan_fov_y = math.tan(config.shader_fov_y * 0.5)
    tan_fov_x = tan_fov_y * config.width / config.height
    focal_x = config.width / (2.0 * tan_fov_x)
    focal_y = config.height / (2.0 * tan_fov_y)
    return np.float32(tan_fov_x), np.float32(tan_fov_y), np.float32(focal_x), np.float32(focal_y)


def compute_cov2d(scale, rot, pos_view, view, config: RenderConfig):
    """2D screen-space covariance (cov.x, cov.y, cov.z) per gaussian.

    Reference: getCovarianceMatrix (Common.glsl:32-78).
      Sigma  = (R S)(R S)^T
      Sigma' = J W Sigma W^T J^T, with view-space xy clamped to the
               IN_VIEW_LIMIT frustum margin before building J.
    Returns [N,3] = (Sigma'_00, Sigma'_01, Sigma'_11) with +0.3 dilation on
    the diagonal.
    """
    tan_fov_x, tan_fov_y, focal_x, focal_y = focal_lengths(config)

    rmat = quat_rot_matrix(rot)  # [N,3,3]
    # RS: scale the columns of R (GLSL rotMat * scaleMat).
    rs = rmat * scale[:, None, :]
    # A = W @ RS, W = upper 3x3 of the (row-major) view matrix.
    w3 = view[:3, :3]
    a = jnp.einsum("rc,ncd->nrd", w3, rs)

    # Clamp view-space xy (Common.glsl:58-63).
    x, y, z = pos_view[:, 0], pos_view[:, 1], pos_view[:, 2]
    lim_x = jnp.float32(tan_fov_x * config.in_view_limit)
    lim_y = jnp.float32(tan_fov_y * config.in_view_limit)
    tx = jnp.clip(x / z, -lim_x, lim_x) * z
    ty = jnp.clip(y / z, -lim_y, lim_y) * z

    # Non-zero Jacobian rows (Common.glsl:65-67):
    #   j0 = (fx/z, 0, -fx*tx/z^2),  j1 = (0, fy/z, -fy*ty/z^2)
    inv_z = jnp.float32(1.0) / z
    j00 = focal_x * inv_z
    j02 = -(focal_x * tx) * inv_z * inv_z
    j11 = focal_y * inv_z
    j12 = -(focal_y * ty) * inv_z * inv_z

    # b_i = j_i @ A  -> [N,3] each; Sigma' rows come from B B^T.
    b0 = j00[:, None] * a[:, 0, :] + j02[:, None] * a[:, 2, :]
    b1 = j11[:, None] * a[:, 1, :] + j12[:, None] * a[:, 2, :]

    cov_x = jnp.sum(b0 * b0, axis=-1) + jnp.float32(config.covariance_dilation)
    cov_y = jnp.sum(b0 * b1, axis=-1)
    cov_z = jnp.sum(b1 * b1, axis=-1) + jnp.float32(config.covariance_dilation)
    return jnp.stack([cov_x, cov_y, cov_z], axis=-1)


def screen_space_position(pos_view, proj, config: RenderConfig):
    """getScreenSpacePosition (Common.glsl:80-89): NDC -> pixel coords with
    y-flip.  Returns [N,2] float32 pixel positions."""
    clip = pos_view @ proj[:3, :3].T + proj[:3, 3]
    w = -pos_view[:, 2]  # proj row 3 = (0,0,-1,0)
    ndc = clip[:, :2] / w[:, None]
    sx = (ndc[:, 0] + jnp.float32(1.0)) * jnp.float32(0.5) * jnp.float32(config.width)
    sy = (-ndc[:, 1] + jnp.float32(1.0)) * jnp.float32(0.5) * jnp.float32(config.height)
    return jnp.stack([sx, sy], axis=-1)


def ndc_position(pos_view, proj):
    """Full NDC xyz (used by culling, InitSortList.comp:97-101)."""
    clip = pos_view @ proj[:3, :3].T + proj[:3, 3]
    w = -pos_view[:, 2]
    return clip / w[:, None]


def depth_key(z_view, config: RenderConfig):
    """getDepthKey (InitSortList.comp:70-80): normalized view depth scaled to
    uint32.

    GLSL computes `uint(clamp(d,0,1) * float(0xFFFFFFFF))`.  float32 cannot
    represent 2^32-1; the product rounds to 2^32 for d == 1.0, which GPU
    float->uint conversion saturates back to 0xFFFFFFFF.  We reproduce that
    saturation explicitly (float32->uint32 casts are undefined above 2^32-1 in
    XLA too).
    """
    near = jnp.float32(config.near_plane)
    far = jnp.float32(config.far_plane)
    d = (-z_view - near) / (far - near)
    d = jnp.clip(d, jnp.float32(0.0), jnp.float32(1.0))
    f = d * jnp.float32(np.float32(MAX_UINT32))  # rounds to 2^32 at d=1
    two32 = jnp.float32(4294967296.0)
    key = jnp.where(
        f >= two32,
        jnp.uint32(MAX_UINT32),
        jnp.minimum(f, jnp.float32(4294967040.0)).astype(jnp.uint32),
    )
    return key


def tile_extents(screen_pos, cov2d, config: RenderConfig):
    """getGaussianTileExtents (InitSortList.comp:47-68).

    radius = ceil(3 * sqrt(max eigenvalue of 2x2 covariance)); extents are
    [min_x, min_y, max_x, max_y) tile indices, min inclusive / max exclusive,
    clamped to the tile grid.  Uses truncating float->int conversion like GLSL.
    """
    cx, cy, cz = cov2d[:, 0], cov2d[:, 1], cov2d[:, 2]
    det = cx * cz - cy * cy
    m = (cx + cz) * jnp.float32(0.5)
    s = jnp.sqrt(jnp.maximum(m * m - det, jnp.float32(0.0)))
    lambda0 = m + s
    lambda1 = m - s
    radius = jnp.ceil(jnp.float32(3.0) * jnp.sqrt(jnp.maximum(lambda0, lambda1)))

    ts = jnp.float32(config.tile_size)
    gw = jnp.int32(config.grid_width)
    gh = jnp.int32(config.grid_height)
    sx, sy = screen_pos[:, 0], screen_pos[:, 1]
    # GLSL int() truncates toward zero.
    min_x = jnp.clip(((sx - radius) / ts).astype(jnp.int32), 0, gw)
    min_y = jnp.clip(((sy - radius) / ts).astype(jnp.int32), 0, gh)
    max_x = jnp.clip(((sx + radius) / ts).astype(jnp.int32) + 1, 0, gw)
    max_y = jnp.clip(((sy + radius) / ts).astype(jnp.int32) + 1, 0, gh)
    return jnp.stack([min_x, min_y, max_x, max_y], axis=-1)


def sh_basis16(eval_dir):
    """Degree-3 Sloan SH basis for [N,3] directions -> [N,16].

    Reference: getShEval4 (Common.glsl:94-138), including the (-x, -y, z)
    direction flip.
    """
    fx = -eval_dir[:, 0]
    fy = -eval_dir[:, 1]
    fz = eval_dir[:, 2]
    fz2 = fz * fz

    p = [None] * 16
    p[0] = jnp.full_like(fz, jnp.float32(0.2820947917738781))
    p[2] = jnp.float32(0.4886025119029199) * fz
    p[6] = jnp.float32(0.9461746957575601) * fz2 + jnp.float32(-0.31539156525252)
    p[12] = fz * (jnp.float32(1.865881662950577) * fz2 + jnp.float32(-1.119528997770346))
    fc0 = fx
    fs0 = fy

    tmp_a = jnp.float32(-0.48860251190292)
    p[3] = tmp_a * fc0
    p[1] = tmp_a * fs0
    tmp_b = jnp.float32(-1.092548430592079) * fz
    p[7] = tmp_b * fc0
    p[5] = tmp_b * fs0
    tmp_c = jnp.float32(-2.285228997322329) * fz2 + jnp.float32(0.4570457994644658)
    p[13] = tmp_c * fc0
    p[11] = tmp_c * fs0
    fc1 = fx * fc0 - fy * fs0
    fs1 = fx * fs0 + fy * fc0

    tmp_a = jnp.float32(0.5462742152960395)
    p[8] = tmp_a * fc1
    p[4] = tmp_a * fs1
    tmp_b = jnp.float32(1.445305721320277) * fz
    p[14] = tmp_b * fc1
    p[10] = tmp_b * fs1
    fc0b = fx * fc1 - fy * fs1
    fs0b = fx * fs1 + fy * fc1

    tmp_c = jnp.float32(-0.5900435899266435)
    p[15] = tmp_c * fc0b
    p[9] = tmp_c * fs0b
    return jnp.stack(p, axis=-1)


def sh_color(eval_dir, sh_coeffs, mode: SphericalHarmonicsMode):
    """getShColor (Common.glsl:141-170): evaluate SH -> rgb with +0.5 offset
    and non-negativity clamp.  `mode` is static (baked at trace time, the
    spec-constant equivalent of the push-constant SH mode)."""
    basis = sh_basis16(eval_dir)  # [N,16]
    if mode == SphericalHarmonicsMode.ALL_BANDS:
        result = jnp.einsum("nc,ncr->nr", basis, sh_coeffs)
    elif mode == SphericalHarmonicsMode.SKIP_FIRST_BAND:
        result = jnp.einsum("nc,ncr->nr", basis[:, 1:], sh_coeffs[:, 1:, :])
        result = result - jnp.float32(0.5)
    elif mode == SphericalHarmonicsMode.ONLY_FIRST_BAND:
        result = basis[:, 0:1] * sh_coeffs[:, 0, :]
    else:
        raise ValueError(f"unknown SH mode {mode}")
    result = result + jnp.float32(0.5)
    return jnp.maximum(result, jnp.float32(0.0))


def normalize_dirs(v):
    """GLSL normalize() for [N,3]: v / length(v) (length 0 -> NaN, matching
    GLSL undefined behaviour; callers cull such cases)."""
    return v / jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True))
