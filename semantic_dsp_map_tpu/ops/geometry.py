"""Small geometry helpers: quaternions, camera matrices, Gaussian pdf."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import (
    GAUSSIAN_PDF_COEF,
    GAUSSIAN_PDF_FLOOR,
    GAUSSIAN_PDF_Z_CLIP,
    MapConfig,
)

#: Camera transforms decide which voxel and pixel a point lands in, so their
#: 3x3 products run in full float32.  At JAX's default precision an H100
#: runs them in TF32: lifting a VKITTI2 frame to the world and projecting it
#: back then moved 16% of the points to another pixel and 4.5% to another
#: voxel, against none and 7 of 465,750 with the pin (chip_smoke.py
#: precision phase).
HIGHEST = jax.lax.Precision.HIGHEST


def mm(a, b):
    """``a @ b`` in full float32 (see :data:`HIGHEST`)."""
    return jnp.matmul(a, b, precision=HIGHEST)


def quat_to_rot(q):
    """Quaternion (w, x, y, z) -> 3x3 rotation matrix."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return jnp.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        dtype=jnp.float32,
    )


def camera_matrices(cam_pos, cam_quat):
    """Camera pose -> (R_wc, t_wc, R_cw, t_cw).

    R_wc/t_wc map camera-frame points to world; R_cw/t_cw is the extrinsic
    (world -> camera), i.e. the inverse pose used by the reference
    (semantic_dsp_map.h:744-747).
    """
    r_wc = quat_to_rot(cam_quat)
    t_wc = cam_pos.astype(jnp.float32)
    r_cw = r_wc.T
    t_cw = -mm(r_cw, t_wc)
    return r_wc, t_wc, r_cw, t_cw


def project_to_image(cfg: MapConfig, r_cw, t_cw, pos):
    """Pinhole projection of world points [..., 3] -> (row, col, cam_z, ok).

    Mirrors calculateParticleBasicStateInImage (operations.h:1267-1290):
    C-style truncation of pixel coordinates, depth-range gating, image-bounds
    gating.  ``ok`` is True when the point is in the depth range AND inside
    the image.
    """
    cam = mm(pos, r_cw.T) + t_cw
    z = cam[..., 2]
    in_depth = (z >= cfg.depth_range_min) & (z <= cfg.depth_range_max)

    zsafe = jnp.where(z == 0, 1e-6, z)
    u = cfg.fx * cam[..., 0] / zsafe + cfg.cx
    v = cfg.fy * cam[..., 1] / zsafe + cfg.cy
    col = u.astype(jnp.int32)  # trunc toward zero, as static_cast<int>
    row = v.astype(jnp.int32)
    in_image = (row >= 0) & (row < cfg.height) & (col >= 0) & (col < cfg.width)
    return row, col, z, in_depth & in_image


def project_to_image_xyz(cfg: MapConfig, r_cw, t_cw, x, y, z):
    """project_to_image for component-separated coordinates (arrays of any
    matching shape).  Keeps the xyz axis out of the array layout entirely —
    see state.Particles.pos for why."""
    cx = r_cw[0, 0] * x + r_cw[0, 1] * y + r_cw[0, 2] * z + t_cw[0]
    cy = r_cw[1, 0] * x + r_cw[1, 1] * y + r_cw[1, 2] * z + t_cw[1]
    cz = r_cw[2, 0] * x + r_cw[2, 1] * y + r_cw[2, 2] * z + t_cw[2]
    in_depth = (cz >= cfg.depth_range_min) & (cz <= cfg.depth_range_max)

    zsafe = jnp.where(cz == 0, 1e-6, cz)
    u = cfg.fx * cx / zsafe + cfg.cx
    v = cfg.fy * cy / zsafe + cfg.cy
    col = u.astype(jnp.int32)
    row = v.astype(jnp.int32)
    in_image = (row >= 0) & (row < cfg.height) & (col >= 0) & (col < cfg.width)
    return row, col, cz, in_depth & in_image


def point_in_frustum(cfg: MapConfig, r_cw, t_cw, pos):
    """isPointInFrustum (operations.h:1240-1258): depth range + symmetric
    half-FOV tangent test."""
    cam = mm(pos, r_cw.T) + t_cw
    x, y, z = cam[..., 0], cam[..., 1], cam[..., 2]
    ok = (z >= cfg.depth_range_min) & (z <= cfg.depth_range_max)
    ok &= jnp.abs(x) <= z * cfg.tan_half_fov_x
    ok &= jnp.abs(y) <= z * cfg.tan_half_fov_y
    return ok


def gaussian_pdf1(x, mu, sigma):
    """The reference's LUT'd per-axis "pdf": (1/sqrt(pi)) * exp(-z^2/2) with
    |z| > 9.9 clamped to 1e-9 (basic_algorithms.h:417-422, 456-459).

    The 1/sqrt(pi) constant (instead of 1/sqrt(2*pi)) is a reference quirk we
    preserve because it is calibrated against noise_number / P_d.
    """
    sigma = jnp.maximum(sigma, 1e-6)
    z = (x - mu) / sigma
    val = GAUSSIAN_PDF_COEF * jnp.exp(-0.5 * z * z)
    return jnp.where(jnp.abs(z) > GAUSSIAN_PDF_Z_CLIP, GAUSSIAN_PDF_FLOOR, val)


def gaussian_pdf3(p, mu, sigma):
    """Product of the three per-axis pdfs (semantic_dsp_map.h:1016-1018)."""
    return (
        gaussian_pdf1(p[..., 0], mu[..., 0], sigma)
        * gaussian_pdf1(p[..., 1], mu[..., 1], sigma)
        * gaussian_pdf1(p[..., 2], mu[..., 2], sigma)
    )


def forgetting_factor(forget_count, forgetting_rate: float, max_forget_count: int):
    """getForgettingFactor (basic_algorithms.h:32-48): 2.5^(-n/rate) for
    n < max_forget_count else 0.  The reference builds a 5-entry table; counts
    are clamped to [0, 5] by the updater so a closed form is exact."""
    n = forget_count.astype(jnp.float32)
    val = jnp.power(2.5, -n / forgetting_rate)
    return jnp.where(forget_count < max_forget_count, val, 0.0)
