"""Camera matrices and primary-ray generation.

Host side builds the same matrices as the reference (glam `perspective_rh` +
`look_at_rh`, camera.rs:58-60); the device side reproduces the raygen math of
ray_gen.glsl:543-571 including the nonstandard thin-lens offset (the lens
sample is scaled by the NDC coordinate — quirk #3 in SURVEY.md §8).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import rng


class CameraArrays(NamedTuple):
    """Device-ready camera state for one (camera, resolution) pair."""

    view_inverse: jnp.ndarray  # [4,4] row-major (v_world = M @ v_cam)
    proj_inverse: jnp.ndarray  # [4,4]
    focal_length: jnp.ndarray  # scalar
    aperture_size: jnp.ndarray  # scalar


def perspective_rh(fov_y_rad: float, aspect: float, z_near: float, z_far: float) -> np.ndarray:
    """glam Mat4::perspective_rh (Vulkan 0..1 depth), as a row-major numpy
    matrix (columns of the glam matrix become columns here too: y = M @ x)."""
    sin_fov = math.sin(0.5 * fov_y_rad)
    cos_fov = math.cos(0.5 * fov_y_rad)
    h = cos_fov / sin_fov
    w = h / aspect
    r = z_far / (z_near - z_far)
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = r
    m[2, 3] = r * z_near
    m[3, 2] = -1.0
    return m


def look_at_rh(eye, center, up) -> np.ndarray:
    """glam Mat4::look_at_rh as a row-major numpy matrix."""
    eye = np.asarray(eye, np.float64)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float64)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def build_camera_arrays(params, width: int, height: int) -> CameraArrays:
    """params: models.compile.CameraParams."""
    aspect = width / height
    proj = perspective_rh(math.radians(params.fov_y_deg), aspect, params.z_near, params.z_far)
    view = look_at_rh(params.eye, np.asarray(params.look_at, np.float64), np.asarray(params.up, np.float64))
    return CameraArrays(
        view_inverse=jnp.asarray(np.linalg.inv(view), jnp.float32),
        proj_inverse=jnp.asarray(np.linalg.inv(proj), jnp.float32),
        focal_length=jnp.float32(params.focal_length),
        aperture_size=jnp.float32(params.aperture_size),
    )


def get_rays(state, cam: CameraArrays, px, py, si, sj, width, height, sqrt_spp,
             use_dof: bool = False):
    """Generate primary rays for a wavefront (ray_gen.glsl:543-571).

    px, py: integer pixel coordinates [R]; si, sj: stratification cell [R].
    Returns (state, origin [R,3], direction [R,3]).  Directions are NOT
    normalized when the aperture is zero (the reference normalizes the
    camera-space target, then rotates; same here).
    """
    recip_sqrt_spp = jnp.float32(1.0 / sqrt_spp)
    state, offset = rng.sample_square_stratified(
        state, si.astype(jnp.float32), sj.astype(jnp.float32), recip_sqrt_spp
    )
    pixel_center = jnp.stack(
        [px.astype(jnp.float32) + 0.5, py.astype(jnp.float32) + 0.5], axis=-1
    )
    opc = pixel_center + offset
    res = jnp.asarray([width, height], jnp.float32)
    d = (opc / res) * 2.0 - 1.0  # NDC in [-1,1], y-down like Vulkan

    vi = cam.view_inverse
    pi = cam.proj_inverse

    origin = jnp.broadcast_to(vi[:3, 3], d.shape[:-1] + (3,))

    # target = projInverse * (dx, dy, 1, 1); only xyz used after normalize.
    target = (
        pi[:3, 0] * d[..., 0:1] + pi[:3, 1] * d[..., 1:2] + pi[:3, 2] + pi[:3, 3]
    )
    from .vec import normalize as _nrm
    tnorm = _nrm(target)
    # HIGHEST: an f32 product may otherwise run in TF32 on the GPU.
    hp = jax.lax.Precision.HIGHEST
    direction = jnp.matmul(tnorm, vi[:3, :3].T, precision=hp)  # w=0 rotate

    def with_dof(state):
        focal_point = cam.focal_length * tnorm  # camera space
        state, lens = rng.sample_uniform_disk_concentric(state)
        lens = lens * (cam.aperture_size / 2.0)
        # QUIRK (ray_gen.glsl:554-558): the lens offset displaces the WORLD
        # x/y of the origin, scaled by the NDC coordinate d.
        o = origin + jnp.stack(
            [lens[..., 0] * d[..., 0], lens[..., 1] * d[..., 1],
             jnp.zeros_like(d[..., 0])],
            axis=-1,
        )
        fp_world = jnp.matmul(focal_point, vi[:3, :3].T, precision=hp) + vi[:3, 3]
        dirn = fp_world - o
        dirn = _nrm(dirn)
        return state, o, dirn

    # `use_dof` is static (aperture > 0 is a host-known scene fact), so the
    # zero-aperture path compiles without any lens sampling at all.
    if use_dof:
        state, origin, direction = with_dof(state)

    return state, origin, direction


def get_rays_v3(state, cam: CameraArrays, px, py, si, sj, width, height,
                sqrt_spp, use_dof: bool = False):
    """Component-wise raygen (same math as get_rays, zero [R,2]/[R,3]
    intermediates — see ops/vec3.py for why)."""
    from .vec3 import V3, normalize as v3_normalize

    recip_sqrt_spp = jnp.float32(1.0 / sqrt_spp)
    state, rx = rng.random_float(state)
    state, ry = rng.random_float(state)
    ox_pix = (si.astype(jnp.float32) + rx) * recip_sqrt_spp - 0.5
    oy_pix = (sj.astype(jnp.float32) + ry) * recip_sqrt_spp - 0.5

    dx = ((px.astype(jnp.float32) + 0.5 + ox_pix) / width) * 2.0 - 1.0
    dy = ((py.astype(jnp.float32) + 0.5 + oy_pix) / height) * 2.0 - 1.0

    vi = cam.view_inverse
    pi = cam.proj_inverse

    target = V3(
        pi[0, 0] * dx + pi[0, 1] * dy + pi[0, 2] + pi[0, 3],
        pi[1, 0] * dx + pi[1, 1] * dy + pi[1, 2] + pi[1, 3],
        pi[2, 0] * dx + pi[2, 1] * dy + pi[2, 2] + pi[2, 3],
    )
    tn = v3_normalize(target)
    direction = V3(
        vi[0, 0] * tn.x + vi[0, 1] * tn.y + vi[0, 2] * tn.z,
        vi[1, 0] * tn.x + vi[1, 1] * tn.y + vi[1, 2] * tn.z,
        vi[2, 0] * tn.x + vi[2, 1] * tn.y + vi[2, 2] * tn.z,
    )
    ones = jnp.ones_like(dx)
    origin = V3(vi[0, 3] * ones, vi[1, 3] * ones, vi[2, 3] * ones)

    if use_dof:
        state, lx, ly = rng.sample_disk_concentric_xy(state)
        half_ap = cam.aperture_size / 2.0
        # QUIRK (ray_gen.glsl:554-558): world x/y offset scaled by NDC d.
        origin = V3(
            origin.x + lx * half_ap * dx,
            origin.y + ly * half_ap * dy,
            origin.z,
        )
        fp = V3(cam.focal_length * tn.x, cam.focal_length * tn.y,
                cam.focal_length * tn.z)
        fpw = V3(
            vi[0, 0] * fp.x + vi[0, 1] * fp.y + vi[0, 2] * fp.z + vi[0, 3],
            vi[1, 0] * fp.x + vi[1, 1] * fp.y + vi[1, 2] * fp.z + vi[1, 3],
            vi[2, 0] * fp.x + vi[2, 1] * fp.y + vi[2, 2] * fp.z + vi[2, 3],
        )
        direction = v3_normalize(fpw - origin)

    return state, origin, direction
