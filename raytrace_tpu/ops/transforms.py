"""Device-side instance transforms: per-batch TRS interpolation and soup
re-transformation.

This replaces the reference's per-batch TLAS refit (acceleration.rs:91-115):
instead of updating an acceleration structure, the whole object-space
triangle soup is re-transformed to world space on device — 2M triangles cost
~100 MFLOP, noise on a TPU — and the (static-topology) BVH stores AABBs that
conservatively bound the full shutter interval.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class InstanceMatrices(NamedTuple):
    object_to_world: jnp.ndarray  # [I, 3, 4]
    world_to_object: jnp.ndarray  # [I, 3, 4]


# Full f32 precision for the geometry contractions: the GPU may otherwise
# run an f32 einsum in TF32 (~1e-3 relative), which cracks meshes and
# moves hits past T_MIN.
_HP = jax.lax.Precision.HIGHEST

def quat_slerp(a, b, t):
    """Batched quaternion slerp with shortest-path flip + nlerp fallback.
    a, b: [..., 4] (x, y, z, w)."""
    dot = jnp.sum(a * b, axis=-1, keepdims=True)
    b = jnp.where(dot < 0.0, -b, b)
    dot = jnp.abs(dot)
    dot_c = jnp.clip(dot, -1.0, 1.0)

    # nlerp branch (nearly parallel)
    lin = a + t * (b - a)
    lin = lin / jnp.linalg.norm(lin, axis=-1, keepdims=True)

    theta = jnp.arccos(dot_c)
    s = jnp.sin(theta)
    safe_s = jnp.where(s < 1e-6, 1.0, s)
    sph = (jnp.sin((1.0 - t) * theta) / safe_s) * a + (jnp.sin(t * theta) / safe_s) * b

    return jnp.where(dot > 0.9995, lin, sph)


def quat_to_mat3(q):
    """[..., 4] → [..., 3, 3] rotation matrices."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1)
    row1 = jnp.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1)
    row2 = jnp.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1)
    return jnp.stack([row0, row1, row2], axis=-2)


def interpolate_instances(inst_t0, inst_t1, time) -> InstanceMatrices:
    """TRS-lerp every instance to `time` ∈ [0,1] and build 3x4 matrices.

    inst_t0/inst_t1: [I, 10] = translation(3) | quat(4) | scale(3).
    Static instances have t1 == t0, so the lerp is the identity for them and
    one fused code path serves both (no dynamic branching under jit).
    """
    tr = (1.0 - time) * inst_t0[:, 0:3] + time * inst_t1[:, 0:3]
    q = quat_slerp(inst_t0[:, 3:7], inst_t1[:, 3:7], time)
    sc = (1.0 - time) * inst_t0[:, 7:10] + time * inst_t1[:, 7:10]

    rot = quat_to_mat3(q)                       # [I,3,3]
    m = rot * sc[:, None, :]                    # R @ diag(s): scale columns
    o2w = jnp.concatenate([m, tr[:, :, None]], axis=-1)  # [I,3,4]

    # Inverse of T·R·S: S^-1 · R^T · T^-1 (analytic, no linear solve).
    inv_s = 1.0 / sc
    rt = jnp.swapaxes(rot, -1, -2)
    m_inv = rt * inv_s[:, :, None]              # diag(1/s) @ R^T: scale rows
    t_inv = -jnp.einsum("ijk,ik->ij", m_inv, tr, precision=_HP)
    w2o = jnp.concatenate([m_inv, t_inv[:, :, None]], axis=-1)
    return InstanceMatrices(object_to_world=o2w, world_to_object=w2o)


def transform_soup(tri_p, tri_n, tri_inst, mats: InstanceMatrices):
    """Object-space soup → world space for one batch time.

    tri_p/tri_n: [T, 3, 3]; tri_inst: [T].  Normals are transformed by the
    inverse-transpose ((M^-1)^T n ≡ n · worldToObject, ray_gen.glsl:171) and
    left unnormalized — shading normalizes after barycentric interpolation,
    which commutes with the linear transform.
    """
    o2w = mats.object_to_world[tri_inst]  # [T,3,4]
    w2o = mats.world_to_object[tri_inst]
    world_p = (jnp.einsum("tij,tvj->tvi", o2w[:, :, :3], tri_p, precision=_HP)
               + o2w[:, None, :, 3])
    world_n = jnp.einsum("tvj,tji->tvi", tri_n, w2o[:, :, :3], precision=_HP)
    return world_p, world_n
