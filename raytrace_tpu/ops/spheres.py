"""Closed-form sphere intersection — the flagship geometry path.

The reference tessellates every uv_sphere into up to thousands of triangles
because the Vulkan RT pipeline only traces triangles (mesh.rs:155-258,
acceleration.rs).  Without RT cores the roles invert: a few hundred
analytic spheres are cheaper as a dense [rays x spheres] sweep with a
running closest-hit reduction than as a BVH over their tessellations —
exactly the original "Ray Tracing in One Weekend" formulation the
reference approximates.

Instance transforms are handled by taking each ray into object space with
the instance's world-to-object matrix (supports translation, rotation —
which spins the UV parameterization — and non-uniform scale, which makes
ellipsoids); the ray parameter t is preserved by affinity, so world-space
closest-hit comparisons against triangles remain valid.

Hit attributes reproduce the tessellation's parameterization in the limit:
normals n = (p_obj - c)/r mapped through the inverse-transpose, and UVs
inverted from the tessellator's convention n = (-sin(phi)cos(theta),
-cos(phi), sin(phi)sin(theta)) with u = theta/2pi, v = phi/pi
(mesh.rs:155-179).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .intersect import T_MAX, T_MIN


class SphereHit(NamedTuple):
    t: jnp.ndarray       # [R]
    sph: jnp.ndarray     # [R] sphere id (-1 = miss)


def intersect_spheres(o, d, centers, radii, w2o, active=None, chunk=128,
                      t_min=T_MIN, t_max=T_MAX) -> SphereHit:
    """Dense closest-hit against all spheres.

    o, d: [R,3] world rays; centers [S,3], radii [S] object space;
    w2o: [S,3,4] world-to-object (per sphere instance, already gathered).
    S must be padded to a multiple of `chunk`; padding has radius 0.
    """
    R = o.shape[0]
    S = centers.shape[0]
    if S % chunk != 0:
        chunk = S
    n_chunks = S // chunk

    init = SphereHit(
        t=jnp.full((R,), t_max, jnp.float32),
        sph=jnp.full((R,), -1, jnp.int32),
    )

    def body(ci, best):
        s0 = ci * chunk
        m = jax.lax.dynamic_slice_in_dim(w2o, s0, chunk)        # [C,3,4]
        c = jax.lax.dynamic_slice_in_dim(centers, s0, chunk)    # [C,3]
        r = jax.lax.dynamic_slice_in_dim(radii, s0, chunk)      # [C]

        # Object-space ray per (ray, sphere): o' = M o + t_col, d' = M d.
        # [R,C,3] = [R,1,3] @ [1,C,3,3]^T contraction.
        rot = m[:, :, :3]                                       # [C,3,3]
        trn = m[:, :, 3]                                        # [C,3]
        hp = jax.lax.Precision.HIGHEST   # no TF32 on the GPU
        o_obj = jnp.einsum("cij,rj->rci", rot, o, precision=hp) + trn[None]
        d_obj = jnp.einsum("cij,rj->rci", rot, d, precision=hp)

        oc = o_obj - c[None]                                    # [R,C,3]
        a = jnp.sum(d_obj * d_obj, axis=-1)
        h = jnp.sum(d_obj * oc, axis=-1)
        c2 = jnp.sum(oc * oc, axis=-1) - r[None] * r[None]
        disc = h * h - a * c2
        ok = (disc >= 0.0) & (r[None] > 0.0) & (a > 0.0)
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        inv_a = 1.0 / jnp.where(a == 0.0, 1.0, a)
        t1 = (-h - sq) * inv_a
        t2 = (-h + sq) * inv_a
        t1_ok = ok & (t1 > t_min) & (t1 < t_max)
        t2_ok = ok & (t2 > t_min) & (t2 < t_max)
        t = jnp.where(t1_ok, t1, jnp.where(t2_ok, t2, t_max))   # [R,C]

        arg = jnp.argmin(t, axis=1)
        rows = jnp.arange(R)
        tc = t[rows, arg]
        better = tc < best.t
        return SphereHit(
            t=jnp.where(better, tc, best.t),
            sph=jnp.where(better, (s0 + arg).astype(jnp.int32), best.sph),
        )

    best = jax.lax.fori_loop(0, n_chunks, body, init)
    if active is not None:
        best = SphereHit(
            t=jnp.where(active, best.t, t_max),
            sph=jnp.where(active, best.sph, -1),
        )
    return best


def world_sphere_tables(cs, batch_times) -> "np.ndarray":
    """Host (f64) precomputation of per-batch world-space sphere tables.

    Any rigid + uniform-scale instance transform maps a sphere to a sphere:
    c_world = M c + t, r_world = s * r.  Precomputing per batch time in f64
    keeps the quadratic's constant k = |c_world|^2 - r_world^2 exact even
    for the 1000-radius ground sphere (f32 would lose the 1e6 - 1e6
    cancellation).  Returns [B, S, 5] = (c_world xyz, r_world, k) as f32,
    or None if any sphere instance has non-uniform scale (ellipsoid -> the
    general object-space path must be used).
    """
    from ..models.bvh_build import _instance_matrix_at

    S = cs.sph_center.shape[0]
    out = np.zeros((len(batch_times), S, 5), np.float64)
    n = cs.num_spheres
    for bi, t in enumerate(batch_times):
        mats = _instance_matrix_at(cs.inst_t0, cs.inst_t1, float(t))  # [I,3,4]
        m = mats[cs.sph_inst[:n]]
        rot = m[:, :, :3]
        scale = np.linalg.norm(rot, axis=1)  # column norms [n,3]
        if n and not np.allclose(scale, scale[:, :1], rtol=1e-5, atol=1e-7):
            return None
        c_world = np.einsum("sij,sj->si", rot, cs.sph_center[:n]) + m[:, :, 3]
        r_world = scale[:, 0] * cs.sph_radius[:n] if n else np.zeros(0)
        out[bi, :n, 0:3] = c_world
        out[bi, :n, 3] = r_world
        out[bi, :n, 4] = (c_world ** 2).sum(-1) - r_world ** 2
        # Padding spheres: r = 0, k huge -> disc < 0, never hit.
        out[bi, n:, 4] = 3.0e37
    return out.astype(np.float32)


def intersect_spheres_world(o, d, table, active=None, chunk=128,
                            t_min=T_MIN, t_max=T_MAX) -> SphereHit:
    """Closest hit against world-space spheres via the stable h-form.

    table: [S, 5] = (cx, cy, cz, r, k) with k = |c|^2 - r^2 precomputed in
    f64.  The rays x spheres sweep is two full-precision [C,3] x [3,R]
    products plus [C, R] elementwise work per chunk of C spheres.
    """
    R = o.shape[0]
    S = table.shape[0]
    if S % chunk != 0:
        chunk = S
    n_chunks = S // chunk

    d_dot_o = jnp.sum(d * o, axis=-1)       # [R]
    a = jnp.sum(d * d, axis=-1)             # [R]
    o_sq = jnp.sum(o * o, axis=-1)          # [R]
    inv_a = 1.0 / jnp.where(a == 0.0, 1.0, a)

    init = SphereHit(
        t=jnp.full((R,), t_max, jnp.float32),
        sph=jnp.full((R,), -1, jnp.int32),
    )

    hp = jax.lax.Precision.HIGHEST

    def body(ci, best):
        s0 = ci * chunk
        tb = jax.lax.dynamic_slice_in_dim(table, s0, chunk)   # [C,5]
        c = tb[:, 0:3]
        r = tb[:, 3]
        k = tb[:, 4]
        dc = jnp.dot(c, d.T, precision=hp)                    # [C,R]
        oc = jnp.dot(c, o.T, precision=hp)                    # [C,R]
        h = d_dot_o[None, :] - dc
        c2 = o_sq[None, :] - 2.0 * oc + k[:, None]
        disc = h * h - a[None, :] * c2
        ok = (disc >= 0.0) & (r[:, None] > 0.0)
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        t1 = (-h - sq) * inv_a[None, :]
        t2 = (-h + sq) * inv_a[None, :]
        t1_ok = ok & (t1 > t_min) & (t1 < t_max)
        t2_ok = ok & (t2 > t_min) & (t2 < t_max)
        t = jnp.where(t1_ok, t1, jnp.where(t2_ok, t2, t_max))  # [C,R]
        arg = jnp.argmin(t, axis=0)                            # [R]
        tc = jnp.min(t, axis=0)
        better = tc < best.t
        return SphereHit(
            t=jnp.where(better, tc, best.t),
            sph=jnp.where(better, (s0 + arg).astype(jnp.int32), best.sph),
        )

    best = jax.lax.fori_loop(0, n_chunks, body, init)
    if active is not None:
        best = SphereHit(
            t=jnp.where(active, best.t, t_max),
            sph=jnp.where(active, best.sph, -1),
        )
    return best


TWO_PI = np.float32(2.0 * np.pi)
PI = np.float32(np.pi)


def sphere_hit_attributes(o, d, t, sph_id, centers, radii, w2o_all, inst_all):
    """Shading attributes for sphere hits.

    sph_id: [R] (clamped caller-side); returns (p_world [R,3],
    n_world_unit [R,3], u [R], v [R]).  w2o_all: [S,3,4]; inst_all: [S].
    """
    sid = jnp.maximum(sph_id, 0)
    m = w2o_all[sid]                     # [R,3,4] (small-table gather)
    c = centers[sid]
    r = radii[sid]

    hp = jax.lax.Precision.HIGHEST   # no TF32 on the GPU
    p_world = o + t[:, None] * d
    p_obj = jnp.einsum("rij,rj->ri", m[:, :, :3], p_world,
                       precision=hp) + m[:, :, 3]
    n_obj = (p_obj - c) / jnp.where(r == 0.0, 1.0, r)[:, None]

    # Normal transform: n_world = n_obj · W2O_rot (inverse-transpose).
    n_world = jnp.einsum("rj,rji->ri", n_obj, m[:, :, :3], precision=hp)
    from . import vec
    n_world = vec.normalize(n_world)

    # UV per the tessellator's parameterization (mesh.rs:164-178):
    #   n = (-sin(phi)cos(theta), -cos(phi), sin(phi)sin(theta))
    nn = vec.normalize(n_obj)
    v = jnp.arccos(jnp.clip(-nn[:, 1], -1.0, 1.0)) / PI
    theta = jnp.arctan2(nn[:, 2], -nn[:, 0])          # in (-pi, pi]
    u = (theta / TWO_PI) % 1.0
    return p_world, n_world, u, v
