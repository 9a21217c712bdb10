"""Fused ray x triangle closest-hit sweep (Möller–Trumbore), written for
Pallas-Triton.

Same skeleton as the sphere sweep (ops/pallas_sweep.py): one program owns
BLOCK rays, walks the triangle table in CHUNK-row steps with the whole
test and a running arg-min in registers, and writes (t, id, u, v) — the
[T, R] intermediates of intersect.intersect_brute_force never reach
device memory.  It serves small-to-medium triangle sets (cornell boxes,
quads, up to the 8,192-triangle BVH threshold); larger meshes trace
through the SAH BVH (ops/bvh.py).

Triangle table layout [T, 16]: v0.xyz, e1.xyz, e2.xyz, valid, pad6, with
T a power of two; invalid rows never hit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .intersect import Hit, T_MAX, T_MIN
from .pallas_sweep import BLOCK, CHUNK, NUM_WARPS, pad_rays, table_rows


def _tri_kernel(tab_ref, ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
                t_ref, id_ref, u_ref, v_ref, *, n_chunks: int, t_min: float,
                t_max: float):
    ox, oy, oz = ox_ref[...][None, :], oy_ref[...][None, :], oz_ref[...][None, :]
    dx, dy, dz = dx_ref[...][None, :], dy_ref[...][None, :], dz_ref[...][None, :]

    def chunk(ci, carry):
        bt, bid, bu, bv = carry
        rows = pl.ds(ci * CHUNK, CHUNK)
        col = lambda j: tab_ref[rows, j][:, None]       # [CHUNK, 1]
        v0x, v0y, v0z = col(0), col(1), col(2)
        e1x, e1y, e1z = col(3), col(4), col(5)
        e2x, e2y, e2z = col(6), col(7), col(8)
        valid_row = col(9) > 0.0

        # pvec = d x e2  ([CHUNK, BLOCK] per (triangle, ray))
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv_det = jnp.where(det != 0.0,
                            1.0 / jnp.where(det == 0.0, 1.0, det), 0.0)
        tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
        u = (tx * px + ty * py + tz * pz) * inv_det
        # qvec = tvec x e1
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv_det
        t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        ok = (valid_row & (det != 0.0) & (u >= 0.0) & (v >= 0.0)
              & (u + v <= 1.0) & (t > t_min) & (t < t_max))
        t = jnp.where(ok, t, t_max)

        ids = ci * CHUNK + jax.lax.broadcasted_iota(
            jnp.int32, (CHUNK, BLOCK), 0)
        better = t < bt
        return (jnp.where(better, t, bt), jnp.where(better, ids, bid),
                jnp.where(better, u, bu), jnp.where(better, v, bv))

    init = (jnp.full((CHUNK, BLOCK), t_max, jnp.float32),
            jnp.full((CHUNK, BLOCK), -1, jnp.int32),
            jnp.zeros((CHUNK, BLOCK), jnp.float32),
            jnp.zeros((CHUNK, BLOCK), jnp.float32))
    bt, bid, bu, bv = jax.lax.fori_loop(0, n_chunks, chunk, init)

    t_win = jnp.min(bt, axis=0)
    id_win = jnp.min(jnp.where(bt <= t_win[None, :], bid,
                               jnp.int32(2147483647)), axis=0)
    pick = bid == id_win[None, :]
    u_win = jnp.max(jnp.where(pick, bu, -1.0), axis=0)
    v_win = jnp.max(jnp.where(pick, bv, -1.0), axis=0)
    missed = t_win >= t_max
    t_ref[...] = t_win
    id_ref[...] = jnp.where(missed, -1, id_win)
    u_ref[...] = jnp.where(missed, 0.0, u_win)
    v_ref[...] = jnp.where(missed, 0.0, v_win)


@functools.partial(jax.jit, static_argnames=("interpret",))
def tri_sweep(table, ox, oy, oz, dx, dy, dz, interpret=False):
    """table: [T, 16] (T = table_rows(T)); ray components [R] with R a
    multiple of BLOCK.  Returns (t, id, u, v), each [R]."""
    T = table.shape[0]
    R = ox.shape[0]
    kernel = functools.partial(
        _tri_kernel, n_chunks=T // CHUNK, t_min=float(T_MIN),
        t_max=float(T_MAX))
    ray = pl.BlockSpec((BLOCK,), lambda i: (i,))
    f32 = jax.ShapeDtypeStruct((R,), jnp.float32)
    return pl.pallas_call(
        kernel,
        grid=(R // BLOCK,),
        in_specs=[pl.BlockSpec((T, 16), lambda i: (0, 0))] + [ray] * 6,
        out_specs=[ray] * 4,
        out_shape=[f32, jax.ShapeDtypeStruct((R,), jnp.int32), f32, f32],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="tri_sweep",
    )(table, ox, oy, oz, dx, dy, dz)


def pack_tri_table(world_p, num_real):
    """[T,3,3] world triangles -> [table_rows(T), 16] kernel table; rows
    at or past `num_real` (a static or traced count) are invalid."""
    T = world_p.shape[0]
    v0 = world_p[:, 0, :]
    e1 = world_p[:, 1, :] - v0
    e2 = world_p[:, 2, :] - v0
    valid = (jnp.arange(T) < num_real).astype(jnp.float32)
    tbl = jnp.zeros((table_rows(T), 16), jnp.float32)
    tbl = tbl.at[:T, 0:3].set(v0)
    tbl = tbl.at[:T, 3:6].set(e1)
    tbl = tbl.at[:T, 6:9].set(e2)
    return tbl.at[:T, 9].set(valid)


def intersect_tris_pallas_v3(o, d, table16, active=None,
                             interpret=False) -> Hit:
    """Closest hit of V3 rays against the packed triangle table, with
    intersect_brute_force's contract (Hit, -1 = miss)."""
    R = o.x.shape[0]
    t, ids, u, v = tri_sweep(table16, *pad_rays(o, d), interpret=interpret)
    t, ids, u, v = t[:R], ids[:R], u[:R], v[:R]
    if active is not None:
        t = jnp.where(active, t, T_MAX)
        ids = jnp.where(active, ids, -1)
    return Hit(t=t, tri=ids, u=u, v=v)


def intersect_tris_pallas(o, d, table16, active=None, interpret=False) -> Hit:
    """[R,3] row-layout entry (tests and tools)."""
    from .vec3 import from_rows

    return intersect_tris_pallas_v3(from_rows(o), from_rows(d), table16,
                                    active=active, interpret=interpret)
