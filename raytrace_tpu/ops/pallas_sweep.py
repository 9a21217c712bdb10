"""Fused ray x sphere closest-hit sweep, written for Pallas-Triton.

The XLA sweep (ops/spheres.intersect_spheres_world) writes [chunk, R]
intermediates through device memory for every 128-sphere chunk.  This
kernel keeps the whole sweep in registers: one program owns BLOCK rays
(one per thread across NUM_WARPS warps), walks the sphere table in
chunks of CHUNK rows with the quadratic, both roots, the range tests and
a running arg-min fused, and writes only (t, id).  Device-memory traffic
drops to the rays in (24 B/ray) and the result out (8 B/ray); the sphere
table (32 B/row) stays resident in L2 across programs.

Layout:
- rays arrive as six 1-D [R] components (the wavefront's V3 layout), R
  padded to a multiple of BLOCK;
- the sphere table is [S, 8] f32 rows (cx cy cz r k pad3) with S a power
  of two (Triton block shapes are powers of two); padding rows have r=0
  and k=3e37 and never hit;
- the running best is a [CHUNK, BLOCK] tile folded to one winner per ray
  after the loop: lowest id among equal t, as in the XLA sweep.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .intersect import T_MAX, T_MIN

BLOCK = 128      # rays per program
CHUNK = 8        # table rows tested per loop step
NUM_WARPS = 4    # one ray per thread


def table_rows(n: int) -> int:
    """Padded table row count: a power of two, at least CHUNK."""
    return max(CHUNK, 1 << max(0, int(n) - 1).bit_length())


def _sphere_kernel(tab_ref, ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
                   t_ref, id_ref, *, n_chunks: int, t_min: float,
                   t_max: float):
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
    d_dot_o = (dx * ox + dy * oy + dz * oz)[None, :]
    a = (dx * dx + dy * dy + dz * dz)[None, :]
    o_sq = (ox * ox + oy * oy + oz * oz)[None, :]
    inv_a = 1.0 / jnp.where(a == 0.0, 1.0, a)
    ox, oy, oz = ox[None, :], oy[None, :], oz[None, :]
    dx, dy, dz = dx[None, :], dy[None, :], dz[None, :]

    def chunk(ci, carry):
        best_t, best_id = carry
        rows = pl.ds(ci * CHUNK, CHUNK)
        cx = tab_ref[rows, 0][:, None]                  # [CHUNK, 1]
        cy = tab_ref[rows, 1][:, None]
        cz = tab_ref[rows, 2][:, None]
        r = tab_ref[rows, 3][:, None]
        k = tab_ref[rows, 4][:, None]
        h = d_dot_o - (cx * dx + cy * dy + cz * dz)     # [CHUNK, BLOCK]
        c2 = o_sq - 2.0 * (cx * ox + cy * oy + cz * oz) + k
        disc = h * h - a * c2
        ok = (disc >= 0.0) & (r > 0.0)
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        t1 = (-h - sq) * inv_a
        t2 = (-h + sq) * inv_a
        t1_ok = ok & (t1 > t_min) & (t1 < t_max)
        t2_ok = ok & (t2 > t_min) & (t2 < t_max)
        t = jnp.where(t1_ok, t1, jnp.where(t2_ok, t2, t_max))
        ids = ci * CHUNK + jax.lax.broadcasted_iota(
            jnp.int32, (CHUNK, BLOCK), 0)
        better = t < best_t
        return jnp.where(better, t, best_t), jnp.where(better, ids, best_id)

    init = (jnp.full((CHUNK, BLOCK), t_max, jnp.float32),
            jnp.full((CHUNK, BLOCK), -1, jnp.int32))
    best_t, best_id = jax.lax.fori_loop(0, n_chunks, chunk, init)

    t_win = jnp.min(best_t, axis=0)                     # [BLOCK]
    id_win = jnp.min(jnp.where(best_t <= t_win[None, :], best_id,
                               jnp.int32(2147483647)), axis=0)
    t_ref[...] = t_win
    id_ref[...] = jnp.where(t_win >= t_max, -1, id_win)


@functools.partial(jax.jit, static_argnames=("interpret",))
def sphere_sweep(table, ox, oy, oz, dx, dy, dz, interpret=False):
    """table: [S, 8] (S = table_rows(S)); ray components [R] with R a
    multiple of BLOCK.  Returns (t [R], id [R])."""
    S = table.shape[0]
    R = ox.shape[0]
    kernel = functools.partial(
        _sphere_kernel, n_chunks=S // CHUNK, t_min=float(T_MIN),
        t_max=float(T_MAX))
    ray = pl.BlockSpec((BLOCK,), lambda i: (i,))
    return pl.pallas_call(
        kernel,
        grid=(R // BLOCK,),
        in_specs=[pl.BlockSpec((S, 8), lambda i: (0, 0))] + [ray] * 6,
        out_specs=[ray, ray],
        out_shape=[jax.ShapeDtypeStruct((R,), jnp.float32),
                   jax.ShapeDtypeStruct((R,), jnp.int32)],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="sphere_sweep",
    )(table, ox, oy, oz, dx, dy, dz)


def pad_table8(table5):
    """[S,5] world sphere table (cx cy cz r k) -> [table_rows(S), 8]."""
    S = table5.shape[0]
    out = jnp.zeros((table_rows(S), 8), jnp.float32)
    out = out.at[:S, :5].set(table5)
    return out.at[S:, 4].set(3.0e37)  # padding k: never hits


def pad_rays(o, d, block: int = BLOCK):
    """V3 rays -> six [R_pad] components, R_pad a positive multiple of
    `block`.  Padding rays (o = 0, d = (1,1,1)) are cut off by the
    caller."""
    R = o.x.shape[0]
    pad = -R % block
    if pad == 0 and R > 0:
        return tuple(o) + tuple(d)
    pad = pad or block
    zo = lambda c: jnp.pad(c, (0, pad))
    zd = lambda c: jnp.pad(c, (0, pad), constant_values=1.0)
    return tuple(zo(c) for c in o) + tuple(zd(c) for c in d)


def intersect_spheres_pallas_v3(o, d, table8, active=None, interpret=False):
    """Closest hit of V3 rays against the padded sphere table, with
    intersect_spheres_world's contract (SphereHit, -1 = miss)."""
    from .spheres import SphereHit

    R = o.x.shape[0]
    t, ids = sphere_sweep(table8, *pad_rays(o, d), interpret=interpret)
    t, ids = t[:R], ids[:R]
    if active is not None:
        t = jnp.where(active, t, T_MAX)
        ids = jnp.where(active, ids, -1)
    return SphereHit(t=t, sph=ids)


def intersect_spheres_pallas(o, d, table8, active=None, interpret=False):
    """[R,3] row-layout entry (tests and tools)."""
    from .vec3 import from_rows

    return intersect_spheres_pallas_v3(from_rows(o), from_rows(d), table8,
                                       active=active, interpret=interpret)
