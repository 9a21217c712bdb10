"""The wavefront path-tracing loop.

One sample batch = one geometry-prepare dispatch plus one jit'd dispatch per
row tile:

  1. `prepare_batch` interpolates instance transforms to the batch ray time
     and re-transforms geometry (replaces the reference's TLAS refit,
     acceleration.rs:91-115),
  2. each tile generates its pixel x sample wavefront and bounces it to
     termination inside `lax.while_loop` with per-ray alive masks and
     multi-phase tail compaction (the iterative rayColour loop of
     ray_gen.glsl:457-541 across a whole wavefront, no host round-trips per
     bounce),
  3. samples average and the batch folds into the running-mean accumulation
     image ((batch*prev + new)/(batch+1), ray_gen.glsl:597-603).

LAYOUT RULE: every per-ray vector on the hot path is a V3 — three 1-D [R]
component arrays (ops/vec3.py).  Each component is contiguous, so fused
elementwise kernels read it with unit stride and the Pallas sweeps take the
components as they are.  [R,3]/[R,k] shapes are allowed only at
compile-time boundaries and in the fallback paths.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..ops import camera as cam_ops
from ..ops import intersect, materials, nee, rng, spheres, transforms
from ..ops import vec3
from ..ops.intersect import T_MAX, T_MIN
from ..ops.materials import LIGHT_PDF
from ..ops.vec3 import V3
from .arrays import SceneArrays, SceneStatic


class RawHit(NamedTuple):
    """Minimal closest-hit output of the trace sweep; attributes are
    reconstructed in the bounce body from ONE combined row fetch."""

    missed: jnp.ndarray     # [R] bool
    t: jnp.ndarray          # [R]
    prim: jnp.ndarray       # [R] unified primitive id (sphere i | S_pad + tri j)
    is_sphere: jnp.ndarray  # [R] bool
    bu: jnp.ndarray         # [R] triangle barycentric u (0 for spheres)
    bv: jnp.ndarray         # [R]


class HitRecord(NamedTuple):
    """Unified closest-hit result (ray_gen.glsl HitRecord + material/
    instance ids resolved, common.glsl:98-102).  p/n are V3."""

    missed: jnp.ndarray
    t: jnp.ndarray
    p: V3
    n: V3
    u: jnp.ndarray
    v: jnp.ndarray
    mat_type: jnp.ndarray
    mat_index: jnp.ndarray
    inst: jnp.ndarray
    prim: jnp.ndarray


class BounceState(NamedTuple):
    depth: jnp.ndarray
    state: jnp.ndarray
    ray_o: V3
    ray_d: V3
    throughput: V3
    accumulated: V3
    alive: jnp.ndarray
    rays_traced: jnp.ndarray


def _compact_size(R: int) -> int:
    """Next compaction size after R (0 = stop compacting)."""
    if R < 16384:
        return 0
    return max(2048, (R // 8 + 1023) // 1024 * 1024)


def _compact_schedule(R: int):
    """Descending wavefront sizes for the multi-phase bounce loop."""
    sizes = []
    cur = R
    while True:
        nxt = _compact_size(cur)
        if nxt == 0 or nxt >= cur:
            break
        sizes.append(nxt)
        cur = nxt
    return sizes


def _background_v3(static: SceneStatic, scene: SceneArrays) -> V3:
    """Sky colour as scalar V3 (quirk: direction-independent,
    ray_gen.glsl:442-455)."""
    from ..models.compile import SKY_SOLID, SKY_VERTICAL_GRADIENT

    if static.sky_type == SKY_SOLID:
        col = scene.sky_solid
    elif static.sky_type == SKY_VERTICAL_GRADIENT:
        f = scene.sky_factor
        col = scene.sky_top * (1.0 - f) + scene.sky_bottom * f
    else:
        col = jnp.zeros(3, jnp.float32)
    return V3(col[0], col[1], col[2])


def make_trace_fn(static: SceneStatic, scene: SceneArrays,
                  geom: "BatchGeometry"):
    """Build the unified closest-hit tracer for this batch.

    Returns trace(o: V3, d: V3, alive) -> RawHit.  Each enabled geometry
    family is swept and the nearest hit wins; disabled families cost nothing
    (static specialization).
    """
    use_tris = static.has_tris
    use_spheres = static.has_spheres
    world_p = geom.world_p
    s_pad = scene.sph_center.shape[0]

    def trace(o: V3, d: V3, alive) -> RawHit:
        R = o.x.shape[0]
        t_best = jnp.full((R,), T_MAX, jnp.float32)

        tri_hit = None
        if use_tris:
            if static.bvh_mode == "sah":
                from ..ops.bvh import BVHArrays, pack_world_tris, traverse_sah

                v0, e1, e2 = pack_world_tris(world_p)
                tri_hit = traverse_sah(
                    BVHArrays(scene.bvh_child_boxes, v0, e1, e2),
                    static.bvh_root, static.bvh_leaf_size,
                    static.bvh_stack_depth,
                    vec3.to_rows(o), vec3.to_rows(d), active=alive,
                )
            elif static.bvh_mode == "implicit":
                from ..ops.bvh import BVHArrays, pack_world_tris, traverse

                v0, e1, e2 = pack_world_tris(world_p)
                tri_hit = traverse(
                    BVHArrays(scene.bvh_child_boxes, v0, e1, e2),
                    static.bvh_num_leaves, static.bvh_leaf_size,
                    static.bvh_stack_depth,
                    vec3.to_rows(o), vec3.to_rows(d), active=alive,
                )
            elif static.use_pallas_sweep:
                from ..ops.pallas_tri_sweep import intersect_tris_pallas_v3

                tri_hit = intersect_tris_pallas_v3(
                    o, d, geom.tri_table16, active=alive,
                    interpret=static.pallas_interpret,
                )
            else:
                tri_hit = intersect.intersect_brute_force(
                    vec3.to_rows(o), vec3.to_rows(d), world_p, active=alive,
                    chunk=min(512, world_p.shape[0]),
                )
            t_best = tri_hit.t

        sph_hit = None
        if use_spheres:
            if static.sphere_world_mode and static.use_pallas_sweep:
                from ..ops.pallas_sweep import intersect_spheres_pallas_v3

                sph_hit = intersect_spheres_pallas_v3(
                    o, d, geom.sph_table8, active=alive,
                    interpret=static.pallas_interpret,
                )
            elif static.sphere_world_mode:
                sph_hit = spheres.intersect_spheres_world(
                    vec3.to_rows(o), vec3.to_rows(d), geom.sph_table,
                    active=alive, chunk=min(128, s_pad),
                )
            else:
                sph_hit = spheres.intersect_spheres(
                    vec3.to_rows(o), vec3.to_rows(d),
                    scene.sph_center, scene.sph_radius, geom.sph_w2o,
                    active=alive, chunk=min(128, s_pad),
                )
            t_best = jnp.minimum(t_best, sph_hit.t)

        missed = t_best >= T_MAX
        zeros = jnp.zeros((R,), jnp.float32)

        if use_tris and use_spheres:
            sphere_wins = sph_hit.t < tri_hit.t
            tri = jnp.maximum(tri_hit.tri, 0)
            sid = jnp.maximum(sph_hit.sph, 0)
            rh = RawHit(
                missed=missed, t=t_best,
                prim=jnp.where(sphere_wins, sid, s_pad + tri),
                is_sphere=sphere_wins,
                bu=jnp.where(sphere_wins, 0.0, tri_hit.u),
                bv=jnp.where(sphere_wins, 0.0, tri_hit.v),
            )
        elif use_spheres:
            sid = jnp.maximum(sph_hit.sph, 0)
            rh = RawHit(
                missed=missed, t=t_best, prim=sid,
                is_sphere=jnp.ones((R,), bool), bu=zeros, bv=zeros,
            )
        else:
            tri = jnp.maximum(tri_hit.tri, 0)
            rh = RawHit(
                missed=missed, t=t_best, prim=s_pad + tri,
                is_sphere=jnp.zeros((R,), bool), bu=tri_hit.u, bv=tri_hit.v,
            )
        if static.scene_axis is None:
            return rh
        return _sc_combine_hit(static, geom, rh, s_pad)

    return trace


def _sc_combine_hit(static: SceneStatic, geom, rh: RawHit,
                    s_pad: int) -> RawHit:
    """Scene-sharded closest-hit combine over the `scene_axis` mesh axis.

    Each shard swept only its slice of the primitive tables; rh carries
    LOCAL prim ids.  The tie key is family-major to reproduce the
    replicated sweep's order EXACTLY: at equal t a triangle beats a
    sphere (trace's strict `sph.t < tri.t`), and within a family the
    lowest ORIGINAL index wins (both intersectors are argmin-first +
    strict <; shards hold contiguous slices, so rank-major local order
    IS original order).  The winner's ray-dependent fields combine with
    one-owner masked psums (a single nonzero term per lane — exact, not
    a float reduction)."""
    ax = static.scene_axis
    n_sc = static.scene_shards
    P_loc = geom.prim_rows.shape[0]
    t_span = P_loc - s_pad
    rank = jax.lax.axis_index(ax).astype(jnp.int32)
    fam_key = jnp.where(
        rh.is_sphere,
        n_sc * t_span + rank * s_pad + rh.prim,
        rank * t_span + (rh.prim - s_pad),
    )
    tmin = jax.lax.pmin(rh.t, ax)
    key = jnp.where(rh.t == tmin, fam_key, jnp.int32(2147483647))
    win = key == jax.lax.pmin(key, ax)
    sel = lambda x: jax.lax.psum(jnp.where(win, x, 0.0), ax)
    gid = rank * P_loc + rh.prim
    return RawHit(
        missed=tmin >= T_MAX, t=tmin,
        prim=jax.lax.psum(jnp.where(win, gid, 0), ax),
        is_sphere=sel(rh.is_sphere.astype(jnp.float32)) > 0.5,
        bu=sel(rh.bu), bv=sel(rh.bv),
    )


def _sc_decode(static: SceneStatic, geom, prim):
    """Global prim id -> (local prim id, owner mask) under scene
    sharding; (prim, None) otherwise."""
    if static.scene_axis is None:
        return prim, None
    P_loc = geom.prim_rows.shape[0]
    rank = jax.lax.axis_index(static.scene_axis).astype(jnp.int32)
    return prim % P_loc, (prim // P_loc) == rank


def _sc_fetch(static: SceneStatic, mine, rows):
    """One-owner masked psum of per-prim rows gathered from a shard-local
    table (exact: a single nonzero term per lane)."""
    if mine is None:
        return rows
    mask = mine.reshape(mine.shape + (1,) * (rows.ndim - 1))
    return jax.lax.psum(jnp.where(mask, rows, 0.0), static.scene_axis)


def _direct_normals(static) -> bool:
    """World-mode uniform spheres whose scenes never read sphere UVs
    (image textures need the object-space parameterization): the normal
    is (hit - c_world) * inv_r_world, with no object-space transform."""
    return bool(static.sphere_world_mode and static.use_fat_shading
                and not static.flags.has_image)


def reconstruct_hit(static: SceneStatic, scene: SceneArrays,
                    geom: "BatchGeometry", raw: RawHit, ray_o: V3, ray_d: V3,
                    rows=None) -> HitRecord:
    """RawHit → full HitRecord (all vectors V3).

    Fat path: sphere data (w2o, center, radius) comes from the combined row
    fetch; triangle attributes come from two packed [T,16]-row gathers
    (positions from the trace table, normals/uvs from tri_attr16).  The
    mesh/BVH path keeps [R,3,3] soup gathers (secondary, CPU-tested).
    """
    R = raw.prim.shape[0]
    s_pad = scene.sph_center.shape[0]
    # Scene sharding: raw.prim is a GLOBAL id; decode to the shard-local
    # id for table indexing and psum-combine the owner's fetches.
    lprim, mine = _sc_decode(static, geom, raw.prim)

    if static.has_tris:
        tri = jnp.maximum(lprim - s_pad, 0)
        packed = static.use_pallas_sweep and static.bvh_mode == "none"
        if packed:
            pos = geom.tri_table16[jnp.clip(tri, 0, geom.tri_table16.shape[0] - 1)]
            att = geom.tri_attr16[jnp.clip(tri, 0, geom.tri_attr16.shape[0] - 1)]
            pos = _sc_fetch(static, mine, pos)
            att = _sc_fetch(static, mine, att)
            bu, bv = raw.bu, raw.bv
            tp = V3(
                pos[:, 0] + bu * pos[:, 3] + bv * pos[:, 6],
                pos[:, 1] + bu * pos[:, 4] + bv * pos[:, 7],
                pos[:, 2] + bu * pos[:, 5] + bv * pos[:, 8],
            )
            tn = V3(
                att[:, 0] + bu * att[:, 3] + bv * att[:, 6],
                att[:, 1] + bu * att[:, 4] + bv * att[:, 7],
                att[:, 2] + bu * att[:, 5] + bv * att[:, 8],
            )
            tu = att[:, 9] + bu * att[:, 11] + bv * att[:, 13]
            tv = att[:, 10] + bu * att[:, 12] + bv * att[:, 14]
        else:
            w = 1.0 - raw.bu - raw.bv
            bary = jnp.stack([w, raw.bu, raw.bv], axis=-1)
            # HIGHEST: an f32 contraction may otherwise run in TF32 on
            # the GPU, which moves hit points off the surface.
            hp = jax.lax.Precision.HIGHEST
            tp_r = jnp.einsum("rv,rvi->ri", bary,
                              _sc_fetch(static, mine, geom.world_p[tri]),
                              precision=hp)
            tn_r = jnp.einsum("rv,rvi->ri", bary,
                              _sc_fetch(static, mine, geom.world_n[tri]),
                              precision=hp)
            tuv = jnp.einsum("rv,rvi->ri", bary,
                             _sc_fetch(static, mine, scene.tri_uv[tri]),
                             precision=hp)
            tp = vec3.from_rows(tp_r)
            tn = vec3.from_rows(tn_r)
            tu, tv = tuv[:, 0], tuv[:, 1]

    if static.has_spheres:
        if rows is not None and _direct_normals(static):
            # Slots 44:48 carry WORLD c/r (prepare_batch): direct normal.
            c = V3(rows[:, 44], rows[:, 45], rows[:, 46])
            r = rows[:, 47]
            sp = ray_o + raw.t * ray_d
            inv_r = 1.0 / jnp.where(r == 0.0, 1.0, r)
            sn = V3((sp.x - c.x) * inv_r, (sp.y - c.y) * inv_r,
                    (sp.z - c.z) * inv_r)
            su = sv = jnp.zeros_like(r)   # no sphere UV consumer (gated)
        else:
            if rows is not None:
                m_cols = tuple(rows[:, 32 + i] for i in range(12))
                c = V3(rows[:, 44], rows[:, 45], rows[:, 46])
                r = rows[:, 47]
            else:
                sid = jnp.minimum(raw.prim, s_pad - 1)
                w2o = geom.sph_w2o[sid]
                m_cols = tuple(w2o.reshape(R, 12)[:, i] for i in range(12))
                c = vec3.from_rows(scene.sph_center[sid])
                r = scene.sph_radius[sid]
            sp = ray_o + raw.t * ray_d
            p_obj = vec3.mat34_apply_point(m_cols, sp)
            inv_r = 1.0 / jnp.where(r == 0.0, 1.0, r)
            n_obj = V3((p_obj.x - c.x) * inv_r, (p_obj.y - c.y) * inv_r,
                       (p_obj.z - c.z) * inv_r)
            sn = vec3.mat34_apply_transposed_vec(m_cols, n_obj)
            nn = vec3.normalize(n_obj)
            # UV per the tessellator's parameterization (mesh.rs:164-178).
            sv = jnp.arccos(jnp.clip(-nn.y, -1.0, 1.0)) / spheres.PI
            su = (jnp.arctan2(nn.z, -nn.x) / spheres.TWO_PI) % 1.0

    if static.has_tris and static.has_spheres:
        sw = raw.is_sphere
        p = vec3.where(sw, sp, tp)
        n = vec3.where(sw, sn, tn)
        u = jnp.where(sw, su, tu)
        v = jnp.where(sw, sv, tv)
    elif static.has_spheres:
        p, n, u, v = sp, sn, su, sv
    else:
        p, n, u, v = tp, tn, tu, tv

    n = vec3.normalize(n)

    if rows is not None:
        mat_type = rows[:, 0].astype(jnp.int32)
        mat_index = jnp.zeros((R,), jnp.int32)       # unused on the fat path
        inst = rows[:, 48].astype(jnp.int32)
    else:
        tri_c = jnp.maximum(raw.prim - s_pad, 0) if static.has_tris else 0
        sid = jnp.minimum(raw.prim, s_pad - 1)
        if static.has_tris and static.has_spheres:
            sel1 = lambda a, b: jnp.where(raw.is_sphere, a, b)
            mat_type = sel1(scene.sph_mat_type[sid], scene.tri_mat_type[tri_c])
            mat_index = sel1(scene.sph_mat_index[sid], scene.tri_mat_index[tri_c])
            inst = sel1(scene.sph_inst[sid], scene.tri_inst[tri_c])
        elif static.has_spheres:
            mat_type = scene.sph_mat_type[sid]
            mat_index = scene.sph_mat_index[sid]
            inst = scene.sph_inst[sid]
        else:
            mat_type = scene.tri_mat_type[tri_c]
            mat_index = scene.tri_mat_index[tri_c]
            inst = scene.tri_inst[tri_c]

    return HitRecord(
        missed=raw.missed, t=raw.t, p=p, n=n, u=u, v=v,
        mat_type=mat_type, mat_index=mat_index, inst=inst, prim=raw.prim,
    )


def _registry_scatter(s_state, scene, static, rec: HitRecord, normal: V3,
                      front, ray_d: V3, alive):
    """CPU-tested fallback for material graphs that exceed the fat-row
    encoding: converts to [R,3] at the boundary and back."""
    mat_type = jnp.where(alive, rec.mat_type, 0)
    p_rows = vec3.to_rows(rec.p)
    n_rows = vec3.to_rows(normal)
    d_rows = vec3.to_rows(ray_d)
    emit = materials.calculate_emission(
        scene, static.flags, mat_type, rec.mat_index, p_rows, front,
        rec.u, rec.v,
    )
    rstate, srec = materials.calculate_scatter(
        s_state, scene, static.flags, mat_type, rec.mat_index,
        p_rows, n_rows, front, rec.u, rec.v, d_rows,
    )
    from ..ops.shading import ScatterV3

    srec_v3 = ScatterV3(
        is_scattered=srec.is_scattered,
        attenuation=vec3.from_rows(srec.attenuation),
        mat_pdf_type=srec.mat_pdf_type,
        skip_pdf=srec.skip_pdf,
        skip_dir=vec3.from_rows(srec.skip_dir),
    )
    return rstate, srec_v3, vec3.from_rows(emit)


def bounce_wavefront(
    static: SceneStatic,
    scene: SceneArrays,
    trace_fn: Callable,
    geom: "BatchGeometry",
    state: jnp.ndarray,
    ray_o: V3,
    ray_d: V3,
    max_depth=None,
):
    """Run the full bounce loop for a wavefront; returns (radiance V3 of [R],
    rng state, rays_traced scalar) — the rayColour loop (ray_gen.glsl:457-541).

    max_depth may be a traced scalar (it only bounds the while loop, not any
    shape), so depth changes never trigger recompilation."""
    R = ray_o.x.shape[0]
    if max_depth is None:
        max_depth = static.max_ray_depth

    ones = jnp.ones((R,), jnp.float32)
    zeros = jnp.zeros((R,), jnp.float32)
    init = BounceState(
        depth=jnp.int32(max_depth),
        state=state,
        ray_o=ray_o,
        ray_d=ray_d,
        throughput=V3(ones, ones, ones),
        accumulated=V3(zeros, zeros, zeros),
        alive=jnp.ones((R,), bool),
        rays_traced=jnp.float32(0.0),
    )

    def cond(s: BounceState):
        return (s.depth > 0) & jnp.any(s.alive)

    inst_mats = geom.inst_mats
    bg = _background_v3(static, scene)

    def body(s: BounceState) -> BounceState:
        raw = trace_fn(s.ray_o, s.ray_d, s.alive)
        rays_traced = s.rays_traced + jnp.sum(s.alive.astype(jnp.float32))

        missed = s.alive & raw.missed
        accumulated = vec3.where(
            missed, s.accumulated + s.throughput * bg, s.accumulated
        )
        alive = s.alive & ~raw.missed

        # --- one combined row fetch per bounce (fat path)
        if static.use_fat_shading:
            prim = jnp.where(alive, raw.prim, 0)
            P = geom.prim_rows.shape[0]
            lp, mine = _sc_decode(static, geom, prim)
            rows = geom.prim_rows[jnp.clip(lp, 0, P - 1)]
            rows = _sc_fetch(static, mine, rows)
        else:
            rows = None

        rec = reconstruct_hit(static, scene, geom, raw, s.ray_o, s.ray_d,
                              rows=rows)

        front = vec3.dot(s.ray_d, rec.n) < 0.0   # common.glsl:239-241
        normal = vec3.where(front, rec.n, -rec.n)

        # --- emission + scatter (ray_gen.glsl:499-506)
        if static.use_fat_shading:
            from ..ops import shading

            rstate, srec, emit = shading.scatter_and_emit_v3(
                s.state, scene, static.flags, rows,
                rec.p, normal, front, rec.u, rec.v, s.ray_d,
            )
        else:
            rstate, srec, emit = _registry_scatter(
                s.state, scene, static, rec, normal, front, s.ray_d, alive
            )
        accumulated = vec3.where(
            alive, accumulated + s.throughput * emit, accumulated
        )
        alive = alive & srec.is_scattered

        if static.has_lights:
            # --- NEE / MIS path (ray_gen.glsl:516-537)
            if rows is not None:
                o2w_rows = geom.inst_o2w_rows[rec.inst]     # [R,12]
                o2w_cols = tuple(o2w_rows[:, i] for i in range(12))
            else:
                o2w = inst_mats.object_to_world[rec.inst]
                o2w_cols = tuple(o2w.reshape(R, 12)[:, i] for i in range(12))
            rstate, light = nee.sample_light_sources_v3(rstate, scene, o2w_cols)
            rstate, chosen = nee.choose_mixture_pdf(
                rstate, srec.mat_pdf_type, static.has_lights
            )
            rstate, sdir = nee.gen_scatter_direction_v3(
                rstate, chosen, rec.p, normal, light
            )
            scatter_pdf = nee.pdf_value_v3(
                srec.mat_pdf_type, sdir, normal, light, scene.light_total_area
            )
            light_pdf = nee.pdf_value_v3(
                jnp.full_like(chosen, LIGHT_PDF), sdir, normal, light,
                scene.light_total_area,
            )
            pdf_value = 0.5 * light_pdf + 0.5 * scatter_pdf
            ratio = jnp.where(
                pdf_value > 0.0,
                scatter_pdf / jnp.where(pdf_value == 0.0, 1.0, pdf_value),
                0.0,
            )
            mis_throughput = s.throughput * srec.attenuation * ratio
            mis_dir = vec3.normalize(sdir)
        else:
            # No lights: pdfValue == scatteringPdf and the ratio cancels to 1
            # except where the cosine pdf is exactly 0 (the reference's 0/0;
            # guarded to 0 here).
            rstate, chosen = nee.choose_mixture_pdf(rstate, srec.mat_pdf_type, False)
            dummy_light = nee.LightSampleV3(
                position=vec3.zeros_like(rec.p), normal=vec3.zeros_like(rec.p)
            )
            rstate, sdir = nee.gen_scatter_direction_v3(
                rstate, chosen, rec.p, normal, dummy_light
            )
            scatter_pdf = nee.pdf_value_v3(
                srec.mat_pdf_type, sdir, normal, dummy_light, jnp.float32(1.0)
            )
            ratio = jnp.where(scatter_pdf > 0.0, 1.0, 0.0)
            mis_throughput = s.throughput * srec.attenuation * ratio
            mis_dir = vec3.normalize(sdir)

        use_skip = srec.skip_pdf
        new_throughput = vec3.where(
            use_skip, s.throughput * srec.attenuation, mis_throughput
        )
        new_dir = vec3.where(use_skip, srec.skip_dir, mis_dir)

        ray_o = vec3.where(alive, rec.p, s.ray_o)
        ray_d = vec3.where(alive, new_dir, s.ray_d)
        throughput = vec3.where(alive, new_throughput, s.throughput)

        return BounceState(
            depth=s.depth - 1,
            state=rstate,
            ray_o=ray_o,
            ray_d=ray_d,
            throughput=throughput,
            accumulated=accumulated,
            alive=alive,
            rays_traced=rays_traced,
        )

    # --- multi-phase execution with tail compaction -----------------------
    # Every while iteration costs O(R) regardless of how many rays are still
    # alive, and scenes run to max_ray_depth=50 while the mean path length
    # is ~2-5 — so the tail dominates.  Each phase runs until the alive
    # count drops below the next (8x smaller) wavefront size, then the
    # survivors are compacted (sorted alive-first) and the loop continues
    # at 1/8 cost.  Contributions scatter back by index after each phase.
    sizes = _compact_schedule(R)
    if not sizes:
        final = jax.lax.while_loop(cond, body, init)
        return final.accumulated, final.state, final.rays_traced

    acc_x = jnp.zeros((R,), jnp.float32)
    acc_y = jnp.zeros((R,), jnp.float32)
    acc_z = jnp.zeros((R,), jnp.float32)
    state_out = init.state
    rays_total = jnp.float32(0.0)
    sel_chain = jnp.arange(R)
    s_cur = init

    for next_size in sizes + [0]:
        if next_size > 0:
            def cond_phase(s, _n=next_size):
                return (s.depth > 0) & (jnp.sum(s.alive) > _n)
        else:
            cond_phase = cond
        s_cur = jax.lax.while_loop(cond_phase, body, s_cur)

        idx = sel_chain
        acc_x = acc_x.at[idx].add(s_cur.accumulated.x)
        acc_y = acc_y.at[idx].add(s_cur.accumulated.y)
        acc_z = acc_z.at[idx].add(s_cur.accumulated.z)
        state_out = state_out.at[idx].set(s_cur.state)
        rays_total = rays_total + s_cur.rays_traced

        if next_size == 0:
            break

        # Compaction without a sort: cumsum gives each alive ray a dense
        # destination slot; a dropped-out-of-range scatter builds the
        # selection.  Dead slots alias index 0 but are marked dead, carry
        # zero accumulation, and their final RNG state is never consumed.
        cur_R = s_cur.alive.shape[0]
        pos = jnp.cumsum(s_cur.alive.astype(jnp.int32)) - 1
        n_alive = jnp.sum(s_cur.alive.astype(jnp.int32))
        dest = jnp.where(s_cur.alive & (pos < next_size), pos, next_size)
        sel = jnp.zeros((next_size,), jnp.int32).at[dest].set(
            jnp.arange(cur_R, dtype=jnp.int32), mode="drop"
        )
        alive_next = jnp.arange(next_size) < n_alive
        sel_chain = idx[sel]
        take3 = lambda v: V3(v.x[sel], v.y[sel], v.z[sel])
        nz = jnp.zeros((next_size,), jnp.float32)
        s_cur = BounceState(
            depth=s_cur.depth,
            state=s_cur.state[sel],
            ray_o=take3(s_cur.ray_o),
            ray_d=take3(s_cur.ray_d),
            throughput=take3(s_cur.throughput),
            accumulated=V3(nz, nz, nz),
            alive=alive_next,
            rays_traced=jnp.float32(0.0),
        )

    return V3(acc_x, acc_y, acc_z), state_out, rays_total


def render_tile(
    static: SceneStatic,
    scene: SceneArrays,
    cam: cam_ops.CameraArrays,
    trace_fn,
    geom,
    sample_batch,
    row0,
    rows_per_tile: int,
    use_dof: bool,
    spp_local: int = 0,
    sample_base=0,
    reduce_mean: bool = True,
    max_depth=None,
):
    """Render `rows_per_tile` pixel rows x width x spp_local samples.

    spp_local/sample_base support sample-axis sharding across chips: a shard
    renders samples [sample_base, sample_base+spp_local) of the pixel's spp
    grid.  With reduce_mean the tile is averaged over local samples (single
    chip); otherwise the per-sample SUM is returned for a cross-chip psum.
    Returns (tile [rows, W, 3], rays-traced count).
    """
    W = static.width
    sqrt_spp = static.sqrt_spp
    spp = sqrt_spp * sqrt_spp
    if spp_local == 0:
        spp_local = spp

    n_rays = rows_per_tile * W * spp_local
    ray_ids = jnp.arange(n_rays, dtype=jnp.uint32)

    s = ray_ids % spp_local + jnp.uint32(sample_base)
    pix = ray_ids // spp_local
    px = pix % W
    py = row0.astype(jnp.uint32) + pix // W
    si = (s % sqrt_spp).astype(jnp.int32)
    sj = (s // sqrt_spp).astype(jnp.int32)

    state = rng.init_rng(sample_batch, s, py, px, static.width, static.height, spp)

    state, ray_o, ray_d = cam_ops.get_rays_v3(
        state, cam, px.astype(jnp.int32), py.astype(jnp.int32), si, sj,
        static.width, static.height, sqrt_spp, use_dof=use_dof,
    )

    radiance, state, rays_traced = bounce_wavefront(
        static, scene, trace_fn, geom, state, ray_o, ray_d,
        max_depth=max_depth,
    )

    tile = vec3.to_rows(radiance).reshape(rows_per_tile, W, spp_local, 3)
    tile = tile.mean(axis=2) if reduce_mean else tile.sum(axis=2)
    return tile, rays_traced


class BatchGeometry(NamedTuple):
    """Per-batch world-space geometry (the refit product)."""

    inst_mats: transforms.InstanceMatrices
    world_p: jnp.ndarray    # [T,3,3] (dummy [1,3,3] when no triangles)
    world_n: jnp.ndarray
    sph_w2o: jnp.ndarray    # [S,3,4] world-to-object per sphere
    sph_table: jnp.ndarray  # [S,5] world c/r/k (host-precomputed per batch)
    sph_table8: jnp.ndarray # [S2,8] sphere table for the Pallas sweep
    tri_table16: jnp.ndarray # [T2,16] v0/e1/e2 triangles (Pallas sweep + attrs)
    tri_attr16: jnp.ndarray  # [T2,16] n0/dn1/dn2/uv0/duv1/duv2 (hit attrs)
    prim_rows: jnp.ndarray  # [P,64] combined per-primitive rows (fat path)
    inst_o2w_rows: jnp.ndarray  # [I,12] objectToWorld rows (NEE fetch)


def prepare_batch(static: SceneStatic, scene: SceneArrays,
                  batch_time: jnp.ndarray,
                  sph_table=None) -> BatchGeometry:
    """Interpolate instance transforms to the batch ray time and re-transform
    the triangle soup — the replacement for the reference's per-batch TLAS
    refit (acceleration.rs:91-115).  One jit'd call per batch.

    sph_table: [S,5] world-space sphere rows for this batch time
    (ops/spheres.world_sphere_tables), or None for the object-space path.
    """
    inst_mats = transforms.interpolate_instances(
        scene.inst_t0, scene.inst_t1, batch_time
    )
    if static.has_tris:
        world_p, world_n = transforms.transform_soup(
            scene.tri_p, scene.tri_n, scene.tri_inst, inst_mats
        )
    else:
        world_p = world_n = jnp.zeros((1, 3, 3), jnp.float32)
    if static.has_spheres:
        sph_w2o = inst_mats.world_to_object[scene.sph_inst]
    else:
        sph_w2o = jnp.zeros((scene.sph_center.shape[0], 3, 4), jnp.float32)
    if sph_table is None:
        sph_table = jnp.zeros((scene.sph_center.shape[0], 5), jnp.float32)
    if static.use_pallas_sweep and static.has_spheres:
        from ..ops.pallas_sweep import pad_table8

        sph_table8 = pad_table8(jnp.asarray(sph_table))
    else:
        sph_table8 = jnp.zeros((8, 8), jnp.float32)

    if static.use_pallas_sweep and static.has_tris and static.bvh_mode == "none":
        from ..ops.pallas_tri_sweep import pack_tri_table

        num_tris = static.num_triangles
        if static.scene_axis is not None:
            # Scene sharding: validity is a GLOBAL row property; clamp
            # the count to this shard's slice (dup-padding rows beyond
            # it are inert anyway — a duplicate at a higher id never
            # wins the strict-< sweep — but zero-row compile padding
            # must stay invalid).
            T_loc = world_p.shape[0]
            rank = jax.lax.axis_index(static.scene_axis).astype(jnp.int32)
            num_tris = jnp.clip(
                static.num_triangles - rank * T_loc, 0, T_loc)
        tri_table16 = pack_tri_table(world_p, num_tris)
        # Attribute table: n0, n1-n0, n2-n0, uv0, uv1-uv0, uv2-uv0, pad.
        T = world_n.shape[0]
        T8 = tri_table16.shape[0]
        n0 = world_n[:, 0, :]
        dn1 = world_n[:, 1, :] - n0
        dn2 = world_n[:, 2, :] - n0
        uv0 = scene.tri_uv[:, 0, :]
        duv1 = scene.tri_uv[:, 1, :] - uv0
        duv2 = scene.tri_uv[:, 2, :] - uv0
        att = jnp.zeros((T8, 16), jnp.float32)
        att = att.at[:T, 0:3].set(n0)
        att = att.at[:T, 3:6].set(dn1)
        att = att.at[:T, 6:9].set(dn2)
        att = att.at[:T, 9:11].set(uv0)
        att = att.at[:T, 11:13].set(duv1)
        att = att.at[:T, 13:15].set(duv2)
        tri_attr16 = att
    else:
        tri_table16 = jnp.zeros((8, 16), jnp.float32)
        tri_attr16 = jnp.zeros((8, 16), jnp.float32)

    # Combined per-primitive rows: ONE fetch per bounce serves shading,
    # sphere attributes, and NEE's instance transform.
    # [0:32] shading row | [32:44] w2o | [44:47] obj center | [47] radius
    # | [48] instance id | [49:64] pad.
    if static.use_fat_shading:
        s_pad = scene.sph_center.shape[0]
        P = scene.shade_rows.shape[0]
        rows = jnp.zeros((P, 64), jnp.float32)
        rows = rows.at[:, 0:32].set(scene.shade_rows)
        if _direct_normals(static):
            # World-mode uniform spheres without sphere UVs: slots
            # 44:48 carry the per-batch WORLD center/radius and the
            # normal is computed directly from them (reconstruct_hit);
            # the 12 w2o slots stay zero.
            rows = rows.at[:s_pad, 44:47].set(sph_table[:s_pad, 0:3])
            rows = rows.at[:s_pad, 47].set(sph_table[:s_pad, 3])
        else:
            rows = rows.at[:s_pad, 32:44].set(sph_w2o.reshape(s_pad, 12))
            rows = rows.at[:s_pad, 44:47].set(scene.sph_center)
            rows = rows.at[:s_pad, 47].set(scene.sph_radius)
        rows = rows.at[:s_pad, 48].set(scene.sph_inst.astype(jnp.float32))
        rows = rows.at[s_pad:, 48].set(scene.tri_inst.astype(jnp.float32))
        prim_rows = rows
    else:
        prim_rows = jnp.zeros((1, 64), jnp.float32)

    I = scene.inst_t0.shape[0]
    inst_o2w_rows = inst_mats.object_to_world.reshape(I, 12)

    return BatchGeometry(inst_mats=inst_mats, world_p=world_p, world_n=world_n,
                         sph_w2o=sph_w2o, sph_table=jnp.asarray(sph_table),
                         sph_table8=sph_table8, tri_table16=tri_table16,
                         tri_attr16=tri_attr16, prim_rows=prim_rows,
                         inst_o2w_rows=inst_o2w_rows)


def render_tile_step(
    static: SceneStatic,
    scene: SceneArrays,
    geom: BatchGeometry,
    cam: cam_ops.CameraArrays,
    sample_batch: jnp.ndarray,
    row0: jnp.ndarray,
    rows_per_tile: int,
    use_dof: bool = False,
    trace_builder=None,
    max_depth=None,
):
    """One jit'd dispatch: render a tile of pixel rows for one batch.

    Kept to a bounded ray count per dispatch (engine.renderer.RAY_BUDGET)
    — the moral equivalent of the reference's <=64 spp / <=32 batch
    guidance against GPU timeouts (ray_gen.glsl:68-74), which also bounds
    the wavefront's working set.
    """
    if trace_builder is None:
        trace_fn = make_trace_fn(static, scene, geom)
    else:
        trace_fn = trace_builder(static, scene, geom)
    return render_tile(
        static, scene, cam, trace_fn, geom,
        sample_batch, row0, rows_per_tile, use_dof, max_depth=max_depth,
    )
