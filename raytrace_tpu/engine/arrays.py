"""Device-resident scene state.

``SceneArrays`` is a pytree of jnp arrays (everything traced through jit);
``SceneStatic`` carries the hashable compile-time facts that specialize the
kernel (sky model, which texture families exist, whether there are lights or
animated instances) — the XLA analogue of the reference's push-constant
count guards (ray_gen.glsl:85-102), except branches that can't run are
removed at compile time instead of at runtime.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.compile import CompiledScene
from ..ops.textures import TexFlags, srgb_u8_to_linear_lut


class SceneArrays(NamedTuple):
    # triangle soup (object space)
    tri_p: jnp.ndarray
    tri_n: jnp.ndarray
    tri_uv: jnp.ndarray
    tri_inst: jnp.ndarray
    tri_mat_type: jnp.ndarray
    tri_mat_index: jnp.ndarray
    # analytic spheres
    sph_center: jnp.ndarray
    sph_radius: jnp.ndarray
    sph_inst: jnp.ndarray
    sph_mat_type: jnp.ndarray
    sph_mat_index: jnp.ndarray
    # instances
    inst_t0: jnp.ndarray
    inst_t1: jnp.ndarray
    # lights
    light_prob: jnp.ndarray
    light_alias: jnp.ndarray
    light_tri_p: jnp.ndarray
    light_tri_packed: jnp.ndarray  # [L,16] p0 p1 p2 pad (single-row fetch)
    light_count: jnp.ndarray        # i32 scalar
    light_total_area: jnp.ndarray   # f32 scalar
    # textures
    const_colours: jnp.ndarray
    checker_scale: jnp.ndarray
    checker_even: jnp.ndarray
    checker_odd: jnp.ndarray
    noise_scale: jnp.ndarray
    atlas: jnp.ndarray
    atlas_wh: jnp.ndarray
    srgb_lut: jnp.ndarray
    # materials
    lamb_albedo: jnp.ndarray
    metal_albedo: jnp.ndarray
    metal_fuzz: jnp.ndarray
    diel_ri: jnp.ndarray
    light_emit: jnp.ndarray
    # table counts (device scalars used as bounds guards)
    n_const: jnp.ndarray
    n_image: jnp.ndarray
    n_checker: jnp.ndarray
    n_noise: jnp.ndarray
    n_lamb: jnp.ndarray
    n_metal: jnp.ndarray
    n_diel: jnp.ndarray
    n_light_mat: jnp.ndarray
    # sky
    sky_solid: jnp.ndarray
    sky_top: jnp.ndarray
    sky_bottom: jnp.ndarray
    sky_factor: jnp.ndarray
    # BVH (empty [0,16] when tracing brute-force)
    bvh_child_boxes: jnp.ndarray
    # pre-resolved shading rows ([1,32] dummy when unavailable)
    shade_rows: jnp.ndarray


@dataclass(frozen=True)
class SceneStatic:
    """Hashable compile-time scene facts (jit static argument)."""

    sky_type: int
    flags: TexFlags
    has_lights: bool
    any_animated: bool
    num_triangles: int       # actual count (soup is padded beyond this)
    num_spheres: int
    has_tris: bool
    has_spheres: bool
    num_instances: int
    max_ray_depth: int
    sqrt_spp: int
    width: int
    height: int
    # BVH geometry ("none" → brute-force tracer)
    bvh_mode: str = "none"        # "none" | "implicit" | "sah"
    bvh_num_leaves: int = 0
    bvh_leaf_size: int = 4
    bvh_stack_depth: int = 0
    bvh_root: int = 0
    # shading / sphere fast paths
    use_fat_shading: bool = False
    sphere_world_mode: bool = False
    # fused Pallas-Triton sphere/triangle sweeps (ops/pallas_sweep.py,
    # ops/pallas_tri_sweep.py); interpret mode only when a test asks
    use_pallas_sweep: bool = False
    pallas_interpret: bool = False
    # scene sharding (parallel/multichip.py "sc" mesh axis): primitive
    # tables are row-sharded across scene_shards devices; the bounce
    # loop combines per-shard closest hits with lax.pmin over scene_axis
    # and fetches the winner's fat row with a one-owner masked psum.
    # None/1 = replicated scene (every other path).
    scene_axis: object = None
    scene_shards: int = 1


def upload_scene(cs: CompiledScene, bvh=None, sharding=None):
    """CompiledScene (numpy) → (SceneArrays on device, SceneStatic)."""
    i32 = lambda x: jnp.asarray(x, jnp.int32)
    f32 = lambda x: jnp.asarray(x, jnp.float32)

    # Counts actually used by the material/texture tables (actual, unpadded).
    n_image = 0 if int(np.prod(cs.atlas.shape[1:3])) <= 1 else cs.atlas.shape[0]

    arrays = SceneArrays(
        tri_p=f32(cs.tri_p), tri_n=f32(cs.tri_n), tri_uv=f32(cs.tri_uv),
        tri_inst=i32(cs.tri_inst),
        tri_mat_type=i32(cs.tri_mat_type), tri_mat_index=i32(cs.tri_mat_index),
        sph_center=f32(cs.sph_center), sph_radius=f32(cs.sph_radius),
        sph_inst=i32(cs.sph_inst),
        sph_mat_type=i32(cs.sph_mat_type), sph_mat_index=i32(cs.sph_mat_index),
        inst_t0=f32(cs.inst_t0), inst_t1=f32(cs.inst_t1),
        light_prob=f32(cs.light_prob), light_alias=i32(cs.light_alias),
        light_tri_p=f32(cs.light_tri_p),
        light_tri_packed=f32(np.pad(
            cs.light_tri_p.reshape(len(cs.light_tri_p), 9), ((0, 0), (0, 7))
        )),
        light_count=i32(cs.light_count),
        light_total_area=f32(cs.light_total_area),
        const_colours=f32(cs.const_colours),
        checker_scale=f32(cs.checker_scale),
        checker_even=i32(cs.checker_even), checker_odd=i32(cs.checker_odd),
        noise_scale=f32(cs.noise_scale),
        atlas=jnp.asarray(cs.atlas, jnp.uint8), atlas_wh=i32(cs.atlas_wh),
        srgb_lut=f32(srgb_u8_to_linear_lut()),
        lamb_albedo=i32(cs.lamb_albedo),
        metal_albedo=i32(cs.metal_albedo), metal_fuzz=i32(cs.metal_fuzz),
        diel_ri=f32(cs.diel_ri), light_emit=i32(cs.light_emit),
        n_const=i32(len(cs.const_colours)),
        n_image=i32(n_image),
        n_checker=i32(len(cs.checker_scale)),
        n_noise=i32(len(cs.noise_scale)),
        n_lamb=i32(len(cs.lamb_albedo)),
        n_metal=i32(len(cs.metal_albedo)),
        n_diel=i32(len(cs.diel_ri)),
        n_light_mat=i32(len(cs.light_emit)),
        sky_solid=f32(cs.sky_solid), sky_top=f32(cs.sky_top),
        sky_bottom=f32(cs.sky_bottom), sky_factor=f32(cs.sky_factor),
        bvh_child_boxes=f32(
            bvh.child_boxes if bvh is not None else np.zeros((0, 16), np.float32)
        ),
        shade_rows=f32(
            cs.shade_rows if cs.shade_rows is not None
            else np.zeros((1, 32), np.float32)
        ),
    )
    if sharding is not None:
        arrays = jax.device_put(arrays, sharding)

    static = SceneStatic(
        sky_type=int(cs.sky_type),
        flags=TexFlags.for_scene(cs),
        has_lights=bool(cs.light_count > 0 and cs.light_total_area > 0.0),
        any_animated=bool(cs.any_animated),
        num_triangles=int(cs.num_triangles),
        num_spheres=int(cs.num_spheres),
        has_tris=bool(cs.num_triangles > 0),
        has_spheres=bool(cs.num_spheres > 0),
        num_instances=int(cs.num_instances),
        max_ray_depth=int(cs.render.max_ray_depth),
        sqrt_spp=int(cs.render.sqrt_spp),
        width=int(cs.render.width),
        height=int(cs.render.height),
        bvh_mode=bvh.mode if bvh is not None else "none",
        bvh_num_leaves=int(bvh.num_leaves) if bvh is not None else 0,
        bvh_leaf_size=int(bvh.leaf_size) if bvh is not None else 4,
        bvh_stack_depth=int(bvh.depth + 2) if bvh is not None else 0,
        bvh_root=int(bvh.root) if bvh is not None else 0,
        use_fat_shading=cs.shade_rows is not None,
    )
    return arrays, static
