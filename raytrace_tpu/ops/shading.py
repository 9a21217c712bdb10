"""Single-fetch shading from pre-resolved fat rows
(models/shading_table.py).

Replaces the registry-walk of ops/materials.py + ops/textures.py on the hot
path: the hit primitive's 32-float row arrives via one row gather, and every
material family evaluates branchlessly from row slots.  Semantics are
identical to the registry path (ray_gen.glsl:328-440) — covered by
cross-checking tests.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.compile import (
    MAT_TYPE_DIELECTRIC,
    MAT_TYPE_DIFFUSE_LIGHT,
    MAT_TYPE_LAMBERTIAN,
    MAT_TYPE_METAL,
)
from ..models.shading_table import MODE_CHECKER, MODE_CONST, MODE_IMAGE, MODE_NOISE
from . import perlin, rng, vec
from .materials import COSINE_PDF, NO_PDF, ScatterRecord, reflect, refract, schlick_reflectance
from .textures import sample_image_nearest

def _marble(scale, p):
    """Noise-texture marble (ray_gen.glsl:203-208); aux slot carries the
    baked noise SCALE."""
    v = 0.5 * (1.0 + jnp.sin(scale * p[..., 2] + 10.0 * perlin.turbulence(p, 7)))
    return v[..., None] * jnp.ones((1, 3), jnp.float32)


def _eval_slot(flags, scene, base_rgb, mode, aux, hit_p, hit_u, hit_v):
    """Evaluate one basic property slot: constant / image / noise."""
    out = base_rgb
    if flags.has_image:
        idx = jnp.clip(aux.astype(jnp.int32), 0, scene.atlas.shape[0] - 1)
        img = sample_image_nearest(
            scene.atlas, scene.atlas_wh, scene.srgb_lut, idx, hit_u, hit_v
        )
        out = jnp.where((mode == MODE_IMAGE)[:, None], img, out)
    if flags.has_noise:
        out = jnp.where((mode == MODE_NOISE)[:, None], _marble(aux, hit_p), out)
    return out


def eval_albedo(flags, scene, rows, hit_p, hit_u, hit_v):
    """Albedo slot incl. one checker indirection (ray_gen.glsl:214-243)."""
    base = rows[:, 2:5]
    mode = rows[:, 11]
    aux = rows[:, 12]
    out = _eval_slot(flags, scene, base, mode, aux, hit_p, hit_u, hit_v)
    if flags.has_checker:
        inv_scale = 1.0 / jnp.where(rows[:, 17] == 0.0, 1.0, rows[:, 17])
        xi = jnp.floor(inv_scale * hit_p[:, 0]).astype(jnp.int32)
        yi = jnp.floor(inv_scale * hit_p[:, 1]).astype(jnp.int32)
        zi = jnp.floor(inv_scale * hit_p[:, 2]).astype(jnp.int32)
        is_even = (xi + yi + zi) % 2 == 0
        even = _eval_slot(flags, scene, rows[:, 18:21], rows[:, 24], rows[:, 25],
                          hit_p, hit_u, hit_v)
        odd = _eval_slot(flags, scene, rows[:, 21:24], rows[:, 26], rows[:, 27],
                         hit_p, hit_u, hit_v)
        ck = jnp.where(is_even[:, None], even, odd)
        out = jnp.where((mode == MODE_CHECKER)[:, None], ck, out)
    return out


def eval_emit(flags, scene, rows, hit_p, hit_u, hit_v):
    base = rows[:, 8:11]
    out = _eval_slot(flags, scene, base, rows[:, 15], rows[:, 16], hit_p, hit_u, hit_v)
    if flags.has_checker:
        # Checker-on-emit shares the row's single checker block; the albedo
        # variant of eval handles selection identically.
        inv_scale = 1.0 / jnp.where(rows[:, 17] == 0.0, 1.0, rows[:, 17])
        xi = jnp.floor(inv_scale * hit_p[:, 0]).astype(jnp.int32)
        yi = jnp.floor(inv_scale * hit_p[:, 1]).astype(jnp.int32)
        zi = jnp.floor(inv_scale * hit_p[:, 2]).astype(jnp.int32)
        is_even = (xi + yi + zi) % 2 == 0
        even = _eval_slot(flags, scene, rows[:, 18:21], rows[:, 24], rows[:, 25],
                          hit_p, hit_u, hit_v)
        odd = _eval_slot(flags, scene, rows[:, 21:24], rows[:, 26], rows[:, 27],
                         hit_p, hit_u, hit_v)
        ck = jnp.where(is_even[:, None], even, odd)
        out = jnp.where((rows[:, 15] == MODE_CHECKER)[:, None], ck, out)
    return out


def scatter_and_emit(state, scene, flags, rows, hit_p, normal, front_face,
                     hit_u, hit_v, world_ray_dir):
    """Fat-row calculateScatter + calculateEmission (ray_gen.glsl:328-440).

    Returns (state, ScatterRecord, emission [R,3]).
    """
    R = hit_p.shape[0]
    mat_type = rows[:, 0].astype(jnp.int32)

    state, fuzz_unit = rng.random_unit_vec3(state)
    state, diel_u = rng.random_float(state)

    albedo = eval_albedo(flags, scene, rows, hit_p, hit_u, hit_v)
    fuzz = rows[:, 5:8]

    is_lamb = mat_type == MAT_TYPE_LAMBERTIAN
    is_metal = mat_type == MAT_TYPE_METAL
    is_diel = mat_type == MAT_TYPE_DIELECTRIC
    is_light = mat_type == MAT_TYPE_DIFFUSE_LIGHT

    # metal (ray_gen.glsl:344-364)
    reflected = reflect(world_ray_dir, normal)
    metal_scatters = jnp.sum(reflected * normal, axis=-1) > 0.0
    refl_unit = vec.normalize(reflected)
    metal_dir = refl_unit + fuzz * fuzz_unit

    # dielectric (ray_gen.glsl:366-399)
    ref_idx = rows[:, 1]
    ri = jnp.where(front_face, 1.0 / jnp.where(ref_idx == 0.0, 1.0, ref_idx), ref_idx)
    unit_dir = vec.normalize(world_ray_dir)
    cos_theta = jnp.minimum(jnp.sum(-unit_dir * normal, axis=-1), 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    cannot_refract = (ri * sin_theta > 1.0) | (schlick_reflectance(cos_theta, ri) > diel_u)
    diel_dir = jnp.where(
        cannot_refract[:, None],
        reflect(unit_dir, normal),
        refract(unit_dir, normal, ri[:, None]),
    )

    zero3 = jnp.zeros((R, 3), jnp.float32)
    is_scattered = is_lamb | is_diel | (is_metal & metal_scatters)
    attenuation = jnp.where(
        is_lamb[:, None] | is_metal[:, None], albedo,
        jnp.where(is_diel[:, None], jnp.ones((R, 3), jnp.float32), zero3),
    )
    skip_pdf = is_metal | is_diel
    skip_dir = jnp.where(is_metal[:, None], metal_dir,
                         jnp.where(is_diel[:, None], diel_dir, zero3))
    mat_pdf_type = jnp.where(is_lamb, COSINE_PDF, NO_PDF).astype(jnp.int32)

    srec = ScatterRecord(
        is_scattered=is_scattered,
        attenuation=attenuation,
        mat_pdf_type=mat_pdf_type,
        skip_pdf=skip_pdf,
        skip_dir=skip_dir,
    )

    # emission, front faces only (ray_gen.glsl:401-412)
    if flags.has_emissive:
        emit = eval_emit(flags, scene, rows, hit_p, hit_u, hit_v)
        emission = jnp.where((is_light & front_face)[:, None], emit, 0.0)
    else:
        emission = zero3
    return state, srec, emission


# ---------------------------------------------------------------------------
# Component-wise (V3) versions for the padding-free hot path.  Same math as
# above; vectors are triples of [R] arrays (see ops/vec3.py for why).

from typing import NamedTuple as _NamedTuple

from . import vec3
from .vec3 import V3


class ScatterV3(_NamedTuple):
    is_scattered: jnp.ndarray
    attenuation: V3
    mat_pdf_type: jnp.ndarray
    skip_pdf: jnp.ndarray
    skip_dir: V3


def _eval_slot_v3(flags, scene, base: V3, mode, aux, p: V3, hit_u, hit_v,
                  p_rows=None):  # p_rows kept for signature compat
    out = base
    if flags.has_image:
        idx = jnp.clip(aux.astype(jnp.int32), 0, scene.atlas.shape[0] - 1)
        img = vec3.from_rows(sample_image_nearest(
            scene.atlas, scene.atlas_wh, scene.srgb_lut, idx, hit_u, hit_v
        ))
        out = vec3.where(mode == MODE_IMAGE, img, out)
    if flags.has_noise:
        # Component-wise turbulence: bitwise-identical to the row
        # version and Pallas-compatible (no [...,3] stacking).
        turb = perlin.turbulence_v3(p.x, p.y, p.z, 7)
        m = 0.5 * (1.0 + jnp.sin(aux * p.z + 10.0 * turb))
        out = vec3.where(mode == MODE_NOISE, V3(m, m, m), out)
    return out


def _rowv3(rows, c0):
    return V3(rows[:, c0], rows[:, c0 + 1], rows[:, c0 + 2])


def eval_albedo_v3(flags, scene, rows, p: V3, hit_u, hit_v, p_rows=None):
    out = _eval_slot_v3(flags, scene, _rowv3(rows, 2), rows[:, 11], rows[:, 12],
                        p, hit_u, hit_v, p_rows)
    if flags.has_checker:
        inv_scale = 1.0 / jnp.where(rows[:, 17] == 0.0, 1.0, rows[:, 17])
        parity = (
            jnp.floor(inv_scale * p.x).astype(jnp.int32)
            + jnp.floor(inv_scale * p.y).astype(jnp.int32)
            + jnp.floor(inv_scale * p.z).astype(jnp.int32)
        ) % 2 == 0
        even = _eval_slot_v3(flags, scene, _rowv3(rows, 18), rows[:, 24],
                             rows[:, 25], p, hit_u, hit_v, p_rows)
        odd = _eval_slot_v3(flags, scene, _rowv3(rows, 21), rows[:, 26],
                            rows[:, 27], p, hit_u, hit_v, p_rows)
        ck = vec3.where(parity, even, odd)
        out = vec3.where(rows[:, 11] == MODE_CHECKER, ck, out)
    return out


def eval_emit_v3(flags, scene, rows, p: V3, hit_u, hit_v, p_rows=None):
    out = _eval_slot_v3(flags, scene, _rowv3(rows, 8), rows[:, 15], rows[:, 16],
                        p, hit_u, hit_v, p_rows)
    if flags.has_checker:
        inv_scale = 1.0 / jnp.where(rows[:, 17] == 0.0, 1.0, rows[:, 17])
        parity = (
            jnp.floor(inv_scale * p.x).astype(jnp.int32)
            + jnp.floor(inv_scale * p.y).astype(jnp.int32)
            + jnp.floor(inv_scale * p.z).astype(jnp.int32)
        ) % 2 == 0
        even = _eval_slot_v3(flags, scene, _rowv3(rows, 18), rows[:, 24],
                             rows[:, 25], p, hit_u, hit_v, p_rows)
        odd = _eval_slot_v3(flags, scene, _rowv3(rows, 21), rows[:, 26],
                            rows[:, 27], p, hit_u, hit_v, p_rows)
        ck = vec3.where(parity, even, odd)
        out = vec3.where(rows[:, 15] == MODE_CHECKER, ck, out)
    return out


def scatter_and_emit_v3(state, scene, flags, rows, p: V3, normal: V3,
                        front_face, hit_u, hit_v, wrd: V3):
    """Fat-row scatter + emission on V3 state (ray_gen.glsl:328-440)."""
    mat_type = rows[:, 0].astype(jnp.int32)

    state, fuzz_unit = rng.random_unit_v3(state)
    state, diel_u = rng.random_float(state)

    albedo = eval_albedo_v3(flags, scene, rows, p, hit_u, hit_v)
    fuzz = _rowv3(rows, 5)

    is_lamb = mat_type == MAT_TYPE_LAMBERTIAN
    is_metal = mat_type == MAT_TYPE_METAL
    is_diel = mat_type == MAT_TYPE_DIELECTRIC
    is_light = mat_type == MAT_TYPE_DIFFUSE_LIGHT

    # metal (ray_gen.glsl:344-364)
    reflected = vec3.reflect(wrd, normal)
    metal_scatters = vec3.dot(reflected, normal) > 0.0
    refl_unit = vec3.normalize(reflected)
    metal_dir = refl_unit + fuzz * fuzz_unit

    # dielectric (ray_gen.glsl:366-399)
    ref_idx = rows[:, 1]
    ri = jnp.where(front_face, 1.0 / jnp.where(ref_idx == 0.0, 1.0, ref_idx), ref_idx)
    unit_dir = vec3.normalize(wrd)
    cos_theta = jnp.minimum(-vec3.dot(unit_dir, normal), 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    cannot_refract = (ri * sin_theta > 1.0) | (schlick_reflectance(cos_theta, ri) > diel_u)
    diel_dir = vec3.where(
        cannot_refract,
        vec3.reflect(unit_dir, normal),
        vec3.refract(unit_dir, normal, ri),
    )

    ones = jnp.ones_like(ref_idx)
    zero = V3(jnp.zeros_like(ones), jnp.zeros_like(ones), jnp.zeros_like(ones))
    is_scattered = is_lamb | is_diel | (is_metal & metal_scatters)
    attenuation = vec3.where(
        is_lamb | is_metal, albedo,
        vec3.where(is_diel, V3(ones, ones, ones), zero),
    )
    skip_pdf = is_metal | is_diel
    skip_dir = vec3.where(is_metal, metal_dir, vec3.where(is_diel, diel_dir, zero))
    mat_pdf_type = jnp.where(is_lamb, COSINE_PDF, NO_PDF).astype(jnp.int32)

    srec = ScatterV3(
        is_scattered=is_scattered, attenuation=attenuation,
        mat_pdf_type=mat_pdf_type, skip_pdf=skip_pdf, skip_dir=skip_dir,
    )

    if flags.has_emissive:
        emit = eval_emit_v3(flags, scene, rows, p, hit_u, hit_v)
        gate = is_light & front_face
        emission = vec3.where(gate, emit, zero)
    else:
        emission = zero
    return state, srec, emission
