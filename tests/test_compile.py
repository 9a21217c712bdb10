"""Scene-compiler tests: every reference asset compiles to consistent SoA
arrays with the expected counts."""

import glob
import os

import numpy as np
import pytest

from raytrace_tpu.models import compile_scene
from raytrace_tpu.models.compile import (
    MAT_TYPE_DIFFUSE_LIGHT,
    MAT_TYPE_LAMBERTIAN,
    SKY_SOLID,
    SKY_VERTICAL_GRADIENT,
)
from raytrace_tpu.scene_file import SceneFile
from conftest import REFERENCE_ASSETS, reference_asset

ASSET_FILES = sorted(glob.glob(os.path.join(REFERENCE_ASSETS, "*.json")))


@pytest.fixture(scope="module")
def compiled():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = compile_scene(
                SceneFile.load_json(reference_asset(name))
            )
        return cache[name]

    return get


@pytest.mark.parametrize(
    "name", [os.path.basename(p) for p in ASSET_FILES if "final" not in p]
)
def test_compiles_consistently(compiled, name):
    cs = compiled(name)
    T = cs.tri_p.shape[0]
    assert T % 256 == 0 and cs.num_triangles <= T
    for a in (cs.tri_n, ):
        assert a.shape == (T, 3, 3)
    assert cs.tri_uv.shape == (T, 3, 2)
    assert cs.tri_inst.shape == (T,)
    if cs.num_triangles:
        assert cs.tri_inst[: cs.num_triangles].max() < cs.num_instances
    if cs.num_spheres:
        assert cs.sph_inst[: cs.num_spheres].max() < cs.num_instances
        assert (cs.sph_radius[: cs.num_spheres] > 0).all()
        assert (cs.sph_radius[cs.num_spheres:] == 0).all()
    assert cs.inst_t0.shape == (cs.num_instances, 10)
    # Quaternions are unit.
    np.testing.assert_allclose(
        np.linalg.norm(cs.inst_t0[:, 3:7], axis=1), 1.0, atol=1e-5
    )
    # Padded triangles are degenerate (all-zero -> never intersect).
    assert not cs.tri_p[cs.num_triangles:].any()


def test_triangle_scene(compiled):
    cs = compiled("triangle.json")
    assert cs.num_triangles == 1
    assert cs.num_instances == 1
    assert cs.light_count == 0
    assert cs.sky_type == SKY_VERTICAL_GRADIENT
    assert cs.tri_mat_type[0] == MAT_TYPE_LAMBERTIAN
    # checker referencing two constants
    assert cs.checker_scale.shape == (1,)
    assert len(cs.const_colours) == 2


def test_cornell_box(compiled):
    cs = compiled("cornell-box.json")
    assert cs.sky_type == SKY_SOLID
    np.testing.assert_allclose(cs.sky_solid, [0, 0, 0])
    # The ceiling light quad = 2 triangles.
    assert cs.light_count == 2
    assert cs.light_total_area > 0
    lights = cs.tri_mat_type[: cs.num_triangles] == MAT_TYPE_DIFFUSE_LIGHT
    assert lights.sum() == 2
    # Two boxes have static transforms, walls identity.
    assert cs.num_instances == 8
    assert not cs.any_animated


def test_final_one_weekend_scale():
    sf = SceneFile.load_json(reference_asset("final-one-weekend.json"))
    cs = compile_scene(sf)
    assert cs.num_instances == 488
    # Analytic mode: every uv_sphere is a closed-form sphere, no soup.
    assert cs.num_spheres == 488
    assert cs.num_triangles == 0
    cam = cs.cameras[cs.render.camera]
    assert cam.aperture_size > 0

    # Mesh-parity mode tessellates:
    # ground 65024 + 484 grid spheres x 3968 + 3 hero x 16128.
    cs2 = compile_scene(sf, analytic_spheres=False)
    assert cs2.num_triangles == 65024 + 484 * 3968 + 3 * 16128
    assert cs2.num_spheres == 0


def test_motion_blur_flags(compiled):
    cs = compiled("earth-motion-blur.json")
    assert cs.any_animated
    assert cs.inst_animated.sum() == 1
    # Animated rotation: start quat is identity, end is 5 deg about y.
    np.testing.assert_allclose(cs.inst_t0[0, 3:7], [0, 0, 0, 1], atol=1e-6)
    expected_w = np.cos(np.radians(2.5))
    np.testing.assert_allclose(abs(cs.inst_t1[0, 6]), expected_w, atol=1e-5)


def test_earth_atlas(compiled):
    cs = compiled("earth.json")
    assert cs.atlas.dtype == np.uint8
    assert cs.atlas.shape[0] == 1
    assert tuple(cs.atlas_wh[0]) == (5400, 2700)


def test_default_window_size(compiled):
    # width defaults to 1024 scaled by aspect ratio (app.rs:34, 141-148)
    cs = compiled("triangle.json")
    assert (cs.render.width, cs.render.height) == (1024, 1024)
    cs2 = compiled("cornell-box.json")
    assert cs2.render.width == 1024


def test_quads_scene(compiled):
    cs = compiled("quads.json")
    assert cs.num_triangles == 2 * len(
        [n for n in cs.mesh_names]
    )  # each quad = 2 tris
