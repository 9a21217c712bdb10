"""Fat-row shading path must agree exactly with the registry path."""

import copy

import numpy as np
import pytest

from raytrace_tpu.models import compile_scene
from raytrace_tpu.models.compile import MAT_TYPE_LAMBERTIAN, MAT_TYPE_METAL
from raytrace_tpu.scene_file import SceneFile
from raytrace_tpu.engine import Renderer
from conftest import reference_asset


def _render_both(asset, w=24, spp=4, batches=1):
    sf = SceneFile.load_json(reference_asset(asset))
    sf.render.samples_per_pixel = spp
    sf.render.sample_batches = batches
    sf.render.max_ray_depth = 6
    h = max(1, int(w / sf.render.aspect_ratio))
    cs = compile_scene(sf, width=w, height=h)
    assert cs.shade_rows is not None, "expected fat rows for shipped scenes"
    img_fat = Renderer(cs).render_all()

    cs2 = copy.copy(cs)
    cs2.shade_rows = None  # force the registry path
    img_reg = Renderer(cs2).render_all()
    return img_fat, img_reg


@pytest.mark.parametrize("asset", [
    "triangle.json",          # checker albedo
    "diffuse-spheres.json",   # checker + constants
    "metal-spheres.json",     # metal albedo + fuzz
    "dielectric-spheres.json",
    "cornell-box.json",       # emissive + NEE
    "perlin-spheres.json",    # noise albedo
    "simple-light.json",      # sphere light + noise
])
def test_fat_equals_registry(asset):
    a, b = _render_both(asset)
    np.testing.assert_allclose(a, b, atol=2e-5)


def test_rows_content_final_scene():
    sf = SceneFile.load_json(reference_asset("final-one-weekend.json"))
    cs = compile_scene(sf, width=8, height=8)
    rows = cs.shade_rows
    s_pad = cs.sph_center.shape[0]
    # Ground sphere row: lambertian with checker albedo.
    ground = rows[0]
    assert ground[0] == MAT_TYPE_LAMBERTIAN
    assert ground[11] == 2.0  # MODE_CHECKER
    assert ground[17] == pytest.approx(0.32)
    np.testing.assert_allclose(ground[18:21], [0.2, 0.3, 0.1], atol=1e-6)
    np.testing.assert_allclose(ground[21:24], [0.9, 0.9, 0.9], atol=1e-6)
    # Hero metal sphere: albedo .7/.6/.5, fuzz 0.  Spheres keep file
    # order (tools order ground/grid/heroes), so the metal hero is the
    # last sphere row.
    assert cs.num_spheres == 488
    hero3 = rows[cs.num_spheres - 1]
    assert hero3[0] == MAT_TYPE_METAL
    np.testing.assert_allclose(hero3[2:5], [0.7, 0.6, 0.5], atol=1e-6)
    np.testing.assert_allclose(hero3[5:8], 0.0, atol=1e-6)
