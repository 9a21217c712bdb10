"""Scene sharding ("sc" mesh axis): primitive tables row-sharded across
devices, per-bounce closest-hit pmin combine + one-owner fat-row psum
(engine/wavefront._sc_combine_hit/_sc_fetch).  The sharded render must be
BIT-IDENTICAL to the replicated-scene render: the combine's global-id tie
order equals the sweep order, and every psum has exactly one nonzero
term, so no float reduction differs.
"""
import numpy as np
import pytest

import jax

from conftest import reference_asset
from raytrace_tpu.models import compile_scene
from raytrace_tpu.parallel import MultiChipRenderer, make_mesh
from raytrace_tpu.scene_file import SceneFile


def _tiny(name, width=32, spp=4, batches=2, depth=4):
    if name == "quad-box":
        from raytrace_tpu.tools import generate_quad_box_scene

        sf = generate_quad_box_scene()
    else:
        sf = SceneFile.load_json(reference_asset(name))
    sf.render.samples_per_pixel = spp
    sf.render.sample_batches = batches
    sf.render.max_ray_depth = depth
    h = max(8, int(width / sf.render.aspect_ratio))
    return compile_scene(sf, width=width, height=h)


def _render_pair(name, **kw):
    devices = jax.devices()[:8]
    cs = _tiny(name, **kw)
    # same ("px","sp") extents on both sides (px=2, sp=2) so the padded
    # row blocks — and hence the exact ray counts — match
    rep = MultiChipRenderer(cs, mesh=make_mesh(devices[:4], sp=2))
    shd = MultiChipRenderer(cs, mesh=make_mesh(devices, sp=2, sc=2))
    assert shd.static.scene_axis == "sc" and shd.static.scene_shards == 2
    rep_img = rep.render_all()
    shd_img = shd.render_all()
    assert rep.rays_traced == shd.rays_traced
    return rep_img, shd_img


def test_scene_sharded_spheres_bitwise():
    """488 world-mode spheres sharded 2-ways (XLA sweep path)."""
    rep, shd = _render_pair("final-one-weekend.json")
    np.testing.assert_array_equal(rep, shd)


def test_scene_sharded_triangles_nee_bitwise():
    """Quad box: triangle soup sharded 2-ways with NEE lights
    (brute-force tri sweep, non-packed attribute path)."""
    rep, shd = _render_pair("quad-box", width=24, spp=4,
                            batches=1, depth=4)
    np.testing.assert_array_equal(rep, shd)


@pytest.mark.slow
def test_scene_sharded_mixed_families():
    """Spheres + triangles + light in one scene: the cross-family merge
    and family-aware shade_rows split.  Paths are identical (equal ray
    counts, asserted in _render_pair) but a few perlin-textured pixels
    differ at the ULP level: XLA fuses the psum-fed noise polynomial
    with different float contractions than the plain-gather program."""
    rep, shd = _render_pair("simple-light.json", width=24, spp=4,
                            batches=1, depth=4)
    np.testing.assert_allclose(rep, shd, rtol=0.0, atol=1e-6)
    assert np.abs(rep - shd).max() <= 1e-6


@pytest.mark.slow
def test_scene_sharded_three_way_dup_padding():
    """sc=3 (px=2, sp=1 on 6 devices): 488 % 3 != 0, so _pad_dup
    actually pads — the duplicate-at-higher-id-never-wins argument gets
    real coverage (sc in {2,4,8} divides every compile-padded family)."""
    devices = jax.devices()[:8]
    cs = _tiny("final-one-weekend.json", width=24, spp=4, batches=1)
    rep = MultiChipRenderer(cs, mesh=make_mesh(devices[:2], sp=1))
    shd = MultiChipRenderer(cs, mesh=make_mesh(devices[:6], sp=1, sc=3))
    np.testing.assert_array_equal(rep.render_all(), shd.render_all())


@pytest.mark.slow
def test_scene_sharded_four_way():
    """sc=4 (px=2, sp=1): the deepest committed shard count."""
    devices = jax.devices()[:8]
    cs = _tiny("final-one-weekend.json", width=24, spp=4, batches=1)
    rep = MultiChipRenderer(cs, mesh=make_mesh(devices[:2], sp=1))
    shd = MultiChipRenderer(cs, mesh=make_mesh(devices, sp=1, sc=4))
    rep_img = rep.render_all()
    shd_img = shd.render_all()
    np.testing.assert_array_equal(rep_img, shd_img)


@pytest.mark.slow
def test_cli_scene_sharded_render(tmp_path):
    """End-to-end: `render --multichip --scene-shards 2` through the CLI
    writes the same PNG as the replicated multichip render."""
    from raytrace_tpu.cli import main

    scene = reference_asset("final-one-weekend.json")
    out_a = tmp_path / "rep.png"
    out_b = tmp_path / "sc.png"
    assert main(["render", "--path", scene, "--width", "24",
                 "--multichip", "-o", str(out_a)]) == 0
    assert main(["render", "--path", scene, "--width", "24",
                 "--multichip", "--scene-shards", "2",
                 "-o", str(out_b)]) == 0
    from raytrace_tpu.utils.image import decode_png

    a = decode_png(out_a.read_bytes())
    b = decode_png(out_b.read_bytes())
    np.testing.assert_array_equal(a, b)


def test_scene_sharded_rejects_bvh():
    cs = _tiny("quad-box", width=16, spp=1, batches=1, depth=2)
    devices = jax.devices()[:8]
    with pytest.raises(ValueError, match="BVH"):
        MultiChipRenderer(cs, mesh=make_mesh(devices, sp=2, sc=2),
                          use_bvh=True)
