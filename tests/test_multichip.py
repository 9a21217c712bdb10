"""Multi-device sharding tests on the 8-device virtual CPU mesh: the
sharded render must match the single-device render exactly (same RNG
streams, float reduction order aside)."""

import numpy as np
import jax
import pytest

from raytrace_tpu.models import compile_scene
from raytrace_tpu.scene_file import SceneFile
from raytrace_tpu.engine import Renderer
from raytrace_tpu.parallel import MultiChipRenderer, make_mesh
from conftest import reference_asset


@pytest.fixture(scope="module")
def small_scene():
    sf = SceneFile.load_json(reference_asset("final-one-weekend.json"))
    sf.render.samples_per_pixel = 4
    sf.render.sample_batches = 2
    sf.render.max_ray_depth = 6
    return compile_scene(sf, width=32, height=18)


def test_mesh_construction():
    mesh = make_mesh()
    assert mesh.shape["px"] * mesh.shape["sp"] == len(jax.devices())
    mesh41 = make_mesh(sp=1)
    assert mesh41.shape["sp"] == 1


@pytest.mark.parametrize("sp", [
    pytest.param(1, marks=pytest.mark.slow),
    2,
    pytest.param(4, marks=pytest.mark.slow),
])
def test_sharded_matches_single_chip(small_scene, sp):
    single = Renderer(small_scene).render_all()
    multi = MultiChipRenderer(small_scene, mesh=make_mesh(sp=sp)).render_all()
    np.testing.assert_allclose(multi, single, atol=2e-5)


def test_rays_counted_across_shards(small_scene):
    r = MultiChipRenderer(small_scene, mesh=make_mesh(sp=2))
    r.render_next_batch()
    # At least one primary ray per sample.
    assert r.rays_traced >= 32 * 18 * 4


def test_full_mesh_axes_used(small_scene):
    mesh = make_mesh(sp=2)
    r = MultiChipRenderer(small_scene, mesh=mesh)
    img = r.render_all()
    assert img.shape == (18, 32, 3)
    assert np.isfinite(img).all()


def test_checkpoint_resume_matches(tmp_path, small_scene):
    """Interrupt + resume must be byte-identical to a straight-through
    render; checkpoints interoperate with the single-chip Renderer."""
    ck = str(tmp_path / "ck.npz")
    mesh = make_mesh(sp=2)

    r1 = MultiChipRenderer(small_scene, mesh=mesh)
    r1.render_next_batch()
    r1.save_checkpoint(ck)

    r2 = MultiChipRenderer(small_scene, mesh=mesh)
    r2.load_checkpoint(ck)
    assert r2.current_batch == 1
    img_resumed = r2.render_all()

    img_straight = MultiChipRenderer(small_scene, mesh=mesh).render_all()
    np.testing.assert_array_equal(img_resumed, img_straight)

    # Cross-renderer resume: single-chip continues a multichip checkpoint.
    r3 = Renderer(small_scene)
    r3.load_checkpoint(ck)
    assert r3.current_batch == 1
    img_cross = r3.render_all()
    np.testing.assert_allclose(img_cross, img_straight, atol=2e-5)


def test_metrics_and_stats_recorded(small_scene, tmp_path):
    jl = str(tmp_path / "metrics.jsonl")
    r = MultiChipRenderer(small_scene, mesh=make_mesh(sp=2),
                          metrics_jsonl=jl)
    r.render_all()
    assert r.stats.batches_done == 2
    assert r.stats.rays_traced > 0
    assert r.stats.mrays_per_sec > 0
    import json

    lines = [json.loads(l) for l in open(jl)]
    assert len(lines) == 2
    assert lines[0]["rays"] > 0


def test_bvh_passthrough():
    """--multichip with mesh geometry must honor use_bvh (round 1 silently
    brute-forced); sharded BVH render matches single-chip BVH render."""
    from raytrace_tpu.tools import generate_quad_box_scene

    sf = generate_quad_box_scene(samples_per_pixel=4, sample_batches=1,
                                 max_ray_depth=4)
    cs = compile_scene(sf, width=32, height=32)

    single = Renderer(cs, use_bvh=True).render_all()
    r = MultiChipRenderer(cs, mesh=make_mesh(sp=2), use_bvh=True)
    assert r.bvh is not None
    multi = r.render_all()
    np.testing.assert_allclose(multi, single, atol=2e-5)


def test_weak_scaling_shapes():
    """Fixed per-device work from 1 to 8 devices: the sharded step must
    compile and agree with the single-chip result at every mesh size (a
    virtual-CPU functional stand-in for the weak-scaling curve)."""
    sf = SceneFile.load_json(reference_asset("final-one-weekend.json"))
    sf.render.samples_per_pixel = 4
    sf.render.sample_batches = 1
    sf.render.max_ray_depth = 4
    cs = compile_scene(sf, width=32, height=32)
    want = Renderer(cs).render_all()
    for n_dev in (1, 2, 4, 8):
        from jax.sharding import Mesh

        devs = np.asarray(jax.devices()[:n_dev]).reshape(n_dev, 1)
        mesh = Mesh(devs, axis_names=("px", "sp"))
        got = MultiChipRenderer(cs, mesh=mesh).render_all()
        np.testing.assert_allclose(got, want, atol=2e-5)


# ---------------------------------------------------------------------------
# Sharded path with the Pallas-Triton sweeps (interpret mode on the virtual
# CPU mesh): the kernels run inside shard_map exactly as on the cards.

def test_sharded_triton_sweep_matches_single_chip(small_scene):
    single = Renderer(small_scene, use_pallas_sweep=True,
                      pallas_interpret=True)
    assert single.static.use_pallas_sweep
    ref = single.render_all()

    multi = MultiChipRenderer(small_scene, mesh=make_mesh(sp=2),
                              use_pallas_sweep=True, pallas_interpret=True)
    assert multi.static.use_pallas_sweep
    np.testing.assert_allclose(multi.render_all(), ref, atol=2e-5)
