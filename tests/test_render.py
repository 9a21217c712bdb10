"""End-to-end render tests (CPU, small resolutions).

The reference has no reference images, so correctness rests on physics:
- exact sky colours for miss rays (deterministic),
- a furnace test: a white lambertian enclosure under a unit-white sky must
  converge to 1.0 everywhere (validates cosine sampling + throughput math),
- emissive + NEE sanity on a mini cornell box,
- progressive accumulation equivalence: N batches of K samples == mean of
  the per-batch images.
"""

import numpy as np
import pytest

from raytrace_tpu.models import compile_scene
from raytrace_tpu.scene_file import (
    Box,
    ConstantTexture,
    DiffuseLight,
    Instance,
    Lambertian,
    Metal,
    Dielectric,
    PerspectiveCamera,
    Quad,
    Render,
    SceneFile,
    SolidSky,
    Triangle,
    UvSphere,
    VerticalGradientSky,
)
from raytrace_tpu.engine import Renderer


def make_scene(textures, materials, primitives, instances, sky,
               spp=4, batches=1, depth=8, eye=(0, 0, 1), look_at=(0, 0, 0),
               fov=90.0, aspect=1.0):
    return SceneFile(
        cameras=[PerspectiveCamera(
            name="cam", eye=list(eye), look_at=list(look_at), up=[0, 1, 0],
            fov_y=fov, z_near=0.01, z_far=100.0, focal_length=1.0,
            aperture_size=0.0,
        )],
        textures=textures,
        materials=materials,
        primitives=primitives,
        instances=instances,
        sky=sky,
        render=Render(camera="cam", samples_per_pixel=spp, sample_batches=batches,
                      max_ray_depth=depth, aspect_ratio=aspect),
    )


def test_sky_only_exact():
    scene = make_scene(
        [ConstantTexture(name="w", rgb=[1, 1, 1])],
        [Lambertian(name="m", albedo="w")],
        [Triangle(name="t", points=[[100, 100, -50], [101, 100, -50], [100, 101, -50]],
                  normal=[0, 0, 1], uv=[[0, 0], [1, 0], [0, 1]], material="m")],
        [Instance(name="t")],
        VerticalGradientSky(factor=0.25, top=[0.2, 0.4, 0.8], bottom=[1, 1, 1]),
        spp=1,
    )
    r = Renderer(compile_scene(scene, width=16, height=16))
    img = r.render_all()
    # Quirk: gradient sky == mix(top, bottom, factor), direction-independent.
    expected = np.array([0.2, 0.4, 0.8]) * 0.75 + np.array([1, 1, 1]) * 0.25
    np.testing.assert_allclose(img[0, 0], expected, atol=1e-6)
    np.testing.assert_allclose(img, np.broadcast_to(expected, (16, 16, 3)), atol=1e-6)


def test_furnace_white_enclosure():
    """Camera inside a big white lambertian sphere under unit sky: every
    pixel must converge to 1 (all paths eventually escape... here the sphere
    is closed, so radiance = sum of throughput*sky at escape through depth
    cutoff; with albedo 1 the estimator is exactly 1 per path segment that
    reaches the sky.  Instead we use a white HALF-space: a huge white sphere
    below, sky above; energy conservation bounds pixels in [sky*albedo^k, 1]."""
    scene = make_scene(
        [ConstantTexture(name="w", rgb=[1.0, 1.0, 1.0])],
        [Lambertian(name="m", albedo="w")],
        [UvSphere(name="s", center=[0, 1001, 0], radius=1000.0, rings=16,
                  segments=32, material="m")],
        [Instance(name="s")],
        SolidSky(rgb=[1.0, 1.0, 1.0]),
        spp=16, batches=2, depth=24, eye=(0, -2, 8), look_at=(0, 0, 0), fov=60,
    )
    r = Renderer(compile_scene(scene, width=20, height=20))
    img = r.render_all()
    # Perfect white diffuse + white sky = radiance exactly 1 everywhere
    # (up to MC noise and the depth-50 cutoff).
    assert img.mean() == pytest.approx(1.0, abs=0.02)
    # Silhouette pixels can trap paths inside the tessellated sphere (shading
    # normal vs geometric face), losing energy at the depth cutoff — the
    # reference behaves identically.  Require the bulk of pixels exact.
    assert (np.abs(img - 1.0) < 1e-3).mean() > 0.9


def test_lambertian_half_albedo_ground():
    """Grey ground (albedo 0.5) under unit sky: looking straight down the
    pixel estimates 0.5 * 1 = 0.5 after one bounce (plus higher-order terms
    bounded by 0.5^k * interreflection).  For a flat plane all secondary
    rays hit the sky, so the answer is exactly 0.5."""
    scene = make_scene(
        [ConstantTexture(name="g", rgb=[0.5, 0.5, 0.5])],
        [Lambertian(name="m", albedo="g")],
        [Quad(name="q", points=[[-50, 2, -50], [50, 2, -50], [50, 2, 50], [-50, 2, 50]],
              normal=[0, -1, 0], uv=[[0, 0], [1, 0], [1, 1], [0, 1]], material="m")],
        [Instance(name="q")],
        SolidSky(rgb=[1.0, 1.0, 1.0]),
        spp=64, batches=2, depth=10, eye=(0, 0, 0), look_at=(0.6, 2, 0), fov=40,
    )
    r = Renderer(compile_scene(scene, width=24, height=24))
    img = r.render_all()
    np.testing.assert_allclose(img.mean(axis=(0, 1)), 0.5, atol=0.01)


def test_metal_mirror_reflection():
    """Perfect mirror (fuzz 0) tilted 45° reflects a black sky region vs the
    emissive panel: check the mirror shows the panel's colour."""
    scene = make_scene(
        [
            ConstantTexture(name="white", rgb=[1, 1, 1]),
            ConstantTexture(name="zero", rgb=[0, 0, 0]),
            ConstantTexture(name="red", rgb=[4, 0.1, 0.1]),
        ],
        [
            Metal(name="mirror", albedo="white", fuzz="zero"),
            DiffuseLight(name="lamp", emit="red"),
        ],
        [
            # Mirror in the z=0 plane facing +z.
            Quad(name="mirror", points=[[-2, -2, 0], [2, -2, 0], [2, 2, 0], [-2, 2, 0]],
                 normal=[0, 0, 1], uv=[[0, 0], [1, 0], [1, 1], [0, 1]], material="mirror"),
            # Red emissive panel behind the camera.
            Quad(name="panel", points=[[-5, -5, 4], [5, -5, 4], [5, 5, 4], [-5, 5, 4]],
                 normal=[0, 0, -1], uv=[[0, 0], [1, 0], [1, 1], [0, 1]], material="lamp"),
        ],
        [Instance(name="mirror"), Instance(name="panel")],
        SolidSky(rgb=[0, 0, 0]),
        spp=4, depth=4, eye=(0, 0, 2), look_at=(0, 0, 0), fov=30,
    )
    r = Renderer(compile_scene(scene, width=16, height=16))
    img = r.render_all()
    center = img[8, 8]
    # Mirror reflects the panel: bright red.
    assert center[0] > 2.0 and center[0] > 10 * center[1]


def test_dielectric_straight_through():
    """A glass slab with ri=1.0 is optically absent: image equals sky."""
    scene = make_scene(
        [ConstantTexture(name="w", rgb=[1, 1, 1])],
        [Dielectric(name="glass", refraction_index=1.0)],
        [Box(name="slab", corners=[[-3, -3, -1], [3, 3, -0.5]], material="glass")],
        [Instance(name="slab")],
        SolidSky(rgb=[0.3, 0.5, 0.9]),
        spp=16, depth=16, eye=(0, 0, 1), look_at=(0, 0, -1), fov=40,
    )
    r = Renderer(compile_scene(scene, width=12, height=12))
    img = r.render_all()
    # ri=1 → schlick r0 = 0, sin constraint never triggers except grazing;
    # nearly all rays pass straight through.
    np.testing.assert_allclose(img.mean(axis=(0, 1)), [0.3, 0.5, 0.9], atol=0.02)


def test_emissive_seen_directly():
    scene = make_scene(
        [ConstantTexture(name="e", rgb=[2.0, 3.0, 4.0])],
        [DiffuseLight(name="lamp", emit="e")],
        [Quad(name="q", points=[[-3, -3, -2], [3, -3, -2], [3, 3, -2], [-3, 3, -2]],
              normal=[0, 0, 1], uv=[[0, 0], [1, 0], [1, 1], [0, 1]], material="lamp")],
        [Instance(name="q")],
        SolidSky(rgb=[0, 0, 0]),
        spp=4, depth=4, eye=(0, 0, 1), look_at=(0, 0, -1), fov=30,
    )
    r = Renderer(compile_scene(scene, width=8, height=8))
    img = r.render_all()
    # Front face emission, exact value, no noise (no scatter involved).
    np.testing.assert_allclose(img, np.broadcast_to([2, 3, 4], (8, 8, 3)), atol=1e-5)
    # Back face emits nothing (quirk #7): move camera behind.
    scene.cameras[0].eye = [0, 0, -5]
    scene.cameras[0].look_at = [0, 0, 0]
    r2 = Renderer(compile_scene(scene, width=8, height=8))
    img2 = r2.render_all()
    np.testing.assert_allclose(img2, 0.0, atol=1e-6)


def test_progressive_accumulation_is_running_mean():
    scene = make_scene(
        [ConstantTexture(name="g", rgb=[0.5, 0.6, 0.7])],
        [Lambertian(name="m", albedo="g")],
        [UvSphere(name="s", center=[0, 0, -3], radius=1.5, rings=8, segments=16,
                  material="m")],
        [Instance(name="s")],
        SolidSky(rgb=[0.8, 0.8, 1.0]),
        spp=4, batches=3, depth=5,
    )
    cs = compile_scene(scene, width=16, height=16)
    r = Renderer(cs)
    per_batch = []
    while r.render_next_batch():
        per_batch.append(r.image().copy())
    # accum after batch b = mean of batches 0..b rendered standalone.
    # Verify via the recurrence: a_b = (b*a_{b-1} + x_b)/(b+1)  =>  the
    # final accumulation equals the mean of the x_b's; reconstruct x_b.
    xs = [per_batch[0]]
    for b in range(1, len(per_batch)):
        xs.append((b + 1) * per_batch[b] - b * per_batch[b - 1])
    np.testing.assert_allclose(np.mean(xs, axis=0), per_batch[-1], atol=1e-4)
    # Batches differ (different RNG streams) but agree statistically.
    assert not np.allclose(xs[0], xs[1])


def test_checkpoint_resume(tmp_path):
    scene = make_scene(
        [ConstantTexture(name="g", rgb=[0.5, 0.6, 0.7])],
        [Lambertian(name="m", albedo="g")],
        [UvSphere(name="s", center=[0, 0, -3], radius=1.5, rings=8, segments=16,
                  material="m")],
        [Instance(name="s")],
        SolidSky(rgb=[0.9, 0.9, 0.9]),
        spp=1, batches=4, depth=4,
    )
    cs = compile_scene(scene, width=8, height=8)
    r1 = Renderer(cs)
    r1.render_next_batch()
    r1.render_next_batch()
    ckpt = str(tmp_path / "ck.npz")
    r1.save_checkpoint(ckpt)
    r1.render_next_batch()
    r1.render_next_batch()
    full = r1.image()

    r2 = Renderer(cs)
    r2.load_checkpoint(ckpt)
    assert r2.current_batch == 2
    r2.render_next_batch()
    r2.render_next_batch()
    np.testing.assert_allclose(r2.image(), full, atol=1e-6)


def test_triangle_asset_smoke():
    from conftest import reference_asset
    from raytrace_tpu.scene_file import SceneFile as SF

    sf = SF.load_json(reference_asset("triangle.json"))
    sf.render.samples_per_pixel = 4
    cs = compile_scene(sf, width=32, height=32)
    r = Renderer(cs)
    img = r.render_all()
    # Sky corners exact.
    expected_sky = np.array([0.5, 0.7, 1.0]) * 0.5 + np.array([1, 1, 1]) * 0.5
    np.testing.assert_allclose(img[0, 0], expected_sky, atol=1e-5)
    np.testing.assert_allclose(img[0, -1], expected_sky, atol=1e-5)
    # Triangle interior differs from sky.
    assert not np.allclose(img[20, 16], expected_sky, atol=0.05)
    assert r.stats.rays_traced > 32 * 32 * 4


def test_update_image_size_resets_accumulation():
    """Resize restarts progressive rendering (render_engine.rs:397-414)."""
    scene = make_scene(
        [ConstantTexture(name="g", rgb=[0.5, 0.6, 0.7])],
        [Lambertian(name="m", albedo="g")],
        [UvSphere(name="s", center=[0, 0, -3], radius=1.5, rings=8, segments=16,
                  material="m")],
        [Instance(name="s")],
        SolidSky(rgb=[0.9, 0.9, 0.9]),
        spp=1, batches=2, depth=4,
    )
    cs = compile_scene(scene, width=16, height=16)
    r = Renderer(cs)
    r.render_next_batch()
    r2 = r.update_image_size(24, 24)
    assert (r2.static.width, r2.static.height) == (24, 24)
    assert r2.current_batch == 0
    img = r2.render_all()
    assert img.shape == (24, 24, 3)


def test_camera_lookup_by_name():
    scene = make_scene(
        [ConstantTexture(name="g", rgb=[0.5, 0.5, 0.5])],
        [Lambertian(name="m", albedo="g")],
        [UvSphere(name="s", center=[0, 0, -3], radius=1.0, rings=4, segments=8,
                  material="m")],
        [Instance(name="s")],
        SolidSky(rgb=[1, 1, 1]),
        spp=1, batches=1, depth=2,
    )
    cs = compile_scene(scene, width=8, height=8)
    with pytest.raises(KeyError, match="not found"):
        Renderer(cs, camera_name="nope")
    Renderer(cs, camera_name="cam")  # by-name lookup works


def test_debug_validation_mode():
    """debug=True (the reference's validation-layer analogue,
    bin/src/app.rs:317-369): clean scenes pass every per-batch check and
    record counters; a poisoned accumulation trips DebugValidationError."""
    from raytrace_tpu.engine.renderer import DebugValidationError

    scene = make_scene(
        [ConstantTexture(name="g", rgb=[0.5, 0.6, 0.7])],
        [Lambertian(name="m", albedo="g")],
        [UvSphere(name="s", center=[0, 0, -3], radius=1.0, rings=4,
                  segments=8, material="m")],
        [Instance(name="s")],
        SolidSky(rgb=[1, 1, 1]),
        spp=2, batches=2, depth=4,
    )
    cs = compile_scene(scene, width=16, height=16)
    r = Renderer(cs, debug=True)
    img = r.render_all()
    assert np.isfinite(img).all()
    assert r.debug_stats.checks >= 2
    assert r.debug_stats.nonfinite_values == 0
    assert r.debug_stats.negative_values == 0
    assert 0.0 < r.debug_stats.max_radiance <= r.debug_stats.energy_bound

    # Poison the accumulation: the next batch's check must trip.
    import jax.numpy as jnp

    r2 = Renderer(cs, debug=True)
    r2.render_next_batch()
    bad = np.asarray(r2.accum).copy()
    bad[0, 0, 0] = np.nan
    r2.accum = jnp.asarray(bad)
    with pytest.raises(DebugValidationError, match="non-finite"):
        r2.render_next_batch()
