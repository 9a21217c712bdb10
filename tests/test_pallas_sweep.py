"""Pallas-Triton sphere and triangle sweeps vs the plain XLA sweeps, in
interpret mode on the CPU: same hits, same images.  On the card the same
comparison runs at 2^20 rays in chip_smoke.py's kernels phase."""

import numpy as np
import jax.numpy as jnp
import pytest

from raytrace_tpu.engine import Renderer
from raytrace_tpu.models import compile_scene
from raytrace_tpu.ops import intersect
from raytrace_tpu.ops.intersect import T_MAX
from raytrace_tpu.ops.pallas_sweep import (
    BLOCK, CHUNK, intersect_spheres_pallas, pad_rays, pad_table8, table_rows,
)
from raytrace_tpu.ops.pallas_tri_sweep import (
    intersect_tris_pallas, pack_tri_table,
)
from raytrace_tpu.ops.spheres import intersect_spheres_world
from raytrace_tpu.ops.vec3 import from_rows
from raytrace_tpu.scene_file import SceneFile
from conftest import reference_asset


def _random_case(S, R, seed=0):
    rs = np.random.default_rng(seed)
    c = rs.uniform(-10, 10, (S, 3))
    r = rs.uniform(0.3, 2.0, S)
    table5 = np.zeros((S, 5), np.float32)
    table5[:, :3] = c
    table5[:, 3] = r
    table5[:, 4] = (c ** 2).sum(1) - r ** 2
    o = rs.uniform(-12, 12, (R, 3)).astype(np.float32)
    d = rs.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return table5, o, d


def _random_tris(n, T, R, seed=3):
    rs = np.random.default_rng(seed)
    tris = (rs.uniform(-8, 8, (n, 1, 3))
            + rs.normal(0, 1, (n, 3, 3))).astype(np.float32)
    world = np.zeros((T, 3, 3), np.float32)
    world[:n] = tris
    o = rs.uniform(-10, 10, (R, 3)).astype(np.float32)
    d = rs.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return world, o, d


def _assert_sphere_hits_agree(pal, ref):
    # The XLA sweep uses HIGHEST-precision dots, the kernel fuses FMAs:
    # grazing hits can flip by ~1e-4 relative.  Distances must agree to
    # 2e-3 rel; hit/miss classification may differ only on such tangents.
    np.testing.assert_allclose(
        np.asarray(pal.t), np.asarray(ref.t), rtol=2e-3, atol=1e-3
    )
    assert (np.asarray(pal.sph) == np.asarray(ref.sph)).mean() > 0.99
    assert (
        (np.asarray(pal.sph) < 0) == (np.asarray(ref.sph) < 0)
    ).mean() > 0.995


@pytest.mark.parametrize("S,R", [
    (3, 100), (21, 500),
    pytest.param(64, BLOCK, marks=pytest.mark.slow),
    pytest.param(100, BLOCK + 7, marks=pytest.mark.slow),
])
def test_matches_xla_sweep(S, R):
    table5, o, d = _random_case(S, R, seed=S)
    ref = intersect_spheres_world(jnp.asarray(o), jnp.asarray(d), jnp.asarray(table5))
    pal = intersect_spheres_pallas(
        jnp.asarray(o), jnp.asarray(d), pad_table8(jnp.asarray(table5)),
        interpret=True,
    )
    _assert_sphere_hits_agree(pal, ref)


def test_active_mask():
    table5, o, d = _random_case(8, 64)
    alive = jnp.asarray(np.arange(64) % 2 == 0)
    pal = intersect_spheres_pallas(
        jnp.asarray(o), jnp.asarray(d), pad_table8(jnp.asarray(table5)),
        active=alive, interpret=True,
    )
    assert (np.asarray(pal.sph)[~np.asarray(alive)] == -1).all()


def test_padding_tail():
    """A ray count that is not a multiple of BLOCK: the wrapper pads to
    whole programs, runs them, and returns exactly R results that match
    the XLA sweep (padding rays never leak into the output)."""
    R = 2 * BLOCK + 5
    table5, o, d = _random_case(13, R, seed=7)
    comps = pad_rays(from_rows(jnp.asarray(o)), from_rows(jnp.asarray(d)))
    assert all(c.shape == (3 * BLOCK,) for c in comps)
    np.testing.assert_array_equal(np.asarray(comps[3])[R:], 1.0)
    pal = intersect_spheres_pallas(
        jnp.asarray(o), jnp.asarray(d), pad_table8(jnp.asarray(table5)),
        interpret=True)
    assert pal.t.shape == (R,) and pal.sph.shape == (R,)
    ref = intersect_spheres_world(jnp.asarray(o), jnp.asarray(d),
                                  jnp.asarray(table5))
    _assert_sphere_hits_agree(pal, ref)


def test_all_inactive():
    """Every ray inactive: no hit survives, whatever the geometry."""
    table5, o, d = _random_case(21, 200, seed=5)
    alive = jnp.zeros((200,), bool)
    pal = intersect_spheres_pallas(
        jnp.asarray(o), jnp.asarray(d), pad_table8(jnp.asarray(table5)),
        active=alive, interpret=True)
    assert (np.asarray(pal.sph) == -1).all()
    assert (np.asarray(pal.t) == T_MAX).all()


@pytest.mark.parametrize("S", [1, 5, 8, 9, 488])
def test_non_power_of_two_table(S):
    """Triton block shapes are powers of two: the table pads to the next
    power of two (at least CHUNK rows) with rows that never hit, and the
    sweep over the padded table equals the XLA sweep over the real one."""
    rows = table_rows(S)
    assert rows >= max(S, CHUNK) and rows & (rows - 1) == 0
    assert rows < 2 * max(S, CHUNK)
    table5, o, d = _random_case(S, 150, seed=S + 11)
    t8 = pad_table8(jnp.asarray(table5))
    assert t8.shape == (rows, 8)
    np.testing.assert_array_equal(np.asarray(t8)[S:, 3], 0.0)
    assert (np.asarray(t8)[S:, 4] > 1e37).all()
    pal = intersect_spheres_pallas(jnp.asarray(o), jnp.asarray(d), t8,
                                   interpret=True)
    assert np.asarray(pal.sph).max() < S
    ref = intersect_spheres_world(jnp.asarray(o), jnp.asarray(d),
                                  jnp.asarray(table5))
    _assert_sphere_hits_agree(pal, ref)


def test_renderer_image_identical():
    sf = SceneFile.load_json(reference_asset("final-one-weekend.json"))
    sf.render.samples_per_pixel = 4
    sf.render.sample_batches = 1
    sf.render.max_ray_depth = 6
    cs = compile_scene(sf, width=48, height=27)
    img_ref = Renderer(cs, use_pallas_sweep=False).render_all()
    r = Renderer(cs, use_pallas_sweep=True, pallas_interpret=True)
    assert r.static.use_pallas_sweep and r.static.pallas_interpret
    img_pal = r.render_all()
    # A flipped near-tie hit reroutes that ray's whole path, so compare by
    # outlier share rather than a global atol.  The flagship's 484 small
    # spheres sit 0.035 deep in the ground sphere, so every contact ring
    # is a near-tie between two spheres: about 1 in 2e4 random rays picks
    # the other sphere of the pair when the two sweeps round differently,
    # and at 6 bounces x 4 spp that reaches ~1% of 48x27 pixels.  Every
    # other pixel is bitwise equal, and the image means agree.
    diff = np.abs(img_pal - img_ref).max(axis=-1)
    assert (diff > 2e-3).mean() < 0.02, f"{(diff > 2e-3).mean():.4%}"
    assert (diff == 0.0).mean() > 0.95
    np.testing.assert_allclose(img_pal.mean(), img_ref.mean(), rtol=2e-3)


class TestTriSweep:
    def test_matches_brute(self):
        world, o, d = _random_tris(37, 64, 200)
        tbl = pack_tri_table(jnp.asarray(world), 37)
        pal = intersect_tris_pallas(jnp.asarray(o), jnp.asarray(d), tbl, interpret=True)
        ref = intersect.intersect_brute_force(jnp.asarray(o), jnp.asarray(d), jnp.asarray(world))
        np.testing.assert_allclose(np.asarray(pal.t), np.asarray(ref.t), rtol=2e-3, atol=1e-3)
        assert (np.asarray(pal.tri) == np.asarray(ref.tri)).mean() > 0.99
        np.testing.assert_allclose(np.asarray(pal.u), np.asarray(ref.u), atol=2e-3)

    def test_padding_tail_and_inactive(self):
        """Non-multiple-of-BLOCK ray count, a non-power-of-two table, and
        an active mask: shapes come back at R, rows past the valid count
        never hit, inactive rays report misses."""
        R = BLOCK + 9
        world, o, d = _random_tris(20, 40, R, seed=9)
        tbl = pack_tri_table(jnp.asarray(world), 20)
        assert tbl.shape == (64, 16)
        assert (np.asarray(tbl)[20:, 9] == 0.0).all()
        alive = jnp.asarray(np.arange(R) % 3 != 0)
        pal = intersect_tris_pallas(jnp.asarray(o), jnp.asarray(d), tbl,
                                    active=alive, interpret=True)
        assert pal.t.shape == (R,) and pal.tri.shape == (R,)
        tri = np.asarray(pal.tri)
        assert (tri[~np.asarray(alive)] == -1).all()
        assert tri.max() < 20
        ref = intersect.intersect_brute_force(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(world[:20]),
            active=alive)
        assert (tri == np.asarray(ref.tri)).mean() > 0.99

    def test_cornell_image_identical(self):
        from raytrace_tpu.tools import generate_quad_box_scene

        sf = generate_quad_box_scene(samples_per_pixel=4, sample_batches=1,
                                     max_ray_depth=6)
        cs = compile_scene(sf, width=48, height=48)
        img_ref = Renderer(cs, use_pallas_sweep=False).render_all()
        img_pal = Renderer(cs, use_pallas_sweep=True,
                           pallas_interpret=True).render_all()
        bad = (np.abs(img_pal - img_ref) > 2e-3).any(axis=-1).mean()
        assert bad < 0.005, f"{bad:.4%} pixels differ"

    @pytest.mark.slow
    def test_mixed_scene_simple_light(self):
        sf = SceneFile.load_json(reference_asset("simple-light.json"))
        sf.render.samples_per_pixel = 4
        sf.render.sample_batches = 1
        sf.render.max_ray_depth = 6
        cs = compile_scene(sf, width=48, height=27)
        img_ref = Renderer(cs, use_pallas_sweep=False).render_all()
        img_pal = Renderer(cs, use_pallas_sweep=True,
                           pallas_interpret=True).render_all()
        # A flipped grazing hit reroutes that ray's whole path, so compare
        # by outlier count rather than a global atol.
        bad = (np.abs(img_pal - img_ref) > 2e-3).any(axis=-1).mean()
        assert bad < 0.005, f"{bad:.4%} pixels differ"
