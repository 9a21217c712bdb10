"""BVH build + traversal tests: structure invariants and exact agreement
with the brute-force oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from raytrace_tpu.models import compile_scene
from raytrace_tpu.models.bvh_build import BIG, build_bvh, permute_soup, world_triangle_bounds
from raytrace_tpu.ops import intersect
from raytrace_tpu.ops.bvh import make_bvh_trace_fn
from raytrace_tpu.scene_file import SceneFile
from raytrace_tpu.engine import Renderer
from conftest import reference_asset


def _random_soup_scene(n_tris=333, seed=0):
    """A fake CompiledScene-like namespace with a random static soup."""
    rs = np.random.default_rng(seed)
    import types

    T = -(-n_tris // 256) * 256
    tri_p = np.zeros((T, 3, 3), np.float32)
    centers = rs.uniform(-10, 10, (n_tris, 1, 3))
    tri_p[:n_tris] = centers + rs.normal(0, 0.7, (n_tris, 3, 3))
    return types.SimpleNamespace(
        tri_p=tri_p,
        tri_n=np.zeros_like(tri_p),
        tri_uv=np.zeros((T, 3, 2), np.float32),
        tri_inst=np.zeros(T, np.int32),
        tri_mat_type=np.zeros(T, np.int32),
        tri_mat_index=np.zeros(T, np.int32),
        num_triangles=n_tris,
        inst_t0=np.array([[0, 0, 0, 0, 0, 0, 1, 1, 1, 1]], np.float32),
        inst_t1=np.array([[0, 0, 0, 0, 0, 0, 1, 1, 1, 1]], np.float32),
        any_animated=False,
    )


class TestBuild:
    def test_structure(self):
        cs = _random_soup_scene(100)
        bvh = build_bvh(cs, leaf_size=4)
        assert bvh.num_leaves & (bvh.num_leaves - 1) == 0  # power of two
        assert bvh.num_leaves * bvh.leaf_size >= 100
        assert bvh.child_boxes.shape == (bvh.num_leaves - 1, 16)
        # Permutation covers all real triangles exactly once.
        real = bvh.order[bvh.order >= 0]
        assert sorted(real.tolist()) == list(range(100))

    def test_root_bounds_everything(self):
        cs = _random_soup_scene(200, seed=3)
        bvh = build_bvh(cs, leaf_size=4)
        mn = np.minimum(bvh.child_boxes[0, 0:3], bvh.child_boxes[0, 6:9])
        mx = np.maximum(bvh.child_boxes[0, 3:6], bvh.child_boxes[0, 9:12])
        pts = cs.tri_p[:200].reshape(-1, 3)
        assert (pts >= mn - 1e-4).all() and (pts <= mx + 1e-4).all()

    def test_animated_bounds_cover_endpoints(self):
        sf = SceneFile.load_json(reference_asset("earth-motion-blur.json"))
        cs = compile_scene(sf, width=8, height=8, analytic_spheres=False)
        mn, mx = world_triangle_bounds(cs)
        n = cs.num_triangles
        # Bounds at t=0 and t=1 must be inside the conservative interval.
        from raytrace_tpu.models.bvh_build import _instance_matrix_at

        for t in (0.0, 1.0):
            m = _instance_matrix_at(cs.inst_t0, cs.inst_t1, t)[cs.tri_inst[:n]]
            wp = np.einsum("tij,tvj->tvi", m[:, :, :3], cs.tri_p[:n].astype(np.float64)) + m[:, None, :, 3]
            assert (wp.min(axis=1) >= mn[:n] - 1e-3).all()
            assert (wp.max(axis=1) <= mx[:n] + 1e-3).all()


class TestTraversal:
    @pytest.mark.parametrize("n_tris", [5, 64, 333, 1000])
    def test_matches_brute_force(self, n_tris):
        cs = _random_soup_scene(n_tris, seed=n_tris)
        bvh = build_bvh(cs, leaf_size=4)
        csp = permute_soup(cs, bvh)

        rs = np.random.default_rng(99)
        R = 256
        o = rs.uniform(-15, 15, (R, 3)).astype(np.float32)
        d = rs.normal(size=(R, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)

        world = jnp.asarray(csp.tri_p)
        trace = make_bvh_trace_fn(
            jnp.asarray(bvh.child_boxes), bvh.num_leaves, bvh.leaf_size,
            bvh.depth + 2, world,
        )
        hb = trace(jnp.asarray(o), jnp.asarray(d), jnp.ones(R, bool))
        href = intersect.intersect_brute_force(
            jnp.asarray(o), jnp.asarray(d), world
        )
        np.testing.assert_allclose(np.asarray(hb.t), np.asarray(href.t), rtol=1e-5)
        # Same triangle except exact-tie cases.
        same = np.asarray(hb.tri) == np.asarray(href.tri)
        assert same.mean() > 0.99
        miss_b = np.asarray(hb.tri) < 0
        miss_r = np.asarray(href.tri) < 0
        np.testing.assert_array_equal(miss_b, miss_r)

    def test_inactive_rays_stay_missed(self):
        cs = _random_soup_scene(64, seed=1)
        bvh = build_bvh(cs, leaf_size=4)
        csp = permute_soup(cs, bvh)
        world = jnp.asarray(csp.tri_p)
        trace = make_bvh_trace_fn(
            jnp.asarray(bvh.child_boxes), bvh.num_leaves, bvh.leaf_size,
            bvh.depth + 2, world,
        )
        o = jnp.zeros((8, 3)); d = jnp.tile(jnp.asarray([0.0, 0, 1]), (8, 1))
        alive = jnp.asarray([True, False] * 4)
        hit = trace(o, d, alive)
        assert (np.asarray(hit.tri)[~np.asarray(alive)] == -1).all()


class TestSAH:
    @pytest.mark.parametrize("n_tris", [5, 64, 1000])
    def test_matches_brute_force(self, n_tris):
        from raytrace_tpu.models.bvh_build import build_bvh_sah
        from raytrace_tpu.ops.bvh import BVHArrays, pack_world_tris, traverse_sah

        cs = _random_soup_scene(n_tris, seed=n_tris + 7)
        bvh = build_bvh_sah(cs, leaf_max=8)
        if bvh is None:
            pytest.skip("native builder unavailable")
        assert bvh.mode == "sah"
        csp = permute_soup(cs, bvh)

        rs = np.random.default_rng(5)
        R = 256
        o = rs.uniform(-15, 15, (R, 3)).astype(np.float32)
        d = rs.normal(size=(R, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)

        world = jnp.asarray(csp.tri_p)
        v0, e1, e2 = pack_world_tris(world)
        hb = traverse_sah(
            BVHArrays(jnp.asarray(bvh.child_boxes), v0, e1, e2),
            bvh.root, bvh.leaf_size, bvh.depth + 2,
            jnp.asarray(o), jnp.asarray(d), active=jnp.ones(R, bool),
        )
        href = intersect.intersect_brute_force(jnp.asarray(o), jnp.asarray(d), world)
        np.testing.assert_allclose(np.asarray(hb.t), np.asarray(href.t), rtol=1e-5)
        np.testing.assert_array_equal(
            np.asarray(hb.tri) < 0, np.asarray(href.tri) < 0
        )
        assert (np.asarray(hb.tri) == np.asarray(href.tri)).mean() > 0.99

    def test_obj_scene_renders_with_sah(self, tmp_path):
        """OBJ mesh import + SAH BVH end-to-end."""
        from raytrace_tpu.scene_file import (
            ConstantTexture, Instance, Lambertian, ObjMesh, PerspectiveCamera,
            Render, SceneFile as SF, SolidSky,
        )
        from raytrace_tpu.engine import Renderer

        sf = SF(
            cameras=[PerspectiveCamera(name="c", eye=[0, 0, 5], look_at=[0, 0, 0],
                                       up=[0, 1, 0], fov_y=40, z_near=0.01,
                                       z_far=100, focal_length=1, aperture_size=0)],
            textures=[ConstantTexture(name="w", rgb=[0.7, 0.7, 0.7])],
            materials=[Lambertian(name="m", albedo="w")],
            primitives=[ObjMesh(name="mesh",
                                path=reference_asset("obj/sphere-smooth.obj"),
                                material="m")],
            instances=[Instance(name="mesh")],
            sky=SolidSky(rgb=[1.0, 1.0, 1.0]),
            render=Render(camera="c", samples_per_pixel=4, sample_batches=1,
                          max_ray_depth=5, aspect_ratio=1.0),
        )
        cs = compile_scene(sf, width=32, height=32)
        r_bvh = Renderer(cs, use_bvh=True)
        img_bvh = r_bvh.render_all()
        img_brute = Renderer(cs, use_bvh=False).render_all()
        np.testing.assert_allclose(img_bvh, img_brute, atol=1e-4)
        # Object visible in the center.
        assert img_bvh[16, 16].mean() < 0.98


class TestRendererIntegration:
    def _render_both(self, asset, width=24, height=24, spp=4):
        sf = SceneFile.load_json(reference_asset(asset))
        sf.render.samples_per_pixel = spp
        sf.render.sample_batches = min(sf.render.sample_batches, 2)
        cs = compile_scene(sf, width=width, height=height)
        img_bvh = Renderer(cs, use_bvh=True).render_all()
        img_brute = Renderer(cs, use_bvh=False).render_all()
        return img_bvh, img_brute

    def test_triangle_scene_identical(self):
        a, b = self._render_both("triangle.json")
        np.testing.assert_allclose(a, b, atol=1e-5)

    def test_quads_scene_identical(self):
        a, b = self._render_both("quads.json")
        np.testing.assert_allclose(a, b, atol=1e-5)

    def test_cornell_identical(self):
        a, b = self._render_both("cornell-box.json", spp=1)
        # Edge-tie pixels can differ; the overwhelming majority must match.
        close = np.isclose(a, b, atol=1e-4).mean()
        assert close > 0.995
