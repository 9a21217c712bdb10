"""Tessellation, transform and alias-table unit tests (reference math:
mesh.rs, decomposed_transform.rs, light.rs)."""

import math

import numpy as np
import pytest

from raytrace_tpu.models import (
    build_alias_table,
    decompose_matrix,
    generate_box,
    generate_uv_sphere,
    quat_slerp,
    trs_to_matrix,
)
from raytrace_tpu.models.tessellate import generate_quad, generate_triangle, load_obj


class TestUvSphere:
    def test_counts(self):
        # rings=R, segments=S: pole rows have S verts, interior rows S+1.
        for rings, segments in [(2, 3), (4, 8), (32, 64)]:
            p, n, uv, idx = generate_uv_sphere([0, 0, 0], 1.0, rings, segments)
            expected_v = 2 * segments + (rings - 1) * (segments + 1)
            expected_t = segments * (2 * rings - 2)
            assert p.shape == (expected_v, 3)
            assert idx.shape == (expected_t * 3,)

    def test_on_sphere_and_normals(self):
        c = np.array([1.0, -2.0, 3.0])
        r = 2.5
        p, n, uv, idx = generate_uv_sphere(c, r, 8, 16)
        np.testing.assert_allclose(np.linalg.norm(p - c, axis=1), r, rtol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, rtol=1e-5)
        np.testing.assert_allclose(p, c + r * n, atol=1e-4)

    def test_pole_vertices(self):
        # Row 0 is the top pole (v=0 → phi=0 → n=(0,-1,0), y-down world).
        p, n, uv, idx = generate_uv_sphere([0, 0, 0], 1.0, 4, 8)
        np.testing.assert_allclose(n[:8], np.tile([0, -1, 0], (8, 1)), atol=1e-6)
        # u of pole row is shifted by du/2.
        du = 1.0 / 8
        np.testing.assert_allclose(uv[:8, 0], np.arange(8) * du + du / 2, atol=1e-6)

    def test_closed_manifold(self):
        """Every interior edge must be shared by exactly two triangles."""
        p, n, uv, idx = generate_uv_sphere([0, 0, 0], 1.0, 4, 8)
        # Weld seam vertices (u=0 and u=1 coincide spatially).
        key = {}
        remap = np.zeros(len(p), np.int64)
        for i, q in enumerate(np.round(p, 5)):
            k = tuple(q)
            remap[i] = key.setdefault(k, i)
        tris = remap[idx.reshape(-1, 3)]
        edges = {}
        for t in tris:
            for a, b in [(t[0], t[1]), (t[1], t[2]), (t[2], t[0])]:
                e = (min(a, b), max(a, b))
                edges[e] = edges.get(e, 0) + 1
        counts = set(edges.values())
        assert counts == {2}, f"non-manifold edge counts: {counts}"

    def test_index_layout_small(self):
        """rings=2, segments=3: top fan + bottom fan only (no quad rows)."""
        p, n, uv, idx = generate_uv_sphere([0, 0, 0], 1.0, 2, 3)
        assert len(p) == 3 + 4 + 3
        tris = idx.reshape(-1, 3)
        assert len(tris) == 6
        # Top fans reference row0 (0..2) and row1 (3..6).
        np.testing.assert_array_equal(tris[0], [0, 3, 4])
        np.testing.assert_array_equal(tris[3], [4, 3, 7])


class TestBox:
    def test_shape_and_bounds(self):
        p, n, uv, idx = generate_box([[1, 2, 3], [-1, -2, -3]])
        assert p.shape == (24, 3)
        assert idx.shape == (36,)
        np.testing.assert_allclose(p.min(axis=0), [-1, -2, -3])
        np.testing.assert_allclose(p.max(axis=0), [1, 2, 3])

    def test_faces_planar_and_axis_aligned(self):
        """Each triangle is coplanar perpendicular to its stored normal.
        (NOTE: winding does NOT consistently match stored normals in the
        reference tessellation — shading uses stored normals + the dot<0
        front-face rule, so we replicate rather than 'fix' the winding.)"""
        p, n, uv, idx = generate_box([[0, 0, 0], [1, 1, 1]])
        tris = idx.reshape(-1, 3)
        for t in tris:
            geo = np.cross(p[t[1]] - p[t[0]], p[t[2]] - p[t[0]])
            geo = geo / np.linalg.norm(geo)
            # Parallel or anti-parallel to the stored normal.
            assert abs(abs(np.dot(geo, n[t[0]])) - 1.0) < 1e-6

    def test_top_face_is_y_down(self):
        p, n, uv, idx = generate_box([[0, 0, 0], [1, 1, 1]])
        # Vertices 16..19 are the "top" face with normal (0,-1,0) at y=hy.
        np.testing.assert_allclose(n[16:20], np.tile([0, -1, 0], (4, 1)))
        np.testing.assert_allclose(p[16:20, 1], 1.0)


class TestQuadTriangle:
    def test_quad_two_triangles(self):
        pts = [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]]
        uvs = [[0, 0], [1, 0], [1, 1], [0, 1]]
        p, n, uv, idx = generate_quad(pts, [0, 0, 1], uvs)
        np.testing.assert_array_equal(idx, [0, 1, 2, 0, 2, 3])
        np.testing.assert_allclose(n, np.tile([0, 0, 1], (4, 1)))

    def test_triangle(self):
        p, n, uv, idx = generate_triangle(
            [[0, -1, 0], [-1, 1, 0], [1, 1, 0]], [0, 0, -1],
            [[0.5, 0], [0, 1], [1, 1]],
        )
        np.testing.assert_array_equal(idx, [0, 1, 2])
        assert p.shape == (3, 3)


class TestObj:
    def test_load_simple_obj(self, tmp_path):
        obj = tmp_path / "tri.obj"
        obj.write_text(
            "v 0 0 0\nv 1 0 0\nv 0 1 0\n"
            "vt 0 0\nvt 1 0\nvt 0 1\n"
            "vn 0 0 1\n"
            "f 1/1/1 2/2/1 3/3/1\n"
        )
        p, n, uv, idx = load_obj(str(obj))
        assert p.shape == (3, 3)
        np.testing.assert_allclose(n, np.tile([0, 0, 1], (3, 1)))
        # V flip: vt (1,0) becomes (1, 1.0-0) = (1,1)
        np.testing.assert_allclose(uv[1], [1, 1])

    def test_load_reference_obj(self):
        # The reference ships OBJ assets its loader never used; ours does.
        from conftest import reference_asset

        p, n, uv, idx = load_obj(reference_asset("obj/sphere-smooth.obj"))
        assert p.shape[0] > 100
        assert idx.shape[0] % 3 == 0
        np.testing.assert_allclose(
            np.linalg.norm(n, axis=1), 1.0, atol=1e-3
        )

    def test_quad_faces_fan_triangulated(self, tmp_path):
        obj = tmp_path / "quad.obj"
        obj.write_text(
            "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n"
        )
        p, n, uv, idx = load_obj(str(obj))
        assert p.shape == (6, 3)  # 2 triangles x 3 corners
        # Geometric normals filled in when no vn present.
        np.testing.assert_allclose(n, np.tile([0, 0, 1], (6, 1)), atol=1e-6)


class TestTransforms:
    def test_decompose_recompose(self):
        from raytrace_tpu.scene_file import Transform, Rotate

        tf = Transform(
            translate=[1, 2, 3], rotate=Rotate(axis=[0, 1, 0], degrees=30),
            scale=[2, 2, 2],
        )
        m = tf.to_matrix()
        d = decompose_matrix(m)
        np.testing.assert_allclose(d.translation, [1, 2, 3], atol=1e-6)
        np.testing.assert_allclose(d.scale, [2, 2, 2], atol=1e-6)
        np.testing.assert_allclose(d.to_matrix(), m, atol=1e-6)

    def test_slerp_midpoint(self):
        from raytrace_tpu.scene_file import Transform, Rotate

        t0 = decompose_matrix(Transform(rotate=Rotate(axis=[0, 1, 0], degrees=0)).to_matrix())
        t1 = decompose_matrix(Transform(rotate=Rotate(axis=[0, 1, 0], degrees=90)).to_matrix())
        mid = t0.lerp(t1, 0.5)
        expected = Transform(rotate=Rotate(axis=[0, 1, 0], degrees=45)).to_matrix()
        np.testing.assert_allclose(mid.to_matrix(), expected, atol=1e-6)

    def test_slerp_shortest_path(self):
        a = np.array([0, 0, 0, 1.0])
        b = -np.array([0, math.sin(math.radians(10)), 0, math.cos(math.radians(10))])
        q = quat_slerp(a, b, 0.5)
        # Shortest path: rotation of ~10 degrees, not ~350.
        angle = 2 * math.degrees(math.acos(min(1.0, abs(q[3]))))
        assert angle < 20

    def test_translation_lerp(self):
        from raytrace_tpu.scene_file import Transform

        t0 = decompose_matrix(Transform(translate=[0, 0, 0]).to_matrix())
        t1 = decompose_matrix(Transform(translate=[4, 0, 0]).to_matrix())
        np.testing.assert_allclose(t0.lerp(t1, 0.25).translation, [1, 0, 0])


class TestAliasTable:
    def test_uniform(self):
        prob, alias, total = build_alias_table(np.ones(7, np.float32))
        np.testing.assert_allclose(prob, 1.0)
        np.testing.assert_array_equal(alias, np.arange(7))
        assert total == pytest.approx(7.0)

    def test_distribution(self):
        rng = np.random.default_rng(0)
        areas = rng.uniform(0.1, 10.0, size=33).astype(np.float32)
        prob, alias, total = build_alias_table(areas)
        n = len(areas)
        # Simulate the exact sampling procedure used on device
        # (ray_gen.glsl:257-267).
        u1 = rng.uniform(size=200_000)
        u2 = rng.uniform(size=200_000)
        i = np.minimum((u1 * n).astype(np.int64), n - 1)
        chosen = np.where(u2 < prob[i], i, alias[i])
        freq = np.bincount(chosen, minlength=n) / len(chosen)
        np.testing.assert_allclose(freq, areas / areas.sum(), atol=0.004)

    def test_empty(self):
        prob, alias, total = build_alias_table(np.zeros(0, np.float32))
        assert len(prob) == 0 and total == 0.0
