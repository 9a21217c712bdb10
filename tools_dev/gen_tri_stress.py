"""Stress scenes for large primitive counts.

- tri_stress_doc(k): a k x k grid of sphere-smooth.obj instances
  (960 tris each) over a ground sphere — the "big OBJ soup" the
  reference traces through its driver BLAS (acceleration.rs:268-294).
  The OBJ is expected at assets/obj/sphere-smooth.obj.
- sphere_stress_doc(k, cap): final-one-weekend tiled k x k (the
  gen_stress.py tiling), optionally trimmed to exactly `cap` spheres.

Run as a script to write tri-stress-{n}.json in the current directory.
"""

import copy
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raytrace_tpu.utils.paths import FLAGSHIP_SCENE, asset  # noqa: E402

OBJ = asset("obj/sphere-smooth.obj")


def tri_stress_doc(k: int = 4):
    """k*k instances x 960 tris (sphere-smooth.obj) + ground sphere."""
    prims = [{"uv_sphere": {"name": "ground", "center": [0, -1000, 0],
                            "radius": 1000, "rings": 4, "segments": 8,
                            "material": "ground"}},
             {"obj_mesh": {"name": "ball", "path": OBJ, "material": "grey"}}]
    insts = [{"name": "ground"}]
    for i in range(k):
        for j in range(k):
            insts.append({
                "name": "ball",
                "transform": {"static": {
                    "translate": [2.5 * (i - (k - 1) / 2), 1.0,
                                  2.5 * (j - (k - 1) / 2)],
                }},
            })
    return {
        "cameras": [{"perspective": {
            "name": "default", "eye": [0, 6.0, 3.0 * k + 4],
            "look_at": [0, 1, 0], "up": [0, 1, 0], "fov_y": 32,
            "z_near": 0.1, "z_far": 10000, "focal_length": 10.0,
            "aperture_size": 0}}],
        "textures": [
            {"constant": {"name": "grey", "rgb": [0.73, 0.73, 0.73]}},
            {"constant": {"name": "ground", "rgb": [0.8, 0.8, 0.0]}}],
        "materials": [
            {"lambertian": {"name": "grey", "albedo": "grey"}},
            {"lambertian": {"name": "ground", "albedo": "ground"}}],
        "primitives": prims, "instances": insts,
        "sky": {"vertical_gradient": {"factor": 0.5,
                                      "top": [0.5, 0.7, 1.0],
                                      "bottom": [1.0, 1.0, 1.0]}},
        "render": {"camera": "default", "samples_per_pixel": 16,
                   "sample_batches": 1, "max_ray_depth": 50,
                   "aspect_ratio": 1.7777778},
    }


def sphere_stress_doc(k: int, cap: int = 0):
    """final-one-weekend grid tiled k x k (gen_stress.py layout); with
    `cap`, added spheres are trimmed so the total is exactly cap."""
    with open(FLAGSHIP_SCENE) as f:
        doc = json.load(f)
    prims = doc["primitives"]
    grid = [p for p in prims
            if "uv_sphere" in p
            and p["uv_sphere"]["name"].startswith("sphere_")]
    new_prims, new_insts = [], []
    for ti in range(k):
        for tj in range(k):
            if ti == 0 and tj == 0:
                continue
            for p in grid:
                b = copy.deepcopy(p["uv_sphere"])
                b["name"] = f'{b["name"]}_t{ti}{tj}'
                b["center"] = [b["center"][0] + 22.5 * ti, b["center"][1],
                               b["center"][2] + 22.5 * tj]
                new_prims.append({"uv_sphere": b})
                new_insts.append({"name": b["name"]})
    if cap:
        n0 = sum(1 for p in prims if "uv_sphere" in p)
        keep = max(0, cap - n0)
        new_prims, new_insts = new_prims[:keep], new_insts[:keep]
    doc["primitives"] = prims + new_prims
    doc["instances"] = doc["instances"] + new_insts
    return doc


def main():
    k = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    doc = tri_stress_doc(k)
    n = k * k * 960
    out = f"tri-stress-{n}.json"
    with open(out, "w") as f:
        json.dump(doc, f)
    print(f"{out}: {k * k} OBJ instances, {n} triangles")


if __name__ == "__main__":
    main()
