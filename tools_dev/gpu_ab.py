"""Kernel and tile-budget decisions on the GPU, measured end to end.

    python tools_dev/gpu_ab.py [--batches 8]

In one process on one card (alternating A, B, B, A so drift cancels):
  sweep   final-one-weekend 1024x576 and the quad box 1024x1024 through
          Renderer with the Pallas-Triton sweeps on and off;
  budget  final-one-weekend 1024x576 with tile ray budgets 2^20..2^23;
  bvh     the 2,033,920-triangle --mesh-geometry scene at 256x144 with
          BVH tile budgets 2^15..2^19.
Each run renders one warm-up batch (compile) and then `--batches` timed
batches; the rate is device-counted rays over the timed wall time.
Refuses to run without a GPU.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rate(cs, batches, **kw):
    from raytrace_tpu.engine import Renderer

    r = Renderer(cs, **kw)
    t0 = time.perf_counter()
    r.render_next_batch()
    first = time.perf_counter() - t0
    rays0, t0 = r.stats.rays_traced, time.perf_counter()
    for _ in range(batches):
        r.render_next_batch()
    dt = time.perf_counter() - t0
    return {"mrays_per_s": (r.stats.rays_traced - rays0) / dt / 1e6,
            "batch_s": dt / batches, "first_batch_s": first,
            "rows_per_tile": r.rows_per_tile,
            "sweep": "triton" if r.static.use_pallas_sweep else "xla"}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--parts", default="sweep,budget,bvh")
    args = ap.parse_args()

    import jax

    if jax.devices()[0].platform != "gpu":
        sys.exit("gpu_ab: no GPU")
    from raytrace_tpu.engine.renderer import rows_for_budget
    from raytrace_tpu.models import compile_scene
    from raytrace_tpu.scene_file import SceneFile
    from raytrace_tpu.tools import generate_quad_box_scene
    from raytrace_tpu.utils.paths import FLAGSHIP_SCENE

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    n = args.batches

    def scene(sf, **kw):
        sf.render.sample_batches = n + 1
        return compile_scene(sf, **kw)

    fow = scene(SceneFile.load_json(FLAGSHIP_SCENE))
    box = scene(generate_quad_box_scene())
    parts = args.parts.split(",")

    def emit(part, label, res):
        print(json.dumps({"part": part, "case": label, **res}), flush=True)

    if "sweep" in parts:
        for name, cs in (("final-one-weekend", fow), ("quad-box", box)):
            for pallas in (False, True, True, False):
                emit("sweep", name, rate(cs, n, use_pallas_sweep=pallas))
    if "budget" in parts:
        H, W, spp = 576, 1024, 4
        for b in (20, 21, 22, 23, 23, 22, 21, 20):
            rows = rows_for_budget(H, W, spp, 1 << b)
            emit("budget", f"final-one-weekend 2^{b}",
                 rate(fow, n, rows_per_tile=rows))
    if "bvh" in parts:
        sf = SceneFile.load_json(FLAGSHIP_SCENE)
        sf.render.sample_batches = 3
        mesh = compile_scene(sf, width=256, height=144, analytic_spheres=False)
        for b in (15, 17, 19, 19, 17, 15):
            rows = rows_for_budget(144, 256, 4, 1 << b)
            emit("bvh", f"mesh-geometry 2^{b}",
                 rate(mesh, 2, rows_per_tile=rows))


if __name__ == "__main__":
    main()
