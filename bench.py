#!/usr/bin/env python
"""Headline throughput: final-one-weekend at 1200x675 on one device.

Prints ONE JSON line:
  {"metric": "mrays_per_sec", "value": N, "unit": "Mrays/s",
   "device": {"platform": ..., "kind": ..., "count": ...}}

Timing excludes the first batch (compile); rays are counted exactly on
device (sum of alive lanes per bounce — primary + secondary rays actually
traced).  The line names the device it ran on; a number from a CPU run is
not a device measurement.

Env knobs:
  BENCH_SCENE   (default final-one-weekend.json, read from assets/)
  BENCH_WIDTH/BENCH_HEIGHT (default 1200x675)
  BENCH_BATCHES (default 4 timed batches after one warm-up batch)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    scene_name = os.environ.get("BENCH_SCENE", "final-one-weekend.json")
    width = int(os.environ.get("BENCH_WIDTH", 1200))
    height = int(os.environ.get("BENCH_HEIGHT", 675))
    n_timed = int(os.environ.get("BENCH_BATCHES", 4))

    import jax

    from raytrace_tpu.engine import Renderer
    from raytrace_tpu.models import compile_scene
    from raytrace_tpu.scene_file import SceneFile
    from raytrace_tpu.utils.paths import asset

    path = scene_name if os.path.exists(scene_name) else asset(scene_name)
    sf = SceneFile.load_json(path)
    sf.render.sample_batches = max(sf.render.sample_batches, n_timed + 1)

    cs = compile_scene(sf, width=width, height=height)
    r = Renderer(cs)

    r.render_batches(1)  # compile + warm-up (excluded from the measurement)

    t0 = time.perf_counter()
    rays0 = r.stats.rays_traced
    r.render_batches(n_timed)
    dt = time.perf_counter() - t0
    rays = r.stats.rays_traced - rays0

    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "mrays_per_sec",
        "value": rays / dt / 1e6 if dt > 0 else 0.0,
        "unit": "Mrays/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
