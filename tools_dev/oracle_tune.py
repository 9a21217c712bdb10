"""Measure engine-vs-oracle disagreement for the round-5 oracle cases
(cornell-box-metal, cornell-box-glass, simple-light,
final-one-weekend-motion-blur) to set the test gates empirically.

  JAX_PLATFORMS=cpu python tools_dev/oracle_tune.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

import numpy as np

from oracle_tracer import render_oracle
from raytrace_tpu.engine import Renderer
from raytrace_tpu.engine.renderer import get_batch_ray_times
from raytrace_tpu.models import compile_scene
from raytrace_tpu.scene_file import SceneFile

from raytrace_tpu.utils.paths import ASSETS_DIR as ASSETS

CASES = [
    ("cornell-box-metal.json", 32, 32, 512, (64, 8), 8, None),
    ("cornell-box-glass.json", 32, 32, 512, (64, 8), 8, None),
    ("simple-light.json", 32, 32, 512, (64, 8), 8, None),
    ("final-one-weekend-motion-blur.json", 48, 27, 48, (16, 8), 8, "batch"),
]


def down(img, k):
    h, w = img.shape[0] // k * k, img.shape[1] // k * k
    return img[:h, :w].reshape(h // k, k, w // k, k, 3).mean(axis=(1, 3))


for name, w, h, ospp, espp, depth, times in CASES:
    tms = list(get_batch_ray_times(espp[1])) if times == "batch" else None
    oi = render_oracle(os.path.join(ASSETS, name), w, h, spp=ospp,
                       max_depth=depth, times=tms)
    sf = SceneFile.load_json(os.path.join(ASSETS, name))
    sf.render.samples_per_pixel = espp[0]
    sf.render.sample_batches = espp[1]
    sf.render.max_ray_depth = depth
    cs = compile_scene(sf, width=w, height=h)
    ei = np.asarray(Renderer(cs).render_all())
    mean_diff = np.abs(oi.mean(axis=(0, 1)) - ei.mean(axis=(0, 1)))
    rmse = float(np.sqrt(((oi - ei) ** 2).mean()))
    k = 4 if w == 32 else 3
    drmse = float(np.sqrt(((down(oi, k) - down(ei, k)) ** 2).mean()))
    print(f"{name:42s} mean_diff={mean_diff.max():.4g} rmse={rmse:.4g} "
          f"down{k}={drmse:.4g} finite={np.isfinite(ei).all()}", flush=True)
