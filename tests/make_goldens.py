"""Regenerate golden renders (run from repo root):

    python tests/make_goldens.py [scene.json ...]   # default: every scene

Goldens are small deterministic CPU renders of every reference scene; the
regression test (test_goldens.py) re-renders and compares RMSE.  Regenerate
ONLY when an intentional behaviour change is made, and eyeball the PNGs.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")

from raytrace_tpu.engine import Renderer               # noqa: E402
from raytrace_tpu.utils.image import write_png         # noqa: E402
from golden_configs import CONFIGS, golden_scene       # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


def render_golden(name):
    return Renderer(golden_scene(name)).render_all()


def main(names=None):
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name in names or CONFIGS:
        img = render_golden(name)
        stem = name.replace(".json", "")
        np.savez_compressed(os.path.join(GOLDEN_DIR, stem + ".npz"), image=img)
        write_png(os.path.join(GOLDEN_DIR, stem + ".png"), img)
        print(f"{stem}: {img.shape} mean={img.mean(axis=(0, 1)).round(4)}")


if __name__ == "__main__":
    main(sys.argv[1:])
