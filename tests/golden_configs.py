"""Render configurations of the golden images (tests/goldens/*.npz).

Free of side effects on import (it does not pin a platform), so both the
CPU golden tools (make_goldens.py) and chip_smoke.py's parity phase on
the card compile the same scene.
"""

# scene -> (width, spp, batches, depth)
CONFIGS = {
    "triangle.json": (64, 4, 1, 8),
    "quads.json": (64, 4, 1, 6),
    "diffuse-spheres.json": (64, 4, 1, 8),
    "metal-spheres.json": (64, 4, 1, 8),
    "dielectric-spheres.json": (64, 4, 1, 10),
    "checkered-spheres.json": (64, 4, 1, 6),
    "perlin-spheres.json": (64, 4, 1, 6),
    "earth.json": (64, 4, 1, 4),
    "earth-motion-blur.json": (64, 4, 2, 4),
    "cornell-box.json": (64, 9, 2, 10),
    "cornell-box-metal.json": (64, 9, 2, 10),
    "cornell-box-glass.json": (64, 9, 2, 10),
    "simple-light.json": (64, 9, 2, 8),
    "final-one-weekend.json": (96, 4, 1, 8),
    "final-one-weekend-motion-blur.json": (96, 4, 2, 8),
}


def golden_scene(name: str):
    """The CompiledScene a golden of `name` is rendered from."""
    from raytrace_tpu.models import compile_scene
    from raytrace_tpu.scene_file import SceneFile
    from raytrace_tpu.utils.paths import asset

    w, spp, batches, depth = CONFIGS[name]
    sf = SceneFile.load_json(asset(name))
    sf.render.samples_per_pixel = spp
    sf.render.sample_batches = batches
    sf.render.max_ray_depth = depth
    h = max(1, round(w / sf.render.aspect_ratio))
    return compile_scene(sf, width=w, height=h)
