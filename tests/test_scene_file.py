"""scene_file schema tests: loading every reference asset, JSON round-trip
stability, validation and render-limit clamping."""

import copy
import glob
import json
import os

import pytest

from raytrace_tpu.scene_file import (
    CheckerTexture,
    ConstantTexture,
    ImageTexture,
    SceneError,
    SceneFile,
)
from conftest import REFERENCE_ASSETS, reference_asset

ASSET_FILES = sorted(glob.glob(os.path.join(REFERENCE_ASSETS, "*.json")))


def _drop_nulls(x):
    """serde writes None-valued Option fields as explicit nulls; we omit them.
    Both spellings are semantically identical."""
    if isinstance(x, dict):
        return {k: _drop_nulls(v) for k, v in x.items() if v is not None}
    if isinstance(x, list):
        return [_drop_nulls(v) for v in x]
    return x


def _strip_paths(d):
    """Image texture paths get absolutized on load; neutralize for comparison."""
    d = copy.deepcopy(d)
    for t in d.get("textures", []):
        for body in t.values():
            if "path" in body:
                body["path"] = os.path.basename(body["path"])
    return _drop_nulls(d)


@pytest.mark.parametrize("path", ASSET_FILES, ids=[os.path.basename(p) for p in ASSET_FILES])
def test_load_and_roundtrip(path):
    scene = SceneFile.load_json(path)
    scene.validate()
    assert scene.render.samples_per_pixel <= 64
    assert scene.render.sample_batches <= 32
    assert len(scene.cameras) >= 1
    assert len(scene.primitives) >= 1
    assert len(scene.instances) >= 1

    # Round-trip: serialize and re-parse; the semantic content must be stable.
    once = scene.to_json_dict()
    again = SceneFile.from_json_dict(json.loads(json.dumps(once))).to_json_dict()
    assert once == again

    # And the round-tripped content must match the raw file modulo render
    # clamping and path absolutization (both intentional load-time fixups).
    with open(path) as f:
        raw = json.load(f)
    raw["render"]["samples_per_pixel"] = min(raw["render"]["samples_per_pixel"], 64)
    raw["render"]["sample_batches"] = min(raw["render"]["sample_batches"], 32)
    # Instances may spell "transform": null explicitly; we omit it.
    for inst in raw["instances"]:
        if inst.get("transform", "missing") is None:
            del inst["transform"]
    assert _strip_paths(once) == _strip_paths(raw)


def test_final_one_weekend_counts():
    scene = SceneFile.load_json(reference_asset("final-one-weekend.json"))
    assert len(scene.primitives) == 488
    assert len(scene.instances) == 488
    assert scene.render.samples_per_pixel == 4
    assert scene.render.sample_batches == 25
    assert scene.render.max_ray_depth == 50


def test_motion_blur_transforms_parse():
    scene = SceneFile.load_json(
        reference_asset("final-one-weekend-motion-blur.json")
    )
    animated = [i for i in scene.instances if i.transform and i.transform.is_animated]
    assert len(animated) == 390


def test_render_limit_clamp(tmp_path):
    scene = SceneFile.load_json(reference_asset("triangle.json"))
    scene.render.samples_per_pixel = 999
    scene.render.sample_batches = 999
    p = tmp_path / "clamped.json"
    scene.save_json(str(p))
    reloaded = SceneFile.load_json(str(p))
    assert reloaded.render.samples_per_pixel == 64
    assert reloaded.render.sample_batches == 32


def test_checker_recursion_rejected():
    scene = SceneFile.load_json(reference_asset("triangle.json"))
    scene.textures.append(
        CheckerTexture(name="c2", scale=1.0, even="green-and-white-checker", odd="white")
    )
    with pytest.raises(SceneError, match="recursive"):
        scene.validate()


def test_checker_unknown_reference_rejected():
    scene = SceneFile.load_json(reference_asset("triangle.json"))
    scene.textures.append(CheckerTexture(name="c2", scale=1.0, even="nope", odd="white"))
    with pytest.raises(SceneError, match="unknown texture"):
        scene.validate()


def test_relative_image_path_resolved():
    scene = SceneFile.load_json(reference_asset("earth.json"))
    img = [t for t in scene.textures if isinstance(t, ImageTexture)]
    assert img and os.path.isabs(img[0].path) and os.path.exists(img[0].path)


def test_missing_camera_raises():
    scene = SceneFile.load_json(reference_asset("triangle.json"))
    with pytest.raises(SceneError, match="not found"):
        scene.get_camera("nonexistent")


def test_duplicate_texture_names_keep_first(caplog):
    scene = SceneFile.load_json(reference_asset("triangle.json"))
    scene.textures.append(ConstantTexture(name="green", rgb=[1, 0, 0]))
    tex = scene.get_textures()
    assert tex["green"].rgb == [0.2, 0.3, 0.1]
