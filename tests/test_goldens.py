"""Golden-image regression: every reference scene renders identically to
its stored golden (same platform, same RNG streams → near-bitwise; the
tolerance only absorbs compiler-version float drift)."""

import os

import numpy as np
import pytest

from conftest import reference_asset
from make_goldens import CONFIGS, GOLDEN_DIR, render_golden
from raytrace_tpu.utils.image import rmse

HAVE_GOLDENS = os.path.isdir(GOLDEN_DIR) and len(os.listdir(GOLDEN_DIR)) > 0


# Fast-set goldens: one scene per major feature family (triangles +
# checker, emissives/NEE, image texture, the 488-sphere flagship).  The
# others run under `pytest -m ""` / `-m slow` (full regression sweep).
FAST_GOLDENS = {"triangle.json", "cornell-box.json", "earth.json",
                "final-one-weekend.json"}


@pytest.mark.skipif(not HAVE_GOLDENS, reason="goldens not generated")
@pytest.mark.parametrize("name", [
    pytest.param(n, marks=[] if n in FAST_GOLDENS else [pytest.mark.slow])
    for n in sorted(CONFIGS)
])
def test_golden(name):
    stem = name.replace(".json", "")
    path = os.path.join(GOLDEN_DIR, stem + ".npz")
    if not os.path.exists(path):
        pytest.skip(f"golden missing for {stem}")
    golden = np.load(path)["image"]
    reference_asset(name)  # skips scenes not shipped in assets/ yet
    img = render_golden(name)
    assert img.shape == golden.shape
    err = rmse(img, golden)
    assert err < 1e-4, f"{stem}: rmse {err} vs golden"
