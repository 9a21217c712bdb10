"""Interactive viewer (raytrace_tpu/viewer.py) — the app-shell parity
tests: progressive refinement over HTTP, scene hot-swap keeping the old
scene on errors (app.rs:225-234), and resize-restarts-accumulation
semantics (app.rs:239-242)."""

import json
import time
import urllib.request

import pytest

from conftest import reference_asset

from raytrace_tpu.viewer import Viewer


def _get(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read()


def _status(port):
    return json.loads(_get(port, "/status"))


def _wait(port, pred, timeout=60.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        st = _status(port)
        if pred(st):
            return st
        time.sleep(0.2)
    raise TimeoutError(str(_status(port)))


@pytest.fixture
def viewer():
    v = Viewer(reference_asset("final-one-weekend.json"), width=48, port=0)
    v.start()
    yield v
    v.stop()


def test_progressive_refinement_and_png(viewer):
    p = viewer.port
    st = _wait(p, lambda s: s["batch"] >= 1)
    assert st["width"] == 48
    png = _get(p, "/image.png")
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    from raytrace_tpu.utils.image import decode_png

    img = decode_png(png)
    assert img.shape[1] == 48 and img.mean() > 0
    page = _get(p, "/")
    assert b"raytrace_tpu" in page


def test_bad_hotswap_keeps_old_scene(viewer):
    p = viewer.port
    _wait(p, lambda s: s["batch"] >= 1)
    gen0 = _status(p)["generation"]
    _get(p, "/reload?path=/nonexistent/scene.json")
    st = _wait(p, lambda s: s["error"] is not None, timeout=30)
    assert st["generation"] == gen0          # old scene kept rendering
    assert st["scene"].endswith("final-one-weekend.json")


def test_hotswap_and_resize_restart(viewer):
    p = viewer.port
    _wait(p, lambda s: s["batch"] >= 1)
    gen0 = _status(p)["generation"]
    blur = reference_asset("final-one-weekend-motion-blur.json")
    _get(p, f"/reload?path={blur}")
    st = _wait(p, lambda s: s["generation"] > gen0, timeout=120)
    assert "motion-blur" in st["scene"]

    gen1 = st["generation"]
    _get(p, "/resize?width=32")
    st = _wait(p, lambda s: s["generation"] > gen1
               and s["width"] == 32, timeout=120)
    # accumulation restarted
    assert st["batch"] <= st["total_batches"]
