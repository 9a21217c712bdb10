"""The platform module, the compile-cache placement rule, the standard-
library PNG codec and chip_smoke.py's refusal to run without a GPU."""

import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

from raytrace_tpu import platform
from raytrace_tpu.engine import Renderer
from raytrace_tpu.engine.renderer import RAY_BUDGET, rows_for_budget
from raytrace_tpu.models import compile_scene
from raytrace_tpu.tools import generate_quad_box_scene
from raytrace_tpu.utils import cache
from raytrace_tpu.utils.image import (decode_png, encode_png, to_srgb_u8,
                                      write_png)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "raytrace_tpu")


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    yield os.path.relpath(path, REPO), fh.read()


def _run(code, env_extra=None, cwd=REPO):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=cwd, timeout=300)


# ------------------------------------------------------------- platform

def test_platform_here_is_cpu_with_xla_sweeps():
    assert platform.platform() == "cpu"
    assert platform.use_triton_sweeps() is False


def test_renderer_sweep_follows_platform(monkeypatch):
    """The default sweep is the platform's answer, and interpret mode is
    never chosen for a device: only an explicit request turns it on."""
    cs = compile_scene(generate_quad_box_scene(sample_batches=1),
                       width=8, height=8)
    r = Renderer(cs)
    assert not r.static.use_pallas_sweep and not r.static.pallas_interpret
    monkeypatch.setattr(platform, "use_triton_sweeps", lambda: True)
    r = Renderer(cs)
    assert r.static.use_pallas_sweep and not r.static.pallas_interpret
    r = Renderer(cs, use_pallas_sweep=False)
    assert not r.static.use_pallas_sweep


def test_ellipsoid_spheres_keep_the_xla_sweep():
    """Non-uniformly scaled sphere instances trace in object space, which
    has no kernel: the Triton sweep is off even when asked for."""
    from raytrace_tpu.scene_file import (ConstantTexture, Instance, Lambertian,
                                         PerspectiveCamera, Render, SceneFile,
                                         SolidSky, Transform, TransformType,
                                         UvSphere)

    sf = SceneFile(
        cameras=[PerspectiveCamera(name="c", eye=[0, 0, 5], look_at=[0, 0, 0],
                                   up=[0, 1, 0], fov_y=40, z_near=0.01,
                                   z_far=100, focal_length=1,
                                   aperture_size=0)],
        textures=[ConstantTexture(name="w", rgb=[0.5, 0.5, 0.5])],
        materials=[Lambertian(name="m", albedo="w")],
        primitives=[UvSphere(name="s", center=[0, 0, 0], radius=1, rings=8,
                             segments=16, material="m")],
        instances=[Instance(name="s", transform=TransformType(
            start=Transform(scale=[2.0, 1.0, 1.0])))],
        sky=SolidSky(rgb=[1, 1, 1]),
        render=Render(camera="c", samples_per_pixel=1, sample_batches=1,
                      max_ray_depth=2, aspect_ratio=1.0))
    r = Renderer(compile_scene(sf, width=8, height=8),
                 use_pallas_sweep=True, pallas_interpret=True)
    assert not r.static.sphere_world_mode
    assert not r.static.use_pallas_sweep


@pytest.mark.parametrize("height,width,spp,budget,rows", [
    (576, 1024, 4, 1 << 20, 192),      # flagship: 3 tiles of 192 rows
    (576, 1024, 4, 1 << 22, 576),      # whole frame in one tile
    (675, 1200, 4, 1 << 20, 169),      # 4 balanced tiles, not 218+tail
    (144, 256, 4, 1 << 15, 29),        # 5 tiles at 256x144
    (10, 10, 1, 1 << 20, 10),
])
def test_rows_for_budget(height, width, spp, budget, rows):
    got = rows_for_budget(height, width, spp, budget)
    assert got == rows
    n_tiles = -(-height // got)
    assert (n_tiles - 1) * got < height <= n_tiles * got


def test_default_budget_tiles_the_flagship():
    """The shipped budget renders the flagship frame (1024x576 x 4 spp)
    as one tile: measured fastest on the H100."""
    assert rows_for_budget(576, 1024, 4, RAY_BUDGET) == 576
    from raytrace_tpu.scene_file import SceneFile
    from raytrace_tpu.utils.paths import FLAGSHIP_SCENE

    cs = compile_scene(SceneFile.load_json(FLAGSHIP_SCENE), width=64,
                       height=36)
    assert Renderer(cs).rows_per_tile == 36


def test_backend_query_only_in_platform_module():
    """One module decides which path runs: no other module asks JAX for
    its backend."""
    hits = [p for p, src in _sources() if "default_backend(" in src]
    assert hits == [os.path.join("raytrace_tpu", "platform.py")], hits


def test_pallas_calls_name_the_triton_route():
    """Pallas is imported only through its Triton route, and every
    pallas_call names that route (a call that names none goes to Mosaic
    GPU)."""
    import ast

    pallas = "jax.experimental.pallas"
    n_calls = 0
    for path, src in _sources():
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, ast.ImportFrom) and node.module == pallas:
                assert {a.name for a in node.names} <= {"triton"}, path
            elif isinstance(node, ast.ImportFrom) and (
                    node.module or "").startswith(pallas + "."):
                assert node.module == pallas + ".triton", path
            elif isinstance(node, ast.Import):
                for a in node.names:
                    assert a.name in (pallas, pallas + ".triton") or \
                        not a.name.startswith(pallas), path
        n = src.count("pl.pallas_call(")
        n_calls += n
        assert src.count('backend="triton"') >= n, path
    assert n_calls == 2


# ------------------------------------------------------------- cache

def test_cache_dir_follows_env(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert cache.cache_dir() == "/some/where"
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert cache.cache_dir() == os.path.join(REPO, ".jax_cache")


def test_cache_written_to_env_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, compiled programs land there and
    the program sets no directory of its own."""
    d = tmp_path / "cc"
    code = (
        "import jax, jax.numpy as jnp\n"
        "from raytrace_tpu.utils.cache import enable_compilation_cache\n"
        "p = enable_compilation_cache()\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(7)).block_until_ready()\n"
        "print(p, jax.config.jax_compilation_cache_dir)\n")
    out = _run(code, {"JAX_COMPILATION_CACHE_DIR": str(d)})
    assert out.returncode == 0, out.stderr[-800:]
    assert out.stdout.split() == [str(d), str(d)]
    assert any(d.iterdir())


def test_cache_default_is_in_checkout():
    code = ("import jax\n"
            "from raytrace_tpu.utils.cache import enable_compilation_cache\n"
            "print(enable_compilation_cache())\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr[-800:]
    want = os.path.join(REPO, ".jax_cache")
    assert out.stdout.split() == [want, want]


# ------------------------------------------------------------- PNG

def test_png_encode_decode_exact():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (7, 13, 3), dtype=np.uint8)
    data = encode_png(img)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    # IHDR: 13x7, 8-bit RGB; its CRC checks.
    (n,) = struct.unpack(">I", data[8:12])
    assert data[12:16] == b"IHDR" and n == 13
    assert struct.unpack(">IIBB", data[16:26]) == (13, 7, 8, 2)
    (crc,) = struct.unpack(">I", data[16 + n:20 + n])
    assert crc == zlib.crc32(data[12:16 + n]) & 0xFFFFFFFF
    np.testing.assert_array_equal(decode_png(data), img)


def _filtered_png(img, ftype):
    """A PNG whose rows all use filter `ftype` (1 sub, 2 up, 3 average,
    4 Paeth), encoded here independently of the library."""
    h, w, c = img.shape
    a = img.reshape(h, w * c).astype(np.int32)
    rows = []
    for y in range(h):
        prev = a[y - 1] if y else np.zeros(w * c, np.int32)
        left = np.concatenate([np.zeros(c, np.int32), a[y, :-c]])
        ul = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) // 2
        else:
            pa, pb, pc = (np.abs(prev - ul), np.abs(left - ul),
                          np.abs(left + prev - 2 * ul))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, ul))
        rows.append(bytes([ftype]) + ((a[y] - pred) & 0xFF)
                    .astype(np.uint8).tobytes())

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    ctype = {3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [1, 2, 3, 4])
@pytest.mark.parametrize("channels", [3, 4])
def test_png_decode_every_filter(ftype, channels):
    img = np.random.default_rng(ftype).integers(
        0, 256, (6, 5, channels), dtype=np.uint8)
    np.testing.assert_array_equal(decode_png(_filtered_png(img, ftype)), img)


def test_write_png_needs_no_pillow(tmp_path):
    """Rendering ends in write_png; it must work where Pillow is absent."""
    p = tmp_path / "x.png"
    code = ("import sys; sys.modules['PIL'] = None\n"
            "import numpy as np\n"
            "from raytrace_tpu.utils.image import write_png\n"
            f"write_png({str(p)!r}, np.full((4, 6, 3), 0.5, np.float32))\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr[-800:]
    img = decode_png(p.read_bytes())
    assert img.shape == (4, 6, 3)
    assert (img == to_srgb_u8(np.full((1, 1, 3), 0.5))[0, 0]).all()


def test_image_texture_without_pillow_names_the_package():
    code = ("import sys; sys.modules['PIL'] = None\n"
            "from raytrace_tpu.models.compile import _load_image_atlas\n"
            "from raytrace_tpu.scene_file import SceneError\n"
            "try:\n"
            "    _load_image_atlas(['earth.jpg'])\n"
            "except SceneError as e:\n"
            "    print('SceneError:', e)\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr[-800:]
    assert "SceneError:" in out.stdout and "Pillow" in out.stdout


# ------------------------------------------------------------- chip_smoke

def test_chip_smoke_refuses_the_cpu():
    """No GPU: non-zero exit, and no result line on standard output."""
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, cwd=REPO, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py without the program beside it fails before JAX."""
    src = os.path.join(REPO, "chip_smoke.py")
    dst = tmp_path / "chip_smoke.py"
    dst.write_text(open(src).read())
    out = subprocess.run([sys.executable, str(dst)], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
