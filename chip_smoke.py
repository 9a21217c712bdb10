#!/usr/bin/env python
"""Proof that the path tracer runs on one NVIDIA GPU, end to end.

    python chip_smoke.py            # phases main, routes, kernels, parity (1 GPU)
    python chip_smoke.py --multi    # the 4-GPU MultiChipRenderer phase only

Phases (one GPU, one process):
  main     `cli render` (raytrace_tpu.cli.main) on assets/final-one-weekend.json
           at its shipped configuration: 1024x576, 4 spp x 25 batches,
           depth 50, depth of field.  Checks the PNG and the float image.
  routes   short Renderer runs of the other paths: the 390-instance
           motion-blur refit, the quad box (triangle sweep + NEE/MIS), and
           the 2,033,920-triangle --mesh-geometry SAH BVH.
  kernels  each Pallas-Triton sweep against the plain XLA sweep at 2^20
           rays (t to rtol 2e-3, >= 99% hit-id agreement), plus the
           card-only tests of tests/test_gpu.py.
  parity   final-one-weekend at its golden configuration against the CPU
           golden tests/goldens/final-one-weekend.npz, with tolerances
           taken from the Monte Carlo noise of the golden's own spp.
  multi    (--multi, 4 GPUs) MultiChipRenderer on a px x sp = 2x2 and a
           px x sp x sc = 1x2x2 mesh against the single-GPU Renderer,
           final-one-weekend 1024x576, 3 batches.

It exits non-zero, printing no result, when JAX finds no GPU, and any
failed check raises.  The last line of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = ("main", "routes", "kernels", "parity")
KERNEL_RAYS = 1 << 20


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` (no JAX involved)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.strip().replace("\n", " | ")


def require_gpu():
    """The GPU devices, or exit non-zero: this check never falls back to
    the CPU."""
    if not os.path.isdir(os.path.join(REPO, "raytrace_tpu")):
        sys.exit("chip_smoke: run from a checkout of the repository "
                 "(raytrace_tpu/ not found beside this script)")
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: JAX found no GPU (default devices: "
                 f"{devs[0].platform}); refusing to run on the CPU")
    return devs


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def mem_line(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis unavailable"
    gib = lambda b: f"{b / 2**30:.3f}GiB"
    return (f"args={gib(m.argument_size_in_bytes)} "
            f"out={gib(m.output_size_in_bytes)} "
            f"temp={gib(m.temp_size_in_bytes)} "
            f"code={gib(m.generated_code_size_in_bytes)}")


def check_image(img, shape, what: str):
    import numpy as np

    img = np.asarray(img)
    assert img.shape == shape, f"{what}: shape {img.shape} != {shape}"
    assert np.isfinite(img).all(), f"{what}: non-finite pixels"
    assert (img >= 0.0).all(), f"{what}: negative pixels"
    assert img.mean() > 0.0, f"{what}: black image"


def render_timed(r, n: int):
    """Render n >= 2 batches; returns (first-batch seconds, which include
    compilation; steady seconds per batch over the rest; device-counted
    rays per second over the rest)."""
    _, first = timed(r.render_next_batch)
    rays0, t0 = r.stats.rays_traced, time.perf_counter()
    for _ in range(n - 1):
        r.render_next_batch()
    rest = time.perf_counter() - t0
    return (first, rest / (n - 1),
            (r.stats.rays_traced - rays0) / rest)


# --------------------------------------------------------------- phases

def phase_main(work: str):
    import numpy as np

    from raytrace_tpu.cli import main
    from raytrace_tpu.engine import Renderer
    from raytrace_tpu.models import compile_scene
    from raytrace_tpu.scene_file import SceneFile
    from raytrace_tpu.utils.image import decode_png
    from raytrace_tpu.utils.paths import FLAGSHIP_SCENE

    # Warm the CLI's executables: the CLI's Renderer shares them (module
    # cache keyed by the scene statics), so its batches time rendering
    # only and compile time is reported on its own.
    sf = SceneFile.load_json(FLAGSHIP_SCENE)
    cs = compile_scene(sf)
    warm = Renderer(cs)
    _, first = timed(warm.render_next_batch)

    png = os.path.join(work, "final-one-weekend.png")
    ck = os.path.join(work, "final-one-weekend.npz")
    jl = os.path.join(work, "metrics.jsonl")
    rc = main(["render", "--path", FLAGSHIP_SCENE, "-o", png,
               "--checkpoint", ck, "--metrics-jsonl", jl])
    assert rc == 0, f"cli render exited {rc}"
    recs = [json.loads(line) for line in open(jl)]
    assert len(recs) == 25, f"{len(recs)} batches recorded, expected 25"
    secs = [r["seconds"] for r in recs]
    rays = sum(r["rays"] for r in recs)
    render_s = sum(secs)
    compile_s = first - float(np.median(secs))
    data = np.load(ck)
    assert int(data["current_batch"]) == 25
    check_image(data["accum"], (576, 1024, 3), "main accumulation")
    assert decode_png(open(png, "rb").read()).shape == (576, 1024, 3)
    log(f"phase main: scene=final-one-weekend 1024x576 spp=4 batches=25 "
        f"depth=50 dof=1 tile_rows={warm.rows_per_tile} "
        f"compile_s={compile_s:.2f} (first batch {first:.2f}s minus the "
        f"median batch) render_s={render_s:.3f} rays={rays:.0f} "
        f"mrays_per_s={rays / render_s / 1e6:.2f} "
        f"batch_s_median={float(np.median(secs)):.4f} "
        f"sweep={'triton' if warm.static.use_pallas_sweep else 'xla'}")
    log(f"phase main: memory_analysis(tile step) {mem_line(warm.compiled_tile())}")


def phase_routes():
    from raytrace_tpu.engine import Renderer
    from raytrace_tpu.models import compile_scene
    from raytrace_tpu.scene_file import SceneFile
    from raytrace_tpu.tools import generate_quad_box_scene
    from raytrace_tpu.utils.paths import FLAGSHIP_SCENE, asset

    def report(name, r, n, setup_s, extra=""):
        first, steady, rays_per_s = render_timed(r, n)
        H, W = r.static.height, r.static.width
        check_image(r.image(), (H, W, 3), name)
        log(f"phase routes: {name} {W}x{H} batches={n} setup_s={setup_s:.2f} "
            f"compile_s={first - steady:.2f} (first batch {first:.2f}s minus "
            f"a steady one) render_s={steady:.4f}/batch "
            f"rays={r.stats.rays_traced:.0f} "
            f"mrays_per_s={rays_per_s / 1e6:.2f} (steady batches) "
            f"sweep={'triton' if r.static.use_pallas_sweep else 'xla'} "
            f"bvh={r.static.bvh_mode} {extra}")

    sf = SceneFile.load_json(asset("final-one-weekend-motion-blur.json"))
    sf.render.sample_batches = 2
    animated = sum(bool(i.transform and i.transform.is_animated)
                   for i in sf.instances)
    assert animated == 390, animated
    cs = compile_scene(sf)
    r, setup = timed(lambda: Renderer(cs))
    assert r.static.any_animated
    report("motion-blur", r, 2, setup, f"animated_instances={animated}")

    cs = compile_scene(generate_quad_box_scene(sample_batches=2))
    r, setup = timed(lambda: Renderer(cs))
    assert r.static.has_tris and r.static.has_lights
    report("quad-box", r, 2, setup,
           f"triangles={cs.num_triangles} lights={cs.light_count}")

    sf = SceneFile.load_json(FLAGSHIP_SCENE)
    sf.render.sample_batches = 2
    cs, tess = timed(lambda: compile_scene(sf, width=256, height=144,
                                           analytic_spheres=False))
    assert cs.num_triangles == 2_033_920, cs.num_triangles
    r, setup = timed(lambda: Renderer(cs))
    assert r.bvh is not None and r.static.bvh_mode == "sah", r.static.bvh_mode
    report("mesh-geometry", r, 2, setup,
           f"triangles={cs.num_triangles} tessellate_s={tess:.2f} "
           f"tile_rows={r.rows_per_tile}")


def _time_fn(fn, *args, reps=10):
    import jax

    out = jax.block_until_ready(fn(*args))          # compile + warm
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps, out


def _compare_hits(name, t_k, id_k, t_x, id_x, ms_k, ms_x, R):
    """The tolerance of tests/test_pallas_sweep.py: where both sweeps hit
    the same primitive, t agrees to rtol 2e-3 (atol 1e-3 near T_MIN); at
    least 99% of rays pick the same primitive.  The XLA sweep uses
    HIGHEST-precision products and the kernel fused FMAs, so a near-tie
    (a grazing tangent, two spheres in contact) may pick the other
    primitive, and an origin on a surface may take the other root of the
    same sphere when its near root sits at T_MIN: at 2^20 random rays
    such root flips are allowed for at most 1 in 1e5 same-id hits."""
    import numpy as np

    t_k, t_x = np.asarray(t_k), np.asarray(t_x)
    id_k, id_x = np.asarray(id_k), np.asarray(id_x)
    same = id_k == id_x
    both = same & (id_x >= 0)
    dt = np.abs(t_k[both] - t_x[both])
    tx = np.abs(t_x[both])
    bad = dt > 1e-3 + 2e-3 * tx
    over = int(bad.sum())
    far = tx >= 1.0
    max_rel = float((dt[far] / tx[far]).max()) if far.any() else 0.0
    agree = float(same.mean())
    log(f"phase kernels: {name} rays={R} hit_share={float((id_x >= 0).mean()):.3f} "
        f"max_rel_dt(t>=1)={max_rel:.3g} max_abs_dt={float(dt.max()):.3g} "
        f"t_out_of_tol={over} id_agreement={agree:.6f} "
        f"id_disagree={int((~same).sum())} "
        f"triton_ms={ms_k * 1e3:.3f} xla_ms={ms_x * 1e3:.3f}")
    if over:
        log(f"phase kernels: {name} out-of-tolerance t (xla, triton): "
            f"{list(zip(t_x[both][bad][:4].tolist(), t_k[both][bad][:4].tolist()))}")
    assert over <= 1e-5 * both.sum(), f"{name}: {over} hits outside rtol 2e-3"
    assert agree >= 0.99, f"{name}: id agreement {agree}"


def phase_kernels(devs):
    import importlib.util

    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytrace_tpu.engine.renderer import get_batch_ray_times
    from raytrace_tpu.models import compile_scene
    from raytrace_tpu.ops import intersect
    from raytrace_tpu.ops.pallas_sweep import intersect_spheres_pallas_v3, pad_table8
    from raytrace_tpu.ops.pallas_tri_sweep import (intersect_tris_pallas_v3,
                                                   pack_tri_table)
    from raytrace_tpu.ops.spheres import intersect_spheres_world, world_sphere_tables
    from raytrace_tpu.ops.vec3 import from_rows
    from raytrace_tpu.scene_file import SceneFile
    from raytrace_tpu.utils.paths import FLAGSHIP_SCENE

    R = KERNEL_RAYS
    rs = np.random.default_rng(0)

    # Spheres: the flagship's 488 world spheres; half the rays leave the
    # camera toward the sphere field, half start anywhere inside it.
    cs = compile_scene(SceneFile.load_json(FLAGSHIP_SCENE))
    table = world_sphere_tables(cs, get_batch_ray_times(1))[0]
    eye = np.asarray(cs.cameras[cs.render.camera].eye, np.float32)
    h = R // 2
    o = np.concatenate([eye + rs.normal(0, 0.2, (h, 3)),
                        rs.uniform([-12, -3, -12], [12, 0.5, 12], (R - h, 3))])
    tgt = rs.uniform([-12, -2, -12], [12, 0.5, 12], (R, 3))
    d = np.concatenate([tgt[:h] - o[:h], rs.normal(size=(R - h, 3))])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)
    tab = jnp.asarray(table)
    xla = jax.jit(lambda o, d, t: intersect_spheres_world(
        o, d, t, chunk=min(128, t.shape[0])))
    tri = jax.jit(lambda o, d, t: intersect_spheres_pallas_v3(
        from_rows(o), from_rows(d), pad_table8(t)))
    ms_x, hx = _time_fn(xla, o, d, tab)
    ms_k, hk = _time_fn(tri, o, d, tab)
    _compare_hits(f"sphere_sweep spheres={cs.num_spheres}", hk.t, hk.sph,
                  hx.t, hx.sph, ms_k, ms_x, R)

    # Triangles: random soups of 32 and 8,192 triangles.
    for n in (32, 8192):
        world = (rs.uniform(-8, 8, (n, 1, 3))
                 + rs.normal(0, 1, (n, 3, 3))).astype(np.float32)
        o = rs.uniform(-10, 10, (R, 3)).astype(np.float32)
        d = rs.normal(size=(R, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o, d, w = jnp.asarray(o), jnp.asarray(d), jnp.asarray(world)
        xla = jax.jit(lambda o, d, w: intersect.intersect_brute_force(
            o, d, w, chunk=min(512, w.shape[0])))
        tri = jax.jit(lambda o, d, w: intersect_tris_pallas_v3(
            from_rows(o), from_rows(d), pack_tri_table(w, w.shape[0])))
        ms_x, hx = _time_fn(xla, o, d, w)
        ms_k, hk = _time_fn(tri, o, d, w)
        _compare_hits(f"tri_sweep triangles={n}", hk.t, hk.tri, hx.t, hx.tri,
                      ms_k, ms_x, R)

    # Card-only tests (marker `gpu`), run here on the card.
    spec = importlib.util.spec_from_file_location(
        "test_gpu", os.path.join(REPO, "tests", "test_gpu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    err = mod.refit_rel_error(devs[0])
    mod.test_refit_matches_host_f64(devs[0])
    log(f"phase kernels: tests/test_gpu.py::test_refit_matches_host_f64 "
        f"passed (refit relative error {err:.3g} < {mod.REFIT_RTOL})")


def phase_parity():
    import importlib.util

    import numpy as np

    from raytrace_tpu.engine import Renderer

    spec = importlib.util.spec_from_file_location(
        "golden_configs", os.path.join(REPO, "tests", "golden_configs.py"))
    gc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gc)
    name = "final-one-weekend.json"
    golden = np.load(os.path.join(REPO, "tests", "goldens",
                                  "final-one-weekend.npz"))["image"]
    cs = gc.golden_scene(name)
    assert cs.render.sample_batches == 1
    # A second, independent batch (other RNG streams) measures the Monte
    # Carlo noise of one golden-spp render on the card.
    cs = dataclasses.replace(
        cs, render=dataclasses.replace(cs.render, sample_batches=2))
    r = Renderer(cs)
    r.render_next_batch()
    img0 = r.image()
    r.render_next_batch()
    img1 = 2.0 * r.image() - img0
    assert img0.shape == golden.shape, (img0.shape, golden.shape)
    check_image(img0, golden.shape, "parity render")

    sigma = (img1 - img0).reshape(-1, 3).std(axis=0) / np.sqrt(2.0)
    n_pix = img0.shape[0] * img0.shape[1]
    # Means: a correct render may differ from the golden by at most 4
    # standard errors of an independent render's per-channel mean.
    d_mean = np.abs(img0.mean(axis=(0, 1)) - golden.mean(axis=(0, 1)))
    mean_tol = 4.0 * np.sqrt(2.0) * sigma / np.sqrt(n_pix)
    # Pixels: the share differing from the golden by more than 3 sigma
    # (any channel) may not exceed the share by which two independent
    # renders on the card differ from each other.  Same RNG streams make
    # the card and the CPU agree far more closely; only grazing hits that
    # flip and reroute a path differ.
    beyond = lambda a, b: (np.abs(a - b) / sigma > 3.0).any(axis=-1).mean()
    share_golden = float(beyond(img0, golden))
    share_indep = float(beyond(img0, img1))
    log(f"phase parity: {name} {img0.shape[1]}x{img0.shape[0]} spp=4 "
        f"depth=8 sigma={np.round(sigma, 4).tolist()} "
        f"mean_diff={np.round(d_mean, 5).tolist()} "
        f"mean_tol={np.round(mean_tol, 5).tolist()} "
        f"share_beyond_3sigma golden={share_golden:.4f} "
        f"independent={share_indep:.4f} "
        f"bitwise_equal_pixels={float((img0 == golden).all(-1).mean()):.4f} "
        f"max_abs_diff={float(np.abs(img0 - golden).max()):.4g}")
    assert (d_mean < mean_tol).all(), "parity: per-channel means differ"
    assert share_golden <= share_indep, "parity: too many pixels differ"


def phase_multi(devs):
    import numpy as np

    from raytrace_tpu.engine import Renderer
    from raytrace_tpu.models import compile_scene
    from raytrace_tpu.parallel import MultiChipRenderer, make_mesh
    from raytrace_tpu.scene_file import SceneFile
    from raytrace_tpu.utils.paths import FLAGSHIP_SCENE

    assert len(devs) >= 4, f"--multi needs 4 GPUs, found {len(devs)}"
    devs = devs[:4]
    sf = SceneFile.load_json(FLAGSHIP_SCENE)
    sf.render.sample_batches = 3
    cs = compile_scene(sf)

    single = Renderer(cs)
    first, steady, rate = render_timed(single, 3)
    ref = single.image()
    log(f"phase multi: single-gpu {single.static.width}x"
        f"{single.static.height} batches=3 first_batch_s={first:.2f} "
        f"render_s={steady:.4f}/batch rays={single.stats.rays_traced:.0f} "
        f"mrays_per_s={rate / 1e6:.2f}")

    for label, mesh in (("px x sp = 2x2", make_mesh(devs, sp=2)),
                        ("px x sp x sc = 1x2x2", make_mesh(devs, sp=2, sc=2))):
        r = MultiChipRenderer(cs, mesh=mesh)
        first, steady, rate = render_timed(r, 3)
        img = r.image()
        check_image(img, ref.shape, label)
        shard_devs = sorted({str(s.device) for s in r.accum.addressable_shards})
        diff = np.abs(img - ref).max(axis=-1)
        log(f"phase multi: {label} axes={dict(mesh.shape)} first_batch_s="
            f"{first:.2f} render_s={steady:.4f}/batch "
            f"rays={r.stats.rays_traced:.0f} mrays_per_s={rate / 1e6:.2f} "
            f"shard_devices={shard_devs} max_abs_diff={float(diff.max()):.3g} "
            f"share_over_2e-5={float((diff > 2e-5).mean()):.5f}")
        assert len(shard_devs) == 4, shard_devs
        # Same RNG streams; only the order of the sample sum differs, so
        # pixels agree to float rounding (2e-5, as on the CPU mesh) except
        # the rare near-tie hit that a different fusion flips.
        assert (diff > 2e-5).mean() < 0.005, label
        np.testing.assert_allclose(img.mean(), ref.mean(), rtol=1e-4)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-GPU MultiChipRenderer phase")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)

    devs = require_gpu()
    sys.path.insert(0, REPO)
    import jax

    log(f"card: {card_line()}")
    log(f"jax {jax.__version__} device_kind={devs[0].device_kind} "
        f"count={len(devs)}")
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".smoke_") as work:
        if args.multi:
            phase_multi(devs)
        else:
            phases = [p for p in args.phases.split(",") if p]
            unknown = set(phases) - set(PHASES)
            if unknown:
                ap.error(f"unknown phases {sorted(unknown)}")
            for p in phases:
                _, dt = timed(lambda: {
                    "main": lambda: phase_main(work),
                    "routes": phase_routes,
                    "kernels": lambda: phase_kernels(devs),
                    "parity": phase_parity,
                }[p]())
                log(f"phase {p}: done in {dt:.1f}s")
    log(f"total {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
