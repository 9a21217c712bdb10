"""Command-line app — the reference's `bin` crate.

The reference's winit window + swapchain dissolve into progressive PNG
output: each sample batch refines the accumulation image, and the renderer
writes the current state on request or at completion.  Checkpoint/resume
persists (batch index, accumulation buffer) — an upgrade over the
reference, which loses all progress on exit (SURVEY.md §5).

Usage:
  python -m raytrace_tpu.cli render --path scene.json [-o out.png]
      [--width W] [--height H] [--mesh-geometry] [--checkpoint ck.npz]
      [--resume] [--multichip [--scene-shards N]] [--preview-every N]
  python -m raytrace_tpu.cli gen-final-one-weekend [--out-dir assets]
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

from .utils.paths import FLAGSHIP_SCENE

log = logging.getLogger("raytrace_tpu")


def cmd_render(args) -> int:
    from .models import compile_scene
    from .scene_file import SceneFile
    from .engine import Renderer

    scene = SceneFile.load_json(args.path)
    scene.validate()
    cs = compile_scene(
        scene, width=args.width, height=args.height,
        analytic_spheres=not args.mesh_geometry,
    )
    log.info(
        "scene: %d instances, %d spheres, %d triangles, %dx%d, %d spp x %d batches",
        cs.num_instances, cs.num_spheres, cs.num_triangles,
        cs.render.width, cs.render.height,
        cs.render.samples_per_pixel, cs.render.sample_batches,
    )

    out = args.output or (os.path.splitext(os.path.basename(args.path))[0] + ".png")

    from .scene_file import SceneError

    if args.scene_shards < 1:
        raise SceneError(f"--scene-shards must be >= 1, got {args.scene_shards}")
    if args.multichip:
        from .parallel import MultiChipRenderer, make_mesh

        try:
            mesh = (make_mesh(sc=args.scene_shards)
                    if args.scene_shards > 1 else None)
            renderer = MultiChipRenderer(cs, mesh=mesh,
                                         metrics_jsonl=args.metrics_jsonl)
        except ValueError as e:
            raise SceneError(str(e))
    elif args.scene_shards > 1:
        raise SceneError("--scene-shards requires --multichip")
    else:
        renderer = Renderer(cs, debug=args.debug,
                            metrics_jsonl=args.metrics_jsonl)

    if args.resume and args.checkpoint and os.path.exists(args.checkpoint):
        renderer.load_checkpoint(args.checkpoint)
        log.info("resumed at batch %d", renderer.current_batch)

    t0 = time.perf_counter()
    total = cs.render.sample_batches
    while renderer.render_next_batch():
        batch = renderer.current_batch
        log.info("batch %d/%d done", batch, total)
        ds = getattr(renderer, "debug_stats", None)
        if ds is not None:
            log.info(
                "debug: batch %d valid (max radiance %.3g of bound %.3g)",
                batch, ds.max_radiance, ds.energy_bound)
        if args.preview_every and batch % args.preview_every == 0:
            renderer.save_png(out)
        if args.checkpoint:
            renderer.save_checkpoint(args.checkpoint)
    dt = time.perf_counter() - t0

    renderer.save_png(out)
    stats = getattr(renderer, "stats", None)
    if stats is not None:
        log.info(
            "rendered %d batches in %.1fs — %.1f Mrays/s -> %s",
            stats.batches_done, dt, stats.mrays_per_sec, out,
        )
    else:
        log.info("rendered in %.1fs -> %s", dt, out)
    print(out)
    return 0


def cmd_generate(args) -> int:
    from .tools import generate_final_one_weekend_pair

    os.makedirs(args.out_dir, exist_ok=True)
    static, blur = generate_final_one_weekend_pair()
    for scene, name in [(static, "final-one-weekend.json"),
                        (blur, "final-one-weekend-motion-blur.json")]:
        path = os.path.join(args.out_dir, name)
        scene.save_json(path)
        log.info("wrote %s", path)
    return 0


def cmd_view(args) -> int:
    from .viewer import Viewer

    Viewer(args.path, width=args.width, height=args.height,
           port=args.port).serve_forever()
    return 0


def main(argv=None) -> int:
    logging.basicConfig(
        level=os.environ.get("LOGLEVEL", "INFO"),
        format="%(levelname)s %(name)s: %(message)s",
    )
    p = argparse.ArgumentParser(prog="raytrace_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a scene JSON to PNG")
    pr.add_argument("--path", default=FLAGSHIP_SCENE,
                    help="scene file (default: assets/final-one-weekend.json)")
    pr.add_argument("-o", "--output", default=None)
    pr.add_argument("--width", type=int, default=None)
    pr.add_argument("--height", type=int, default=None)
    pr.add_argument("--mesh-geometry", action="store_true",
                    help="tessellate spheres (reference-parity geometry)")
    pr.add_argument("--checkpoint", default=None)
    pr.add_argument("--resume", action="store_true")
    pr.add_argument("--multichip", action="store_true")
    pr.add_argument("--scene-shards", type=int, default=1,
                    help="row-shard the primitive tables over an 'sc' mesh"
                         " axis (scenes too large to replicate per chip);"
                         " needs --multichip")
    pr.add_argument("--preview-every", type=int, default=0,
                    help="write the PNG every N batches (progressive preview)")
    pr.add_argument("--metrics-jsonl", default=None,
                    help="append one JSON line per batch (seconds, rays, "
                         "Mrays/s) to this file")
    pr.add_argument("--debug", action="store_true",
                    help="validate every batch (finite / non-negative / "
                         "energy-bounded accumulation) — the reference's "
                         "Vulkan validation-layer analogue")
    pr.set_defaults(fn=cmd_render)

    pg = sub.add_parser("gen-final-one-weekend",
                        help="generate the RTiOW final scene files")
    pg.add_argument("--out-dir", default="assets")
    pg.set_defaults(fn=cmd_generate)

    pv = sub.add_parser(
        "view", help="interactive progressive viewer (browser; hot-swap "
                     "+ resize like the reference's windowed app)")
    pv.add_argument("path", nargs="?", default=FLAGSHIP_SCENE)
    pv.add_argument("--width", type=int, default=None)
    pv.add_argument("--height", type=int, default=None)
    pv.add_argument("--port", type=int, default=8000)
    pv.set_defaults(fn=cmd_view)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        log.error("file not found: %s", e.filename or e)
        return 2
    except Exception as e:
        # Scene/config errors get a clean message (the reference's anyhow
        # chain equivalent); unexpected errors keep the traceback.
        from .scene_file import SceneError

        if isinstance(e, SceneError):
            log.error("%s", e)
            return 2
        from .engine.renderer import DebugValidationError

        if isinstance(e, DebugValidationError):
            log.error("debug validation failed: %s", e)
            return 3
        raise


if __name__ == "__main__":
    sys.exit(main())
