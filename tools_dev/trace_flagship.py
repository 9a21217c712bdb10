"""Device time breakdown of the flagship render on one GPU.

    python tools_dev/trace_flagship.py [--batches 3] [--out chiprun_out]

Renders final-one-weekend at 1024x576 (shipped configuration), warms up
one batch, then traces `--batches` batches with jax.profiler and reduces
the trace: the device's busy and idle share of the traced window (busy =
union of the intervals in which a GPU op runs) and the ops that take the
most device time.  Writes <out>/trace_summary.json and prints it.
Refuses to run without a GPU.
"""

import argparse
import glob
import json
import os
import shutil
import sys
import tempfile
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def reduce_trace(path: str, t0_ns: float = None, t1_ns: float = None) -> dict:
    """Busy/idle share and top ops of every GPU plane in an .xplane.pb."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    out = {"planes": {}, "all_planes": {}}
    for plane in pd.planes:
        lines = {ln.name: ln for ln in plane.lines}
        out["all_planes"][plane.name] = sorted(lines)[:20]
        if not plane.name.startswith("/device:GPU"):
            continue
        # Kernel events: the "XLA Ops" line where the profiler names ops,
        # else every stream line.
        use = ([lines["XLA Ops"]] if "XLA Ops" in lines else
               [ln for name, ln in lines.items() if name.startswith("Stream")])
        ivals, per_op = [], defaultdict(float)
        for ln in use:
            for ev in ln.events:
                ivals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                per_op[ev.name] += ev.duration_ns
        if not ivals:
            continue
        ivals.sort()
        lo = ivals[0][0] if t0_ns is None else t0_ns
        hi = max(e for _, e in ivals) if t1_ns is None else t1_ns
        busy, cur_s, cur_e = 0.0, None, None
        for s, e in ivals:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        window = hi - lo
        top = sorted(per_op.items(), key=lambda kv: -kv[1])[:12]
        out["planes"][plane.name] = {
            "lines": sorted(lines),
            "window_ms": window / 1e6,
            "busy_ms": busy / 1e6,
            "idle_share": 1.0 - busy / window if window > 0 else None,
            "n_ops": len(ivals),
            "top_ops_ms": [(name, d / 1e6) for name, d in top],
        }
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()

    import jax

    if jax.devices()[0].platform != "gpu":
        sys.exit("trace_flagship: no GPU")
    from raytrace_tpu.engine import Renderer
    from raytrace_tpu.models import compile_scene
    from raytrace_tpu.scene_file import SceneFile
    from raytrace_tpu.utils.paths import FLAGSHIP_SCENE
    from raytrace_tpu.utils.profiling import trace

    cs = compile_scene(SceneFile.load_json(FLAGSHIP_SCENE))
    r = Renderer(cs)
    r.render_next_batch()                                # compile + warm
    tmp = tempfile.mkdtemp(prefix=".trace_", dir=".")
    try:
        t0 = time.perf_counter()
        with trace(tmp):
            for _ in range(args.batches):
                r.render_next_batch()
        wall = time.perf_counter() - t0
        path = glob.glob(os.path.join(tmp, "**", "*.xplane.pb"),
                         recursive=True)[0]
        summary = reduce_trace(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary.update({"scene": "final-one-weekend 1024x576", "batches":
                    args.batches, "wall_s_traced": wall,
                    "rows_per_tile": r.rows_per_tile,
                    "device_kind": jax.devices()[0].device_kind})
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "trace_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
