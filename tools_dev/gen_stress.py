"""Generate sphere-count stress variants of final-one-weekend: the 484
grid spheres tiled kxk with world-space offsets (22 units apart, the
grid's footprint) — 4x/9x/16x scenes for the sub-linear-scaling bench.

    python tools_dev/gen_stress.py 2      # -> stress-4x.json
"""

import copy
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    k = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    from raytrace_tpu.utils.paths import FLAGSHIP_SCENE

    with open(FLAGSHIP_SCENE) as f:
        doc = json.load(f)
    prims = doc["primitives"]
    insts = {i["name"]: i for i in doc["instances"]}
    grid = [p for p in prims
            if "uv_sphere" in p and p["uv_sphere"]["name"].startswith("sphere_")]
    new_prims, new_insts = [], []
    for ti in range(k):
        for tj in range(k):
            if ti == 0 and tj == 0:
                continue
            for p in grid:
                b = copy.deepcopy(p["uv_sphere"])
                b["name"] = f'{b["name"]}_t{ti}{tj}'
                b["center"] = [b["center"][0] + 22.5 * ti, b["center"][1],
                               b["center"][2] + 22.5 * tj]
                new_prims.append({"uv_sphere": b})
                new_insts.append({"name": b["name"]})
    doc["primitives"].extend(new_prims)
    doc["instances"].extend(new_insts)
    out = f"stress-{k*k}x.json"
    with open(out, "w") as f:
        json.dump(doc, f)
    n = sum(1 for p in doc["primitives"] if "uv_sphere" in p)
    print(f"{out}: {n} spheres")


if __name__ == "__main__":
    main()
