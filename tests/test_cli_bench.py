"""CLI + bench harness shape tests (CPU, tiny scenes)."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, env_extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    if env_extra:
        env.update(env_extra)
    code = (
        "import sys, jax; jax.config.update('jax_platforms','cpu');"
        + args
    )
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=500)


def test_bench_json_shape(tmp_path):
    out = _run(
        "import bench; bench.main()",
        env_extra={
            "BENCH_SCENE": "final-one-weekend.json",
            "BENCH_WIDTH": "32",
            "BENCH_HEIGHT": "18",
            "BENCH_BATCHES": "2",
        },
    )
    assert out.returncode == 0, out.stderr[-500:]
    line = out.stdout.strip().splitlines()[-1]
    data = json.loads(line)
    assert data["metric"] == "mrays_per_sec"
    assert data["unit"] == "Mrays/s"
    assert data["value"] > 0
    # The line names the device it ran on (here the CPU, never a card).
    assert data["device"]["platform"] == "cpu"
    assert data["device"]["count"] >= 1


def test_cli_render_exit_codes(tmp_path):
    out = _run("from raytrace_tpu.cli import main; sys.exit(main(['render','--path','/nope.json']))")
    assert out.returncode == 2
    out = _run(
        "from raytrace_tpu.cli import main; sys.exit(main(['render',"
        "'--path','assets/final-one-weekend.json','--width','24',"
        f"'-o','{tmp_path}/t.png']))"
    )
    assert out.returncode == 0
    assert os.path.exists(tmp_path / "t.png")
