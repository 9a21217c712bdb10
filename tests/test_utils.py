"""Utility-layer tests: metrics, image IO round-trips, sRGB transfer."""

import json
import os

import numpy as np

from raytrace_tpu.utils.image import (
    linear_to_srgb,
    read_png_linear,
    rmse,
    srgb_to_linear,
    to_srgb_u8,
    write_png,
)
from raytrace_tpu.utils.profiling import BatchMetrics


def test_srgb_round_trip():
    x = np.linspace(0, 1, 256).reshape(16, 16)
    np.testing.assert_allclose(srgb_to_linear(linear_to_srgb(x)), x, atol=1e-6)
    # Known anchor points of the transfer function.
    np.testing.assert_allclose(linear_to_srgb(np.array(0.0)), 0.0, atol=1e-7)
    np.testing.assert_allclose(linear_to_srgb(np.array(1.0)), 1.0, atol=1e-6)
    np.testing.assert_allclose(linear_to_srgb(np.array(0.5)), 0.7353569, atol=1e-5)


def test_srgb_clamps_hdr():
    assert to_srgb_u8(np.array([[[15.0, -1.0, 0.5]]])).tolist() == [[[255, 0, 188]]]


def test_png_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (20, 30, 3)).astype(np.float32)
    p = str(tmp_path / "t.png")
    write_png(p, img)
    back = read_png_linear(p)
    # 8-bit quantization in sRGB space bounds the linear error.
    assert rmse(img, back) < 0.004


def test_batch_metrics_jsonl(tmp_path):
    path = str(tmp_path / "m.jsonl")
    m = BatchMetrics(pixels=100, spp=4, jsonl_path=path)
    m.record(0, 2.0, 4_000_000)
    m.record(1, 2.0, 4_000_000)
    assert m.total_rays == 8_000_000
    assert abs(m.mrays_per_sec - 2.0) < 1e-9
    assert abs(m.records[0].spp_per_sec - 2.0) < 1e-9
    lines = [json.loads(l) for l in open(path)]
    assert len(lines) == 2 and lines[1]["batch"] == 1


def test_profiler_trace_noop_on_cpu(tmp_path):
    """trace() profiles the CPU backend too and leaves a trace file."""
    import jax.numpy as jnp

    from raytrace_tpu.utils import profiling

    with profiling.trace(str(tmp_path / "trace")):
        jnp.ones(8).sum().block_until_ready()
    found = [f for _, _, fs in os.walk(tmp_path / "trace") for f in fs]
    assert any(f.endswith(".xplane.pb") for f in found), found
