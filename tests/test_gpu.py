"""Geometry precision on the device: the per-batch triangle refit must
match the host f64 transform, which an f32 contraction running in TF32
(the GPU's default for unannotated f32 products) would break by ~1e-3.

The `gpu`-marked test skips on the CPU (gpu_device fixture) and runs on
the card from chip_smoke.py's kernels phase; its CPU twin runs the same
check here.  This module imports nothing from conftest, so chip_smoke.py
can load it without pinning the CPU.
"""

import numpy as np
import pytest

#: Scene-scale relative bound: max |refit - host| / max |host|.  f32
#: rounding of a few chained products gives ~1e-7; TF32 gives ~1e-3.
REFIT_RTOL = 1e-6


def refit_rel_error(device) -> float:
    """Largest refit error of the quad-box scene with one animated box,
    at a batch time inside the shutter, relative to the scene's extent."""
    import jax
    import jax.numpy as jnp

    from raytrace_tpu.models import compile_scene
    from raytrace_tpu.models.bvh_build import _instance_matrix_at
    from raytrace_tpu.ops import transforms
    from raytrace_tpu.scene_file import Rotate, Transform, TransformType
    from raytrace_tpu.tools import generate_quad_box_scene

    sf = generate_quad_box_scene()
    tall = next(i for i in sf.instances if i.name == "tall")
    tall.transform = TransformType(
        start=tall.transform.start,
        end=Transform(translate=[301.0, 540.0, 270.0],
                      rotate=Rotate(axis=[0.3, 1.0, 0.1], degrees=-40.0),
                      scale=[1.1, 0.9, 1.05]))
    cs = compile_scene(sf, width=8, height=8)
    t = 0.37

    put = lambda a: jax.device_put(np.asarray(a, np.float32), device)
    refit = jax.jit(lambda t0, t1, p, n, inst, tm: transforms.transform_soup(
        p, n, inst, transforms.interpolate_instances(t0, t1, tm)))
    world_p, _ = refit(put(cs.inst_t0), put(cs.inst_t1), put(cs.tri_p),
                       put(cs.tri_n), jax.device_put(cs.tri_inst, device),
                       jnp.float32(t))
    n = cs.num_triangles
    m = _instance_matrix_at(cs.inst_t0.astype(np.float64),
                            cs.inst_t1.astype(np.float64), t)[cs.tri_inst[:n]]
    host = (np.einsum("tij,tvj->tvi", m[:, :, :3],
                      cs.tri_p[:n].astype(np.float64))
            + m[:, None, :, 3])
    got = np.asarray(world_p, np.float64)[:n]
    return float(np.abs(got - host).max() / np.abs(host).max())


@pytest.mark.gpu
def test_refit_matches_host_f64(gpu_device):
    err = refit_rel_error(gpu_device)
    assert err < REFIT_RTOL, f"refit relative error {err:.3g}"


def test_refit_matches_host_f64_cpu():
    import jax

    err = refit_rel_error(jax.devices("cpu")[0])
    assert err < REFIT_RTOL, f"refit relative error {err:.3g}"
