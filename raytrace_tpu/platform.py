"""Where the arrays live, and which closest-hit sweeps run there.

The one place that asks JAX for its backend.  Every other module takes
its answer from here, so a new platform changes one function.
"""

from __future__ import annotations

import jax


def platform() -> str:
    """The platform of JAX's default devices: "gpu", "cpu", ..."""
    return jax.default_backend()


def use_triton_sweeps() -> bool:
    """Whether the hand-written Pallas-Triton sweeps (ops/pallas_sweep.py,
    ops/pallas_tri_sweep.py) run by default: on the GPU only.  Everywhere
    else the plain XLA sweeps run; interpret mode is never chosen here,
    only by a caller that asks for it."""
    return platform() == "gpu"
