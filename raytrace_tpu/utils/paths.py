"""Locations inside the checkout.

Everything the program reads or writes by default lives under the
repository root: the shipped scenes in ``assets/`` and the persistent
compile cache in ``.jax_cache/`` (utils/cache.py).
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ASSETS_DIR = os.path.join(REPO_ROOT, "assets")
FLAGSHIP_SCENE = os.path.join(ASSETS_DIR, "final-one-weekend.json")


def asset(name: str) -> str:
    """Path of a scene or mesh shipped in ``assets/``."""
    return os.path.join(ASSETS_DIR, name)
