"""Scene generation tools (reference: tools/src/main.rs)."""

from .generate import (generate_final_one_weekend_pair,
                       generate_final_one_weekend_scene,
                       generate_quad_box_scene)

__all__ = ["generate_final_one_weekend_scene",
           "generate_final_one_weekend_pair",
           "generate_quad_box_scene"]
