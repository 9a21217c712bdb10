"""raytrace_tpu — a wavefront path tracer in JAX.

A from-scratch reimplementation of the capabilities of
hackmad/raytracing-vulkan-rs (a Vulkan KHR ray-tracing-pipeline path tracer)
as a JAX/XLA/Pallas framework whose accelerator is an NVIDIA GPU:

- ``scene_file``: JSON scene schema, bit-compatible with the reference.
- ``models``:     geometry — tessellators, OBJ import, scene compiler → SoA.
- ``ops``:        device kernels — RNG, camera rays, BVH traversal,
                  intersection, materials, textures, sky, NEE/MIS.
- ``engine``:     the render engine — jit'd wavefront batch step, progressive
                  accumulation, checkpoint/resume, metrics.
- ``parallel``:   multi-device sharding of the ray wavefront over a mesh.
- ``platform``:   which platform the arrays live on and which sweeps run.
- ``utils``:      image IO, colour conversion, profiling, paths, cache.
- ``tools``:      scene generators (final-one-weekend etc.).

The reference's raygen/closest-hit/miss shader split, descriptor sets, SBT
and swapchain dissolve here: a scene compiles to a pytree of padded arrays,
and a single jit'd function renders one progressive sample batch end-to-end
on device with no host round-trips per bounce.
"""

__version__ = "0.1.0"
