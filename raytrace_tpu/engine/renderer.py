"""Renderer facade: progressive batched rendering with accumulation,
checkpoint/resume, metrics and PNG export.

Plays the role of the reference's Scene + RenderEngine (scene.rs:24-92,
render_engine.rs:422-571): each call to `render_next_batch` traces one
sample batch and folds it into the running mean; `render_all` drives every
batch.  The accumulation image lives in device memory between batches; resume state
(batch index + accumulation buffer) can be saved/loaded — an upgrade over
the reference, which loses progress on exit.
"""

from __future__ import annotations

import dataclasses
import functools
import time as _time
from dataclasses import dataclass
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.compile import CompiledScene
from ..ops import camera as cam_ops
from ..utils.image import write_png
from .arrays import SceneArrays, SceneStatic, upload_scene

# The reference seeds its host RNG with this fixed value
# (render_engine.rs:116); we use it for the batch-time jitter stream.
HOST_SEED = 485_674_845_675_491


def get_batch_ray_times(sample_batches: int, seed: int = HOST_SEED) -> np.ndarray:
    """Jittered stratified shutter times over [0,1], biased around cell
    centers (render_engine.rs:700-710), drawn from the same ChaCha20
    stream the reference seeds at engine construction
    (render_engine.rs:116) — the times match the reference bitwise
    (tools/chacha.py replicates rand 0.9's stream + float conversion)."""
    from ..tools.chacha import ChaCha20Rng

    rng = ChaCha20Rng.seed_from_u64(seed)
    f = np.float32
    d = f(1.0) / f(sample_batches)
    out = []
    for i in range(sample_batches):
        t_center = (f(i) + f(0.5)) * d
        jitter = f(rng.f32_range(-0.5, 0.5))
        out.append(np.clip(t_center + jitter * d, f(0.0), f(1.0)))
    return np.asarray(out, np.float32)


@functools.lru_cache(maxsize=64)
def _cached_prepare(static):
    from .wavefront import prepare_batch

    return jax.jit(functools.partial(prepare_batch, static))


@functools.lru_cache(maxsize=64)
def _cached_tile(static, rows_per_tile: int, use_dof: bool):
    from .wavefront import render_tile_step

    return jax.jit(functools.partial(
        render_tile_step, static, rows_per_tile=rows_per_tile, use_dof=use_dof
    ))


@functools.partial(jax.jit, static_argnums=(0,), donate_argnums=(1,))
def _finish_batch(height, accum, tiles, ray_counts, b):
    img = jnp.concatenate(tiles, axis=0)[:height]
    bf = b.astype(jnp.float32)
    return (bf * accum + img) / (bf + 1.0), jnp.sum(jnp.stack(ray_counts))


@jax.jit
def _debug_scan(accum):
    """Per-batch validation reduction (one tiny fused kernel): non-finite
    count, negative count, max channel value over the accumulation."""
    finite = jnp.isfinite(accum)
    return (jnp.sum(~finite), jnp.sum(jnp.where(finite, accum, 0.0) < 0.0),
            jnp.max(jnp.where(finite, accum, 0.0)))


@dataclass
class DebugStats:
    """`debug=True` counters — the validation-layer analogue of the
    reference's Vulkan debug callback (bin/src/app.rs:317-369): instead of
    driver messages, every batch's accumulation is scanned for non-finite /
    negative / energy-violating radiance."""
    checks: int = 0
    nonfinite_values: int = 0
    negative_values: int = 0
    max_radiance: float = 0.0
    energy_bound: float = 0.0


class DebugValidationError(RuntimeError):
    pass


@dataclass
class RenderStats:
    batches_done: int = 0
    rays_traced: float = 0.0
    render_seconds: float = 0.0

    @property
    def mrays_per_sec(self) -> float:
        if self.render_seconds <= 0:
            return 0.0
        return self.rays_traced / self.render_seconds / 1e6


#: Primary rays per tile dispatch (rows x width x spp).  Chosen on the
#: H100 (CHANGES.md, PERF.md): final-one-weekend at 1024x576 renders
#: ~2.2x faster as one 2.36M-ray tile than as three 2^20-ray tiles,
#: because every tile runs its own depth-50 bounce tail; 2^23 measured
#: no faster.  The SAH BVH path also got faster with every larger tile
#: measured (2^15 -> 2^19, 2,033,920 triangles at 256x144).
RAY_BUDGET = 1 << 22
#: Above this many triangles the "auto" policy traces through the SAH
#: BVH; at or below it a dense sweep is faster.
TRI_SWEEP_MAX = 8192


def rows_for_budget(height: int, width: int, spp: int, budget: int) -> int:
    """Rows per tile so one dispatch traces about `budget` primary rays,
    balanced so the last tile is not mostly padding (675 rows at a
    218-row budget would otherwise render a 4th tile that is 90% waste)."""
    budget_rows = max(1, budget // (width * max(1, spp)))
    n_tiles = max(1, -(-height // budget_rows))
    return -(-height // n_tiles)


class SceneSetup(NamedTuple):
    compiled: CompiledScene   # soup permuted into BVH order when bvh is set
    bvh: object
    scene: SceneArrays
    static: SceneStatic
    batch_times: np.ndarray
    sphere_tables: Optional[np.ndarray]   # [B,S,5] world tables, or None


def setup_scene(compiled: CompiledScene, use_bvh="auto", leaf_size: int = 4,
                use_pallas_sweep: Optional[bool] = None,
                pallas_interpret: bool = False) -> SceneSetup:
    """Scene setup shared by the single-device and the sharded renderer:
    BVH policy and build, upload, per-batch shutter times, world-space
    sphere tables and the choice of closest-hit sweep.

    use_pallas_sweep=None takes the platform's default (platform.py);
    pallas_interpret runs the Pallas kernels in interpret mode, which
    only tests ask for."""
    from ..ops.spheres import world_sphere_tables
    from ..platform import use_triton_sweeps

    if use_bvh == "auto":
        use_bvh = compiled.num_triangles > TRI_SWEEP_MAX
    bvh = None
    if use_bvh and compiled.num_triangles > 0:
        from ..models.bvh_build import build_bvh, build_bvh_sah, permute_soup

        # Prefer the native binned-SAH builder (far better tree quality
        # than the Morton/implicit fallback).
        bvh = build_bvh_sah(compiled, leaf_max=8)
        if bvh is None:
            bvh = build_bvh(compiled, leaf_size=leaf_size)
        compiled = permute_soup(compiled, bvh)
    scene, static = upload_scene(compiled, bvh=bvh)
    batch_times = get_batch_ray_times(compiled.render.sample_batches)
    # World-space sphere tables per batch time (host f64 -> f32); None
    # when a sphere instance has non-uniform scale (ellipsoid path).
    sphere_tables = (world_sphere_tables(compiled, batch_times)
                     if static.has_spheres else None)
    world_mode = sphere_tables is not None
    if use_pallas_sweep is None:
        use_pallas_sweep = use_triton_sweeps()
    static = dataclasses.replace(
        static,
        sphere_world_mode=world_mode,
        # The object-space (ellipsoid) sphere path has no kernel.
        use_pallas_sweep=bool(use_pallas_sweep)
        and (world_mode or not static.has_spheres),
        pallas_interpret=pallas_interpret,
    )
    return SceneSetup(compiled, bvh, scene, static, batch_times,
                      sphere_tables)


class Renderer:
    def __init__(
        self,
        compiled: CompiledScene,
        camera_name: Optional[str] = None,
        rows_per_tile: Optional[int] = None,
        trace_builder=None,
        use_bvh="auto",
        leaf_size: int = 4,
        metrics_jsonl: Optional[str] = None,
        use_pallas_sweep: Optional[bool] = None,
        pallas_interpret: bool = False,
        debug: bool = False,
    ):
        from ..utils.cache import enable_compilation_cache

        enable_compilation_cache()
        # Kept so update_image_size can rebuild with identical options.
        self._ctor_kwargs = dict(
            camera_name=camera_name, trace_builder=trace_builder,
            use_bvh=use_bvh, leaf_size=leaf_size,
            metrics_jsonl=metrics_jsonl, use_pallas_sweep=use_pallas_sweep,
            pallas_interpret=pallas_interpret, debug=debug,
        )
        self.debug = debug
        setup = setup_scene(compiled, use_bvh=use_bvh, leaf_size=leaf_size,
                            use_pallas_sweep=use_pallas_sweep,
                            pallas_interpret=pallas_interpret)
        compiled = self.compiled = setup.compiled
        self.bvh = setup.bvh
        self.scene, self.static = setup.scene, setup.static
        self.batch_times = setup.batch_times
        self.sphere_tables = setup.sphere_tables

        name = camera_name or compiled.render.camera
        if name not in compiled.cameras:
            raise KeyError(f"Camera {name} not found")
        self.camera = cam_ops.build_camera_arrays(
            compiled.cameras[name], self.static.width, self.static.height
        )

        if rows_per_tile is None:
            rows_per_tile = rows_for_budget(
                self.static.height, self.static.width,
                self.static.sqrt_spp ** 2, RAY_BUDGET)
        self.rows_per_tile = min(rows_per_tile, self.static.height)

        use_dof = compiled.cameras[name].aperture_size > 0.0
        if trace_builder is None:
            # Module-level executable cache: a new Renderer for the same
            # (scene-static, tiling) reuses compiled programs instead of
            # re-tracing (tests build many Renderers).
            self._prepare = _cached_prepare(self.static)
            self._tile = _cached_tile(self.static, self.rows_per_tile, use_dof)
        else:
            from .wavefront import prepare_batch, render_tile_step

            self._prepare = jax.jit(functools.partial(prepare_batch, self.static))
            self._tile = jax.jit(
                functools.partial(
                    render_tile_step, self.static,
                    rows_per_tile=self.rows_per_tile, use_dof=use_dof,
                    trace_builder=trace_builder,
                )
            )
        self._finish = functools.partial(_finish_batch, self.static.height)

        self.accum = jnp.zeros(
            (self.static.height, self.static.width, 3), jnp.float32
        )
        self.current_batch = 0
        # Runtime-adjustable (traced, never recompiles).
        self.max_depth = compiled.render.max_ray_depth
        self.stats = RenderStats()
        self.debug_stats = None
        if debug:
            # Loose per-path radiance ceiling: every additive term is a
            # product of albedos (<=1 each) times one emission (or the
            # sky, <=1), and NEE adds at most one light term per bounce —
            # so a sample can't exceed emax * (depth + 2) without a bug
            # (zero-pdf blowup, un-guarded 0/0, ...).
            emax = max(1.0, float(compiled.const_colours.max()))
            self.debug_stats = DebugStats(
                energy_bound=emax * (self.max_depth + 2))
        from ..utils.profiling import BatchMetrics

        self.metrics = BatchMetrics(
            pixels=self.static.width * self.static.height,
            spp=self.static.sqrt_spp ** 2,
            jsonl_path=metrics_jsonl,
        )

    # ------------------------------------------------------------- debug

    def _debug_check(self, batch: int) -> None:
        """debug=True: validate the accumulation after a batch (finite,
        non-negative, energy-bounded) — raises DebugValidationError with
        the batch index on the first violation."""
        if self.debug_stats is None:
            return
        nonf, neg, mx = _debug_scan(self.accum)
        st = self.debug_stats
        st.checks += 1
        st.nonfinite_values += int(nonf)
        st.negative_values += int(neg)
        st.max_radiance = max(st.max_radiance, float(mx))
        if int(nonf) or int(neg):
            raise DebugValidationError(
                f"batch {batch}: {int(nonf)} non-finite / {int(neg)} "
                f"negative accumulation values")
        if float(mx) > st.energy_bound:
            raise DebugValidationError(
                f"batch {batch}: radiance {float(mx):.3g} exceeds energy "
                f"bound {st.energy_bound:.3g}")

    # ------------------------------------------------------------- steps

    def render_next_batch(self) -> bool:
        """Trace one sample batch; returns False when all batches are done
        (render_engine.rs:464-466 semantics)."""
        if self.current_batch >= self.compiled.render.sample_batches:
            return False
        t0 = _time.perf_counter()
        sph_table = (
            self.sphere_tables[self.current_batch]
            if self.sphere_tables is not None else None
        )
        geom = self._prepare(
            self.scene, jnp.float32(self.batch_times[self.current_batch]),
            sph_table=sph_table,
        )
        tiles, ray_counts = [], []
        for row0 in range(0, self.static.height, self.rows_per_tile):
            tile, tr = self._tile(
                self.scene, geom, self.camera,
                jnp.int32(self.current_batch), jnp.int32(row0),
                max_depth=jnp.int32(self.max_depth),
            )
            tiles.append(tile)
            ray_counts.append(tr)
        self.accum, rays_dev = self._finish(
            self.accum, tiles, ray_counts, jnp.int32(self.current_batch)
        )
        rays = float(rays_dev)  # blocks until the batch finishes
        self._debug_check(self.current_batch)
        dt = _time.perf_counter() - t0
        self.metrics.record(self.current_batch, dt, rays)
        self.current_batch += 1
        self.stats.batches_done += 1
        self.stats.rays_traced += rays
        self.stats.render_seconds += dt
        return True

    def compiled_tile(self):
        """The tile step compiled ahead of time for this renderer's shapes
        (for memory_analysis / cost_analysis)."""
        sph_table = (self.sphere_tables[0] if self.sphere_tables is not None
                     else None)
        geom = self._prepare(self.scene, jnp.float32(self.batch_times[0]),
                             sph_table=sph_table)
        return self._tile.lower(
            self.scene, geom, self.camera, jnp.int32(0), jnp.int32(0),
            max_depth=jnp.int32(self.max_depth)).compile()

    def render_batches(self, k: int) -> int:
        """Render up to k batches; returns the number rendered."""
        done = 0
        while done < k and self.render_next_batch():
            done += 1
        return done

    def render_all(self, progress=None) -> np.ndarray:
        while self.render_next_batch():
            if progress is not None:
                progress(self.current_batch,
                         self.compiled.render.sample_batches)
        return self.image()

    def image(self) -> np.ndarray:
        """Current linear-light accumulation image [H,W,3]."""
        return np.asarray(self.accum)

    def save_png(self, path: str) -> None:
        write_png(path, self.image())

    # -------------------------------------------------------- checkpoints

    def save_checkpoint(self, path: str) -> None:
        np.savez(
            path,
            accum=self.image(),
            current_batch=self.current_batch,
            width=self.static.width,
            height=self.static.height,
        )

    def load_checkpoint(self, path: str) -> None:
        data = np.load(path if path.endswith(".npz") else path + ".npz")
        if (int(data["width"]), int(data["height"])) != (
            self.static.width, self.static.height,
        ):
            raise ValueError("Checkpoint resolution does not match scene")
        self.accum = jnp.asarray(data["accum"])
        self.current_batch = int(data["current_batch"])

    # ------------------------------------------------------------- resize

    def update_image_size(self, width: int, height: int) -> "Renderer":
        """Resize restarts progressive accumulation (render_engine.rs:397-414).
        Returns a NEW renderer compiled for the new resolution, preserving
        every constructor option of this one."""
        cs = dataclasses.replace(
            self.compiled,
            render=dataclasses.replace(self.compiled.render, width=width, height=height),
        )
        return Renderer(cs, rows_per_tile=None, **self._ctor_kwargs)
