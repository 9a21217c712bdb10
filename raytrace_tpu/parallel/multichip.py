"""Sharded wavefront rendering over a jax.sharding.Mesh.

Layout:
- mesh axes ("px", "sp"): image rows are sharded over "px"; each pixel's
  samples are split over "sp".
- scene/camera/geometry inputs are replicated (broadcast once).
- each device renders its (row-shard, sample-shard) wavefront fully
  independently — ray bouncing is embarrassingly parallel with shared
  read-only scene state — then one `psum` over "sp" folds partial
  sample sums; the output image shards over "px" with no communication.

The mesh follows the algorithm, not a link topology: the devices of one
host are joined all to all, so any px x sp split is as good as another.

Optional third axis ("sc") SHARDS THE SCENE ITSELF for scenes too large
to replicate per device: primitive tables (and the fat shading rows) are
row-sharded over "sc", rays replicate across it, and every bounce runs
one closest-hit pmin combine plus one-owner masked psums for the
winner's rows (engine/wavefront._sc_combine_hit / _sc_fetch).
make_mesh(sp=, sc=) builds either layout.

This is the multi-device work distribution the reference's architecture
lacked (it renders on one GPU queue).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..engine.arrays import SceneArrays, SceneStatic
from ..engine.wavefront import prepare_batch, render_tile
from ..ops import camera as cam_ops


def make_mesh(devices=None, sp: Optional[int] = None,
              sc: Optional[int] = None) -> Mesh:
    """Build a ("px", "sp") — or ("px", "sp", "sc") — mesh.

    `sp` fixes the sample-axis size (must divide device count); by default
    uses 2 when the device count is even, else 1.  `sc` > 1 adds the
    scene-sharding axis: primitive tables are row-sharded over it and the
    bounce loop combines per-shard hits with pmin/psum collectives — for
    scenes too large to replicate per device.
    """
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    sc = sc or 1
    if sc < 1:
        raise ValueError(f"sc must be >= 1, got {sc}")
    if sp is None:
        rem = max(1, n // sc)
        sp = 2 if rem % 2 == 0 and rem > 1 else 1
    if n % (sp * sc) != 0:
        raise ValueError(
            f"sp*sc = {sp}*{sc} must divide the device count {n}")
    if sc > 1:
        arr = np.asarray(devices).reshape(n // (sp * sc), sp, sc)
        return Mesh(arr, axis_names=("px", "sp", "sc"))
    arr = np.asarray(devices).reshape(n // sp, sp)
    return Mesh(arr, axis_names=("px", "sp"))


def _padded_rows(height: int, n_px: int) -> int:
    return -(-height // n_px)


def sharded_batch_fn(static: SceneStatic, mesh: Mesh, use_dof: bool,
                     rows_inner: Optional[int] = None):
    """Build the jit'd sharded batch step.

    Returns f(scene, geom, cam, sample_batch) -> (image [H_pad, W, 3] sharded
    over rows, rays_traced scalar).

    `rows_inner` bounds rows per kernel dispatch WITHIN a shard (the same
    tile ray budget as the single-device Renderer): a shard's row block
    renders as ceil(rows_local/rows_inner) sequential tiles, which bounds
    the wavefront's working set even at full resolution x 64 spp.
    """
    n_px = mesh.shape["px"]
    n_sp = mesh.shape["sp"]
    spp = static.sqrt_spp ** 2
    if spp % n_sp != 0:
        raise ValueError(f"effective spp {spp} must be divisible by sp={n_sp}")
    spp_local = spp // n_sp
    rows_local = _padded_rows(static.height, n_px)
    if rows_inner is None or rows_inner <= 0:
        rows_inner = rows_local
    rows_inner = min(rows_inner, rows_local)
    n_inner = -(-rows_local // rows_inner)

    def shard_body(scene, geom, cam, sample_batch):
        return _shard_tile_loop(static, scene, geom, cam, sample_batch,
                                use_dof, rows_local, rows_inner, n_inner,
                                spp, spp_local)

    mapped = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=(P("px", None, None), P()),
        check_vma=False,
    )
    return jax.jit(mapped)


def _shard_tile_loop(static, scene, geom, cam, sample_batch, use_dof,
                     rows_local, rows_inner, n_inner, spp, spp_local):
    """Per-shard tile loop shared by the replicated and scene-sharded
    steps: render this ('px','sp') shard's row block in n_inner
    dispatches, then psum sample partials over 'sp'.  Rays replicate
    over any 'sc' axis — psum only ('px','sp')."""
    from ..engine.wavefront import make_trace_fn

    px_rank = jax.lax.axis_index("px")
    sp_rank = jax.lax.axis_index("sp")
    row_base = (px_rank * rows_local).astype(jnp.int32)
    sample_base = (sp_rank * spp_local).astype(jnp.uint32)
    trace = make_trace_fn(static, scene, geom)
    tiles = []
    rays = jnp.float32(0.0)
    for i in range(n_inner):
        rows_i = min(rows_inner, rows_local - i * rows_inner)
        tile_i, rays_i = render_tile(
            static, scene, cam, trace, geom,
            sample_batch, row_base + i * rows_inner, rows_i, use_dof,
            spp_local=spp_local, sample_base=sample_base,
            reduce_mean=False,
        )
        tiles.append(tile_i)
        rays = rays + rays_i
    tile_sum = tiles[0] if n_inner == 1 else jnp.concatenate(tiles, 0)
    tile_sum = jax.lax.psum(tile_sum, "sp")
    rays = jax.lax.psum(rays, ("px", "sp"))
    return tile_sum / spp, rays


# ---------------------------------------------------------------- scene
# sharding ("sc" axis): primitive tables row-sharded across devices, for
# scenes too large to replicate per device.  The bounce loop's collectives
# live in engine/wavefront (_sc_combine_hit / _sc_fetch).

#: per-primitive SceneArrays leaves sharded along "sc" (plus shade_rows,
#: rebuilt family-aware below)
_SC_SPH = ("sph_center", "sph_radius", "sph_inst", "sph_mat_type",
           "sph_mat_index")
_SC_TRI = ("tri_p", "tri_n", "tri_uv", "tri_inst", "tri_mat_type",
           "tri_mat_index")
_SC_SHARDED = _SC_SPH + _SC_TRI + ("shade_rows",)


def _pad_dup(a: np.ndarray, n: int) -> np.ndarray:
    """Pad dim0 to a multiple of n by DUPLICATING the last row: a
    duplicate primitive at a higher id never wins the strict-< closest-
    hit sweep, so the padding is provably inert for any fill content."""
    pad = -(-a.shape[0] // n) * n - a.shape[0]
    if pad == 0:
        return a
    return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], axis=0)


def shard_scene_arrays(scene: SceneArrays, n_sc: int,
                       mesh: Optional[Mesh] = None) -> SceneArrays:
    """Replicated SceneArrays -> stacked [n_sc, local, ...] per-prim
    leaves (family-aware: shade_rows' [spheres | tris] block layout is
    rebuilt per shard so each shard's fat-row table matches its slices);
    all other leaves pass through replicated.  With a mesh, each stacked
    leaf is committed SHARDED over "sc" — a device holds only its slice,
    which is the point of scene sharding."""
    put = (lambda a: jnp.asarray(a)) if mesh is None else (
        lambda a: jax.device_put(a, NamedSharding(mesh, P("sc"))))
    np_of = lambda x: np.asarray(x)
    s_pad = np_of(scene.sph_center).shape[0]
    upd = {}
    for f in _SC_SPH + _SC_TRI:
        a = _pad_dup(np_of(getattr(scene, f)), n_sc)
        upd[f] = put(a.reshape((n_sc, -1) + a.shape[1:]))
    sr = np_of(scene.shade_rows)
    sph_rows = _pad_dup(sr[:s_pad], n_sc).reshape(n_sc, -1, sr.shape[1])
    tri_rows = _pad_dup(sr[s_pad:], n_sc).reshape(n_sc, -1, sr.shape[1])
    upd["shade_rows"] = put(np.concatenate([sph_rows, tri_rows], axis=1))
    return scene._replace(**upd)


def shard_sphere_tables(tables: np.ndarray, n_sc: int) -> np.ndarray:
    """[B, S, 5] world sphere tables -> [B, n_sc, S_local, 5]."""
    B, S = tables.shape[0], tables.shape[1]
    S2 = -(-S // n_sc) * n_sc
    out = np.empty((B, S2, tables.shape[2]), tables.dtype)
    for b in range(B):
        out[b] = _pad_dup(tables[b], n_sc)
    return out.reshape(B, n_sc, S2 // n_sc, tables.shape[2])


def scene_sharded_batch_fn(static: SceneStatic, mesh: Mesh, use_dof: bool,
                           rows_inner: Optional[int] = None):
    """Sharded batch step with SCENE sharding: per-prim scene leaves and
    the per-batch sphere table arrive stacked [n_sc, ...] with P("sc");
    prepare_batch runs on the local slice inside shard_map, so each device
    holds and refits 1/n_sc of the geometry.  Rays replicate over "sc";
    the per-bounce closest-hit pmin + one-owner row psums reproduce the
    replicated render exactly (see wavefront._sc_combine_hit)."""
    n_sc = mesh.shape["sc"]
    assert static.scene_axis == "sc" and static.scene_shards == n_sc
    assert static.use_fat_shading, "scene sharding needs the fat-row ABI"
    assert static.bvh_mode == "none", "scene sharding shards the soup, not a BVH"
    n_px = mesh.shape["px"]
    n_sp = mesh.shape["sp"]
    spp = static.sqrt_spp ** 2
    if spp % n_sp != 0:
        raise ValueError(f"effective spp {spp} must be divisible by sp={n_sp}")
    spp_local = spp // n_sp
    rows_local = _padded_rows(static.height, n_px)
    rows_inner = min(rows_inner or rows_local, rows_local)
    n_inner = -(-rows_local // rows_inner)

    def shard_body(scene_st, sph_tab, time, cam, sample_batch):
        scene = scene_st._replace(
            **{f: getattr(scene_st, f)[0] for f in _SC_SHARDED})
        tab = sph_tab[0] if static.sphere_world_mode else None
        geom = prepare_batch(static, scene, time, sph_table=tab)
        return _shard_tile_loop(static, scene, geom, cam, sample_batch,
                                use_dof, rows_local, rows_inner, n_inner,
                                spp, spp_local)

    scene_specs = SceneArrays(**{
        f: (P("sc") if f in _SC_SHARDED else P())
        for f in SceneArrays._fields})
    mapped = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(scene_specs, P("sc"), P(), P(), P()),
        out_specs=(P("px", None, None), P()),
        check_vma=False,
    )
    return jax.jit(mapped)


@functools.partial(jax.jit, donate_argnums=(0,))
def _fold(accum, img, b):
    """Running mean: fold batch b's image into the mean of b batches."""
    return (b * accum + img) / (b + 1.0)


class MultiChipRenderer:
    """Progressive renderer sharded over a device mesh.

    Matches the single-device Renderer's semantics and feature set — same
    scene setup (engine.renderer.setup_scene), RNG streams and running-
    mean accumulation (a sharded render is bit-identical to the single-
    device one up to float reduction order), per-batch metrics,
    checkpoint/resume and PNG export, plus the single-device tile ray
    budget applied WITHIN each row shard.
    """

    def __init__(self, compiled, mesh: Optional[Mesh] = None,
                 camera_name: Optional[str] = None,
                 use_bvh="auto", leaf_size: int = 4,
                 metrics_jsonl: Optional[str] = None,
                 use_pallas_sweep: Optional[bool] = None,
                 pallas_interpret: bool = False):
        import dataclasses
        import time as _time

        from ..engine.renderer import (RAY_BUDGET, TRI_SWEEP_MAX,
                                       RenderStats, setup_scene)
        from ..utils.cache import enable_compilation_cache
        from ..utils.profiling import BatchMetrics

        enable_compilation_cache()
        self._time = _time
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_sc = dict(self.mesh.shape).get("sc", 1)

        # Scene sharding shards the SOUP, not a BVH: dense sweeps only.
        if use_bvh == "auto":
            use_bvh = (compiled.num_triangles > TRI_SWEEP_MAX
                       and self.n_sc == 1)
        if use_bvh and self.n_sc > 1:
            raise ValueError("scene sharding (sc > 1) does not support a BVH")
        setup = setup_scene(compiled, use_bvh=use_bvh, leaf_size=leaf_size,
                            use_pallas_sweep=use_pallas_sweep,
                            pallas_interpret=pallas_interpret)
        compiled = self.compiled = setup.compiled
        self.bvh = setup.bvh
        self.scene, self.static = setup.scene, setup.static
        self.batch_times = setup.batch_times
        self.sphere_tables = setup.sphere_tables
        if self.n_sc > 1:
            if not self.static.use_fat_shading:
                raise ValueError(
                    "scene sharding needs the fat-row ABI (shade_rows)")
            self.static = dataclasses.replace(
                self.static, scene_axis="sc", scene_shards=self.n_sc)

        name = camera_name or compiled.render.camera
        if name not in compiled.cameras:
            raise KeyError(f"Camera {name} not found")
        self.camera = cam_ops.build_camera_arrays(
            compiled.cameras[name], self.static.width, self.static.height
        )
        use_dof = compiled.cameras[name].aperture_size > 0.0
        if self.n_sc == 1:
            # sc mode prepares INSIDE shard_map (prepare_batch calls
            # axis_index(scene_axis), illegal outside it).
            self._prepare = jax.jit(
                functools.partial(prepare_batch, self.static))

        # Single-device tile ray budget applied per shard.
        n_sp = self.mesh.shape["sp"]
        spp_local = max(1, self.static.sqrt_spp ** 2 // max(1, n_sp))
        rows_inner = max(1, RAY_BUDGET // (self.static.width * spp_local))
        if self.n_sc > 1:
            self._scene_stacked = shard_scene_arrays(
                self.scene, self.n_sc, mesh=self.mesh)
            if self.sphere_tables is not None:
                tabs = shard_sphere_tables(
                    np.asarray(self.sphere_tables), self.n_sc)
            else:
                B = len(self.batch_times)
                tabs = np.zeros((B, self.n_sc, 1, 5), np.float32)
            self._sph_tabs_sc = jax.device_put(
                tabs, NamedSharding(self.mesh, P(None, "sc")))
            # free the replicated per-prim device copies (the whole point
            # of sc mode is not holding the full scene per device); the
            # stacked scene keeps the replicated non-prim leaves.
            tiny = {f: getattr(self.scene, f)[:1] for f in _SC_SHARDED}
            self.scene = self.scene._replace(**tiny)
            self._step = scene_sharded_batch_fn(
                self.static, self.mesh, use_dof, rows_inner=rows_inner)
        else:
            self._step = sharded_batch_fn(self.static, self.mesh, use_dof,
                                          rows_inner=rows_inner)

        H, W = self.static.height, self.static.width
        # The running mean lives row-padded and sharded exactly like the
        # step's output image, so the jitted fold compiles once and never
        # moves the image between devices.
        self._accum_sharding = NamedSharding(self.mesh, P("px", None, None))
        self._h_pad = self.mesh.shape["px"] * _padded_rows(H, self.mesh.shape["px"])
        self.accum = np.zeros((H, W, 3), np.float32)
        self.current_batch = 0
        self.rays_traced = 0.0
        self.stats = RenderStats()
        self.metrics = BatchMetrics(
            pixels=W * H, spp=self.static.sqrt_spp ** 2,
            jsonl_path=metrics_jsonl,
        )

    @property
    def accum(self):
        """Running-mean image [H, W, 3] (a device array)."""
        return self._accum_pad[:self.static.height]

    @accum.setter
    def accum(self, img) -> None:
        img = np.asarray(img, np.float32)
        pad = self._h_pad - img.shape[0]
        img = np.pad(img, ((0, pad), (0, 0), (0, 0)))
        self._accum_pad = jax.device_put(img, self._accum_sharding)

    def render_next_batch(self) -> bool:
        if self.current_batch >= self.compiled.render.sample_batches:
            return False
        t0 = self._time.perf_counter()
        if self.n_sc > 1:
            img_pad, rays = self._step(
                self._scene_stacked,
                self._sph_tabs_sc[self.current_batch],
                jnp.float32(self.batch_times[self.current_batch]),
                self.camera, jnp.int32(self.current_batch),
            )
        else:
            sph_table = (
                self.sphere_tables[self.current_batch]
                if self.sphere_tables is not None else None
            )
            geom = self._prepare(
                self.scene,
                jnp.float32(self.batch_times[self.current_batch]),
                sph_table=sph_table,
            )
            img_pad, rays = self._step(
                self.scene, geom, self.camera, jnp.int32(self.current_batch)
            )
        self._accum_pad = _fold(self._accum_pad, img_pad,
                                jnp.float32(self.current_batch))
        rays = float(rays)  # blocks until the batch finishes
        dt = self._time.perf_counter() - t0
        self.metrics.record(self.current_batch, dt, rays)
        self.rays_traced += rays
        self.current_batch += 1
        self.stats.batches_done += 1
        self.stats.rays_traced += rays
        self.stats.render_seconds += dt
        return True

    def render_batches(self, k: int) -> int:
        """Render up to k batches; returns the number rendered."""
        done = 0
        while done < k and self.render_next_batch():
            done += 1
        return done

    def render_all(self) -> np.ndarray:
        while self.render_next_batch():
            pass
        return np.asarray(self.accum)

    def image(self) -> np.ndarray:
        return np.asarray(self.accum)

    def save_png(self, path: str) -> None:
        from ..utils.image import write_png

        write_png(path, self.image())

    # ------------------------------------------------- checkpoint/resume
    # Same npz format as the single-device Renderer: checkpoints written by
    # either renderer resume on the other.

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
        self.accum = data["accum"]
        self.current_batch = int(data["current_batch"])
