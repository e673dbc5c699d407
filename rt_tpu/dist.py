"""Sharding and multi-host distribution.

The reference's only parallelism is a shared-memory thread pool over pixels
(``threads.for_range(0, W*H, worker)``, mg_ray_tracer.cpp:203-204) and its
only "collective" is the pool join.  Here (SURVEY.md §2 parallelism table)
a ``jax.sharding.Mesh`` replaces it:

* **'rays' axis** — data parallelism over pixels/rays: each device renders a
  contiguous slice of the flattened pixel array via ``shard_map``.  The RNG
  stream is folded by *global* chunk index, so a sharded render is
  bit-identical to the unsharded one regardless of mesh size.
* **'prims' axis** (optional) — the sequence-parallel analogue for giant
  scenes (SURVEY.md §5 long-context): the sphere table is sharded, each
  device intersects its slice, and the per-shard winners are combined with
  an ``all_gather`` + min-reduce over the axis.
* Gradients: a loss over the sharded framebuffer transposes through
  ``shard_map`` into a ``psum`` of parameter gradients.  XLA schedules
  that all-reduce; whether it overlaps the backward pass has not been
  measured.

Multi-host: ``initialize()`` wraps ``jax.distributed.initialize``; the same
mesh API spans the devices of all processes.  The mesh shape follows the
algorithm alone: every card of an NVLink host reaches every other at the
same rate.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from . import rng as _rng
from .integrator import default_ray_chunk, render_pixels, _pixel_grid
from .ops.intersect import HitRecord, closest_hit, sphere_stage

__all__ = [
    "initialize",
    "make_mesh",
    "render_image_sharded",
    "shard_spheres",
    "sharded_hit_fn",
]


def initialize(**kwargs) -> None:
    """Multi-host bring-up (jax.distributed.initialize passthrough).
    No-op on a single process.  Exercised for real by tools/mp_check.py:
    a 2-OS-process CPU-backend run building a cross-process mesh (the
    multi-process simulation SURVEY.md §4 calls for)."""
    if jax.process_count() > 1 or kwargs:
        jax.distributed.initialize(**kwargs)


def _to_global(mesh: Mesh, spec, value):
    """Host-local value -> global jax.Array laid out ``spec`` over ``mesh``.

    Multi-controller JAX (2+ OS processes) rejects process-local arrays as
    shard_map/jit operands; this builds the global array each process
    contributes its addressable shards to.  PRNG key arrays round-trip
    through key_data/wrap_key_data (typed keys can't cross
    make_array_from_callback directly)."""
    if hasattr(value, "dtype") and jnp.issubdtype(value.dtype, jax.dtypes.prng_key):
        data = np.asarray(jax.random.key_data(value))
        g = jax.make_array_from_callback(
            data.shape, NamedSharding(mesh, P()), lambda idx: data[idx])
        return jax.random.wrap_key_data(g)
    arr = np.asarray(value)
    return jax.make_array_from_callback(
        arr.shape, NamedSharding(mesh, spec), lambda idx: arr[idx])


def make_mesh(n_rays: Optional[int] = None, n_prims: int = 1, *, devices=None) -> Mesh:
    """Build a ('rays', 'prims') device mesh.  Defaults to all devices on
    the rays axis."""
    if devices is None:
        devices = jax.devices()
    if n_rays is None:
        n_rays = len(devices) // n_prims
    if n_rays * n_prims != len(devices):
        devices = devices[: n_rays * n_prims]
    dev_array = np.asarray(devices).reshape(n_rays, n_prims)
    return Mesh(dev_array, axis_names=("rays", "prims"))


def shard_spheres(scene, mesh: Mesh):
    """Pad the sphere table so it divides the 'prims' axis (padding rows are
    inert: centres at 1e9, radius 0 — they cannot hit)."""
    np_ = mesh.shape["prims"]
    s = scene.spheres
    n = s.center.shape[0]
    pad = (-n) % np_
    if pad == 0:
        return scene
    import dataclasses

    spheres = dataclasses.replace(
        s,
        center=jnp.concatenate([s.center, jnp.full((pad, 3), 1e9, s.center.dtype)]),
        radius=jnp.concatenate([s.radius, jnp.zeros((pad,), s.radius.dtype)]),
        material=jnp.concatenate([s.material, jnp.zeros((pad,), s.material.dtype)]),
    )
    return dataclasses.replace(scene, spheres=spheres)


def sharded_hit_fn(scene, *, include_boxes: bool = False):
    """Closest-hit where the sphere table is already sliced along 'prims'.

    To be called *inside* a shard_map whose axes include 'prims': runs the
    sphere stage on the local slice, all-gathers the per-shard winners, and
    min-reduces before the cross-class select (spheres still beat planes on
    ties; among equal sphere distances the lowest shard — i.e. lowest global
    index — wins, matching the reference's first-wins scan order for
    contiguous shards)."""

    def hit_fn(o, d):
        import dataclasses

        local_n = int(scene.spheres.center.shape[0])
        local = dataclasses.replace(scene.spheres, count=local_n)
        ts, ns, ms, is_, rl = sphere_stage(local, o, d)
        shard_off = jax.lax.axis_index("prims") * local_n
        # (P, N) gathered winners; axis index orders shards so argmin's
        # first-occurrence rule preserves global index order.
        ts_all = jax.lax.all_gather(ts, "prims")
        ns_all = jax.lax.all_gather(ns, "prims")
        ms_all = jax.lax.all_gather(ms, "prims")
        is_all = jax.lax.all_gather(is_ + shard_off, "prims")
        rl_all = jax.lax.all_gather(rl, "prims")
        pwin = jnp.argmin(ts_all, axis=0)
        ar = jnp.arange(ts.shape[0])
        sphere_result = (ts_all[pwin, ar], ns_all[pwin, ar], ms_all[pwin, ar],
                         is_all[pwin, ar], rl_all[pwin, ar])
        return closest_hit(
            scene.spheres, scene.planes, scene.boxes, o, d,
            include_boxes=include_boxes, sphere_result=sphere_result,
        )

    return hit_fn


def render_image_sharded(
    scene,
    size: tuple[int, int],
    key: jax.Array,
    mesh: Mesh,
    *,
    personality: str = "mg",
    spp: Optional[int] = None,
    max_bounces: Optional[int] = None,
    rng_mode: str = "reference",
    ray_chunk: Optional[int] = None,
    gamma: bool = True,
    grad_mode: str = "autodiff",
) -> jax.Array:
    """Path-traced frame sharded over the mesh.  Returns a (H, W, 3) f32
    jax.Array sharded over rows on 'rays' (materialize with np.asarray — the
    all-gather to host replaces the reference's back_buffer flush,
    back_buffer.cpp:40-50).

    Bit-identical to :func:`rt_tpu.integrator.render_image` with the same
    key and ray_chunk: the RNG is folded by global chunk index.
    """
    w, h = size
    if spp is None:
        spp = scene.samples_per_pixel
    if max_bounces is None:
        max_bounces = scene.max_bounces
    n = w * h
    n_rays_axis = mesh.shape["rays"]
    n_prims_axis = mesh.shape["prims"]
    if ray_chunk is None:
        ray_chunk = min(default_ray_chunk(scene), max(1024, -(-n // n_rays_axis)))

    scene = shard_spheres(scene, mesh)

    # Pad pixels so every device gets the same number of whole chunks.
    stride = ray_chunk * n_rays_axis
    n_pad = -(-n // stride) * stride
    grid = jnp.pad(_pixel_grid(size), ((0, n_pad - n), (0, 0)))
    chunks_per_shard = n_pad // stride

    spheres_spec = jax.tree_util.tree_map(lambda _: P("prims"), scene.spheres)
    scene_spec = jax.tree_util.tree_map(lambda _: P(), scene)
    import dataclasses

    scene_spec = dataclasses.replace(scene_spec, spheres=spheres_spec)

    if jax.process_count() > 1 and not isinstance(grid, jax.core.Tracer):
        # multi-controller: operands must be global arrays (inside a jit
        # trace the enclosing pjit already owns the layout — skip there)
        scene = jax.tree_util.tree_map(
            lambda leaf, sp: _to_global(mesh, sp, leaf), scene, scene_spec)
        grid = _to_global(mesh, P("rays"), grid)
        key = _to_global(mesh, P(), key)

    def shard_fn(local_scene, local_pixels, k):
        shard_id = jax.lax.axis_index("rays")
        hit_fn = sharded_hit_fn(local_scene) if n_prims_axis > 1 else None
        rad = render_pixels(
            local_scene, size, local_pixels, k,
            spp=spp, personality=personality, max_bounces=max_bounces,
            rng_mode=rng_mode, ray_chunk=ray_chunk, hit_fn=hit_fn,
            chunk_offset=shard_id * chunks_per_shard,
            grad_mode=grad_mode,
            # prims-sharded replay: the sharded hit_fn records GLOBAL
            # winner indices; replay one-hot-fetches per shard + psums
            # the payloads (rt_tpu.replay.replay_radiance)
            replay_prims_axis=("prims" if (hit_fn is not None
                                           and grad_mode == "replay")
                               else None),
        )
        return rad

    rad = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(scene_spec, P("rays"), P()),
        out_specs=P("rays"),
        check_vma=False,
    )(scene, grid, key)

    img = rad[:n]
    if gamma:
        img = jnp.sqrt(jnp.maximum(img, 0.0))
    return img.reshape(h, w, 3)
