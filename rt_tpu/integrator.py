"""Wavefront path-tracing integrator.

The reference traces recursively per pixel on a CPU thread pool
(/root/reference/src/renderers/mg_ray_tracer.cpp:155-204).  Recursion and
per-ray branching don't map to a vector machine; the design here is a
*wavefront*: a flat ray batch advances through a ``lax.scan`` over bounce
depth with live-ray masks, accumulating throughput, and the whole pixel x
sample space is just batch dimensions sharded across chips.

Semantic parity with the reference:

* sky on miss: lerp(white, (0.5, 0.7, 1.0), 0.5*(dir.y + 1))
  (mg_ray_tracer.cpp:164).
* a ray that exhausts max_bounces, or is absorbed by metal, contributes
  black (mg_ray_tracer.cpp:157-158, 173) — radiance only accrues at sky
  misses, scaled by the product of attenuations.
* sample 0 is at the pixel centre (+0.5, +0.5), samples >= 1 add U[0,1)^2
  jitter (mg_ray_tracer.cpp:189).
* the estimate is the mean over samples followed by a per-channel sqrt
  (gamma 2.0) (mg_ray_tracer.cpp:195-198).

The rasterizer preview (renderers/rasterizer.cpp) is also provided: primary
rays only, quarter-ambient lambert shade toward the eye, vertical sky
gradient, boxes intersected but with the reference's never-assigned 'up'
normal quirk.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from . import rng as _rng
from .camera import generate_rays, screen_to_world
from .colour import colour_from_hex
from .materials import personality_classes, scatter
from .ops.intersect import closest_hit

__all__ = [
    "trace_batch",
    "render_image",
    "render_pixels",
    "render_rasterizer",
    "render_null",
    "sky_colour",
    "default_ray_chunk",
]

_WHITE = (1.0, 1.0, 1.0)
_SKY_BLUE = (0.5, 0.7, 1.0)


def sky_colour(dirs: jax.Array) -> jax.Array:
    """Background gradient (mg_ray_tracer.cpp:164)."""
    t = 0.5 * (dirs[..., 1] + 1.0)
    white = jnp.asarray(_WHITE, jnp.float32)
    blue = jnp.asarray(_SKY_BLUE, jnp.float32)
    return (1.0 - t)[..., None] * white + t[..., None] * blue


def trace_batch(
    scene,
    origins: jax.Array,
    dirs: jax.Array,
    key: jax.Array,
    *,
    personality: str = "mg",
    max_bounces: Optional[int] = None,
    rng_mode: str = "reference",
    include_boxes: bool = False,
    hit_fn=None,
) -> jax.Array:
    """Trace a flat batch of rays to radiance.  Returns (N, 3) f32.

    Equivalent to ``trace()`` (mg_ray_tracer.cpp:155-174) applied to every
    ray in the batch, restructured as a bounded scan with live masks.
    ``hit_fn(o, d) -> HitRecord`` overrides the closest-hit (used by
    rt_tpu.dist for primitive-sharded intersection).
    """
    if max_bounces is None:
        max_bounces = scene.max_bounces
    classes = personality_classes(personality)
    n = origins.shape[0]
    if hit_fn is None:
        def hit_fn(o, d):
            return closest_hit(scene.spheres, scene.planes, scene.boxes, o, d,
                               include_boxes=include_boxes)

    def body(state, b):
        o, d, thr, rad, live = state
        rec = hit_fn(o, d)
        miss_now = live & ~rec.hit
        rad = rad + jnp.where(miss_now[:, None], thr * sky_colour(d), 0.0)

        live_h = live & rec.hit
        kb = _rng.fold(key, b)
        ur = _rng.unit_vector(_rng.fold(kb, 1), (n,), mode=rng_mode)
        coin = _rng.uniform(_rng.fold(kb, 2), (n,))
        brdf_class = classes[scene.materials.type[rec.material]]
        sc = scatter(scene.materials, brdf_class, rec.material, d, rec.normal, ur, coin)

        t_safe = jnp.where(rec.hit, rec.t, 0.0)
        new_o = o + t_safe[:, None] * d
        alive = live_h & ~sc.absorbed
        thr = jnp.where(alive[:, None], thr * sc.attenuation, thr)
        o = jnp.where(live_h[:, None], new_o, o)
        d = jnp.where(live_h[:, None], sc.direction, d)
        return (o, d, thr, rad, alive), None

    init = (
        origins,
        dirs,
        jnp.ones((n, 3), jnp.float32),
        jnp.zeros((n, 3), jnp.float32),
        jnp.ones((n,), bool),
    )
    (_, _, _, radiance, _), _ = jax.lax.scan(body, init, jnp.arange(max_bounces))
    return radiance


def _pixel_grid(size: tuple[int, int]) -> jax.Array:
    """Integer pixel coordinates in the reference's row-major order
    (image.hpp:82-85: position_of(i) = (i % W, i / W))."""
    w, h = size
    idx = jnp.arange(w * h)
    return jnp.stack([(idx % w).astype(jnp.float32), (idx // w).astype(jnp.float32)], axis=-1)


def render_image(
    scene,
    size: tuple[int, int],
    key: jax.Array,
    *,
    personality: str = "mg",
    spp: Optional[int] = None,
    max_bounces: Optional[int] = None,
    rng_mode: str = "reference",
    ray_chunk: Optional[int] = None,
    gamma: bool = True,
    hit_fn=None,
    chunk_offset=0,
    remat: bool = True,
    grad_mode: str = "autodiff",
    include_boxes: bool = False,
) -> jax.Array:
    """Full path-traced frame.  Returns (H, W, 3) f32 (pre-quantization).

    Mirrors the per-pixel worker (mg_ray_tracer.cpp:182-204): spp samples,
    sample 0 at the pixel centre, mean, sqrt gamma.  ``ray_chunk`` bounds the
    live ray batch to cap the (rays x primitives) intermediate; the chunks
    are processed by a sequential scan.
    """
    w, h = size
    if spp is None:
        spp = scene.samples_per_pixel
    n = w * h
    grid = _pixel_grid(size)  # (N, 2)
    acc = render_pixels(
        scene, size, grid, key,
        spp=spp, personality=personality, max_bounces=max_bounces,
        rng_mode=rng_mode, ray_chunk=ray_chunk, hit_fn=hit_fn,
        chunk_offset=chunk_offset, remat=remat, grad_mode=grad_mode,
        include_boxes=include_boxes,
    )
    img = acc[:n]
    if gamma:
        img = jnp.sqrt(jnp.maximum(img, 0.0))
    return img.reshape(h, w, 3)


def default_ray_chunk(scene) -> int:
    """Chunk size keeping the (rays x spheres) intermediate under ~256 MB."""
    s = max(int(scene.spheres.center.shape[0]), 1)
    return max(min(1 << (64 * 1024 * 1024 // (s * 4)).bit_length(), 65536), 1024)


def render_pixels(
    scene,
    size: tuple[int, int],
    pixels: jax.Array,
    key: jax.Array,
    *,
    spp: int,
    personality: str = "mg",
    max_bounces: Optional[int] = None,
    rng_mode: str = "reference",
    ray_chunk: Optional[int] = None,
    hit_fn=None,
    chunk_offset=0,
    remat: bool = True,
    grad_mode: str = "autodiff",
    include_boxes: bool = False,
    replay_prims_axis=None,
) -> jax.Array:
    """Mean radiance over spp samples for a flat (N, 2) pixel array.

    Returns (N_padded, 3) pre-gamma radiance (N padded up to a chunk
    multiple).  ``chunk_offset`` biases the per-chunk RNG fold so a sharded
    caller (rt_tpu.dist) reproduces the exact unsharded stream: global chunk
    id = chunk_offset + local index.

    ``remat``: wrap each chunk trace in ``jax.checkpoint`` so the backward
    pass recomputes the bounce loop instead of storing per-(sample, chunk,
    bounce) residuals — without it the reverse pass needs O(spp * bounces *
    rays * primitives) HBM and large frames OOM.  (SURVEY.md: trade FLOPs
    for HBM.)

    ``grad_mode``: "autodiff" differentiates the full trace; "replay"
    (rt_tpu.replay) pins the discrete path structure and differentiates a
    cheap replay — same value, same detached-sampling gradient, much
    cheaper backward.  With a custom (prims-sharded) hit_fn, pass
    ``replay_prims_axis`` to run the global-winner replay
    (rt_tpu.replay.replay_radiance).
    """
    if max_bounces is None:
        max_bounces = scene.max_bounces
    n = pixels.shape[0]
    if ray_chunk is None:
        ray_chunk = default_ray_chunk(scene)
    ray_chunk = min(ray_chunk, 1 << (max(n - 1, 1)).bit_length())
    n_pad = -(-n // ray_chunk) * ray_chunk
    chunks = jnp.pad(pixels, ((0, n_pad - n), (0, 0))).reshape(n_pad // ray_chunk, ray_chunk, 2)

    if grad_mode == "replay":
        if hit_fn is not None and replay_prims_axis is None:
            raise ValueError(
                "grad_mode='replay' with a custom hit_fn needs "
                "replay_prims_axis (global-winner replay; rt_tpu.dist)")
        import functools as _ft

        from .replay import trace_batch_replay
        _trace = _ft.partial(trace_batch_replay,
                             prims_axis=replay_prims_axis)
    elif grad_mode == "autodiff":
        _trace = trace_batch
    else:
        raise ValueError(f"unknown grad_mode {grad_mode!r}")

    def sample_body(acc, s):
        def chunk_body(s, c_idx, chunk_pix):
            ks = _rng.fold(key, s)
            kc = _rng.fold(ks, chunk_offset + c_idx)
            jitter = _rng.uniform(_rng.fold(kc, 0), (ray_chunk, 2))
            off = jnp.where(s == 0, jnp.float32(0.5), jitter)
            o, d = generate_rays(scene.camera, size, chunk_pix + off)
            return _trace(
                scene, o, d, _rng.fold(kc, 3),
                personality=personality, max_bounces=max_bounces, rng_mode=rng_mode,
                hit_fn=hit_fn, include_boxes=include_boxes,
            )

        if remat:
            chunk_body = jax.checkpoint(chunk_body, prevent_cse=False)

        rad = jax.lax.map(
            lambda args: chunk_body(s, args[0], args[1]),
            (jnp.arange(chunks.shape[0]), chunks),
        )  # (C, chunk, 3)
        return acc + rad.reshape(n_pad, 3), None

    acc0 = jnp.zeros((n_pad, 3), jnp.float32)
    acc, _ = jax.lax.scan(sample_body, acc0, jnp.arange(spp))
    return acc / spp


def render_rasterizer(
    scene,
    size: tuple[int, int],
    key: jax.Array = None,
    *,
    compat_colours: bool = True,
    **_unused,
) -> jax.Array:
    """One-bounce preview renderer (renderers/rasterizer.cpp:22-88).

    Primary ray at pixel centre; closest hit *including boxes* (with the
    reference's box-normal-stays-'up' quirk, rasterizer.cpp:38,55-58);
    shade = min(0.25 + 0.75 * dot(to_eye, n) * albedo, 1) — note: no lower
    clamp, back-facing surfaces go negative exactly as the reference;
    miss = vertical sky gradient lerp(sky_start, sky_end, y/(H-1))
    (rasterizer.cpp:65-66, 79-82).
    """
    w, h = size
    grid = _pixel_grid(size)
    o, d = generate_rays(scene.camera, size, grid + 0.5)

    rec = closest_hit(scene.spheres, scene.planes, scene.boxes, o, d,
                      include_boxes=True, box_normals_up=True,
                      tie_order="rasterizer")
    # Out-of-range guard (rasterizer.cpp:33-35): hits are sought below
    # max_dist + 1 where max_dist = |far_pos - near_pos|; anything at
    # t >= that initial best is a miss.  t here is measured from the near
    # plane along a unit dir, so max_dist = (far-near) ray length per pixel.
    near_pos = screen_to_world(scene.camera, size, grid + 0.5, 0.0)
    far_pos = screen_to_world(scene.camera, size, grid + 0.5, 1.0)
    max_dist = jnp.linalg.norm(far_pos - near_pos, axis=-1)
    hit = rec.hit & (rec.t < max_dist + 1.0)

    albedo = scene.materials.albedo[rec.material][:, :3]
    to_eye = -d
    lam = jnp.sum(to_eye * rec.normal, axis=-1, keepdims=True) * albedo
    shade = jnp.minimum(0.25 + lam * 0.75, 1.0)

    sky_start = jnp.asarray(colour_from_hex(0xD0E4FF, compat=compat_colours)[:3], jnp.float32)
    sky_end = jnp.asarray(colour_from_hex(0xEEF5FF, compat=compat_colours)[:3], jnp.float32)
    ty = (grid[:, 1] / jnp.float32(max(h - 1, 1)))[:, None]
    sky = (1.0 - ty) * sky_start + ty * sky_end

    img = jnp.where(hit[:, None], shade, sky)
    return img.reshape(h, w, 3)


def render_null(scene, size: tuple[int, int], key: jax.Array = None, **_unused) -> jax.Array:
    """No-op renderer (renderers/null_renderer.cpp:7-15): the app clears the
    buffer to black first (main.cpp:318), so the frame is black."""
    w, h = size
    return jnp.zeros((h, w, 3), jnp.float32)
