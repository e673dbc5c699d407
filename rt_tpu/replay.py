"""Replay-mode gradients: record the discrete path structure, differentiate
a cheap replay.

Differentiating the full wavefront trace makes XLA transpose the entire
(rays x primitives) closest-hit chain per bounce — ~20x the forward cost.
But under the detached-sampling convention (rt_tpu.diff) every discrete
decision is constant in the backward pass anyway.  So:

1. ``trace_batch_recorded`` runs the normal trace (stop-gradient) and
   additionally records, per bounce and ray: the winning primitive (kind +
   index + sphere-root bit), the live/miss/absorbed masks, and the
   scatter decision bits (dielectric coin, lambert degeneracy).
2. ``replay_radiance`` recomputes the radiance as a *smooth* function of
   the scene parameters with the discrete structure pinned: per bounce it
   solves the hit for the one recorded primitive (O(1) per ray instead of
   O(S)), fetches parameters with one-hot contractions, and applies the
   recorded masks.  Autodiff of this function gives exactly the
   detached-sampling gradient at a fraction of the cost.

``trace_batch_replay`` composes the two; its value equals ``trace_batch``
bit-for-bit (tested), and its gradient matches the direct autodiff gradient.

This is also the shape a hand-written fused backward would want: the
records are the compact residuals its forward would emit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from . import rng as _rng
from .materials import personality_classes, scatter
from .ops.intersect import MIN_HIT_DIST, closest_hit, safe_normalize

__all__ = ["PathRecords", "trace_batch_recorded", "replay_radiance", "trace_batch_replay"]

_BIG = jnp.float32(3.0e38)


class PathRecords(NamedTuple):
    """Stacked (max_bounces, N) discrete path structure."""

    kind: jax.Array      # int32: 0 miss, 1 sphere, 2 plane, 3 box (--boxes)
    idx: jax.Array       # int32 winner index within class
    root_lo: jax.Array   # bool: sphere near-root used
    live_in: jax.Array   # bool: ray alive at bounce entry
    miss: jax.Array      # bool: alive and missed → sky contribution
    alive_out: jax.Array # bool: alive after the bounce (hit, not absorbed)
    reflect_bit: jax.Array  # bool: dielectric reflect branch
    lam_deg: jax.Array      # bool: lambert degenerate fallback


def trace_batch_recorded(
    scene,
    origins: jax.Array,
    dirs: jax.Array,
    key: jax.Array,
    *,
    personality: str = "mg",
    max_bounces: Optional[int] = None,
    rng_mode: str = "reference",
    hit_fn=None,
    include_boxes: bool = False,
):
    """Forward trace emitting (radiance, PathRecords).  Mirrors
    rt_tpu.integrator.trace_batch exactly (same RNG folds, same update
    order) — kept in sync by test_replay.py's bitwise checks.

    ``hit_fn`` overrides the closest-hit like trace_batch's — with
    rt_tpu.dist.sharded_hit_fn the recorded sphere winner index is the
    GLOBAL index (shard offset already added), which is what the sharded
    replay consumes.  ``include_boxes`` enables the ``--boxes`` extension
    (records carry kind=3 + box index; tracer default keeps the
    reference's never-hitting box stub, mg_ray_tracer.cpp:89-93)."""
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
        from .integrator import sky_colour

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
        recs = PathRecords(
            kind=rec.kind, idx=rec.idx, root_lo=rec.root_lo,
            live_in=live, miss=miss_now, alive_out=alive,
            reflect_bit=sc.reflect_bit, lam_deg=sc.lam_deg,
        )
        return (o, d, thr, rad, alive), recs

    init = (
        origins,
        dirs,
        jnp.ones((n, 3), jnp.float32),
        jnp.zeros((n, 3), jnp.float32),
        jnp.ones((n,), bool),
    )
    (_, _, _, radiance, _), records = jax.lax.scan(body, init, jnp.arange(max_bounces))
    return radiance, records


def replay_radiance(
    scene,
    origins: jax.Array,
    dirs: jax.Array,
    key: jax.Array,
    records: PathRecords,
    *,
    personality: str = "mg",
    max_bounces: Optional[int] = None,
    rng_mode: str = "reference",
    prims_axis: Optional[str] = None,
    include_boxes: bool = False,
) -> jax.Array:
    """Differentiable radiance with the discrete path structure pinned to
    ``records``.  O(1) work per ray per bounce (plus one-hot contractions
    for parameter fetches).

    ``prims_axis``: global-winner replay under a shard_map whose mesh
    shards the sphere table along this axis.  ``records.idx`` carries
    GLOBAL sphere indices (rt_tpu.dist.sharded_hit_fn); each shard
    one-hot-fetches the winners living in its slice and the payloads
    (centre, radius, material id) are combined with a ``psum`` over the
    axis — exactly one shard contributes per lane, so values match the
    replicated fetch and the psum transpose routes the parameter
    cotangents back to the owning shard's table slice."""
    if max_bounces is None:
        max_bounces = scene.max_bounces
    classes = personality_classes(personality)
    n = origins.shape[0]
    S = scene.spheres.center.shape[0]
    P = scene.planes.normal.shape[0]
    # kind=3 records only exist when the forward ran with --boxes; the box
    # branch compiles away entirely for box-free traces
    NB = scene.boxes.center.shape[0] if (
        include_boxes and scene.boxes.count > 0) else 0

    def body(state, inp):
        o, d, thr, rad = state
        b, r = inp
        is_sphere = r.kind == 1
        is_plane = r.kind == 2
        hit = r.kind > 0

        # --- differentiable hit for the recorded primitive ---------------
        if prims_axis is None:
            sid = jnp.where(is_sphere, r.idx, 0)
            s_sel = is_sphere
        else:
            # local slice of the sharded table: mask to winners owned here
            off = jax.lax.axis_index(prims_axis).astype(jnp.int32) * S
            lid = r.idx - off
            s_sel = is_sphere & (lid >= 0) & (lid < S)
            sid = jnp.clip(jnp.where(s_sel, lid, 0), 0, S - 1)
        s_onehot = jax.nn.one_hot(sid, S, dtype=jnp.float32)
        s_onehot = s_onehot * s_sel[:, None]
        c = jnp.matmul(s_onehot, scene.spheres.center,
                       precision="highest")                  # (N, 3)
        radius = jnp.matmul(s_onehot, scene.spheres.radius,
                            precision="highest")             # (N,)
        if prims_axis is not None:
            c = jax.lax.psum(c, prims_axis)
            radius = jax.lax.psum(radius, prims_axis)
        oc = o - c
        bq = jnp.sum(oc * d, axis=-1)
        c0 = jnp.sum(oc * oc, axis=-1) - radius * radius
        disc = bq * bq - c0
        sq = jnp.sqrt(jnp.where(is_sphere, jnp.maximum(disc, 1e-12), 1.0))
        sq = jnp.where(is_sphere, sq, 0.0)
        t_s = jnp.where(r.root_lo, -bq - sq, -bq + sq)

        p_onehot = jax.nn.one_hot(jnp.where(is_plane, r.idx, 0), P, dtype=jnp.float32)
        p_onehot = p_onehot * is_plane[:, None]
        pn = jnp.matmul(p_onehot, scene.planes.normal,
                        precision="highest")                 # (N, 3)
        pd = jnp.matmul(p_onehot, scene.planes.d,
                        precision="highest")                 # (N,)
        ndotd = jnp.sum(pn * d, axis=-1)
        safe_dd = jnp.where(jnp.abs(ndotd) > 1e-12, ndotd, 1.0)
        t_p = -(jnp.sum(pn * o, axis=-1) + pd) / safe_dd

        t = jnp.where(is_sphere, t_s, jnp.where(is_plane, t_p, 0.0))
        if NB:
            # --boxes extension: smooth slab t for the recorded box.  The
            # slab max/min pick the hit face, and jnp.max's subgradient
            # flows through exactly that face's plane — the face CHOICE is
            # the detached discrete decision, its t is smooth in
            # (center, extents).  The face normal is piecewise constant in
            # the parameters, so the detached recompute is exact a.e.
            is_box = r.kind == 3
            bid = jnp.where(is_box, r.idx, 0)
            b_onehot = jax.nn.one_hot(bid, NB, dtype=jnp.float32)
            b_onehot = b_onehot * is_box[:, None]
            bc = jnp.matmul(b_onehot, scene.boxes.center,
                            precision="highest")             # (N, 3)
            be = jnp.matmul(b_onehot, scene.boxes.extents,
                            precision="highest")             # (N, 3)
            inv = 1.0 / jnp.where(jnp.abs(d) > 1e-12, d, 1e-12)
            ta = (bc - be - o) * inv
            tb2 = (bc + be - o) * inv
            tmn = jnp.max(jnp.minimum(ta, tb2), axis=-1)
            tmx = jnp.min(jnp.maximum(ta, tb2), axis=-1)
            use_min = jax.lax.stop_gradient(tmn) >= MIN_HIT_DIST
            t_b = jnp.where(use_min, tmn, tmx)
            t = jnp.where(is_box, t_b, t)
        hit_p = o + t[:, None] * d
        normal = jnp.where(is_sphere[:, None], safe_normalize(hit_p - c), pn)
        if NB:
            eb = jnp.maximum(jax.lax.stop_gradient(be), 1e-12)
            local = (jax.lax.stop_gradient(hit_p - bc)) / eb
            ax = jnp.argmax(jnp.abs(local), axis=-1)
            bn = jax.nn.one_hot(ax, 3, dtype=local.dtype) * jnp.sign(
                jnp.take_along_axis(local, ax[:, None], axis=-1))
            normal = jnp.where(is_box[:, None], bn, normal)

        # material id: integer gathers (no tangents); indices clamped to the
        # owning table to keep out-of-class lanes in bounds
        p_idx = jnp.where(is_plane, r.idx, 0)
        if prims_axis is None:
            s_mat = scene.spheres.material[jnp.where(is_sphere, r.idx, 0)]
        else:
            s_mat = jax.lax.psum(
                jnp.where(s_sel, scene.spheres.material[sid], 0), prims_axis)
        mat = jnp.where(is_sphere, s_mat,
                        scene.planes.material[p_idx]).astype(jnp.int32)
        if NB:
            mat = jnp.where(is_box, scene.boxes.material[bid], mat)
            mat = mat.astype(jnp.int32)

        # --- sky contribution (recorded miss mask) ------------------------
        from .integrator import sky_colour

        rad = rad + jnp.where(r.miss[:, None], thr * sky_colour(d), 0.0)

        # --- scatter with pinned decisions --------------------------------
        kb = _rng.fold(key, b)
        ur = _rng.unit_vector(_rng.fold(kb, 1), (n,), mode=rng_mode)
        coin = _rng.uniform(_rng.fold(kb, 2), (n,))
        brdf_class = classes[scene.materials.type[mat]]
        sc = scatter(scene.materials, brdf_class, mat, d, normal, ur, coin,
                     decisions=(r.reflect_bit, r.lam_deg))

        live_h = r.live_in & hit
        thr = jnp.where(r.alive_out[:, None], thr * sc.attenuation, thr)
        o = jnp.where(live_h[:, None], hit_p, o)
        d = jnp.where(live_h[:, None], sc.direction, d)
        return (o, d, thr, rad), None

    init = (
        origins,
        dirs,
        jnp.ones((n, 3), jnp.float32),
        jnp.zeros((n, 3), jnp.float32),
    )
    (_, _, _, radiance), _ = jax.lax.scan(
        body, init, (jnp.arange(max_bounces), records))
    return radiance


def trace_batch_replay(
    scene,
    origins: jax.Array,
    dirs: jax.Array,
    key: jax.Array,
    *,
    personality: str = "mg",
    max_bounces: Optional[int] = None,
    rng_mode: str = "reference",
    hit_fn=None,
    prims_axis: Optional[str] = None,
    include_boxes: bool = False,
    **_unused,
) -> jax.Array:
    """trace_batch with replay-mode gradients: same value, detached-sampling
    gradient at a fraction of the backward cost.

    On a prims-sharded mesh pass the sharded ``hit_fn`` (whose records carry
    global winner indices) together with ``prims_axis``; the replay then
    runs the global-winner fetch + psum path (see replay_radiance)."""
    _, records = jax.lax.stop_gradient(
        trace_batch_recorded(
            scene, origins, dirs, key,
            personality=personality, max_bounces=max_bounces,
            rng_mode=rng_mode, hit_fn=hit_fn, include_boxes=include_boxes,
        )
    )
    return replay_radiance(
        scene, origins, dirs, key, records,
        personality=personality, max_bounces=max_bounces, rng_mode=rng_mode,
        prims_axis=prims_axis, include_boxes=include_boxes,
    )
