"""Vectorized ray-primitive intersection (pure jnp reference path).

Semantics mirror the reference renderers' linear closest-hit scans
(/root/reference/src/renderers/mg_ray_tracer.cpp:36-102):

* ``min_hit_dist = 0.001`` epsilon (mg_ray_tracer.cpp:20).
* Within a primitive class, the *earliest index* wins distance ties (the
  scan keeps the incumbent unless the new hit is strictly nearer,
  mg_ray_tracer.cpp:47) — matching ``argmin``'s first-occurrence rule.
* Across classes the combination is ``select(spheres, select(boxes,
  planes))`` where the first argument wins ties (mg_ray_tracer.cpp:95-102,
  160-162): spheres beat planes/boxes at equal distance.
* Boxes never hit in the path tracers (``test_boxes`` is a stub,
  mg_ray_tracer.cpp:89-93); the rasterizer *does* test them
  (rasterizer.cpp:61-63).  ``closest_hit(..., include_boxes=...)`` selects.

Sphere root selection: the nearer root if it is >= min_dist, else the far
root (exit point).  For exterior geometry this is identical to the
reference; for rays starting on/inside a sphere (dielectric refraction)
it is the numerically robust choice — the reference's behaviour there
hinges on float error in ``muu::ray::hits`` (see sm_ray_tracer.cpp:181-219,
whose dielectric is itself marked TODO).

All functions are differentiable w.r.t. primitive parameters and ray
origin/direction; the winning-index selection is piecewise constant and
contributes no gradient (detached-sampling convention).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

MIN_HIT_DIST = 0.001
_BIG = jnp.float32(3.0e38)

__all__ = ["HitRecord", "closest_hit", "hit_spheres", "hit_planes", "hit_boxes", "MIN_HIT_DIST"]


def safe_normalize(v, *, eps: float = 1e-20, fallback=None):
    """Normalize with NaN-free gradients: the norm is computed on a guarded
    squared length so grad(sqrt) never sees 0, and exactly-zero vectors map
    to ``fallback`` (default: zero)."""
    n2 = jnp.sum(v * v, axis=-1, keepdims=True)
    ok = n2 > eps
    inv = jax.lax.rsqrt(jnp.where(ok, n2, 1.0))
    out = jnp.where(ok, v * inv, 0.0 if fallback is None else fallback)
    return out


class HitRecord(NamedTuple):
    """Closest-hit result for a batch of rays."""

    t: jax.Array         # (N,) f32 distance; _BIG where no hit
    normal: jax.Array    # (N, 3) f32
    material: jax.Array  # (N,) int32
    hit: jax.Array       # (N,) bool
    kind: jax.Array      # (N,) int32: 0 miss, 1 sphere, 2 plane, 3 box
    idx: jax.Array       # (N,) int32 winner index within its class
    root_lo: jax.Array   # (N,) bool: sphere hit used the near root


def _count_mask(n_padded: int, count: int) -> jax.Array:
    """Validity mask for padded tables; count is static so this folds to a
    compile-time constant."""
    return jnp.arange(n_padded) < count


def _select_min(t: jax.Array):
    """(t_best, idx, onehot) for a (N, S) candidate matrix.

    The winner is extracted with a one-hot reduction instead of a gather:
    the transpose of a gather is a scatter-add, while the transpose of the
    one-hot contraction is another contraction.  Whether a gather is
    cheaper on the GPU has not been measured.
    """
    idx = jnp.argmin(t, axis=-1)
    onehot = jax.nn.one_hot(idx, t.shape[-1], dtype=t.dtype)
    # 0 * _BIG == 0, so masked lanes don't leak
    t_best = jnp.sum(jnp.where(onehot > 0, t, 0.0), axis=-1)
    return t_best, idx, onehot


def sphere_t_matrix(origins, dirs, centers, radii, count, *, min_dist=MIN_HIT_DIST):
    """(N, S) per-pair hit distances, _BIG where no valid hit.

    Quadratic with unit direction: oc = o - c, b = oc·d, c0 = |oc|^2 - r^2,
    disc = b^2 - c0, roots -b ∓ sqrt(disc).
    """
    oc = origins[:, None, :] - centers[None, :, :]          # (N, S, 3)
    b = jnp.sum(oc * dirs[:, None, :], axis=-1)             # (N, S)
    c0 = jnp.sum(oc * oc, axis=-1) - radii[None, :] ** 2    # (N, S)
    disc = b * b - c0
    # sqrt guarded on both branches: grad(sqrt) at 0 is inf and would leak
    # NaN through the miss lanes' where().
    sq = jnp.sqrt(jnp.where(disc > 0.0, disc, 1.0))
    sq = jnp.where(disc > 0.0, sq, 0.0)
    t0 = -b - sq
    t1 = -b + sq
    root_lo = t0 >= min_dist
    t = jnp.where(root_lo, t0, t1)
    valid = (disc >= 0.0) & (t >= min_dist) & _count_mask(centers.shape[0], count)[None, :]
    return jnp.where(valid, t, _BIG), root_lo


def hit_spheres(origins, dirs, centers, radii, count, *, min_dist=MIN_HIT_DIST):
    """Per-ray nearest sphere.  Returns (t, index) with t=_BIG on miss."""
    t, _ = sphere_t_matrix(origins, dirs, centers, radii, count, min_dist=min_dist)
    t_best, idx, _ = _select_min(t)
    return t_best, idx


def plane_t_matrix(origins, dirs, normals, ds, count, *, min_dist=MIN_HIT_DIST):
    """(N, P) per-pair plane hit distances (double-sided).  n·x + d = 0 →
    t = -(n·o + d) / (n·dir)."""
    # precision="highest": keeps this f32 product out of TF32 on the GPU,
    # whose rounding flips hit/tie decisions on grazing planes
    ndotd = jnp.matmul(dirs, normals.T, precision="highest")   # (N, P)
    ndoto = jnp.matmul(origins, normals.T,
                       precision="highest") + ds[None, :]      # (N, P)
    safe = jnp.where(jnp.abs(ndotd) > 1e-12, ndotd, 1.0)
    t = -ndoto / safe
    valid = (jnp.abs(ndotd) > 1e-12) & (t >= min_dist) & _count_mask(normals.shape[0], count)[None, :]
    return jnp.where(valid, t, _BIG)


def hit_planes(origins, dirs, normals, ds, count, *, min_dist=MIN_HIT_DIST):
    """Per-ray nearest plane.  Returns (t, index) with t=_BIG on miss."""
    t = plane_t_matrix(origins, dirs, normals, ds, count, min_dist=min_dist)
    t_best, idx, _ = _select_min(t)
    return t_best, idx


def hit_boxes(origins, dirs, centers, extents, count, *, min_dist=MIN_HIT_DIST):
    """Per-ray nearest axis-aligned box via the slab test.  extents are
    half-extents (muu::bounding_box convention, soa.toml:35-45).  Rays
    starting inside a box hit its exit face."""
    inv = 1.0 / jnp.where(jnp.abs(dirs) > 1e-12, dirs, 1e-12)  # (N, 3)
    lo = centers[None, :, :] - extents[None, :, :]             # (N?, B, 3)
    hi = centers[None, :, :] + extents[None, :, :]
    ta = (lo - origins[:, None, :]) * inv[:, None, :]
    tb = (hi - origins[:, None, :]) * inv[:, None, :]
    tmin = jnp.max(jnp.minimum(ta, tb), axis=-1)               # (N, B)
    tmax = jnp.min(jnp.maximum(ta, tb), axis=-1)
    t = jnp.where(tmin >= min_dist, tmin, tmax)
    valid = (tmax >= tmin) & (t >= min_dist) & _count_mask(centers.shape[0], count)[None, :]
    t = jnp.where(valid, t, _BIG)
    t_best, idx, _ = _select_min(t)
    return t_best, idx


def _box_normal(origins, dirs, t, centers, extents, idx):
    """Outward normal of the slab face hit at parameter t (sign of the
    dominant component of the local hit position, scaled by extents)."""
    c = centers[idx]
    e = jnp.maximum(extents[idx], 1e-12)
    p = origins + t[:, None] * dirs
    local = (p - c) / e
    ax = jnp.argmax(jnp.abs(local), axis=-1)
    n = jax.nn.one_hot(ax, 3, dtype=local.dtype) * jnp.sign(
        jnp.take_along_axis(local, ax[:, None], axis=-1)
    )
    return n


def sphere_stage(spheres, origins, dirs, *, min_dist: float = MIN_HIT_DIST):
    """Nearest-sphere stage: (t, normal, material) per ray.

    Split out so a primitive-sharded caller (rt_tpu.dist) can run it on a
    table shard and all-gather the per-shard winners before the cross-class
    select.  The winner's centre is extracted with a one-hot contraction
    (its transpose is the sphere-centre gradient without any scatter; at
    precision="highest" the fetch is exact, with no TF32 rounding).  The
    material id is an integer gather (no tangents).

    Returns (t, normal, material, idx, root_lo)."""
    t, root_lo_m = sphere_t_matrix(origins, dirs, spheres.center, spheres.radius,
                                   spheres.count, min_dist=min_dist)
    ts, is_, onehot = _select_min(t)
    # clip miss-lane t (=_BIG) before the multiply: inf/overflow upstream of
    # a where() still poisons gradients.
    t_safe = jnp.minimum(ts, 1e30)
    hit_p = origins + t_safe[:, None] * dirs
    center_w = jnp.matmul(onehot, spheres.center,
                          precision="highest")                 # (N, 3)
    n = safe_normalize(hit_p - center_w)
    root_lo = jnp.sum(jnp.where(onehot > 0, root_lo_m, False), axis=-1).astype(bool)
    return ts, n, spheres.material[is_], is_.astype(jnp.int32), root_lo


def closest_hit(
    spheres,
    planes,
    boxes,
    origins,
    dirs,
    *,
    min_dist: float = MIN_HIT_DIST,
    include_boxes: bool = False,
    box_normals_up: bool = False,
    sphere_result=None,
    tie_order: str = "tracer",
) -> HitRecord:
    """Closest hit over the whole scene for a flat ray batch.

    Args:
      spheres/planes/boxes: the scene tables (rt_tpu.scene dataclasses).
      origins, dirs: (N, 3) f32; dirs unit.
      include_boxes: False reproduces the path tracers (box stub,
        mg_ray_tracer.cpp:89-93); True tests boxes (rasterizer.cpp:61-63).
      box_normals_up: reproduce the rasterizer's never-assigned box normal
        (stays 'up', rasterizer.cpp:38,55-58).
      tie_order: exact-tie winner convention.  "tracer" = the path tracers'
        ``select()`` chain (planes scanned first, spheres then win a tie,
        mg_ray_tracer.cpp:95-102, 160-162).  "rasterizer" = the preview's
        single scan planes → boxes → spheres with strict '<', so the
        *earlier-scanned* class keeps an exact tie (rasterizer.cpp:41-63).
    """
    n = origins.shape[0]

    if sphere_result is None:
        ts, sphere_n, sphere_m, sphere_i, root_lo = sphere_stage(spheres, origins, dirs, min_dist=min_dist)
    else:
        ts, sphere_n, sphere_m, sphere_i, root_lo = sphere_result
    tpm = plane_t_matrix(origins, dirs, planes.normal, planes.d, planes.count, min_dist=min_dist)
    tp, ip, p_onehot = _select_min(tpm)

    if include_boxes and boxes.count > 0:
        tb, ib = hit_boxes(origins, dirs, boxes.center, boxes.extents, boxes.count, min_dist=min_dist)
    else:
        tb = jnp.full((n,), _BIG)
        ib = jnp.zeros((n,), jnp.int32)

    if tie_order == "rasterizer":
        # planes → boxes → spheres, strict '<': earlier class keeps ties.
        box_over_p = tb < tp
        t_pb = jnp.where(box_over_p, tb, tp)
        sphere_sel = ts < t_pb
        box_sel = box_over_p & ~sphere_sel
        t = jnp.where(sphere_sel, ts, t_pb)
    else:
        # select(a=spheres, b=planes): a wins ties; boxes beat planes at
        # ties but lose to spheres (select chain mg_ray_tracer.cpp:160-162).
        sphere_wins = ts <= tp
        t_sp = jnp.where(sphere_wins, ts, tp)
        box_sel = tb < t_sp
        sphere_sel = sphere_wins & ~box_sel
        t = jnp.where(box_sel, tb, t_sp)
    hit = t < _BIG

    # Normals & material ids by winner class (one-hot contraction for the
    # float normal, integer gather for the material id).
    plane_n = jnp.matmul(p_onehot, planes.normal,
                         precision="highest")
    if include_boxes and boxes.count > 0:
        if box_normals_up:
            box_n = jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0], jnp.float32), (n, 3))
        else:
            box_n = _box_normal(origins, dirs, tb, boxes.center, boxes.extents, ib)
    else:
        box_n = jnp.zeros((n, 3), jnp.float32)

    normal = jnp.where(sphere_sel[:, None], sphere_n, plane_n)
    normal = jnp.where(box_sel[:, None], box_n, normal)

    mat = jnp.where(sphere_sel, sphere_m, planes.material[ip])
    if include_boxes and boxes.count > 0:
        mat = jnp.where(box_sel, boxes.material[ib], mat)

    kind = jnp.where(sphere_sel & (ts < _BIG), 1, jnp.where(tp < _BIG, 2, 0))
    kind = jnp.where(box_sel, 3, kind)
    kind = jnp.where(hit, kind, 0)
    idx = jnp.where(sphere_sel, sphere_i, ip.astype(jnp.int32))
    if include_boxes and boxes.count > 0:
        idx = jnp.where(box_sel, ib.astype(jnp.int32), idx)

    return HitRecord(
        t=t, normal=normal, material=mat.astype(jnp.int32), hit=hit,
        kind=kind.astype(jnp.int32), idx=idx, root_lo=root_lo & sphere_sel,
    )
