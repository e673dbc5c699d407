"""Differentiable rendering: parameter pytrees, losses, gradients.

The whole radiance estimate is differentiable w.r.t. the continuous scene
parameters (BASELINE.json north star): sphere centres/radii, material
albedos/roughness/reflectivity (incl. IOR), camera pose.  Discrete decisions
— the winning hit index, the dielectric reflect/refract coin, live masks,
metal absorption — are piecewise-constant and deliberately contribute no
gradient (detached-sampling convention; SURVEY.md §7 hard part (a): no
edge/silhouette gradients, matching finite differences on smooth paths).

Losses are computed on *pre-gamma* radiance by default: the reference's
sqrt gamma (mg_ray_tracer.cpp:195-198) has an infinite derivative at zero,
which would poison gradients of black pixels.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from .integrator import render_image

__all__ = [
    "extract_params",
    "apply_params",
    "render_for_loss",
    "image_loss",
    "loss_and_grad",
    "fd_check",
]

# Differentiable leaves, as (field path) pairs.
_PARAM_FIELDS = (
    ("spheres", "center"),
    ("spheres", "radius"),
    ("materials", "albedo"),
    ("materials", "roughness"),
    ("materials", "reflectivity"),
    ("camera", "position"),
    ("camera", "rotation"),
)


def extract_params(scene) -> dict[str, jax.Array]:
    """Pull the differentiable parameter pytree out of a scene.  Scenes
    using the ``--boxes`` extension additionally expose boxes.center /
    boxes.extents (box-free scenes keep the historical key set, so
    checkpoints and optimizer trees are unchanged for them)."""
    fields = _PARAM_FIELDS
    if scene.boxes.count > 0:
        fields = fields + (("boxes", "center"), ("boxes", "extents"))
    return {f"{a}.{b}": getattr(getattr(scene, a), b) for a, b in fields}


def apply_params(scene, params: dict[str, jax.Array]):
    """Rebuild a scene with the given parameter values substituted."""
    groups: dict[str, dict[str, Any]] = {}
    for k, v in params.items():
        a, b = k.split(".")
        groups.setdefault(a, {})[b] = v
    for a, kv in groups.items():
        sub = dataclasses.replace(getattr(scene, a), **kv)
        scene = dataclasses.replace(scene, **{a: sub})
    return scene


def render_for_loss(
    params: dict[str, jax.Array],
    scene,
    size: tuple[int, int],
    key: jax.Array,
    *,
    spp: int = 4,
    max_bounces: int = 4,
    personality: str = "mg",
    render_fn=None,
    grad_mode: str = "replay",
    **opts,
) -> jax.Array:
    """Render with substituted params; pre-gamma radiance (H, W, 3).

    ``render_fn(scene, size, key, **opts)`` overrides the renderer (e.g.
    rt_tpu.dist.render_image_sharded for a sharded loss).  ``grad_mode``
    defaults to "replay" (rt_tpu.replay): identical value and
    detached-sampling gradient, far cheaper backward pass."""
    scene = apply_params(scene, params)
    if render_fn is None:
        render_fn = render_image
    return render_fn(
        scene, size, key,
        spp=spp, max_bounces=max_bounces, personality=personality,
        gamma=False, grad_mode=grad_mode, **opts,
    )


def image_loss(params, scene, target, size, key, **opts) -> jax.Array:
    """Mean-squared error against a target (pre-gamma) image."""
    img = render_for_loss(params, scene, size, key, **opts)
    return jnp.mean((img - jnp.asarray(target)) ** 2)


def loss_and_grad(params, scene, target, size, key, **opts):
    """(loss, grads) — deterministic for a fixed key, so finite-difference
    validation applies directly."""
    return jax.value_and_grad(image_loss)(params, scene, target, size, key, **opts)


def fd_check(params, scene, target, size, key, name: str, index=0, *,
             eps: float = 1e-3, **opts):
    """Central finite difference of :func:`image_loss` in one parameter
    element against the analytic gradient.  Returns ``(analytic, fd, ok)``
    with ok = |analytic - fd| <= max(2e-2 |fd|, 1e-4): the draws are the
    same on both sides (fixed key), so only a wrong gradient or a path flip
    inside +-eps separates them."""
    p_hi = dict(params)
    p_hi[name] = params[name].at[index].add(eps)
    p_lo = dict(params)
    p_lo[name] = params[name].at[index].add(-eps)
    l_hi = float(image_loss(p_hi, scene, target, size, key, **opts))
    l_lo = float(image_loss(p_lo, scene, target, size, key, **opts))
    fd = (l_hi - l_lo) / (2 * eps)
    _, grads = loss_and_grad(params, scene, target, size, key, **opts)
    an = float(grads[name][index])
    return an, fd, abs(an - fd) <= max(2e-2 * abs(fd), 1e-4)
