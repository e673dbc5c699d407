"""Camera math: pose, rotations, viewport projections and ray generation.

Re-implements the reference's pinhole camera (/root/reference/src/camera.hpp)
as pure, differentiable jnp functions:

* ``viewport()`` (camera.hpp:121-137) built view / perspective-projection /
  inverse matrices; ``screen_to_world`` (camera.hpp:42-48) un-projected a
  pixel at NDC depth 0 (near plane) and 1 (far plane), and the renderers
  formed the primary ray between the two points (mg_ray_tracer.cpp:189-193).
  Here :func:`generate_rays` computes the identical ray directly: the pixel's
  view-space direction scaled to the near/far planes, rotated into world
  space.  Ray origin lies on the near plane — exactly as the reference.
* NDC convention (camera.hpp:42-48): x = 2*sx/W - 1, y = 1 - 2*sy/H, depth
  in [0, 1] mapping near→0, far→1.
* vfov is the vertical field of view, default pi/4 (camera.hpp:54).

Everything is differentiable w.r.t. camera position and rotation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "look_rotation",
    "rotate_yaw",
    "rotate_pitch",
    "generate_rays",
    "view_projection",
    "world_to_screen",
    "screen_to_world",
]

_WORLD_UP = jnp.array([0.0, 1.0, 0.0], dtype=jnp.float32)


def look_rotation(direction: jax.Array, world_up: jax.Array = _WORLD_UP) -> jax.Array:
    """Orthonormal rotation whose -z column (camera forward) is ``direction``.

    Equivalent to ``mat3::from_3d_direction`` as used by ``camera::pose``
    (camera.hpp:116-119): columns are (right, up, backward).  Degenerate
    (direction parallel to world up) falls back to a z-axis reference so the
    function stays total and jit-safe.
    """
    f = direction / jnp.linalg.norm(direction)
    # Branchless degenerate handling: if f is (anti)parallel to world_up,
    # use the z axis as the reference "up" instead.
    parallel = jnp.abs(jnp.dot(f, world_up, precision="highest")) > 0.999999
    ref_up = jnp.where(parallel, jnp.array([0.0, 0.0, 1.0], dtype=f.dtype), world_up)
    # Conventional lookAt basis: right = normalize(cross(f, up)); for
    # f=(0,0,-1), up=(0,1,0) this yields +x, i.e. screen-right.
    right = jnp.cross(f, ref_up)
    right = right / jnp.linalg.norm(right)
    up = jnp.cross(right, f)
    return jnp.stack([right, up, -f], axis=1)


def _axis_angle(axis: jax.Array, angle) -> jax.Array:
    """Rotation matrix about a unit axis (Rodrigues)."""
    axis = axis / jnp.linalg.norm(axis)
    x, y, z = axis[0], axis[1], axis[2]
    c = jnp.cos(angle)
    s = jnp.sin(angle)
    C = 1.0 - c
    return jnp.array(
        [
            [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
            [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
            [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
        ],
        dtype=jnp.float32,
    )


def rotate_yaw(rotation: jax.Array, angle) -> jax.Array:
    """Yaw about the *world* up axis (camera.hpp:80-84)."""
    return jnp.matmul(_axis_angle(_WORLD_UP, angle), rotation,
                      precision="highest")


def rotate_pitch(rotation: jax.Array, angle) -> jax.Array:
    """Pitch about the camera's current right axis (camera.hpp:86-91)."""
    right = jnp.matmul(rotation, jnp.array([1.0, 0.0, 0.0], jnp.float32),
                       precision="highest")
    return jnp.matmul(_axis_angle(right, angle), rotation,
                      precision="highest")


def generate_rays(camera, size: tuple[int, int], pixel_pos: jax.Array):
    """Primary rays for continuous pixel positions.

    Args:
      camera: a :class:`rt_tpu.scene.Camera`.
      size: (width, height) in pixels.
      pixel_pos: (..., 2) float32 continuous pixel coordinates (the caller
        adds the reference's +0.5 centre offset / jitter,
        mg_ray_tracer.cpp:189).

    Returns:
      (origins, directions): (..., 3) arrays.  Origins lie on the near plane;
      directions are unit, matching ``ray{near, direction(near, far)}``
      (mg_ray_tracer.cpp:190-193).
    """
    w, h = size
    th = jnp.tan(jnp.asarray(camera.vfov, jnp.float32) * 0.5)
    aspect = jnp.asarray(w / h, jnp.float32)
    nx = 2.0 * (pixel_pos[..., 0] / w) - 1.0
    ny = 1.0 - 2.0 * (pixel_pos[..., 1] / h)
    # View-space direction through the pixel (camera looks down -z).
    d_view = jnp.stack([nx * th * aspect, ny * th, -jnp.ones_like(nx)], axis=-1)
    # R @ d, batched.  precision="highest": without it the GPU may run
    # this f32 product in TF32 (about three decimal digits), a direction
    # error that flips hit decisions on grazing geometry
    d_world = jnp.matmul(d_view, camera.rotation.T, precision="highest")
    origins = camera.position + d_world * camera.near
    directions = d_world / jnp.linalg.norm(d_world, axis=-1, keepdims=True)
    return origins, directions


def view_projection(camera, size: tuple[int, int]) -> jax.Array:
    """Full 4x4 view-projection matrix (camera.hpp:121-137): perspective with
    NDC z in [0,1] (near→0, far→1) composed with the inverse rigid pose."""
    w, h = size
    f = 1.0 / jnp.tan(jnp.asarray(camera.vfov, jnp.float32) * 0.5)
    a = w / h
    n, fr = camera.near, camera.far
    proj = jnp.array(
        [
            [f / a, 0.0, 0.0, 0.0],
            [0.0, f, 0.0, 0.0],
            [0.0, 0.0, fr / (n - fr), n * fr / (n - fr)],
            [0.0, 0.0, -1.0, 0.0],
        ],
        dtype=jnp.float32,
    )
    R = camera.rotation
    t = camera.position
    view = jnp.eye(4, dtype=jnp.float32)
    view = view.at[:3, :3].set(R.T)
    view = view.at[:3, 3].set(-jnp.matmul(R.T, t, precision="highest"))
    return jnp.matmul(proj, view, precision="highest")


def world_to_screen(camera, size: tuple[int, int], world_pos: jax.Array):
    """Project world positions to pixel coordinates + NDC depth
    (camera.hpp:21-39).  Returns ((..., 2) pixels, (...,) depth)."""
    vp = view_projection(camera, size)
    p = jnp.concatenate([world_pos, jnp.ones_like(world_pos[..., :1])], axis=-1)
    clip = jnp.matmul(p, vp.T, precision="highest")
    wcoord = clip[..., 3:4]
    ndc = jnp.where(wcoord != 0.0, clip / wcoord, clip)
    w, h = size
    sx = (ndc[..., 0] + 1.0) * (w / 2.0)
    sy = (1.0 - ndc[..., 1]) * (h / 2.0)
    return jnp.stack([sx, sy], axis=-1), ndc[..., 2]


def screen_to_world(camera, size: tuple[int, int], pixel_pos: jax.Array, depth) -> jax.Array:
    """Un-project pixels at an NDC depth in [0, 1] (camera.hpp:42-48).
    depth=0 → near plane, depth=1 → far plane."""
    w, h = size
    th = jnp.tan(jnp.asarray(camera.vfov, jnp.float32) * 0.5)
    aspect = jnp.asarray(w / h, jnp.float32)
    nx = 2.0 * (pixel_pos[..., 0] / w) - 1.0
    ny = 1.0 - 2.0 * (pixel_pos[..., 1] / h)
    d_view = jnp.stack([nx * th * aspect, ny * th, -jnp.ones_like(nx)], axis=-1)
    # NDC depth d maps to a view-space z via the projective interpolation of
    # the [near, far] range: z_view = near*far / ((1-d)*far + d*near)
    # (the cancellation-free form of near*far / (far - d*(far-near))).
    depth = jnp.asarray(depth, jnp.float32)
    z = camera.near * camera.far / ((1.0 - depth) * camera.far + depth * camera.near)
    d_world = jnp.matmul(d_view, camera.rotation.T, precision="highest")
    return camera.position + d_world * z[..., None]
