"""Replay-mode gradients: value equality with the direct trace, gradient
equality with direct autodiff."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rt_tpu
from rt_tpu import diff
from rt_tpu.integrator import trace_batch
from rt_tpu.replay import replay_radiance, trace_batch_recorded, trace_batch_replay

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")

SCENE = os.path.join(SCENES, "basic.toml")
DIELECTRIC = os.path.join(SCENES, "dielectric.toml")


def _rays(scene, size=(24, 16)):
    from rt_tpu.camera import generate_rays

    w, h = size
    idx = np.arange(w * h)
    grid = jnp.asarray(
        np.stack([idx % w, idx // w], axis=-1).astype(np.float32) + 0.5
    )
    return generate_rays(scene.camera, size, grid)


@pytest.mark.parametrize("scene_file,personality", [
    (SCENE, "mg"), (DIELECTRIC, "sm"),
])
def test_replay_value_matches_trace(scene_file, personality):
    s = rt_tpu.load(scene_file)
    o, d = _rays(s)
    key = rt_tpu.rng.make_key(9)
    direct = trace_batch(s, o, d, key, personality=personality, max_bounces=5)
    replay = trace_batch_replay(s, o, d, key, personality=personality, max_bounces=5)
    # tolerance covers float reassociation between the two compiled programs
    np.testing.assert_allclose(np.asarray(replay), np.asarray(direct), atol=1e-4, rtol=1e-4)


def test_records_shapes():
    s = rt_tpu.load(SCENE)
    o, d = _rays(s, (8, 8))
    rad, recs = trace_batch_recorded(s, o, d, rt_tpu.rng.make_key(0), max_bounces=3)
    assert rad.shape == (64, 3)
    assert recs.kind.shape == (3, 64)
    assert recs.miss.dtype == bool


@pytest.mark.parametrize("scene_file,personality", [
    (SCENE, "mg"), (DIELECTRIC, "sm"),
])
def test_replay_grads_match_autodiff(scene_file, personality):
    s = rt_tpu.load(scene_file)
    key = rt_tpu.rng.make_key(4)
    size = (24, 16)
    params = diff.extract_params(s)
    target = jnp.zeros((size[1], size[0], 3))

    def loss(p, mode):
        return diff.image_loss(p, s, target, size, key, spp=2, max_bounces=4,
                               personality=personality, grad_mode=mode)

    l_auto, g_auto = jax.value_and_grad(loss)(params, "autodiff")
    l_rep, g_rep = jax.value_and_grad(loss)(params, "replay")
    assert float(l_rep) == pytest.approx(float(l_auto), rel=1e-5)
    for k in g_auto:
        np.testing.assert_allclose(
            np.asarray(g_rep[k]), np.asarray(g_auto[k]), atol=2e-4, rtol=2e-3,
            err_msg=k,
        )


def test_replay_through_sharded_render():
    from rt_tpu import dist

    s = rt_tpu.load(SCENE)
    key = rt_tpu.rng.make_key(5)
    size = (32, 16)
    params = diff.extract_params(s)
    target = jnp.zeros((size[1], size[0], 3))
    mesh = dist.make_mesh(8, 1)

    def render_fn(sc, sz, k, **o):
        return dist.render_image_sharded(sc, sz, k, mesh, **o)

    l1, g1 = diff.loss_and_grad(params, s, target, size, key, spp=1, max_bounces=3,
                                ray_chunk=64)
    # shard_map with an inner scan must run under jit (eager shard_map
    # doesn't support closed_call yet)
    sharded = jax.jit(lambda p: jax.value_and_grad(diff.image_loss)(
        p, s, target, size, key, spp=1, max_bounces=3, ray_chunk=64,
        render_fn=render_fn))
    l2, g2 = sharded(params)
    assert float(l1) == pytest.approx(float(l2), rel=1e-6)
    for k in g1:
        np.testing.assert_allclose(np.asarray(g2[k]), np.asarray(g1[k]),
                                   atol=1e-5, rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# --boxes extension through record/replay (round-3 VERDICT item 9)
# ---------------------------------------------------------------------------

BOX_SCENE = (
    "samples_per_pixel = 2\n"
    "max_bounces = 4\n"
    "materials = [ { type = 'lambert', albedo = 'gray' },\n"
    "              { type = 'metal', albedo = 'white', roughness = 0.1 },\n"
    "              { type = 'lambert', albedo = 'red' } ]\n"
    "spheres = [ { material = 0, position = [0,-1000,0], radius = 1000 } ]\n"
    "boxes = [ { material = 2, position = [0, 0.5, -3], extents = [0.5, 0.5, 0.5] },\n"
    "          { material = 1, position = [1.6, 0.4, -3.5], extents = [0.4, 0.4, 0.4] } ]\n"
)


def test_box_replay_value_matches_trace():
    """trace_batch_replay(include_boxes) reproduces trace_batch's value
    on a box scene (kind=3 records + smooth slab replay; tolerance covers
    float reassociation between the two compiled programs, as in
    test_replay_value_matches_trace)."""
    s = rt_tpu.loads(BOX_SCENE)
    key = rt_tpu.rng.make_key(3)
    o, d = _rays(s)
    a = trace_batch(s, o, d, key, max_bounces=4, include_boxes=True)
    b = trace_batch_replay(s, o, d, key, max_bounces=4, include_boxes=True)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4,
                               rtol=1e-4)


def test_box_replay_gradients_match_autodiff():
    """Replay gradients == full-autodiff gradients on a box scene,
    including the new boxes.center/extents parameters (detached-sampling
    convention on both sides)."""
    s = rt_tpu.loads(BOX_SCENE)
    params = diff.extract_params(s)
    assert "boxes.center" in params and "boxes.extents" in params
    key = rt_tpu.rng.make_key(11)
    size = (24, 18)
    target = jnp.zeros((18, 24, 3), jnp.float32)
    kw = dict(spp=2, max_bounces=4, include_boxes=True)
    l_r, g_r = diff.loss_and_grad(params, s, target, size, key,
                                  grad_mode="replay", **kw)
    l_a, g_a = diff.loss_and_grad(params, s, target, size, key,
                                  grad_mode="autodiff", **kw)
    assert float(l_r) == pytest.approx(float(l_a), rel=1e-6)
    for k in g_a:
        a, b = np.asarray(g_r[k]), np.asarray(g_a[k])
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a, b, atol=3e-4 * scale, rtol=3e-3,
                                   err_msg=k)
    # box geometry actually receives gradient (the box is visible)
    assert np.abs(np.asarray(g_r["boxes.center"])).max() > 0


def test_box_center_grad_matches_fd():
    """Smooth-path FD check on a box face: moving the box toward the
    camera changes the recorded-face t smoothly."""
    s = rt_tpu.loads(BOX_SCENE)
    params = diff.extract_params(s)
    key = rt_tpu.rng.make_key(2)
    size = (24, 18)
    target = jnp.zeros((18, 24, 3), jnp.float32)
    kw = dict(spp=1, max_bounces=2, include_boxes=True, grad_mode="replay")
    _, grads = diff.loss_and_grad(params, s, target, size, key, **kw)
    eps = 1e-3
    hi = dict(params)
    hi["boxes.center"] = params["boxes.center"].at[0, 2].add(eps)
    lo = dict(params)
    lo["boxes.center"] = params["boxes.center"].at[0, 2].add(-eps)
    lh = diff.image_loss(hi, s, target, size, key, **kw)
    ll = diff.image_loss(lo, s, target, size, key, **kw)
    fd = (float(lh) - float(ll)) / (2 * eps)
    an = float(grads["boxes.center"][0, 2])
    assert abs(an - fd) <= max(0.05 * abs(fd), 1e-5), (an, fd)
