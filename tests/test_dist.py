"""Sharded rendering on the virtual 8-device CPU mesh (SURVEY.md §4:
multi-process CPU simulation as the fake backend for distributed tests)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rt_tpu
from rt_tpu import diff, dist

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")

SCENE = os.path.join(SCENES, "basic.toml")


@pytest.fixture(scope="module")
def setup():
    s = rt_tpu.load(SCENE)
    key = rt_tpu.rng.make_key(5)
    size = (64, 32)
    ref = np.asarray(
        rt_tpu.integrator.render_image(s, size, key, spp=2, max_bounces=4, ray_chunk=256)
    )
    return s, key, size, ref


def test_requires_8_devices():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("n_rays,n_prims", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_matches_unsharded_bitwise(setup, n_rays, n_prims):
    s, key, size, ref = setup
    mesh = dist.make_mesh(n_rays, n_prims)
    img = np.asarray(
        dist.render_image_sharded(s, size, key, mesh, spp=2, max_bounces=4, ray_chunk=256)
    )
    np.testing.assert_array_equal(img, ref)


def test_sharded_procedural_scene(setup):
    # primitive sharding on a bigger sphere table
    s = rt_tpu.scene.make_procedural_scene(100, spp=1)
    key = rt_tpu.rng.make_key(1)
    ref = np.asarray(rt_tpu.integrator.render_image(s, (32, 16), key, spp=1, max_bounces=3, ray_chunk=128))
    mesh = dist.make_mesh(2, 4)
    img = np.asarray(dist.render_image_sharded(s, (32, 16), key, mesh, spp=1, max_bounces=3, ray_chunk=128))
    np.testing.assert_array_equal(img, ref)


def test_sharded_gradients_match(setup):
    s, key, size, _ = setup
    params = diff.extract_params(s)
    target = jnp.zeros((size[1], size[0], 3))
    loss, grads = diff.loss_and_grad(params, s, target, size, key, spp=1, max_bounces=3,
                                     ray_chunk=256)
    mesh = dist.make_mesh(4, 2)
    sharded = jax.jit(lambda p: jax.value_and_grad(diff.image_loss)(
        p, s, target, size, key, spp=1, max_bounces=3, ray_chunk=256,
        render_fn=lambda sc, sz, k, **o: dist.render_image_sharded(sc, sz, k, mesh, **o),
    ))
    loss_sh, grads_sh = sharded(params)
    assert float(loss_sh) == pytest.approx(float(loss), rel=1e-6)
    for k in grads:
        np.testing.assert_allclose(np.asarray(grads_sh[k]), np.asarray(grads[k]),
                                   atol=1e-5, rtol=1e-4)


def test_shard_spheres_padding_inert(setup):
    s, key, size, ref = setup
    mesh = dist.make_mesh(1, 8)
    padded = dist.shard_spheres(s, mesh)
    assert padded.spheres.center.shape[0] % 8 == 0
    # padding must not hit anything: render unchanged
    img = np.asarray(
        dist.render_image_sharded(s, size, key, mesh, spp=2, max_bounces=4, ray_chunk=256)
    )
    np.testing.assert_array_equal(img, ref)


def test_mesh_shapes():
    m = dist.make_mesh(8, 1)
    assert m.shape == {"rays": 8, "prims": 1}
    m = dist.make_mesh(n_prims=2)
    assert m.shape == {"rays": 4, "prims": 2}


def test_sharded_replay_gradients_match(setup):
    """grad_mode='replay' on a prims-sharded (2,4) mesh must match the
    single-device replay gradients (round-2 VERDICT item 5: global-winner
    replay instead of the warn-and-downgrade-to-autodiff path)."""
    s = rt_tpu.scene.make_procedural_scene(100, spp=1)
    key = rt_tpu.rng.make_key(3)
    size = (32, 16)
    params = diff.extract_params(s)
    target = jnp.zeros((16, 32, 3))
    ref_fn = jax.jit(lambda p: jax.value_and_grad(diff.image_loss)(
        p, s, target, size, key, spp=1, max_bounces=3, ray_chunk=128,
        grad_mode="replay"))
    loss0, g0 = ref_fn(params)
    mesh = dist.make_mesh(2, 4)
    sh_fn = jax.jit(lambda p: jax.value_and_grad(diff.image_loss)(
        p, s, target, size, key, spp=1, max_bounces=3, ray_chunk=128,
        grad_mode="replay",
        render_fn=lambda sc, sz, k, **o: dist.render_image_sharded(
            sc, sz, k, mesh, **o)))
    loss1, g1 = sh_fn(params)
    assert float(loss1) == pytest.approx(float(loss0), rel=1e-6)
    for k in g0:
        np.testing.assert_allclose(np.asarray(g1[k]), np.asarray(g0[k]),
                                   atol=1e-6, rtol=1e-5)


def test_sharded_replay_value_bitwise(setup):
    """The sharded replay's forward value is bit-identical to unsharded."""
    s = rt_tpu.scene.make_procedural_scene(100, spp=1)
    key = rt_tpu.rng.make_key(7)
    ref = np.asarray(rt_tpu.integrator.render_image(
        s, (32, 16), key, spp=1, max_bounces=3, ray_chunk=128,
        grad_mode="replay"))
    mesh = dist.make_mesh(2, 4)
    img = np.asarray(dist.render_image_sharded(
        s, (32, 16), key, mesh, spp=1, max_bounces=3, ray_chunk=128,
        grad_mode="replay"))
    np.testing.assert_array_equal(img, ref)
