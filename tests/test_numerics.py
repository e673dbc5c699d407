"""Numerical-hygiene guards (the functional-model analogue of the
reference's absent TSan/race jobs, SURVEY.md §5): renders and gradients
must be NaN/Inf-free under jax_debug_nans."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rt_tpu
from rt_tpu import diff

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")


@pytest.fixture(autouse=True)
def nan_debugging():
    jax.config.update("jax_debug_nans", True)
    yield
    jax.config.update("jax_debug_nans", False)


def test_render_nan_free_basic():
    s = rt_tpu.load(os.path.join(SCENES, "basic.toml"))
    img = rt_tpu.integrator.render_image(s, (24, 16), rt_tpu.rng.make_key(0),
                                         spp=2, max_bounces=4)
    assert np.all(np.isfinite(np.asarray(img)))


def test_render_nan_free_dielectric():
    s = rt_tpu.load(os.path.join(SCENES, "dielectric.toml"))
    img = rt_tpu.integrator.render_image(s, (24, 16), rt_tpu.rng.make_key(0),
                                         spp=2, max_bounces=4, personality="sm")
    assert np.all(np.isfinite(np.asarray(img)))


def test_grads_nan_free_under_debug():
    s = rt_tpu.load(os.path.join(SCENES, "basic.toml"))
    params = diff.extract_params(s)
    target = jnp.zeros((16, 24, 3))
    for mode in ("autodiff", "replay"):
        loss, grads = diff.loss_and_grad(
            params, s, target, (24, 16), rt_tpu.rng.make_key(1),
            spp=1, max_bounces=3, grad_mode=mode,
        )
        assert np.isfinite(float(loss))
        for k, g in grads.items():
            assert np.all(np.isfinite(np.asarray(g))), (mode, k)


def test_degenerate_geometry_no_nans():
    # zero-radius sphere, duplicate spheres, grazing plane
    s = rt_tpu.loads(
        "materials = [ { type = 'metal', albedo = 'white', roughness = 0 } ]\n"
        "spheres = [ { material = 0, position = [0,1,-3], radius = 0.0 },\n"
        "            { material = 0, position = [0,1,-3], radius = 0.5 },\n"
        "            { material = 0, position = [0,1,-3], radius = 0.5 } ]\n"
        "planes = [ { material = 0, position = 'origin', normal = 'up' } ]\n"
    )
    img = rt_tpu.integrator.render_image(s, (16, 12), rt_tpu.rng.make_key(0),
                                         spp=2, max_bounces=6)
    assert np.all(np.isfinite(np.asarray(img)))


# Adversarial geometry: r=0 sphere, exact duplicates (tie at identical t), a
# glass sphere the camera ray grazes tangentially (disc ~ 0), a sphere
# tangent to the plane, and a plane nearly parallel to the view rays.
DEGENERATE = (
    "materials = [ { type = 'metal', albedo = 'white', roughness = 0.0 },\n"
    "              { type = 'lambert', albedo = 'red' },\n"
    "              { type = 'dielectric', albedo = 'white' } ]\n"
    "spheres = [ { material = 0, position = [0,1,-3], radius = 0.0 },\n"
    "            { material = 1, position = [0,1,-3], radius = 0.5 },\n"
    "            { material = 1, position = [0,1,-3], radius = 0.5 },\n"
    "            { material = 2, position = [1.5,0.5,-3], radius = 0.5 },\n"
    "            { material = 1, position = [-1.5,0.5,-4], radius = 0.5 } ]\n"
    "planes = [ { material = 1, position = 'origin', normal = 'up' },\n"
    "           { material = 1, position = [0,0,-50], normal = 'backward' } ]\n"
)


@pytest.mark.parametrize("personality", ["mg", "sm"])
def test_degenerate_scene_render_finite(personality):
    s = rt_tpu.loads(DEGENERATE)
    img = rt_tpu.integrator.render_image(s, (32, 24), rt_tpu.rng.make_key(3),
                                         spp=2, max_bounces=6,
                                         personality=personality)
    assert np.all(np.isfinite(np.asarray(img)))


@pytest.mark.parametrize("personality", ["mg", "sm"])
def test_degenerate_scene_replay_matches_autodiff(personality):
    """Replay pins the same discrete path structure autodiff differentiates
    through, so on the adversarial scene both give the same value and
    gradients, all finite."""
    s = rt_tpu.loads(DEGENERATE)
    params = diff.extract_params(s)
    target = jnp.zeros((18, 24, 3))
    out = {}
    for mode in ("autodiff", "replay"):
        out[mode] = diff.loss_and_grad(
            params, s, target, (24, 18), rt_tpu.rng.make_key(5),
            spp=2, max_bounces=4, personality=personality, grad_mode=mode)
    (la, ga), (lr, gr) = out["autodiff"], out["replay"]
    assert float(la) == pytest.approx(float(lr), rel=1e-6)
    for k in ga:
        a, r = np.asarray(ga[k]), np.asarray(gr[k])
        assert np.all(np.isfinite(r)), k
        np.testing.assert_allclose(r, a, rtol=1e-4, atol=1e-6, err_msg=k)
