"""Gradient correctness: analytic vs finite differences.

Convention (diff.py docstring, SURVEY.md §7): gradients flow through
continuous quantities (hit t, normals, Fresnel, attenuation); discrete
decisions are detached, so FD validation is done on smooth paths (interior
pixels / parameters that don't cross silhouettes at the probe epsilon).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rt_tpu
from rt_tpu import diff

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")

SCENE = os.path.join(SCENES, "basic.toml")
DIELECTRIC = os.path.join(SCENES, "dielectric.toml")


@pytest.fixture(scope="module")
def setup():
    s = rt_tpu.load(SCENE)
    key = rt_tpu.rng.make_key(11)
    params = diff.extract_params(s)
    return s, key, params


def _pixel_loss_fn(s, key, px, py, size=(32, 24), personality="mg"):
    def pixel_loss(p):
        img = diff.render_for_loss(p, s, size, key, spp=1, max_bounces=3,
                                   personality=personality)
        return img[py, px].sum()
    return pixel_loss


def _fd(loss, params, name, idx, eps=1e-3):
    def at(v):
        p = dict(params)
        p[name] = params[name].at[idx].set(v)
        return float(loss(p))
    v0 = float(params[name][idx])
    return (at(v0 + eps) - at(v0 - eps)) / (2 * eps)


@pytest.mark.parametrize("name,idx,tol", [
    ("spheres.radius", 1, 5e-3),
    ("spheres.center", (1, 0), 5e-3),
    ("camera.position", 1, 5e-3),
    ("materials.reflectivity", 1, 5e-3),
    ("materials.albedo", (1, 0), 5e-3),
])
def test_smooth_path_grads_match_fd(setup, name, idx, tol):
    s, key, params = setup
    # pixel in the interior of sphere 1's disc
    loss = _pixel_loss_fn(s, key, 14, 14)
    an = float(jax.grad(loss)(params)[name][idx])
    fd = _fd(loss, params, name, idx)
    assert an == pytest.approx(fd, rel=tol, abs=1e-5)


def test_full_image_material_grads_match_fd(setup):
    # Material params don't move silhouettes → full-image FD is valid.
    s, key, params = setup
    target = jnp.zeros((24, 32, 3))

    def loss(p):
        return diff.image_loss(p, s, target, (32, 24), key, spp=2, max_bounces=3)

    grads = jax.grad(loss)(params)
    for name, idx in [("materials.reflectivity", 0), ("materials.roughness", 2),
                      ("materials.albedo", (2, 1))]:
        fd = _fd(lambda p: loss(p), params, name, idx)
        an = float(grads[name][idx])
        assert an == pytest.approx(fd, rel=2e-2, abs=1e-5), name


def test_dielectric_ior_grad(setup):
    # IOR (reflectivity) gradient through refraction in the sm personality.
    s = rt_tpu.load(DIELECTRIC)
    key = rt_tpu.rng.make_key(2)
    params = diff.extract_params(s)
    # pixel through the central glass sphere (material 3 at [-1, 0.5, 0]):
    from rt_tpu.camera import world_to_screen
    px_xy, _ = world_to_screen(s.camera, (48, 36), jnp.array([[-1.0, 0.5, 0.0]]))
    px, py = int(px_xy[0, 0]), int(px_xy[0, 1])
    loss = _pixel_loss_fn(s, key, px, py, size=(48, 36), personality="sm")
    an = float(jax.grad(loss)(params)["materials.reflectivity"][3])
    fd = _fd(loss, params, "materials.reflectivity", 3, eps=1e-3)
    assert np.isfinite(an)
    assert an == pytest.approx(fd, rel=2e-2, abs=1e-4)


def test_apply_extract_roundtrip(setup):
    s, _, params = setup
    s2 = diff.apply_params(s, params)
    for k, v in diff.extract_params(s2).items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(params[k]))


def test_grads_finite_everywhere(setup):
    s, key, params = setup
    target = jnp.zeros((24, 32, 3))
    _, grads = diff.loss_and_grad(params, s, target, (32, 24), key, spp=2, max_bounces=4)
    for k, g in grads.items():
        assert np.all(np.isfinite(np.asarray(g))), k


def test_sm_grads_finite_on_dielectric_scene():
    s = rt_tpu.load(DIELECTRIC)
    key = rt_tpu.rng.make_key(0)
    params = diff.extract_params(s)
    target = jnp.zeros((16, 24, 3))
    _, grads = diff.loss_and_grad(params, s, target, (24, 16), key,
                                  spp=2, max_bounces=4, personality="sm")
    for k, g in grads.items():
        assert np.all(np.isfinite(np.asarray(g))), k


@pytest.mark.parametrize("name,idx", [("materials.reflectivity", 0),
                                      ("materials.albedo", (1, 0))])
def test_fd_check_agrees_on_material_params(setup, name, idx):
    s, key, params = setup
    target = jnp.zeros((24, 32, 3))
    an, fd, ok = diff.fd_check(params, s, target, (32, 24), key, name, idx,
                               spp=2, max_bounces=3)
    assert ok and an != 0.0
    assert an == pytest.approx(fd, rel=2e-2, abs=1e-4)


def test_fd_check_flags_a_wrong_gradient(setup, monkeypatch):
    s, key, params = setup
    target = jnp.zeros((24, 32, 3))
    right = diff.loss_and_grad

    def doubled(*a, **k):
        loss, grads = right(*a, **k)
        return loss, jax.tree_util.tree_map(lambda g: 2 * g, grads)

    monkeypatch.setattr(diff, "loss_and_grad", doubled)
    _, _, ok = diff.fd_check(params, s, target, (32, 24), key,
                             "materials.reflectivity", 0, spp=2, max_bounces=3)
    assert not ok
