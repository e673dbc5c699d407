"""Equivalence of the wavefront integrator against the recursive NumPy
mirror (tests/ref_impl.py) when fed identical random draws."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rt_tpu
from rt_tpu import rng as _rng
from rt_tpu.integrator import render_image, render_null, sky_colour, trace_batch

import ref_impl

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")


def _mirror_rng(key, n):
    """Reproduce trace_batch's per-bounce draw chain (integrator.py)."""

    def rng(bounce):
        kb = _rng.fold(key, bounce)
        ur = np.asarray(_rng.unit_vector(_rng.fold(kb, 1), (n,)))
        coin = np.asarray(_rng.uniform(_rng.fold(kb, 2), (n,)))
        return ur, coin

    return rng


@pytest.mark.parametrize("personality,table,scene_file", [
    ("mg", ref_impl.MG_TABLE, "basic.toml"),
    ("sm", ref_impl.SM_TABLE, "basic.toml"),
    ("sm", ref_impl.SM_TABLE, "dielectric.toml"),
])
def test_trace_matches_mirror(personality, table, scene_file):
    s = rt_tpu.load(os.path.join(SCENES, scene_file))
    snp = ref_impl.scene_to_np(s)
    cam = ref_impl.camera_to_np(s)

    w, h = 24, 16
    n = w * h
    idx = np.arange(n)
    grid = np.stack([idx % w, idx // w], axis=-1).astype(np.float32) + 0.5
    o_np, d_np = ref_impl.generate_rays(cam["pos"], cam["rot"], cam["vfov"], cam["near"], (w, h), grid)

    key = _rng.fold(_rng.make_key(7), 99)
    max_bounces = 5
    rad = trace_batch(
        s, jnp.asarray(o_np), jnp.asarray(d_np), key,
        personality=personality, max_bounces=max_bounces,
    )
    expected = ref_impl.trace_np(snp, o_np, d_np, max_bounces, 0, _mirror_rng(key, n), table)
    np.testing.assert_allclose(np.asarray(rad), expected, atol=2e-4, rtol=1e-3)


def test_render_matches_mirror_end_to_end():
    s = rt_tpu.load(os.path.join(SCENES, "basic.toml"))
    snp = ref_impl.scene_to_np(s)
    cam = ref_impl.camera_to_np(s)
    w, h = 32, 32
    n = w * h
    key = _rng.make_key(3)
    spp, mb = 3, 4

    img = np.asarray(render_image(s, (w, h), key, spp=spp, max_bounces=mb, ray_chunk=n))

    def rng_for_sample(sidx):
        ks = _rng.fold(key, sidx)
        kc = _rng.fold(ks, 0)  # single chunk
        base = _rng.fold(kc, 3)
        return _mirror_rng(base, n)

    def jitter_for_sample(sidx):
        ks = _rng.fold(key, sidx)
        kc = _rng.fold(ks, 0)
        return np.asarray(_rng.uniform(_rng.fold(kc, 0), (n, 2)))

    expected = ref_impl.render_np(snp, cam, (w, h), spp, mb, ref_impl.MG_TABLE,
                                  rng_for_sample, jitter_for_sample)
    np.testing.assert_allclose(img, expected, atol=5e-4, rtol=1e-3)


def test_sky_only_scene_deterministic():
    # Camera pointed straight up at an empty scene: every sample sees the
    # same sky; spp cancels; gamma = sqrt (mg_ray_tracer.cpp:164,195-198).
    s = rt_tpu.loads("camera = { position = 'origin', direction = 'up' }\n")
    img = np.asarray(render_image(s, (8, 8), _rng.make_key(0), spp=2, max_bounces=3))
    # direction 'up' → d.y = 1 → sky = (0.5, 0.7, 1.0); sqrt applied
    center = img[4, 4]
    assert np.allclose(center, np.sqrt([0.5, 0.7, 1.0]), atol=5e-3)


def test_sky_colour_formula():
    d = jnp.array([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, 1.0]])
    sky = np.asarray(sky_colour(d))
    assert np.allclose(sky[0], [0.5, 0.7, 1.0])
    assert np.allclose(sky[1], [1.0, 1.0, 1.0])
    assert np.allclose(sky[2], [0.75, 0.85, 1.0])


def test_depth_exhaustion_black():
    # A mirror box of... simpler: max_bounces=1 with a lambert sphere filling
    # the view: first bounce hits, second level would be needed → black.
    s = rt_tpu.loads(
        "materials = [ { type = 'lambert', albedo = 'white' } ]\n"
        "spheres = [ { material = 0, position = [0, 1, -3], radius = 1.0 } ]\n"
        "camera = { position = [0, 1, -1], direction = 'forward' }\n"
    )
    img = np.asarray(render_image(s, (8, 8), _rng.make_key(0), spp=1, max_bounces=1))
    assert np.allclose(img[4, 4], 0.0, atol=1e-6)


def test_null_renderer_black():
    s = rt_tpu.loads("")
    img = np.asarray(render_null(s, (16, 8)))
    assert img.shape == (8, 16, 3)
    assert np.all(img == 0)


def test_render_jits_cleanly():
    s = rt_tpu.load(os.path.join(SCENES, "basic.toml"))
    f = jax.jit(lambda sc, k: render_image(sc, (16, 12), k, spp=2, max_bounces=3))
    img1 = f(s, _rng.make_key(0))
    img2 = f(s, _rng.make_key(0))
    np.testing.assert_array_equal(np.asarray(img1), np.asarray(img2))
