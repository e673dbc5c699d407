import os

import numpy as np

import rt_tpu
from rt_tpu.integrator import render_rasterizer

import ref_impl

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")


def test_rasterizer_matches_mirror_basic():
    s = rt_tpu.load(os.path.join(SCENES, "basic.toml"))
    img = np.asarray(render_rasterizer(s, (48, 32)))
    expected = ref_impl.rasterize_np(ref_impl.scene_to_np(s), ref_impl.camera_to_np(s), (48, 32))
    np.testing.assert_allclose(img, expected, atol=2e-4, rtol=1e-3)


def test_rasterizer_with_boxes_and_planes():
    s = rt_tpu.loads(
        "materials = [ { type = 'lambert', albedo = 'red' },"
        "              { type = 'lambert', albedo = 'blue' } ]\n"
        "planes = [ { material = 0, position = 'origin', normal = 'up' } ]\n"
        "boxes = [ { material = 1, position = [0, 1, -4], extents = 0.7 } ]\n"
        "camera = { position = [0, 1.5, 0], direction = [0, -0.2, -1] }\n"
    )
    img = np.asarray(render_rasterizer(s, (40, 30)))
    expected = ref_impl.rasterize_np(ref_impl.scene_to_np(s), ref_impl.camera_to_np(s), (40, 30))
    np.testing.assert_allclose(img, expected, atol=2e-4, rtol=1e-3)


def test_rasterizer_sky_is_white_in_compat():
    # The reference's sky constants colour{238,245,255} / colour{208,228,255}
    # binarize to white through to_component_value (colour.hpp:72-84).
    s = rt_tpu.loads("camera = { position = 'origin', direction = 'up' }\n")
    img = np.asarray(render_rasterizer(s, (8, 8)))
    assert np.allclose(img, 1.0)
    img_true = np.asarray(render_rasterizer(s, (8, 8), compat_colours=False))
    assert not np.allclose(img_true, 1.0)  # light blue gradient


def test_rasterizer_tie_break_plane_wins():
    # rasterizer.cpp:41-63 scans planes -> boxes -> spheres with strict '<',
    # so a plane keeps an exact tie; the path tracers' select() gives the
    # tie to the sphere (mg_ray_tracer.cpp:95-102).  Geometry below makes
    # both hits land at exactly t = 5.0.
    import jax.numpy as jnp

    from rt_tpu.ops.intersect import closest_hit

    s = rt_tpu.loads(
        """
materials = [ { type = 'lambert' }, { type = 'metal' } ]
planes  = [ { material = 0, position = [0.0, 0.0, -5.0], normal = [0.0, 0.0, 1.0] } ]
spheres = [ { material = 1, position = [0.0, 0.0, -6.0], radius = 1.0 } ]
"""
    )
    o = jnp.zeros((1, 3), jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)

    tracer = closest_hit(s.spheres, s.planes, s.boxes, o, d)
    assert int(tracer.kind[0]) == 1          # sphere wins the tie
    assert int(tracer.material[0]) == 1

    rast = closest_hit(s.spheres, s.planes, s.boxes, o, d,
                       tie_order="rasterizer")
    assert int(rast.kind[0]) == 2            # plane keeps the tie
    assert int(rast.material[0]) == 0
    assert float(rast.t[0]) == 5.0
