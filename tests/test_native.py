"""Native C++ runtime tests (native/librt_native.so via rt_tpu._native).

The native tracer is the MEASURED CPU baseline (bench.py, BASELINE.md), so
its estimator must statistically match the JAX renderer for both
personalities — mg (mg_ray_tracer.cpp:142-152 semantics) and sm
(dielectric family, sm_ray_tracer.cpp:181-236).  Parity is statistical at
equal spp (independent RNGs; tolerance from MC variance, SURVEY.md §4).
"""

import os
import subprocess

import numpy as np
import pytest

import rt_tpu
from rt_tpu import _native

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ensure_native():
    if not _native.available():
        subprocess.run(["make", "-C", os.path.join(REPO, "native")],
                       capture_output=True)
        _native._TRIED = False
    if not _native.available():
        pytest.skip("native library not available (no C++ toolchain?)")


def test_pack_rgba8888_reference_semantics():
    _ensure_native()
    # colour.hpp:100-106: clamp then *255.99999 then truncate
    rgba = np.asarray([[0.0, 1.0, 0.5, 2.0], [-1.0, 0.25, 0.999, 1.0]],
                      np.float32)
    out = _native.pack_rgba8888(rgba)
    exp = []
    for row in rgba:
        w = 0
        for v in row:
            w = (w << 8) | int(min(max(float(v), 0.0), 1.0) * 255.99999)
        exp.append(w)
    assert out.tolist() == exp


@pytest.mark.parametrize("pers,scene_path,tol", [
    ("mg", os.path.join(SCENES, "basic.toml"), 0.015),
    ("sm", os.path.join(SCENES, "dielectric.toml"), 0.015),
])
def test_native_tracer_statistical_parity(pers, scene_path, tol):
    _ensure_native()
    s = rt_tpu.load(scene_path)
    size = (100, 75)
    spp = 32
    from rt_tpu import renderer as reg

    img_n, secs = _native.render_cpu(s, size, spp=spp, max_bounces=8,
                                     personality=pers)
    assert secs > 0
    img_j = np.asarray(reg.create(pers)(s, size, rt_tpu.rng.make_key(7),
                                        spp=spp, max_bounces=8))
    d = np.abs(img_n - img_j)
    assert d.mean() < tol, f"mean abs diff {d.mean():.4f}"
    assert np.isfinite(img_n).all()


def test_native_sm_differs_from_mg_on_glass():
    # the dielectric family must actually refract: the sm and mg frames of
    # dielectric.toml must differ measurably (mg maps glass to lambert)
    _ensure_native()
    s = rt_tpu.load(os.path.join(SCENES, "dielectric.toml"))
    a, _ = _native.render_cpu(s, (100, 75), spp=16, max_bounces=8,
                              personality="sm")
    b, _ = _native.render_cpu(s, (100, 75), spp=16, max_bounces=8,
                              personality="mg")
    assert np.abs(a - b).mean() > 0.005
