"""Silent-fallback visibility: the performance-relevant downgrades must
warn (once)."""

import os

import numpy as np
import pytest

import jax
import jax.random as jr

import rt_tpu
from rt_tpu import log as rtlog

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")


@pytest.fixture(autouse=True)
def _fresh_warnings():
    rtlog.reset_warnings()
    yield
    rtlog.reset_warnings()


def test_warn_once_is_once(capsys):
    assert rtlog.warn_once("k", "message one")
    assert not rtlog.warn_once("k", "message one")
    err = capsys.readouterr().err
    assert err.count("message one") == 1


def test_sharded_replay_no_downgrade(capsys):
    """Round 3: prims-sharded replay runs the global-winner path — the
    round-2 warn-and-downgrade-to-autodiff is gone (tests/test_dist.py
    asserts gradient parity; here: NO warning is emitted)."""
    from rt_tpu import dist

    mesh = dist.make_mesh(2, 2, devices=jax.devices()[:4])
    s = rt_tpu.load(os.path.join(SCENES, "basic.toml"))
    img = dist.render_image_sharded(
        s, (32, 24), jr.key(0), mesh, spp=1, max_bounces=2,
        grad_mode="replay")
    np.asarray(img)
    assert "downgrading" not in capsys.readouterr().err
