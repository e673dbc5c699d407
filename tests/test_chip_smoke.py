"""chip_smoke.py and rt_tpu.runtime on the CPU: the gates bite, the device
check refuses a run without the card, the compile-cache helper honours
JAX_COMPILATION_CACHE_DIR, and the smoke's phases, gates and four-device
path run end to end at tiny sizes (the rehearsal of a chip run)."""

import importlib.util
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import rt_tpu
from rt_tpu import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "scenes")

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _render(name, key, bounces, personality="mg", size=(64, 48), spp=16, **kw):
    s = rt_tpu.load(os.path.join(SCENES, name))
    return np.asarray(rt_tpu.integrator.render_image(
        s, size, rt_tpu.rng.make_key(key), spp=spp, max_bounces=bounces,
        personality=personality, **kw))


@pytest.mark.parametrize("name,personality", [("basic.toml", "mg"),
                                              ("dielectric.toml", "sm")])
def test_mc_gate_catches_one_bounce_short(name, personality):
    ref = _render(name, 1, 4, personality)
    ref2 = _render(name, 2, 4, personality)
    short = _render(name, 3, 3, personality)
    fair = _render(name, 3, 4, personality)
    assert not chip_smoke.mc_gate(short, ref, ref2, "one bounce short")[0]
    assert chip_smoke.mc_gate(fair, ref, ref2, "same estimator")[0]


def test_det_gate_catches_one_bounce_short():
    ref = _render("basic.toml", 0, 1, spp=1, gamma=False)
    short = _render("basic.toml", 0, 2, spp=1, gamma=False)
    assert not chip_smoke.det_gate(short, ref, "depth slip")[0]
    assert chip_smoke.det_gate(ref.copy(), ref, "same frame")[0]
    # a handful of grazing-pixel flips stays under the 0.1% limit
    flipped = ref.copy()
    flipped.reshape(-1)[:2] += 1.0
    assert chip_smoke.det_gate(flipped, ref, "two values")[0]


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu()


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    r = _run_smoke(REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("environ,expected", [
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"}, None),
    ({}, os.path.join(REPO, ".jax_cache")),
])
def test_compile_cache_dir(environ, expected):
    assert runtime.compile_cache_dir(environ) == expected


@pytest.mark.parametrize("env_dir", ["/elsewhere/cache", None])
def test_use_compile_cache_honours_env(monkeypatch, env_dir):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    runtime.use_compile_cache()
    if env_dir is None:
        assert calls == [("jax_compilation_cache_dir",
                          os.path.join(REPO, ".jax_cache"))]
    else:
        assert calls == []


def test_rehearse_gates_on_cpu():
    rep = chip_smoke.Report()
    cpu = jax.devices("cpu")
    chip_smoke.gates(rep, cpu[0], cpu[1], size=(24, 18), spp=2, grad_size=(12, 9))
    assert rep.failed == []


def test_rehearse_phases_on_cpu(capsys):
    rep = chip_smoke.Report()
    chip_smoke.phases(rep, "cpu", jax.devices("cpu")[0], size_div=40, spp_div=16)
    assert rep.failed == []
    out = capsys.readouterr().out
    for label, *_ in chip_smoke.PHASES:
        assert f"[phase] {label} forward" in out
    assert "[cut] config 4 scene" in out
    assert out.count("train step") == 2


def test_rehearse_four_devices_on_cpu():
    rep = chip_smoke.Report()
    chip_smoke.four(rep, "cpu", jax.devices("cpu")[:4], size=(32, 24), spp=2,
                    bounces=3, ray_chunk=64, train_size=(16, 12), train_spp=1,
                    train_chunk=16)
    assert rep.failed == []


@pytest.mark.gpu
def test_gates_on_gpu(gpu):
    rep = chip_smoke.Report()
    chip_smoke.gates(rep, gpu, jax.devices("cpu")[0])
    assert rep.failed == []
