import os

import numpy as np
import pytest

from rt_tpu.cli import main

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")


def test_list(capsys):
    assert main(["--list"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == ["mg_ray_tracer", "sm_ray_tracer", "rasterizer", "null_renderer"]


def test_render_to_file(tmp_path, capsys):
    out = str(tmp_path / "img.png")
    rc = main(["--scene", os.path.join(SCENES, "basic.toml"), "--renderer", "mg",
               "--size", "32x24", "--spp", "1", "--bounces", "2", "--out", out])
    assert rc == 0
    assert os.path.exists(out)
    assert open(out, "rb").read(4) == b"\x89PNG"
    log = capsys.readouterr().out
    assert "created renderer: mg_ray_tracer" in log
    assert f"scene '{os.path.join(SCENES, 'basic.toml')}' loaded." in log


def test_npy_output(tmp_path):
    out = str(tmp_path / "img.npy")
    rc = main(["--scene", os.path.join(SCENES, "basic.toml"), "--renderer", "rasterizer",
               "--size", "16x12", "--out", out])
    assert rc == 0
    img = np.load(out)
    assert img.shape == (12, 16, 3)


def test_unknown_renderer(capsys):
    rc = main(["--renderer", "zzz", "--scene", os.path.join(SCENES, "basic.toml")])
    assert rc == 2
    assert "no known renderer" in capsys.readouterr().err


def test_missing_scene(capsys):
    rc = main(["--scene", "/nope/missing.toml"])
    assert rc == 1
    assert "did not exist" in capsys.readouterr().err


def test_bad_size(capsys):
    rc = main(["--size", "banana", "--scene", os.path.join(SCENES, "basic.toml")])
    assert rc == 2


def test_fuzzy_renderer_and_mesh(tmp_path):
    out = str(tmp_path / "img.ppm")
    rc = main(["--scene", os.path.join(SCENES, "basic.toml"), "--renderer", "sm",
               "--size", "16x12", "--spp", "1", "--bounces", "2",
               "--mesh", "2x2", "--out", out])
    assert rc == 0
    assert open(out, "rb").read(2) == b"P6"


def test_mesh_rejects_rasterizer(capsys):
    rc = main(["--scene", os.path.join(SCENES, "basic.toml"), "--renderer", "rasterizer",
               "--mesh", "4"])
    assert rc == 2


def test_procedural_scene(tmp_path, capsys):
    out = str(tmp_path / "proc.npy")
    rc = main(["--procedural", "12", "--renderer", "rasterizer",
               "--size", "16x12", "--out", out])
    assert rc == 0
    img = np.load(out)
    assert img.shape == (12, 16, 3)
    assert "<procedural:12>" in capsys.readouterr().out
