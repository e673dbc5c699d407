import os

import numpy as np
import pytest

import rt_tpu
from rt_tpu.scene import MATERIAL_TYPES, load, loads, make_procedural_scene

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")


def test_load_reference_basic():
    # Literal values from /root/reference/scenes/basic.toml via the
    # deserialization rules of scene.cpp:483-618.
    s = load(os.path.join(SCENES, "basic.toml"))
    assert s.samples_per_pixel == 30  # commented out in the file → default
    assert s.max_bounces == 10
    assert np.allclose(np.asarray(s.camera.position), [0, 1, 3])
    assert np.allclose(np.asarray(s.camera.forward), [0, 0, -1], atol=1e-6)

    assert s.materials.count == 3
    t = np.asarray(s.materials.type)
    assert t[0] == MATERIAL_TYPES["lambert"]
    assert t[1] == MATERIAL_TYPES["lambert"]
    assert t[2] == MATERIAL_TYPES["metal"]
    alb = np.asarray(s.materials.albedo)
    assert np.allclose(alb[0], [1, 1, 1, 1])   # gray_33 binarizes (colour quirk)
    assert np.allclose(alb[1], [1, 0, 1, 1])   # fuchsia
    rough = np.asarray(s.materials.roughness)
    assert rough[0] == pytest.approx(0.5)      # default
    assert rough[2] == pytest.approx(0.05)
    refl = np.asarray(s.materials.reflectivity)
    assert refl[0] == pytest.approx(0.5)       # lambert default (scene.cpp:555)
    assert refl[2] == pytest.approx(0.8)       # metal default (scene.cpp:549)

    assert s.spheres.count == 3
    c = np.asarray(s.spheres.center)
    r = np.asarray(s.spheres.radius)
    assert np.allclose(c[0], [0, -1000, 0]) and r[0] == 1000
    assert np.allclose(c[1], [0, 0.5, 0]) and r[1] == 0.5  # default radius
    assert np.allclose(c[2], [1, 0.5, 0])
    assert list(np.asarray(s.spheres.material)[:3]) == [0, 1, 2]
    assert s.planes.count == 0
    assert s.boxes.count == 0


def test_load_reference_dielectric():
    s = load(os.path.join(SCENES, "dielectric.toml"))
    assert s.samples_per_pixel == 200
    assert s.materials.count == 7
    t = np.asarray(s.materials.type)
    assert t[1] == MATERIAL_TYPES["vacuum"]
    assert t[3] == MATERIAL_TYPES["dielectric"]
    refl = np.asarray(s.materials.reflectivity)
    assert refl[1] == pytest.approx(1.0)        # vacuum IOR
    assert refl[3] == pytest.approx(1.52)       # dielectric IOR
    assert refl[4] == pytest.approx(1.000293)   # air IOR
    assert refl[5] == pytest.approx(1.333)      # water IOR
    assert refl[6] == pytest.approx(1.31)       # ice IOR
    rough = np.asarray(s.materials.roughness)
    assert rough[3] == pytest.approx(0.0)       # dielectric roughness default
    assert s.spheres.count == 7


def test_clamps_and_defaults():
    s = loads("samples_per_pixel = 9999\nmax_bounces = 0\n")
    assert s.samples_per_pixel == 1000  # clamp [1,1000] (scene.cpp:531-532)
    assert s.max_bounces == 1
    # no materials → fallback fuchsia lambert (scene.cpp:565-566)
    assert s.materials.count == 1
    assert np.allclose(np.asarray(s.materials.albedo)[0], [1, 0, 1, 1])
    assert np.asarray(s.materials.roughness)[0] == pytest.approx(0.05)
    # default camera (camera.hpp:55, scene.cpp:536-537)
    assert np.allclose(np.asarray(s.camera.position), [0, 1, 0])


def test_sphere_defaults():
    s = loads("spheres = [ { material = 0 } ]\nmaterials = [ { type = 'lambert' } ]\n")
    assert np.allclose(np.asarray(s.spheres.center)[0], [0, 1, -3])  # scene.cpp:591
    assert np.asarray(s.spheres.radius)[0] == pytest.approx(0.5)


def test_plane_representation():
    s = loads(
        "materials = [ { type = 'lambert' } ]\n"
        "planes = [ { material = 0, position = [0, 2, 0], normal = [0, 3, 0] } ]\n"
    )
    n = np.asarray(s.planes.normal)[0]
    assert np.allclose(n, [0, 1, 0])  # normalized (scene.cpp:581)
    assert np.asarray(s.planes.d)[0] == pytest.approx(-2.0)  # d = -n·p


def test_box_defaults_and_broadcast():
    s = loads(
        "materials = [ { type = 'lambert' } ]\n"
        "boxes = [ { material = 0, extents = 2 } ]\n"
    )
    assert np.allclose(np.asarray(s.boxes.center)[0], [0, 1, -3])
    assert np.allclose(np.asarray(s.boxes.extents)[0], [2, 2, 2])  # scalar broadcast


def test_vector_aliases():
    s = loads("camera = { position = 'one', direction = 'down' }\n")
    assert np.allclose(np.asarray(s.camera.position), [1, 1, 1])
    assert np.allclose(np.asarray(s.camera.forward), [0, -1, 0], atol=1e-6)


def test_material_index_out_of_range():
    with pytest.raises(ValueError, match="out-of-range"):
        loads("materials = [ { type = 'lambert' } ]\nspheres = [ { material = 3 } ]\n")


def test_enum_by_int_and_name():
    s = loads("materials = [ { type = 1 } ]")
    assert np.asarray(s.materials.type)[0] == MATERIAL_TYPES["metal"]
    with pytest.raises(ValueError, match="not a member"):
        loads("materials = [ { type = 42 } ]")
    with pytest.raises(ValueError, match="not a member"):
        loads("materials = [ { type = 'adamantium' } ]")


def test_missing_scene_raises():
    with pytest.raises(FileNotFoundError):
        load("/definitely/not/here.toml")


def test_scene_is_pytree():
    import jax

    s = load(os.path.join(SCENES, "basic.toml"))
    leaves = jax.tree_util.tree_leaves(s)
    assert all(hasattr(l, "dtype") for l in leaves)
    s2 = jax.tree_util.tree_map(lambda x: x, s)
    assert s2.samples_per_pixel == s.samples_per_pixel


def test_procedural_scene():
    s = make_procedural_scene(50, spp=4)
    assert s.spheres.count == 50
    assert np.asarray(s.spheres.radius)[0] == 1000.0  # ground sphere
    assert s.materials.count > 0


def test_unsigned_fields_reject_negatives():
    # toml++ deserialize(..., unsigned{}) bounds-checks: a negative int is a
    # type mismatch, not a wrap-around (scene.cpp:88-101, 568-574)
    with pytest.raises(ValueError, match="unsigned"):
        rt_tpu.loads("samples_per_pixel = -3\n")
    with pytest.raises(ValueError, match="unsigned"):
        rt_tpu.loads("max_bounces = -1\n")
    with pytest.raises(ValueError, match="unsigned"):
        rt_tpu.loads(
            "materials = [ { type = 'lambert' } ]\n"
            "spheres = [ { material = -1 } ]\n"
        )


def test_loader_errors_carry_source_positions():
    # the reference threads node.source() into every loader error
    # (scene.cpp:58-66); ours carry best-effort line/column
    with pytest.raises(ValueError, match=r"line 1, column 1"):
        rt_tpu.loads("samples_per_pixel = -3\n")
    with pytest.raises(ValueError, match=r"line 2, column 15"):
        rt_tpu.loads(
            "materials = [ { type = 'lambert' } ]\n"
            "spheres = [ { material = 9 } ]\n"
        )
    with pytest.raises(ValueError, match=r"line 3, column 21"):
        rt_tpu.loads(
            "materials = [\n"
            "  { type = 'lambert' },\n"
            "  { type = 'metal', roughness = 'x' },\n"
            "]\n"
        )
    with pytest.raises(ValueError, match=r"line 2, column 1"):
        rt_tpu.loads("[camera]\ndirection = 'diagonal'\n")
