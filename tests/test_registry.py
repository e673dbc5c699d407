import pytest

from rt_tpu import renderer as reg


def test_builtins_registered_in_order():
    names = [d.name for d in reg.all_renderers()]
    # exactly the reference's four renderers (renderers/*.cpp)
    assert names == ["mg_ray_tracer", "sm_ray_tracer", "rasterizer", "null_renderer"]


def test_find_by_name_and_key():
    d = reg.find_by_name("rasterizer")
    assert d is not None and d.name == "rasterizer"
    assert reg.find_by_key(d.key) is d
    assert reg.find_by_name("nope") is None


def test_fuzzy_prefix_match():
    # main.cpp:67-81: exact match first, else first name starting with query
    assert reg.find_by_name_fuzzy("mg").name == "mg_ray_tracer"
    assert reg.find_by_name_fuzzy("sm").name == "sm_ray_tracer"
    assert reg.find_by_name_fuzzy("ra").name == "rasterizer"
    assert reg.find_by_name_fuzzy("null_renderer").name == "null_renderer"
    assert reg.find_by_name_fuzzy("") is None
    assert reg.find_by_name_fuzzy("zzz") is None


def test_install_idempotent_by_key():
    n = len(reg.all_renderers())
    d = reg.all_renderers()[0]
    reg.install(d)
    assert len(reg.all_renderers()) == n


def test_create_unknown_raises():
    with pytest.raises(KeyError):
        reg.create("does_not_exist")


def test_create_returns_callable():
    r = reg.create("null")
    assert callable(r)
