"""Renderer registry.

Mirrors the reference's plugin layer (/root/reference/src/renderer.hpp:9-41,
renderer.cpp:11-69): renderers self-register into a process-wide registry
under a unique key (the reference uses ``__FILE__:__LINE__:Type``; here
``module:qualname``), are listed by ``all()``, found by key or exact name,
and the CLI resolves fuzzy prefixes (main.cpp:67-81).

A renderer is a callable ``render(scene, size, key, **opts) -> (H, W, 3)``
float32 radiance image.  ``register_renderer`` is the analogue of the
``REGISTER_RENDERER(T)`` macro (renderer.hpp:34-41).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

__all__ = [
    "Description",
    "install",
    "all_renderers",
    "find_by_key",
    "find_by_name",
    "find_by_name_fuzzy",
    "register_renderer",
    "create",
]


@dataclasses.dataclass(frozen=True)
class Description:
    key: str
    name: str
    create: Callable[[], Callable]


_REGISTRY: list[Description] = []


def install(desc: Description) -> None:
    """Idempotent by key (renderer.cpp:21-37)."""
    for d in _REGISTRY:
        if d.key == desc.key:
            return
    _REGISTRY.append(desc)


def all_renderers() -> tuple[Description, ...]:
    return tuple(_REGISTRY)


def find_by_key(key: str) -> Optional[Description]:
    for d in _REGISTRY:
        if d.key == key:
            return d
    return None


def find_by_name(name: str) -> Optional[Description]:
    for d in _REGISTRY:
        if d.name == name:
            return d
    return None


def find_by_name_fuzzy(name: str) -> Optional[Description]:
    """Exact match first, else first registered whose name starts with the
    query (main.cpp:67-81)."""
    if not name:
        return None
    d = find_by_name(name)
    if d is not None:
        return d
    for d in _REGISTRY:
        if d.name.startswith(name):
            return d
    return None


def register_renderer(name: str, factory: Callable[[], Callable]) -> None:
    install(Description(key=f"{factory.__module__}:{name}", name=name, create=factory))


def create(name: str) -> Callable:
    """Create a renderer by (fuzzy) name; raises KeyError if unknown."""
    d = find_by_name_fuzzy(name)
    if d is None:
        raise KeyError(f"no known renderer with name '{name}'")
    return d.create()


def _install_builtins() -> None:
    from . import integrator

    def _mg():
        def render(scene, size, key, **opts):
            opts.setdefault("personality", "mg")
            return integrator.render_image(scene, size, key, **opts)
        return render

    def _sm():
        def render(scene, size, key, **opts):
            opts.setdefault("personality", "sm")
            return integrator.render_image(scene, size, key, **opts)
        return render

    def _raster():
        return integrator.render_rasterizer

    def _null():
        return integrator.render_null

    # Registration order matches the reference's renderer cycling UX
    # (main.cpp:181-191 iterates registry order).
    register_renderer("mg_ray_tracer", _mg)
    register_renderer("sm_ray_tracer", _sm)
    register_renderer("rasterizer", _raster)
    register_renderer("null_renderer", _null)


_install_builtins()
