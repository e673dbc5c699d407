"""rt_tpu — a differentiable path tracer in JAX.

A from-scratch JAX/XLA re-design of the capabilities of marzer/rt
(the reference C++ software renderer at /root/reference): TOML scenes,
pinhole camera, SoA sphere/plane/box intersection, lambert/metal/dielectric
scattering, Monte-Carlo accumulation — implemented as a vectorized
wavefront over device meshes, fully differentiable w.r.t. scene parameters.

Layer map (cf. SURVEY.md §1):
  colour     — colour model + named colours          (L1)
  scene      — SoA pytree tables + TOML loader       (L2, L3)
  camera     — pinhole projection + raygen           (L3)
  image      — framebuffer + PNG/PPM/NPY export      (L4)
  renderer   — renderer registry                     (L5)
  rng        — counter-based threefry streams        (L6)
  ops        — ray/primitive intersection kernels    (hot path)
  materials  — branchless BRDF blend                 (hot path)
  integrator — wavefront bounce loop                 (hot path)
  dist       — meshes, sharding, multi-host          (new: scaling)
  diff       — gradient helpers                      (new: differentiability)
  cli        — argparse CLI mirroring the reference  (L8)
"""

from . import camera, colour, image, integrator, materials, ops, renderer, rng, scene
from .scene import Scene, load, load_first_available, loads

__version__ = "0.1.0"

__all__ = [
    "camera",
    "colour",
    "image",
    "integrator",
    "materials",
    "ops",
    "renderer",
    "rng",
    "scene",
    "Scene",
    "load",
    "load_first_available",
    "loads",
    "__version__",
]
