"""Material scattering as pure, branchless functions.

The reference dispatches through a constexpr function-pointer table indexed
by ``material_type`` (/root/reference/src/renderers/mg_ray_tracer.cpp:142-152,
sm_ray_tracer.cpp:221-236).  Per-ray function pointers don't vectorize
over a flat ray batch; instead every BRDF is evaluated for every ray and
the result is blended with a one-hot select over the material *class* — a
dense "mixture-of-BRDFs" router.

Renderer personalities map the 8 material types onto 3 BRDF classes:

* ``mg`` (mg_ray_tracer.cpp:142-152): metal → metal, everything else →
  lambert (dielectrics included!).
* ``sm`` (sm_ray_tracer.cpp:221-236): metal → metal; dielectric, air,
  vacuum, water, ice → dielectric; lambert & diamond → lambert.

BRDF semantics (bit-for-bit formula parity with the reference):

* lambert (mg_ray_tracer.cpp:109-123): scatter = normalize(normal +
  random_unit_vector()), degenerate → normal; attenuation = albedo.rgb *
  reflectivity.
* metal (mg_ray_tracer.cpp:125-140): scatter = reflect(normalize(dir),
  normal) + roughness * random_unit_vector(); absorbed if scatter·normal
  <= 0; attenuation = albedo.rgb * reflectivity.
* dielectric (sm_ray_tracer.cpp:181-219): the material's ``reflectivity``
  doubles as the IOR; Schlick-probability coin picks reflect vs refract;
  attenuation = albedo.rgb * reflectivity (an IOR-scaled albedo — a
  reference quirk kept for parity).  Note the reference reflects about the
  *geometric* normal (not the outward one) and computes the inside-cosine
  as ior * dot(d, n) — both reproduced.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["ScatterResult", "scatter", "LAMBERT", "METAL", "DIELECTRIC", "personality_classes"]

LAMBERT, METAL, DIELECTRIC = 0, 1, 2

# material_type enum order: lambert, metal, dielectric, air, vacuum, water,
# ice, diamond (common.hpp:105-115).
_MG_CLASSES = (LAMBERT, METAL, LAMBERT, LAMBERT, LAMBERT, LAMBERT, LAMBERT, LAMBERT)
_SM_CLASSES = (LAMBERT, METAL, DIELECTRIC, DIELECTRIC, DIELECTRIC, DIELECTRIC, DIELECTRIC, LAMBERT)


def personality_classes(personality: str) -> jax.Array:
    """Material-type → BRDF-class lookup table for a renderer personality."""
    if personality == "mg":
        return jnp.asarray(_MG_CLASSES, jnp.int32)
    if personality == "sm":
        return jnp.asarray(_SM_CLASSES, jnp.int32)
    raise ValueError(f"unknown personality {personality!r}")


class ScatterResult(NamedTuple):
    direction: jax.Array    # (N, 3) unit scatter direction
    attenuation: jax.Array  # (N, 3)
    absorbed: jax.Array     # (N,) bool — ray dies with zero contribution
    # discrete decision bits, recorded for replay-mode gradients
    # (rt_tpu.replay): fixing these makes the scatter a smooth function of
    # the material/geometry parameters
    reflect_bit: jax.Array  # (N,) bool — dielectric took the reflect branch
    lam_deg: jax.Array      # (N,) bool — lambert degenerate (normal + ruv ~ 0)


from .ops.intersect import safe_normalize


def _reflect(v, n):
    """reflect() (common.hpp:100-103): v - 2 (v·n) n."""
    return v - 2.0 * jnp.sum(v * n, axis=-1, keepdims=True) * n


def scatter(
    materials,
    brdf_class: jax.Array,   # (N,) int32 BRDF class per ray
    mat_idx: jax.Array,      # (N,) int32 material index per ray
    ray_dir: jax.Array,      # (N, 3) unit incoming direction
    normal: jax.Array,       # (N, 3) geometric normal at hit
    unit_rand: jax.Array,    # (N, 3) random_unit_vector() samples
    coin: jax.Array,         # (N,) U[0,1) for the dielectric reflect/refract coin
    decisions=None,          # optional (reflect_bit, lam_deg) overrides (replay mode)
) -> ScatterResult:
    """Evaluate all BRDFs and blend by class.  Differentiable w.r.t. material
    parameters and geometry; the class/coin decisions are detached.

    Material parameters are fetched with a one-hot contraction over the
    (small, padded) material table: its transpose — the material-parameter
    gradient — is another contraction instead of a scatter-add."""
    m = materials.albedo.shape[0]
    mat_onehot = jax.nn.one_hot(mat_idx, m, dtype=jnp.float32)  # (N, M)
    # precision="highest": exact one-hot fetch (a TF32 product on the GPU
    # would round the fetched f32 payload values)
    albedo = jnp.matmul(mat_onehot, materials.albedo,
                        precision="highest")[:, :3]              # (N, 3)
    roughness = jnp.matmul(mat_onehot, materials.roughness,
                           precision="highest")[:, None]         # (N, 1)
    refl = jnp.matmul(mat_onehot, materials.reflectivity,
                      precision="highest")                       # (N,)

    # Shared attenuation formula: albedo * reflectivity
    # (mg_ray_tracer.cpp:115,131; sm_ray_tracer.cpp:194).
    attenuation = albedo * refl[:, None]

    # --- lambert -----------------------------------------------------------
    lam_raw = normal + unit_rand
    lam_n2 = jnp.sum(lam_raw * lam_raw, axis=-1, keepdims=True)
    if decisions is None:
        lam_deg = (lam_n2 < 1e-16)[:, 0]
    else:
        lam_deg = decisions[1]
    lam = jnp.where(lam_deg[:, None], normal, safe_normalize(lam_raw))

    # --- metal -------------------------------------------------------------
    met = _reflect(ray_dir, normal) + roughness * unit_rand
    metal_absorbed = jnp.sum(met * normal, axis=-1) <= 0.0
    met = safe_normalize(met)

    # --- dielectric --------------------------------------------------------
    dn = jnp.sum(ray_dir * normal, axis=-1)            # (N,)
    inside = dn > 0.0
    outward_n = jnp.where(inside[:, None], -normal, normal)
    eta = jnp.where(inside, refl, 1.0 / jnp.maximum(refl, 1e-12))
    cosine = jnp.where(inside, refl * dn, -dn)         # |dir| == 1
    cos_i = -jnp.sum(ray_dir * outward_n, axis=-1)
    sin2_t = eta * eta * (1.0 - cos_i * cos_i)
    tir = sin2_t > 1.0
    # guarded sqrt (grad-safe at the TIR boundary)
    cos_t = jnp.sqrt(jnp.where(tir, 1.0, jnp.maximum(1.0 - sin2_t, 1e-12)))
    cos_t = jnp.where(tir, 0.0, cos_t)
    refracted = eta[:, None] * ray_dir + (eta * cos_i - cos_t)[:, None] * outward_n
    # Schlick uses the *material* IOR regardless of side (sm:211).
    r0 = ((1.0 - refl) / (1.0 + refl)) ** 2
    reflect_prob = jnp.where(tir, 1.0, r0 + (1.0 - r0) * (1.0 - cosine) ** 5)
    if decisions is None:
        reflect_bit = coin < reflect_prob
    else:
        reflect_bit = decisions[0]
    # Reference reflects about the geometric normal (sm:188), not outward_n.
    die_reflected = _reflect(ray_dir, normal)
    die = jnp.where(reflect_bit[:, None], die_reflected, refracted)
    die = safe_normalize(die, fallback=normal)

    # --- blend by class ----------------------------------------------------
    is_metal = brdf_class == METAL
    is_diel = brdf_class == DIELECTRIC
    direction = jnp.where(is_metal[:, None], met, lam)
    direction = jnp.where(is_diel[:, None], die, direction)
    absorbed = is_metal & metal_absorbed
    return ScatterResult(direction=direction, attenuation=attenuation, absorbed=absorbed,
                         reflect_bit=reflect_bit, lam_deg=lam_deg)
