"""Counter-based RNG streams.

The reference uses a thread-local ``std::mt19937`` seeded from
``std::random_device`` (/root/reference/src/random.cpp:9-17) — fast but
non-reproducible and meaningless on a SPMD machine.  This design replaces
it with JAX's counter-based threefry: one base key, deterministically
folded per (bounce, sample-batch, shard), then a single large ``uniform``
draw per step feeds every ray lane at once.

Distribution-parity notes (the estimator must match the reference's):

* ``rt::random<float>`` is U[0,1) (random.cpp:22-26); ``random<vecN>`` draws
  independent components (random.hpp:37-53).
* ``random_unit_vector()`` (random.hpp:57-66) normalizes a U[0,1)^3 sample —
  i.e. it is **biased to the positive octant**, not uniform on the sphere.
  ``unit_vector(..., mode="reference")`` reproduces that; ``mode="sphere"``
  gives a properly uniform direction for non-parity use.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["make_key", "fold", "uniform", "unit_vector"]


def make_key(seed: int = 0) -> jax.Array:
    return jax.random.key(seed)


def fold(key: jax.Array, *ids) -> jax.Array:
    """Derive a subkey by folding in a chain of integer identifiers
    (bounce index, sample index, shard index, ...)."""
    for i in ids:
        key = jax.random.fold_in(key, i)
    return key


def uniform(key: jax.Array, shape, dtype=jnp.float32) -> jax.Array:
    """U[0,1) of the requested shape."""
    return jax.random.uniform(key, shape, dtype=dtype)


def unit_vector(key: jax.Array, shape=(), *, mode: str = "reference") -> jax.Array:
    """Random direction(s) of shape ``shape + (3,)``.

    mode="reference": normalize(U[0,1)^3), the reference's positive-octant
    biased distribution (random.hpp:57-66).  The reference retries on an
    exactly-zero sample; that event has ~2^-96 probability, here the guard
    substitutes the normalized one-vector.

    mode="sphere": uniform on the unit sphere (normalized Gaussian).
    """
    if mode == "reference":
        p = jax.random.uniform(key, tuple(shape) + (3,), dtype=jnp.float32)
        n = jnp.linalg.norm(p, axis=-1, keepdims=True)
        inv_sqrt3 = jnp.float32(0.5773502691896258)
        return jnp.where(n > 0.0, p / jnp.maximum(n, 1e-30), inv_sqrt3)
    elif mode == "sphere":
        p = jax.random.normal(key, tuple(shape) + (3,), dtype=jnp.float32)
        n = jnp.linalg.norm(p, axis=-1, keepdims=True)
        return p / jnp.maximum(n, 1e-12)
    raise ValueError(f"unknown unit_vector mode {mode!r}")
