"""Process set-up shared by the entry points (CLI, bench.py, chip_smoke.py):
the persistent compilation cache and the accelerator check.

Nothing here runs at import; each entry point calls what it needs.
"""

from __future__ import annotations

import os
import subprocess
from typing import Mapping, Optional

import jax

__all__ = ["compile_cache_dir", "use_compile_cache", "require_gpu", "gpu_name_and_power"]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir(environ: Mapping[str, str] = os.environ) -> Optional[str]:
    """Directory the program should set as JAX's compilation cache, or None
    when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads it itself).  The
    fallback is a fixed path: the path is part of the cache key, so a
    directory that moves never hits."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(REPO, ".jax_cache")


def use_compile_cache() -> None:
    """Keep compiled programs across processes (see :func:`compile_cache_dir`)."""
    path = compile_cache_dir()
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)


def require_gpu() -> list:
    """The GPU devices; raises RuntimeError when JAX finds none.  Measurement
    paths call this so that a run without the card fails instead of timing
    the CPU backend under a device metric's name."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default backend is {devs[0].platform!r} "
            f"({len(devs)} device(s)); this measurement needs the card")
    return devs


def gpu_name_and_power() -> str:
    """``name, power.limit`` of each card, one per line, as nvidia-smi
    reports them.  Runs as a child process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
