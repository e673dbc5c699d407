"""Tracing / profiling utilities.

The reference has no profiling at all (SURVEY.md §5: vsync pacing only).
Here: wall-clock render timers with Mrays/s (the north-star metric),
optional jax.profiler trace capture, and a tiny counter registry.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import jax

__all__ = ["RenderTimer", "trace", "counters", "mrays_per_sec", "sustained"]

counters: dict[str, float] = {}


def sustained(step, iters: int = 32, windows: int = 5,
              warmup_windows: int = 1) -> dict:
    """Steady-state step time as bench.py measures it.

    Runs ``step(i)`` in ``windows`` async-pipelined windows of ``iters``
    calls (blocked once per window — the steady serving/training shape;
    a single blocked call would also time the host round trip).  After
    ``warmup_windows`` discarded warm-up windows, reports the MEDIAN
    per-step seconds plus min/max across windows.

    Returns {"median": s, "min": s, "max": s, "windows": [s...]}.
    """
    out = step(0)
    jax.block_until_ready(out)
    ws = []
    for w in range(warmup_windows + windows):
        t0 = time.perf_counter()
        for i in range(iters):
            out = step(i)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / iters
        if w >= warmup_windows:
            ws.append(dt)
    ws.sort()
    return {
        "median": ws[len(ws) // 2],
        "min": ws[0],
        "max": ws[-1],
        "windows": ws,
    }


def mrays_per_sec(size: tuple[int, int], spp: int, seconds: float) -> float:
    """Camera rays per second in millions (rays = W*H*spp)."""
    w, h = size
    return w * h * spp / seconds / 1e6


class RenderTimer:
    """Context manager timing a render; blocks on the result.

    >>> with RenderTimer((800, 600), spp=4) as t:
    ...     img = render(...)
    ...     t.result = img
    >>> t.mrays
    """

    def __init__(self, size: tuple[int, int], spp: int, name: str = "render"):
        self.size = size
        self.spp = spp
        self.name = name
        self.result = None
        self.seconds = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.result is not None:
            jax.block_until_ready(self.result)
        self.seconds = time.perf_counter() - self._t0
        counters[f"{self.name}.seconds"] = self.seconds
        counters[f"{self.name}.mrays"] = self.mrays
        return False

    @property
    def mrays(self) -> float:
        return mrays_per_sec(self.size, self.spp, max(self.seconds, 1e-12))


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/rt_tpu_trace"):
    """Capture a jax.profiler trace around a block (view with XProf/TensorBoard)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
