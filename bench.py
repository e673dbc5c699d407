#!/usr/bin/env python
"""rt_tpu benchmark: forward+backward Mrays/s on the GPU, basic.toml 800x600@4spp.

Prints ONE JSON line: the device rate with the device it ran on
(``platform``, ``device_kind``, ``device_count``, and ``card``: the
card's name and power limit), the ``pipeline`` that ran, and the native C++ CPU
tracer's forward rate as its own labelled number.  Without a GPU it fails;
it never times the CPU backend under the device metric's name.

"Rays" counts camera rays (W*H*spp) per fwd+bwd step.  The native tracer
(native/rt_native.cpp) is the reference's documented renderer semantics
compiled with the reference's release flags and a thread pool, measured
*forward only* (the reference has no backward); its measurement is cached
in .baseline_cpu.json.

    python bench.py [--quick] [--size WxH] [--spp N] [--iters N]
    python bench.py --scaling      # rays/s over meshes of 1, 2, 4... devices
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

BASELINE_CACHE = os.path.join(REPO, ".baseline_cpu.json")
BASIC = os.path.join(REPO, "scenes", "basic.toml")
PIPELINE = "jnp autodiff: jax.value_and_grad(diff.image_loss), grad_mode='autodiff'"


def measure_cpu_baseline(scene, size, spp, max_bounces) -> float:
    """Mrays/s of the native CPU tracer (cached); 0.0 if it cannot be built."""
    key = f"{size[0]}x{size[1]}x{spp}x{max_bounces}"
    cache = {}
    if os.path.exists(BASELINE_CACHE):
        try:
            with open(BASELINE_CACHE) as f:
                cache = json.load(f)
        except (OSError, ValueError):
            cache = {}
        if key in cache:
            return cache[key]
    from rt_tpu import _native

    if not _native.available():
        os.system(f"make -C {os.path.join(REPO, 'native')} >/dev/null 2>&1")
        _native._TRIED = False
    if not _native.available():
        return 0.0
    # warm-up + timed
    _native.render_mg_cpu(scene, size, spp=1, max_bounces=max_bounces)
    _, secs = _native.render_mg_cpu(scene, size, spp=spp, max_bounces=max_bounces)
    mrays = size[0] * size[1] * spp / secs / 1e6
    cache[key] = mrays
    with open(BASELINE_CACHE, "w") as f:
        json.dump(cache, f)
    return mrays


def device_fields(devices) -> dict:
    from rt_tpu import runtime

    return {
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
        # name and power limit, as nvidia-smi reports them
        "card": runtime.gpu_name_and_power(),
    }


def scaling(args, devices) -> None:
    """Rays/s over meshes of 1, 2, 4... devices, and the efficiency against
    the 1-device rate.  One JSON line per mesh size."""
    import jax

    import rt_tpu
    from rt_tpu import dist

    scene = rt_tpu.load(BASIC)
    key = rt_tpu.rng.make_key(0)
    size = (512, 384)
    spp = args.spp or 4
    base_rate = None
    n = 1
    fields = device_fields(devices)
    while n <= len(devices):
        mesh = dist.make_mesh(n, 1, devices=devices[:n])

        def render():
            return dist.render_image_sharded(
                scene, size, key, mesh, spp=spp, max_bounces=8,
                ray_chunk=4096)

        jax.block_until_ready(render())  # compile + warm
        t0 = time.perf_counter()
        iters = 4
        for _ in range(iters):
            out = render()
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / iters
        rate = size[0] * size[1] * spp / dt / 1e6
        if base_rate is None:
            base_rate = rate
        print(json.dumps({
            "metric": f"scaling rays/s ({n} devices)",
            "value": rate, "unit": "Mrays/s",
            "efficiency": rate / (base_rate * n),
            "pipeline": "dist.render_image_sharded, mesh (n, 1)",
            **fields,
        }))
        n *= 2


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="tiny smoke run")
    ap.add_argument("--size", default=None, help="WxH override")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--scaling", action="store_true",
                    help="mesh scaling-efficiency ladder instead of the "
                         "headline fwd+bwd benchmark")
    ap.add_argument("--iters", type=int, default=32,
                    help="steps per timed window; the metric is the MEDIAN "
                         "over 9 async-pipelined windows (blocked once per "
                         "window), via rt_tpu.profiling.sustained")
    args = ap.parse_args()

    from rt_tpu import runtime

    runtime.use_compile_cache()
    devices = runtime.require_gpu()
    if args.scaling:
        scaling(args, devices)
        return

    import jax
    import jax.numpy as jnp
    import numpy as np

    import rt_tpu
    from rt_tpu import diff
    from rt_tpu.profiling import sustained

    if args.quick:
        size, spp, max_bounces, iters = (160, 120), 2, 4, 1
    else:
        size, spp, max_bounces, iters = (800, 600), 4, 8, args.iters
    if args.size:
        w, h = args.size.split("x")
        size = (int(w), int(h))
    if args.spp:
        spp = args.spp

    scene = rt_tpu.load(BASIC)
    key = rt_tpu.rng.make_key(0)
    params = diff.extract_params(scene)
    target = jnp.zeros((size[1], size[0], 3), jnp.float32)

    @jax.jit
    def fwd_bwd(params, key):
        return jax.value_and_grad(diff.image_loss)(
            params, scene, target, size, key, spp=spp,
            max_bounces=max_bounces, grad_mode="autodiff",
        )

    stats = sustained(lambda i: fwd_bwd(params, rt_tpu.rng.fold(key, i))[1],
                      iters=iters, windows=1 if args.quick else 9)
    _, grads = fwd_bwd(params, key)

    def rate(secs):
        return size[0] * size[1] * spp / secs / 1e6

    # gradient sanity: finite + a smooth-path FD check on reflectivity
    grad_ok = bool(all(np.all(np.isfinite(np.asarray(g))) for g in grads.values()))
    if grad_ok and not args.quick:
        small = (200, 150)
        _, _, grad_ok = diff.fd_check(
            params, scene, jnp.zeros((small[1], small[0], 3), jnp.float32),
            small, key, "materials.reflectivity", 0, spp=2, max_bounces=4)

    print(json.dumps({
        "metric": "fwd+bwd Mrays/s (basic.toml %dx%d @ %dspp, depth %d, grad_ok=%s)"
                  % (size[0], size[1], spp, max_bounces, grad_ok),
        "value": rate(stats["median"]),
        "unit": "Mrays/s",
        # dispersion across the measured windows (median is the headline)
        "spread": [rate(stats["max"]), rate(stats["min"])],
        "pipeline": PIPELINE,
        **device_fields(devices),
        "native_cpu_fwd_mrays": measure_cpu_baseline(scene, size, spp, max_bounces),
    }))


if __name__ == "__main__":
    main()
