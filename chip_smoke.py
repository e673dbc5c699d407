#!/usr/bin/env python
"""Run the render and gradient path on an NVIDIA GPU at real sizes, and check
it against the CPU backend of the same process.

    python chip_smoke.py           # gates, then the phases, on one card
    python chip_smoke.py --four    # only the sharded paths, on four cards

One card: first the gates, which compare the GPU with ``jax.devices("cpu")``
(deterministic frame, full estimator, replay gradients, finite differences);
then the phases of BASELINE.json configs 2, 3 and 4 through the entry points
a user calls (``renderer.create``, ``python -m rt_tpu.cli``'s ``main``,
``train.make_train_step``), each with its compile and steady seconds, camera
Mrays/s and memory.  ``--four``: the sharded render on 4x1 and 2x2 meshes
and one sharded train step, each against one card.

Every result is printed on a line before the last.  The last line of stdout
is ``{"ok": true, "device": {...}}``, printed only when every gate and phase
passed.  Without a GPU the script exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SCENES = os.path.join(REPO, "scenes")

# (label, scene, personality, size, spp, max_bounces, train steps, cut)
# BASELINE.json configs 2-4.  Config 4 renders its 500-sphere scene at
# 4 spp instead of 128: the phase proves ray chunking and memory at 512
# padded spheres; it does not time the config.
PHASES = (
    ("config 2", "basic.toml", "mg", (800, 600), 16, 8, 3, None),
    ("config 3", "dielectric.toml", "sm", (800, 600), 64, 8, 1, None),
    ("config 4 scene", "procedural:500", "mg", (1920, 1080), 4, 8, 0,
     "4 spp instead of BASELINE.json's 128"),
)


def mc_gate(test, ref, ref2, label):
    """Full-estimator gate: ``test - ref`` (same key) must look like
    ``ref - ref2`` (the reference at an independent key).  The mean gap is
    held to 4 standard errors of the reference's own noise and the mean
    absolute difference to 1.35x its level; an estimator that traces one
    bounce short moves the sky term by many sigma and trips both.
    Returns (ok, message)."""
    d = test - ref
    r = ref - ref2
    se_ref = float(r.std()) / np.sqrt(r.size) + 1e-6
    mad_ref = float(np.abs(r).mean()) + 1e-5
    dmean = abs(float(d.mean()))
    mad = float(np.abs(d).mean())
    ok = dmean <= 4.0 * se_ref and mad <= 1.35 * mad_ref
    same = float(np.all(test == ref, axis=-1).mean())
    return ok, (f"{label}: dmean {dmean:.6g} (limit {4 * se_ref:.6g}), "
                f"MAD {mad:.6g} (limit {1.35 * mad_ref:.6g}), "
                f"bit-identical pixels {same:.6f}")


def det_gate(test, ref, label, frac_limit=1e-3):
    """Deterministic gate: no randomness survives, so at most ``frac_limit``
    of the pixels may differ by more than 2e-5 (FMA contraction and the
    order of sums flip only grazing hits).  Returns (ok, message)."""
    diff = np.abs(test - ref)
    bad = float((diff > 2e-5).mean())
    return bad <= frac_limit, (f"{label}: share of values off by >2e-5 "
                               f"{bad:.6f} (limit {frac_limit}), "
                               f"max diff {float(diff.max()):.6g}")


def _run_on(device, fn, *args):
    """``fn(*args)`` with every input placed on ``device``."""
    import jax

    args = jax.device_put(args, device)
    with jax.default_device(device):
        return jax.block_until_ready(fn(*args))


def _load(name):
    import rt_tpu

    if name.startswith("procedural:"):
        return rt_tpu.scene.make_procedural_scene(int(name.split(":")[1]))
    return rt_tpu.load(os.path.join(SCENES, name))


class Report:
    """Collects gate results; every line goes to stdout as it comes."""

    def __init__(self):
        self.failed = []

    def gate(self, ok, msg):
        print(f"[gate {'ok' if ok else 'FAIL'}] {msg}", flush=True)
        if not ok:
            self.failed.append(msg)

    def line(self, msg):
        print(msg, flush=True)


def gates(rep, dev, cpu, *, size=(200, 150), spp=16, grad_size=(64, 48)):
    """Compare ``dev`` with the ``cpu`` device on small frames."""
    import jax
    import jax.numpy as jnp

    import rt_tpu
    from rt_tpu import diff, integrator

    basic = _load("basic.toml")
    k1, k2 = rt_tpu.rng.make_key(1), rt_tpu.rng.make_key(2)

    # deterministic: 1 spp (the pixel centre), depth 1 — only the primary
    # hit and the sky survive
    det = jax.jit(lambda s, k: integrator.render_image(
        s, size, k, spp=1, max_bounces=1, gamma=False))
    rep.gate(*det_gate(np.asarray(_run_on(dev, det, basic, k1)),
                       np.asarray(_run_on(cpu, det, basic, k1)),
                       f"deterministic basic.toml {size[0]}x{size[1]} 1spp depth 1"))

    for name, personality in (("basic.toml", "mg"), ("dielectric.toml", "sm")):
        s = _load(name)
        full = jax.jit(lambda s, k, p=personality: integrator.render_image(
            s, size, k, spp=spp, max_bounces=8, personality=p))
        rep.gate(*mc_gate(np.asarray(_run_on(dev, full, s, k1)),
                          np.asarray(_run_on(cpu, full, s, k1)),
                          np.asarray(_run_on(cpu, full, s, k2)),
                          f"estimator {name} {personality} {size[0]}x{size[1]} "
                          f"{spp}spp depth 8"))

    # replay gradients, every parameter key: rtol 1e-3, and an atol of 1e-5
    # or 1e-3 of the key's largest gradient, whichever is larger.  An element
    # that sums over every pixel (camera pose) picks up the few samples whose
    # path flips between the backends (FMA contraction, order of sums; the
    # forward frames above share that cause), so its absolute error grows
    # with the key's scale: on an H100, dielectric camera.rotation differs by
    # 6.5e-5 where its largest gradient is 0.155.
    w, h = grad_size
    target = jnp.full((h, w, 3), 0.25, jnp.float32)
    for name, personality in (("basic.toml", "mg"), ("dielectric.toml", "sm")):
        s = _load(name)
        vg = jax.jit(lambda p, t, k, s=s, pers=personality: diff.loss_and_grad(
            p, s, t, grad_size, k, spp=2, max_bounces=4, personality=pers))
        params = diff.extract_params(s)
        _, g_dev = _run_on(dev, vg, params, target, k1)
        _, g_cpu = _run_on(cpu, vg, params, target, k1)
        for key in params:
            a, b = np.asarray(g_dev[key]), np.asarray(g_cpu[key])
            err = float(np.abs(a - b).max())
            scale = float(np.abs(b).max())
            atol = max(1e-5, 1e-3 * scale)
            rep.gate(np.allclose(a, b, rtol=1e-3, atol=atol),
                     f"replay grad {name} {personality} {w}x{h} 2spp depth 4 "
                     f"{key}: max |gpu-cpu| {err:.6g}, max |cpu| {scale:.6g} "
                     f"(limit rtol 1e-3, atol {atol:.6g})")

    # finite differences through the device's own loss (bench.py's check)
    fw, fh = size
    an, fd, ok = _run_on(dev, lambda p, s, t, k: diff.fd_check(
        p, s, t, size, k, "materials.reflectivity", 0, spp=2, max_bounces=4),
        diff.extract_params(basic), basic, jnp.zeros((fh, fw, 3), jnp.float32),
        rt_tpu.rng.make_key(0))
    rep.gate(ok, f"FD on the device, basic.toml {fw}x{fh} 2spp depth 4 "
                 f"materials.reflectivity[0]: analytic {an:.6g}, fd {fd:.6g} "
                 "(limit |an-fd| <= max(2e-2 |fd|, 1e-4))")


def _memory(compiled, dev):
    mem = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    analysis = {f: getattr(mem, f, None) for f in fields} if mem is not None else None
    stats = dev.memory_stats() or {}
    return (f"memory_analysis {analysis}, "
            f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}")


def _compile(fn, *args):
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def forward_phase(rep, card, dev, label, render, scene, size, spp, bounces,
                  key, iters=3):
    """Compile the frame, call it once, then time ``iters`` calls."""
    import jax

    w, h = size
    scene, key = jax.device_put((scene, key), dev)
    compiled, t_compile = _compile(
        lambda s, k: render(s, size, k, spp=spp, max_bounces=bounces),
        scene, key)
    img = jax.block_until_ready(compiled(scene, key))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        img = jax.block_until_ready(compiled(scene, key))
        times.append(time.perf_counter() - t0)
    img = np.asarray(img)
    if img.shape != (h, w, 3) or not np.isfinite(img).all():
        raise RuntimeError(f"{label}: bad frame, shape {img.shape}, "
                           f"finite {np.isfinite(img).all()}")
    steady = statistics.median(times)
    rep.line(f"[phase] {label} forward {w}x{h} @{spp}spp depth {bounces} "
             f"on {card}: compile {t_compile:.6f} s, steady {steady:.6f} s "
             f"(median of {iters}), {w * h * spp / steady / 1e6:.6f} camera "
             f"Mrays/s, mean {img.mean():.6f}, {_memory(compiled, dev)}")
    return img


def train_phase(rep, card, dev, label, scene, target, size, spp, bounces,
                personality, steps, key):
    """``train.make_train_step`` (replay gradients) over every key of
    ``diff.extract_params``: compile, then ``steps`` steps; the first step
    after compiling is not counted as steady when there are more."""
    import jax
    import optax

    import rt_tpu
    from rt_tpu import diff, train

    w, h = size
    opt = optax.adam(1e-2)
    params = diff.extract_params(scene)
    # start away from the target's parameters so the loss has a gradient
    # beyond the Monte-Carlo noise
    params["materials.albedo"] = params["materials.albedo"] * 0.8
    step = train.make_train_step(opt, scene, target, size, spp=spp,
                                 max_bounces=bounces, personality=personality)
    state = jax.device_put((params, opt.init(params)), dev)
    key = jax.device_put(key, dev)
    t0 = time.perf_counter()
    compiled = step.lower(*state, key).compile()
    t_compile = time.perf_counter() - t0
    start = {k: np.asarray(v) for k, v in params.items()}
    times, losses = [], []
    p, o = state
    for i in range(steps):
        t0 = time.perf_counter()
        p, o, loss = jax.block_until_ready(compiled(p, o, rt_tpu.rng.fold(key, i)))
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    p = {k: np.asarray(v) for k, v in p.items()}
    if not np.isfinite(losses).all() or not all(np.isfinite(v).all() for v in p.values()):
        raise RuntimeError(f"{label}: non-finite loss or parameters, losses {losses}")
    # a key whose gradient is zero everywhere (e.g. roughness in a scene
    # whose metal is never reached) keeps its value under Adam
    unchanged = [k for k in p if np.array_equal(p[k], start[k])]
    steady_times = times[1:] or times
    steady = statistics.median(steady_times)
    rep.line(f"[phase] {label} train step {w}x{h} @{spp}spp depth {bounces} "
             f"({len(p)} parameter keys, replay) on {card}: compile "
             f"{t_compile:.6f} s, steady {steady:.6f} s (median of "
             f"{len(steady_times)}; step times {times}), "
             f"{w * h * spp / steady / 1e6:.6f} camera Mrays/s, losses {losses}, "
             f"keys left unchanged {unchanged}, {_memory(compiled, dev)}")


def cli_phase(rep, dev, size, spp, bounces, expected):
    """The same frame through the CLI's ``main`` (``python -m rt_tpu.cli``),
    in this process; its .npy output must match the renderer's frame."""
    import jax

    from rt_tpu import cli

    w, h = size
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cli.npy")
        argv = ["--scene", os.path.join(SCENES, "basic.toml"), "--renderer", "mg",
                "--size", f"{w}x{h}", "--spp", str(spp), "--bounces", str(bounces),
                "--out", out]
        rep.line(f"[phase] cli: python -m rt_tpu.cli {' '.join(argv)}")
        with jax.default_device(dev):
            rc = cli.main(argv)
        if rc != 0:
            raise RuntimeError(f"cli exited {rc}")
        img = np.load(out)
    mad = float(np.abs(img - expected).mean())
    rep.gate(img.shape == expected.shape and mad <= 1e-3,
             f"cli frame vs renderer frame (same key): shape {img.shape}, "
             f"mean |diff| {mad:.6g} (limit 1e-3)")


def phases(rep, card, dev, *, size_div=1, spp_div=1):
    """BASELINE.json configs 2-4 (``PHASES``); the divisors shrink the
    shapes for a rehearsal on the CPU."""
    import rt_tpu
    from rt_tpu import renderer

    key = rt_tpu.rng.make_key(0)
    for label, name, personality, size, spp, bounces, steps, cut in PHASES:
        size = (size[0] // size_div, size[1] // size_div)
        spp = max(spp // spp_div, 1)
        if cut:
            rep.line(f"[cut] {label}: {cut}")
        scene = _load(name)
        img = forward_phase(rep, card, dev, label,
                            renderer.create(personality), scene, size, spp,
                            bounces, key)
        if name == "basic.toml":
            cli_phase(rep, dev, size, spp, bounces, img)
        if steps:
            # target: the scene's own frame, pre-gamma
            train_phase(rep, card, dev, label, scene, img.astype(np.float32) ** 2,
                        size, spp, bounces, personality, steps, key)


def _assert_spread(rep, out, devs, label):
    """Each shard of ``out`` lives on its own card of ``devs``."""
    shard_devs = {s.device for s in out.addressable_shards}
    ok = out.sharding.device_set == set(devs) and len(shard_devs) == len(devs)
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use") for d in devs]
    rep.gate(ok, f"{label}: output shards on devices "
                 f"{sorted(d.id for d in shard_devs)}; peak_bytes_in_use per "
                 f"device {peaks}")


def four(rep, card, devs, *, size=(800, 600), spp=16, bounces=8, ray_chunk=65536,
         train_size=(256, 192), train_spp=4, train_chunk=4096):
    """The multi-card paths against one card: sharded render on 4x1 and 2x2
    meshes, and one sharded train step."""
    import jax
    import jax.numpy as jnp
    import optax

    import rt_tpu
    from rt_tpu import diff, dist, integrator, train

    if len(devs) != 4 or len({d.id for d in devs}) != 4:
        raise RuntimeError(f"--four needs four distinct devices, got {devs}")
    scene = _load("basic.toml")
    key = rt_tpu.rng.make_key(0)
    w, h = size

    single = jax.jit(lambda s, k: integrator.render_image(
        s, size, k, spp=spp, max_bounces=bounces, ray_chunk=ray_chunk))
    ref = np.asarray(_run_on(devs[0], single, scene, key))

    for n_rays, n_prims in ((4, 1), (2, 2)):
        mesh = dist.make_mesh(n_rays, n_prims, devices=devs)
        label = f"sharded render {n_rays}x{n_prims} {w}x{h} @{spp}spp depth {bounces}"
        sharded, t_compile = _compile(
            lambda s, k, mesh=mesh: dist.render_image_sharded(
                s, size, k, mesh, spp=spp, max_bounces=bounces,
                ray_chunk=ray_chunk), scene, key)
        out = jax.block_until_ready(sharded(scene, key))
        t0 = time.perf_counter()
        out = jax.block_until_ready(sharded(scene, key))
        steady = time.perf_counter() - t0
        rep.line(f"[phase] {label} on {card}: compile {t_compile:.6f} s, "
                 f"steady {steady:.6f} s, {w * h * spp / steady / 1e6:.6f} "
                 f"camera Mrays/s")
        _assert_spread(rep, out, devs, label)
        img = np.asarray(out)
        if n_prims == 1:
            rep.gate(np.array_equal(img, ref),
                     f"{label} vs one card: bit-identical "
                     f"(max diff {float(np.abs(img - ref).max()):.6g})")
        else:
            rep.gate(*det_gate(img, ref, f"{label} vs one card"))

    # one sharded train step; its psum'd gradients against one card's
    tw, th = train_size
    mesh = dist.make_mesh(2, 2, devices=devs)
    target = jnp.full((th, tw, 3), 0.25, jnp.float32)
    params = diff.extract_params(scene)
    opts = dict(spp=train_spp, max_bounces=bounces, ray_chunk=train_chunk)

    def sharded_render(sc, sz, k, **o):
        return dist.render_image_sharded(sc, sz, k, mesh, **o)

    vg_one = jax.jit(lambda p, k: diff.loss_and_grad(
        p, scene, target, train_size, k, **opts))
    vg_mesh = jax.jit(lambda p, k: diff.loss_and_grad(
        p, scene, target, train_size, k, render_fn=sharded_render, **opts))
    _, g_one = _run_on(devs[0], vg_one, params, key)
    _, g_mesh = jax.block_until_ready(vg_mesh(params, key))
    for k in params:
        a, b = np.asarray(g_mesh[k]), np.asarray(g_one[k])
        rep.gate(np.allclose(a, b, rtol=1e-4, atol=1e-8),
                 f"sharded 2x2 grad {tw}x{th} @{train_spp}spp depth {bounces} {k}: "
                 f"max |mesh-one| {float(np.abs(a - b).max()):.6g}, "
                 f"max |one| {float(np.abs(b).max()):.6g} (limit rtol 1e-4)")

    opt = optax.adam(1e-2)
    step = train.make_train_step(opt, scene, target, train_size,
                                 render_fn=sharded_render, **opts)
    p, _, loss = jax.block_until_ready(step(params, opt.init(params), key))
    ok = np.isfinite(float(loss)) and all(
        np.isfinite(np.asarray(v)).all() for v in p.values())
    rep.gate(ok, f"sharded 2x2 train step (make_train_step): loss {float(loss):.6g}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded paths, on four cards")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    import jax

    from rt_tpu import runtime

    # the gates compare with this process's CPU backend
    platforms = jax.config.jax_platforms
    if platforms and "cpu" not in platforms.split(","):
        jax.config.update("jax_platforms", platforms + ",cpu")
    runtime.use_compile_cache()
    devs = runtime.require_gpu()
    cards = runtime.gpu_name_and_power().splitlines()
    rep = Report()
    for line in cards:
        rep.line(f"card (name, power limit): {line}")
    card = "; ".join(dict.fromkeys(cards)) + (f" (x{len(cards)})" if len(cards) > 1 else "")
    rep.line(f"jax {jax.__version__}, devices {devs}")
    t0 = time.perf_counter()
    if args.four:
        four(rep, card, devs[:4])
    else:
        gates(rep, devs[0], jax.devices("cpu")[0])
        phases(rep, card, devs[0])
    rep.line(f"wall {time.perf_counter() - t0:.3f} s")
    if rep.failed:
        rep.line(f"{len(rep.failed)} gate(s) failed")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
