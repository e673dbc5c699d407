#!/usr/bin/env python
"""Big-scene inverse rendering: optimize albedos in a procedural N-sphere
scene with ``train.make_train_step`` and replay gradients.

Replay mode (rt_tpu.replay) records the discrete path structure in the
forward pass and differentiates a cheap replay of it, so the backward pass
never transposes the (rays x spheres) closest-hit scan; the scene tables
are traced parameters, so a full optax loop runs with zero recompiles.

Usage:
    python examples/big_scene_training.py --spheres 500
    python examples/big_scene_training.py --cpu --spheres 24   # small, on the CPU
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spheres", type=int, default=500)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--size", default=None, help="WxH (default 400x300)")
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU backend (use a small --spheres)")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import optax

    import rt_tpu
    from rt_tpu import diff, train

    if args.size:
        w, h = (int(x) for x in args.size.split("x"))
    else:
        w, h = (96, 64) if args.cpu else (400, 300)

    scene = rt_tpu.scene.make_procedural_scene(args.spheres)
    true_params = diff.extract_params(scene)
    opts = dict(spp=args.spp, max_bounces=4)

    # target = render with the true albedos (pre-gamma, like every loss in
    # rt_tpu.diff); start from gray
    target = diff.render_for_loss(true_params, scene, (w, h),
                                  rt_tpu.rng.make_key(0), **opts)
    params = {"materials.albedo": jnp.full_like(true_params["materials.albedo"], 0.5)}

    optimizer = optax.adam(5e-2)
    step = train.make_train_step(optimizer, scene, target, (w, h),
                                 grad_mode="replay", **opts)
    opt_state = optimizer.init(params)
    key = rt_tpu.rng.make_key(1)

    t0 = time.perf_counter()
    for i in range(args.steps):
        params, opt_state, loss = step(params, opt_state, rt_tpu.rng.fold(key, i))
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(loss):.6f}")
    jax.block_until_ready(loss)
    dt = (time.perf_counter() - t0) / args.steps
    # the inverse problem is under-constrained at demo sizes (some of the
    # 12 materials barely appear in the image), so albedo recovery is not
    # the right success metric — image-space error against a held-out
    # render (fresh key) is what the loss actually optimizes
    holdout_key = rt_tpu.rng.make_key(12345)

    def render_with(albedo):
        return diff.render_for_loss({"materials.albedo": albedo}, scene, (w, h),
                                    holdout_key, **opts)

    holdout = render_with(true_params["materials.albedo"])
    gray = jnp.full_like(true_params["materials.albedo"], 0.5)
    e0 = float(jnp.abs(render_with(gray) - holdout).mean())
    e1 = float(jnp.abs(render_with(params["materials.albedo"]) - holdout).mean())
    print(f"{dt * 1e3:.1f} ms/step (first step includes compilation); "
          f"held-out image MAE {e0:.4f} -> {e1:.4f}")


if __name__ == "__main__":
    main()
