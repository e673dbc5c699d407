"""Command-line interface.

Mirrors the reference app driver (/root/reference/src/main.cpp:331-366):

* ``--list`` prints the registered renderers and exits (main.cpp:355-360).
* ``--scene``: path, ``-`` for stdin, or empty → first *.toml under the
  search prefixes (scene.cpp:620-643).
* ``--renderer``: fuzzy prefix resolution, default ``mg`` (main.cpp:346-351).

An accelerator host has no SDL window, so the interactive loop becomes:
render → write an image file, with ``--watch`` reproducing the hot-reload
loop (mtime polled every 0.5 s, main.cpp:235-249; a failed reload logs the
error and keeps the previous scene, main.cpp:127-132).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

__all__ = ["main", "build_parser"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="rt",
        description="rt_tpu — a differentiable path tracer in JAX",
    )
    ap.add_argument("-l", "--list", action="store_true",
                    help="list available renderers and exit")
    ap.add_argument("-s", "--scene", default="",
                    help="scene TOML path ('-' = stdin; default: first .toml found)")
    ap.add_argument("-r", "--renderer", default="mg",
                    help="renderer name (fuzzy prefix; default mg_ray_tracer)")
    ap.add_argument("-o", "--out", default="out.png",
                    help="output image path (.png/.ppm/.npy)")
    ap.add_argument("--size", default="800x600", help="WxH (default 800x600)")
    ap.add_argument("--spp", type=int, default=None,
                    help="samples per pixel (default: scene's)")
    ap.add_argument("--bounces", type=int, default=None,
                    help="max bounces (default: scene's)")
    ap.add_argument("--seed", type=int, default=0, help="RNG seed")
    ap.add_argument("--mesh", default="",
                    help="shard over devices, e.g. '8' (rays) or '4x2' (rays x prims)")
    ap.add_argument("--procedural", type=int, default=0, metavar="N",
                    help="render the procedural N-sphere benchmark scene "
                         "(BASELINE configs 4/5) instead of a TOML file")
    ap.add_argument("--watch", action="store_true",
                    help="re-render whenever the scene file changes (0.5 s mtime poll)")
    ap.add_argument("-i", "--interactive", action="store_true",
                    help="ANSI terminal viewer with FPS controls (the "
                         "reference's SDL window, sans SDL)")
    ap.add_argument("--preview", action="store_true",
                    help="print an ANSI preview of the render to the terminal")
    ap.add_argument("--boxes", action="store_true",
                    help="enable real box intersection in the path tracers "
                         "(the reference's test_boxes is a stub that never "
                         "hits, mg_ray_tracer.cpp:89-93 — parity default)")
    ap.add_argument("--true-colours", action="store_true",
                    help="interpret named colours as /255 instead of the "
                         "reference's clamp binarization")
    return ap


def _log(*args):
    print(*args, file=sys.stdout, flush=True)


def _error(*args):
    print("error:", *args, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import rt_tpu
    from rt_tpu import renderer as registry
    from rt_tpu import runtime

    if args.list:
        for d in registry.all_renderers():
            _log(d.name)
        return 0

    try:
        w, h = (int(v) for v in args.size.lower().split("x"))
    except ValueError:
        _error(f"bad --size '{args.size}' (expected WxH)")
        return 2

    runtime.use_compile_cache()
    if args.interactive:
        from .viewer import interactive

        interactive(args.scene.strip(), args.renderer.strip(),
                    size=(w, h), spp=args.spp, seed=args.seed)
        return 0

    desc = registry.find_by_name_fuzzy(args.renderer.strip())
    if desc is None:
        _error(f"no known renderer with name '{args.renderer}'")
        return 2
    render = desc.create()
    _log(f"created renderer: {desc.name}")

    def load_scene():
        if args.procedural:
            return rt_tpu.scene.make_procedural_scene(args.procedural)
        if args.scene.strip():
            return rt_tpu.load(args.scene.strip(), compat_colours=not args.true_colours)
        return rt_tpu.load_first_available(compat_colours=not args.true_colours)

    try:
        scene = load_scene()
    except Exception as ex:
        _error(ex)
        return 1
    if scene.path:
        _log(f"scene '{scene.path}' loaded.")
    else:
        _log("scene loaded.")

    opts = {}
    if args.spp is not None:
        opts["spp"] = args.spp
    if args.bounces is not None:
        opts["max_bounces"] = args.bounces
    if args.boxes and desc.name in ("mg_ray_tracer", "sm_ray_tracer"):
        opts["include_boxes"] = True

    render_fn = render
    if args.mesh:
        from rt_tpu import dist

        parts = args.mesh.lower().split("x")
        n_rays = int(parts[0])
        n_prims = int(parts[1]) if len(parts) > 1 else 1
        mesh = dist.make_mesh(n_rays, n_prims)
        personality = {"mg_ray_tracer": "mg", "sm_ray_tracer": "sm"}.get(desc.name)
        if personality is None:
            _error(f"--mesh is only supported for the path tracers, not {desc.name}")
            return 2

        def render_fn(scene, size, key, **o):
            return dist.render_image_sharded(scene, size, key, mesh,
                                             personality=personality, **o)

    import numpy as np

    def do_render(scene):
        key = rt_tpu.rng.make_key(args.seed)
        t0 = time.perf_counter()
        img = np.asarray(render_fn(scene, (w, h), key, **opts))
        dt = time.perf_counter() - t0
        rt_tpu.image.write_image(args.out, img)
        spp = opts.get("spp", scene.samples_per_pixel)
        _log(f"rendered {w}x{h}@{spp}spp in {dt:.2f}s "
             f"({w * h * spp / dt / 1e6:.1f} Mrays/s) -> {args.out}")
        if args.preview:
            from .viewer import print_preview

            print_preview(img)

    do_render(scene)

    if args.watch and not args.procedural and os.path.exists(scene.path or ""):
        _log("watching for changes (ctrl-c to stop)...")
        last = os.path.getmtime(scene.path)
        try:
            while True:
                time.sleep(0.5)  # reference polls every 0.5 s (main.cpp:235-249)
                try:
                    mtime = os.path.getmtime(scene.path)
                except OSError:
                    continue
                if mtime != last:
                    last = mtime
                    try:
                        scene = load_scene()
                        _log(f"scene '{scene.path}' reloaded.")
                    except Exception as ex:
                        _error(ex)  # keep previous scene (main.cpp:127-132)
                        continue
                    do_render(scene)
        except KeyboardInterrupt:
            _log("bye")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
