#!/usr/bin/env python
"""Real multi-process distributed check (SURVEY.md §4).

Spawns N OS processes, each a separate JAX controller on the CPU backend
(`jax.distributed.initialize` — rt_tpu.dist.initialize's machinery), builds
a cross-process ('rays',) mesh over all global devices and asserts:

* a sharded render is BIT-IDENTICAL to the single-process jnp renderer
  (each worker checks its addressable shards);
* the MSE loss + parameter gradients through the sharded renderer (whose
  shard_map transpose emits a cross-process psum) match the single-process
  values.

It stands in for a multi-host run, which one machine cannot exercise; the
same mesh API spans hosts.

Usage:
  python tools/mp_check.py [--procs 2] [--devs 2]     # launcher
  python tools/mp_check.py WORKER <pid> <procs> <port> <devs>
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(pid: int, nproc: int, port: int, devs_per_proc: int) -> None:
    inherited = [f for f in os.environ.get("XLA_FLAGS", "").split()
                 if "xla_force_host_platform_device_count" not in f]
    os.environ["XLA_FLAGS"] = " ".join(
        [f"--xla_force_host_platform_device_count={devs_per_proc}"] + inherited)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nproc, process_id=pid,
    )
    assert jax.process_count() == nproc, jax.process_count()
    n_global = len(jax.devices())
    assert n_global == nproc * devs_per_proc

    import numpy as np
    import jax.numpy as jnp

    sys.path.insert(0, REPO)
    import rt_tpu
    from rt_tpu import diff, dist
    from jax.sharding import NamedSharding, PartitionSpec as P

    s = rt_tpu.load(os.path.join(REPO, "scenes", "basic.toml"))
    size = (64, 32)
    key = rt_tpu.rng.make_key(5)

    # single-process reference (pure local computation)
    ref = np.asarray(rt_tpu.integrator.render_image(
        s, size, key, spp=2, max_bounces=3, ray_chunk=256))

    # 1) sharded render over the cross-process mesh: bit parity
    mesh = dist.make_mesh(n_global, 1)
    img = dist.render_image_sharded(
        s, size, key, mesh, spp=2, max_bounces=3, ray_chunk=256)
    ref3 = ref.reshape(size[1], size[0], 3)
    checked = 0
    for shard in img.addressable_shards:
        np.testing.assert_array_equal(np.asarray(shard.data), ref3[shard.index])
        checked += 1
    assert checked > 0
    print(f"[worker {pid}] render parity ok ({checked} shards)", flush=True)

    # 2) gradients: shard_map transpose -> cross-process psum
    params = diff.extract_params(s)
    target = np.zeros((size[1], size[0], 3), np.float32)
    l_ref, g_ref = diff.loss_and_grad(
        params, s, jnp.asarray(target), size, key,
        spp=1, max_bounces=2, ray_chunk=256)

    gparams = {k: dist._to_global(mesh, P(), v) for k, v in params.items()}
    gtarget = dist._to_global(mesh, P(), target)

    def lossf(p, t):
        return diff.image_loss(
            p, s, t, size, key, spp=1, max_bounces=2, ray_chunk=256,
            render_fn=lambda sc, sz, k, **o: dist.render_image_sharded(
                sc, sz, k, mesh, **o),
        )

    l_sh, g_sh = jax.jit(jax.value_and_grad(lossf))(gparams, gtarget)
    np.testing.assert_allclose(float(l_sh), float(l_ref), rtol=1e-6)
    for k in g_ref:
        np.testing.assert_allclose(
            np.asarray(g_sh[k]), np.asarray(g_ref[k]), atol=1e-5, rtol=1e-4,
            err_msg=k)
    print(f"[worker {pid}] psum'd gradients ok", flush=True)
    print(f"[worker {pid}] OK", flush=True)


def launch(nproc: int = 2, devs_per_proc: int = 2, timeout: int = 300) -> None:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "WORKER",
             str(i), str(nproc), str(port), str(devs_per_proc)],
        )
        for i in range(nproc)
    ]
    rcs = [p.wait(timeout=timeout) for p in procs]
    if any(rcs):
        raise RuntimeError(f"mp_check worker failures: rcs={rcs}")
    print(f"mp_check OK: {nproc} processes x {devs_per_proc} devices", flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "WORKER":
        worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
               int(sys.argv[5]))
    else:
        import argparse

        ap = argparse.ArgumentParser()
        ap.add_argument("--procs", type=int, default=2)
        ap.add_argument("--devs", type=int, default=2)
        ap.parse_args_result = ap.parse_args()
        launch(ap.parse_args_result.procs, ap.parse_args_result.devs)
