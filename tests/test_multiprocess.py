"""Real multi-process distribution.

tools/mp_check.py spawns 2 OS processes, each its own JAX controller on the
CPU backend (jax.distributed.initialize), builds a cross-process mesh and
asserts sharded-render bit parity + psum'd-gradient parity against the
single-process pipeline.  It stands in for a multi-host run: the
collectives cross process boundaries (Gloo transport).
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_two_process_render_and_grads():
    # the workers manage their own XLA_FLAGS / platform selection
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "mp_check.py"),
         "--procs", "2", "--devs", "2"],
        capture_output=True, text=True, timeout=600, cwd=REPO,
    )
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "mp_check OK" in r.stdout
