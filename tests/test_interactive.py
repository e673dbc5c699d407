"""Drive the interactive surfaces end-to-end (VERDICT r1 item 8).

* viewer.interactive through a real pty: keystrokes for renderer cycling,
  movement (low-res switch), hot reload with camera preserved, quit.
* cli --watch: touch the scene file, assert an automatic re-render; feed a
  broken scene, assert the previous one is kept (main.cpp:127-132).
"""

import os
import re
import select
import shutil
import signal
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENE = """
samples_per_pixel = 1
max_bounces = 2
materials = [ { type = 'lambert', albedo = 'red' } ]
spheres = [ { material = 0, position = [0.0, 1.0, -3.0], radius = 0.5 } ]
"""


def _read_until(fd, pattern, timeout=90.0, proc=None):
    """Read from fd until ``pattern`` (regex) appears; returns the buffer."""
    buf = b""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        r, _, _ = select.select([fd], [], [], 0.25)
        if r:
            try:
                chunk = os.read(fd, 65536)
            except OSError:
                break
            if not chunk:
                break
            buf += chunk
            if re.search(pattern, buf.decode("utf-8", "replace")):
                return buf.decode("utf-8", "replace")
        if proc is not None and proc.poll() is not None and not r:
            raise AssertionError(
                f"child exited rc={proc.returncode} before {pattern!r}; "
                f"got: {buf.decode('utf-8', 'replace')[-800:]!r}")
    raise AssertionError(
        f"pattern {pattern!r} not seen; got: {buf.decode('utf-8', 'replace')[-800:]!r}")


@pytest.mark.slow
def test_viewer_interactive_pty(tmp_path):
    import pty

    scene_file = tmp_path / "scene.toml"
    scene_file.write_text(SCENE)

    master, slave = pty.openpty()
    env = dict(os.environ)
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "from rt_tpu.viewer import interactive;"
        f"interactive({str(scene_file)!r}, 'null', size=(48, 28))"
    )
    proc = subprocess.Popen(
        [sys.executable, "-c", code],
        stdin=slave, stdout=slave, stderr=subprocess.DEVNULL,
        env=env, cwd=REPO, close_fds=True,
    )
    os.close(slave)
    try:
        # initial full-quality frame with the requested renderer
        _read_until(master, r"\[null_renderer\]", proc=proc)

        # '-' cycles back to the rasterizer (registry order); the terminal
        # title carries the status line (main.cpp:154-163 analogue)
        os.write(master, b"-")
        _read_until(master,
                    r"(?s)\x1b\]0;rt - .*scene\.toml - rasterizer\x07"
                    r".*\[rasterizer\]", proc=proc)

        # movement: low-res frame now, full-quality one ~0.5 s later
        os.write(master, b"w")
        _read_until(master, r"\[rasterizer\]", proc=proc)

        # hot reload via mtime poll: the change raises a confirmation
        # prompt (the ImGui "reload?" dialog analogue, main.cpp:251-263);
        # 'y' reloads with the camera preserved
        scene_file.write_text(SCENE.replace("'red'", "'blue'"))
        os.utime(scene_file, (time.time() + 2, time.time() + 2))
        _read_until(master, r"reload\? \[y/n\]", timeout=120, proc=proc)
        os.write(master, b"y")
        _read_until(master, r"\[rasterizer\].*scene\.toml", timeout=120,
                    proc=proc)

        # 'r' reload, let the redraw land, then quit
        os.write(master, b"r")
        _read_until(master, r"\[rasterizer\]", timeout=120, proc=proc)
        time.sleep(0.5)
        os.write(master, b"q")
        _read_until(master, r"bye", proc=proc)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        os.close(master)


@pytest.mark.slow
def test_viewer_mouse_look_and_resize_pty(tmp_path):
    """RMB drag-look via SGR mouse reporting + SIGWINCH-driven resize
    (round-2 VERDICT items 1/2; main.cpp:208-232, window.cpp:198-203)."""
    import fcntl
    import pty
    import re as _re
    import struct
    import termios

    scene_file = tmp_path / "scene.toml"
    scene_file.write_text(SCENE)

    master, slave = pty.openpty()
    # initial pty size consistent with the requested render size
    fcntl.ioctl(master, termios.TIOCSWINSZ, struct.pack("HHHH", 20, 60, 0, 0))
    env = dict(os.environ)
    env["RT_VIEWER_DEBUG"] = "1"
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "from rt_tpu.viewer import interactive;"
        f"interactive({str(scene_file)!r}, 'null', size=(48, 28))"
    )
    proc = subprocess.Popen(
        [sys.executable, "-c", code],
        stdin=slave, stdout=slave, stderr=subprocess.DEVNULL,
        env=env, cwd=REPO, close_fds=True,
    )
    os.close(slave)
    fwd_re = _re.compile(r"fwd=\((-?\d+\.\d+),(-?\d+\.\d+),(-?\d+\.\d+)\)")
    try:
        buf = _read_until(master, r"\[null_renderer\] 48x28", proc=proc)
        # mouse reporting is enabled (DECSET 1002/1006)
        buf += _read_until(master, r"\x1b\[\?1002h\x1b\[\?1006h|cam pos=",
                           proc=proc)
        first = fwd_re.search(buf)
        assert first is not None, f"no cam HUD in {buf[-400:]!r}"
        fwd0 = tuple(first.groups())

        # RMB press at (60,5), drag left to (20,5), release: yaw_delta =
        # +40 * 0.1 = 4 rad accumulated, applied x dt on the next frame
        os.write(master, b"\x1b[<2;60;5M")
        time.sleep(0.2)
        os.write(master, b"\x1b[<34;20;5M")
        time.sleep(0.4)
        os.write(master, b"\x1b[<2;20;5m")

        deadline = time.monotonic() + 90
        rotated = False
        while time.monotonic() < deadline and not rotated:
            buf += _read_until(master, r"fwd=", proc=proc)
            for m in fwd_re.finditer(buf):
                if m.groups() != fwd0:
                    rotated = True
                    break
        assert rotated, f"camera never rotated; HUD tail: {buf[-400:]!r}"

        # shrink the terminal; after the 0.3 s debounce the render size is
        # rebuilt from the cell grid: (2*(30-2), 4*(12-3)) = 56x36
        fcntl.ioctl(master, termios.TIOCSWINSZ,
                    struct.pack("HHHH", 12, 30, 0, 0))
        proc.send_signal(signal.SIGWINCH)
        _read_until(master, r"\[null_renderer\] 56x36", timeout=60, proc=proc)

        os.write(master, b"q")
        _read_until(master, r"bye", proc=proc)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        os.close(master)


@pytest.mark.slow
def test_cli_watch_rerenders(tmp_path):
    scene_file = tmp_path / "watched.toml"
    scene_file.write_text(SCENE)
    out = tmp_path / "out.png"
    env = dict(os.environ)
    code = (
        "import jax, sys; jax.config.update('jax_platforms','cpu');"
        "from rt_tpu.cli import main;"
        "sys.exit(main(sys.argv[1:]))"
    )
    proc = subprocess.Popen(
        [sys.executable, "-u", "-c", code,
         "--scene", str(scene_file), "--renderer", "rasterizer",
         "--size", "32x24", "--out", str(out), "--watch"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, cwd=REPO,
    )
    fd = proc.stdout.fileno()
    try:
        _read_until(fd, r"watching for changes")
        mtime0 = out.stat().st_mtime

        # a broken edit: error logged, previous scene kept, no exit
        scene_file.write_text("materials = [ { type = 'nope' } ]\n")
        os.utime(scene_file, (time.time() + 2, time.time() + 2))
        _read_until(fd, r"error:.*material_type", timeout=120)
        assert proc.poll() is None

        # a good edit: automatic re-render to the same output file
        scene_file.write_text(SCENE.replace("0.5", "0.7"))
        os.utime(scene_file, (time.time() + 4, time.time() + 4))
        _read_until(fd, r"reloaded", timeout=120)
        _read_until(fd, r"rendered 32x24", timeout=180)
        # the PNG write lands after the "rendered" log line; poll rather
        # than sleep a fixed amount (the full suite loads the machine)
        deadline = time.time() + 15
        while time.time() < deadline and out.stat().st_mtime == mtime0:
            time.sleep(0.2)
        assert out.stat().st_mtime != mtime0
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
