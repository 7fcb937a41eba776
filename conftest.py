"""Builds the JAX reference's native libraries once, before any test module
is collected.

``nerf_meets_mlx_tpu/utils/native_lib.py`` runs ``make -C native`` at first
use and caches a failed load as None, and ``tests/test_native_video.py``
skips itself at collection when that load fails. Under pytest-xdist every
worker collects that module at the same time, so each one runs ``make``
into ``native/build/`` and a worker may load a ``.so`` that another is still
writing ("file too short", "invalid ELF header"): its cached None then
skips the module's tests in that worker. Building once in the controller
(the process without ``workerinput``), before the workers start, leaves
them a finished library. A failed or missing build is ignored: the
reference's native tests then skip as they would.
"""

import subprocess
from pathlib import Path

NATIVE = Path(__file__).resolve().parent / "native"


def pytest_configure(config):
    if hasattr(config, "workerinput") or not (NATIVE / "Makefile").exists():
        return
    try:
        subprocess.run(["make", "-C", str(NATIVE)], capture_output=True, timeout=300, check=False)
    except (OSError, subprocess.SubprocessError):
        pass
