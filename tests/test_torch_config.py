"""The PyTorch port's configuration and its independence from JAX.

The port keeps its own copy of the presets; every one must equal the JAX
package's. Neither the port nor ``chip_smoke.py`` may import JAX or the JAX
package, which the card's machine does not run.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

from nerf_meets_mlx_torch import config as tcfg
from nerf_meets_mlx_tpu import config as jcfg

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "nerf_meets_mlx_tpu")


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_preset_equals_jax(name):
    assert sorted(tcfg.PRESETS) == sorted(jcfg.PRESETS)
    assert dataclasses.asdict(tcfg.PRESETS[name]()) == dataclasses.asdict(
        jcfg.PRESETS[name]()
    )


def test_config_from_text_equals_jax(tmp_path):
    txt = tmp_path / "lego.txt"
    txt.write_text(
        "expname = lego\nN_samples = 32\nN_importance = 64\nwhite_bkgd = True\n"
        "netwidth = 128\nmultires = 8\nchunk = 4096\nno_ndc = True\n"
    )
    assert tcfg.parse_text_config(txt) == jcfg.parse_text_config(txt)
    assert dataclasses.asdict(tcfg.config_from_text(txt)) == dataclasses.asdict(
        jcfg.config_from_text(txt)
    )


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    pkg = ROOT / "nerf_meets_mlx_torch"
    files = [  # build/ holds compiled kernels and scratch copies, not the port
        f for f in sorted(pkg.rglob("*.py")) if f.relative_to(pkg).parts[0] != "build"
    ] + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [
        (str(f.relative_to(ROOT)), m)
        for f in files
        for m in _imported_modules(f)
        if m.split(".")[0] in FORBIDDEN
    ]
    assert bad == []


def test_import_leaves_jax_unloaded():
    code = (
        "import sys, nerf_meets_mlx_torch, nerf_meets_mlx_torch.entrypoints, "
        "nerf_meets_mlx_torch.__main__; "
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}))"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
        env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
