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


NERF_PRESETS = ("lego_coarse", "lego_hierarchical", "lego_fast", "lego_occ", "lego_full",
                "lego_ingp", "lego_ingp_occ", "llff", "deepvoxels", "lego_cp")
# the "feats" route's two triggers, as text overlays on lego_ingp: the
# Instant-NGP paper's tables, and more than 256 samples a ray
FEATS_OVERLAYS = {
    "lego_ingp+paper_tables": "hash_n_levels = 16\nhash_log2_table_size = 19\nhash_max_res = 512\n",
    "lego_ingp+long_rays": "N_samples = 128\nN_importance = 256\n",
}


_PAPER = FEATS_OVERLAYS["lego_ingp+paper_tables"]
# the overlay commands whose shapes the fused kernels took only once their
# width, level and feature bounds were lifted: (preset, overlay, the fused
# train route both packages take); the INGP ones keep their tables within
# the ingp route's budget (HashEncodeSpec.vmem_ok: L·T·F·4 <= 6 MiB)
SHAPE_OVERLAYS = {
    "lego_ingp+netwidth128": ("lego_ingp", "netwidth = 128\n", "ingp"),
    "lego_ingp+netwidth256": ("lego_ingp", "netwidth = 256\n", "ingp"),
    "lego_ingp+32_levels": ("lego_ingp", "hash_n_levels = 32\nhash_log2_table_size = 12\n",
                            "ingp"),
    "lego_ingp+8_features": ("lego_ingp", "hash_features_per_level = 8\nhash_n_levels = 12\n",
                             "ingp"),
    "paper_tables+netwidth128": ("lego_ingp", _PAPER + "netwidth = 128\n", "feats"),
    "paper_tables+32x4": ("lego_ingp", "hash_n_levels = 32\nhash_log2_table_size = 19\n"
                          "hash_max_res = 512\nhash_features_per_level = 4\n", "feats"),
    "lego_hierarchical+netwidth96": ("lego_hierarchical", "netwidth = 96\n", "sinusoidal"),
    "lego_occ+netwidth48": ("lego_occ", "netwidth = 48\n", "sinusoidal"),
}


def _preset(mod, name, tmp_path):
    if name in FEATS_OVERLAYS or name in SHAPE_OVERLAYS:
        preset, text, _ = SHAPE_OVERLAYS.get(name, ("lego_ingp", FEATS_OVERLAYS.get(name), None))
        txt = tmp_path / "overlay.txt"
        txt.write_text(text)
        return mod.config_from_text(txt, mod.PRESETS[preset]())
    return mod.PRESETS[name]()


@pytest.mark.parametrize(
    "name", NERF_PRESETS + tuple(FEATS_OVERLAYS) + tuple(SHAPE_OVERLAYS) + ("image2d",))
def test_routing_equals_jax(name, tmp_path):
    """Every NeRF preset, lego_ingp under both "feats" overlays, the overlay
    commands of the lifted shape bounds, and the image task take the same
    route in both packages, with the fused kernels off, on, and on without
    the fused train op: the fused mode ("sinusoidal", "ingp", "feats" or
    none) and the hash-encode kernel of ``query``. The CUDA entry points
    turn the fused kernels on for the sinusoidal and the hash-grid presets,
    as the JAX trainer does on a TPU."""
    from nerf_meets_mlx_torch.entrypoints.render_only import _uses_fused_route
    from nerf_meets_mlx_torch.models import create_nerf as t_create
    from nerf_meets_mlx_tpu.models import create_nerf as j_create

    base_t, base_j = _preset(tcfg, name, tmp_path), _preset(jcfg, name, tmp_path)
    assert dataclasses.asdict(base_t) == dataclasses.asdict(base_j)
    for fused, fused_train in ((False, True), (True, True), (True, False)):
        tc = base_t.replace(use_fused_kernel=fused, use_fused_train=fused_train)
        jc = base_j.replace(use_fused_kernel=fused, use_fused_train=fused_train)
        tm, jm = t_create(tc, device="meta"), j_create(jc)
        assert tm._fused_train_mode == jm._fused_train_mode, (fused, fused_train)
        assert tm._use_hash_kernel() == (
            fused and jc.pos_encoding.kind == "hash_grid" and name != "lego_ingp+paper_tables"
            and not name.startswith("paper_tables"))
    hash_grid = base_t.pos_encoding.kind == "hash_grid"
    assert _uses_fused_route(base_t) == (
        hash_grid or (base_t.pos_encoding.kind == "sinusoidal" and name != "image2d"))
    want = {"lego_ingp": "ingp", "lego_ingp+paper_tables": "feats",
            "lego_ingp+long_rays": "feats", "image2d": None, "lego_cp": None,
            **{k: v[2] for k, v in SHAPE_OVERLAYS.items()}}
    if name in want:
        assert t_create(tc.replace(use_fused_train=True), device="meta")._fused_train_mode == (
            want[name])


def test_feats_route_raises():
    """A hash-grid config past the fused INGP kernel's bounds (more than 256
    samples a ray) takes the "feats" train route in both packages: its train
    render runs (the hash encode, then the feat train op), and its eval
    render takes the standard route, as the JAX package's does. Past 2048
    samples a ray no fused route is left, and the train render raises."""
    import torch

    from nerf_meets_mlx_torch.models import create_nerf as t_create
    from nerf_meets_mlx_tpu.models import create_nerf as j_create

    def cfg_of(mod, n=160):
        cfg = mod.lego_ingp().replace(use_fused_kernel=True)
        return cfg.replace(render=dataclasses.replace(cfg.render, n_samples=n, n_importance=n))

    tm = t_create(cfg_of(tcfg), device="cpu").init(torch.Generator().manual_seed(0))
    assert tm._fused_train_mode == j_create(cfg_of(jcfg))._fused_train_mode == "feats"
    ro, rd = torch.zeros(2, 3), torch.tensor([[0.0, 0.0, 1.0]] * 2)
    out = tm.render_rays_train(ro, rd, torch.zeros(2, 3), generator=torch.Generator())
    assert out["sse_fine"].requires_grad and out["rgb_fine"].shape == (2, 3)
    assert tuple(out["weights"].shape) == (2, 160)
    out = tm.render_rays(ro, rd, train=False)
    assert out["rgb_map"].shape == (2, 3)
    long = t_create(cfg_of(tcfg, 1025), device="cpu").init(torch.Generator().manual_seed(0))
    assert long._fused_train_mode is None is j_create(cfg_of(jcfg, 1025))._fused_train_mode
    with pytest.raises(ValueError, match="fused route"):
        long.render_rays_train(ro, rd, torch.zeros(2, 3), generator=torch.Generator())
