"""Times the fused kernels of two checkouts of the port in turns, on one card.

    python nerf_meets_mlx_torch/tools/kernel_ab.py --base <checkout> [--head <checkout>]

``--head`` defaults to the checkout this file is in. Each turn is a fresh
process with that checkout first on ``PYTHONPATH``; the turns run base,
head, head, base, so that a drift of the card shows as a difference between
a checkout's two turns. A turn builds the kernels it times (all builds
started together), then times with CUDA events, at the main paths' shapes:
the INGP eval and train kernels (lego_ingp, 4096 rays / 32,768-ray chunks, 48
and 96 samples), the hash forward and dG (lego_ingp's 196,608 / 393,216
points), the sinusoidal eval and train kernels (lego_hierarchical, 8 x 256),
the MLP forward and backward (lego_occ's fine points), the feat train kernel
(the paper tables' 32 channels) and the image kernels (image2d); and a
400 x 400 frame of lego_ingp and of lego_hierarchical; the INGP and feat
train calls' device time (every kernel they launch, from torch.profiler:
the host-bound coarse calls read their kernels here, not in their event
time); and the paper tables' warm train step (the feats route, 32 steps,
as chip_smoke.py times it). It prints one JSON line per turn and each
measurement's four times; then, where both checkouts have
``csrc/ingp_train_tc.cu``, each kernel of it in both: ptxas's registers and
spills, and its SASS instruction by instruction (the kernel parameters'
constant-bank offsets masked), as lines starting with ``[ptxas]`` and
``[sass]``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

HEAD = Path(__file__).resolve().parents[2]


def _ms(fn, n=20):
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def _device_ms(fn, n=10):
    """Device ms a call of everything ``fn`` launches (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            t = getattr(e, "self_device_time_total", None)
            us += float(getattr(e, "self_cuda_time_total", 0.0) if t is None else t)
    return us / 1e3 / n


def _paper_step_ms(n=32):
    """Host ms a warm train step of lego_ingp with the paper's tables (the
    feats route) on the 400 x 400 procedural scene, over ``n`` steps
    ending in one synchronize."""
    import dataclasses
    import time

    import torch

    from nerf_meets_mlx_torch.config import lego_ingp
    from nerf_meets_mlx_torch.datasets.synthetic import make_synthetic_scene
    from nerf_meets_mlx_torch.engine import TrainState, make_nerf_train_step
    from nerf_meets_mlx_torch.models import create_nerf

    dev = torch.device("cuda", 0)
    ds = make_synthetic_scene(2, 1, 1, 400, device=dev)
    cfg = lego_ingp()
    cfg = cfg.replace(use_fused_kernel=True, pos_encoding=dataclasses.replace(
        cfg.pos_encoding, hash_n_levels=16, hash_log2_table_size=19, hash_max_res=512))
    model = create_nerf(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    images = torch.as_tensor(ds.images[ds.i_train], device=dev)
    poses = torch.as_tensor(ds.poses[ds.i_train, :3, :4], device=dev)
    state = TrainState(model, cfg.train)
    step = make_nerf_train_step(model, ds.H, ds.W, ds.focal)
    gen = torch.Generator(device=dev).manual_seed(25)
    for _ in range(3):
        step(state, images, poses, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step(state, images, poses, gen)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def _build_all():
    """Every build the turn times, all started together (where the
    checkout's ``_build`` takes per-shape defines: lego_ingp's and the
    paper tables' shapes; and the INGP train kernel's source where the
    checkout has one)."""
    from concurrent.futures import ThreadPoolExecutor

    from nerf_meets_mlx_torch.kernels import _build

    jobs = [(n, None) for n in ("fused_eval", "fused_train", "fused_mlp", "hash_encode",
                                "fused_image")]
    if hasattr(_build, "variant_name"):
        import inspect

        from nerf_meets_mlx_torch.kernels import fused_feat_train, fused_ingp_train

        # kernel_defines takes (width, levels, features), or (width, L·F)
        # in checkouts that predate the runtime-shape build
        ingp = fused_ingp_train.kernel_defines
        n_args = len(inspect.signature(ingp).parameters)
        jobs += [("fused_ingp", ingp(64, 8, 2) if n_args == 3 else ingp(64, 16)),
                 ("fused_feat", fused_feat_train.kernel_defines(64, 32))]
        if hasattr(fused_ingp_train, "TC_SOURCE"):  # the INGP train kernel's own source
            jobs.append((fused_ingp_train.TC_SOURCE, None))
        call = _build.build
    else:
        jobs += [("fused_ingp", None), ("fused_feat", None)]

        def call(name, _defines):
            return _build.build(name)

    with ThreadPoolExecutor(len(jobs)) as ex:
        for f in [ex.submit(call, n, d) for n, d in jobs]:
            f.result()


def worker():
    import numpy as np
    import torch

    from nerf_meets_mlx_torch.cameras.pose import orbit_poses
    from nerf_meets_mlx_torch.cameras.rays import get_rays
    from nerf_meets_mlx_torch.config import image2d, lego_hierarchical, lego_ingp
    from nerf_meets_mlx_torch.datasets.synthetic import CAMERA_ANGLE_X
    from nerf_meets_mlx_torch.kernels import fused_feat_train as ff
    from nerf_meets_mlx_torch.kernels import fused_image as fim
    from nerf_meets_mlx_torch.kernels import fused_ingp_train as fi
    from nerf_meets_mlx_torch.kernels import fused_mlp as fm
    from nerf_meets_mlx_torch.kernels import fused_train as ft
    from nerf_meets_mlx_torch.kernels import hash_encode as he
    from nerf_meets_mlx_torch.models import create_nerf
    from nerf_meets_mlx_torch.models.nerf_mlp import NeRFMLP
    from nerf_meets_mlx_torch.rendering import render_image

    torch.backends.cuda.matmul.allow_tf32 = False
    _build_all()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    res = 400
    focal = 0.5 * res / np.tan(0.5 * CAMERA_ANGLE_X)
    K = np.array([[focal, 0, res / 2], [0, focal, res / 2], [0, 0, 1]], np.float32)
    ro, rd = get_rays(res, res, K, orbit_poses(160)[0][:3, :4], device=dev)
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    vd = rd / torch.linalg.vector_norm(rd, dim=-1, keepdim=True)

    def level(n_rays, S, lo=2.0, hi=6.0):
        z = torch.sort(torch.rand((n_rays, S), generator=g, device=dev) * (hi - lo) + lo, -1).values
        dl = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1)
        dl = dl * torch.linalg.vector_norm(rd[:n_rays], dim=-1, keepdim=True)
        return z, dl, torch.randn((n_rays, S), generator=g, device=dev)

    target = torch.rand((4096, 3), generator=g, device=dev)
    tspec = ft.TrainSpec  # the spec type of both checkouts

    # INGP and hash kernels at lego_ingp
    m = create_nerf(lego_ingp().replace(use_fused_kernel=True), device=dev)
    m.init(torch.Generator(device=dev).manual_seed(0))
    sh = m.dir_enc.apply(vd)
    for name, n_rays, S in (("coarse", 4096, 48), ("fine", 4096, 96)):
        z, dl, nz = level(n_rays, S)
        rb = fi.ingp_rays_block(S)
        spec = tspec(n_samples=S, rays_block=rb, mode="canonical", density_activation="softplus",
                     white_bkgd=True, group=fi.ingp_group(S, rb))
        args = (m.fine, m.pos_enc, sh[:n_rays], spec, ro[:n_rays], rd[:n_rays], z, dl, nz, target)

        def train(args=args):
            sse = fi.fused_ingp_train_apply(*args)[0]
            sse.backward()

        out[f"ingp_train_{name}"] = _ms(train)
        with torch.no_grad():
            out[f"ingp_train_device_{name}"] = _device_ms(lambda args=args: fi.fused_ingp_train_apply(
                *args))
        pts = (ro[:n_rays, None] + z[..., None] * rd[:n_rays, None]).reshape(-1, 3)
        out[f"hash_fwd_{name}"] = _ms(lambda pts=pts: he.hash_encode_apply(m.pos_enc, pts))
        dout = torch.randn((pts.shape[0], m.pos_enc.out_dim), generator=g, device=dev)
        out[f"hash_fwd_bwd_{name}"] = _ms(
            lambda pts=pts, dout=dout: (he.hash_encode_apply(m.pos_enc, pts) * dout).sum().backward())
        z, dl, _ = level(32768, S)
        espec = tspec(n_samples=S, rays_block=fi.ingp_rays_block(S), mode="canonical",
                      density_activation="softplus", white_bkgd=True)
        with torch.no_grad():
            out[f"ingp_eval_{name}"] = _ms(lambda z=z, dl=dl, espec=espec: fi.fused_ingp_eval_apply(
                m.fine, m.pos_enc, sh[:32768], espec, ro[:32768], rd[:32768], z, dl), n=10)
    with torch.no_grad():
        out["lego_ingp_frame"] = _ms(lambda: render_image(m, res, res, K, orbit_poses(160)[0][:3, :4]),
                                     n=5)

    # sinusoidal kernels at lego_hierarchical, the MLP kernels at lego_occ's fine points
    m = create_nerf(lego_hierarchical().replace(use_fused_kernel=True), device=dev)
    m.init(torch.Generator(device=dev).manual_seed(0))
    for name, S in (("coarse", 64), ("fine", 192)):
        z, dl, nz = level(4096, S)
        rb = ft.default_rays_block(S)
        spec = tspec(n_samples=S, rays_block=rb, mode="canonical", density_activation="softplus",
                     white_bkgd=True, group=ft.default_group(S, rb))
        args = (m.fine, m.pos_enc, m.dir_enc, spec, ro[:4096], rd[:4096], vd[:4096], z, dl, nz,
                target)
        out[f"train_{name}"] = _ms(lambda args=args: ft.fused_train_apply(*args)[0].backward(), n=5)
        z, dl, _ = level(32768, S)
        espec = tspec(n_samples=S, rays_block=ft.eval_block(S), mode="canonical",
                      density_activation="softplus", white_bkgd=True)
        with torch.no_grad():
            out[f"eval_{name}"] = _ms(lambda z=z, dl=dl, espec=espec: ft.fused_eval_apply(
                m.fine, m.pos_enc, m.dir_enc, espec, ro[:32768], rd[:32768], vd[:32768], z, dl),
                n=3)
    with torch.no_grad():
        out["lego_hierarchical_frame"] = _ms(
            lambda: render_image(m, res, res, K, orbit_poses(160)[0][:3, :4]), n=2)
    z, _, _ = level(4096, 96)
    pts = (ro[:4096, None] + z[..., None] * rd[:4096, None]).reshape(-1, 3)
    dirs = vd[:4096, None].expand(-1, 96, -1).reshape(-1, 3)
    with torch.no_grad():
        out["mlp_fwd_fine"] = _ms(lambda: fm.fused_mlp_apply(m.fine, m.pos_enc, m.dir_enc, pts,
                                                             dirs), n=5)
    dout = torch.randn((pts.shape[0], 4), generator=g, device=dev)
    out["mlp_fwd_bwd_fine"] = _ms(lambda: (fm.fused_mlp_apply(
        m.fine, m.pos_enc, m.dir_enc, pts, dirs) * dout).sum().backward(), n=5)

    # feat kernel at the paper tables' 32 channels, image kernels at image2d
    cfg = lego_ingp().mlp
    mlp = NeRFMLP(cfg, 32, 25, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    for name, S in (("coarse", 48), ("fine", 96)):
        z, dl, nz = level(4096, S)
        feats = torch.randn((4096, S, 32), generator=g, device=dev) * 0.5
        x = ff.pack_feat_inputs(feats, sh[:4096], dl, nz)
        rb = ff.feat_rays_block(S)
        spec = tspec(n_samples=S, rays_block=rb, mode="canonical", density_activation="softplus",
                     white_bkgd=True, group=ff.feat_group(S, rb))
        out[f"feat_train_{name}"] = _ms(
            lambda x=x, spec=spec: ff.fused_feat_train_apply(mlp, spec, x, target)[0].backward())
        with torch.no_grad():
            out[f"feat_train_device_{name}"] = _device_ms(
                lambda x=x, spec=spec: ff.fused_feat_train_apply(mlp, spec, x, target))
    m = create_nerf(image2d(), device=dev)
    m.init(torch.Generator(device=dev).manual_seed(0))
    xy = torch.rand((4096, 2), generator=g, device=dev)
    out["image_train"] = _ms(lambda: fim.fused_image_train(m.coarse, m.pos_enc, xy,
                                                           target).backward())
    grid = torch.rand((160_000, 2), generator=g, device=dev)
    with torch.no_grad():
        out["image_fwd"] = _ms(lambda: fim.fused_image_apply(m.coarse, m.pos_enc, grid))
    out["paper_step"] = _paper_step_ms()
    print(json.dumps(out), flush=True)


def _tile_kernels(root: Path, tag: str):
    """ptxas's report and the SASS of each kernel of ``root``'s
    csrc/ingp_train_tc.cu (compiled to a cubin with the build's flags):
    {kernel: [instructions, constant-bank offsets masked]}."""
    from nerf_meets_mlx_torch.kernels import _build

    csrc = root / "nerf_meets_mlx_torch" / "csrc"
    out_dir = HEAD / ".runs" / "kernel_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    cubin = out_dir / f"{tag}.cubin"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    proc = subprocess.run([_build._nvcc(), *flags, "-cubin", "-I", str(csrc), "-o", str(cubin),
                           str(csrc / "ingp_train_tc.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag}:\n{proc.stderr[-3000:]}")
    names = r"(ingp_tc_kernel|feat_tc_kernel|ingp_tc_reduce_kernel)(ILi\d+)?"
    lines = proc.stderr.splitlines()
    for i, line in enumerate(lines):
        found = re.search(names, line) if "Compiling entry" in line else None
        if found:
            report = [x.strip() for x in lines[i + 1:i + 4] if "registers" in x or "spill" in x]
            print(f"[ptxas] {tag} {found.group(0)}: {' | '.join(report)}", flush=True)
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(cubin)], capture_output=True,
                          text=True).stdout
    kernels = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        head, rest = body.split("\n", 1)
        ins = [re.sub(r"c\[0x0\]\[[^\]]*\]", "c[0x0][P]", m.group(1))
               for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s*(.*?);", rest)]
        kernels[re.search(names, head).group(0)] = ins
    return kernels


def _compare_tile_kernels(base: Path, head: Path) -> None:
    if not all((r / "nerf_meets_mlx_torch" / "csrc" / "ingp_train_tc.cu").exists()
               for r in (base, head)):
        return
    a, b = _tile_kernels(base, "base"), _tile_kernels(head, "head")
    for k in sorted(set(a) & set(b)):
        x, y = a[k], b[k]
        apart = [(u, v) for u, v in zip(x, y) if u != v]
        print(f"[sass] {k}: base {len(x)} instructions, head {len(y)}; "
              f"{len(apart) + abs(len(x) - len(y))} apart"
              + "".join(f"; {u} | {v}" for u, v in apart[:3]), flush=True)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--base", required=True, help="the other checkout's root")
    p.add_argument("--head", default=str(HEAD), help="this checkout's root (default)")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    a = p.parse_args()
    if a.worker:
        worker()
        return 0
    turns = []
    for tag, root in (("base", a.base), ("head", a.head), ("head", a.head), ("base", a.base)):
        env = dict(os.environ, PYTHONPATH=str(Path(root).resolve()))
        proc = subprocess.run([sys.executable, __file__, "--worker", "--base", a.base],
                              cwd=root, env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-6000:], file=sys.stderr)
            return 1
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"turn": tag, "ms": times}), flush=True)
        turns.append((tag, times))
    for key in turns[0][1]:
        row = " ".join(f"{t}={d[key]:.4f}" for t, d in turns)
        print(f"{key:18s} {row}", flush=True)
    sys.path.insert(0, str(HEAD))
    _compare_tile_kernels(Path(a.base).resolve(), Path(a.head).resolve())
    return 0


if __name__ == "__main__":
    sys.exit(main())
