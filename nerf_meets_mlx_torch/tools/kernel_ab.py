"""Times the fused kernels of two checkouts of the port in turns, on one card.

    python nerf_meets_mlx_torch/tools/kernel_ab.py --base <checkout> [--head <checkout>]

``--head`` defaults to the checkout this file is in. With ``--hash R`` a
turn times the hash forward's calls alone (``hash_worker``), in R rounds
alternating as ``--frames`` does. With ``--frames R`` a
turn times the host-bound end-to-end metrics alone: the lego_hierarchical
400 x 400 frame (5 frames after one), lego_occ's warm steps on both routes
and its frame with the grid, and the warm image step, as the full turn
times them; in R rounds of base, head, head, base, every second round
head, base, base, head, so that neither checkout always takes the middle
turns, and nothing else runs. Each turn is a fresh
process with that checkout first on ``PYTHONPATH``; the turns run base,
head, head, base, so that a drift of the card shows as a difference between
a checkout's two turns. A turn builds the kernels it times (all builds
started together), then times with CUDA events, at the main paths' shapes:
the INGP eval and train kernels (lego_ingp, 4096 rays / 32,768-ray chunks, 48
and 96 samples), the hash forward and forward + dG (lego_ingp's 196,608 /
393,216 points), the forward alone (``hash_fwd_device_*``: its kernel's
device time at the grid update's 262,144 cell points, lego_ingp's, the
long-ray route's 524,288 / 1,572,864 and the long-ray frame's chunks,
4,194,304 / 12,582,912, in ray order) and the dG kernel alone
(``hash_bwd_*``, also at the long-ray route's batches;
``hash_bwd_device_*`` its device time, the zeroing of dG included), the
long-ray route's 400 x 400 frame (``long_ray_frame``, and its device time,
``long_ray_frame_device``), the sinusoidal eval and train kernels
(lego_hierarchical, 8 x 256),
the MLP forward at lego_occ's three shapes (the grid update's 262,144 cell
points, a step's 4096 x 32 and 4096 x 96 points; also its device time and
the call's host time), the MLP backward at the coarse and fine ones (a
call's device time, host time and kernel launches: ``mlp_bwd_*``) and
forward + backward at the fine one, the feat
train kernel (the paper tables' 32 channels) and the image kernels
(image2d); and a 400 x 400 frame of lego_ingp and of lego_hierarchical;
the INGP, feat and image train calls' device time (every kernel they
launch, from torch.profiler: the host-bound calls read their kernels here,
not in their event time), and the INGP eval call's at both levels of its
32,768-ray chunk; the image train and forward calls' host time (the host
clock around the call, a synchronize before each) and the forward call's
device time and device events (its launches and copies) at the 160,000
pixels of a 400 x 400 frame; the paper tables' warm train step
(the feats route, 32 steps, as chip_smoke.py times it) and the long-ray
overlay's (128 + 256 samples, 10 steps), the warm image step
(50 steps of 4096 pixels, as chip_smoke.py's phase_image_timing), and
lego_occ's warm step on the fused-train and the value_and_grad route (32
steps, two grid updates inside, as phase_occ_timing) and its frame with the
grid. It prints one JSON line per turn and each measurement's four times;
then ptxas's registers and spills of every kernel of
``csrc/fused_train.cu``, ``csrc/fused_mlp.cu``, ``csrc/mlp_fwd_tc.cu``,
``csrc/mlp_bwd_tc.cu``, ``csrc/fused_image.cu``, ``csrc/image_fwd_tc.cu``,
``csrc/image_train_tc.cu``, ``csrc/ingp_eval_tc.cu``,
``csrc/fused_ingp.cu``'s runtime-shape build and ``csrc/hash_encode.cu``
in each checkout that has the source, and, where both checkouts have
``csrc/ingp_train_tc.cu`` (or ``csrc/mlp_bwd_tc.cu``, or
``csrc/hash_encode.cu``: its dG and dX kernels), each kernel of it in
both: ptxas's report and its SASS instruction by instruction (the kernel
parameters' constant-bank offsets masked), as lines starting with
``[ptxas]`` and ``[sass]``; and the count of ``HGMMA`` instructions in
each kernel of each checkout's ``csrc/mlp_bwd_tc.cu`` (``[hgmma]``).
"""

from __future__ import annotations

import argparse
import dataclasses
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


def _device_ms(fn, n=10, events=False):
    """Device ms a call of everything ``fn`` launches (torch.profiler); with
    ``events``, also the device events (launches and copies) a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us, count = 0.0, 0
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            t = getattr(e, "self_device_time_total", None)
            us += float(getattr(e, "self_cuda_time_total", 0.0) if t is None else t)
            count += 1
    return (us / 1e3 / n, count / n) if events else us / 1e3 / n


def _hash_step_ms(cfg, n):
    """Host ms a warm train step of a lego_ingp config on the feats route on
    the 400 x 400 procedural scene, over ``n`` steps ending in one
    synchronize (as chip_smoke.py's phase_feats_e2e takes them)."""
    import time

    import torch

    from nerf_meets_mlx_torch.datasets.synthetic import make_synthetic_scene
    from nerf_meets_mlx_torch.engine import TrainState, make_nerf_train_step
    from nerf_meets_mlx_torch.models import create_nerf

    dev = torch.device("cuda", 0)
    ds = make_synthetic_scene(2, 1, 1, 400, device=dev)
    model = create_nerf(cfg.replace(use_fused_kernel=True), device=dev)
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


def _paper_step_ms(n=32):
    """The paper tables' warm step (16 levels of 2^19 x 2, 512 finest)."""
    import dataclasses

    from nerf_meets_mlx_torch.config import lego_ingp

    cfg = lego_ingp()
    return _hash_step_ms(cfg.replace(pos_encoding=dataclasses.replace(
        cfg.pos_encoding, hash_n_levels=16, hash_log2_table_size=19, hash_max_res=512)), n)


def _long_step_ms(n=10):
    """The long-ray overlay's warm step (128 + 256 samples: the hash
    forward and dG kernels and the feat train kernel a level)."""
    import dataclasses

    from nerf_meets_mlx_torch.config import lego_ingp

    cfg = lego_ingp()
    return _hash_step_ms(cfg.replace(render=dataclasses.replace(
        cfg.render, n_samples=128, n_importance=256)), n)


def _occ_ms(n=32):
    """lego_occ on the 400 x 400 procedural scene: host ms a warm train step
    on the fused-train route and on ``use_fused_train=False`` (the
    value_and_grad route: the MLP forward and backward kernels), over ``n``
    steps ending in one synchronize with the grid updated every 16 steps
    (the preset's cadence), and the lesser of two 400 x 400 frames with the
    grid of the fused-train run."""
    import time

    import numpy as np
    import torch

    from nerf_meets_mlx_torch.acceleration.occupancy import init_occupancy_grid
    from nerf_meets_mlx_torch.cameras.pose import orbit_poses
    from nerf_meets_mlx_torch.config import lego_occ
    from nerf_meets_mlx_torch.datasets.synthetic import CAMERA_ANGLE_X, make_synthetic_scene
    from nerf_meets_mlx_torch.engine import TrainState, make_nerf_train_step
    from nerf_meets_mlx_torch.models import create_nerf
    from nerf_meets_mlx_torch.rendering import render_image

    dev = torch.device("cuda", 0)
    ds = make_synthetic_scene(2, 1, 1, 400, device=dev)
    images = torch.as_tensor(ds.images[ds.i_train], device=dev)
    poses = torch.as_tensor(ds.poses[ds.i_train, :3, :4], device=dev)
    base = lego_occ().replace(use_fused_kernel=True)
    out = {}
    for route, cfg in (("fused_train", base), ("value_and_grad", base.replace(use_fused_train=False))):
        model = create_nerf(cfg, device=dev)
        model.init(torch.Generator(device=dev).manual_seed(0))
        state = TrainState(model, cfg.train,
                           occ_grid=init_occupancy_grid(cfg.render.occ_resolution, device=dev))
        step = make_nerf_train_step(model, ds.H, ds.W, ds.focal)
        gen = torch.Generator(device=dev).manual_seed(27)
        for _ in range(3):
            step(state, images, poses, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step(state, images, poses, gen)
        torch.cuda.synchronize()
        out[f"lego_occ_step_{route}"] = (time.perf_counter() - t0) / n * 1e3
        if route == "fused_train":
            focal = 0.5 * 400 / np.tan(0.5 * CAMERA_ANGLE_X)
            K = np.array([[focal, 0, 200], [0, focal, 200], [0, 0, 1]], np.float32)
            times = []
            with torch.no_grad():
                for _ in range(2):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    render_image(model, 400, 400, K, orbit_poses(160)[0][:3, :4],
                                 occ_grid=state.occ_grid)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
            out["lego_occ_frame"] = min(times)
        del model, state
        torch.cuda.empty_cache()
    return out


def _host_ms(fn, n=20):
    """Median host ms of a call of ``fn``, a synchronize before each."""
    import time

    import torch

    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return sorted(times)[n // 2]


def _image_step_ms(n=50):
    """Host ms a warm image2d train step (4096 pixels of the 400 x 400 test
    image, the fused route), over ``n`` steps ending in one synchronize."""
    import time

    import torch

    from nerf_meets_mlx_torch.config import image2d
    from nerf_meets_mlx_torch.datasets.image import make_test_image, pixel_dataset
    from nerf_meets_mlx_torch.engine import TrainState, make_image_train_step
    from nerf_meets_mlx_torch.models import create_nerf

    dev = torch.device("cuda", 0)
    coords, colors = (torch.as_tensor(a, device=dev) for a in pixel_dataset(make_test_image(400)))
    model = create_nerf(image2d().replace(use_fused_kernel=True), device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    state = TrainState(model, model.cfg.train)
    step = make_image_train_step(model)
    gen = torch.Generator(device=dev).manual_seed(26)
    for _ in range(5):
        step(state, coords, colors, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step(state, coords, colors, gen)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def _build_all():
    """Every build the turn times, all started together (where the
    checkout's ``_build`` takes per-shape defines: the builds of lego_ingp's
    and the paper tables' shapes; and the INGP kernels' own sources where
    the checkout has them)."""
    from concurrent.futures import ThreadPoolExecutor

    from nerf_meets_mlx_torch.kernels import _build

    jobs = [(n, None) for n in ("fused_eval", "fused_train", "fused_mlp", "mlp_fwd_tc",
                                "mlp_bwd_tc", "hash_encode", "fused_image", "image_fwd_tc",
                                "image_train_tc")
            if (_build.CSRC / f"{n}.cu").exists()]
    if hasattr(_build, "variant_name"):
        import inspect

        from nerf_meets_mlx_torch.kernels import fused_feat_train, fused_ingp_train

        jobs.append(("fused_feat", fused_feat_train.kernel_defines(64, 32)))
        if hasattr(fused_ingp_train, "eval_build"):  # the INGP eval kernel's own source
            jobs.append(fused_ingp_train.eval_build(64, 2, 8, 2, 25))
        else:
            # kernel_defines takes (width, levels, features), or (width,
            # L·F) in checkouts that predate the runtime-shape build
            ingp = fused_ingp_train.kernel_defines
            n_args = len(inspect.signature(ingp).parameters)
            jobs.append(("fused_ingp", ingp(64, 8, 2) if n_args == 3 else ingp(64, 16)))
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


def _frame_setup():
    """(the rays' camera K, the 400 x 400 resolution) of the timed frames."""
    import numpy as np

    from nerf_meets_mlx_torch.datasets.synthetic import CAMERA_ANGLE_X

    res = 400
    focal = 0.5 * res / np.tan(0.5 * CAMERA_ANGLE_X)
    return np.array([[focal, 0, res / 2], [0, focal, res / 2], [0, 0, 1]], np.float32), res


def _hash_fwd_device(enc, level, ro, rd, g):
    """The hash forward alone (its kernel's device time, ``hash_fwd_device_*``)
    at the seven batches the main paths give it: the grid update's cell
    points, lego_ingp's train batches, the long-ray route's and the long-ray
    frame's chunks (32,768 rays), in ray order; ``level(R, S)`` gives the
    depths."""
    import torch

    from nerf_meets_mlx_torch.acceleration.occupancy import _cell_points
    from nerf_meets_mlx_torch.config import lego_ingp_occ
    from nerf_meets_mlx_torch.kernels import hash_encode as he

    dev = ro.device
    rcfg = lego_ingp_occ().render
    sets = [("grid", _cell_points(rcfg.occ_resolution, torch.tensor(rcfg.aabb[:3], device=dev),
                                  torch.tensor(rcfg.aabb[3:], device=dev), generator=g))]
    for name, R, S in (("coarse", 4096, 48), ("fine", 4096, 96), ("long_coarse", 4096, 128),
                       ("long_fine", 4096, 384), ("frame_coarse", 32768, 128),
                       ("frame_fine", 32768, 384)):
        z, _, _ = level(R, S)
        sets.append((name, (ro[:R, None] + z[..., None] * rd[:R, None]).reshape(-1, 3)))
    return {f"hash_fwd_device_{name}": _device_ms(lambda pts=pts: he._fwd_launch(enc, pts),
                                                  n=max(5, int(4_000_000 // len(pts))))
            for name, pts in sets}


def hash_worker():
    """``--hash``' turn: the hash forward at the seven batches
    (``_hash_fwd_device``), and the forward and the forward + dG through
    ``hash_encode_apply`` at lego_ingp's 4096 x 48 / 96 points: a call's
    event time and its device time (every kernel it launches), as
    ``worker`` times them; only csrc/hash_encode.cu is built."""
    import torch

    from nerf_meets_mlx_torch.cameras.pose import orbit_poses
    from nerf_meets_mlx_torch.cameras.rays import get_rays
    from nerf_meets_mlx_torch.config import lego_ingp
    from nerf_meets_mlx_torch.kernels import _build
    from nerf_meets_mlx_torch.kernels import hash_encode as he
    from nerf_meets_mlx_torch.models import create_nerf

    _build.build("hash_encode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    K, res = _frame_setup()
    ro, rd = get_rays(res, res, K, orbit_poses(160)[0][:3, :4], device=dev)
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)

    def level(n_rays, S):
        z = torch.sort(torch.rand((n_rays, S), generator=g, device=dev) * 4.0 + 2.0, -1).values
        return z, None, None

    m = create_nerf(lego_ingp().replace(use_fused_kernel=True), device=dev)
    m.init(torch.Generator(device=dev).manual_seed(0))
    out = _hash_fwd_device(m.pos_enc, level, ro, rd, g)
    for name, S in (("coarse", 48), ("fine", 96)):
        z, _, _ = level(4096, S)
        pts = (ro[:4096, None] + z[..., None] * rd[:4096, None]).reshape(-1, 3)
        dout = torch.randn((pts.shape[0], m.pos_enc.out_dim), generator=g, device=dev)

        def fwd(pts=pts):
            he.hash_encode_apply(m.pos_enc, pts)

        def fwd_bwd(pts=pts, dout=dout):
            (he.hash_encode_apply(m.pos_enc, pts) * dout).sum().backward()

        out[f"hash_fwd_{name}"] = _ms(fwd)
        out[f"hash_fwd_bwd_{name}"] = _ms(fwd_bwd)
        out[f"hash_fwd_bwd_device_{name}"] = _device_ms(fwd_bwd)
        out[f"hash_fwd_bwd_host_{name}"] = _host_ms(fwd_bwd)
    print(json.dumps(out), flush=True)


def frames_worker():
    """``--frames``' turn: the lego_hierarchical frame over 5 frames,
    lego_occ's steps and frame (``_occ_ms``) and the image step
    (``_image_step_ms``), as ``worker`` times them."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from nerf_meets_mlx_torch.cameras.pose import orbit_poses
    from nerf_meets_mlx_torch.config import lego_hierarchical
    from nerf_meets_mlx_torch.kernels import _build
    from nerf_meets_mlx_torch.models import create_nerf
    from nerf_meets_mlx_torch.rendering import render_image

    torch.backends.cuda.matmul.allow_tf32 = False
    names = ("fused_eval", "fused_train", "mlp_fwd_tc", "mlp_bwd_tc", "image_train_tc")
    with ThreadPoolExecutor(len(names)) as ex:
        for f in [ex.submit(_build.build, n) for n in names]:
            f.result()
    K, res = _frame_setup()
    m = create_nerf(lego_hierarchical().replace(use_fused_kernel=True), device=torch.device("cuda"))
    m.init(torch.Generator(device=torch.device("cuda")).manual_seed(0))
    with torch.no_grad():
        out = {"lego_hierarchical_frame": _ms(
            lambda: render_image(m, res, res, K, orbit_poses(160)[0][:3, :4]), n=5)}
    del m
    torch.cuda.empty_cache()
    out.update(_occ_ms())
    out["image_step"] = _image_step_ms()
    print(json.dumps(out), flush=True)


def worker():
    import torch

    from nerf_meets_mlx_torch.acceleration.occupancy import _cell_points
    from nerf_meets_mlx_torch.cameras.pose import orbit_poses
    from nerf_meets_mlx_torch.cameras.rays import get_rays
    from nerf_meets_mlx_torch.config import image2d, lego_hierarchical, lego_ingp, lego_occ
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
    K, res = _frame_setup()
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
            def ingp_eval(z=z, dl=dl, espec=espec):
                return fi.fused_ingp_eval_apply(m.fine, m.pos_enc, sh[:32768], espec, ro[:32768],
                                                rd[:32768], z, dl)

            out[f"ingp_eval_{name}"] = _ms(ingp_eval, n=10)
            out[f"ingp_eval_device_{name}"] = _device_ms(ingp_eval, n=10)
    out.update(_hash_fwd_device(m.pos_enc, level, ro, rd, g))
    # the hash dG kernel alone at the batches of its two routes
    for name, S in (("coarse", 48), ("fine", 96), ("long_coarse", 128), ("long_fine", 384)):
        z, _, _ = level(4096, S)
        pts = (ro[:4096, None] + z[..., None] * rd[:4096, None]).reshape(-1, 3)
        dout = torch.randn((pts.shape[0], m.pos_enc.out_dim), generator=g, device=dev)

        def hash_bwd(pts=pts, dout=dout):
            he._bwd_launch(m.pos_enc, pts, dout)

        out[f"hash_bwd_{name}"] = _ms(hash_bwd)
        out[f"hash_bwd_device_{name}"] = _device_ms(hash_bwd)
    with torch.no_grad():
        out["lego_ingp_frame"] = _ms(lambda: render_image(m, res, res, K, orbit_poses(160)[0][:3, :4]),
                                     n=5)
    # the long-ray route's frame (the standard query: the hash forward, 10
    # launches a frame), its time and its device time
    cfg = lego_ingp()
    m = create_nerf(cfg.replace(use_fused_kernel=True, render=dataclasses.replace(
        cfg.render, n_samples=128, n_importance=256)), device=dev)
    m.init(torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        def long_frame():
            render_image(m, res, res, K, orbit_poses(160)[0][:3, :4])

        out["long_ray_frame"] = _ms(long_frame, n=3)
        out["long_ray_frame_device"] = _device_ms(long_frame, n=2)
    del m
    torch.cuda.empty_cache()

    # sinusoidal kernels at lego_hierarchical
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
    # the MLP kernels at lego_occ's shapes: the grid update's cell points
    # (zero directions) and a step's coarse and fine points
    m = create_nerf(lego_occ().replace(use_fused_kernel=True), device=dev)
    m.init(torch.Generator(device=dev).manual_seed(0))
    rc = m.cfg.render
    cells = _cell_points(rc.occ_resolution, torch.tensor(rc.aabb[:3], device=dev),
                         torch.tensor(rc.aabb[3:], device=dev), generator=g)
    sets = [("grid", m.fine, cells, torch.zeros_like(cells))]
    for name, S, mlp in (("coarse", 32, m.coarse), ("fine", 96, m.fine)):
        z, _, _ = level(4096, S)
        pts = (ro[:4096, None] + z[..., None] * rd[:4096, None]).reshape(-1, 3)
        sets.append((name, mlp, pts, vd[:4096, None].expand(-1, S, -1).reshape(-1, 3).contiguous()))
    for name, mlp, pts, dirs in sets:
        def mlp_fwd(mlp=mlp, pts=pts, dirs=dirs):
            with torch.no_grad():
                return fm.fused_mlp_apply(mlp, m.pos_enc, m.dir_enc, pts, dirs)

        out[f"mlp_fwd_{name}"] = _ms(mlp_fwd, n=10)
        out[f"mlp_fwd_device_{name}"] = _device_ms(mlp_fwd)
        out[f"mlp_fwd_host_{name}"] = _host_ms(mlp_fwd)
    for name, mlp, p, d in sets[1:]:
        dz = torch.randn((p.shape[0], 4), generator=g, device=dev)

        def mlp_bwd(mlp=mlp, p=p, d=d, dz=dz):
            fm._bwd_launch(mlp, m.pos_enc, m.dir_enc, p, d, dz, False)

        out[f"mlp_bwd_{name}"] = _ms(mlp_bwd, n=5)
        out[f"mlp_bwd_device_{name}"], out[f"mlp_bwd_launches_{name}"] = _device_ms(
            mlp_bwd, n=5, events=True)
        out[f"mlp_bwd_host_{name}"] = _host_ms(mlp_bwd, n=10)
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
    with torch.no_grad():
        out["image_train_device"] = _device_ms(
            lambda: fim.fused_image_train(m.coarse, m.pos_enc, xy, target))
        out["image_train_host"] = _host_ms(
            lambda: fim.fused_image_train(m.coarse, m.pos_enc, xy, target))
    grid = torch.rand((160_000, 2), generator=g, device=dev)
    with torch.no_grad():
        out["image_fwd"] = _ms(lambda: fim.fused_image_apply(m.coarse, m.pos_enc, grid))
        out["image_fwd_device"], out["image_fwd_launches"] = _device_ms(
            lambda: fim.fused_image_apply(m.coarse, m.pos_enc, grid), events=True)
        out["image_fwd_host"] = _host_ms(lambda: fim.fused_image_apply(m.coarse, m.pos_enc, grid))
    out["paper_step"] = _paper_step_ms()
    out["long_ray_step"] = _long_step_ms()
    out["image_step"] = _image_step_ms()
    out.update(_occ_ms())
    print(json.dumps(out), flush=True)


def _cubin(root: Path, tag: str, source: str, defines=()):
    """Compiles ``root``'s csrc/<source>.cu (with the ``-D`` flags
    ``defines``) to a cubin with the build's flags and prints ptxas's
    registers and spills of each of its kernels (``[ptxas]``); returns the
    cubin's path."""
    from nerf_meets_mlx_torch.kernels import _build

    csrc = root / "nerf_meets_mlx_torch" / "csrc"
    out_dir = HEAD / ".runs" / "kernel_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    cubin = out_dir / f"{tag}_{source}.cubin"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    proc = subprocess.run([_build._nvcc(), *flags, *defines, "-cubin", "-I", str(csrc), "-o",
                           str(cubin), str(csrc / f"{source}.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag} {source}:\n{proc.stderr[-3000:]}")
    lines = proc.stderr.splitlines()
    for i, line in enumerate(lines):
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            report = [x.strip() for x in lines[i + 1:i + 4] if "registers" in x or "spill" in x]
            print(f"[ptxas] {tag} {source} {found.group(1)}: {' | '.join(report)}", flush=True)
    return cubin


def _ptxas_reports(base: Path, head: Path) -> None:
    """[ptxas] of the sinusoidal train, the MLP, the image and the INGP eval
    sources in both checkouts (each that has the source; csrc/fused_ingp.cu
    as its runtime-shape build, with ``-DINGP_W=0 -DINGP_PP=0`` where the
    source still has the register builds), all compiled together."""
    from concurrent.futures import ThreadPoolExecutor

    jobs = []
    for source in ("fused_train", "fused_mlp", "mlp_fwd_tc", "mlp_bwd_tc", "fused_image",
                   "image_fwd_tc", "image_train_tc", "ingp_eval_tc", "fused_ingp", "hash_encode"):
        for tag, root in (("base", base), ("head", head)):
            cu = root / "nerf_meets_mlx_torch" / "csrc" / f"{source}.cu"
            if cu.exists():
                rt = source == "fused_ingp" and "INGP_W" in cu.read_text()
                jobs.append((root, tag, source, ("-DINGP_W=0", "-DINGP_PP=0") if rt else ()))
    with ThreadPoolExecutor(len(jobs)) as ex:
        for f in [ex.submit(_cubin, *job) for job in jobs]:
            f.result()


# the kernels whose SASS the two checkouts compare, by source
SASS_KERNELS = {
    "ingp_train_tc": r"(ingp_tc_kernel|feat_tc_kernel|ingp_tc_reduce_kernel)(ILi\d+)?",
    "mlp_bwd_tc": r"(?<=\d)mlp_bwd_(tile|dw|pack|reduce)_kernel(ILi\d+)?",
    "hash_encode": r"hash_(bwd|dx_bwd)_kernelILi\d+E(Li\d+E)?",
}


def _tile_kernels(root: Path, tag: str, source: str):
    """ptxas's report and the SASS of each kernel of ``root``'s
    csrc/<source>.cu that ``SASS_KERNELS`` names: {kernel: [instructions,
    constant-bank offsets masked]}."""
    from nerf_meets_mlx_torch.kernels import _build

    names = SASS_KERNELS[source]
    cubin = HEAD / ".runs" / "kernel_ab" / f"{tag}_{source}.cubin"  # _ptxas_reports' build
    if not cubin.exists():
        cubin = _cubin(root, tag, source)
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(cubin)], capture_output=True,
                          text=True).stdout
    kernels = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        head, rest = body.split("\n", 1)
        found = re.search(names, head)
        if found is None:
            continue
        ins = [re.sub(r"c\[0x0\]\[[^\]]*\]", "c[0x0][P]", m.group(1))
               for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s*(.*?);", rest)]
        kernels[found.group(0)] = ins
    return kernels


def _compare_tile_kernels(base: Path, head: Path, source: str) -> None:
    if not all((r / "nerf_meets_mlx_torch" / "csrc" / f"{source}.cu").exists()
               for r in (base, head)):
        return
    a, b = _tile_kernels(base, "base", source), _tile_kernels(head, "head", source)
    for k in sorted(set(a) & set(b)):
        x, y = a[k], b[k]
        apart = [(u, v) for u, v in zip(x, y) if u != v]
        print(f"[sass] {k}: base {len(x)} instructions, head {len(y)}; "
              f"{len(apart) + abs(len(x) - len(y))} apart"
              + "".join(f"; {u} | {v}" for u, v in apart[:3]), flush=True)


def _hgmma_counts(root: Path, tag: str) -> None:
    """[hgmma]: the HGMMA instructions of each kernel of ``root``'s
    csrc/mlp_bwd_tc.cu and the first one's text, where it has the source."""
    if not (root / "nerf_meets_mlx_torch" / "csrc" / "mlp_bwd_tc.cu").exists():
        return
    for k, ins in sorted(_tile_kernels(root, tag, "mlp_bwd_tc").items()):
        hg = [i for i in ins if i.startswith("HGMMA")]
        print(f"[hgmma] {tag} {k}: {len(hg)} of {len(ins)} instructions"
              + (f"; {hg[0]}" if hg else ""), flush=True)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--base", required=True, help="the other checkout's root")
    p.add_argument("--head", default=str(HEAD), help="this checkout's root (default)")
    p.add_argument("--frames", type=int, default=0,
                   help="rounds timing the host-bound frames and steps alone, the order "
                        "alternating (base, head, head, base; head, base, base, head)")
    p.add_argument("--hash", type=int, default=0,
                   help="rounds timing the hash forward's calls alone, alternating as --frames")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    a = p.parse_args()
    if a.worker:
        hash_worker() if a.hash else frames_worker() if a.frames else worker()
        return 0
    turns = []
    order = (("base", a.base), ("head", a.head), ("head", a.head), ("base", a.base))
    flipped = (order[1], order[0], order[3], order[2])
    rounds = max(a.frames, a.hash, 1)
    for tag, root in [t for r in range(rounds) for t in (flipped if r % 2 else order)]:
        env = dict(os.environ, PYTHONPATH=str(Path(root).resolve()))
        proc = subprocess.run([sys.executable, __file__, "--worker", "--base", a.base,
                               "--frames", str(a.frames), "--hash", str(a.hash)],
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
    if a.frames or a.hash:
        return 0
    sys.path.insert(0, str(HEAD))
    _ptxas_reports(Path(a.base).resolve(), Path(a.head).resolve())
    for source in SASS_KERNELS:
        _compare_tile_kernels(Path(a.base).resolve(), Path(a.head).resolve(), source)
    for tag, root in (("base", a.base), ("head", a.head)):
        _hgmma_counts(Path(root).resolve(), tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
