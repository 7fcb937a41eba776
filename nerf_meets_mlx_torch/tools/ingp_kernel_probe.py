"""Where the INGP train launch's (or the eval call's) time goes, on one card.

    python nerf_meets_mlx_torch/tools/ingp_kernel_probe.py [--base <parent checkout>] [--no-head]
    python nerf_meets_mlx_torch/tools/ingp_kernel_probe.py --feat [--base <parent checkout>] [--no-head]
    python nerf_meets_mlx_torch/tools/ingp_kernel_probe.py --eval [--base <parent checkout>] [--no-head]

Each part runs in a process of its own, with its checkout first on
``PYTHONPATH``, at lego_ingp's train-step shapes (2 x 64 MLP over 8 levels x
2^14 x 2 hash features and 16 SH channels; 4096 rays of a 400 x 400 view, 48
and 96 samples, tables with N(0, 0.1) added, unit density noise), and prints
lines starting with ``[parent]``, ``[time]`` or ``[ptxas]``:

* ``[parent]`` (with ``--base``): the other checkout's
  ``fused_ingp_train_apply`` per level: the launch's ms (CUDA events), the
  device ms of each of its kernels (``ingp_rays_kernel``, ``dw_gemm_kernel``,
  ``reduce_kernel``) and of the wrapper's own torch ops (torch.profiler),
  and the wrapper's host ms a call (the host clock around the calls, no
  synchronize between them).
* ``[time]``: the same for this checkout's kernel (``csrc/ingp_train_tc.cu``,
  through ``fused_ingp_train_apply``) and its variants, each built here
  from the same source with one ``-D`` flag and launched through
  ``_tc_launch(..., lib=<the variant>)``: ``no_atomics`` (dG not written),
  ``no_mma`` (every tensor-core product skipped), ``no_hash`` (features
  zero, no table lookups), which compute wrong results and only time.
* ``[phases]``: the ``clocks`` variant's cycles per tile of each phase of
  the kernel (block 0's tiles, thread 0's clock between the barriers), and
  each phase's share; then the same with every product skipped
  (``clocks_no_mma``).
* ``[ptxas]``: registers, spill bytes and shared memory of the kernel's
  build.
* ``[rate]``: ``mma.sync`` m16n8k8 TF32 on register operands, 12 warps an
  SM (the kernel's block), with 1, 2, 4, 8 and 16 independent accumulators
  a warp (chains of dependent mmas): TFLOP/s.
* ``[forms]``: the products of 64-row tiles with one 64 x 64 weight in
  3xTF32 (lego_ingp's trunk and feature layers) at the coarse and fine
  batches (196,608 and 393,216 points), A from fp32 activations in shared
  memory split in registers, one block of 12 warps an SM, in three forms:
  ``mma`` (the kernel's: a warp pair per 16-row tile, B split at every
  k-step from one fp32 copy of the weight, each k-step's products summed
  from zero and added in fp32), ``wgmma`` (a warpgroup per 64-row tile,
  m64n64k8 with B from hi/lo TF32 images in shared memory, a whole layer
  in the accumulator, as csrc/fused_eval.cu) and ``wgmma_kstep`` (the
  same, each k-step's products summed from zero and added in fp32, the
  precision the train kernel's chain needs); each in the forward (B =
  W^T) and the cotangent direction (B = W). ms a layer (the time of 9
  chained layers a tile less that of 1, over 8), against the 3xTF32
  bound, and each form's error against float64.
* ``[acc]`` (on the host): how far a 64 x 64 fp32 layer product lands from
  the exact one (float64) on 20,000 random relu rows, as torch sums it in
  fp32 and as the kernel's 3xTF32 products sum it, a whole layer in the
  truncating accumulator or per k-step added in fp32: the mean and largest
  absolute error, and the mean signed error.
* ``[f64]``: the checkout's kernel (the parent's too, with ``--base``),
  the fp32 plain version and, on the head, ``one_pass`` (the kernel built
  with every split's lo half zero: one TF32 product, a lower-precision
  control) against the plain version in float64, per level, every
  gradient array: the largest error over the array's largest float64
  value; the kernel's against the fp32 plain version's; and the entries of
  W0 and dG further than 1e-5 of the array's largest plain value from it.

With ``--draws N`` it prints only ``[draws]``: the gradient check of
``tests/test_torch_fused_ingp.py::test_cuda_tc_train_kernel_matches_plain``
over N draws of the tables' N(0, 0.1) noise (seeds 1 .. N; the test's
rays, 1,001 of S = 96 and 48, both compositing modes, the white background
on and off): max |dG - plain| / max |plain dG| for this checkout's kernel
and for csrc/fused_ingp.cu's runtime-shape build (the parent's
thread-per-point design), and the largest dG and alpha-head dW errors of
each and of the fp32 plain version against float64. With ``--draws N
--draws-width W`` it prints ``[draws-rt]`` instead: the gradient check of
``test_cuda_ingp_kernels_match_plain_at_new_shapes`` at width W (the
runtime-shape build of ``csrc/fused_ingp.cu`` past width 64) over N table
draws: per draw whether the test's criteria hold, and per gradient array
the kernel's and the fp32 plain version's distance from float64.

With ``--feat`` it probes the feat train launch instead
(``fused_feat_train_apply``), at the "feats" route's shapes on the
Instant-NGP paper's tables (lego_ingp with 16 levels x 2^19 x 2: P = 32
feature channels from the plain encode of each level's points, 25 SH
channels, canonical compositing, white background; the same rays, levels
and noise): ``[parent]`` splits the other checkout's launch into
``feat_rays_kernel``, ``dw_gemm_kernel``, ``reduce_kernel``, the wrapper's
torch ops and its host time a call; ``[time]`` gives this checkout's
launch (``feat_tc_kernel`` in ``csrc/ingp_train_tc.cu`` where the router
sends the shape) and its ``no_mma`` variant, ``[phases]`` its phase clocks
(the x load in place of the points, the view layer's SH term in place of
the features, the dfeats store in place of the scatter), ``[ptxas]`` the
build's report. No ``[rate]``, ``[forms]``, ``[acc]`` or ``[f64]``.

With ``--long-rays`` it prints only ``[long]``: the shapes the tile does
not take, on ``csrc/fused_feat.cu``'s register build that the router
names and on its runtime-shape build (``FEAT_W = FEAT_PP = 0``), in turns
register, runtime, runtime, register in one process: the feat train call
at the long-ray overlay's levels (lego_ingp's 16 channels, 25 SH
channels, 4096 rays of 128 and 384 samples; CUDA events, and its kernels'
device ms), and the overlay's warm train step (lego_ingp with 128 + 256
samples on the fused route, the 400 x 400 procedural scene, 20 steps
ending in one synchronize, as ``chip_smoke.py`` times it). Each turn also
prints its sse beside the register build's first.

With ``--eval`` it probes the INGP eval call instead
(``fused_ingp_eval_apply``), at the serving path's shapes: the first
32,768 rays of a 400 x 400 orbit frame, lego_ingp (48 + 48 samples) and
lego_ingp_occ (32 + 32), the coarse depths of an eval render and the fine
ones importance-sampled from the plain version's coarse weights, tables
with N(0, 0.1) added. Per preset and level, ``[parent]`` (the other
checkout's call) or ``[time]`` (this checkout's): the call's ms (CUDA
events), its kernel's device ms and that of every other launch of the
call (torch.profiler), the device events a call, the host ms a call, the
kernel's timing variants' device ms, and the standalone
``hash_encode_apply`` forward at the chunk's points. The parent's variants
are text edits of its own ``csrc/fused_ingp.cu`` at lego_ingp's register
build (``no_mlp``: the hash features summed into sigma; ``no_hash``: the
features read from the point), this checkout's the ``-D`` builds of
``csrc/ingp_eval_tc.cu`` (``no_mma``: the products skipped; ``no_hash``);
both compute wrong results and only time. ``[ptxas]`` gives the build's
report; ``[frame]`` lego_ingp's 400 x 400 frame: its warm host ms, and
under torch.profiler the device's busy share and the eval kernel's share.

The last line is one JSON object with every number printed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HEAD = Path(__file__).resolve().parents[2]
LEVELS = (("coarse", 48), ("fine", 96))
N_RAYS = 4096
PARENT_KERNELS = ("ingp_rays_kernel", "dw_gemm_kernel", "reduce_kernel")
HEAD_KERNELS = ("ingp_tc_kernel", "ingp_tc_reduce_kernel")
VARIANTS = {
    "kernel": {},
    "no_atomics": {"INGP_TC_NO_ATOMICS": 1},
    "no_mma": {"INGP_TC_NO_MMA": 1},
    "no_hash": {"INGP_TC_NO_HASH": 1},
}
CLOCKS = {"clocks": {"INGP_TC_CLOCKS": 1},
          "clocks_no_mma": {"INGP_TC_CLOCKS": 1, "INGP_TC_NO_MMA": 1}}
PHASES = ("setup", "features", "forward", "composite", "heads dW", "d(hd)", "view dW",
          "d(feature)", "feature dW", "last dZ", "trunk dW", "trunk dZ", "scatter")
# --feat: the feat train launch, its kernels and variants, and the names of
# the phases where they differ from the INGP kernel's
FEAT_PARENT_KERNELS = ("feat_rays_kernel", "dw_gemm_kernel", "reduce_kernel")
FEAT_HEAD_KERNELS = ("feat_tc_kernel", "ingp_tc_reduce_kernel")
FEAT_VARIANTS = {"kernel": {}, "no_mma": {"INGP_TC_NO_MMA": 1}}
FEAT_PHASES = ("x load", "SH term") + PHASES[2:-1] + ("dfeats store",)
PAPER = dict(hash_n_levels=16, hash_log2_table_size=19, hash_max_res=512)
# --long-rays: the overlay's levels (n_samples 128, n_importance 256) and
# csrc/fused_feat.cu's runtime-shape build
LONG_LEVELS = (("coarse", 128), ("fine", 384))
FEAT_RT = {"FEAT_W": 0, "FEAT_PP": 0}


def _inputs(dev, paper=False, level_samples=LEVELS):
    """lego_ingp (seeded init, tables + N(0, 0.1); with ``paper`` the
    Instant-NGP paper's tables) and the rays, sh and per-level (z, deltas,
    noise) of one train step, at ``level_samples``' (name, samples)."""
    import dataclasses

    import numpy as np
    import torch

    from nerf_meets_mlx_torch.cameras.pose import orbit_poses
    from nerf_meets_mlx_torch.cameras.rays import get_rays
    from nerf_meets_mlx_torch.config import lego_ingp
    from nerf_meets_mlx_torch.datasets.synthetic import CAMERA_ANGLE_X
    from nerf_meets_mlx_torch.models import create_nerf

    g = torch.Generator(device=dev).manual_seed(2)
    cfg = lego_ingp().replace(use_fused_kernel=True)
    if paper:
        cfg = cfg.replace(pos_encoding=dataclasses.replace(cfg.pos_encoding, **PAPER))
    m = create_nerf(cfg, device=dev)
    m.init(torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        m.pos_enc.tables.add_(torch.randn(m.pos_enc.tables.shape, generator=g, device=dev) * 0.1)
    res = 400
    focal = 0.5 * res / np.tan(0.5 * CAMERA_ANGLE_X)
    K = np.array([[focal, 0, res / 2], [0, focal, res / 2], [0, 0, 1]], np.float32)
    ro, rd = get_rays(res, res, K, orbit_poses(160)[0][:3, :4], device=dev)
    pick = torch.randperm(res * res, generator=g, device=dev)[:N_RAYS]
    ro, rd = ro.reshape(-1, 3)[pick].contiguous(), rd.reshape(-1, 3)[pick].contiguous()
    dnorm = torch.linalg.vector_norm(rd, dim=-1, keepdim=True)
    sh = m.dir_enc.apply(rd / dnorm)
    target = torch.rand((N_RAYS, 3), generator=g, device=dev)
    levels = {}
    for name, S in level_samples:
        z = torch.sort(torch.rand((N_RAYS, S), generator=g, device=dev) * 4.0 + 2.0, -1).values
        dl = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1) * dnorm
        levels[name] = (z, dl, torch.randn((N_RAYS, S), generator=g, device=dev))
    return m, (ro, rd, sh, target), levels


def _split_ms(call, names, n):
    """Device ms a call of each kernel of ``names`` and of everything else
    the call ran on the device (the wrapper's torch ops), from
    torch.profiler over ``n`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    out = {k: 0.0 for k in names}
    out["torch ops"] = 0.0
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        key = next((k for k in names if k in e.name and "at::" not in e.name), "torch ops")
        out[key] += float(us) / 1e3 / n
    return out


def _event_ms(call, n=20):
    import torch

    call()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        call()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def _host_ms(call, n=10):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / n


def _spec(S):
    from nerf_meets_mlx_torch.kernels import fused_ingp_train as fi
    from nerf_meets_mlx_torch.kernels.fused_train import TrainSpec

    rb = fi.ingp_rays_block(S)
    return TrainSpec(n_samples=S, rays_block=rb, mode="canonical", density_activation="softplus",
                     white_bkgd=True, group=fi.ingp_group(S, rb))


def _variant_lib(defines):
    """A typed build of csrc/ingp_train_tc.cu with ``defines``."""
    from nerf_meets_mlx_torch.kernels import _build
    from nerf_meets_mlx_torch.kernels import fused_ingp_train as fi

    return fi.type_tc_lib(_build.load_library(fi.TC_SOURCE, defines))


def _variant_call(m, rays, level, lib):
    """One train launch of lego_ingp's fine MLP at ``level``: through
    ``fused_ingp_train_apply`` where ``lib`` is None, else straight through
    ``_tc_launch`` with that build. Returns (sse, rgb, weights, grads)."""
    import torch

    from nerf_meets_mlx_torch.kernels import fused_ingp_train as fi

    ro, rd, sh, target = rays
    z, dl, nz = level
    S = z.shape[1]
    if lib is None:
        def call():
            with torch.no_grad():
                return fi.fused_ingp_train_apply(m.fine, m.pos_enc, sh, _spec(S), ro, rd, z, dl,
                                                 nz, target)
        return call
    rpt = fi.tc_rays_per_tile(64, 2, 8, 2, m.fine.in_dim_views, S)  # lego_ingp's shape
    args = (ro, rd, sh, z, dl, nz, target)
    return lambda: fi._tc_launch(m.fine, m.pos_enc, _spec(S), args, rpt, lib)


def _feat_levels(m, rays, levels):
    """Per level the feat op's packed input x (the plain encode's features
    of the level's points, the rays' SH, the deltas and the noise)."""
    import torch

    from nerf_meets_mlx_torch.kernels import fused_feat_train as ff

    ro, rd, sh, _ = rays
    out = {}
    for name, (z, dl, nz) in levels.items():
        with torch.no_grad():
            feats = m.pos_enc.apply(ro[:, None, :] + z[..., None] * rd[:, None, :])
        out[name] = ff.pack_feat_inputs(feats, sh, dl, nz).contiguous()
    return out


def _feat_spec(S):
    from nerf_meets_mlx_torch.kernels import fused_feat_train as ff
    from nerf_meets_mlx_torch.kernels.fused_train import TrainSpec

    rb = ff.feat_rays_block(S)
    return TrainSpec(n_samples=S, rays_block=rb, mode="canonical", density_activation="softplus",
                     white_bkgd=True, group=ff.feat_group(S, rb))


def _feat_call(m, target, x, S, lib):
    """A function that makes one feat train launch of the fine MLP on
    ``x``: through ``fused_feat_train_apply`` where ``lib`` is None, else
    through ``_tc_launch`` with that build of csrc/ingp_train_tc.cu (rgb,
    the second of its results, then holds the clocks variants' cycles)."""
    import torch

    from nerf_meets_mlx_torch.kernels import fused_feat_train as ff

    if lib is None:
        def call():
            with torch.no_grad():
                return ff.fused_feat_train_apply(m.fine, _feat_spec(S), x, target)
        return call
    mlp = m.fine
    rpt = ff.tc_rays_per_tile(mlp.cfg.net_width, mlp.cfg.net_depth, mlp.in_dim, mlp.in_dim_views,
                              S)
    return lambda: ff._tc_launch(mlp, _feat_spec(S), x, target, rpt, lib)


def feat_worker(role: str) -> None:
    """--feat: the parent's split, or this checkout's launch, variants and
    phase clocks, at the paper tables' levels."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from nerf_meets_mlx_torch.kernels import _build
    from nerf_meets_mlx_torch.kernels import fused_feat_train as ff
    from nerf_meets_mlx_torch.kernels import fused_ingp_train as fi

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    libs = {}
    if role == "parent":
        variants, names = {"parent": None}, FEAT_PARENT_KERNELS
        _build.build("fused_feat", ff.kernel_defines(64, 32))
    else:
        variants, names = FEAT_VARIANTS, FEAT_HEAD_KERNELS
        builds = dict(FEAT_VARIANTS, **CLOCKS)
        with ThreadPoolExecutor(len(builds)) as ex:
            for f in [ex.submit(_build.build, fi.TC_SOURCE, d or None) for d in builds.values()]:
                f.result()
        libs.update({k: _variant_lib(d or None) for k, d in builds.items() if d})
        for line in _build.BUILD_LOG.get(_build.variant_name(fi.TC_SOURCE), "").splitlines():
            if any(k in line for k in ("registers", "spill", "smem", "Compiling")):
                print(f"[ptxas] {line.strip()}", flush=True)
    m, rays, levels = _inputs(dev, paper=True)
    target = rays[3]
    xs = _feat_levels(m, rays, levels)
    out = {}
    for variant in variants:
        for name, S in LEVELS:
            if role == "head" and variant == "kernel":
                mlp = m.fine
                print(f"[route] {name} S={S} P={mlp.in_dim} DD={mlp.in_dim_views}: "
                      f"{ff.train_build(64, 2, mlp.in_dim, mlp.in_dim_views, S)[0]}, "
                      f"{ff.tc_rays_per_tile(64, 2, mlp.in_dim, mlp.in_dim_views, S)} rays a tile",
                      flush=True)
            call = _feat_call(m, target, xs[name], S, libs.get(variant))
            ms = _event_ms(call)
            split = _split_ms(call, names, 10)
            host = _host_ms(call)
            out[f"{variant}_{name}"] = dict(ms=ms, host_ms=host, **split)
            tag = "[parent]" if role == "parent" else "[time]"
            print(f"{tag} feat {variant:8s} {name:6s} {N_RAYS} x {S}: {ms:.4f} ms a launch; "
                  "device " + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
                  + f" ms; host {host:.4f} ms a call", flush=True)
    if role == "head":
        phases = {}
        for variant, (name, S) in ((v, lv) for v in CLOCKS for lv in LEVELS):
            rgb = _feat_call(m, target, xs[name], S, libs[variant])()[1]
            clk = rgb.flatten()[: len(FEAT_PHASES)].tolist()
            rpt = ff.tc_rays_per_tile(64, 2, m.fine.in_dim, m.fine.in_dim_views, S)
            n_tiles = -(-N_RAYS // rpt)
            grid = min(n_tiles, torch.cuda.get_device_properties(0).multi_processor_count)
            tiles = len(range(0, n_tiles, grid))
            total = sum(clk)
            phases[f"{variant}_{name}"] = {k: c / tiles for k, c in zip(FEAT_PHASES, clk)}
            print(f"[phases] feat {variant:13s} {name:6s} {tiles} tiles in block 0, "
                  f"{total / tiles:.0f} cycles a tile: "
                  + ", ".join(f"{k} {c / tiles:.0f} ({c / total:.1%})"
                              for k, c in zip(FEAT_PHASES, clk)), flush=True)
        out["phases"] = phases
    print(json.dumps(out), flush=True)


def _long_step(dev):
    """A function that runs one train step of lego_ingp with the long-ray
    overlay (128 + 256 samples: the feats route over the hash kernels) on
    the 400 x 400 procedural scene."""
    import dataclasses

    import torch

    from nerf_meets_mlx_torch.config import lego_ingp
    from nerf_meets_mlx_torch.datasets.synthetic import make_synthetic_scene
    from nerf_meets_mlx_torch.engine import TrainState, make_nerf_train_step
    from nerf_meets_mlx_torch.models import create_nerf

    ds = make_synthetic_scene(2, 1, 1, 400, device=dev)
    cfg = lego_ingp()
    cfg = cfg.replace(use_fused_kernel=True, render=dataclasses.replace(
        cfg.render, n_samples=LONG_LEVELS[0][1],
        n_importance=LONG_LEVELS[1][1] - LONG_LEVELS[0][1]))
    model = create_nerf(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    images = torch.as_tensor(ds.images[ds.i_train], device=dev)
    poses = torch.as_tensor(ds.poses[ds.i_train, :3, :4], device=dev)
    state = TrainState(model, cfg.train)
    step = make_nerf_train_step(model, ds.H, ds.W, ds.focal)
    gen = torch.Generator(device=dev).manual_seed(25)
    return lambda: step(state, images, poses, gen)


def long_worker() -> dict:
    """--long-rays: the overlay's feat call and step on the register build
    the router names and on the runtime-shape build, in turns."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from nerf_meets_mlx_torch.kernels import _build
    from nerf_meets_mlx_torch.kernels import fused_feat_train as ff

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    m, rays, levels = _inputs(dev, level_samples=LONG_LEVELS)
    mlp = m.fine
    register = ff.kernel_defines(mlp.cfg.net_width, mlp.in_dim)
    with ThreadPoolExecutor(2) as ex:
        for f in [ex.submit(_build.build, "fused_feat", d) for d in (register, FEAT_RT)]:
            f.result()
    for name, S in LONG_LEVELS:
        build = ff.train_build(mlp.cfg.net_width, mlp.cfg.net_depth, mlp.in_dim,
                               mlp.in_dim_views, S)
        print(f"[long] {name} S={S} P={mlp.in_dim} DD={mlp.in_dim_views}: routed to {build}",
              flush=True)
    target = rays[3]
    xs = _feat_levels(m, rays, levels)
    step = _long_step(dev)
    routed = ff.kernel_defines
    out, sse0 = {}, {}
    for turn, defines in enumerate((register, FEAT_RT, FEAT_RT, register)):
        build = "register" if defines == register else "runtime"
        # the wrapper loads the build kernel_defines names: route every
        # shape to this turn's
        ff.kernel_defines = lambda _w, _p, d=defines: dict(d)
        try:
            res = {}
            for name, S in LONG_LEVELS:
                call = _feat_call(m, target, xs[name], S, None)
                sse = float(call()[0])
                sse0.setdefault(name, sse)
                ms = _event_ms(call)
                split = _split_ms(call, FEAT_PARENT_KERNELS, 10)
                res[name] = dict(ms=ms, sse=sse, **split)
                print(f"[long] turn {turn} {build:8s} feat {name:6s} {N_RAYS} x {S}: "
                      f"{ms:.4f} ms a call; device "
                      + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
                      + f" ms; sse {sse:.6f} (register build's first {sse0[name]:.6f})",
                      flush=True)
            for _ in range(2):
                step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                step()
            torch.cuda.synchronize()
            res["step_ms"] = (time.perf_counter() - t0) / 20 * 1e3
            print(f"[long] turn {turn} {build:8s} step {res['step_ms']:.3f} ms", flush=True)
        finally:
            ff.kernel_defines = routed
        out[f"{turn}_{build}"] = res
    return out


# --eval: the INGP eval call at the serving path's shapes, a 32,768-ray chunk
# of a 400 x 400 frame: lego_ingp (48 + 48 samples) and lego_ingp_occ (32 +
# 32), each level's depths as the renderer makes them
EVAL_PRESETS = ("lego_ingp", "lego_ingp_occ")
EVAL_CHUNK = 32768
# the parent's eval kernel (csrc/fused_ingp.cu's register build at lego_ingp's
# width and levels) with its MLP taken out (the point's hash features summed
# into sigma and the colour) or its hash encode (the features read as the
# point's coordinates: no lookups), as text edits of that checkout's source
PARENT_EVAL_DEFINES = {"INGP_W": 64, "INGP_PP": 16}
PARENT_EVAL_EDITS = {
    "no_mlp": ("point_forward<W, PP>(A, wts, gbase + i, rgb, sigma);",
               "{\n  float x_[3];\n  point_of(A, gbase + i, x_);\n  float e_[PP];\n"
               "  hash_features<PP>(A, x_, e_);\n  float s_ = 0.f;\n#pragma unroll\n"
               "  for (int k_ = 0; k_ < PP; ++k_) s_ += e_[k_];\n"
               "  sigma = s_;\n  rgb[0] = rgb[1] = rgb[2] = s_;\n}"),
    "no_hash": ("hash_features<PP>(A, x, e);",
                "{\n#pragma unroll\n  for (int k_ = 0; k_ < PP; ++k_) "
                "e[k_] = k_ < A.L * A.F ? x[k_ % 3] : 0.f;\n}"),
}
# this checkout's eval kernel (csrc/ingp_eval_tc.cu) with its products or its
# hash lookups skipped (timing only: wrong results)
HEAD_EVAL_VARIANTS = {"no_mma": {"INGP_EVAL_NO_MMA": 1}, "no_hash": {"INGP_EVAL_NO_HASH": 1}}
# its phase clocks (block 0: consumer thread 0, then encoder thread 0)
EVAL_CLOCKS = {"INGP_EVAL_CLOCKS": 1}
EVAL_PHASES = ("wait for features", "layer 0 fragments", "products", "epilogues",
               "consumers' barrier", "composite", "enc: wait for a buffer", "enc: points",
               "enc: features", "enc: SH terms")


def _eval_inputs(dev, preset):
    """A seeded ``preset`` model on the fused route (tables + N(0, 0.1)),
    the first EVAL_CHUNK rays of orbit frame 0 at 400 x 400, their SH and
    per level (z, deltas): the coarse depths of an eval render, the fine
    ones importance-sampled from the plain version's coarse weights."""
    import numpy as np
    import torch

    from nerf_meets_mlx_torch.cameras.pose import orbit_poses
    from nerf_meets_mlx_torch.cameras.rays import get_rays
    from nerf_meets_mlx_torch.config import PRESETS
    from nerf_meets_mlx_torch.datasets.synthetic import CAMERA_ANGLE_X
    from nerf_meets_mlx_torch.kernels import fused_ingp_train as fi
    from nerf_meets_mlx_torch.models import create_nerf
    from nerf_meets_mlx_torch.sampling.importance import merge_z, sample_pdf

    g = torch.Generator(device=dev).manual_seed(2)
    m = create_nerf(PRESETS[preset]().replace(use_fused_kernel=True), device=dev)
    m.init(torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        m.pos_enc.tables.add_(torch.randn(m.pos_enc.tables.shape, generator=g, device=dev) * 0.1)
    res = 400
    focal = 0.5 * res / np.tan(0.5 * CAMERA_ANGLE_X)
    K = np.array([[focal, 0, res / 2], [0, focal, res / 2], [0, 0, 1]], np.float32)
    c2w = orbit_poses(160)[0][:3, :4]
    ro, rd = get_rays(res, res, K, c2w, device=dev)
    ro = ro.reshape(-1, 3)[:EVAL_CHUNK].contiguous()
    rd = rd.reshape(-1, 3)[:EVAL_CHUNK].contiguous()
    dnorm = torch.linalg.vector_norm(rd, dim=-1, keepdim=True)
    sh = m.dir_enc.apply(rd / dnorm).contiguous()
    rcfg = m.cfg.render

    def level(z):
        return z, torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1) * dnorm

    coarse = level(m._coarse_z(ro, rd, train=False))
    with torch.no_grad():
        _, w_c = fi.fused_ingp_eval_reference(m.coarse, m.pos_enc, sh, _eval_spec(m, rcfg.n_samples),
                                              ro, rd, *coarse)
    fine = level(merge_z(coarse[0], sample_pdf(coarse[0], w_c, rcfg.n_importance,
                                                deterministic=True)))
    return m, (K, c2w), (ro, rd, sh), {"coarse": coarse, "fine": fine}


def _eval_spec(m, S):
    from nerf_meets_mlx_torch.kernels import fused_ingp_train as fi
    from nerf_meets_mlx_torch.kernels.fused_train import TrainSpec

    rcfg = m.cfg.render
    rb = fi.ingp_rays_block(S)
    return TrainSpec(n_samples=S, rays_block=rb, mode=rcfg.compositing,
                     density_activation=rcfg.density_activation, white_bkgd=rcfg.white_bkgd,
                     group=fi.ingp_group(S, rb))


def _device_events(call, n):
    """Device events (kernels, copies) a call of ``call`` makes, from
    torch.profiler over ``n`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / n


def _parent_eval_libs():
    """{variant: library} of the parent's register build at lego_ingp's
    shape with PARENT_EVAL_EDITS applied (its own source, csrc/ on the
    include path), built side by side."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    from nerf_meets_mlx_torch.kernels import _build

    src = (_build.CSRC / "fused_ingp.cu").read_text()
    out_dir = HEAD / ".runs" / "ingp_kernel_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    defines = [f"-D{k}={v}" for k, v in PARENT_EVAL_DEFINES.items()]

    def build(name, edit):
        old, new = edit
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the parent's source does not hold {old!r} once")
        cu, lib = out_dir / f"parent_eval_{name}.cu", out_dir / f"libparent_eval_{name}.so"
        cu.write_text(src.replace(old, new))
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-I", str(_build.CSRC),
                               "-o", str(lib), str(cu)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-3000:]}")
        return ctypes.CDLL(str(lib))

    with ThreadPoolExecutor(len(PARENT_EVAL_EDITS)) as ex:
        futs = {k: ex.submit(build, k, e) for k, e in PARENT_EVAL_EDITS.items()}
        return {k: f.result() for k, f in futs.items()}


def _frame(m, view, kernel):
    """lego_ingp's 400 x 400 frame: the host ms of a warm frame (the lesser
    of 2, each ending in a synchronize), and one frame under torch.profiler:
    its device-busy share of the wall time and the eval kernel's device ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nerf_meets_mlx_torch.rendering import render_image

    K, c2w = view

    def frame():
        with torch.no_grad():
            render_image(m, 400, 400, K, c2w)
        torch.cuda.synchronize()

    frame()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        frame()
        times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frame()
        wall = (time.perf_counter() - t0) * 1e3
    busy = kern = 0.0
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        us = getattr(e, "self_device_time_total", None)
        us = float(getattr(e, "self_cuda_time_total", 0.0) if us is None else us) / 1e3
        busy += us
        if kernel in e.name:
            kern += us
    out = dict(frame_ms=min(times), traced_wall_ms=wall, busy_ms=busy, busy_share=busy / wall,
               eval_kernel_ms=kern, eval_kernel_share=kern / wall)
    print(f"[frame] lego_ingp 400x400: {min(times):.2f} ms a warm frame; traced {wall:.2f} ms, "
          f"device busy {busy:.2f} ms ({busy / wall:.3f}), {kernel} {kern:.2f} ms "
          f"({kern / wall:.3f} of the frame)", flush=True)
    return out


def _eval_phases(m, spec, args, lib, mlp):
    """[phases]: cycles a tile of each phase of the clocks build's block 0."""
    import torch

    from nerf_meets_mlx_torch.kernels import fused_ingp_train as fi

    R, S = args[3].shape
    clk = fi._eval_tc_launch(mlp, m.pos_enc, spec, args, lib)[0].flatten()[: len(EVAL_PHASES)].tolist()
    grid = min(R, torch.cuda.get_device_properties(0).multi_processor_count)
    tile = min(192, 32 * S)
    tiles = -(-(R // grid) * S // tile)  # block 0's
    total = sum(clk[:6])
    out = {k: c / tiles for k, c in zip(EVAL_PHASES, clk)}
    print(f"[phases] {S} samples, {tiles} tiles in block 0, consumer {total / tiles:.0f} cycles "
          "a tile: " + ", ".join(f"{k} {c / tiles:.0f} ({c / total:.1%})"
                                  for k, c in zip(EVAL_PHASES[:6], clk))
          + "; encoder: " + ", ".join(f"{k[5:]} {c / tiles:.0f}"
                                      for k, c in zip(EVAL_PHASES[6:], clk[6:])), flush=True)
    return out


def eval_worker(role: str) -> None:
    """--eval: the checkout's INGP eval call per preset and level: its
    event ms, device ms by kernel and of the wrapper's other launches,
    device events a call, host ms; its variants' kernel device ms; the
    standalone hash forward at the chunk's points; the build's ptxas
    report; lego_ingp's frame. This checkout's also its kernel's phase
    clocks."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from nerf_meets_mlx_torch.kernels import _build
    from nerf_meets_mlx_torch.kernels import fused_ingp_train as fi
    from nerf_meets_mlx_torch.kernels import hash_encode as he

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    tag = "[parent]" if role == "parent" else "[time]"
    # every build of the turn started together
    with ThreadPoolExecutor(6) as ex:
        hash_build = ex.submit(_build.build, "hash_encode")
        if role == "parent":
            kernel = "ingp_eval_kernel"
            key = ("fused_ingp", tuple(sorted(PARENT_EVAL_DEFINES.items())))
            own_build = ex.submit(_build.build, "fused_ingp", PARENT_EVAL_DEFINES)
            libs = _parent_eval_libs()
            own_build.result()
            report = _build.BUILD_LOG.get(_build.variant_name("fused_ingp", PARENT_EVAL_DEFINES),
                                          "")
            own = _build.load_library("fused_ingp", PARENT_EVAL_DEFINES)
        else:
            kernel = "ingp_eval_tc_kernel"
            builds = [None, *HEAD_EVAL_VARIANTS.values(), EVAL_CLOCKS]
            for f in [ex.submit(_build.build, fi.EVAL_SOURCE, d) for d in builds]:
                f.result()
            report = _build.BUILD_LOG.get(_build.variant_name(fi.EVAL_SOURCE), "")
            libs = {k: fi.type_eval_lib(_build.load_library(fi.EVAL_SOURCE, d))
                    for k, d in HEAD_EVAL_VARIANTS.items()}
            clocks = fi.type_eval_lib(_build.load_library(fi.EVAL_SOURCE, EVAL_CLOCKS))
        hash_build.result()
    for line in report.splitlines():
        if any(k in line for k in ("registers", "spill", "smem", "Compiling")):
            print(f"[ptxas] {role} {line.strip()}", flush=True)
    out = {}
    for preset in EVAL_PRESETS:
        m, view, (ro, rd, sh), levels = _eval_inputs(dev, preset)
        for name, (z, dl) in levels.items():
            mlp = m.coarse if name == "coarse" else m.fine
            S = z.shape[1]
            spec = _eval_spec(m, S)

            def call(mlp=mlp, spec=spec, z=z, dl=dl):
                with torch.no_grad():
                    return fi.fused_ingp_eval_apply(mlp, m.pos_enc, sh, spec, ro, rd, z, dl)

            ms = _event_ms(call, 10)
            split = _split_ms(call, (kernel,), 5)
            events = _device_events(call, 5)
            host = _host_ms(call)
            row = dict(ms=ms, host_ms=host, events=events, **split)
            for variant, lib in libs.items():
                if role == "parent":
                    _build._LIBS[key] = lib
                    vcall = call
                else:
                    args = (ro, rd, sh, z, dl)

                    def vcall(mlp=mlp, spec=spec, args=args, lib=lib):
                        return fi._eval_tc_launch(mlp, m.pos_enc, spec, args, lib)
                try:
                    row[variant] = _split_ms(vcall, (kernel,), 5)[kernel]
                finally:
                    if role == "parent":
                        _build._LIBS[key] = own
            pts = (ro[:, None, :] + z[..., None] * rd[:, None, :]).reshape(-1, 3)
            with torch.no_grad():
                row["hash_fwd_ms"] = _event_ms(lambda pts=pts: he.hash_encode_apply(m.pos_enc, pts),
                                               10)
            if role == "head":
                row["phases"] = _eval_phases(m, spec, (ro, rd, sh, z, dl), clocks, mlp)
            out[f"{preset}_{name}"] = row
            print(f"{tag} eval {preset} {name:6s} {EVAL_CHUNK} x {S}: {ms:.4f} ms a call "
                  f"(events); device {kernel} {split[kernel]:.4f}, other launches "
                  f"{split['torch ops']:.4f} ms; {events:.1f} device events a call; host "
                  f"{host:.4f} ms a call; "
                  + ", ".join(f"{v} {row[v]:.4f}" for v in libs)
                  + f" ms; hash_encode_apply at its {pts.shape[0]} points {row['hash_fwd_ms']:.4f} ms",
                  flush=True)
        if preset == "lego_ingp":
            out["frame"] = _frame(m, view, kernel)
        del m
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def worker(role: str) -> None:
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from nerf_meets_mlx_torch.kernels import _build
    from nerf_meets_mlx_torch.kernels import fused_ingp_train as fi

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    libs = {}
    if role == "parent":
        variants = {"parent": None}
        # the build that trains lego_ingp's fine level in that checkout
        if hasattr(fi, "train_build"):
            _build.build(*fi.train_build(64, 2, 8, 2, 25, 96))
        else:
            _build.build("fused_ingp", fi.kernel_defines(64, 8, 2))
        names = PARENT_KERNELS
    else:
        variants = VARIANTS
        builds = dict(VARIANTS, **CLOCKS)
        with ThreadPoolExecutor(len(builds) + 1) as ex:
            futs = {k: ex.submit(_build.build, fi.TC_SOURCE, d or None) for k, d in builds.items()}
            one_pass = ex.submit(_one_pass_lib)
            for f in futs.values():
                f.result()
            libs["one_pass"] = one_pass.result()
        libs.update({k: _variant_lib(d or None) for k, d in builds.items() if d})
        names = HEAD_KERNELS
        for line in _build.BUILD_LOG.get(_build.variant_name(fi.TC_SOURCE), "").splitlines():
            if any(k in line for k in ("registers", "spill", "smem", "Compiling")):
                print(f"[ptxas] {line.strip()}", flush=True)
    m, rays, levels = _inputs(dev)
    out = {}
    for variant in variants:
        for name, S in LEVELS:
            call = _variant_call(m, rays, levels[name], libs.get(variant))
            ms = _event_ms(call)
            split = _split_ms(call, names, 10)
            host = _host_ms(call)
            out[f"{variant}_{name}"] = dict(ms=ms, host_ms=host, **split)
            tag = "[parent]" if role == "parent" else "[time]"
            print(f"{tag} {variant:10s} {name:6s} {N_RAYS} x {S}: {ms:.4f} ms a launch; device "
                  + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
                  + f" ms; host {host:.4f} ms a call", flush=True)
    if role == "head":
        out["phases"] = _phases(m, rays, levels, libs)
    out["f64"] = _f64(m, rays, levels, role, libs.get("one_pass"))
    print(json.dumps(out), flush=True)


def _phases(m, rays, levels, libs):
    """Cycles per tile of each phase, from the clocks variants' block 0."""
    import torch

    from nerf_meets_mlx_torch.kernels import fused_ingp_train as fi

    out = {}
    for variant, (name, S) in ((v, lv) for v in CLOCKS for lv in LEVELS):
        rgb = _variant_call(m, rays, levels[name], libs[variant])()[1]
        clk = rgb.flatten()[: len(PHASES)].tolist()
        rpt = fi.tc_rays_per_tile(64, 2, 8, 2, m.fine.in_dim_views, S)  # lego_ingp's shape
        n_tiles = -(-N_RAYS // rpt)
        grid = min(n_tiles, torch.cuda.get_device_properties(0).multi_processor_count)
        tiles = len(range(0, n_tiles, grid))
        total = sum(clk)
        out[f"{variant}_{name}"] = {k: c / tiles for k, c in zip(PHASES, clk)}
        print(f"[phases] {variant:13s} {name:6s} {tiles} tiles in block 0, "
              f"{total / tiles:.0f} cycles a tile: "
              + ", ".join(f"{k} {c / tiles:.0f} ({c / total:.1%})" for k, c in zip(PHASES, clk)),
              flush=True)
    return out


# csrc/ingp_train_tc.cu with one TF32 product in place of three: every
# split's lo half is zero, so lo*hi and hi*lo add nothing
ONE_PASS_SRC = """#include "tf32x3.cuh"
__device__ __forceinline__ void split_hi_only(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = 0u;
}
#define split_tf32 split_hi_only
#include "ingp_train_tc.cu"
"""


def _nvcc_lib(name: str, src: str):
    """``src`` compiled (csrc/ on the include path) into the probe's
    scratch directory under .runs/ and loaded."""
    import ctypes

    from nerf_meets_mlx_torch.kernels import _build

    out_dir = HEAD / ".runs" / "ingp_kernel_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, lib_path = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    cu.write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                           "-o", str(lib_path), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-3000:]}")
    return ctypes.CDLL(str(lib_path))


def _one_pass_lib():
    from nerf_meets_mlx_torch.kernels import fused_ingp_train as fi

    return fi.type_tc_lib(_nvcc_lib("ingp_train_tc_one_pass", ONE_PASS_SRC))


RATE_SRC = r"""
#include <cuda_runtime.h>
#include <cstdint>
template <int ILP>
__global__ void mma_chains(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  b[0] = a[2]; b[1] = a[3];
  float c[ILP][4];
  for (int j = 0; j < ILP; ++j) for (int k = 0; k < 4; ++k) c[j][k] = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < ILP; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                   "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                   : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < ILP; ++j) for (int k = 0; k < 4; ++k) s += c[j][k];
  if (s == 123.f) out[0] = s;  // keeps the mmas live
}
extern "C" int mma_chains_launch(int ilp, float* out, int blocks, int threads, int iters,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (ilp) {
    case 1: mma_chains<1><<<blocks, threads, 0, st>>>(out, iters); break;
    case 2: mma_chains<2><<<blocks, threads, 0, st>>>(out, iters); break;
    case 4: mma_chains<4><<<blocks, threads, 0, st>>>(out, iters); break;
    case 8: mma_chains<8><<<blocks, threads, 0, st>>>(out, iters); break;
    default: mma_chains<16><<<blocks, threads, 0, st>>>(out, iters); break;
  }
  return (int)cudaGetLastError();
}
"""


def _rate():
    """[rate]: mma.sync TF32 TFLOP/s at 12 warps an SM by independent chains."""
    import ctypes

    import torch

    lib = _nvcc_lib("mma_chains", RATE_SRC)
    lib.mma_chains_launch.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    buf = torch.zeros(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for ilp in (1, 2, 4, 8, 16):
        iters = 16384 // ilp

        def run(ilp=ilp, iters=iters):
            if lib.mma_chains_launch(ilp, buf.data_ptr(), sms, 384, iters, stream) != 0:
                raise RuntimeError("mma_chains launch failed")

        ms = _event_ms(run, 3)
        flop = sms * 12 * iters * ilp * 2 * 16 * 8 * 8
        out[ilp] = flop / ms / 1e9
        print(f"[rate] mma.sync m16n8k8 tf32, 12 warps an SM, {ilp:2d} independent chains a "
              f"warp: {ms:.3f} ms, {out[ilp]:.1f} TFLOP/s", flush=True)
    return out


def _trunc32(x64):
    """float64 values to float32 rounded toward zero, as the tensor cores
    round their adds."""
    import torch

    y = x64.to(torch.float32)
    over = (y.double().abs() > x64.abs()).to(torch.int32)
    return (y.view(torch.int32) - over).view(torch.float32)


def _acc_errors():
    """[acc]: the fp32 and 3xTF32 sums of one 64 x 64 layer against float64."""
    import torch

    from nerf_meets_mlx_torch.kernels.fused_train import _tf32

    g = torch.Generator().manual_seed(0)
    w = torch.randn(64, 64, generator=g) * (2 / 64) ** 0.5
    x = torch.relu(torch.randn(20000, 64, generator=g))
    xh, wh = _tf32(x), _tf32(w)
    xl, wl = _tf32(x - xh), _tf32(w - wh)
    steps = [torch.einsum("psk,skn->spn", a.double().reshape(-1, 8, 8),
                          b.double().reshape(8, 8, -1))
             for a, b in ((xl, wh), (xh, wl), (xh, wh))]
    whole = torch.zeros(x.shape[0], 64, dtype=torch.float64)
    per_step = torch.zeros(x.shape[0], 64, dtype=torch.float32)
    for k in range(8):
        t = torch.zeros_like(whole)
        for part in steps:
            whole = _trunc32(whole + part[k]).double()
            t = _trunc32(t + part[k]).double()
        per_step = per_step + t.float()
    exact = x.double() @ w.double()
    out = {}
    for name, y in (("fp32", x @ w), ("whole_layer", whole.float()), ("per_kstep", per_step)):
        d = y.double() - exact
        out[name] = (float(d.abs().mean()), float(d.abs().max()), float(d.mean()))
        print(f"[acc] {name:12s} mean |err| {out[name][0]:.3e}, max {out[name][1]:.3e}, "
              f"mean signed {out[name][2]:.3e}", flush=True)
    return out


def _f64(m, rays, levels, role, one_pass_lib=None):
    """max |x - float64| / max |float64| of every gradient array for the
    kernel, the fp32 plain version and the one-pass control; max |kernel -
    plain| / max |plain|; and the entries of W0 and dG off by more than
    1e-5 of max |plain|; per level."""
    import copy

    import torch

    from nerf_meets_mlx_torch.kernels import fused_ingp_train as fi

    ro, rd, sh, target = rays
    mlp64, enc64 = copy.deepcopy(m.fine).double(), copy.deepcopy(m.pos_enc).double()
    out = {}
    for name, S in LEVELS:
        z, dl, nz = levels[name]
        spec = _spec(S)
        rows = (ro, rd, z, dl, nz, target)
        grads = {}
        for kind, fn, mlp, enc, dt in (
                ("kernel", fi.fused_ingp_train_apply, m.fine, m.pos_enc, torch.float32),
                ("plain", fi.fused_ingp_train_reference, m.fine, m.pos_enc, torch.float32),
                ("f64", fi.fused_ingp_train_reference, mlp64, enc64, torch.float64)):
            params = [p for _, lin in mlp.linears() for p in (lin.weight, lin.bias)] + [enc.tables]
            sse = fn(mlp, enc, sh.to(dt), spec, *(t.to(dt) for t in rows))[0]
            grads[kind] = [g.double() for g in torch.autograd.grad(sse, params)]
        if one_pass_lib is not None:
            g = _variant_call(m, rays, levels[name], one_pass_lib)()[3]
            grads["one_pass"] = [x.double() for x in g]

        def ratios(a, b):
            return [float((x - y).abs().max() / y.abs().max()) for x, y in zip(a, b)]

        r = {f"{k}_f64": ratios(grads[k], grads["f64"])
             for k in ("kernel", "plain", "one_pass") if k in grads}
        r["kernel_plain"] = ratios(grads["kernel"], grads["plain"])
        r["off_w0_dg"] = [int(((a - b).abs() > 1e-5 * b.abs().max()).sum()) for a, b in (
            (grads["kernel"][0], grads["plain"][0]), (grads["kernel"][-1], grads["plain"][-1]))]
        out[name] = r
        for k, v in r.items():
            print(f"[f64] {role:6s} {name:6s} {k:14s} "
                  + " ".join(f"{x:.1e}" if isinstance(x, float) else str(x) for x in v),
                  flush=True)
    return out


# The products of a 64-row tile with one 64 x 64 weight in 3xTF32, in the
# train kernel's mma.sync form and in two wgmma forms ([forms] above).
FORMS_SRC = r"""
#include <cuda_runtime.h>
#include <cstdint>
#include "tf32x3.cuh"

namespace {
constexpr int WD = 64;       // K = N = 64
constexpr int LDX = WD + 8;  // row stride of the activation tiles and the fp32 weight

__device__ __forceinline__ int swz(int row, int col) { return col ^ ((row & 4) << 1); }

__device__ void load_tile(const float* x, float* X, long long row0, int rows, int n_pts) {
  for (int e = threadIdx.x; e < rows * WD; e += blockDim.x) {
    const int p = e / WD, c = e - p * WD;
    X[p * LDX + c] = row0 + p < n_pts ? x[(row0 + p) * WD + c] : 0.f;
  }
}

__device__ void store_tile(float* y, const float* X, long long row0, int rows, int n_pts) {
  for (int e = threadIdx.x; e < rows * WD; e += blockDim.x) {
    const int p = e / WD, c = e - p * WD;
    if (row0 + p < n_pts) y[(row0 + p) * WD + c] = X[p * LDX + c];
  }
}

// the k-step's A fragment of rows `arow` and arow + 8 (K order permuted:
// lane t takes columns k0 + 2t and k0 + 2t + 1), split into hi and lo
__device__ __forceinline__ void a_frag(const float* arow, int k0, int t, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  const float2 u = *reinterpret_cast<const float2*>(arow + k0 + 2 * t);
  const float2 v = *reinterpret_cast<const float2*>(arow + 8 * LDX + k0 + 2 * t);
  split_tf32(u.x, ah[0], al[0]);
  split_tf32(v.x, ah[1], al[1]);
  split_tf32(u.y, ah[2], al[2]);
  split_tf32(v.y, ah[3], al[3]);
}

// csrc/ingp_train_tc.cu's form: 96-row tiles, a warp pair per 16 rows, each
// warp 32 columns; B split at every k-step from the fp32 weight [in][out]
// (swizzled); each k-step's products summed from zero, added in fp32.
// FWD: y = x W^T (B[k][n] = w[n][k]), else y = x W (B[k][n] = w[k][n]).
template <bool FWD>
__global__ void __launch_bounds__(384, 1) mma_form(const float* x, const float* w, float* y,
                                                   int n_pts, int reps) {
  extern __shared__ __align__(128) float sm[];
  float* Ws = sm;
  float* X0 = Ws + WD * LDX;
  float* X1 = X0 + 96 * LDX;
  for (int e = threadIdx.x; e < WD * WD; e += blockDim.x) {
    const int o = e / WD, i = e - o * WD;
    Ws[i * LDX + swz(i, o)] = w[e];
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rt = warp >> 1, c0 = (warp & 1) * 32;
  const int n_tiles = (n_pts + 95) / 96;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    __syncthreads();
    load_tile(x, X0, (long long)tile * 96, 96, n_pts);
    __syncthreads();
    float* src = X0;
    float* dst = X1;
    for (int r = 0; r < reps; ++r) {
      float acc[4][4] = {};
      const float* arow = src + (16 * rt + g) * LDX;
#pragma unroll
      for (int k0 = 0; k0 < WD; k0 += 8) {
        uint32_t ah[4], al[4], bh[4][2], bl[4][2];
        a_frag(arow, k0, t, ah, al);
        float s[4][4] = {};
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int c = c0 + 8 * n + g;
          if (FWD) {
            const int r0 = k0 + 2 * t, r1 = r0 + 1;
            split_tf32(Ws[r0 * LDX + swz(r0, c)], bh[n][0], bl[n][0]);
            split_tf32(Ws[r1 * LDX + swz(r1, c)], bh[n][1], bl[n][1]);
          } else {
            const float2 q = *reinterpret_cast<const float2*>(Ws + c * LDX + swz(c, k0 + 2 * t));
            split_tf32(q.x, bh[n][0], bl[n][0]);
            split_tf32(q.y, bh[n][1], bl[n][1]);
          }
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) mma_tf32(s[n], al, bh[n]);
#pragma unroll
        for (int n = 0; n < 4; ++n) mma_tf32(s[n], ah, bl[n]);
#pragma unroll
        for (int n = 0; n < 4; ++n) mma_tf32(s[n], ah, bh[n]);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[n][i] += s[n][i];
      }
      float* drow = dst + (16 * rt + g) * LDX + c0 + 2 * t;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        *reinterpret_cast<float2*>(drow + 8 * n) = make_float2(acc[n][0], acc[n][1]);
        *reinterpret_cast<float2*>(drow + 8 * LDX + 8 * n) = make_float2(acc[n][2], acc[n][3]);
      }
      named_barrier(1 + rt, 64);  // the pair's other warp reads these columns next
      float* tmp = src;
      src = dst;
      dst = tmp;
    }
    __syncthreads();
    store_tile(y, src, (long long)tile * 96, 96, n_pts);
  }
}

// 192-row tiles, a warpgroup per 64 rows, m64n64k8 with A from registers and
// B the hi/lo TF32 images of the weight in shared memory (split once per
// block, core matrices [K half][N / 8][8][4] per k-step, K permuted as A):
// KSTEP = false keeps a whole layer in the accumulator (csrc/fused_eval.cu),
// KSTEP = true sums each k-step's products from zero and adds them in fp32.
template <bool FWD, bool KSTEP>
__global__ void __launch_bounds__(384, 1) wgmma_form(const float* x, const float* w, float* y,
                                                     int n_pts, int reps) {
  extern __shared__ __align__(128) float sm[];
  float* img = sm;
  float* X0 = img + 8 * 16 * WD;
  float* X1 = X0 + 192 * LDX;
  for (int e = threadIdx.x; e < WD * WD; e += blockDim.x) {
    const int k = e / WD, n = e - k * WD, kk = k & 7, p = (kk & 1) * 4 + (kk >> 1);
    uint32_t hi, lo;
    split_tf32(FWD ? w[n * WD + k] : w[k * WD + n], hi, lo);
    float* at = img + (k >> 3) * 16 * WD + (p >> 2) * 4 * WD + (n >> 3) * 32 + (n & 7) * 4 + (p & 3);
    at[0] = __uint_as_float(hi);
    at[8 * WD] = __uint_as_float(lo);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the images, to the wgmmas
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row = 64 * (warp >> 2) + 16 * (warp & 3) + g;
  const int n_tiles = (n_pts + 191) / 192;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    __syncthreads();
    load_tile(x, X0, (long long)tile * 192, 192, n_pts);
    __syncthreads();
    float* src = X0;
    float* dst = X1;
    for (int r = 0; r < reps; ++r) {
      float acc[32] = {}, part[32] = {};
      const float* arow = src + row * LDX;
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        uint32_t ah[4], al[4];
        a_frag(arow, 8 * s, t, ah, al);
        const float* B = img + s * 16 * WD;
        const uint64_t dh = wgmma_desc(B, 16 * WD, 128), dl = wgmma_desc(B + 8 * WD, 16 * WD, 128);
        __syncwarp();
        wgmma_fence();
        if constexpr (KSTEP) {
          wgmma_tf32<64>(part, al, dh, 0);
          wgmma_tf32<64>(part, ah, dl, 1);
          wgmma_tf32<64>(part, ah, dh, 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs<32>(part);
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[i] += part[i];
        } else {
          wgmma_tf32<64>(acc, al, dh, s == 0 ? 0 : 1);
          wgmma_tf32<64>(acc, ah, dl, 1);
          wgmma_tf32<64>(acc, ah, dh, 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs<32>(acc);
        }
      }
      float* drow = dst + row * LDX + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<float2*>(drow + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(drow + 8 * LDX + 8 * j) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
      __syncwarp();  // a warp reads and writes only its own 16 rows
      float* tmp = src;
      src = dst;
      dst = tmp;
    }
    __syncthreads();
    store_tile(y, src, (long long)tile * 192, 192, n_pts);
  }
}

template <class K>
int run(K kern, int smem, const float* x, const float* w, float* y, int n_pts, int reps,
        int blocks, cudaStream_t st) {
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kern<<<blocks, 384, smem, st>>>(x, w, y, n_pts, reps);
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" int forms_launch(int form, int fwd, const float* x, const float* w, float* y,
                            int n_pts, int reps, int blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int sm_mma = (WD + 2 * 96) * LDX * 4, sm_wg = (8 * 16 * WD + 2 * 192 * LDX) * 4;
  if (form == 0)
    return fwd ? run(mma_form<true>, sm_mma, x, w, y, n_pts, reps, blocks, st)
               : run(mma_form<false>, sm_mma, x, w, y, n_pts, reps, blocks, st);
  if (form == 1)
    return fwd ? run(wgmma_form<true, false>, sm_wg, x, w, y, n_pts, reps, blocks, st)
               : run(wgmma_form<false, false>, sm_wg, x, w, y, n_pts, reps, blocks, st);
  return fwd ? run(wgmma_form<true, true>, sm_wg, x, w, y, n_pts, reps, blocks, st)
             : run(wgmma_form<false, true>, sm_wg, x, w, y, n_pts, reps, blocks, st);
}
"""
FORMS = ("mma", "wgmma", "wgmma_kstep")


def _forms():
    """[forms]: ms a 64 x 64 layer in 3xTF32 per form, direction and batch."""
    import ctypes

    import torch

    lib = _nvcc_lib("tile_forms", FORMS_SRC)
    lib.forms_launch.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(5)
    w = torch.randn((64, 64), generator=g, device="cuda") / 8
    out = {}
    for form_i, form in enumerate(FORMS):
        for fwd, direction in ((1, "x W^T"), (0, "x W")):
            def launch(x, y, reps, form_i=form_i, fwd=fwd):
                err = lib.forms_launch(form_i, fwd, x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                       x.shape[0], reps, sms, stream)
                if err != 0:
                    raise RuntimeError(f"forms_launch failed with cudaError {err}")

            x = torch.randn((1000, 64), generator=g, device="cuda")
            y = torch.empty_like(x)
            launch(x, y, 2)
            b = (w.T if fwd else w).double()
            ref = x.double() @ b @ b
            rel = float((y.double() - ref).abs().max() / ref.abs().max())
            row = {"rel_err": rel}
            for name, n in LEVELS:
                pts = N_RAYS * n
                x = torch.randn((pts, 64), generator=g, device="cuda")
                y = torch.empty_like(x)
                t1 = _event_ms(lambda: launch(x, y, 1), 10)
                t9 = _event_ms(lambda: launch(x, y, 9), 10)
                layer = (t9 - t1) / 8
                bound = 3 * 2 * 64 * 64 * pts / 495e12 * 1e3
                row[name] = {"layer_ms": layer, "bound_ms": bound}
                print(f"[forms] {form:11s} {direction:6s} {pts} points: {layer:.4f} ms a layer "
                      f"({layer / bound:.2f}x the 3xTF32 bound {bound:.4f} ms; 1 layer {t1:.4f}, "
                      f"9 layers {t9:.4f} ms a launch); max err / max |float64| {rel:.1e}",
                      flush=True)
            out[f"{form} {direction}"] = row
    return out


def _draws(n: int) -> dict:
    """[draws]: the gpu test's gradient check over ``n`` table draws."""
    import copy

    import torch

    from nerf_meets_mlx_torch.config import lego_ingp
    from nerf_meets_mlx_torch.encoding.spherical_harmonics import sh_encode
    from nerf_meets_mlx_torch.kernels import fused_ingp_train as fi
    from nerf_meets_mlx_torch.kernels.fused_train import TrainSpec
    from nerf_meets_mlx_torch.models import create_nerf

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    R = 1001
    rows = {}
    for S in (96, 48):
        g = torch.Generator(device=dev).manual_seed(5)
        ro = torch.randn((R, 3), generator=g, device=dev) * 0.2 + torch.tensor([0.0, 0.0, 3.0],
                                                                               device=dev)
        rd = torch.randn((R, 3), generator=g, device=dev) * 0.2 + torch.tensor([0.0, 0.0, -1.0],
                                                                               device=dev)
        sh = sh_encode(rd / rd.norm(dim=-1, keepdim=True), 4)
        z = torch.sort(torch.rand((R, S), generator=g, device=dev) * 4.0 + 1.0, dim=-1).values
        dl = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1) * rd.norm(
            dim=-1, keepdim=True)
        rows[S] = (ro, rd, sh, z, dl, torch.randn((R, S), generator=g, device=dev),
                   torch.rand((R, 3), generator=g, device=dev))

    def rel(a, b):
        return float((a.double() - b.double()).abs().max() / b.double().abs().max())

    out = {}
    for seed in range(1, n + 1):
        m = create_nerf(lego_ingp(), device=dev).init(torch.Generator(device=dev).manual_seed(0))
        with torch.no_grad():
            m.pos_enc.tables.add_(torch.randn(m.pos_enc.tables.shape, device=dev,
                                              generator=torch.Generator(device=dev).manual_seed(
                                                  seed)) * 0.1)
        mlp, enc = m.fine, m.pos_enc
        mlp64, enc64 = copy.deepcopy(mlp).double(), copy.deepcopy(enc).double()
        params = [p for _, lin in mlp.linears() for p in (lin.weight, lin.bias)] + [enc.tables]
        params64 = [p for _, lin in mlp64.linears() for p in (lin.weight, lin.bias)] + [
            enc64.tables]
        for S, (ro, rd, sh, z, dl, nz, target) in rows.items():
            for mode in ("canonical", "reference"):
                for white in (True, False):
                    rb = fi.ingp_rays_block(S)
                    spec = TrainSpec(n_samples=S, rays_block=rb, mode=mode,
                                     density_activation="softplus", white_bkgd=white,
                                     group=fi.ingp_group(S, rb))
                    args = (ro, rd, sh, z, dl, nz, target)
                    sse = fi.fused_ingp_train_apply(mlp, enc, sh, spec, ro, rd, z, dl, nz,
                                                    target)[0]
                    gk = torch.autograd.grad(sse, params)
                    grt = fi._rt_launch(mlp, enc, spec, args)[3]
                    sse = fi.fused_ingp_train_reference(mlp, enc, sh, spec, ro, rd, z, dl, nz,
                                                        target)[0]
                    gp = torch.autograd.grad(sse, params)
                    sse = fi.fused_ingp_train_reference(mlp64, enc64, sh.double(), spec,
                                                        *(t.double() for t in args[:2]),
                                                        *(t.double() for t in args[3:]))[0]
                    g64 = torch.autograd.grad(sse, params64)
                    r = {"kernel_plain": rel(gk[-1], gp[-1]), "rt_plain": rel(grt[-1], gp[-1])}
                    for k, gg in (("kernel", gk), ("rt", grt), ("plain", gp)):
                        r[f"{k}_f64"] = rel(gg[-1], g64[-1])
                        r[f"{k}_alpha_f64"] = max(rel(gg[4], g64[4]), rel(gg[5], g64[5]))
                    key = f"S={S} {mode} white={int(white)}"
                    out.setdefault(key, []).append(r)
                    print(f"[draws] seed {seed:2d} {key}: dG vs plain kernel "
                          f"{r['kernel_plain']:.1e}, rt {r['rt_plain']:.1e}; dG vs float64 "
                          f"kernel {r['kernel_f64']:.1e}, rt {r['rt_f64']:.1e}, plain "
                          f"{r['plain_f64']:.1e}; alpha head vs float64 kernel "
                          f"{r['kernel_alpha_f64']:.1e}, rt {r['rt_alpha_f64']:.1e}, plain "
                          f"{r['plain_alpha_f64']:.1e}", flush=True)
    for key, rs in out.items():
        print(f"[draws] {key}: over {len(rs)} draws, dG vs plain above 1e-3: kernel "
              f"{sum(r['kernel_plain'] > 1e-3 for r in rs)}, rt "
              f"{sum(r['rt_plain'] > 1e-3 for r in rs)}; largest kernel "
              f"{max(r['kernel_plain'] for r in rs):.1e}, rt {max(r['rt_plain'] for r in rs):.1e}",
              flush=True)
    return out


def _draws_rt(n: int, width: int) -> dict:
    """[draws-rt]: ``tests/test_torch_fused_ingp.py::
    test_cuda_ingp_kernels_match_plain_at_new_shapes`` at ``width`` (8
    levels of 2 features, fp32 hash compute; the test's 501 rays of 48
    samples from seed 2) over ``n`` draws of the tables' N(0, 0.1) noise
    (seeds 1 .. n): per draw whether the test's criteria hold, and for each
    gradient array how far the kernel and the fp32 plain version are from
    float64 (max |x - float64| / max |float64|)."""
    import copy
    import dataclasses

    import torch

    from nerf_meets_mlx_torch.config import EncodingConfig, lego_ingp
    from nerf_meets_mlx_torch.encoding.spherical_harmonics import sh_encode
    from nerf_meets_mlx_torch.kernels import fused_ingp_train as fi
    from nerf_meets_mlx_torch.kernels.fused_train import TrainSpec
    from nerf_meets_mlx_torch.models import create_nerf

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    pcfg = dataclasses.replace(EncodingConfig(kind="hash_grid", in_dim=3), hash_n_levels=8,
                               hash_features_per_level=2, hash_compute_dtype="float32")
    cfg = lego_ingp()
    mlp_cfg = dataclasses.replace(cfg.mlp, net_width=width)
    cfg = cfg.replace(pos_encoding=pcfg, mlp=mlp_cfg, mlp_fine=mlp_cfg)
    g = torch.Generator(device=dev).manual_seed(2)
    R, S = 501, 48
    ro = torch.randn((R, 3), generator=g, device=dev) * 0.2 + torch.tensor([0.0, 0.0, 3.0],
                                                                           device=dev)
    rd = torch.randn((R, 3), generator=g, device=dev) * 0.2 + torch.tensor([0.0, 0.0, -1.0],
                                                                           device=dev)
    sh = sh_encode(rd / rd.norm(dim=-1, keepdim=True), 4)
    z = torch.sort(torch.rand((R, S), generator=g, device=dev) * 4.0 + 1.0, dim=-1).values
    dl = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1) * rd.norm(
        dim=-1, keepdim=True)
    nz = torch.randn((R, S), generator=g, device=dev)
    target = torch.rand((R, 3), generator=g, device=dev)
    rb = fi.ingp_rays_block(S)
    spec = TrainSpec(n_samples=S, rays_block=rb, mode="canonical", density_activation="softplus",
                     white_bkgd=True, group=fi.ingp_group(S, rb))
    build = fi.train_build(width, cfg.mlp.net_depth, 8, 2, sh.shape[-1], S)
    print(f"[draws-rt] width {width}: {R} rays x {S} samples on {build}", flush=True)

    def rel(a, b):
        return float((a.double() - b.double()).abs().max() / b.double().abs().max())

    draws = []
    for seed in range(1, n + 1):
        m = create_nerf(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
        with torch.no_grad():
            m.pos_enc.tables.add_(torch.randn(m.pos_enc.tables.shape, device=dev,
                                              generator=torch.Generator(device=dev).manual_seed(
                                                  seed)) * 0.1)
        mlp, enc = m.fine, m.pos_enc
        mlp64, enc64 = copy.deepcopy(mlp).double(), copy.deepcopy(enc).double()
        params = [p for _, lin in mlp.linears() for p in (lin.weight, lin.bias)] + [enc.tables]
        params64 = [p for _, lin in mlp64.linears() for p in (lin.weight, lin.bias)] + [
            enc64.tables]
        names = [f"{n_}.{w}" for n_, _ in mlp.linears() for w in ("w", "b")] + ["tables"]
        args = (mlp, enc, sh, spec, ro, rd, z, dl, nz, target)
        sse, rgb, _ = fi.fused_ingp_train_apply(*args)
        gk = torch.autograd.grad(sse, params)
        sse_p, rgb_p, _ = fi.fused_ingp_train_reference(*args)
        gp = torch.autograd.grad(sse_p, params)
        sse64 = fi.fused_ingp_train_reference(mlp64, enc64, sh.double(), spec, ro.double(),
                                              rd.double(), z.double(), dl.double(), nz.double(),
                                              target.double())[0]
        g64 = torch.autograd.grad(sse64, params64)
        floor = 1e-6 * max(float(b.abs().max()) for b in gp)
        values_ok = bool(torch.allclose(sse, sse_p, rtol=1e-4, atol=1e-4)) and bool(
            torch.allclose(rgb, rgb_p.detach(), rtol=1e-4, atol=1e-4))
        arrays = {}
        for name, a, b, c in zip(names, gk, gp, g64):
            err, scale = float((a - b).abs().max()), float(b.abs().max())
            arrays[name] = {"kernel_f64": rel(a, c), "plain_f64": rel(b, c),
                            "kernel_plain": err / scale if scale else 0.0,
                            "test_ok": bool(torch.isfinite(a).all()) and err <= 1e-3 * scale + floor}
        failing = [k for k, r in arrays.items() if not r["test_ok"]]
        further = [k for k, r in arrays.items() if r["kernel_f64"] > r["plain_f64"]]
        worst = max(arrays, key=lambda k: arrays[k]["kernel_f64"] / max(arrays[k]["plain_f64"],
                                                                        1e-30))
        draws.append({"seed": seed, "values_ok": values_ok, "failing": failing,
                      "arrays": arrays})
        print(f"[draws-rt] seed {seed:2d}: test {'passes' if values_ok and not failing else 'FAILS'}"
              f" (values {'ok' if values_ok else 'off'}; arrays past 1e-3 of plain: "
              f"{failing or 'none'}); kernel further from float64 than plain on "
              f"{len(further)}/{len(arrays)} arrays; worst ratio {worst}: kernel "
              f"{arrays[worst]['kernel_f64']:.2e} vs plain {arrays[worst]['plain_f64']:.2e}",
              flush=True)
    for name in draws[0]["arrays"]:
        rs = [d["arrays"][name] for d in draws]
        print(f"[draws-rt] {name:18s} over {n} draws: vs float64 kernel max "
              f"{max(r['kernel_f64'] for r in rs):.2e}, plain max "
              f"{max(r['plain_f64'] for r in rs):.2e}; kernel further than plain in "
              f"{sum(r['kernel_f64'] > r['plain_f64'] for r in rs)}, by at most "
              f"{max(r['kernel_f64'] / max(r['plain_f64'], 1e-30) for r in rs):.2f}x; test "
              f"criterion fails in {sum(not r['test_ok'] for r in rs)}", flush=True)
    print(f"[draws-rt] the test fails on {sum(bool(d['failing']) or not d['values_ok'] for d in draws)}"
          f" of {n} draws", flush=True)
    return {"width": width, "build": str(build), "draws": draws}


def _run(role: str, root: Path, mode: str = "") -> dict:
    env = dict(os.environ, PYTHONPATH=str(root.resolve()))
    cmd = [sys.executable, __file__, "--worker", role] + ([mode] if mode else [])
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    if proc.returncode != 0:
        print(proc.stdout[-3000:], proc.stderr[-6000:], file=sys.stderr)
        raise RuntimeError(f"the {role} worker failed")
    return json.loads(lines[-1])


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--base", help="the parent checkout's root")
    p.add_argument("--no-head", action="store_true", help="time the parent only")
    p.add_argument("--draws", type=int, default=0,
                   help="only the gpu test's gradient check over this many table draws")
    p.add_argument("--draws-width", type=int, default=0,
                   help="with --draws: the runtime-shape build's gpu test at this width instead")
    p.add_argument("--feat", action="store_true",
                   help="probe the feat train launch at the paper tables' levels")
    p.add_argument("--long-rays", action="store_true",
                   help="only the long-ray overlay on the register and runtime-shape builds")
    p.add_argument("--eval", action="store_true",
                   help="probe the INGP eval call at the serving path's chunks")
    p.add_argument("--worker", choices=("parent", "head"), help=argparse.SUPPRESS)
    a = p.parse_args()
    if a.worker:
        (eval_worker if a.eval else feat_worker if a.feat else worker)(a.worker)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("ingp_kernel_probe needs a CUDA device")
    sys.path.insert(0, str(HEAD))
    if a.draws:
        out = _draws_rt(a.draws, a.draws_width) if a.draws_width else _draws(a.draws)
        print(json.dumps(out), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[card] {torch.cuda.get_device_name(0)} | {smi}", flush=True)
    out = {"card": smi}
    if a.long_rays:
        out["long"] = long_worker()
        print(json.dumps(out), flush=True)
        return 0
    mode = "--eval" if a.eval else "--feat" if a.feat else ""
    if not mode:
        out.update(acc=_acc_errors(), rate=_rate(), forms=_forms())
    if a.base:
        out["parent"] = _run("parent", Path(a.base), mode)
    if not a.no_head:
        out["head"] = _run("head", HEAD, mode)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
