#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``nerf_meets_mlx_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: needs CUDA; prints the card's name and ``nvidia-smi`` power
   limit; turns TF32 off so fp32 matmuls of the plain versions are fp32.
2. build: compiles every CUDA source of the main paths from the checkout
   (one ``nvcc`` per source, all started together) and prints the ptxas
   report (registers, shared memory, spills); each source is joined only
   before the first phase that needs it (``fused_ingp.cu`` and
   ``fused_feat.cu`` take minutes), and all before any timing.
3. kernels vs plain: each kernel against its plain PyTorch version at the
   main paths' shapes (full-width lego_hierarchical weights from a seeded
   init, 4096 rays, S = 64 and 192, both MLPs, both compositing modes; the
   train kernel also with the white background on and off and density
   noise on, its dW and db against autograd through the plain version).
4. serving path: saves a seeded checkpoint and calls ``render_only(
   preset="lego_hierarchical", synth_resolution=400, n_orbit=2)`` with every
   launch count at 0; checks the counts, the frames, and the first chunk of
   frame 0 against the plain (standard) route.
5. training path: ``train_nerf(preset="lego_hierarchical",
   synth_resolution=400, max_iters=100, precrop_iters=20,
   render_video=False)`` with every launch count at 0: 200 train-kernel
   launches, the eval launches of its test renders, a falling loss (the
   last 10 steps against the first 10 past the central crop); then
   ``render_only`` serves the checkpoint it wrote; then 3 steps from one
   seed on the fused route and on the plain (standard, autograd) route
   must give the same parameters.
   The same for ``preset="lego_occ"`` (32 + 64 samples, AABB, the learned
   64³ occupancy grid updated every 16 steps): 200 train launches, 7
   launches of the fused MLP forward kernel (the grid updates at steps 0,
   16, ..., 96), no MLP backward, a falling loss, a non-empty grid in the
   checkpoint, and ``render_only`` serving it with the grid. Then 3 lego_occ
   steps from one seed, the grid updated every step, on the fused-train
   route, on ``use_fused_train=False`` (the MLP forward and backward
   kernels: the backward kernel's path) and on the plain route must agree.
   Before the paths: the fused MLP kernels against their plain version on
   the grid update's 262,144 points and lego_occ's coarse and fine points
   (the forward, ``csrc/mlp_fwd_tc.cu``, also within MLP_TIGHT, which one
   TF32 pass misses; the backward, ``csrc/mlp_bwd_tc.cu``, with every dW,
   db and dX against autograd, ``fused_mlp.grad_check``).
6. timing: each kernel per level with CUDA events, beside its bound and
   its plain version's time (the eval kernel also beside its fp32 bound,
   with the weight bytes it reads from L2 a launch and their rate, and the
   per-launch weight packs; the train kernel's three launches also apart,
   from the profiler's kernel table); the frame time of the render; the host
   seconds of a warm train step (25 steps ending in one synchronize),
   rays/s, peak memory, and the device's busy share of 5 steps from
   ``torch.profiler``; the fused MLP kernels per call at lego_occ's shapes
   (each timed forward call held against plain, its kernel's device time,
   device events and host ms a call beside; the backward's kernels' device
   time, its launches and host ms a call, beside its 3xTF32 and workspace
   bounds);
   lego_occ's warm step on both of its kernel routes (32 steps, two grid
   updates inside), its busy share, and its 400 x 400 frame with the grid.

7. the INGP path (``lego_ingp``: hash grid of 8 levels x 2^14 x 2, degree-4
   spherical harmonics, 2 x 64 MLPs, 48 + 48 samples, lr 1e-2, encoding
   weight decay; ``lego_ingp_occ``: 32 + 32 samples and the 64³ grid): the
   four INGP kernels against their plain versions (the hash forward on the
   grid update's and a step's points, its dG; the eval kernel
   (``csrc/ingp_eval_tc.cu``, both levels routed to it) and the train kernel
   at 4096 rays, S = 48 and 96, both MLPs, both modes, white background on
   and off: values to atol 1e-4 + rtol 1e-4, the hash dG kernel to 1e-4 and
   the train kernel's dW and dG to 1e-3 of max |plain|, sse and dW bit for
   bit over two launches); ``train_nerf(preset="lego_ingp", ...)`` as in phase 5 with
   every count at 0: 200 INGP train launches, 50 INGP eval launches, no hash
   launches, a falling loss, ``render_only`` serving it; the same for
   ``lego_ingp_occ`` (200 train and 7 hash-forward launches, a non-empty
   grid); 3 lego_ingp steps from one seed on the fused-train route, on
   ``use_fused_train=False`` (the hash forward and dG kernels) and on the
   plain route must agree, table entries no point touched equal to the
   decayed init; then, after phase 6, each INGP kernel per launch beside
   its bound and plain version (the eval call also by its kernel's device
   time), and both presets' warm step, frame, peak memory and busy share.

8. the image path (``image2d``: 2-D sinusoidal encoding, 8 x 256 MLP):
   the image train kernels (``csrc/image_train_tc.cu``) against their plain
   version at 4096 and 4001 pixels (sse, every dW and db) and the forward
   kernel (``csrc/image_fwd_tc.cu``, also within IMAGE_TIGHT) on a 400 x 400
   frame; ``image_learning(size=400, max_iters=300,
   frame_every=100)`` with every count at 0: 300 train launches, all on
   that build, and 4 forward launches, a rising PSNR; then each kernel per
   launch (the train call's device time by kernel too) and the warm step
   on both routes.

9. the "feats" route: the feat train kernel against its plain version at
   4096 rays x 48 / 96 samples with 16 and 32 feature channels (the
   tensor-core kernel of ``csrc/ingp_train_tc.cu``), 1024 x 384 and 64 x
   2048 (``csrc/fused_feat.cu``), both modes, white on and off, noise on
   (gradients also against the plain version in float64), each with the
   build the router picked; two launches at the paper tables' levels
   bit-identical; ``train_nerf(preset="lego_ingp")`` with the overlay of
   the Instant-NGP paper's tables (16 levels of 2^19, resolutions to 512),
   both levels routed to the tensor-core kernel: 200 feat-train launches
   and no other, a falling
   loss, a test PSNR, the tables and their Adam moments in the checkpoint;
   3 lego_ingp steps at 128 + 256 samples on the fused-train route (hash
   forward, feat train, hash dG) and on the plain route must agree; then
   the kernel per level, the paper-tables step, frame and trace, and the
   long-ray step.

10. the CP path (``lego_cp``: CP grid of 4 levels x 64..512 nodes x 16
   components in bf16, degree-4 spherical harmonics, 2 x 64 MLPs, 48 + 48
   samples, lr 1e-2): both CP kernels against their plain versions (the
   Pallas semantics) at a train step's 196,608 and 393,216 points and an
   eval chunk's 3,145,728, in bf16 and fp32; ``train_nerf(preset=
   "lego_cp")`` as in phase 5 with every count at 0: no kernel launch (the
   JAX route: plain encode and MLP), a falling loss, ``render_only``
   serving it; 3 lego_cp steps from one seed with the kernels behind the
   query (``with_cp_kernel``: 2 cp_fwd + 2 cp_bwd launches a step) against
   the standard route, and a frame through the kernel; then the kernels
   per launch beside their bound, their plain versions and
   ``CPGridEncoding.apply``, and lego_cp's step and frame on both.

11. the overlay commands whose shapes the fused kernels did not take
   before (``PART_A``: width 32 on lego_ingp, 16 levels, 4 features a
   level, bf16 hash compute, width 64 on lego_hierarchical and lego_occ;
   widths 128 and 256 on lego_ingp, 32 levels, 8 features a level, the
   paper tables at width 128 and at 32 levels of 4 features (128
   channels, the feats route), width 96 on lego_hierarchical and 48 on
   lego_occ): each through ``train_nerf`` for 10 steps with every count at
   0 (its kernels launched, finite metrics, a falling loss), then its
   kernels at its shapes against their plain versions (the INGP eval call
   in both compositing modes, on the build ``eval_build`` names), timed per
   level;
   and the image kernels of a width-96 image model (the Python API's
   ``image2d()``) against their plain version.

12. the hash API's last four kernels (``hash_encode_apply(...,
   compute_dx=True)`` and ``levels_in_body=False``): forward and backward
   at a lego_ingp train step's coarse and fine points with every count at
   0 (2 launches of each); each kernel against its plain version at those
   batches and at the Instant-NGP paper's tables, in fp32 and with a bf16
   encoding; each per launch beside its plain version and its byte bound.

It prints the kernels' JSON line, the ``nvidia-smi`` line, and as its last
line ``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT = ROOT / ".runs" / "chip_smoke"  # gitignored: checkpoint, frames, result.json

# published H100 SXM peaks (dense): fp32 outside the tensor cores, HBM3
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12
# the three launches of csrc/fused_train.cu, timed apart by the profiler
TRAIN_KERNELS = ("train_rays_kernel", "dw_gemm_kernel", "reduce_kernel")
# the three launches of csrc/image_train_tc.cu
IMAGE_TRAIN_KERNELS = ("image_tc_kernel", "image_dw_kernel", "image_reduce_kernel")

ATOL = 1e-4   # kernel vs plain: fp32 sums in another order (see PERF.md)
RTOL = 1e-4
DW_REL = 1e-3  # train kernel: max |dW - plain| <= DW_REL * max |plain dW|
# the MLP backward (csrc/mlp_bwd_tc.cu) is held to fused_mlp.grad_check with
# DW_REL: see there
# the MLP forward kernel (csrc/mlp_fwd_tc.cu) is also held within MLP_TIGHT
# (atol = rtol) of plain: its 3xTF32 products meet it, one TF32 pass, which
# can meet ATOL + RTOL, does not (tests/test_torch_fused_mlp.py)
MLP_TIGHT = 5e-6
# the image forward kernel (csrc/image_fwd_tc.cu) likewise within IMAGE_TIGHT
# (tests/test_torch_image.py, where the readings that set it are)
IMAGE_TIGHT = 2e-6
SEED = 0
RES = 400             # frame H = W of the main paths (lego half-res)
N_ORBIT = 2           # frames the serving path renders
COMPARE_RAYS = 4096   # rays of the kernel-vs-plain comparisons (= n_rand)
TRAIN_STEPS = 100     # steps of the training path
PRECROP = 20          # its central-crop warmup
NOISE_STD = 1.0       # density noise of the train-kernel comparison
ROUTE_STEPS = 3       # steps of the fused-vs-plain route comparison
TIMED_STEPS = 25      # warm train steps timed with the host clock
PROFILED_STEPS = 5    # train steps traced with torch.profiler


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi: not found"
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()


def mlp_macs(mlp_cfg, pos_dim: int, dir_dim: int) -> int:
    """Multiply-adds per point of the view-direction NeRF MLP."""
    D, W = mlp_cfg.net_depth, mlp_cfg.net_width
    macs = 0
    for j in range(D):
        fan_in = pos_dim if j == 0 else (W + pos_dim if (j - 1) in mlp_cfg.skips else W)
        macs += fan_in * W
    macs += W * 1 + W * W                    # alpha, feature
    macs += (W + dir_dim) * (W // 2) + (W // 2) * 3  # dir layer, rgb
    return macs


def train_macs(mlp_cfg, pos_dim: int, dir_dim: int) -> int:
    """Multiply-adds per point of one train-kernel call: the forward, dW of
    every layer (as many MACs as the forward), and the cotangents of every
    layer's input but the first's, without the skip's and the view head's
    encoding rows (the encodings have no parameters)."""
    D, W = mlp_cfg.net_depth, mlp_cfg.net_width
    fwd = mlp_macs(mlp_cfg, pos_dim, dir_dim)
    dx = (D - 1) * W * W + W * W + W + W * (W // 2) + (W // 2) * 3
    return 2 * fwd + dx


def mlp_bwd_ws_floats(mlp_cfg, pos_dim: int, dir_dim: int) -> int:
    """Floats a point of the MLP backward's workspace (csrc/mlp_bwd_tc.cu's
    make_plan): the encodings (rows padded to 8), every trunk layer's
    output, the feature and view layers' outputs, every trunk dZ, dfeat, the
    view layer's dZ and dout's four columns."""
    D, W = mlp_cfg.net_depth, mlp_cfg.net_width
    return (-(-pos_dim // 8) * 8 + -(-dir_dim // 8) * 8 + 2 * D * W + 2 * W + W + 4)


def reset_launches():
    from nerf_meets_mlx_torch.kernels import fused_train as ft

    for k in ft.LAUNCHES:
        ft.LAUNCHES[k] = 0


def launches_now() -> dict:
    from nerf_meets_mlx_torch.kernels import fused_train as ft

    return dict(ft.LAUNCHES)


def counts(**kw) -> dict:
    """A launch-count dict with every kernel's count: 0 unless given."""
    from nerf_meets_mlx_torch.kernels import fused_train as ft

    unknown = set(kw) - set(ft.LAUNCHES)
    if unknown:
        raise KeyError(f"no such launch counts: {sorted(unknown)}")
    return {k: kw.get(k, 0) for k in ft.LAUNCHES}


def cuda_time_ms(fn, n: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def make_model(cfg, device):
    import torch
    from nerf_meets_mlx_torch.models import create_nerf

    return create_nerf(cfg, device=device).init(torch.Generator().manual_seed(SEED))


def frame_rays(H: int, W: int, device, pose_index: int = 0):
    """Rays of one orbit frame of the procedural scene's camera."""
    import torch
    from nerf_meets_mlx_torch.cameras.pose import orbit_poses
    from nerf_meets_mlx_torch.cameras.rays import get_rays
    from nerf_meets_mlx_torch.datasets.synthetic import CAMERA_ANGLE_X

    focal = 0.5 * W / np.tan(0.5 * CAMERA_ANGLE_X)
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    c2w = orbit_poses(160)[pose_index][:3, :4]
    ro, rd = get_rays(H, W, K, c2w, device=device)
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    return ro, rd, rd / torch.linalg.vector_norm(rd, dim=-1, keepdim=True)


def level_inputs(model, ro, rd, vd):
    """(z, deltas) of the coarse level and of the fine level, as the fused
    eval route makes them for these rays."""
    import torch
    from nerf_meets_mlx_torch.kernels.fused_train import fused_eval_reference
    from nerf_meets_mlx_torch.sampling.importance import merge_z, sample_pdf

    rcfg = model.cfg.render
    dnorm = torch.linalg.vector_norm(rd, dim=-1, keepdim=True)

    def deltas_of(z):
        return torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1) * dnorm

    z_c = model._coarse_z(ro, rd, train=False)
    with torch.no_grad():
        _, w_c = fused_eval_reference(
            model.coarse, model.pos_enc, model.dir_enc, tspec_for(model, rcfg.n_samples),
            ro, rd, vd, z_c, deltas_of(z_c),
        )
    z_f = merge_z(z_c, sample_pdf(z_c, w_c, rcfg.n_importance, deterministic=True))
    return (z_c, deltas_of(z_c)), (z_f, deltas_of(z_f))


def tspec_for(model, n_samples: int, mode=None):
    from nerf_meets_mlx_torch.kernels.fused_train import TrainSpec, eval_block

    rcfg = model.cfg.render
    return TrainSpec(
        n_samples=n_samples, rays_block=eval_block(n_samples),
        mode=mode or rcfg.compositing, density_activation=rcfg.density_activation,
        white_bkgd=rcfg.white_bkgd,
    )


def train_tspec(model, n_samples: int, mode=None, white=None):
    from nerf_meets_mlx_torch.kernels.fused_train import (
        TrainSpec,
        default_group,
        default_rays_block,
    )

    rcfg = model.cfg.render
    rb = default_rays_block(n_samples)
    return TrainSpec(
        n_samples=n_samples, rays_block=rb, mode=mode or rcfg.compositing,
        density_activation=rcfg.density_activation,
        white_bkgd=rcfg.white_bkgd if white is None else white,
        group=default_group(n_samples, rb),
    )


def picked_rays(device):
    """COMPARE_RAYS rays of orbit frame 0 at RES x RES, picked without
    replacement."""
    import torch

    ro, rd, vd = frame_rays(RES, RES, device)
    pick = torch.as_tensor(
        np.random.default_rng(SEED).choice(ro.shape[0], COMPARE_RAYS, replace=False),
        device=device,
    )
    return ro[pick].contiguous(), rd[pick].contiguous(), vd[pick].contiguous()


def train_level_inputs(model, ro, rd, vd, target, gen, noise_std: float):
    """(z, deltas, noise) of the coarse and of the fine level, as the fused
    train route makes them: jittered coarse depths, importance samples from
    the coarse level's weights (plain version), pre-scaled density noise."""
    import torch
    from nerf_meets_mlx_torch.kernels import fused_train as ft
    from nerf_meets_mlx_torch.sampling.importance import merge_z, sample_pdf

    rcfg = model.cfg.render
    dnorm = torch.linalg.vector_norm(rd, dim=-1, keepdim=True)

    def level(z):
        dl = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1) * dnorm
        return z, dl, torch.randn(z.shape, generator=gen, device=z.device) * noise_std

    coarse = level(model._coarse_z(ro, rd, train=True, generator=gen))
    with torch.no_grad():
        _, _, w_c = ft.fused_train_reference(
            model.coarse, model.pos_enc, model.dir_enc, train_tspec(model, rcfg.n_samples),
            ro, rd, vd, *coarse, target,
        )
    u = torch.rand((ro.shape[0], rcfg.n_importance), generator=gen, device=ro.device)
    z_f = merge_z(coarse[0], sample_pdf(coarse[0], w_c, rcfg.n_importance, u=u))
    return coarse, level(z_f)


def mlp_params(mlp):
    return [p for _, lin in mlp.linears() for p in (lin.weight, lin.bias)]


def device_times(prof) -> dict:
    """{kernel name: (device us, count)} of a torch.profiler run: device-side
    events only (kernels, copies), since an ATen op's entry repeats the
    device time of the kernels it launched, and a user annotation on the
    device timeline (the optimizer's) spans kernels counted already."""
    import torch

    agg = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if getattr(e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        t, n = agg.get(e.name, (0.0, 0))
        agg[e.name] = (t + float(us), n + 1)
    return agg


def kernel_split_ms(fn, names, n: int) -> dict:
    """Device ms per call of ``fn()`` of each kernel of ``names`` (matched
    as a substring of the profiler's kernel name, PyTorch's own kernels
    excluded), from torch.profiler over ``n`` calls after one warm call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {k: 0.0 for k in names}
    for name, (us, _) in device_times(prof).items():
        for k in names:
            if k in name and "at::" not in name:
                out[k] += us / 1e3 / n
    return out


def launches_a_call(fn, kernel: str, n: int = 3) -> float:
    """Device launches a call of ``fn()`` of the kernels whose names hold
    ``kernel`` (torch.profiler over ``n`` calls after one warm call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(c for name, (_, c) in device_times(prof).items() if kernel in name) / n


def call_split(fn, kernel: str, n: int) -> dict:
    """A call of ``fn()`` apart: the device ms of the kernels named
    ``kernel`` (a substring of the profiler's name) and of every other
    device event, and the device events, per call (torch.profiler over
    ``n`` calls after one warm call); and the median host ms of a call,
    a synchronize before each of ``n`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    mine = other = 0.0
    events = 0
    for name, (us, cnt) in device_times(prof).items():
        events += cnt
        if kernel in name:
            mine += us
        else:
            other += us
    host = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return {"device_ms": mine / 1e3 / n, "other_device_ms": other / 1e3 / n,
            "device_events": events / n, "host_ms": sorted(host)[n // 2]}


def profile_device(fn, label: str):
    """Device time by kernel name over ``fn()`` (torch.profiler), and the
    device's busy share of its wall time under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    agg = device_times(prof)
    rows = [(k, t, n) for k, (t, n) in agg.items() if t > 0]
    rows.sort(key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    if busy_us == 0:
        log("[trace] the profiler recorded no device time: busy share not measured")
        return {"wall_ms": wall_us / 1e3, "device_busy_share": None, "top": []}
    log(f"[trace] {label} under torch.profiler: wall {wall_us / 1e3:.1f} ms, "
        f"device busy {busy_us / 1e3:.1f} ms ({busy_us / wall_us:.4f} of wall)")
    for name, us, n in rows[:8]:
        log(f"[trace]   {us / 1e3:10.3f} ms  x{n:<4d} {name[:90]}")
    return {
        "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / wall_us,
        "top": [{"name": n[:120], "ms": us / 1e3, "count": c} for n, us, c in rows[:8]],
    }


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[device] {name} | torch {torch.__version__} cuda {torch.version.cuda} | {smi}")
    return name, smi


BUILD_T0 = [0.0]


def phase_build():
    """Starts one nvcc per build (``build_variants``: a source, or one shape
    of the per-shape INGP and feat sources), all together; returns their
    futures by source. ``wait_builds`` joins a source's builds where a phase
    first needs them, so that the slow ones overlap the earlier phases."""
    from nerf_meets_mlx_torch.kernels import _build

    variants = build_variants()
    BUILD_T0[0] = time.perf_counter()
    ex = ThreadPoolExecutor(len(variants))
    futures = {}
    for name, defines in variants:
        futures.setdefault(name, []).append((defines, ex.submit(_build.build, name, defines)))
    ex.shutdown(wait=False)
    return futures


def wait_builds(futures, names):
    from nerf_meets_mlx_torch.kernels import _build

    t0 = time.perf_counter()
    paths = [f.result() for name in names for _, f in futures[name]]
    log(f"[build] {', '.join(p.name for p in paths)}: waited {time.perf_counter() - t0:.1f} s, "
        f"{time.perf_counter() - BUILD_T0[0]:.1f} s after the builds started")
    for name in names:
        for defines, _ in futures[name]:
            variant = _build.variant_name(name, defines)
            for line in _build.BUILD_LOG.get(variant, "(cached build)").splitlines():
                if any(k in line for k in ("registers", "spill", "smem", "Compiling entry",
                                           "arning")):
                    log(f"[build] {variant}: {line.strip()}")
            _build.load_library(name, defines)


def phase_compare(device):
    """Kernel vs plain at the main path's shapes; returns the max abs error."""
    import torch
    from nerf_meets_mlx_torch.config import lego_hierarchical
    from nerf_meets_mlx_torch.kernels import fused_train as ft

    model = make_model(lego_hierarchical(), device)
    ro, rd, vd = frame_rays(RES, RES, device)
    pick = torch.as_tensor(
        np.random.default_rng(SEED).choice(ro.shape[0], COMPARE_RAYS, replace=False),
        device=device,
    )
    ro, rd, vd = ro[pick].contiguous(), rd[pick].contiguous(), vd[pick].contiguous()
    levels = level_inputs(model, ro, rd, vd)
    worst = 0.0
    ft.LAUNCHES["eval"] = 0
    for z, dl in levels:
        S = z.shape[1]
        for level, mlp in (("coarse", model.coarse), ("fine", model.fine)):
            for mode in ("canonical", "reference"):
                tspec = tspec_for(model, S, mode=mode)
                args = (mlp, model.pos_enc, model.dir_enc, tspec, ro, rd, vd, z, dl)
                with torch.no_grad():
                    rgb_k, w_k = ft.fused_eval_apply(*args)
                    torch.cuda.synchronize()
                    rgb_p, w_p = ft.fused_eval_reference(*args)
                # share of samples that carry weight: how much compositing
                # the comparison exercised
                live = float((w_p > 1e-4).float().mean())
                for what, k, p in (("rgb", rgb_k, rgb_p), ("weights", w_k, w_p)):
                    err = (k - p).abs()
                    abs_err = float(err.max())
                    rel_err = float((err / p.abs().clamp_min(1e-6)).max())
                    ok = bool(torch.isfinite(k).all()) and bool(
                        (err <= ATOL + RTOL * p.abs()).all()
                    )
                    log(f"[compare] fused_eval S={S} {level:6s} mlp {mode:9s} {what:7s} "
                        f"max_abs={abs_err:.3e} max_rel={rel_err:.3e} "
                        f"(weights > 1e-4: {live:.3f}) {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(
                            f"fused_eval disagrees with its plain version: S={S} {level} {mode} {what}"
                        )
                    worst = max(worst, abs_err)
    ft.LAUNCHES["eval"] = 0
    return worst


def mlp_inputs(model, device):
    """The point sets the fused MLP kernels see on lego_occ's paths, as
    (name, pts [N, 3], dirs [N, 3]): one jittered point per cell of the 64³
    grid with zero directions (the grid update), and the coarse (4096 x 32)
    and fine (4096 x 96) points of a train step with their rays' view
    directions (the value_and_grad route)."""
    import torch
    from nerf_meets_mlx_torch.acceleration.occupancy import _cell_points

    rcfg = model.cfg.render
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    lo = torch.tensor(rcfg.aabb[:3], device=device)
    hi = torch.tensor(rcfg.aabb[3:], device=device)
    cells = _cell_points(rcfg.occ_resolution, lo, hi, generator=gen)
    out = [("grid", cells, torch.zeros_like(cells))]
    ro, rd, vd = picked_rays(device)
    target = torch.rand((ro.shape[0], 3), generator=gen, device=device)
    for name, (z, _, _) in zip(("coarse", "fine"),
                               train_level_inputs(model, ro, rd, vd, target, gen, 0.0)):
        R, S = z.shape
        pts = (ro[:, None, :] + z[..., None] * rd[:, None, :]).reshape(-1, 3)
        out.append((name, pts, vd[:, None, :].expand(R, S, 3).reshape(-1, 3).contiguous()))
    return out


def mlp_fwd_errors(raw_k, raw_p):
    """(max abs error, worst share of MLP_TIGHT, ok) of the MLP forward
    kernel's raw against plain: ok within ATOL + RTOL and within MLP_TIGHT
    (atol = rtol), all finite."""
    import torch

    err = (raw_k - raw_p).abs()
    tight = float((err / (MLP_TIGHT * (1.0 + raw_p.abs()))).max())
    ok = bool(torch.isfinite(raw_k).all()) and bool((err <= ATOL + RTOL * raw_p.abs()).all())
    return float(err.max()), tight, ok and tight <= 1.0


def phase_compare_mlp(device):
    """The fused MLP forward kernel against its plain version on the grid
    update's 262,144 points and the coarse and fine levels' 131,072 and
    393,216 (both MLPs), within ATOL + RTOL and MLP_TIGHT, and the backward
    kernels at the coarse and fine levels with random dout, compute_dx off
    and on: every dW, db and dX against autograd through the plain version
    (``fused_mlp.grad_check``). Returns (max abs error of raw, max abs error
    and worst ratio of the gradients against the fp32 plain version)."""
    import torch
    from nerf_meets_mlx_torch.config import lego_occ
    from nerf_meets_mlx_torch.kernels import fused_mlp as fm

    model = make_model(lego_occ(), device)
    sets = {name: (p, d) for name, p, d in mlp_inputs(model, device)}
    worst_raw, worst_g, worst_ratio = 0.0, 0.0, 0.0
    for name in ("grid", "coarse", "fine"):
        pts, dirs = sets[name]
        for level in ("coarse", "fine"):
            mlp = getattr(model, level)
            with torch.no_grad():
                raw_k = fm.fused_mlp_apply(mlp, model.pos_enc, model.dir_enc, pts, dirs)
                torch.cuda.synchronize()
                raw_p = fm.fused_mlp_reference(mlp, model.pos_enc, model.dir_enc, pts, dirs)
            err, tight, ok = mlp_fwd_errors(raw_k, raw_p)
            log(f"[compare] fused_mlp forward {name:6s} N={pts.shape[0]} {level:6s} mlp "
                f"max_abs={err:.3e} ({tight:.3f} of MLP_TIGHT) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"fused_mlp forward disagrees with its plain version: {name}")
            worst_raw = max(worst_raw, err)
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    for name in ("coarse", "fine"):
        pts, dirs = sets[name]
        dout = torch.randn((pts.shape[0], 4), generator=gen, device=device)
        mlp = getattr(model, name)
        params = mlp_params(mlp)
        for compute_dx in (False, True):
            p = pts.clone().requires_grad_(compute_dx)
            d = dirs.clone().requires_grad_(compute_dx)
            wrt = params + ([p, d] if compute_dx else [])
            out = fm.fused_mlp_apply(mlp, model.pos_enc, model.dir_enc, p, d, compute_dx=compute_dx)
            g_k = torch.autograd.grad((out * dout).sum(), wrt)
            torch.cuda.synchronize()
            del out
            check = fm.grad_check(mlp, model.pos_enc, model.dir_enc, pts, dirs, dout, compute_dx,
                                  g_k, DW_REL)
            worst_g = max(worst_g, check.err32)
            log(f"[compare] fused_mlp backward {name:6s} N={pts.shape[0]} compute_dx="
                f"{int(compute_dx)}: {check.describe()} {'ok' if check.ok else 'FAIL'}")
            if not check.ok:
                raise AssertionError(
                    f"fused_mlp backward disagrees with its plain version: {name} dx={compute_dx}")
            worst_ratio = max(worst_ratio, max(check.r32))
    reset_launches()
    return worst_raw, worst_g, worst_ratio


def phase_main_path(device):
    """The serving entry point, with the launch counts read around it."""
    import torch
    from nerf_meets_mlx_torch.config import lego_hierarchical
    from nerf_meets_mlx_torch.engine.checkpoint import save_checkpoint
    from nerf_meets_mlx_torch.entrypoints import render_only
    from nerf_meets_mlx_torch.kernels import fused_train as ft
    from nerf_meets_mlx_torch.rendering.renderer import to8b

    res_px, n_orbit = RES, N_ORBIT
    cfg = lego_hierarchical()
    log_dir = OUT / "lego_hierarchical"
    shutil.rmtree(log_dir, ignore_errors=True)
    save_checkpoint(log_dir / "ckpt", make_model(cfg, device), step=0)

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = render_only(
        preset="lego_hierarchical", log_dir=str(log_dir),
        synth_resolution=res_px, n_orbit=n_orbit, device=device,
    )
    launches = launches_now()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    chunks = -(-res_px * res_px // cfg.render.ray_chunk)
    want = counts(eval=2 * chunks * n_orbit)
    log(f"[main] render_only -> {res['frames']}; launches {launches} (want {want}); "
        f"frame seconds {res['frame_seconds']}; peak device memory {peak_gb:.2f} GB")
    if launches != want:
        raise AssertionError(f"render_only launched {launches}, want {want}")
    frames = np.load(res["frames"])
    if frames.shape != (n_orbit, res_px, res_px, 3) or frames.dtype != np.uint8:
        raise AssertionError(f"frames {frames.shape} {frames.dtype}")

    # first chunk of frame 0: fused route vs the plain (standard) route
    fused = make_model(cfg.replace(use_fused_kernel=True), device)
    plain = make_model(cfg, device)
    ro, rd, vd = frame_rays(res_px, res_px, device)
    c = cfg.render.ray_chunk
    ro, rd, vd = ro[:c], rd[:c], vd[:c]
    with torch.no_grad():  # the standard route's eval keeps gradients otherwise
        out_f = fused.render_rays(ro, rd, train=False, viewdirs=vd)
        out_p = plain.render_rays(ro, rd, train=False, viewdirs=vd)
    for k in sorted(out_p):
        if not bool(torch.isfinite(out_f[k]).all()):
            raise AssertionError(f"fused route: non-finite {k}")
        err = (out_f[k] - out_p[k]).abs()
        ok = bool((err <= ATOL + RTOL * out_p[k].abs()).all())
        log(f"[main] chunk 0 fused vs plain route {k:12s} max_abs={float(err.max()):.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"fused route disagrees with the plain route on {k}")
    got = frames[0].reshape(-1, 3)[:c].astype(np.int16)
    diff = int(np.abs(got - to8b(out_f["rgb_map"]).astype(np.int16)).max())
    log(f"[main] frame 0 from render_only vs the fused chunk: max uint8 diff {diff}")
    if diff > 1:
        raise AssertionError("render_only's frame 0 disagrees with the fused route")
    ft.LAUNCHES["eval"] = 0
    return launches, res, fused


def phase_timing(fused, res, device):
    import torch
    from nerf_meets_mlx_torch.kernels import fused_train as ft

    cfg = fused.cfg
    ro, rd, vd = frame_rays(RES, RES, device)
    c = cfg.render.ray_chunk
    ro, rd, vd = ro[:c].contiguous(), rd[:c].contiguous(), vd[:c].contiguous()
    levels = level_inputs(fused, ro, rd, vd)
    wbytes = 4 * ft.pack_eval_weights(fused.coarse, fused.pos_enc, fused.dir_enc)[0].numel()
    # the kernel streams every dense layer's TF32 hi and lo images (the
    # wrapper packs them per launch) from L2 through shared memory once per
    # 128-point tile
    img_bytes = 4 * ft.pack_eval_wgmma(fused.coarse, fused.pos_enc, fused.dir_enc).numel()
    with torch.no_grad():
        pack_ms = cuda_time_ms(lambda: (
            ft.pack_eval_weights(fused.coarse, fused.pos_enc, fused.dir_enc),
            ft.pack_eval_wgmma(fused.coarse, fused.pos_enc, fused.dir_enc)), 10)
    per_level = {}
    for name, (z, dl), mlp, reps in (
        ("coarse", levels[0], fused.coarse, 10), ("fine", levels[1], fused.fine, 4)
    ):
        R, S = z.shape
        tspec = tspec_for(fused, S)
        args = (mlp, fused.pos_enc, fused.dir_enc, tspec, ro, rd, vd, z, dl)
        with torch.no_grad():
            k_ms = cuda_time_ms(lambda: ft.fused_eval_apply(*args), reps)
            p_ms = cuda_time_ms(lambda: ft.fused_eval_reference(*args), max(2, reps // 2))
            k_ms2 = cuda_time_ms(lambda: ft.fused_eval_apply(*args), reps)
        flops = 2.0 * mlp_macs(mlp.cfg, fused.pos_enc.out_dim, fused.dir_enc.out_dim) * R * S
        nbytes = 4 * (9 * R + 2 * R * S + 3 * R + R * S) + wbytes
        # the dense layers run in 3xTF32: three TF32 tensor-core products
        # for each fp32 one (the heads' few MACs are counted with them)
        ops_s, bytes_s = 3 * flops / TF32_FLOPS, nbytes / HBM_BYTES_PER_S
        bound_ms = max(ops_s, bytes_s) * 1e3
        ms = (k_ms + k_ms2) / 2
        tiles = -(-R // tspec.rays_block) * -(-tspec.rays_block * S // 128)
        l2_gb = img_bytes * tiles / 1e9
        per_level[name] = dict(
            rays=R, samples=S, ms=ms, ms_runs=[k_ms, k_ms2], plain_ms=p_ms,
            bound_ms=bound_ms, bound_by="operations" if ops_s > bytes_s else "bytes",
            fp32_bound_ms=max(flops / FP32_FLOPS, bytes_s) * 1e3,
            tf32_bound_ms=flops / TF32_FLOPS * 1e3, tflops=flops / 1e12,
            achieved_tflops_s=flops / (ms * 1e-3) / 1e12, l2_weight_gb=l2_gb,
            l2_tb_s=l2_gb / ms, pack_ms=pack_ms,
        )
        log(f"[time] fused_eval {name:6s} R={R} S={S}: kernel {k_ms:.3f} / {k_ms2:.3f} ms, "
            f"plain {p_ms:.3f} ms, 3xTF32 bound {bound_ms:.3f} ms "
            f"({per_level[name]['bound_by']}), fp32 bound "
            f"{per_level[name]['fp32_bound_ms']:.3f} ms, TF32 bound "
            f"{flops / TF32_FLOPS * 1e3:.3f} ms, {flops / 1e12:.3f} TFLOP -> "
            f"{per_level[name]['achieved_tflops_s']:.2f} TFLOP/s; weights from L2 "
            f"{l2_gb:.2f} GB a launch ({tiles} tiles x {img_bytes} B) -> "
            f"{per_level[name]['l2_tb_s']:.3f} TB/s; weight packs {pack_ms:.3f} ms a launch")

    # frame time of the fused render at 400 x 400 (warm), host clock around
    # work that ends in a synchronize
    from nerf_meets_mlx_torch.datasets.synthetic import CAMERA_ANGLE_X
    from nerf_meets_mlx_torch.cameras.pose import orbit_poses
    from nerf_meets_mlx_torch.rendering import render_image

    focal = 0.5 * RES / np.tan(0.5 * CAMERA_ANGLE_X)
    K = np.array([[focal, 0, RES / 2], [0, focal, RES / 2], [0, 0, 1]], np.float32)
    times = []
    for pose in orbit_poses(160)[:2]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_image(fused, RES, RES, K, pose[:3, :4])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ft.LAUNCHES["eval"] = 0
    frame_s = min(times)
    trace = profile_device(
        lambda: render_image(fused, RES, RES, K, orbit_poses(160)[0][:3, :4]),
        f"one {RES}x{RES} frame",
    )
    ft.LAUNCHES["eval"] = 0
    log(f"[time] render_image {RES}x{RES} lego_hierarchical: frames {times} s -> "
        f"{frame_s:.4f} s/frame, {RES * RES / frame_s:.1f} rays/s; "
        f"render_only frame seconds {res['frame_seconds']}")
    return per_level, {"frame_seconds": times, "rays_per_s": RES * RES / frame_s, "trace": trace}


def phase_compare_train(device):
    """The train kernel vs its plain version (values and every dW, db);
    returns (max abs error of the values, worst dW ratio)."""
    import torch
    from nerf_meets_mlx_torch.config import lego_hierarchical
    from nerf_meets_mlx_torch.kernels import fused_train as ft

    model = make_model(lego_hierarchical(), device)
    ro, rd, vd = picked_rays(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    target = torch.rand((ro.shape[0], 3), generator=gen, device=device)
    levels = train_level_inputs(model, ro, rd, vd, target, gen, NOISE_STD)
    worst_val, worst_dw = 0.0, 0.0
    ft.LAUNCHES["train"] = 0
    for z, dl, nz in levels:
        S = z.shape[1]
        for level, mlp in (("coarse", model.coarse), ("fine", model.fine)):
            params = mlp_params(mlp)
            for mode in ("canonical", "reference"):
                for white in (True, False):
                    tspec = train_tspec(model, S, mode=mode, white=white)
                    args = (mlp, model.pos_enc, model.dir_enc, tspec, ro, rd, vd, z, dl, nz, target)
                    sse_k, rgb_k, w_k = ft.fused_train_apply(*args)
                    g_k = torch.autograd.grad(sse_k, params)
                    torch.cuda.synchronize()
                    sse_p, rgb_p, w_p = ft.fused_train_reference(*args)
                    g_p = torch.autograd.grad(sse_p, params)
                    live = float((w_p > 1e-4).float().mean())
                    errs, ok = {}, True
                    for what, k, p in (("sse", sse_k, sse_p), ("rgb", rgb_k, rgb_p),
                                       ("weights", w_k, w_p)):
                        k, p = k.detach(), p.detach()
                        err = (k - p).abs()
                        errs[what] = float(err.max())
                        ok &= bool(torch.isfinite(k).all()) and bool(
                            (err <= ATOL + RTOL * p.abs()).all()
                        )
                    ratios = []
                    for a, b in zip(g_k, g_p):
                        scale = float(b.abs().max())
                        err = float((a - b).abs().max())
                        ratios.append(err / scale if scale > 0 else (0.0 if err == 0 else float("inf")))
                        ok &= bool(torch.isfinite(a).all())
                    ok &= max(ratios) <= DW_REL
                    log(f"[compare] fused_train S={S} {level:6s} mlp {mode:9s} white={int(white)} "
                        f"max_abs sse={errs['sse']:.3e} rgb={errs['rgb']:.3e} "
                        f"weights={errs['weights']:.3e} (weights > 1e-4: {live:.3f}); "
                        f"max|dW-plain|/max|plain| per array: "
                        + " ".join(f"{r:.1e}" for r in ratios) + f" {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(
                            f"fused_train disagrees with its plain version: S={S} {level} "
                            f"{mode} white={white}"
                        )
                    worst_val = max(worst_val, errs["rgb"], errs["weights"])
                    worst_dw = max(worst_dw, max(ratios))
    ft.LAUNCHES["train"] = 0
    return worst_val, worst_dw


def phase_train_main_path(device, preset="lego_hierarchical", extra="", tag=None):
    """The training entry point with every launch count set to 0 before it
    and read after it, then the serving entry point on the checkpoint it
    wrote (with its occupancy grid, when the preset has one). ``extra``
    holds text-overlay lines beyond ``i_print = 1``; a run with them (the
    paper-size tables, ``tag``) is not served, since ``render_only`` takes
    no overlay in either package."""
    import torch
    from nerf_meets_mlx_torch.config import PRESETS, config_from_text
    from nerf_meets_mlx_torch.entrypoints import render_only, train_nerf

    tag = tag or preset
    log_dir = OUT / f"train_{tag}"
    shutil.rmtree(log_dir, ignore_errors=True)
    OUT.mkdir(parents=True, exist_ok=True)
    overlay = OUT / f"overlay_{tag}.txt"  # i_print = 1: every step's loss is logged
    overlay.write_text("i_print = 1\n" + extra)
    cfg = config_from_text(overlay, PRESETS[preset]())
    rcfg = cfg.render

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train_nerf(
        preset=preset, synth_resolution=RES, max_iters=TRAIN_STEPS,
        precrop_iters=PRECROP, render_video=False, device=device,
        log_dir=str(log_dir), config_txt=str(overlay),
    )
    wall = time.perf_counter() - t0
    launches = launches_now()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    chunks = -(-RES * RES // rcfg.ray_chunk)
    n_frames = 1 + cfg.data.synth_n_test  # one held-out render, then the test set
    # the grid update runs at steps 0, occ_update_every, ... (one forward
    # launch each); the fused-train route never runs the MLP backward
    n_updates = -(-TRAIN_STEPS // rcfg.occ_update_every) if rcfg.occupancy else 0
    if extra:
        # the "feats" route: the feat train kernel per level, the encode by
        # the plain gather (tables past the hash kernels' budget), the
        # renders on the standard route; both levels' shapes route to the
        # tensor-core kernel
        from nerf_meets_mlx_torch.kernels import fused_feat_train as ff

        want = counts(feat_train=2 * TRAIN_STEPS)
        p_dim = cfg.pos_encoding.hash_n_levels * cfg.pos_encoding.hash_features_per_level
        builds = [ff.train_build(m.net_width, m.net_depth, p_dim, cfg.dir_encoding.out_dim, S)[0]
                  for m, S in ((cfg.mlp, rcfg.n_samples),
                               (cfg.mlp_fine, rcfg.n_samples + rcfg.n_importance))]
        log(f"[train] {tag}: the feat train call's build per level: {builds}")
        if builds != [ff.TC_SOURCE] * 2:
            raise AssertionError(f"{tag} does not route both levels to {ff.TC_SOURCE}")
    elif cfg.pos_encoding.kind == "cp_grid":
        # lego_cp trains and serves on the standard route, as in JAX: the
        # plain encode and MLP, no kernel
        want = want_served = counts()
    elif cfg.pos_encoding.kind == "hash_grid":
        # the INGP kernels; the grid update's query runs the hash forward
        want = counts(ingp_eval=2 * chunks * n_frames, ingp_train=2 * TRAIN_STEPS,
                      hash_fwd=n_updates)
        want_served = counts(ingp_eval=2 * chunks)
    else:
        want = counts(eval=2 * chunks * n_frames, train=2 * TRAIN_STEPS, mlp_fwd=n_updates)
        want_served = counts(eval=2 * chunks)
    log(f"[train] train_nerf {tag} {RES}x{RES}, {TRAIN_STEPS} steps: {wall:.1f} s "
        f"(data, steps, {n_frames} renders); launches {launches} (want {want}); "
        f"peak device memory {peak_gb:.2f} GB; result "
        + json.dumps({k: v for k, v in res.items() if k != "log_dir"}))
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want}")
    recs = [json.loads(x) for x in (log_dir / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in recs if "loss" in r]
    losses = [r["loss"] for r in steps]
    if [r["step"] for r in steps] != list(range(1, TRAIN_STEPS + 1)):
        raise AssertionError("metrics.jsonl does not log every step")
    # the first PRECROP steps see only the central crop, whose pixels have
    # another loss than whole images: the loss must fall from the first 10
    # whole-image steps to the last 10
    crop = float(np.mean(losses[:10]))
    first = float(np.mean(losses[PRECROP : PRECROP + 10]))
    last = float(np.mean(losses[-10:]))
    finite = all(np.isfinite(v) for r in recs for v in r.values() if isinstance(v, float))
    log(f"[train] {tag} loss: mean of steps 1-10 (central crop) {crop:.5f}; of steps "
        f"{PRECROP + 1}-{PRECROP + 10} (whole images) {first:.5f}, of the last 10 {last:.5f}; "
        f"all logged metrics finite: {finite}; steps/s of the logged intervals: median "
        f"{float(np.median([r['steps_per_sec'] for r in steps[1:]])):.3f}")
    if not finite or not last < first:
        raise AssertionError("the training loss did not fall, or a metric is not finite")
    out = {
        "wall_s": wall, "peak_gb": peak_gb, "loss_crop10": crop, "loss_first10": first,
        "loss_last10": last,
        "test_psnr_mean": res["test_psnr_mean"], "test_ssim_mean": res["test_ssim_mean"],
    }
    if rcfg.occupancy:
        from nerf_meets_mlx_torch.acceleration.occupancy import occupancy_binary

        state = torch.load(log_dir / "ckpt" / f"step_{TRAIN_STEPS:08d}" / "state.pt",
                           weights_only=True)
        grid = state["occ_grid"]
        occupied = float((grid > rcfg.occ_threshold).float().mean())
        dilated = float(occupancy_binary(grid, rcfg.occ_threshold).float().mean())
        log(f"[train] {preset} checkpoint grid {tuple(grid.shape)}: max {float(grid.max()):.4f}, "
            f"mean {float(grid.mean()):.4f}, cells above {rcfg.occ_threshold}: {occupied:.4f} "
            f"(dilated {dilated:.4f})")
        if not (grid.shape == (rcfg.occ_resolution,) * 3 and bool(torch.isfinite(grid).all())
                and float(grid.max()) > 0.0 and occupied > 0.0):
            raise AssertionError("the trained occupancy grid is empty or not finite")
        out.update(grid_max=float(grid.max()), grid_occupied=occupied, grid_dilated=dilated)

    reset_launches()
    if extra:
        state = torch.load(log_dir / "ckpt" / f"step_{TRAIN_STEPS:08d}" / "state.pt",
                           weights_only=True)
        tables = state["params"]["pos_enc.tables"]
        log(f"[train] {tag} checkpoint tables {tuple(tables.shape)}, Adam moments of "
            f"{sum(v['exp_avg'].numel() for v in state['optimizer']['state'].values())} "
            f"entries; test PSNR {res['test_psnr_mean']:.3f}")
        if not np.isfinite(res["test_psnr_mean"]) or not bool(torch.isfinite(tables).all()):
            raise AssertionError(f"{tag}: a non-finite test PSNR or table entry")
        out["tables_shape"] = list(tables.shape)
        return launches, out
    served = render_only(
        preset=preset, log_dir=str(log_dir), synth_resolution=RES, n_orbit=1, device=device,
    )
    frames = np.load(served["frames"])
    got = launches_now()
    log(f"[train] render_only {preset} serves step {served['step']}: frames {frames.shape}, "
        f"launches {got} (want {want_served}), frame seconds {served['frame_seconds']}")
    if served["step"] != TRAIN_STEPS or frames.shape != (1, RES, RES, 3) or got != want_served:
        raise AssertionError("render_only did not serve the trained checkpoint")
    out["served_frame_seconds"] = served["frame_seconds"]
    reset_launches()
    return launches, out


def train_scene(device):
    from nerf_meets_mlx_torch.datasets.synthetic import make_synthetic_scene

    return make_synthetic_scene(2, 1, 1, RES, device=device)


def run_route(cfg, ds, device, steps: int, seed: int, patch=None):
    """``steps`` train steps of a fresh seeded model (given to ``patch``
    first, when set) from one generator seed, with every launch count set
    to 0 before them and read after: (final parameters, per-step gradients,
    losses, launches, occupancy grid after each step's update or None)."""
    import torch
    from nerf_meets_mlx_torch.engine import TrainState, make_nerf_train_step

    images = torch.as_tensor(ds.images[ds.i_train], device=device)
    poses = torch.as_tensor(ds.poses[ds.i_train, :3, :4], device=device)
    model = make_model(cfg, device)
    if patch is not None:
        patch(model)
    occ = None
    if cfg.render.occupancy:
        from nerf_meets_mlx_torch.acceleration.occupancy import init_occupancy_grid

        occ = init_occupancy_grid(cfg.render.occ_resolution, device=device)
    state = TrainState(model, cfg.train, occ_grid=occ)
    grads, grids = [], []
    apply = state.apply_gradients

    def record_then_apply():
        grads.append([p.grad.detach().clone() for p in model.parameters()])
        if state.occ_grid is not None:
            grids.append(state.occ_grid.clone())
        apply()

    state.apply_gradients = record_then_apply
    step = make_nerf_train_step(model, ds.H, ds.W, ds.focal)
    gen = torch.Generator(device=device).manual_seed(seed)
    reset_launches()
    losses = [float(step(state, images, poses, gen)["loss"]) for _ in range(steps)]
    launches = launches_now()
    reset_launches()
    return [p.detach() for p in model.parameters()], grads, losses, launches, grids or None


def compare_params(run_a, run_b, lr, steps):
    """Adam's first steps are about lr·sign(g), so a parameter whose
    gradient sits within the routes' rounding of zero may move either way:
    parameters whose two gradients agree within 25% at every step (so their
    Adam steps differ by at most lr/12 each) are held to rtol 5e-3 / atol
    1e-4, the others to one Adam step each way per step. A gradient
    difference of r moves an Adam step by up to ~r·lr, so at a larger lr
    than lego's 5e-4 (the INGP presets' 1e-2) the agreement asked of the
    settled parameters shrinks in proportion (1.25% at 1e-2). Returns (ok,
    settled, total, worst ratio among the settled)."""
    import torch

    (p_a, g_a, l_a), (p_b, g_b, l_b) = run_a[:3], run_b[:3]
    settle = min(0.25, 0.25 * 5e-4 / lr)
    n_settled = n_all = 0
    worst = 0.0
    ok = bool(np.allclose(l_a, l_b, rtol=5e-4))
    for i, (a, b) in enumerate(zip(p_a, p_b)):
        settled = torch.ones_like(a, dtype=torch.bool)
        for ga, gb in zip(g_a, g_b):
            settled &= (ga[i] - gb[i]).abs() <= settle * gb[i].abs()
        err = (a - b).abs()
        ok &= bool((err[settled] <= 1e-4 + 5e-3 * b.abs()[settled]).all())
        ok &= bool((err[~settled] <= 2 * steps * lr + 1e-4).all())
        ok &= bool(torch.isfinite(a).all())
        n_settled += int(settled.sum())
        n_all += settled.numel()
        if bool(settled.any()):
            worst = max(worst, float((err / (1e-4 + 5e-3 * b.abs()))[settled].max()))
    return ok, n_settled, n_all, worst


def phase_train_routes(ds, device):
    """ROUTE_STEPS steps of lego_hierarchical from one seed on the fused
    route and on the plain (standard, autograd) route must give the same
    parameters (``compare_params``)."""
    from nerf_meets_mlx_torch.config import lego_hierarchical

    cfg = lego_hierarchical()
    fused = run_route(cfg.replace(use_fused_kernel=True), ds, device, ROUTE_STEPS, SEED + 1)
    plain = run_route(cfg, ds, device, ROUTE_STEPS, SEED + 1)
    for name, run, want in (("fused", fused, 2 * ROUTE_STEPS), ("plain", plain, 0)):
        if run[3] != counts(train=want):
            raise AssertionError(f"{name} route launched {run[3]}")
    ok, n_settled, n_all, worst = compare_params(fused, plain, cfg.train.lrate, ROUTE_STEPS)
    log(f"[routes] {ROUTE_STEPS} steps, fused vs plain route: losses {fused[2]} vs {plain[2]}; "
        f"{n_settled}/{n_all} parameters whose gradients agree within 25%, worst "
        f"|diff|/(1e-4 + 5e-3|p|) among them {worst:.3f}; the other {n_all - n_settled} "
        f"within {2 * ROUTE_STEPS} lr: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the fused and the plain route disagree after 3 steps")
    return {"losses_fused": fused[2], "losses_plain": plain[2], "unsettled": n_all - n_settled,
            "worst_ratio": worst}


GRID_ATOL = 1e-5  # routes' grids: fp32 sums in another order, weights within compare_params


def phase_occ_routes(ds, device):
    """ROUTE_STEPS lego_occ steps from one seed, the grid updated at every
    step and gating from step 0, on three routes: the fused-train route
    (train kernel, plus the MLP forward kernel for each grid update),
    use_fused_train=False (the value_and_grad route: the MLP forward and
    backward kernels at both levels, plus the update) and the plain route.
    The parameters must agree as ``compare_params`` holds them, and the
    grid after the first update (all routes on the same weights) and after
    the last step within GRID_ATOL. The
    value_and_grad run is the MLP backward kernel's path: its launches are
    reported in the kernels line."""
    import torch
    from nerf_meets_mlx_torch.config import lego_occ

    base = lego_occ()
    base = base.replace(render=dataclasses.replace(base.render, occ_update_every=1, occ_warmup=0))
    S = ROUTE_STEPS
    runs = {
        "fused_train": run_route(base.replace(use_fused_kernel=True), ds, device, S, SEED + 3),
        "value_and_grad": run_route(
            base.replace(use_fused_kernel=True, use_fused_train=False), ds, device, S, SEED + 3),
        "plain": run_route(base, ds, device, S, SEED + 3),
    }
    want = {
        "fused_train": counts(train=2 * S, mlp_fwd=S),
        "value_and_grad": counts(mlp_fwd=3 * S, mlp_bwd=2 * S),
        "plain": counts(),
    }
    out = {}
    plain = runs["plain"]
    for route in ("fused_train", "value_and_grad"):
        run = runs[route]
        if run[3] != want[route]:
            raise AssertionError(f"lego_occ {route} route launched {run[3]}, want {want[route]}")
        ok, n_settled, n_all, worst = compare_params(run, plain, base.train.lrate, S)
        g0 = float((run[4][0] - plain[4][0]).abs().max())
        gerr = (run[4][-1] - plain[4][-1]).abs()
        ok &= g0 <= GRID_ATOL and float(gerr.max()) <= GRID_ATOL
        ok &= bool(torch.isfinite(run[4][-1]).all())
        log(f"[occ routes] {S} lego_occ steps, {route} vs plain route: launches {run[3]}; losses "
            f"{run[2]} vs {plain[2]}; {n_settled}/{n_all} parameters whose gradients agree "
            f"within 25%, worst |diff|/(1e-4 + 5e-3|p|) among them {worst:.3f}, the other "
            f"{n_all - n_settled} within {2 * S} lr; first grid max |diff| {g0:.3e} (<= "
            f"{GRID_ATOL}), last grid max |diff| {float(gerr.max()):.3e}, max "
            f"{float(plain[4][-1].max()):.4f}: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the lego_occ {route} route disagrees with the plain route")
        out[route] = {"losses": run[2], "launches": run[3], "unsettled": n_all - n_settled,
                      "worst_ratio": worst, "grid0_max_abs": g0,
                      "grid_last_max_abs": float(gerr.max())}
    out["losses_plain"] = plain[2]
    return out


def phase_train_timing(ds, device):
    """The train kernel per level at 4096 rays (CUDA events) beside its
    plain version's forward + backward, its bounds (3xTF32, fp32, one TF32
    pass) and its three launches apart (profiler); then warm train steps
    (host clock, one synchronize at the end), peak memory, and the device's
    busy share of a few steps under torch.profiler."""
    import torch
    from nerf_meets_mlx_torch.config import lego_hierarchical
    from nerf_meets_mlx_torch.engine import TrainState, make_nerf_train_step
    from nerf_meets_mlx_torch.kernels import fused_train as ft

    cfg = lego_hierarchical().replace(use_fused_kernel=True)
    model = make_model(cfg, device)
    ro, rd, vd = picked_rays(device)
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    target = torch.rand((ro.shape[0], 3), generator=gen, device=device)
    levels = train_level_inputs(model, ro, rd, vd, target, gen, cfg.render.raw_noise_std)
    n_dw = ft.pack_train_weights(model.coarse, model.pos_enc, model.dir_enc)[1][
        2 * cfg.mlp.net_depth + 8
    ]
    per_level = {}
    for name, (z, dl, nz), mlp, reps in (
        ("coarse", levels[0], model.coarse, 6), ("fine", levels[1], model.fine, 3)
    ):
        R, S = z.shape
        params = mlp_params(mlp)
        args = (mlp, model.pos_enc, model.dir_enc, train_tspec(model, S), ro, rd, vd, z, dl, nz,
                target)

        def kernel():
            with torch.no_grad():
                ft.fused_train_apply(*args)

        def plain():
            sse, _, _ = ft.fused_train_reference(*args)
            torch.autograd.grad(sse, params)

        k_ms = cuda_time_ms(kernel, reps)
        p_ms = cuda_time_ms(plain, reps)
        k_ms2 = cuda_time_ms(kernel, reps)
        split = kernel_split_ms(kernel, TRAIN_KERNELS, reps)
        flops = 2.0 * train_macs(mlp.cfg, model.pos_enc.out_dim, model.dir_enc.out_dim) * R * S
        # each input read once (rays, z, deltas, noise, target, weights),
        # each output written once (rgb, weights, sse, dW)
        nbytes = 4 * (9 * R + 3 * R * S + 3 * R + n_dw + 3 * R + R * S + 1 + n_dw)
        # the kernel's GEMMs run in 3xTF32: three TF32 tensor-core products
        # for each fp32 one
        bound_ms = max(3 * flops / TF32_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
        by = "operations" if 3 * flops / TF32_FLOPS > nbytes / HBM_BYTES_PER_S else "bytes"
        fp32_ms = max(flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
        ms = (k_ms + k_ms2) / 2
        per_level[name] = dict(
            rays=R, samples=S, ms=ms, ms_runs=[k_ms, k_ms2], plain_ms=p_ms, bound_ms=bound_ms,
            bound_by=by, fp32_bound_ms=fp32_ms, tf32_bound_ms=flops / TF32_FLOPS * 1e3,
            tflop=flops / 1e12, achieved_tflops_s=flops / (ms * 1e-3) / 1e12, split_ms=split,
        )
        log(f"[time] fused_train {name:6s} R={R} S={S}: kernel {k_ms:.3f} / {k_ms2:.3f} ms, "
            f"plain fwd+bwd {p_ms:.3f} ms, 3xTF32 bound {bound_ms:.3f} ms ({by}), fp32 bound "
            f"{fp32_ms:.3f} ms, TF32 bound {flops / TF32_FLOPS * 1e3:.3f} ms, "
            f"{flops / 1e12:.4f} TFLOP -> {per_level[name]['achieved_tflops_s']:.2f} TFLOP/s")
        log(f"[time] fused_train {name:6s} launches by kernel (torch.profiler, per call): "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()))
    ft.LAUNCHES["train"] = 0

    images = torch.as_tensor(ds.images[ds.i_train], device=device)
    poses = torch.as_tensor(ds.poses[ds.i_train, :3, :4], device=device)
    state = TrainState(model, cfg.train)
    step = make_nerf_train_step(model, ds.H, ds.W, ds.focal)
    for _ in range(3):
        step(state, images, poses, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        step(state, images, poses, gen)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_rand = cfg.train.n_rand
    rcfg = cfg.render
    log(f"[time] train step lego_hierarchical (fused route, {n_rand} rays, "
        f"{rcfg.n_samples} + {rcfg.n_importance} samples): "
        f"{step_s:.5f} s/step over {TIMED_STEPS} warm steps -> {n_rand / step_s:.1f} rays/s; "
        f"peak device memory {peak_gb:.2f} GB")

    def steps():
        for _ in range(PROFILED_STEPS):
            step(state, images, poses, gen)

    trace = profile_device(steps, f"{PROFILED_STEPS} train steps")
    ft.LAUNCHES["train"] = 0
    return per_level, {"step_s": step_s, "rays_per_s": n_rand / step_s, "peak_gb": peak_gb,
                       "trace": trace}


def phase_mlp_timing(device):
    """Each fused MLP kernel per call (CUDA events) at lego_occ's shapes
    beside its plain version and its bound: the forward on the grid
    update's 262,144 points and on the coarse and fine points of a step,
    each timed call's raw held against plain (ATOL + RTOL and MLP_TIGHT,
    raising if it disagrees), with its kernel's device time, the device
    events and the host ms of a call (``call_split``); the backward (which
    recomputes the forward) at the coarse and fine level, against the plain
    version's forward + autograd backward, with its kernels' device time,
    the device events (its launches) and host ms of a call (``call_split``).
    Both run their products on the tensor cores in 3xTF32, so their bound
    counts three TF32 operations for each fp32 one over 495 TFLOP/s (the
    fp32 bound logged beside); the backward's workspace (every layer's input
    and dZ written feature-major and read back by its dW kernel,
    ``mlp_bwd_ws_floats``) is logged as a second floor beside it."""
    import torch
    from nerf_meets_mlx_torch.config import lego_occ
    from nerf_meets_mlx_torch.kernels import fused_mlp as fm

    model = make_model(lego_occ(), device)
    pe, de = model.pos_enc, model.dir_enc
    wbytes = 4 * fm.pack_mlp_weights(model.fine, pe, de)[0].numel()
    n_dw = fm.grad_offsets(model.fine)[1]
    ws_floats = mlp_bwd_ws_floats(model.fine.cfg, pe.out_dim, de.out_dim)
    fwd, bwd = {}, {}
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    for name, pts, dirs in mlp_inputs(model, device):
        N = pts.shape[0]
        mlp = model.fine if name != "coarse" else model.coarse
        params = mlp_params(mlp)
        reps = max(3, int(2_000_000 // N))

        def kernel():
            with torch.no_grad():
                return fm.fused_mlp_apply(mlp, pe, de, pts, dirs)

        def plain():
            with torch.no_grad():
                return fm.fused_mlp_reference(mlp, pe, de, pts, dirs)

        k1, p_ms, k2 = cuda_time_ms(kernel, reps), cuda_time_ms(plain, reps), cuda_time_ms(kernel, reps)
        raw_k = kernel()
        torch.cuda.synchronize()
        err, tight, ok = mlp_fwd_errors(raw_k, plain())
        if not ok:
            raise AssertionError(f"the timed fused_mlp forward disagrees with plain: {name}")
        split = call_split(kernel, "mlp_fwd_tc_kernel", reps)
        flops = 2.0 * mlp_macs(mlp.cfg, pe.out_dim, de.out_dim) * N
        nbytes = 4 * (6 * N + 4 * N) + wbytes  # points, directions in; raw out; weights
        t_ops, t_fp32, t_bytes = 3 * flops / TF32_FLOPS, flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
        ms = (k1 + k2) / 2
        fwd[name] = dict(points=N, ms=ms, ms_runs=[k1, k2], plain_ms=p_ms,
                         bound_ms=max(t_ops, t_bytes) * 1e3,
                         bound_by="operations" if t_ops > t_bytes else "bytes",
                         fp32_bound_ms=max(t_fp32, t_bytes) * 1e3,
                         tf32_bound_ms=flops / TF32_FLOPS * 1e3,
                         tf32x3_bound_ms=max(t_ops, t_bytes) * 1e3,
                         achieved_tflops_s=flops / (ms * 1e-3) / 1e12,
                         max_abs_err=err, tight_share=tight, **split)
        log(f"[time] fused_mlp forward {name:6s} N={N}: kernel {k1:.4f} / {k2:.4f} ms (device "
            f"{split['device_ms']:.4f} ms, {split['device_events']:.0f} device events and "
            f"{split['other_device_ms']:.4f} ms beside it, host {split['host_ms']:.4f} ms a call), "
            f"plain {p_ms:.3f} ms, 3xTF32 bound {fwd[name]['bound_ms']:.3f} ms "
            f"({fwd[name]['bound_by']}), fp32 bound {fwd[name]['fp32_bound_ms']:.3f} ms -> "
            f"{fwd[name]['achieved_tflops_s']:.2f} TFLOP/s; timed raw within {err:.3e} of plain "
            f"({tight:.3f} of MLP_TIGHT)")
        if name == "grid":
            continue
        dout = torch.randn((N, 4), generator=gen, device=device)

        def kernel_bwd():
            fm._bwd_launch(mlp, pe, de, pts, dirs, dout, False)

        def plain_bwd():
            out = fm.fused_mlp_reference(mlp, pe, de, pts, dirs)
            torch.autograd.grad(out, params, dout)

        reps = max(2, int(600_000 // N))
        k1, p_ms, k2 = (cuda_time_ms(kernel_bwd, reps), cuda_time_ms(plain_bwd, reps),
                        cuda_time_ms(kernel_bwd, reps))
        split = call_split(kernel_bwd, "mlp_bwd", reps)
        flops = 2.0 * train_macs(mlp.cfg, pe.out_dim, de.out_dim) * N
        # points, directions, dout in; weights in; dW out
        nbytes = 4 * (6 * N + 4 * N + n_dw) + wbytes
        t_ops, t_fp32, t_bytes = 3 * flops / TF32_FLOPS, flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
        t_ws = 2 * 4 * ws_floats * N / HBM_BYTES_PER_S  # written once, read back once
        ms = (k1 + k2) / 2
        bwd[name] = dict(points=N, ms=ms, ms_runs=[k1, k2], plain_ms=p_ms,
                         bound_ms=max(t_ops, t_bytes) * 1e3,
                         bound_by="operations" if t_ops > t_bytes else "bytes",
                         fp32_bound_ms=max(t_fp32, t_bytes) * 1e3,
                         tf32_bound_ms=flops / TF32_FLOPS * 1e3,
                         tf32x3_bound_ms=max(t_ops, t_bytes) * 1e3,
                         workspace_bound_ms=t_ws * 1e3, workspace_bytes=2 * 4 * ws_floats * N,
                         achieved_tflops_s=flops / (ms * 1e-3) / 1e12, **split)
        log(f"[time] fused_mlp backward {name:6s} N={N}: kernels {k1:.3f} / {k2:.3f} ms (device "
            f"{split['device_ms']:.4f} ms, {split['device_events']:.0f} device events and "
            f"{split['other_device_ms']:.4f} ms beside them, host {split['host_ms']:.4f} ms a "
            f"call), plain fwd+bwd {p_ms:.3f} ms, 3xTF32 bound {bwd[name]['bound_ms']:.3f} ms "
            f"({bwd[name]['bound_by']}), workspace bound {t_ws * 1e3:.3f} ms "
            f"({2 * 4 * ws_floats * N / 1e9:.2f} GB at 3.35 TB/s), fp32 bound "
            f"{bwd[name]['fp32_bound_ms']:.3f} ms -> {bwd[name]['achieved_tflops_s']:.2f} TFLOP/s")
    reset_launches()
    return fwd, bwd


OCC_TIMED_STEPS = 32  # two grid updates (steps 16 and 32) fall inside


def phase_occ_timing(ds, device):
    """lego_occ: the host seconds of a warm train step on the fused-train
    route and on use_fused_train=False (OCC_TIMED_STEPS steps ending in one
    synchronize, the grid updated every 16 steps as the preset says), peak
    memory, the device's busy share of 5 steps of each route under
    torch.profiler, and the 400 x 400 frame time with the grid."""
    import torch
    from nerf_meets_mlx_torch.acceleration.occupancy import init_occupancy_grid
    from nerf_meets_mlx_torch.cameras.pose import orbit_poses
    from nerf_meets_mlx_torch.config import lego_occ
    from nerf_meets_mlx_torch.datasets.synthetic import CAMERA_ANGLE_X
    from nerf_meets_mlx_torch.engine import TrainState, make_nerf_train_step
    from nerf_meets_mlx_torch.rendering import render_image

    images = torch.as_tensor(ds.images[ds.i_train], device=device)
    poses = torch.as_tensor(ds.poses[ds.i_train, :3, :4], device=device)
    base = lego_occ().replace(use_fused_kernel=True)
    out = {}
    for route, cfg in (("fused_train", base), ("value_and_grad", base.replace(use_fused_train=False))):
        model = make_model(cfg, device)
        state = TrainState(model, cfg.train,
                           occ_grid=init_occupancy_grid(cfg.render.occ_resolution, device=device))
        step = make_nerf_train_step(model, ds.H, ds.W, ds.focal)
        gen = torch.Generator(device=device).manual_seed(SEED + 7)
        for _ in range(3):  # steps 0-2, the first grid update included
            step(state, images, poses, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        for _ in range(OCC_TIMED_STEPS):
            step(state, images, poses, gen)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / OCC_TIMED_STEPS
        launches = launches_now()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        n_rand = cfg.train.n_rand
        log(f"[time] train step lego_occ ({route} route, {n_rand} rays, "
            f"{cfg.render.n_samples} + {cfg.render.n_importance} samples, grid every "
            f"{cfg.render.occ_update_every} steps): {step_s:.5f} s/step over {OCC_TIMED_STEPS} "
            f"warm steps -> {n_rand / step_s:.1f} rays/s; launches {launches}; peak device "
            f"memory {peak_gb:.2f} GB")
        out[route] = {"step_s": step_s, "rays_per_s": n_rand / step_s, "peak_gb": peak_gb,
                      "launches": launches}
        def steps():
            for _ in range(PROFILED_STEPS):
                step(state, images, poses, gen)

        out[route]["trace"] = profile_device(steps,
                                             f"{PROFILED_STEPS} lego_occ train steps ({route})")
        if route == "fused_train":
            focal = 0.5 * RES / np.tan(0.5 * CAMERA_ANGLE_X)
            K = np.array([[focal, 0, RES / 2], [0, focal, RES / 2], [0, 0, 1]], np.float32)
            grid = state.occ_grid
            times = []
            for pose in orbit_poses(160)[:2]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                render_image(model, RES, RES, K, pose[:3, :4], occ_grid=grid)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            out["frame_trace"] = profile_device(
                lambda: render_image(model, RES, RES, K, orbit_poses(160)[0][:3, :4], occ_grid=grid),
                f"one {RES}x{RES} lego_occ frame",
            )
            occupied = float((grid > cfg.render.occ_threshold).float().mean())
            log(f"[time] render_image {RES}x{RES} lego_occ with the grid ({occupied:.4f} of "
                f"cells above the threshold): frames {times} s -> {min(times):.4f} s/frame, "
                f"{RES * RES / min(times):.1f} rays/s")
            out["frame"] = {"frame_seconds": times, "rays_per_s": RES * RES / min(times),
                            "grid_occupied": occupied}
        del model, state
        torch.cuda.empty_cache()
    reset_launches()
    return out


# ---------------------------------------------------------------------------
# the INGP path: lego_ingp and lego_ingp_occ
# ---------------------------------------------------------------------------

# the hash dG kernel's table gradient is summed with atomics in a
# run-dependent order, and each coarse-level row sums hundreds of the plain
# scatter-add's terms in another order: max |dG - plain| <= DG_REL *
# max |plain dG|. The INGP train kernel's dG is held to DW_REL, as its dW:
# it comes through the MLP's backward, where a pre-activation within
# rounding of 0 takes the other side of the relu in the kernel than in
# cuBLAS's sum (a few units in 393,216 points x 128) and moves that point's
# whole contribution to the rows it touches.
DG_REL = 1e-4
GRAD_FLOOR = 1e-6  # feat kernel: of the largest plain gradient entry of all arrays
INGP_TABLE_NOISE = 0.1  # N(0, 0.1) added to the tables of the kernel comparisons
# the INGP eval kernel's rgb and weights are also held to atol = rtol =
# EVAL_TIGHT of plain: its 3xTF32 products meet it at lego_ingp's shapes,
# one TF32 pass does not (tests/test_torch_ingp_eval.py builds that control
# and sees it fail), so a kernel that lost its lo products fails here
EVAL_TIGHT = 1e-6


def ingp_eval_errors(got, want):
    """The INGP eval kernel's (rgb, weights) against plain's: ({output: max
    abs error}, whether both are finite and within atol 1e-4 + rtol 1e-4
    and within EVAL_TIGHT)."""
    import torch

    errs, ok = {}, True
    for what, k, p in zip(("rgb", "weights"), got, want):
        d = (k - p).abs()
        errs[what] = float(d.max())
        ok &= bool(torch.isfinite(k).all()) and bool((d <= ATOL + RTOL * p.abs()).all())
        ok &= bool((d <= EVAL_TIGHT * (1.0 + p.abs())).all())
    return errs, ok


def ingp_model(preset, device, noisy: bool = False):
    """A seeded lego_ingp / lego_ingp_occ model on the fused route; with
    ``noisy`` its tables get N(0, INGP_TABLE_NOISE), so that every corner's
    row shows in the comparisons (the init is U(-1e-4, 1e-4))."""
    import torch
    from nerf_meets_mlx_torch.config import PRESETS

    model = make_model(PRESETS[preset]().replace(use_fused_kernel=True), device)
    if noisy:
        gen = torch.Generator(device=device).manual_seed(SEED + 10)
        with torch.no_grad():
            model.pos_enc.tables.add_(
                torch.randn(model.pos_enc.tables.shape, generator=gen, device=device)
                * INGP_TABLE_NOISE)
    return model


def ingp_tspec(model, n_samples: int, mode=None, white=None):
    from nerf_meets_mlx_torch.kernels.fused_ingp_train import ingp_group, ingp_rays_block
    from nerf_meets_mlx_torch.kernels.fused_train import TrainSpec

    rcfg = model.cfg.render
    rb = ingp_rays_block(n_samples)
    return TrainSpec(
        n_samples=n_samples, rays_block=rb, mode=mode or rcfg.compositing,
        density_activation=rcfg.density_activation,
        white_bkgd=rcfg.white_bkgd if white is None else white, group=ingp_group(n_samples, rb),
    )


def ingp_level_inputs(model, ro, rd, vd, target, gen, noise_std: float, train: bool = True):
    """The rays' spherical harmonics and the (z, deltas, noise) of the coarse
    and the fine level, as the fused INGP route makes them: coarse depths
    (jittered in training), importance samples from the coarse level's
    weights (plain version; deterministic in eval), pre-scaled noise."""
    import torch
    from nerf_meets_mlx_torch.kernels import fused_ingp_train as fi
    from nerf_meets_mlx_torch.sampling.importance import merge_z, sample_pdf

    rcfg = model.cfg.render
    dnorm = torch.linalg.vector_norm(rd, dim=-1, keepdim=True)
    sh = model.dir_enc.apply(vd)

    def level(z):
        dl = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1) * dnorm
        return z, dl, torch.randn(z.shape, generator=gen, device=z.device) * noise_std

    coarse = level(model._coarse_z(ro, rd, train=train, generator=gen))
    with torch.no_grad():
        _, w_c = fi.fused_ingp_eval_reference(
            model.coarse, model.pos_enc, sh, ingp_tspec(model, rcfg.n_samples), ro, rd,
            *coarse[:2])
    u = torch.rand((ro.shape[0], rcfg.n_importance), generator=gen, device=ro.device)
    z_imp = sample_pdf(coarse[0], w_c, rcfg.n_importance, deterministic=not train,
                       u=u if train else None)
    return sh, coarse, level(merge_z(coarse[0], z_imp))


def ingp_point_sets(model, device):
    """(name, points [N, 3]) the hash kernels see on the INGP paths: one
    jittered point per cell of lego_ingp_occ's 64³ grid (the grid update,
    hash forward) and lego_ingp's coarse (4096 x 48) and fine (4096 x 96)
    points of a train step (the value_and_grad route, forward and dG)."""
    import torch
    from nerf_meets_mlx_torch.acceleration.occupancy import _cell_points
    from nerf_meets_mlx_torch.config import lego_ingp_occ

    rcfg = lego_ingp_occ().render
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    lo = torch.tensor(rcfg.aabb[:3], device=device)
    hi = torch.tensor(rcfg.aabb[3:], device=device)
    out = [("grid", _cell_points(rcfg.occ_resolution, lo, hi, generator=gen))]
    ro, rd, vd = picked_rays(device)
    target = torch.rand((ro.shape[0], 3), generator=gen, device=device)
    _, coarse, fine = ingp_level_inputs(model, ro, rd, vd, target, gen, 0.0)
    for name, (z, _, _) in (("coarse", coarse), ("fine", fine)):
        out.append((name, (ro[:, None, :] + z[..., None] * rd[:, None, :]).reshape(-1, 3)))
    return out


def long_ray_point_sets(device):
    """(name, points [N, 3]) the hash kernels see on the long-ray route (the
    feats route of lego_ingp at LONG_RAYS samples): a train step's coarse
    (4096 x 128) and fine (4096 x 384) points in ray order, made as
    ingp_point_sets makes lego_ingp's."""
    import torch
    from nerf_meets_mlx_torch.config import lego_ingp

    base = lego_ingp()
    model = make_model(base.replace(use_fused_kernel=True, render=dataclasses.replace(
        base.render, n_samples=LONG_RAYS[0], n_importance=LONG_RAYS[1])), device)
    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    ro, rd, vd = picked_rays(device)
    _, coarse, fine = ingp_level_inputs(model, ro, rd, vd, None, gen, 0.0)
    return [(name, (ro[:, None, :] + z[..., None] * rd[:, None, :]).reshape(-1, 3))
            for name, (z, _, _) in (("long_coarse", coarse), ("long_fine", fine))]


def long_ray_frame_point_sets(device):
    """(name, points [N, 3]) the hash forward sees on the long-ray route's
    frame (the eval route: the standard query at LONG_RAYS samples): the
    first 32,768-ray chunk of a RES x RES orbit frame, its coarse (32,768 x
    128) and fine (32,768 x 384) points in ray order, the fine depths
    importance-sampled from the coarse level's weights (deterministic, as
    in eval)."""
    import torch
    from nerf_meets_mlx_torch.config import lego_ingp

    base = lego_ingp()
    model = make_model(base.replace(use_fused_kernel=True, render=dataclasses.replace(
        base.render, n_samples=LONG_RAYS[0], n_importance=LONG_RAYS[1])), device)
    gen = torch.Generator(device=device).manual_seed(SEED + 15)
    ro, rd, vd = frame_rays(RES, RES, device)
    c = model.cfg.render.ray_chunk
    ro, rd, vd = ro[:c].contiguous(), rd[:c].contiguous(), vd[:c].contiguous()
    _, coarse, fine = ingp_level_inputs(model, ro, rd, vd, None, gen, 0.0, train=False)
    return [(name, (ro[:, None, :] + z[..., None] * rd[:, None, :]).reshape(-1, 3))
            for name, (z, _, _) in (("frame_coarse", coarse), ("frame_fine", fine))]


# the hash forward's batches that no dG follows: the grid update's and the
# long-ray frame's
FORWARD_ONLY = ("grid", "frame_coarse", "frame_fine")


def grad_ratios(g_k, g_p):
    """max |kernel - plain| / max |plain| per array."""
    out = []
    for a, b in zip(g_k, g_p):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        out.append(err / scale if scale > 0 else (0.0 if err == 0 else float("inf")))
    return out


def phase_compare_ingp(device):
    """The four INGP kernels against their plain versions at the main
    paths' shapes (full-width lego_ingp weights from a seeded init, tables
    with N(0, 0.1) added, 4096 rays of orbit frame 0): the hash forward on
    the grid update's 262,144 points, the train step's 196,608 / 393,216,
    the long-ray route's 524,288 / 1,572,864 and its frame's 4,194,304 /
    12,582,912 (features equal: the same IEEE operations in the same
    order), its dG at the four train batches with
    random dout; the eval and the train kernel at S = 48 and 96, both
    MLPs, both compositing modes, the white background on and off (train),
    density noise on; values to atol 1e-4 + rtol 1e-4, the hash dG kernel to
    DG_REL and the train kernel's dW and dG to DW_REL of the array's largest
    plain value (whether its dG is within DG_REL is logged), the eval
    kernel's also to EVAL_TIGHT; both levels on
    csrc/ingp_eval_tc.cu (eval_build) and csrc/ingp_train_tc.cu
    (train_build), whose sse and dW two launches give bit for bit."""
    import torch
    from nerf_meets_mlx_torch.kernels import fused_ingp_train as fi
    from nerf_meets_mlx_torch.kernels import hash_encode as he

    model = ingp_model("lego_ingp", device, noisy=True)
    enc = model.pos_enc
    out = {"hash_fwd": 0.0, "hash_dg": 0.0, "hash_dg_ratio": 0.0, "eval": 0.0, "train_val": 0.0,
           "train_dw_ratio": 0.0, "train_dg_ratio": 0.0}
    rcfg = model.cfg.render
    for S in (rcfg.n_samples, rcfg.n_samples + rcfg.n_importance):
        build = fi.train_build(model.cfg.mlp.net_width, model.cfg.mlp.net_depth, enc.n_levels,
                               enc.features_per_level, model.dir_enc.out_dim, S)
        if build[0] != fi.TC_SOURCE:
            raise AssertionError(f"lego_ingp's S={S} trains in {build}, not {fi.TC_SOURCE}")
    build = fi.eval_build(model.cfg.mlp.net_width, model.cfg.mlp.net_depth, enc.n_levels,
                          enc.features_per_level, model.dir_enc.out_dim)
    if build[0] != fi.EVAL_SOURCE:
        raise AssertionError(f"lego_ingp evaluates in {build}, not {fi.EVAL_SOURCE}")
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    for name, pts in (ingp_point_sets(model, device) + long_ray_point_sets(device)
                      + long_ray_frame_point_sets(device)):
        with torch.no_grad():
            f_k = he.hash_encode_apply(enc, pts)
            torch.cuda.synchronize()
            f_p = enc.apply(pts)
        err = float((f_k - f_p).abs().max())
        ok = bool(torch.isfinite(f_k).all()) and bool(torch.equal(f_k, f_p))
        line = f"[compare] hash_fwd {name:6s} N={pts.shape[0]} max_abs={err:.3e} (equal: {ok})"
        out["hash_fwd"] = max(out["hash_fwd"], err)
        if name not in FORWARD_ONLY:
            dout = torch.randn(f_p.shape, generator=gen, device=device)
            (g_k,) = torch.autograd.grad((he.hash_encode_apply(enc, pts) * dout).sum(), enc.tables)
            torch.cuda.synchronize()
            (g_p,) = torch.autograd.grad((enc.apply(pts) * dout).sum(), enc.tables)
            r = grad_ratios([g_k], [g_p])[0]
            ok &= bool(torch.isfinite(g_k).all()) and r <= DG_REL
            out["hash_dg_ratio"] = max(out["hash_dg_ratio"], r)
            out["hash_dg"] = max(out["hash_dg"], float((g_k - g_p).abs().max()))
            line += f"; hash_bwd max|dG-plain|/max|plain| {r:.2e}"
        log(line + (" ok" if ok else " FAIL"))
        if not ok:
            raise AssertionError(f"the hash kernels disagree with their plain version: {name}")

    ro, rd, vd = picked_rays(device)
    target = torch.rand((ro.shape[0], 3), generator=gen, device=device)
    sh, coarse, fine = ingp_level_inputs(model, ro, rd, vd, target, gen, NOISE_STD)
    for (z, dl, nz), mlp, level in ((coarse, model.coarse, "coarse"), (fine, model.fine, "fine")):
        S = z.shape[1]
        params = mlp_params(mlp) + [enc.tables]
        for mode in ("canonical", "reference"):
            tspec = ingp_tspec(model, S, mode=mode)
            with torch.no_grad():
                rgb_k, w_k = fi.fused_ingp_eval_apply(mlp, enc, sh, tspec, ro, rd, z, dl)
                torch.cuda.synchronize()
                rgb_p, w_p = fi.fused_ingp_eval_reference(mlp, enc, sh, tspec, ro, rd, z, dl)
            live = float((w_p > 1e-4).float().mean())
            errs, ok = ingp_eval_errors((rgb_k, w_k), (rgb_p, w_p))
            log(f"[compare] ingp_eval S={S} {level:6s} {mode:9s} max_abs rgb={errs['rgb']:.3e} "
                f"weights={errs['weights']:.3e} (weights > 1e-4: {live:.3f}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"ingp_eval disagrees with its plain version: S={S} {mode}")
            out["eval"] = max(out["eval"], *errs.values())
            for white in (True, False):
                tspec = ingp_tspec(model, S, mode=mode, white=white)
                args = (mlp, enc, sh, tspec, ro, rd, z, dl, nz, target)
                sse_k, rgb_k, w_k = fi.fused_ingp_train_apply(*args)
                g_k = torch.autograd.grad(sse_k, params)
                torch.cuda.synchronize()
                sse_p, rgb_p, w_p = fi.fused_ingp_train_reference(*args)
                g_p = torch.autograd.grad(sse_p, params)
                errs, ok = {}, True
                for what, k, p in (("sse", sse_k, sse_p), ("rgb", rgb_k, rgb_p),
                                   ("weights", w_k, w_p)):
                    k, p = k.detach(), p.detach()
                    errs[what] = float((k - p).abs().max())
                    ok &= bool(torch.isfinite(k).all()) and bool(
                        ((k - p).abs() <= ATOL + RTOL * p.abs()).all())
                ratios = grad_ratios(g_k, g_p)
                ok &= all(bool(torch.isfinite(a).all()) for a in g_k)
                ok &= max(ratios) <= DW_REL
                # how many entries carry the disagreement (a few: relu flips)
                n_off = [int(((a - b).abs() > 1e-5 * b.abs().max()).sum())
                         for a, b in ((g_k[0], g_p[0]), (g_k[-1], g_p[-1]))]
                log(f"[compare] ingp_train S={S} {level:6s} {mode:9s} white={int(white)} max_abs "
                    f"sse={errs['sse']:.3e} rgb={errs['rgb']:.3e} weights={errs['weights']:.3e}; "
                    f"max|dW-plain|/max|plain| per array: "
                    + " ".join(f"{r:.1e}" for r in ratios[:-1])
                    + f"; dG {ratios[-1]:.1e} (within {DG_REL:.0e}: {ratios[-1] <= DG_REL}); "
                    f"entries beyond 1e-5 of max (W0, dG): {n_off} "
                    + ("ok" if ok else "FAIL"))
                if not ok:
                    raise AssertionError(
                        f"ingp_train disagrees with its plain version: S={S} {mode} white={white}")
                out["train_val"] = max(out["train_val"], errs["rgb"], errs["weights"])
                out["train_dw_ratio"] = max(out["train_dw_ratio"], max(ratios[:-1]))
                out["train_dg_ratio"] = max(out["train_dg_ratio"], ratios[-1])
        # two launches give bit-identical sse and dW (fixed-order sums)
        args = (mlp, enc, sh, ingp_tspec(model, S), ro, rd, z, dl, nz, target)
        runs = []
        for _ in range(2):
            sse_k = fi.fused_ingp_train_apply(*args)[0]
            runs.append([sse_k.detach()] + list(torch.autograd.grad(sse_k, params[:-1])))
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        log(f"[compare] ingp_train S={S} {level:6s} two launches: sse and dW bit-identical: "
            f"{same}")
        if not same:
            raise AssertionError(f"ingp_train is not deterministic in sse and dW: S={S}")
    reset_launches()
    return out


def phase_ingp_routes(ds, device):
    """ROUTE_STEPS lego_ingp steps from one seed on three routes: the
    fused-train route (the INGP train kernel), use_fused_train=False (the
    value_and_grad route: the hash forward and dG kernels at both levels,
    the MLP by autograd) and the plain route. The parameters and tables
    must agree as ``compare_params`` holds them at lr 1e-2, and table
    entries that no point touched (zero gradient at every step on both
    routes) must equal each other and the initial values decayed by the
    encoding weight decay alone. The value_and_grad run is the hash dG
    kernel's path: its launches are reported in the kernels line."""
    import torch
    from nerf_meets_mlx_torch.config import lego_ingp

    base = lego_ingp()
    S = ROUTE_STEPS
    runs = {
        "fused_train": run_route(base.replace(use_fused_kernel=True), ds, device, S, SEED + 9),
        "value_and_grad": run_route(
            base.replace(use_fused_kernel=True, use_fused_train=False), ds, device, S, SEED + 9),
        "plain": run_route(base, ds, device, S, SEED + 9),
    }
    want = {
        "fused_train": counts(ingp_train=2 * S),
        "value_and_grad": counts(hash_fwd=2 * S, hash_bwd=2 * S),
        "plain": counts(),
    }
    init = make_model(base, device).pos_enc.tables.detach()
    decayed = init.clone()
    wd = base.train.encoding_weight_decay
    for _ in range(S):
        decayed.sub_(wd * decayed)
    ti = next(i for i, p in enumerate(runs["plain"][0]) if p.shape == init.shape)
    plain = runs["plain"]
    out = {}
    for route in ("fused_train", "value_and_grad"):
        run = runs[route]
        if run[3] != want[route]:
            raise AssertionError(f"lego_ingp {route} route launched {run[3]}, want {want[route]}")
        ok, n_settled, n_all, worst = compare_params(run, plain, base.train.lrate, S)
        untouched = torch.ones_like(init, dtype=torch.bool)
        for g in run[1] + plain[1]:
            untouched &= g[ti] == 0
        a, b = run[0][ti][untouched], plain[0][ti][untouched]
        exact = bool(torch.equal(a, b)) and bool(torch.equal(a, decayed[untouched]))
        ok &= exact
        log(f"[ingp routes] {S} lego_ingp steps, {route} vs plain route: launches {run[3]}; "
            f"losses {run[2]} vs {plain[2]}; {n_settled}/{n_all} parameters whose gradients "
            f"agree within 1.25%, worst |diff|/(1e-4 + 5e-3|p|) among them {worst:.3f}, the "
            f"other {n_all - n_settled} within {2 * S} lr; {int(untouched.sum())} untouched "
            f"table entries equal to the decayed init: {exact}: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the lego_ingp {route} route disagrees with the plain route")
        out[route] = {"losses": run[2], "launches": run[3], "unsettled": n_all - n_settled,
                      "worst_ratio": worst, "untouched": int(untouched.sum())}
    out["losses_plain"] = plain[2]
    return out


def phase_ingp_kernel_timing(device):
    """Each INGP kernel per launch (CUDA events) at the main paths' shapes,
    beside its plain version's time and its bound: the hash forward (a
    call's event time and its kernel's device time, profiler) on the grid
    update's 262,144 points, the train step's coarse and fine points, the
    long-ray route's (4096 x 128 / 384) and its frame's chunk (32,768 x 128
    / 384), its dG (kernel alone;
    plain: forward + autograd backward) at the last four, the batches of
    its two routes (lego_ingp's value_and_grad, the long-ray feats route);
    the eval call per level on a 32,768-ray chunk
    of a 400 x 400 frame (the serving path), also its kernel's device time
    (profiler), and its output on that chunk against plain's (as
    phase_compare_ingp holds it, raising if it disagrees); the train kernel per level at 4096 rays (plain: forward +
    autograd backward). The bound is the larger of the bytes it must move
    over 3.35 TB/s and its fp32 operations over 67 TFLOP/s; the eval and
    train kernels', which run their products on the tensor cores in
    3xTF32, count three TF32 operations for each fp32 one over 495 TFLOP/s
    (their fp32 bound logged beside), the view layer's SH rows once a ray.
    Hashed lookups and atomics have no peak rate in the table and are not
    counted as operations."""
    import torch
    from nerf_meets_mlx_torch.kernels import fused_ingp_train as fi
    from nerf_meets_mlx_torch.kernels import hash_encode as he

    model = ingp_model("lego_ingp", device, noisy=True)
    enc = model.pos_enc
    L, F = enc.n_levels, enc.features_per_level
    table_bytes = 4 * enc.tables.numel()
    mlp_cfg = model.cfg.mlp
    E, DD = enc.out_dim, model.dir_enc.out_dim
    # MLP and hash-interpolation operations per point
    fwd_macs = mlp_macs(mlp_cfg, E, DD)
    hash_flops = L * 8 * (2 * F + 2)  # per point: weight and weighted sum of 8 corners
    W = mlp_cfg.net_width
    # the train call: forward, dW (as many MACs), every layer's input
    # cotangent (the hidden layers, the feature, the view head, and the
    # hash features' through layer 0); the view layer's SH rows once a ray
    # in the forward and in dW (the kernel forms the SH term once a ray and
    # its dW from the ray's summed cotangent), not once a point
    train_dx = (mlp_cfg.net_depth - 1) * W * W + W * W + W + W * (W // 2) + (W // 2) * 3 + E * W
    sh_macs = DD * (W // 2)
    wbytes = 4 * fi.pack_weights(model.fine)[0].numel()
    gen = torch.Generator(device=device).manual_seed(SEED + 13)

    def entry(ms_runs, plain_ms, nbytes, flops, tensor_cores=False, **extra):
        t_fp32, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
        t_ops = 3 * flops / TF32_FLOPS if tensor_cores else t_fp32
        ms = sum(ms_runs) / len(ms_runs)
        # the bound of the units the kernel runs on, the fp32 one, and the
        # 3xTF32 one (three TF32 tensor-core operations for each fp32 one)
        # that a tensor-core port would meet
        return dict(ms=ms, ms_runs=ms_runs, plain_ms=plain_ms,
                    bound_ms=max(t_ops, t_bytes) * 1e3,
                    bound_by="operations" if t_ops > t_bytes else "bytes",
                    fp32_bound_ms=max(t_fp32, t_bytes) * 1e3,
                    tf32x3_bound_ms=max(3 * flops / TF32_FLOPS, t_bytes) * 1e3, **extra)

    hfwd, hbwd, ev, tr = {}, {}, {}, {}
    for name, pts in (ingp_point_sets(model, device) + long_ray_point_sets(device)
                      + long_ray_frame_point_sets(device)):
        N = pts.shape[0]
        reps = max(5, int(4_000_000 // N))

        def fwd():
            with torch.no_grad():
                he.hash_encode_apply(enc, pts)

        k1 = cuda_time_ms(fwd, reps)
        with torch.no_grad():
            p_ms = cuda_time_ms(lambda: enc.apply(pts), max(2, reps // 4))
        k2 = cuda_time_ms(fwd, reps)
        device_ms = kernel_split_ms(fwd, ("hash_fwd_kernel",), reps)["hash_fwd_kernel"]
        hfwd[name] = entry([k1, k2], p_ms, 4 * (3 * N + L * F * N) + table_bytes,
                           hash_flops * N, points=N, device_ms=device_ms)
        log(f"[time] hash_fwd {name:6s} N={N}: a call {k1:.4f} / {k2:.4f} ms, its kernel's "
            f"device time {device_ms:.4f} ms, plain {p_ms:.3f} ms, bound "
            f"{hfwd[name]['bound_ms']:.4f} ms ({hfwd[name]['bound_by']}), "
            f"{N * L * 8 / (device_ms * 1e-3) / 1e9:.1f} G lookups/s")
        if name in FORWARD_ONLY:
            continue
        dout = torch.randn((N, L * F), generator=gen, device=device)

        def plain_bwd():
            torch.autograd.grad((enc.apply(pts) * dout).sum(), enc.tables)

        k1 = cuda_time_ms(lambda: he._bwd_launch(enc, pts, dout), reps)
        p_ms = cuda_time_ms(plain_bwd, max(2, reps // 4))
        k2 = cuda_time_ms(lambda: he._bwd_launch(enc, pts, dout), reps)
        hbwd[name] = entry([k1, k2], p_ms, 4 * (3 * N + L * F * N) + table_bytes,
                           hash_flops * N, points=N)
        log(f"[time] hash_bwd {name:6s} N={N}: kernel {k1:.4f} / {k2:.4f} ms, plain fwd+bwd "
            f"{p_ms:.3f} ms, bound {hbwd[name]['bound_ms']:.4f} ms ({hbwd[name]['bound_by']}), "
            f"{N * L * 8 * F / (hbwd[name]['ms'] * 1e-3) / 1e9:.1f} G terms/s")

    # eval: a 32,768-ray chunk of a 400 x 400 frame
    ro, rd, vd = frame_rays(RES, RES, device)
    c = model.cfg.render.ray_chunk
    ro, rd, vd = ro[:c].contiguous(), rd[:c].contiguous(), vd[:c].contiguous()
    sh, coarse, fine = ingp_level_inputs(model, ro, rd, vd, None, gen, 0.0, train=False)
    for name, (z, dl, _), mlp, reps in (("coarse", coarse, model.coarse, 10),
                                         ("fine", fine, model.fine, 6)):
        R, S = z.shape
        tspec = ingp_tspec(model, S)
        args = (mlp, enc, sh, tspec, ro, rd, z, dl)
        build = fi.eval_build(W, mlp_cfg.net_depth, L, F, DD)[0]

        def kernel():
            with torch.no_grad():
                fi.fused_ingp_eval_apply(*args)

        with torch.no_grad():
            k1 = cuda_time_ms(kernel, reps)
            p_ms = cuda_time_ms(lambda: fi.fused_ingp_eval_reference(*args), max(2, reps // 2))
            k2 = cuda_time_ms(kernel, reps)
            # the launch that is timed, on the serving chunk, against plain
            got = fi.fused_ingp_eval_apply(*args)
            torch.cuda.synchronize()
            errs, ok = ingp_eval_errors(got, fi.fused_ingp_eval_reference(*args))
        log(f"[compare] ingp_eval {name:6s} R={R} S={S} (the timed chunk) max_abs "
            f"rgb={errs['rgb']:.3e} weights={errs['weights']:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"ingp_eval disagrees with its plain version on the timed "
                                 f"chunk: {name} R={R} S={S}")
        device_ms = kernel_split_ms(kernel, ("ingp_eval_tc_kernel", "ingp_eval_kernel"), reps)
        nbytes = 4 * (6 * R + DD * R + 2 * R * S + 3 * R + R * S) + table_bytes + wbytes
        flops = (2 * (fwd_macs - sh_macs) + hash_flops) * R * S + 2 * sh_macs * R
        ev[name] = entry([k1, k2], p_ms, nbytes, flops, tensor_cores=build == fi.EVAL_SOURCE,
                         rays=R, samples=S, build=build, device_ms=sum(device_ms.values()))
        log(f"[time] ingp_eval {name:6s} R={R} S={S} ({build}): a call {k1:.4f} / {k2:.4f} ms, "
            f"its kernel's device time {ev[name]['device_ms']:.4f} ms, plain {p_ms:.3f} ms, "
            f"bound {ev[name]['bound_ms']:.4f} ms ({ev[name]['bound_by']}; 3xTF32 "
            f"{ev[name]['tf32x3_bound_ms']:.4f}, fp32 {ev[name]['fp32_bound_ms']:.4f} ms)")

    # train: 4096 rays
    ro, rd, vd = picked_rays(device)
    target = torch.rand((ro.shape[0], 3), generator=gen, device=device)
    sh, coarse, fine = ingp_level_inputs(model, ro, rd, vd, target, gen,
                                         model.cfg.render.raw_noise_std)
    for name, (z, dl, nz), mlp, reps in (("coarse", coarse, model.coarse, 10),
                                          ("fine", fine, model.fine, 6)):
        R, S = z.shape
        params = mlp_params(mlp) + [enc.tables]
        args = (mlp, enc, sh, ingp_tspec(model, S), ro, rd, z, dl, nz, target)

        def kernel():
            with torch.no_grad():
                fi.fused_ingp_train_apply(*args)

        def plain():
            sse, _, _ = fi.fused_ingp_train_reference(*args)
            torch.autograd.grad(sse, params)

        k1, p_ms, k2 = cuda_time_ms(kernel, reps), cuda_time_ms(plain, reps), cuda_time_ms(kernel, reps)
        split = kernel_split_ms(kernel, ("ingp_tc_kernel", "ingp_tc_reduce_kernel"), reps)
        n_dw = wbytes // 4
        # in: rays, sh, z, deltas, noise, target, weights, tables; out: rgb,
        # weights, sse, dW, dG
        nbytes = (4 * (6 * R + DD * R + 3 * R * S + 3 * R + 3 * R + R * S + 1 + n_dw) + wbytes
                  + 2 * table_bytes)
        flops = (2 * (2 * (fwd_macs - sh_macs) + train_dx) + 2 * hash_flops) * R * S \
            + 2 * 2 * sh_macs * R
        build = fi.train_build(W, mlp_cfg.net_depth, L, F, DD, S)[0]
        tr[name] = entry([k1, k2], p_ms, nbytes, flops, tensor_cores=build == fi.TC_SOURCE,
                         rays=R, samples=S, split_ms=split, build=build)
        log(f"[time] ingp_train {name:6s} R={R} S={S} ({build}): kernel {k1:.3f} / {k2:.3f} ms ("
            + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
            + f" ms), plain fwd+bwd {p_ms:.3f} ms, bound {tr[name]['bound_ms']:.3f} ms "
            f"({tr[name]['bound_by']}; 3xTF32 {tr[name]['tf32x3_bound_ms']:.3f}, fp32 "
            f"{tr[name]['fp32_bound_ms']:.3f} ms)")
    reset_launches()
    return hfwd, hbwd, ev, tr


def phase_ingp_e2e(ds, device):
    """lego_ingp and lego_ingp_occ end to end on the fused route (and
    lego_ingp on use_fused_train=False, the hash-kernel route): the host
    seconds of a warm train step (OCC_TIMED_STEPS steps ending in one
    synchronize; lego_ingp_occ's grid updated every 16 steps, two updates
    inside), rays/s, peak memory, the device's busy share of 5 steps under
    torch.profiler, and the 400 x 400 frame time (with the grid for
    lego_ingp_occ) and its busy share."""
    import torch
    from nerf_meets_mlx_torch.acceleration.occupancy import init_occupancy_grid
    from nerf_meets_mlx_torch.cameras.pose import orbit_poses
    from nerf_meets_mlx_torch.config import PRESETS
    from nerf_meets_mlx_torch.datasets.synthetic import CAMERA_ANGLE_X
    from nerf_meets_mlx_torch.engine import TrainState, make_nerf_train_step
    from nerf_meets_mlx_torch.rendering import render_image

    images = torch.as_tensor(ds.images[ds.i_train], device=device)
    poses = torch.as_tensor(ds.poses[ds.i_train, :3, :4], device=device)
    focal = 0.5 * RES / np.tan(0.5 * CAMERA_ANGLE_X)
    K = np.array([[focal, 0, RES / 2], [0, focal, RES / 2], [0, 0, 1]], np.float32)
    out = {}
    for key, preset, fused_train in (("lego_ingp", "lego_ingp", True),
                                     ("lego_ingp_value_and_grad", "lego_ingp", False),
                                     ("lego_ingp_occ", "lego_ingp_occ", True)):
        cfg = PRESETS[preset]().replace(use_fused_kernel=True, use_fused_train=fused_train)
        model = make_model(cfg, device)
        grid = (init_occupancy_grid(cfg.render.occ_resolution, device=device)
                if cfg.render.occupancy else None)
        state = TrainState(model, cfg.train, occ_grid=grid)
        step = make_nerf_train_step(model, ds.H, ds.W, ds.focal)
        gen = torch.Generator(device=device).manual_seed(SEED + 14)
        for _ in range(3):  # steps 0-2, the first grid update included
            step(state, images, poses, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        for _ in range(OCC_TIMED_STEPS):
            step(state, images, poses, gen)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / OCC_TIMED_STEPS
        launches = launches_now()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        n_rand = cfg.train.n_rand
        log(f"[time] train step {key} ({n_rand} rays, {cfg.render.n_samples} + "
            f"{cfg.render.n_importance} samples): {step_s:.5f} s/step over {OCC_TIMED_STEPS} warm "
            f"steps -> {n_rand / step_s:.1f} rays/s; launches {launches}; peak device memory "
            f"{peak_gb:.2f} GB")
        res = {"step_s": step_s, "rays_per_s": n_rand / step_s, "peak_gb": peak_gb,
               "launches": launches}

        def steps():
            for _ in range(PROFILED_STEPS):
                step(state, images, poses, gen)

        res["trace"] = profile_device(steps, f"{PROFILED_STEPS} {key} train steps")
        if fused_train:
            grid = state.occ_grid
            times = []
            for pose in orbit_poses(160)[:2]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                render_image(model, RES, RES, K, pose[:3, :4], occ_grid=grid)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            torch.cuda.reset_peak_memory_stats()
            render_image(model, RES, RES, K, orbit_poses(160)[0][:3, :4], occ_grid=grid)
            frame_peak = torch.cuda.max_memory_allocated() / 1e9
            res["frame_trace"] = profile_device(
                lambda: render_image(model, RES, RES, K, orbit_poses(160)[0][:3, :4],
                                     occ_grid=grid),
                f"one {RES}x{RES} {key} frame",
            )
            log(f"[time] render_image {RES}x{RES} {key}: frames {times} s -> "
                f"{min(times):.4f} s/frame, {RES * RES / min(times):.1f} rays/s; peak device "
                f"memory {frame_peak:.2f} GB")
            res["frame"] = {"frame_seconds": times, "rays_per_s": RES * RES / min(times),
                            "peak_gb": frame_peak}
        out[key] = res
        del model, state
        torch.cuda.empty_cache()
    reset_launches()
    return out

# ---------------------------------------------------------------------------
# the "feats" route and the 2-D image task
# ---------------------------------------------------------------------------

# the Instant-NGP paper's grid (Müller et al. 2022, Table 1) on lego_ingp:
# 16 levels of 2^19 entries of 2 features, resolutions 16..512; its 64 MiB
# of tables put lego_ingp on the "feats" route
PAPER_OVERLAY = "hash_n_levels = 16\nhash_log2_table_size = 19\nhash_max_res = 512\n"
LONG_RAYS = (128, 256)  # N_samples, N_importance of the long-ray route check
IMAGE_STEPS = 300       # steps of the image path
IMAGE_FRAME_EVERY = 100
IMAGE_TIMED_STEPS = 50


def paper_cfg():
    from nerf_meets_mlx_torch.config import lego_ingp

    cfg = lego_ingp()
    return cfg.replace(pos_encoding=dataclasses.replace(
        cfg.pos_encoding, hash_n_levels=16, hash_log2_table_size=19, hash_max_res=512))


def feat_model(kind, device):
    """A seeded lego_ingp model (P = 16) or one with the paper's tables (P =
    32) on the fused route, its tables with N(0, INGP_TABLE_NOISE) added so
    that the features are at full scale."""
    import torch
    from nerf_meets_mlx_torch.config import lego_ingp

    cfg = (paper_cfg() if kind == "paper" else lego_ingp()).replace(use_fused_kernel=True)
    model = make_model(cfg, device)
    gen = torch.Generator(device=device).manual_seed(SEED + 20)
    with torch.no_grad():
        model.pos_enc.tables.add_(
            torch.randn(model.pos_enc.tables.shape, generator=gen, device=device)
            * INGP_TABLE_NOISE)
    return model


def feat_tspec(model, n_samples, mode=None, white=None):
    from nerf_meets_mlx_torch.kernels.fused_feat_train import feat_group, feat_rays_block
    from nerf_meets_mlx_torch.kernels.fused_train import TrainSpec

    rcfg = model.cfg.render
    rb = feat_rays_block(n_samples)
    return TrainSpec(
        n_samples=n_samples, rays_block=rb, mode=mode or rcfg.compositing,
        density_activation=rcfg.density_activation,
        white_bkgd=rcfg.white_bkgd if white is None else white,
        group=feat_group(n_samples, rb),
    )


def feat_sets(device):
    """(name, model, mlp, features [R, S, P], sh, deltas, noise, target) at
    the feats route's shapes: 4096 rays at the coarse (S = 48) and fine (S =
    96) level of lego_ingp (P = 16) and of the paper's tables (P = 32), as
    the route makes them (jittered depths, importance samples, pre-scaled
    noise, features of the points from the plain encode); and longer rays
    from stratified depths over [near, far]: S = 384 at 1024 rays (P = 16,
    the long-ray route's sample count) and S = 2048 at 64 rays (P = 32)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    ro, rd, vd = picked_rays(device)
    target = torch.rand((ro.shape[0], 3), generator=gen, device=device)
    out = []
    for kind in ("ingp", "paper"):
        model = feat_model(kind, device)
        sh, coarse, fine = ingp_level_inputs(model, ro, rd, vd, target, gen, NOISE_STD)
        for level, (z, dl, nz), mlp in (("coarse", coarse, model.coarse),
                                         ("fine", fine, model.fine)):
            pts = ro[:, None, :] + z[..., None] * rd[:, None, :]
            with torch.no_grad():
                feats = model.pos_enc.apply(pts)
            out.append((f"{kind} {level}", model, mlp, feats, sh, dl, nz, target))
    for kind, R, S in (("ingp", 1024, 384), ("paper", 64, 2048)):
        model = feat_model(kind, device)
        rcfg = model.cfg.render
        R = min(R, ro.shape[0])
        ro_, rd_, vd_ = ro[:R], rd[:R], vd[:R]
        z = rcfg.near + (rcfg.far - rcfg.near) * torch.sort(
            torch.rand((R, S), generator=gen, device=device), dim=-1).values
        dnorm = torch.linalg.vector_norm(rd_, dim=-1, keepdim=True)
        dl = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1) * dnorm
        nz = torch.randn((R, S), generator=gen, device=device) * NOISE_STD
        with torch.no_grad():
            feats = model.pos_enc.apply(ro_[:, None, :] + z[..., None] * rd_[:, None, :])
        out.append((f"{kind} S={S}", model, model.fine, feats, model.dir_enc.apply(vd_), dl, nz,
                    target[:R]))
    return out


def feat_case(name, model, mlp, mlp64, feats, sh, dl, nz, target, mode, white):
    """The feat train kernel against its plain version on one input set,
    one compositing mode and background: sse, rgb and weights to atol 1e-4
    + rtol 1e-4; every dW, db and d(feats) (i) to DW_REL of the array's
    largest plain value plus GRAD_FLOOR of the largest plain gradient entry
    of all the arrays (the criterion of the gpu tests of the INGP and feat
    kernels), or (ii) no more than twice as far as the fp32 plain version
    from the plain version evaluated in float64 (``mlp64``). Raises if not;
    returns (max abs error of the values, the gradient ratios against the
    fp32 plain version, how many arrays criterion (ii) held)."""
    import torch
    from nerf_meets_mlx_torch.kernels import fused_feat_train as ff

    R, S, P = feats.shape
    params, params64 = mlp_params(mlp), mlp_params(mlp64)
    tspec = feat_tspec(model, S, mode=mode, white=white)
    build = ff.train_build(mlp.cfg.net_width, mlp.cfg.net_depth, P, sh.shape[-1], S)[0]
    f = feats.clone().requires_grad_(True)
    x = ff.pack_feat_inputs(f, sh, dl, nz)
    sse_k, rgb_k, w_k = ff.fused_feat_train_apply(mlp, tspec, x, target)
    g_k = torch.autograd.grad(sse_k, params + [f])
    torch.cuda.synchronize()
    sse_p, rgb_p, w_p = ff.fused_feat_train_reference(mlp, tspec, x, target)
    g_p = torch.autograd.grad(sse_p, params + [f])
    live = float((w_p > 1e-4).float().mean())
    errs, ok = {}, True
    for what, k, p in (("sse", sse_k, sse_p), ("rgb", rgb_k, rgb_p), ("weights", w_k, w_p)):
        k, p = k.detach(), p.detach()
        errs[what] = float((k - p).abs().max())
        ok &= bool(torch.isfinite(k).all()) and bool(
            ((k - p).abs() <= ATOL + RTOL * p.abs()).all())
    ratios = grad_ratios(g_k, g_p)
    ok &= all(bool(torch.isfinite(a).all()) for a in g_k)
    # each array (i) within DW_REL of its largest plain value plus
    # GRAD_FLOOR of the largest plain entry of all the arrays (the gpu
    # tests' criterion: a relu input within rounding of 0 flips a point's
    # cotangent), or (ii) at most twice as far as the fp32 plain version
    # from the plain version evaluated in float64: in canonical mode the
    # terminal bin (delta 1e10) makes the alpha head's sums cancel, and
    # there the fp32 plain version itself misses the float64 one by up to
    # 1e-1 of the array's largest value
    f64 = feats.double().requires_grad_(True)
    x64 = ff.pack_feat_inputs(f64, sh.double(), dl.double(), nz.double())
    sse64, _, _ = ff.fused_feat_train_reference(mlp64, tspec, x64, target.double())
    g64 = torch.autograd.grad(sse64, params64 + [f64])
    r_k64 = grad_ratios([a.double() for a in g_k], g64)
    r_p64 = grad_ratios([b.double() for b in g_p], g64)
    floor = GRAD_FLOOR * max(float(b.abs().max()) for b in g_p)
    by = []
    for a, b, rk, rp in zip(g_k, g_p, r_k64, r_p64):
        if float((a - b).abs().max()) <= DW_REL * float(b.abs().max()) + floor:
            by.append("i")
        elif rk <= 2.0 * rp:
            by.append("ii")
        else:
            by.append("no")
    ok &= "no" not in by
    log(f"[compare] feat_train {name:12s} R={R} S={S} P={P} ({build}) {mode:9s} white="
        f"{int(white)} max_abs sse={errs['sse']:.3e} rgb={errs['rgb']:.3e} "
        f"weights={errs['weights']:.3e} (weights > 1e-4: {live:.3f}); "
        f"max|dW-plain|/max|plain| per array: "
        + " ".join(f"{r:.1e}" for r in ratios[:-1])
        + f"; dfeats {ratios[-1]:.1e}; against the plain version in float64, "
        f"kernel / fp32 plain: alpha W {r_k64[4]:.1e} / {r_p64[4]:.1e}, alpha b "
        f"{r_k64[5]:.1e} / {r_p64[5]:.1e}, worst {max(r_k64):.1e} / "
        f"{max(r_p64):.1e}; criterion per array {' '.join(by)} "
        + ("ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError(f"feat_train disagrees with its plain version: {name} {mode} {white}")
    return max(errs["rgb"], errs["weights"]), ratios, by.count("ii")


def feat_repeats(name, model, mlp, feats, sh, dl, nz, target):
    """Two launches of the feat train kernel on the same inputs: sse, every
    dW and db and d(feats) bit-identical (per-block partials summed in
    block order, dfeats by plain stores: no atomics). Raises if not."""
    import torch
    from nerf_meets_mlx_torch.kernels import fused_feat_train as ff

    tspec = feat_tspec(model, feats.shape[1])
    runs = []
    for _ in range(2):
        f = feats.clone().requires_grad_(True)
        sse, _, _ = ff.fused_feat_train_apply(mlp, tspec, ff.pack_feat_inputs(f, sh, dl, nz),
                                              target)
        runs.append([sse.detach()] + list(torch.autograd.grad(sse, mlp_params(mlp) + [f])))
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    log(f"[compare] feat_train {name}: two launches bit-identical (sse, dW, dfeats): {same}")
    if not same:
        raise AssertionError(f"feat_train is not deterministic at {name}")


def phase_compare_feat(device):
    """The feat train kernel against its plain version at ``feat_sets``'
    shapes, both compositing modes, the white background on and off,
    density noise on (``feat_case``, which logs the build that ran each
    shape); the paper tables' levels run on the tensor-core kernel and
    repeat bit for bit (``feat_repeats``). Returns (max abs error of the
    values, worst gradient ratio against the fp32 plain version)."""
    import copy

    from nerf_meets_mlx_torch.kernels import fused_feat_train as ff

    worst_val, worst_ratio, n_by_ii = 0.0, 0.0, 0
    for name, model, mlp, feats, sh, dl, nz, target in feat_sets(device):
        mlp64 = copy.deepcopy(mlp).double()
        for mode in ("canonical", "reference"):
            for white in (True, False):
                val, ratios, n_ii = feat_case(name, model, mlp, mlp64, feats, sh, dl, nz,
                                              target, mode, white)
                worst_val = max(worst_val, val)
                worst_ratio = max(worst_ratio, max(ratios))
                n_by_ii += n_ii
        if name.startswith("paper") and "S=" not in name:
            build = ff.train_build(mlp.cfg.net_width, mlp.cfg.net_depth, feats.shape[-1],
                                   sh.shape[-1], feats.shape[1])[0]
            if build != ff.TC_SOURCE:
                raise AssertionError(f"{name} routes to {build}, not {ff.TC_SOURCE}")
            feat_repeats(name, model, mlp, feats, sh, dl, nz, target)
    log(f"[compare] feat_train: {n_by_ii} arrays held by criterion (ii)")
    reset_launches()
    return worst_val, worst_ratio


def image_model(device, fused=True, width=None):
    from nerf_meets_mlx_torch.config import image2d

    cfg = image2d().replace(use_fused_kernel=fused)
    if width is not None:
        cfg = cfg.replace(mlp=dataclasses.replace(cfg.mlp, net_width=width))
    return make_model(cfg, device)


def phase_compare_image(device, width=None):
    """The image kernels against their plain version at image2d's full 8 x
    256 (or ``width``: the image model the Python API makes at another
    width) from a seeded init: the train kernel at 4096 pixels and at 4001
    (a ragged last tile), sse to atol 1e-4 + rtol 1e-4 and every dW and db
    to DW_REL of the array's largest plain value; the forward kernel on the
    160,000 pixels of a 400 x 400 frame to atol 1e-4 + rtol 1e-4 and within
    IMAGE_TIGHT (atol = rtol). Returns
    (max abs error of sse, worst dW ratio, max abs error of the forward)."""
    import torch
    from nerf_meets_mlx_torch.datasets.image import make_test_image, pixel_dataset
    from nerf_meets_mlx_torch.kernels import fused_image as fim

    model = image_model(device, width=width)
    mlp, enc = model.coarse, model.pos_enc
    coords, colors = (torch.as_tensor(a, device=device)
                      for a in pixel_dataset(make_test_image(RES)))
    gen = torch.Generator(device=device).manual_seed(SEED + 22)
    params = mlp_params(mlp)
    worst_sse, worst_ratio = 0.0, 0.0
    for n in (4096, 4001):
        idx = torch.randint(0, coords.shape[0], (n,), generator=gen, device=device)
        x, y = coords[idx], colors[idx]
        sse_k = fim.fused_image_train(mlp, enc, x, y)
        g_k = torch.autograd.grad(sse_k, params)
        torch.cuda.synchronize()
        sse_p = torch.sum((fim.fused_image_reference(mlp, enc, x) - y) ** 2)
        g_p = torch.autograd.grad(sse_p, params)
        err = float((sse_k - sse_p).detach().abs())
        ratios = grad_ratios(g_k, g_p)
        ok = bool(torch.isfinite(sse_k.detach())) and err <= ATOL + RTOL * float(sse_p.detach().abs())
        ok &= all(bool(torch.isfinite(a).all()) for a in g_k) and max(ratios) <= DW_REL
        log(f"[compare] image_train width {mlp.cfg.net_width} N={n}: sse {float(sse_k.detach()):.6f} vs "
            f"{float(sse_p.detach()):.6f} "
            f"(abs err {err:.3e}); max|dW-plain|/max|plain| per array: "
            + " ".join(f"{r:.1e}" for r in ratios) + (" ok" if ok else " FAIL"))
        if not ok:
            raise AssertionError(f"image_train disagrees with its plain version: N={n}")
        worst_sse, worst_ratio = max(worst_sse, err), max(worst_ratio, max(ratios))
    with torch.no_grad():
        out_k = fim.fused_image_apply(mlp, enc, coords)
        torch.cuda.synchronize()
        out_p = fim.fused_image_reference(mlp, enc, coords)
    err = (out_k - out_p).abs()
    tight = float((err / (IMAGE_TIGHT * (1.0 + out_p.abs()))).max())
    ok = bool(torch.isfinite(out_k).all()) and bool((err <= ATOL + RTOL * out_p.abs()).all())
    ok &= tight <= 1.0
    log(f"[compare] image_fwd width {mlp.cfg.net_width} N={coords.shape[0]}: max_abs {float(err.max()):.3e} "
        f"({tight:.3f} of IMAGE_TIGHT) " + ("ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("image_fwd disagrees with its plain version")
    reset_launches()
    return worst_sse, worst_ratio, float(err.max())


def phase_long_ray_routes(ds, device):
    """ROUTE_STEPS steps of lego_ingp at N_samples = 128, N_importance = 256
    (384 samples a ray: the "feats" route, its tables within the hash
    kernels' budget) from one seed on the fused-train route (per level the
    hash forward kernel, the feat train kernel, then the hash dG kernel)
    and on the plain route. Held as ``phase_ingp_routes`` holds lego_ingp's:
    ``compare_params`` at lr 1e-2, and the table entries no point touched
    equal on both routes and to the init decayed by the weight decay
    alone."""
    import torch
    from nerf_meets_mlx_torch.config import lego_ingp

    base = lego_ingp()
    base = base.replace(render=dataclasses.replace(
        base.render, n_samples=LONG_RAYS[0], n_importance=LONG_RAYS[1]))
    S = ROUTE_STEPS
    fused = run_route(base.replace(use_fused_kernel=True), ds, device, S, SEED + 23)
    plain = run_route(base, ds, device, S, SEED + 23)
    want = counts(hash_fwd=2 * S, feat_train=2 * S, hash_bwd=2 * S)
    if fused[3] != want or plain[3] != counts():
        raise AssertionError(f"long-ray routes launched {fused[3]} / {plain[3]}, want {want}")
    init = make_model(base, device).pos_enc.tables.detach()
    decayed = init.clone()
    wd = base.train.encoding_weight_decay
    for _ in range(S):
        decayed.sub_(wd * decayed)
    ti = next(i for i, p in enumerate(plain[0]) if p.shape == init.shape)
    ok, n_settled, n_all, worst = compare_params(fused, plain, base.train.lrate, S)
    untouched = torch.ones_like(init, dtype=torch.bool)
    for g in fused[1] + plain[1]:
        untouched &= g[ti] == 0
    a, b = fused[0][ti][untouched], plain[0][ti][untouched]
    exact = bool(torch.equal(a, b)) and bool(torch.equal(a, decayed[untouched]))
    ok &= exact
    log(f"[long routes] {S} lego_ingp steps at {LONG_RAYS[0]} + {LONG_RAYS[1]} samples, "
        f"fused-train (feats) vs plain route: launches {fused[3]}; losses {fused[2]} vs "
        f"{plain[2]}; {n_settled}/{n_all} parameters whose gradients agree within 1.25%, worst "
        f"|diff|/(1e-4 + 5e-3|p|) among them {worst:.3f}, the other {n_all - n_settled} within "
        f"{2 * S} lr; {int(untouched.sum())} untouched table entries equal to the decayed "
        f"init: {exact}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the long-ray feats route disagrees with the plain route")
    return {"losses_fused": fused[2], "losses_plain": plain[2], "launches": fused[3],
            "unsettled": n_all - n_settled, "worst_ratio": worst,
            "untouched": int(untouched.sum())}


def phase_image_path(device):
    """The image entry point, ``image_learning(size=400, max_iters=300,
    frame_every=100)``, with every launch count set to 0 before it and read
    after: one train-kernel launch a step, one forward-kernel launch a
    frame and one for the final prediction, a rising PSNR."""
    import torch
    from nerf_meets_mlx_torch.entrypoints import image_learning
    from nerf_meets_mlx_torch.kernels import fused_image as fim

    log_dir = OUT / "image"
    shutil.rmtree(log_dir, ignore_errors=True)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = image_learning(size=RES, max_iters=IMAGE_STEPS, log_dir=str(log_dir),
                         frame_every=IMAGE_FRAME_EVERY, device=device)
    wall = time.perf_counter() - t0
    launches = launches_now()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_frames = IMAGE_STEPS // IMAGE_FRAME_EVERY
    want = counts(image_train=IMAGE_STEPS, image_fwd=n_frames + 1)
    # the train calls' build: every plan of the wrapper is the tensor-core source's
    builds = {Path(p.lib._name).name for p in fim._PLANS.values()}
    on_tc = bool(builds) and all(b.startswith("lib" + fim.TRAIN_SOURCE) for b in builds)
    recs = [json.loads(x) for x in (log_dir / "metrics.jsonl").read_text().splitlines()]
    psnrs = [(r["step"], r["psnr"]) for r in recs if "psnr" in r]
    frames = np.load(log_dir / "progress_frames.npy")
    log(f"[image] image_learning {RES}x{RES}, {IMAGE_STEPS} steps: {wall:.1f} s; launches "
        f"{launches} (want {want}), the train calls on {sorted(builds)}; batch PSNR at the "
        f"logged steps {psnrs}; final PSNR "
        f"{res['final_psnr']:.3f}; frames {frames.shape}; peak device memory {peak_gb:.2f} GB")
    if launches != want or not on_tc:
        raise AssertionError(f"image launches {launches} on {builds}, want {want} on "
                             f"{fim.TRAIN_SOURCE}")
    if (len(psnrs) < 2 or not psnrs[-1][1] > psnrs[0][1] or not np.isfinite(res["final_psnr"])
            or frames.shape != (n_frames, RES, RES, 3)):
        raise AssertionError("the image task's PSNR did not rise, or its frames are wrong")
    reset_launches()
    return launches, {"wall_s": wall, "psnr_logged": psnrs, "final_psnr": res["final_psnr"],
                      "peak_gb": peak_gb}


def feat_train_macs(P, DD, S, W=64, D=2):
    """Multiply-adds per ray of one feat train call at S samples a ray: per
    point the forward, dW (as many) and the cotangents of every layer's
    input, the features' included; per ray the view layer's SH rows, once
    in the forward and once in dW (a ray's rows carry one SH, so the tile
    kernel forms the SH term once a ray and its dW from the ray's summed
    cotangent), not their cotangent."""
    fwd = P * W + (D - 1) * W * W + W + W * W + W * (W // 2) + (W // 2) * 3
    dx = (D - 1) * W * W + W * W + W + W * (W // 2) + (W // 2) * 3 + P * W
    return S * (2 * fwd + dx) + 2 * DD * (W // 2)


def image_macs(mlp_cfg, enc_dim):
    """(forward, train) multiply-adds per pixel of the image MLP: the train
    call is the forward, dW and the hidden layers' cotangents."""
    D, W = mlp_cfg.net_depth, mlp_cfg.net_width
    fwd = 0
    for j in range(D):
        fwd += (enc_dim if j == 0 else W + (enc_dim if (j - 1) in mlp_cfg.skips else 0)) * W
    fwd += W * mlp_cfg.out_channels
    dx = (D - 1) * W * W + W * mlp_cfg.out_channels
    return fwd, 2 * fwd + dx


def phase_feat_image_timing(device):
    """Each new kernel per launch (CUDA events) beside its plain version
    and its bound: the feat train kernel at the paper-size tables' coarse
    (4096 x 48) and fine (4096 x 96) level (plain: forward + autograd
    backward); the image train call at 4096 pixels (plain: forward +
    autograd backward), with its kernels' device time (torch.profiler),
    and the forward call on a 400 x 400 frame, with its two kernels'
    device time and its host ms (``call_split``; raising if the call runs
    any other device event). The bound is the larger of the bytes each
    launch must move over 3.35 TB/s and its operations over the rate of the
    units that run them: three TF32 operations for each fp32 one over 495
    TFLOP/s where the build runs its products on the tensor cores in
    3xTF32 (the feat call's ``csrc/ingp_train_tc.cu``, the image calls'
    ``csrc/image_train_tc.cu`` and ``csrc/image_fwd_tc.cu``), fp32 over 67
    TFLOP/s elsewhere; both are logged."""
    import torch
    from nerf_meets_mlx_torch.datasets.image import make_test_image, pixel_dataset
    from nerf_meets_mlx_torch.kernels import fused_feat_train as ff
    from nerf_meets_mlx_torch.kernels import fused_image as fim
    from nerf_meets_mlx_torch.kernels import fused_ingp_train as fi

    def entry(ms_runs, plain_ms, nbytes, flops, tensor_cores=False, **extra):
        t_fp32, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
        t_ops = 3 * flops / TF32_FLOPS if tensor_cores else t_fp32
        ms = sum(ms_runs) / len(ms_runs)
        return dict(ms=ms, ms_runs=ms_runs, plain_ms=plain_ms,
                    bound_ms=max(t_ops, t_bytes) * 1e3,
                    bound_by="operations" if t_ops > t_bytes else "bytes",
                    fp32_bound_ms=max(t_fp32, t_bytes) * 1e3,
                    tf32x3_bound_ms=max(3 * flops / TF32_FLOPS, t_bytes) * 1e3,
                    achieved_tflops_s=flops / (ms * 1e-3) / 1e12, **extra)

    feat = {}
    sets = {n: rest for n, *rest in feat_sets(device)}
    for name, reps in (("paper coarse", 10), ("paper fine", 6)):
        model, mlp, feats, sh, dl, nz, target = sets[name]
        R, S, P = feats.shape
        params = mlp_params(mlp)
        tspec = feat_tspec(model, S)
        x = ff.pack_feat_inputs(feats, sh, dl, nz)

        def kernel():
            with torch.no_grad():
                ff.fused_feat_train_apply(mlp, tspec, x, target)

        f = feats.clone().requires_grad_(True)
        xg = ff.pack_feat_inputs(f, sh, dl, nz)

        def plain():
            sse, _, _ = ff.fused_feat_train_reference(mlp, tspec, xg, target)
            torch.autograd.grad(sse, params + [f], retain_graph=True)

        k1, p_ms, k2 = cuda_time_ms(kernel, reps), cuda_time_ms(plain, reps), cuda_time_ms(kernel, reps)
        DD = sh.shape[-1]
        n_w = fi.pack_weights(mlp)[0].numel()
        # in: x, target, weights; out: rgb, weights, sse, dW, dfeats
        nbytes = 4 * (R * S * (P + DD + 2) + 3 * R + n_w + 3 * R + R * S + 1 + n_w + R * S * P)
        key = name.split()[1]
        build = ff.train_build(mlp.cfg.net_width, mlp.cfg.net_depth, P, DD, S)[0]
        feat[key] = entry([k1, k2], p_ms, nbytes, 2.0 * feat_train_macs(P, DD, S) * R,
                          tensor_cores=build == ff.TC_SOURCE, rays=R, samples=S, p_dim=P,
                          build=build)
        log(f"[time] feat_train {name} R={R} S={S} P={P} ({build}): kernel {k1:.3f} / {k2:.3f} "
            f"ms, plain fwd+bwd {p_ms:.3f} ms, bound {feat[key]['bound_ms']:.3f} ms "
            f"({feat[key]['bound_by']}; 3xTF32 {feat[key]['tf32x3_bound_ms']:.3f}, fp32 "
            f"{feat[key]['fp32_bound_ms']:.3f} ms), {feat[key]['achieved_tflops_s']:.2f} TFLOP/s")

    model = image_model(device)
    mlp, enc = model.coarse, model.pos_enc
    coords, colors = (torch.as_tensor(a, device=device)
                      for a in pixel_dataset(make_test_image(RES)))
    gen = torch.Generator(device=device).manual_seed(SEED + 24)
    idx = torch.randint(0, coords.shape[0], (4096,), generator=gen, device=device)
    x, y = coords[idx], colors[idx]
    params = mlp_params(mlp)
    fwd_macs, train_macs_ = image_macs(mlp.cfg, enc.out_dim)
    n_w = sum(p.numel() for p in params)  # every weight and bias, read once

    def kernel():
        with torch.no_grad():
            fim.fused_image_train(mlp, enc, x, y)

    def plain():
        sse = torch.sum((fim.fused_image_reference(mlp, enc, x) - y) ** 2)
        torch.autograd.grad(sse, params)

    k1, p_ms, k2 = cuda_time_ms(kernel, 20), cuda_time_ms(plain, 20), cuda_time_ms(kernel, 20)
    split = kernel_split_ms(kernel, IMAGE_TRAIN_KERNELS, 20)
    N = x.shape[0]
    image_train = {"batch": entry([k1, k2], p_ms, 4 * (2 * N + 3 * N + 2 * n_w + 1),
                                  2.0 * train_macs_ * N, tensor_cores=True, pixels=N,
                                  split_ms=split, device_ms=sum(split.values()))}
    b = image_train["batch"]
    log(f"[time] image_train N={N}: a call {k1:.3f} / {k2:.3f} ms, device {b['device_ms']:.4f} ms ("
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
        + f"), plain fwd+bwd {p_ms:.3f} ms, bound {b['bound_ms']:.3f} ms ({b['bound_by']}; 3xTF32 "
        f"{b['tf32x3_bound_ms']:.3f}, fp32 {b['fp32_bound_ms']:.3f} ms), "
        f"{b['achieved_tflops_s']:.2f} TFLOP/s")
    N = coords.shape[0]

    def kernel_fwd():
        with torch.no_grad():
            fim.fused_image_apply(mlp, enc, coords)

    def plain_fwd():
        with torch.no_grad():
            fim.fused_image_reference(mlp, enc, coords)

    k1, p_ms, k2 = cuda_time_ms(kernel_fwd, 5), cuda_time_ms(plain_fwd, 5), cuda_time_ms(kernel_fwd, 5)
    # the call's device time (its pack and tile-walk kernels), the device
    # events and the host ms of a call: a call launches those two and nothing else
    split = call_split(kernel_fwd, "image_fwd", 10)
    image_fwd = {"frame": entry([k1, k2], p_ms, 4 * (2 * N + 3 * N + n_w),
                                2.0 * fwd_macs * N, tensor_cores=True, pixels=N, **split)}
    f = image_fwd["frame"]
    log(f"[time] image_fwd N={N}: a call {k1:.3f} / {k2:.3f} ms (device {split['device_ms']:.4f} "
        f"ms, {split['device_events']:.0f} device events and {split['other_device_ms']:.4f} ms "
        f"beside them, host {split['host_ms']:.4f} ms a call), plain {p_ms:.3f} ms, bound "
        f"{f['bound_ms']:.3f} ms ({f['bound_by']}; 3xTF32 {f['tf32x3_bound_ms']:.3f}, fp32 "
        f"{f['fp32_bound_ms']:.3f} ms), {f['achieved_tflops_s']:.2f} TFLOP/s")
    if split["device_events"] != 2 or split["other_device_ms"] != 0.0:
        raise AssertionError(f"an image_fwd call ran {split['device_events']} device events, "
                             f"{split['other_device_ms']} ms of them not its two kernels")
    reset_launches()
    return feat, image_train, image_fwd


def phase_feats_e2e(ds, device):
    """lego_ingp with the paper's tables on the fused route (the feats
    route: plain-gather encode, feat train kernel per level) end to end: the
    host seconds of a warm train step (OCC_TIMED_STEPS steps ending in one
    synchronize), rays/s, peak memory, the device's busy share and device
    time by kernel of 5 steps under torch.profiler, and the 400 x 400 frame
    (standard route: plain gather and MLP, no kernel) with its busy share;
    then the long-ray overlay's warm step (hash kernels + feat train
    kernel), its busy share and device time by kernel likewise, and its
    frame (the standard route with the hash forward kernel: 2 launches a
    32,768-ray chunk, 10 a frame, and no other kernel) as the paper tables'
    frame is timed: 2 warm frames, peak memory, busy share, device time by
    kernel."""
    import torch
    from nerf_meets_mlx_torch.cameras.pose import orbit_poses
    from nerf_meets_mlx_torch.config import lego_ingp
    from nerf_meets_mlx_torch.datasets.synthetic import CAMERA_ANGLE_X
    from nerf_meets_mlx_torch.engine import TrainState, make_nerf_train_step
    from nerf_meets_mlx_torch.rendering import render_image

    images = torch.as_tensor(ds.images[ds.i_train], device=device)
    poses = torch.as_tensor(ds.poses[ds.i_train, :3, :4], device=device)
    focal = 0.5 * RES / np.tan(0.5 * CAMERA_ANGLE_X)
    K = np.array([[focal, 0, RES / 2], [0, focal, RES / 2], [0, 0, 1]], np.float32)
    long_cfg = lego_ingp()
    long_cfg = long_cfg.replace(render=dataclasses.replace(
        long_cfg.render, n_samples=LONG_RAYS[0], n_importance=LONG_RAYS[1]))
    out = {}
    for key, cfg, n_steps in (("paper_tables", paper_cfg(), OCC_TIMED_STEPS),
                              ("long_rays", long_cfg, 10)):
        model = make_model(cfg.replace(use_fused_kernel=True), device)
        state = TrainState(model, cfg.train)
        step = make_nerf_train_step(model, ds.H, ds.W, ds.focal)
        gen = torch.Generator(device=device).manual_seed(SEED + 25)
        for _ in range(3):
            step(state, images, poses, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step(state, images, poses, gen)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / n_steps
        launches = launches_now()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        n_rand = cfg.train.n_rand
        log(f"[time] train step lego_ingp+{key} ({n_rand} rays, {cfg.render.n_samples} + "
            f"{cfg.render.n_importance} samples): {step_s:.5f} s/step over {n_steps} warm "
            f"steps -> {n_rand / step_s:.1f} rays/s; launches {launches}; peak device memory "
            f"{peak_gb:.2f} GB")
        res = {"step_s": step_s, "rays_per_s": n_rand / step_s, "peak_gb": peak_gb,
               "launches": launches}

        def steps():
            for _ in range(PROFILED_STEPS):
                step(state, images, poses, gen)

        res["trace"] = profile_device(steps, f"{PROFILED_STEPS} lego_ingp+{key} train steps")
        # the frame on the eval route (the standard query): the paper
        # tables' gathers its features in plain torch, the long-ray
        # overlay's launches the hash forward at both levels of each chunk
        chunks = -(-RES * RES // cfg.render.ray_chunk)
        want = counts() if key == "paper_tables" else counts(hash_fwd=2 * chunks)
        times = []
        for pose in orbit_poses(160)[:2]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render_image(model, RES, RES, K, pose[:3, :4])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        render_image(model, RES, RES, K, orbit_poses(160)[0][:3, :4])
        frame_peak = torch.cuda.max_memory_allocated() / 1e9
        frame_launches = launches_now()
        if frame_launches != want:
            raise AssertionError(f"the {key} frame launched {frame_launches}, want {want}")
        res["frame_trace"] = profile_device(
            lambda: render_image(model, RES, RES, K, orbit_poses(160)[0][:3, :4]),
            f"one {RES}x{RES} lego_ingp+{key} frame")
        log(f"[time] render_image {RES}x{RES} lego_ingp+{key}: frames {times} s -> "
            f"{min(times):.4f} s/frame, {RES * RES / min(times):.1f} rays/s; launches "
            f"{ {k: v for k, v in frame_launches.items() if v} }; peak device memory "
            f"{frame_peak:.2f} GB")
        res["frame"] = {"frame_seconds": times, "rays_per_s": RES * RES / min(times),
                        "peak_gb": frame_peak, "launches": frame_launches}
        out[key] = res
        del model, state
        torch.cuda.empty_cache()
    reset_launches()
    return out


def phase_image_timing(device):
    """The image task's warm step (IMAGE_TIMED_STEPS steps of 4096 pixels
    ending in one synchronize) on the kernel route and on the plain route,
    the busy share of 5 kernel-route steps, and one 400 x 400 prediction
    on each route (host clock, ends in a synchronize)."""
    import torch
    from nerf_meets_mlx_torch.datasets.image import make_test_image, pixel_dataset
    from nerf_meets_mlx_torch.engine import TrainState, make_image_train_step
    from nerf_meets_mlx_torch.kernels import fused_image as fim

    coords, colors = (torch.as_tensor(a, device=device)
                      for a in pixel_dataset(make_test_image(RES)))
    out = {}
    for route, fused in (("kernel", True), ("plain", False)):
        model = image_model(device, fused=fused)
        state = TrainState(model, model.cfg.train)
        step = make_image_train_step(model)
        gen = torch.Generator(device=device).manual_seed(SEED + 26)
        for _ in range(5):
            step(state, coords, colors, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(IMAGE_TIMED_STEPS):
            step(state, coords, colors, gen)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / IMAGE_TIMED_STEPS
        res = {"step_s": step_s, "pixels_per_s": model.cfg.train.n_rand / step_s}
        if fused:
            def steps():
                for _ in range(PROFILED_STEPS):
                    step(state, coords, colors, gen)

            res["trace"] = profile_device(steps, f"{PROFILED_STEPS} image train steps")
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                if fused:
                    fim.fused_image_apply(model.coarse, model.pos_enc, coords)
                else:
                    model.query("coarse", coords[:, None, :], None)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        res["frame_seconds"] = times
        log(f"[time] image step ({route} route, {model.cfg.train.n_rand} pixels): {step_s:.6f} "
            f"s/step over {IMAGE_TIMED_STEPS} warm steps; {RES}x{RES} prediction {times} s")
        out[route] = res
    reset_launches()
    return out


# ---------------------------------------------------------------------------
# the shapes the overlay keys reach, and the CP path (lego_cp)
# ---------------------------------------------------------------------------

# (width, P) of the feat builds: lego_ingp's 8 x 2 (long rays), the paper
# tables' 16 x 2, and (128, 32) for its runtime-shape build
FEAT_SHAPES = ((64, 16), (64, 32), (128, 32))
# the widths other than 32, 64, 128 and 256 that the sinusoidal and image
# sources are built for, one build each (fused_train.width_defines): the
# PART_A overlays' and the width-96 image model's
KW_BUILDS = (("fused_eval", 96), ("fused_train", 96), ("fused_eval", 48), ("fused_train", 48),
             ("mlp_bwd_tc", 48), ("mlp_fwd_tc", 48), ("image_fwd_tc", 96), ("image_train_tc", 96))
PART_A_STEPS = 10
# the overlay commands that train in JAX and failed on the card before the
# fused kernels took their shapes: (tag, preset, overlay, kernels its
# training must launch); PR 6's six, then the widths past 64 on the INGP and
# feat kernels, 32 levels, 8 features a level, 128 channels, and sinusoidal
# widths that are odd multiples of 16
PAPER_32X4 = "hash_n_levels = 32\nhash_log2_table_size = 19\nhash_max_res = 512\n" \
    "hash_features_per_level = 4\n"
PART_A = (
    ("lego_ingp+netwidth32", "lego_ingp", "netwidth = 32\n", ("ingp_train", "ingp_eval")),
    ("lego_ingp+16_levels", "lego_ingp", "hash_n_levels = 16\nhash_log2_table_size = 14\n",
     ("ingp_train", "ingp_eval")),
    ("lego_ingp+4_features", "lego_ingp", "hash_features_per_level = 4\n",
     ("ingp_train", "ingp_eval")),
    ("lego_ingp+bf16_hash", "lego_ingp", "hash_compute_dtype = bfloat16\n",
     ("ingp_train", "ingp_eval")),
    ("lego_hierarchical+netwidth64", "lego_hierarchical", "netwidth = 64\n", ("train", "eval")),
    ("lego_occ+netwidth64", "lego_occ", "netwidth = 64\n", ("train", "eval", "mlp_fwd")),
    ("lego_ingp+netwidth128", "lego_ingp", "netwidth = 128\n", ("ingp_train", "ingp_eval")),
    ("lego_ingp+netwidth256", "lego_ingp", "netwidth = 256\n", ("ingp_train", "ingp_eval")),
    ("lego_ingp+32_levels", "lego_ingp", "hash_n_levels = 32\nhash_log2_table_size = 12\n",
     ("ingp_train", "ingp_eval")),
    ("lego_ingp+8_features", "lego_ingp", "hash_features_per_level = 8\nhash_n_levels = 12\n",
     ("ingp_train", "ingp_eval")),
    ("paper_tables+netwidth128", "lego_ingp", PAPER_OVERLAY + "netwidth = 128\n",
     ("feat_train",)),
    ("paper_tables+32x4", "lego_ingp", PAPER_32X4, ("feat_train",)),
    ("lego_hierarchical+netwidth96", "lego_hierarchical", "netwidth = 96\n", ("train", "eval")),
    ("lego_occ+netwidth48", "lego_occ", "netwidth = 48\n", ("train", "eval", "mlp_fwd")),
)
# the image model's width reached through the Python API only (image2d())
IMAGE_API_WIDTH = 96
# lego_cp's batches for the CP kernels: a train step's coarse and fine
# points, and one eval chunk's fine and coarse points (rays, samples a ray)
CP_BATCHES = (("coarse", 4096, 48), ("fine", 4096, 96), ("eval_chunk", 32768, 96),
              ("frame_coarse", 32768, 48))
CP_RANDOM = 393_216  # uniform random points in and around the box, as the gpu test draws
CP_VAL_ATOL, CP_VAL_RTOL = 1e-6, 1e-5  # the same roundings; sums of two exact products
CP_DL_REL = 1e-4                       # dLines: atomics add in another order
CP_ROUTE_RTOL = 1e-2                   # kernel route vs standard route, see phase_cp_routes
CP_FRAME_ATOL = 1e-2                   # their frames' colours, the same semantics apart
CP_TIMED_STEPS = 25


# the further shapes that the gpu-marked tests hold against their plain
# versions: widths 32 and 64 with 16, 24, 48 or 64 feature channels (every
# register build of csrc/fused_feat.cu); the widths 48 and 96 of the
# sinusoidal and image kernels
TEST_FEAT_SHAPES = ((32, 16), (64, 64), (32, 24), (32, 48))
TEST_KW_BUILDS = tuple((s, w) for s in ("fused_eval", "fused_train", "mlp_bwd_tc", "mlp_fwd_tc",
                                        "image_fwd_tc", "image_train_tc") for w in (48, 96))
# the INGP eval, the MLP forward, the MLP backward and the image forward
# kernels with one TF32 product in place of three: the controls that the gpu
# tests of their 3xTF32 products see fail EVAL_TIGHT, MLP_TIGHT, the
# backward's gradient criterion and IMAGE_TIGHT (the image forward's at the
# widths 48 and 96 of those tests too)
TEST_ONE_PASS = (("ingp_eval_tc", {"INGP_EVAL_ONE_PASS": 1}),
                 ("mlp_fwd_tc", {"MLP_FWD_ONE_PASS": 1}),
                 ("mlp_bwd_tc", {"MLP_BWD_ONE_PASS": 1}),
                 ("image_fwd_tc", {"IMAGE_FWD_ONE_PASS": 1}),
                 ("image_fwd_tc", {"IMAGE_FWD_ONE_PASS": 1, "KW": 48}),
                 ("image_fwd_tc", {"IMAGE_FWD_ONE_PASS": 1, "KW": 96}))


def build_variants(tests: bool = False):
    """(source, defines) of every build the script's phases use, and with
    ``tests`` those of the gpu-marked tests too, each once."""
    from nerf_meets_mlx_torch.kernels import fused_feat_train as ff
    from nerf_meets_mlx_torch.kernels import fused_ingp_train as fi
    from nerf_meets_mlx_torch.kernels import fused_train as ft

    feat = FEAT_SHAPES + (TEST_FEAT_SHAPES if tests else ())
    kw = KW_BUILDS + (TEST_KW_BUILDS if tests else ())
    # the INGP sources take every shape in one build each: the eval and the
    # train kernel on the tensor cores, and csrc/fused_ingp.cu for the rest
    out = [(s, None) for s in ("fused_eval", "fused_train", "mlp_bwd_tc", "mlp_fwd_tc",
                               "hash_encode", "image_fwd_tc", "image_train_tc", "cp_encode",
                               fi.TC_SOURCE, fi.EVAL_SOURCE, fi.RT_SOURCE)]
    out += [("fused_feat", ff.kernel_defines(w, p)) for w, p in feat]
    out += [(s, ft.width_defines(w)) for s, w in kw]
    if tests:
        out += list(TEST_ONE_PASS)
    seen, unique = set(), []
    for name, defines in out:
        key = (name, tuple(sorted((defines or {}).items())))
        if key not in seen:
            seen.add(key)
            unique.append((name, defines))
    return unique


def build_only() -> int:
    """``python3 chip_smoke.py --build``: every build of the script and of
    the gpu-marked tests, all started together (the tests would build each
    on first use, one after another), with the ptxas report; then exits."""
    from nerf_meets_mlx_torch.kernels import _build

    t0 = time.perf_counter()
    variants = build_variants(tests=True)
    with ThreadPoolExecutor(len(variants)) as ex:
        futures = [(n, d, ex.submit(_build.build, n, d)) for n, d in variants]
    failed = [f.exception() for _, _, f in futures if f.exception() is not None]
    for e in failed:
        log(f"[build] {e}")
    if failed:
        raise RuntimeError(f"{len(failed)} of {len(variants)} builds failed")
    for name, defines, f in futures:
        variant = _build.variant_name(name, defines)
        for line in _build.BUILD_LOG.get(variant, "(cached build)").splitlines():
            if any(k in line for k in ("registers", "spill")):
                log(f"[build] {variant}: {line.strip()}")
    log(f"[build] {len(variants)} builds in {time.perf_counter() - t0:.1f} s")
    return 0


def overlay_cfg(preset, overlay, tag):
    """(config, overlay file) of ``preset`` under the text overlay."""
    from nerf_meets_mlx_torch.config import PRESETS, config_from_text

    OUT.mkdir(parents=True, exist_ok=True)
    txt = OUT / f"overlay_{tag}.txt"
    txt.write_text("i_print = 1\n" + overlay)
    return config_from_text(txt, PRESETS[preset]()), txt


def check_values(what, pairs):
    """max |kernel - plain| over (name, kernel, plain) value pairs, each
    within ATOL + RTOL·|plain|; raises otherwise."""
    import torch

    worst = 0.0
    for name, k, p in pairs:
        k, p = k.detach(), p.detach()
        err = float((k - p).abs().max())
        worst = max(worst, err)
        if not (bool(torch.isfinite(k).all())
                and bool(((k - p).abs() <= ATOL + RTOL * p.abs()).all())):
            raise AssertionError(f"{what}: {name} disagrees with its plain version ({err:.3e})")
    return worst


def check_grads(what, g_k, g_p, floor_rel=GRAD_FLOOR):
    """Every gradient array within DW_REL of its largest plain value plus
    ``floor_rel`` of the largest plain entry of all arrays."""
    import torch

    floor = floor_rel * max(float(b.abs().max()) for b in g_p)
    worst = 0.0
    for i, (a, b) in enumerate(zip(g_k, g_p)):
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        worst = max(worst, err / scale if scale > 0 else 0.0)
        if not (bool(torch.isfinite(a).all()) and err <= DW_REL * scale + floor):
            raise AssertionError(f"{what}: gradient {i} off by {err:.3e} of {scale:.3e}")
    return worst


def check_ingp_shape(cfg, device, tag):
    """The INGP kernels at this config's shapes (both MLPs, 4096 rays, both
    levels, its hash compute type, tables with N(0, 0.1) added; the eval
    call in both compositing modes) against their plain versions (bf16: the
    rounding twin), then each timed per
    level (CUDA events, 3 launches; the eval kernel on the same 4096 rays);
    returns the worst value error, the worst gradient ratio and the
    times."""
    import torch
    from nerf_meets_mlx_torch.kernels import fused_ingp_train as fi

    model = make_model(cfg.replace(use_fused_kernel=True), device)
    gen = torch.Generator(device=device).manual_seed(SEED + 40)
    with torch.no_grad():
        model.pos_enc.tables.add_(torch.randn(model.pos_enc.tables.shape, generator=gen,
                                              device=device) * INGP_TABLE_NOISE)
    ro, rd, vd = picked_rays(device)
    target = torch.rand((ro.shape[0], 3), generator=gen, device=device)
    sh, coarse, fine = ingp_level_inputs(model, ro, rd, vd, target, gen, NOISE_STD)
    val = ratio = 0.0
    times = {}
    enc = model.pos_enc
    build = fi.eval_build(model.cfg.mlp.net_width, model.cfg.mlp.net_depth, enc.n_levels,
                          enc.features_per_level, model.dir_enc.out_dim)[0]
    for (z, dl, nz), mlp, level in ((coarse, model.coarse, "coarse"), (fine, model.fine, "fine")):
        for mode in ("canonical", "reference"):
            spec = ingp_tspec(model, z.shape[1], mode=mode)
            with torch.no_grad():
                k = fi.fused_ingp_eval_apply(mlp, enc, sh, spec, ro, rd, z, dl)
                torch.cuda.synchronize()
                p = fi.fused_ingp_eval_reference(mlp, enc, sh, spec, ro, rd, z, dl)
            val = max(val, check_values(f"{tag} ingp_eval ({build}) {level} {mode}",
                                        zip(("rgb", "w"), k, p)))
        tspec = ingp_tspec(model, z.shape[1])
        params = mlp_params(mlp) + [model.pos_enc.tables]
        args = (mlp, model.pos_enc, sh, tspec, ro, rd, z, dl, nz, target)
        k = fi.fused_ingp_train_apply(*args)
        g_k = torch.autograd.grad(k[0], params)
        torch.cuda.synchronize()
        p = fi.fused_ingp_train_reference(*args)
        g_p = torch.autograd.grad(p[0], params)
        val = max(val, check_values(f"{tag} ingp_train {level}", zip(("sse", "rgb", "w"), k, p)))
        ratio = max(ratio, check_grads(f"{tag} ingp_train {level}", g_k, g_p))
        with torch.no_grad():
            times[level] = {
                "width": mlp.cfg.net_width, "rays": ro.shape[0], "samples": z.shape[1],
                "train_ms": cuda_time_ms(lambda: fi.fused_ingp_train_apply(*args), 3),
                "eval_ms": cuda_time_ms(lambda: fi.fused_ingp_eval_apply(
                    mlp, model.pos_enc, sh, tspec, ro, rd, z, dl), 3)}
        log(f"[part-a] {tag} {level} width {mlp.cfg.net_width}, {model.pos_enc.n_levels} x "
            f"{model.pos_enc.features_per_level} features ({model.pos_enc.compute_dtype}): "
            f"INGP kernels vs plain (eval on {build}), worst value {val:.3e}, gradient ratio "
            f"{ratio:.2e} ok; "
            f"train {times[level]['train_ms']:.3f} ms, eval {times[level]['eval_ms']:.3f} ms "
            f"a launch")
    return val, ratio, times


def check_sinusoidal_shape(cfg, device, tag):
    """The eval and train kernels (and, with an occupancy grid, the MLP
    forward and backward kernels, the forward also within MLP_TIGHT, the
    backward by ``fused_mlp.grad_check``) at this config's widths against their
    plain versions, both levels at 4096 rays; returns the worst value error
    and gradient ratio (against the fp32 plain versions)."""
    import torch
    from nerf_meets_mlx_torch.kernels import fused_mlp as fm
    from nerf_meets_mlx_torch.kernels import fused_train as ft

    model = make_model(cfg.replace(use_fused_kernel=True), device)
    gen = torch.Generator(device=device).manual_seed(SEED + 41)
    ro, rd, vd = picked_rays(device)
    target = torch.rand((ro.shape[0], 3), generator=gen, device=device)
    val = ratio = 0.0
    times = {}
    levels = zip(level_inputs(model, ro, rd, vd),
                 train_level_inputs(model, ro, rd, vd, target, gen, NOISE_STD),
                 (model.coarse, model.fine), ("coarse", "fine"))
    for (z, dl), (zt, dlt, nz), mlp, level in levels:
        S = z.shape[1]
        with torch.no_grad():
            k = ft.fused_eval_apply(mlp, model.pos_enc, model.dir_enc, tspec_for(model, S),
                                    ro, rd, vd, z, dl)
            torch.cuda.synchronize()
            p = ft.fused_eval_reference(mlp, model.pos_enc, model.dir_enc, tspec_for(model, S),
                                        ro, rd, vd, z, dl)
        val = max(val, check_values(f"{tag} eval {level}", zip(("rgb", "w"), k, p)))
        args = (mlp, model.pos_enc, model.dir_enc, train_tspec(model, S), ro, rd, vd, zt, dlt,
                nz, target)
        k = ft.fused_train_apply(*args)
        g_k = torch.autograd.grad(k[0], mlp_params(mlp))
        torch.cuda.synchronize()
        p = ft.fused_train_reference(*args)
        g_p = torch.autograd.grad(p[0], mlp_params(mlp))
        val = max(val, check_values(f"{tag} train {level}", zip(("sse", "rgb", "w"), k, p)))
        ratio = max(ratio, check_grads(f"{tag} train {level}", g_k, g_p, floor_rel=0.0))
        if cfg.render.occupancy:
            pts = (ro[:, None, :] + zt[..., None] * rd[:, None, :]).reshape(-1, 3)
            dirs = vd[:, None, :].expand(-1, S, -1).reshape(-1, 3)
            dout = torch.randn((pts.shape[0], 4), generator=gen, device=device)
            k = fm.fused_mlp_apply(mlp, model.pos_enc, model.dir_enc, pts, dirs)
            g_k = torch.autograd.grad((k * dout).sum(), mlp_params(mlp))
            torch.cuda.synchronize()
            with torch.no_grad():
                p = fm.fused_mlp_reference(mlp, model.pos_enc, model.dir_enc, pts, dirs)
            k = k.detach()
            val = max(val, check_values(f"{tag} mlp {level}", [("raw", k, p)]))
            _, tight, ok = mlp_fwd_errors(k, p)
            if not ok:
                raise AssertionError(f"{tag} mlp {level}: raw at {tight:.3f} of MLP_TIGHT")
            del k, p
            check = fm.grad_check(mlp, model.pos_enc, model.dir_enc, pts, dirs, dout, False, g_k,
                                  DW_REL)
            log(f"[part-a] {tag} {level} mlp backward: {check.describe()} "
                f"{'ok' if check.ok else 'FAIL'}")
            if not check.ok:
                raise AssertionError(f"{tag} mlp {level}: the backward's gradients miss "
                                     "fused_mlp.grad_check")
            ratio = max(ratio, max(check.r32))
        with torch.no_grad():
            times[level] = {
                "width": mlp.cfg.net_width, "rays": ro.shape[0], "samples": S,
                "train_ms": cuda_time_ms(lambda: ft.fused_train_apply(*args), 3),
                "eval_ms": cuda_time_ms(lambda: ft.fused_eval_apply(
                    mlp, model.pos_enc, model.dir_enc, tspec_for(model, S), ro, rd, vd, z, dl), 3)}
        log(f"[part-a] {tag} {level} width {mlp.cfg.net_width}: sinusoidal kernels vs plain, "
            f"worst value {val:.3e}, gradient ratio {ratio:.2e} ok; train "
            f"{times[level]['train_ms']:.3f} ms, eval {times[level]['eval_ms']:.3f} ms a launch")
    return val, ratio, times


def check_feat_shape(cfg, device, tag):
    """The feat train kernel at this config's shapes (both MLPs, 4096 rays,
    both levels as the feats route makes them, tables with N(0, 0.1) added)
    against its plain version (``feat_case``, its compositing mode and
    background), then timed per level (CUDA events, 3 launches); returns the
    worst value error, the worst gradient ratio and the times."""
    import copy

    import torch
    from nerf_meets_mlx_torch.kernels import fused_feat_train as ff

    model = make_model(cfg.replace(use_fused_kernel=True), device)
    gen = torch.Generator(device=device).manual_seed(SEED + 42)
    with torch.no_grad():
        model.pos_enc.tables.add_(torch.randn(model.pos_enc.tables.shape, generator=gen,
                                              device=device) * INGP_TABLE_NOISE)
    ro, rd, vd = picked_rays(device)
    target = torch.rand((ro.shape[0], 3), generator=gen, device=device)
    sh, coarse, fine = ingp_level_inputs(model, ro, rd, vd, target, gen, NOISE_STD)
    rcfg = model.cfg.render
    val = ratio = 0.0
    times = {}
    for level, (z, dl, nz), mlp in (("coarse", coarse, model.coarse), ("fine", fine, model.fine)):
        with torch.no_grad():
            feats = model.pos_enc.apply(ro[:, None, :] + z[..., None] * rd[:, None, :])
        v, ratios, _ = feat_case(f"{tag} {level}", model, mlp, copy.deepcopy(mlp).double(), feats,
                                 sh, dl, nz, target, rcfg.compositing, rcfg.white_bkgd)
        val, ratio = max(val, v), max(ratio, max(ratios))
        tspec = feat_tspec(model, z.shape[1])
        x = ff.pack_feat_inputs(feats, sh, dl, nz)
        with torch.no_grad():
            times[level] = {"width": mlp.cfg.net_width, "rays": ro.shape[0],
                            "samples": z.shape[1], "channels": feats.shape[-1],
                            "train_ms": cuda_time_ms(
                                lambda: ff.fused_feat_train_apply(mlp, tspec, x, target), 3)}
        log(f"[part-a] {tag} {level} width {mlp.cfg.net_width}, {feats.shape[-1]} channels: "
            f"feat kernel vs plain, worst value {val:.3e}, gradient ratio {ratio:.2e} ok; train "
            f"{times[level]['train_ms']:.3f} ms a launch")
    return val, ratio, times


def phase_part_a(device):
    """Each overlay command of PART_A through the training entry point for
    PART_A_STEPS steps with every launch count at 0 before it: the kernels
    of its route launched (the INGP, feat or sinusoidal train kernel once a
    level a step, the eval kernel in its renders), finite metrics, a falling
    loss (the last step's below the first's); then the kernels at its
    shapes against their plain versions, timed per level. Then the image
    kernels of a width-96 image model against their plain version."""
    from nerf_meets_mlx_torch.entrypoints import train_nerf

    out = {}
    for tag, preset, overlay, kernels in PART_A:
        cfg, txt = overlay_cfg(preset, overlay, tag)
        log_dir = OUT / f"train_{tag}"
        shutil.rmtree(log_dir, ignore_errors=True)
        reset_launches()
        t0 = time.perf_counter()
        res = train_nerf(preset=preset, synth_resolution=RES, max_iters=PART_A_STEPS,
                         precrop_iters=0, render_video=False, device=device,
                         log_dir=str(log_dir), config_txt=str(txt))
        wall = time.perf_counter() - t0
        launches = launches_now()
        train_key = next(k for k in ("ingp_train", "feat_train", "train") if k in kernels)
        losses = [json.loads(x)["loss"] for x in (log_dir / "metrics.jsonl").read_text().splitlines()
                  if '"loss"' in x]
        log(f"[part-a] train_nerf {tag}, {PART_A_STEPS} steps: {wall:.1f} s; launches "
            f"{ {k: v for k, v in launches.items() if v} }; losses {losses[0]:.5f} -> "
            f"{losses[-1]:.5f}; test PSNR {res['test_psnr_mean']:.3f}")
        if (launches[train_key] != 2 * PART_A_STEPS or any(launches[k] < 1 for k in kernels)
                or not all(np.isfinite(losses)) or not np.isfinite(res["test_psnr_mean"])
                or not losses[-1] < losses[0]):
            raise AssertionError(f"{tag}: its kernels did not run, a metric is not finite, or "
                                 "the loss did not fall")
        check = {"ingp_train": check_ingp_shape, "feat_train": check_feat_shape,
                 "train": check_sinusoidal_shape}[train_key]
        val, ratio, times = check(cfg, device, tag)
        out[tag] = {"wall_s": wall, "launches": {k: launches[k] for k in kernels},
                    "loss_first": losses[0], "loss_last": losses[-1],
                    "test_psnr_mean": res["test_psnr_mean"], "max_abs_err": val,
                    "worst_grad_ratio": ratio, "per_level": times}
    # the image model at a width only the Python API reaches
    sse_err, dw_ratio, fwd_err = phase_compare_image(device, width=IMAGE_API_WIDTH)
    out[f"image2d+width{IMAGE_API_WIDTH}"] = {"max_abs_err": max(sse_err, fwd_err),
                                             "worst_grad_ratio": dw_ratio}
    reset_launches()
    return out


# lego_ingp's train-step batches (coarse, fine) and the Instant-NGP paper's
# tables at the fine batch: the shapes of the compute_dx and grid kernels
DX_REL = 1e-4   # dX: sums over levels and corners in another order
HASH_DG_REL = 1e-3  # dG: atomics add in another order
HASH_RANDOM = 393_216  # uniform random points in and around the box, as the gpu test draws
DX_KERNELS = ("hash_dx_dg_kernel", "hash_dx_kernel")  # the compute_dx backward's launches


def hash_api_sets(device):
    """(name, encoding, points [N, 3]) of the hash API paths: lego_ingp's
    coarse (196,608) and fine (393,216) points of a train step, with tables
    N(0, 0.1) added, the fine points under the paper's 16 x 2^19 x 2
    tables, and HASH_RANDOM uniform random points in [-1.6, 1.6]^3 at
    lego_ingp's tables (no runs along a ray)."""
    import torch

    model = ingp_model("lego_ingp", device, noisy=True)
    sets = [(n, model.pos_enc, pts) for n, pts in ingp_point_sets(model, device) if n != "grid"]
    paper = feat_model("paper", device)
    sets.append(("paper", paper.pos_enc, sets[-1][2]))
    gen = torch.Generator(device=device).manual_seed(SEED + 15)
    sets.append(("random", model.pos_enc,
                 torch.rand((HASH_RANDOM, 3), generator=gen, device=device) * 3.2 - 1.6))
    return sets


def phase_hash_api(device):
    """The hash encode's last four kernels on the paths of the API that
    reaches them (``hash_encode_apply(enc, x, compute_dx=True)`` and
    ``levels_in_body=False``; no model path of the JAX package takes
    either): every count at 0, forward and backward on a lego_ingp train
    step's coarse and fine points, the counts read; then each kernel
    against its plain version at ``hash_api_sets``' batches, in fp32 and
    with a bf16 encoding (compute_dx: fp32 either way): features to atol
    1e-4 + rtol 1e-4, dX to DX_REL and dG to HASH_DG_REL of the largest
    plain value; then each timed per launch (CUDA events) beside its plain
    version and its byte bound (points, features or cotangent and dX, the
    tables read once where a kernel reads them, dG written once, over 3.35
    TB/s), the compute_dx backward also by its kernels' device time
    (torch.profiler: ``DX_KERNELS``, each and together, and their launches
    a call). Returns
    (launches, worst errors, times)."""
    import copy

    import torch
    from nerf_meets_mlx_torch.kernels import hash_encode as he

    sets = hash_api_sets(device)
    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    douts = {n: torch.randn((pts.shape[0], enc.out_dim), generator=gen, device=device)
             for n, enc, pts in sets}

    # the path: forward and backward through the API, coarse and fine
    reset_launches()
    for name, enc, pts in sets[:2]:
        x = pts.clone().requires_grad_(True)
        f = he.hash_encode_apply(enc, x, compute_dx=True)
        torch.autograd.grad((f * douts[name]).sum(), [x, enc.tables])
        f = he.hash_encode_apply(enc, pts, levels_in_body=False)
        torch.autograd.grad((f * douts[name]).sum(), enc.tables)
    torch.cuda.synchronize()
    launches = launches_now()
    want = counts(hash_dx_fwd=2, hash_dx_bwd=2, hash_grid_fwd=2, hash_grid_bwd=2)
    log(f"[hash-api] launches {launches}")
    if launches != want:
        raise AssertionError(f"the hash API paths launched {launches}, not {want}")

    errs = {"dx_fwd": 0.0, "dx_bwd": 0.0, "dx_dg_ratio": 0.0, "dx_ratio": 0.0, "grid_fwd": 0.0,
            "grid_bwd": 0.0, "grid_dg_ratio": 0.0}
    for name, enc, pts in sets:
        dout = douts[name]
        for dtype in ("float32", "bfloat16"):
            e = enc
            if dtype == "bfloat16":
                e = copy.deepcopy(enc)
                e.compute_dtype = dtype
            # compute_dx
            x = pts.clone().requires_grad_(True)
            f_k = he.hash_encode_apply(e, x, compute_dx=True)
            gx_k, gt_k = torch.autograd.grad((f_k * dout).sum(), [x, e.tables])
            torch.cuda.synchronize()
            f_p = he.hash_encode_dx_reference(e, x)
            gx_p, gt_p = torch.autograd.grad((f_p * dout).sum(), [x, e.tables])
            v = check_values(f"hash_dx_fwd {name} {dtype}", [("feats", f_k, f_p)])
            rx, rg = grad_ratios([gx_k, gt_k], [gx_p, gt_p])
            ok = (bool(torch.isfinite(gx_k).all()) and rx <= DX_REL
                  and bool(torch.isfinite(gt_k).all()) and rg <= HASH_DG_REL)
            errs["dx_fwd"] = max(errs["dx_fwd"], v)
            errs["dx_bwd"] = max(errs["dx_bwd"], float((gx_k - gx_p).abs().max()))
            errs["dx_ratio"] = max(errs["dx_ratio"], rx)
            errs["dx_dg_ratio"] = max(errs["dx_dg_ratio"], rg)
            log(f"[compare] hash_dx {name:6s} {dtype:8s} N={pts.shape[0]}: feats max_abs {v:.3e}; "
                f"max|dX-plain|/max|plain| {rx:.2e} (max|dX| {float(gx_p.abs().max()):.3e}); "
                f"dG {rg:.2e} " + ("ok" if ok else "FAIL"))
            if not ok:
                raise AssertionError(f"the compute_dx kernels disagree with plain: {name} {dtype}")
            # one level per grid step
            f_k = he.hash_encode_apply(e, pts, levels_in_body=False)
            (g_k,) = torch.autograd.grad((f_k * dout).sum(), e.tables)
            torch.cuda.synchronize()
            f_p = he.hash_encode_reference(e, pts)
            (g_p,) = torch.autograd.grad((f_p * dout).sum(), e.tables)
            v = check_values(f"hash_grid_fwd {name} {dtype}", [("feats", f_k, f_p)])
            (rg,) = grad_ratios([g_k], [g_p])
            ok = bool(torch.isfinite(g_k).all()) and rg <= HASH_DG_REL
            errs["grid_fwd"] = max(errs["grid_fwd"], v)
            errs["grid_bwd"] = max(errs["grid_bwd"], float((g_k - g_p).abs().max()))
            errs["grid_dg_ratio"] = max(errs["grid_dg_ratio"], rg)
            log(f"[compare] hash_grid {name:6s} {dtype:8s} N={pts.shape[0]}: feats max_abs "
                f"{v:.3e}; dG {rg:.2e} " + ("ok" if ok else "FAIL"))
            if not ok:
                raise AssertionError(f"the grid hash kernels disagree with plain: {name} {dtype}")

    def entry(ms_runs, plain_ms, nbytes, **extra):
        ms = sum(ms_runs) / len(ms_runs)
        return dict(ms=ms, ms_runs=ms_runs, plain_ms=plain_ms,
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", **extra)

    times = {k: {} for k in ("dx_fwd", "dx_bwd", "grid_fwd", "grid_bwd")}
    for name, enc, pts in sets:
        N, C = pts.shape[0], enc.out_dim
        tb = 4 * enc.tables.numel()
        dout = douts[name]
        reps = max(5, int(4_000_000 // N))
        x = pts.clone().requires_grad_(True)

        def plain_dx_bwd():
            torch.autograd.grad((he.hash_encode_dx_reference(enc, x) * dout).sum(),
                                [x, enc.tables])

        def plain_bwd():
            torch.autograd.grad((he.hash_encode_reference(enc, pts) * dout).sum(), enc.tables)

        for key, kern, plain, nbytes in (
            ("dx_fwd", lambda: he._dx_fwd_launch(enc, pts),
             lambda: he.hash_encode_dx_reference(enc, pts), 4 * N * (3 + C) + tb),
            ("dx_bwd", lambda: he._dx_bwd_launch(enc, pts, dout), plain_dx_bwd,
             4 * N * (3 + C + 3) + 2 * tb),
            ("grid_fwd", lambda: he._fwd_launch(enc, pts, grid=True),
             lambda: he.hash_encode_reference(enc, pts), 4 * N * (3 + C) + tb),
            ("grid_bwd", lambda: he._bwd_launch(enc, pts, dout, grid=True), plain_bwd,
             4 * N * (3 + C) + tb),
        ):
            if key.endswith("fwd"):
                with torch.no_grad():
                    k1 = cuda_time_ms(kern, reps)
                    p_ms = cuda_time_ms(plain, max(2, reps // 4))
                    k2 = cuda_time_ms(kern, reps)
            else:
                k1 = cuda_time_ms(kern, reps)
                p_ms = cuda_time_ms(plain, max(2, reps // 4))
                k2 = cuda_time_ms(kern, reps)
            times[key][name] = entry([k1, k2], p_ms, nbytes, points=N)
            if key == "dx_bwd":
                split = kernel_split_ms(kern, DX_KERNELS, reps)
                times[key][name].update(device_ms=sum(split.values()), device_split=split,
                                        device_launches=launches_a_call(kern, "hash_dx"))
                log(f"[time] hash_dx_bwd {name:6s} N={N}: device "
                    f"{times[key][name]['device_ms']:.4f} ms in "
                    f"{times[key][name]['device_launches']:g} launches a call "
                    + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
            log(f"[time] hash_{key} {name:6s} N={N}: kernel {k1:.4f} / {k2:.4f} ms, plain "
                f"{p_ms:.3f} ms, bound {times[key][name]['bound_ms']:.4f} ms (bytes)")
    reset_launches()
    return launches, errs, times


def cp_model(device, cfg=None):
    from nerf_meets_mlx_torch.config import lego_cp

    return make_model(cfg or lego_cp(), device)


def with_cp_kernel(model):
    """The model with its position encode replaced, on this model object
    only, by the CP drop-in ``cp_encode_apply`` (the Pallas semantics on the
    CUDA kernels). No config key does this: the JAX package keeps the XLA
    encode on lego_cp's path and measured its kernel slower there."""
    from nerf_meets_mlx_torch.kernels.cp_encode import cp_encode_apply

    model._encode_pos = lambda pts: cp_encode_apply(model.pos_enc, pts)
    return model


def cp_point_sets(device):
    """(name, points) of CP_BATCHES: rays of orbit frame 0 at RES x RES with
    lego_cp's AABB-tightened, jittered depths."""
    import torch
    from nerf_meets_mlx_torch.config import lego_cp

    ro, rd, _ = frame_rays(RES, RES, device)
    gen = torch.Generator(device=device).manual_seed(SEED + 30)
    out = []
    for name, n_rays, S in CP_BATCHES:
        cfg = lego_cp()
        cfg = cfg.replace(render=dataclasses.replace(cfg.render, n_samples=S))
        model = cp_model(device, cfg)
        pick = torch.randperm(ro.shape[0], generator=gen, device=device)[:n_rays]
        o, d = ro[pick], rd[pick]
        z = model._coarse_z(o, d, train=True, generator=gen)
        out.append((name, (o[:, None, :] + z[..., None] * d[:, None, :]).reshape(-1, 3)))
    return out


def phase_compare_cp(device):
    """Both CP kernels against their plain versions (the Pallas semantics)
    at CP_BATCHES (ray order) and on CP_RANDOM uniform random points, in
    lego_cp's bf16 compute and in fp32: the features to CP_VAL_ATOL +
    CP_VAL_RTOL·|plain| (whether they are equal bit for bit is logged),
    dLines (random cotangent) to CP_DL_REL of the largest plain value."""
    import torch
    from nerf_meets_mlx_torch.kernels import cp_encode as ce

    out = {"fwd": 0.0, "bwd": 0.0, "bwd_ratio": 0.0, "fwd_equal": True}
    gen = torch.Generator(device=device).manual_seed(SEED + 31)
    model = cp_model(device)
    enc = model.pos_enc
    uniform = torch.rand((CP_RANDOM, 3), generator=gen, device=device) * 3.4 - 1.7
    for name, pts in cp_point_sets(device) + [("random", uniform)]:
        for dtype in ("bfloat16", "float32"):
            enc.compute_dtype = dtype
            spec = ce.CPEncodeSpec.from_encoding(enc)
            flat = ce.flatten_lines(enc.lines)
            f_k = ce.cp_fwd_launch(spec, flat, pts)
            dout = torch.randn(f_k.shape, generator=gen, device=device)
            d_k = ce.split_lines(spec, ce.cp_bwd_launch(spec, flat, pts, dout))
            torch.cuda.synchronize()
            f_p = ce.cp_fwd_reference(spec, enc.lines, pts)
            d_p = ce.cp_bwd_reference(spec, enc.lines, pts, dout)
            err = float((f_k - f_p).abs().max())
            ok = bool(torch.isfinite(f_k).all()) and bool(
                ((f_k - f_p).abs() <= CP_VAL_ATOL + CP_VAL_RTOL * f_p.abs()).all())
            ratios = grad_ratios(d_k, d_p)
            ok &= all(bool(torch.isfinite(a).all()) for a in d_k) and max(ratios) <= CP_DL_REL
            equal = bool(torch.equal(f_k, f_p))
            out["fwd_equal"] &= equal
            log(f"[compare] cp_fwd/cp_bwd {name:12s} N={pts.shape[0]} {dtype}: max_abs features "
                f"{err:.3e} (equal bit for bit: {equal}); max|dLines-plain|/max|plain| per level "
                + " ".join(f"{r:.1e}" for r in ratios) + (" ok" if ok else " FAIL"))
            if not ok:
                raise AssertionError(f"the CP kernels disagree with their plain versions: {name}")
            out["fwd"] = max(out["fwd"], err)
            out["bwd"] = max(out["bwd"], max(float((a - b).abs().max()) for a, b in zip(d_k, d_p)))
            out["bwd_ratio"] = max(out["bwd_ratio"], max(ratios))
    enc.compute_dtype = "bfloat16"
    reset_launches()
    return out


def phase_cp_routes(ds, device):
    """ROUTE_STEPS lego_cp steps from one seed on the standard route (the
    plain encode, XLA semantics) and with the CP kernels behind the query
    (``with_cp_kernel``): exactly 2 cp_fwd and 2 cp_bwd launches a step on
    the kernel route and none on the standard one; the losses within
    CP_ROUTE_RTOL and the parameters within ``compare_params`` at lego_cp's
    lr (the two differ by the Pallas semantics: the box normalisation moves
    some bf16 weights by one bf16 ulp, and dLines keeps fp32 sums where the
    XLA path rounds them to bf16). Then one RES x RES frame through the
    kernel (2 cp_fwd launches a chunk) against the standard route's."""
    import torch
    from nerf_meets_mlx_torch.cameras.pose import orbit_poses
    from nerf_meets_mlx_torch.config import lego_cp
    from nerf_meets_mlx_torch.datasets.synthetic import CAMERA_ANGLE_X
    from nerf_meets_mlx_torch.rendering import render_image

    cfg = lego_cp()
    kern = run_route(cfg, ds, device, ROUTE_STEPS, SEED + 5, patch=with_cp_kernel)
    plain = run_route(cfg, ds, device, ROUTE_STEPS, SEED + 5)
    if kern[3] != counts(cp_fwd=2 * ROUTE_STEPS, cp_bwd=2 * ROUTE_STEPS) or plain[3] != counts():
        raise AssertionError(f"lego_cp routes launched {kern[3]} / {plain[3]}")
    ok, n_settled, n_all, worst = compare_params(kern, plain, cfg.train.lrate, ROUTE_STEPS)
    loss_ok = bool(np.allclose(kern[2], plain[2], rtol=CP_ROUTE_RTOL))
    # parameters() order: the position encoding's lines first, then the MLPs
    lines_err = max(float((a - b).abs().max()) for a, b in zip(kern[0][:4], plain[0][:4]))
    log(f"[routes] lego_cp {ROUTE_STEPS} steps, CP kernels vs standard route: losses "
        f"{kern[2]} vs {plain[2]} (rtol {CP_ROUTE_RTOL}: {loss_ok}); {n_settled}/{n_all} "
        f"parameters whose gradients agree within {min(0.25, 0.25 * 5e-4 / cfg.train.lrate):.4f},"
        f" worst ratio among them {worst:.3f}; the rest within {2 * ROUTE_STEPS} lr; lines max "
        f"|diff| {lines_err:.3e}: {'ok' if ok and loss_ok else 'FAIL'}")
    if not (ok and loss_ok):
        raise AssertionError("lego_cp: the CP-kernel route and the standard route disagree")

    focal = 0.5 * RES / np.tan(0.5 * CAMERA_ANGLE_X)
    K = np.array([[focal, 0, RES / 2], [0, focal, RES / 2], [0, 0, 1]], np.float32)
    pose = orbit_poses(160)[0][:3, :4]
    model = cp_model(device)
    with torch.no_grad():
        std = render_image(model, RES, RES, K, pose)
        reset_launches()
        frame = render_image(with_cp_kernel(model), RES, RES, K, pose)
        torch.cuda.synchronize()
    launches = launches_now()
    chunks = -(-RES * RES // cfg.render.ray_chunk)
    ferr = float((frame["rgb_map"] - std["rgb_map"]).abs().max())
    log(f"[routes] lego_cp {RES}x{RES} frame through the CP kernel: launches "
        f"{ {k: v for k, v in launches.items() if v} } (want {2 * chunks} cp_fwd); max |rgb - "
        f"standard route| {ferr:.3e}")
    if launches != counts(cp_fwd=2 * chunks) or not bool(torch.isfinite(frame["rgb_map"]).all()) \
            or ferr > CP_FRAME_ATOL:
        raise AssertionError("lego_cp: the frame through the CP kernel is off")
    reset_launches()
    return {"losses_kernel": kern[2], "losses_standard": plain[2], "unsettled": n_all - n_settled,
            "worst_ratio": worst, "lines_max_abs": lines_err, "launches": kern[3],
            "frame_launches": launches, "frame_max_abs": ferr}


def phase_cp_timing(ds, device):
    """The CP kernels per launch at CP_BATCHES: a call's event time and its
    kernel's device time (torch.profiler) beside their bound (bytes: 12
    bytes of position and L·C·4 of features or cotangent a point, the lines
    read once, dLines written once, over HBM_BYTES_PER_S), their plain
    versions, and CPGridEncoding.apply (with autograd for the backward);
    lego_cp's warm step on the standard route and with the kernel (mean of
    CP_TIMED_STEPS ending in a synchronize), rays/s, peak memory, busy
    share of 5 steps; a RES x RES frame on both, and the kernel route's
    frame's device time by kernel."""
    import torch
    from nerf_meets_mlx_torch.cameras.pose import orbit_poses
    from nerf_meets_mlx_torch.config import lego_cp
    from nerf_meets_mlx_torch.datasets.synthetic import CAMERA_ANGLE_X
    from nerf_meets_mlx_torch.engine import TrainState, make_nerf_train_step
    from nerf_meets_mlx_torch.kernels import cp_encode as ce
    from nerf_meets_mlx_torch.rendering import render_image

    model = cp_model(device)
    enc = model.pos_enc
    spec = ce.CPEncodeSpec.from_encoding(enc)
    flat = ce.flatten_lines(enc.lines)
    line_bytes = 4 * flat.numel()
    fwd_t, bwd_t = {}, {}
    gen = torch.Generator(device=device).manual_seed(SEED + 32)
    for name, pts in cp_point_sets(device):
        N = pts.shape[0]
        dout = torch.randn((N, spec.out_dim), generator=gen, device=device)
        n = 20 if N < 1_000_000 else 5
        io = N * (12 + 4 * spec.out_dim)
        fwd = {"ms": cuda_time_ms(lambda: ce.cp_fwd_launch(spec, flat, pts), n),
               "device_ms": kernel_split_ms(lambda: ce.cp_fwd_launch(spec, flat, pts),
                                            ("cp_fwd",), n)["cp_fwd"],
               "plain_ms": cuda_time_ms(lambda: ce.cp_fwd_reference(spec, enc.lines, pts), n),
               "bound_ms": (io + line_bytes) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
        with torch.no_grad():
            fwd["apply_ms"] = cuda_time_ms(lambda: enc.apply(pts), n)

        def apply_bwd():
            f = enc.apply(pts)
            torch.autograd.grad((f * dout).sum(), list(enc.lines))

        bwd = {"ms": cuda_time_ms(lambda: ce.cp_bwd_launch(spec, flat, pts, dout), n),
               "device_ms": kernel_split_ms(lambda: ce.cp_bwd_launch(spec, flat, pts, dout),
                                            ("cp_bwd",), n)["cp_bwd"],
               "plain_ms": cuda_time_ms(lambda: ce.cp_bwd_reference(spec, enc.lines, pts, dout),
                                        n),
               "bound_ms": (io + 2 * line_bytes) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
               "apply_fwd_bwd_ms": cuda_time_ms(apply_bwd, n)}
        log(f"[time] cp_fwd {name:12s} N={N}: {fwd['ms']:.4f} ms a call, kernel "
            f"{fwd['device_ms']:.4f} ms device (bound {fwd['bound_ms']:.4f} ms bytes; plain "
            f"{fwd['plain_ms']:.4f} ms; CPGridEncoding.apply {fwd['apply_ms']:.4f} ms) | cp_bwd "
            f"{bwd['ms']:.4f} ms a call, kernel {bwd['device_ms']:.4f} ms device (bound "
            f"{bwd['bound_ms']:.4f}; plain {bwd['plain_ms']:.4f}; apply + autograd "
            f"{bwd['apply_fwd_bwd_ms']:.4f} ms)")
        fwd_t[name], bwd_t[name] = fwd, bwd

    images = torch.as_tensor(ds.images[ds.i_train], device=device)
    poses = torch.as_tensor(ds.poses[ds.i_train, :3, :4], device=device)
    focal = 0.5 * RES / np.tan(0.5 * CAMERA_ANGLE_X)
    K = np.array([[focal, 0, RES / 2], [0, focal, RES / 2], [0, 0, 1]], np.float32)
    e2e = {}
    for key, patch in (("standard", None), ("cp_kernel", with_cp_kernel),
                       ("cp_kernel_2", with_cp_kernel), ("standard_2", None)):
        cfg = lego_cp()
        model = cp_model(device, cfg)
        if patch:
            patch(model)
        state = TrainState(model, cfg.train)
        step = make_nerf_train_step(model, ds.H, ds.W, ds.focal)
        g = torch.Generator(device=device).manual_seed(SEED + 33)
        for _ in range(3):
            step(state, images, poses, g)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(CP_TIMED_STEPS):
            step(state, images, poses, g)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / CP_TIMED_STEPS
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        times = []
        with torch.no_grad():
            for pose in orbit_poses(160)[:2]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                render_image(model, RES, RES, K, pose[:3, :4])
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        res = {"step_s": step_s, "rays_per_s": cfg.train.n_rand / step_s, "peak_gb": peak_gb,
               "frame_seconds": times}
        log(f"[time] lego_cp train step ({key}): {step_s:.5f} s/step over {CP_TIMED_STEPS} warm "
            f"steps -> {cfg.train.n_rand / step_s:.1f} rays/s, peak {peak_gb:.2f} GB; "
            f"{RES}x{RES} frames {times} s")
        if not key.endswith("_2"):

            def steps():
                for _ in range(PROFILED_STEPS):
                    step(state, images, poses, g)

            res["trace"] = profile_device(steps, f"{PROFILED_STEPS} lego_cp {key} train steps")

            def frame():
                render_image(model, RES, RES, K, orbit_poses(160)[0][:3, :4])

            res["frame_trace"] = profile_device(frame, f"one {RES}x{RES} lego_cp {key} frame")
            if patch:
                with torch.no_grad():
                    res["frame_cp_fwd_device_ms"] = kernel_split_ms(frame, ("cp_fwd",), 2)["cp_fwd"]
                log(f"[time] lego_cp {key} frame: cp_fwd {res['frame_cp_fwd_device_ms']:.4f} ms "
                    f"of device time in its {2 * -(-RES * RES // cfg.render.ray_chunk)} launches")
        e2e[key] = res
        del model, state
        torch.cuda.empty_cache()
    reset_launches()
    return fwd_t, bwd_t, e2e


def main() -> int:
    import torch

    t_start = time.perf_counter()
    name, smi = phase_device()
    if "--build" in sys.argv[1:]:
        return build_only()
    device = torch.device("cuda", 0)
    builds = phase_build()
    wait_builds(builds, ["fused_eval", "fused_train", "mlp_bwd_tc", "mlp_fwd_tc"])
    max_err = phase_compare(device)
    train_err, dw_ratio = phase_compare_train(device)
    mlp_raw_err, mlp_grad_err, mlp_grad_ratio = phase_compare_mlp(device)
    launches, res, fused = phase_main_path(device)
    train_launches, train_run = phase_train_main_path(device)
    occ_launches, occ_run = phase_train_main_path(device, preset="lego_occ")
    ds = train_scene(device)
    routes = phase_train_routes(ds, device)
    occ_routes = phase_occ_routes(ds, device)
    wait_builds(builds, ["image_fwd_tc", "image_train_tc"])
    image_err = phase_compare_image(device)
    image_launches, image_run = phase_image_path(device)
    wait_builds(builds, ["hash_encode", "ingp_eval_tc", "ingp_train_tc", "fused_ingp"])
    ingp_err = phase_compare_ingp(device)
    ingp_launches, ingp_run = phase_train_main_path(device, preset="lego_ingp")
    ingp_occ_launches, ingp_occ_run = phase_train_main_path(device, preset="lego_ingp_occ")
    ingp_routes = phase_ingp_routes(ds, device)
    # every build done before any timing: nvcc shares the host's cores
    wait_builds(builds, ["fused_feat"])
    feat_err = phase_compare_feat(device)
    feat_launches, feat_run = phase_train_main_path(
        device, preset="lego_ingp", extra=PAPER_OVERLAY, tag="lego_ingp_paper_tables")
    long_routes = phase_long_ray_routes(ds, device)
    wait_builds(builds, ["cp_encode"])
    cp_err = phase_compare_cp(device)
    cp_launches, cp_run = phase_train_main_path(device, preset="lego_cp")
    cp_routes = phase_cp_routes(ds, device)
    part_a = phase_part_a(device)
    hash_launches, hash_err, hash_t = phase_hash_api(device)
    per_level, frame = phase_timing(fused, res, device)
    train_level, train_step = phase_train_timing(ds, device)
    mlp_fwd_t, mlp_bwd_t = phase_mlp_timing(device)
    occ_time = phase_occ_timing(ds, device)
    hash_fwd_t, hash_bwd_t, ingp_eval_t, ingp_train_t = phase_ingp_kernel_timing(device)
    ingp_time = phase_ingp_e2e(ds, device)
    feat_t, image_train_t, image_fwd_t = phase_feat_image_timing(device)
    feats_time = phase_feats_e2e(ds, device)
    image_time = phase_image_timing(device)
    cp_fwd_t, cp_bwd_t, cp_time = phase_cp_timing(ds, device)

    # one entry per kernel; its times are the mean per launch over its main
    # path's mix: the coarse and the fine level equally often (eval, train,
    # the MLP and the hash backward on the value_and_grad routes, the INGP
    # kernels), the 64³ grid update for the MLP forward on lego_occ's and the
    # hash forward on lego_ingp_occ's training path
    def entry(name, source, replaces, n, err, levels):
        lv = list(levels.values())

        def mean(key):
            return sum(d[key] for d in lv) / len(lv)

        row = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": n,
            "max_abs_err": err,
            "ms": mean("ms"),
            "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"),
            "bound_by": "operations" if all(d["bound_by"] == "operations" for d in lv) else "bytes",
            "library_ms": None,
        }
        if all("device_ms" in d for d in lv):  # its kernels' device time (profiler)
            row["device_ms"] = mean("device_ms")
        return row

    kernels = [
        entry("fused_eval", "nerf_meets_mlx_torch/csrc/fused_eval.cu",
              "nerf_meets_mlx_tpu/kernels/fused_train.py:523", launches["eval"], max_err,
              per_level),
        entry("fused_train", "nerf_meets_mlx_torch/csrc/fused_train.cu",
              "nerf_meets_mlx_tpu/kernels/fused_train.py:219", train_launches["train"],
              train_err, train_level),
        entry("fused_mlp_fwd", "nerf_meets_mlx_torch/csrc/mlp_fwd_tc.cu",
              "nerf_meets_mlx_tpu/kernels/fused_mlp.py:342", occ_launches["mlp_fwd"],
              mlp_raw_err, {"grid": mlp_fwd_t["grid"]}),
        entry("fused_mlp_bwd", "nerf_meets_mlx_torch/csrc/mlp_bwd_tc.cu",
              "nerf_meets_mlx_tpu/kernels/fused_mlp.py:480",
              occ_routes["value_and_grad"]["launches"]["mlp_bwd"], mlp_grad_err, mlp_bwd_t),
        # the hash forward's paths: lego_ingp_occ's grid updates, lego_ingp's
        # value_and_grad steps, the long-ray steps and the long-ray frame;
        # its time the mean over their seven batches
        entry("hash_fwd", "nerf_meets_mlx_torch/csrc/hash_encode.cu",
              "nerf_meets_mlx_tpu/kernels/hash_encode.py:340",
              ingp_occ_launches["hash_fwd"] + ingp_routes["value_and_grad"]["launches"]["hash_fwd"]
              + long_routes["launches"]["hash_fwd"]
              + feats_time["long_rays"]["frame"]["launches"]["hash_fwd"],
              ingp_err["hash_fwd"], hash_fwd_t),
        # the hash dG kernel's two routes: lego_ingp's value_and_grad steps
        # and the long-ray feats route's steps (a coarse and a fine launch a
        # step each); its time the mean over their four batches
        entry("hash_bwd", "nerf_meets_mlx_torch/csrc/hash_encode.cu",
              "nerf_meets_mlx_tpu/kernels/hash_encode.py:376",
              ingp_routes["value_and_grad"]["launches"]["hash_bwd"]
              + long_routes["launches"]["hash_bwd"], ingp_err["hash_dg"], hash_bwd_t),
        entry("ingp_eval", "nerf_meets_mlx_torch/csrc/ingp_eval_tc.cu",
              "nerf_meets_mlx_tpu/kernels/fused_ingp_train.py:306", ingp_launches["ingp_eval"],
              ingp_err["eval"], ingp_eval_t),
        entry("ingp_train", "nerf_meets_mlx_torch/csrc/ingp_train_tc.cu",
              "nerf_meets_mlx_tpu/kernels/fused_ingp_train.py:93", ingp_launches["ingp_train"],
              ingp_err["train_val"], ingp_train_t),
        entry("feat_train", "nerf_meets_mlx_torch/csrc/ingp_train_tc.cu",
              "nerf_meets_mlx_tpu/kernels/fused_feat_train.py:308", feat_launches["feat_train"],
              feat_err[0], feat_t),
        entry("image_train", "nerf_meets_mlx_torch/csrc/image_train_tc.cu",
              "nerf_meets_mlx_tpu/kernels/fused_image.py:262", image_launches["image_train"],
              image_err[0], image_train_t),
        entry("image_fwd", "nerf_meets_mlx_torch/csrc/image_fwd_tc.cu",
              "nerf_meets_mlx_tpu/kernels/fused_image.py:304", image_launches["image_fwd"],
              image_err[2], image_fwd_t),
        # the CP kernels' path: lego_cp's train steps with the kernel behind
        # its query (a coarse and a fine launch a step)
        entry("cp_fwd", "nerf_meets_mlx_torch/csrc/cp_encode.cu",
              "nerf_meets_mlx_tpu/kernels/cp_encode.py:108", cp_routes["launches"]["cp_fwd"],
              cp_err["fwd"], {k: cp_fwd_t[k] for k in ("coarse", "fine")}),
        entry("cp_bwd", "nerf_meets_mlx_torch/csrc/cp_encode.cu",
              "nerf_meets_mlx_tpu/kernels/cp_encode.py:128", cp_routes["launches"]["cp_bwd"],
              cp_err["bwd"], {k: cp_bwd_t[k] for k in ("coarse", "fine")}),
        # the hash API's paths (compute_dx, levels_in_body=False): forward
        # and backward at a lego_ingp train step's coarse and fine points
        entry("hash_dx_fwd", "nerf_meets_mlx_torch/csrc/hash_encode.cu",
              "nerf_meets_mlx_tpu/kernels/hash_encode.py:428", hash_launches["hash_dx_fwd"],
              hash_err["dx_fwd"], {k: hash_t["dx_fwd"][k] for k in ("coarse", "fine")}),
        entry("hash_dx_bwd", "nerf_meets_mlx_torch/csrc/hash_encode.cu",
              "nerf_meets_mlx_tpu/kernels/hash_encode.py:474", hash_launches["hash_dx_bwd"],
              hash_err["dx_bwd"], {k: hash_t["dx_bwd"][k] for k in ("coarse", "fine")}),
        entry("hash_grid_fwd", "nerf_meets_mlx_torch/csrc/hash_encode.cu",
              "nerf_meets_mlx_tpu/kernels/hash_encode.py:249", hash_launches["hash_grid_fwd"],
              hash_err["grid_fwd"], {k: hash_t["grid_fwd"][k] for k in ("coarse", "fine")}),
        entry("hash_grid_bwd", "nerf_meets_mlx_torch/csrc/hash_encode.cu",
              "nerf_meets_mlx_tpu/kernels/hash_encode.py:290", hash_launches["hash_grid_bwd"],
              hash_err["grid_bwd"], {k: hash_t["grid_bwd"][k] for k in ("coarse", "fine")}),
    ]
    if len(kernels) != 17:
        raise AssertionError(f"{len(kernels)} kernels in the line, not the 17 Pallas kernels'")
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was not launched on its path")
    detail = {
        "per_level": per_level, "frame": frame, "train_per_level": train_level,
        "train_step": train_step, "train_run": train_run, "routes": routes,
        "train_dw_worst_ratio": dw_ratio,
        "mlp_forward": mlp_fwd_t, "mlp_backward": mlp_bwd_t, "mlp_grad_worst_ratio": mlp_grad_ratio,
        "occ_train_run": occ_run, "occ_launches": occ_launches, "occ_routes": occ_routes,
        "occ_timing": occ_time, "ingp_compare": ingp_err, "ingp_train_run": ingp_run,
        "ingp_launches": ingp_launches, "ingp_occ_train_run": ingp_occ_run,
        "ingp_occ_launches": ingp_occ_launches, "ingp_routes": ingp_routes,
        "hash_forward": hash_fwd_t, "hash_backward": hash_bwd_t, "ingp_eval_per_level": ingp_eval_t,
        "ingp_train_per_level": ingp_train_t, "ingp_timing": ingp_time,
        "feat_compare": {"max_abs_val": feat_err[0], "worst_grad_ratio": feat_err[1]},
        "feat_train_run": feat_run, "feat_launches": feat_launches, "long_ray_routes": long_routes,
        "feat_train_per_level": feat_t, "feats_timing": feats_time,
        "image_compare": {"sse_abs": image_err[0], "worst_dw_ratio": image_err[1],
                          "fwd_abs": image_err[2]},
        "image_run": image_run, "image_launches": image_launches,
        "image_train_per_launch": image_train_t, "image_fwd_per_launch": image_fwd_t,
        "image_timing": image_time, "cp_compare": cp_err, "cp_train_run": cp_run,
        "cp_launches": cp_launches, "cp_routes": cp_routes, "cp_fwd_per_batch": cp_fwd_t,
        "cp_bwd_per_batch": cp_bwd_t, "cp_timing": cp_time, "part_a": part_a,
        "hash_api": {"launches": hash_launches, "compare": hash_err, "times": hash_t},
        "card": smi,
    }
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "result.json").write_text(json.dumps({"kernels": kernels, **detail}, indent=1))
    log("[detail] " + json.dumps(detail))
    log(f"[main] chip_smoke.py took {time.perf_counter() - t_start:.1f} s, builds included")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
