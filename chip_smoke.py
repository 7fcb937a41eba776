#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``nerf_meets_mlx_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: needs CUDA; prints the card's name and ``nvidia-smi`` power
   limit; turns TF32 off so fp32 matmuls of the plain versions are fp32.
2. build: compiles every CUDA source of the main path from the checkout
   (one ``nvcc`` per source, all started together) and prints the ptxas
   report (registers, shared memory, spills).
3. kernels vs plain: each kernel against its plain PyTorch version at the
   main path's shapes (full-width lego_hierarchical weights from a seeded
   init, 4096 rays, S = 64 and 192, both compositing modes).
4. main path: saves a seeded checkpoint and calls the serving entry point
   ``render_only(preset="lego_hierarchical", synth_resolution=400,
   n_orbit=2)`` with every launch count at 0; checks the counts, the frames,
   and the first chunk of frame 0 against the plain (standard) route.
5. timing: each kernel per level at the full ray chunk (32768 rays) with
   CUDA events, beside its bound and its plain version's time; the frame
   time and rays/s of the render.

It prints the kernels' JSON line, the ``nvidia-smi`` line, and as its last
line ``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

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

ATOL = 1e-4   # kernel vs plain: fp32 sums in another order (see PERF.md)
RTOL = 1e-4
SEED = 0
RES = 400             # frame H = W of the main path (lego half-res)
N_ORBIT = 2           # frames the main path renders
COMPARE_RAYS = 4096   # rays of the kernel-vs-plain comparison


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


def profile_frame(render):
    """Device time by kernel name over one frame (torch.profiler), and the
    device's busy share of the frame's wall time under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies): an ATen op's entry
        # repeats the device time of the kernels it launched
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((e.key, float(us), int(e.count)))
    rows.sort(key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    if busy_us == 0:
        log("[trace] the profiler recorded no device time: busy share not measured")
        return {"wall_ms": wall_us / 1e3, "device_busy_share": None, "top": []}
    log(f"[trace] one {RES}x{RES} frame under torch.profiler: wall {wall_us / 1e3:.1f} ms, "
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


def phase_build():
    from nerf_meets_mlx_torch.kernels import _build

    sources = ["fused_eval"]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as ex:
        paths = list(ex.map(_build.build, sources))
    log(f"[build] {len(sources)} source(s) in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(p.name for p in paths))
    for name in sources:
        for line in _build.BUILD_LOG.get(name, "(cached build)").splitlines():
            if any(k in line for k in ("registers", "spill", "smem", "Compiling entry")):
                log(f"[build] {name}: {line.strip()}")
        _build.load_library(name)


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

    ft.LAUNCHES["eval"] = 0
    torch.cuda.reset_peak_memory_stats()
    res = render_only(
        preset="lego_hierarchical", log_dir=str(log_dir),
        synth_resolution=res_px, n_orbit=n_orbit, device=device,
    )
    launches = {"eval": ft.LAUNCHES["eval"]}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    chunks = -(-res_px * res_px // cfg.render.ray_chunk)
    want = 2 * chunks * n_orbit
    log(f"[main] render_only -> {res['frames']}; launches {launches} (want eval={want}); "
        f"frame seconds {res['frame_seconds']}; peak device memory {peak_gb:.2f} GB")
    if launches["eval"] != want:
        raise AssertionError(f"fused_eval launched {launches['eval']} times, want {want}")
    frames = np.load(res["frames"])
    if frames.shape != (n_orbit, res_px, res_px, 3) or frames.dtype != np.uint8:
        raise AssertionError(f"frames {frames.shape} {frames.dtype}")

    # first chunk of frame 0: fused route vs the plain (standard) route
    fused = make_model(cfg.replace(use_fused_kernel=True), device)
    plain = make_model(cfg, device)
    ro, rd, vd = frame_rays(res_px, res_px, device)
    c = cfg.render.ray_chunk
    ro, rd, vd = ro[:c], rd[:c], vd[:c]
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
        bound_ms = max(flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
        per_level[name] = dict(
            rays=R, samples=S, ms=(k_ms + k_ms2) / 2, ms_runs=[k_ms, k_ms2], plain_ms=p_ms,
            bound_ms=bound_ms, bound_by="operations" if flops / FP32_FLOPS > nbytes / HBM_BYTES_PER_S else "bytes",
            tf32_bound_ms=flops / TF32_FLOPS * 1e3, tflops=flops / 1e12,
            achieved_tflops_s=flops / (k_ms * 1e-3) / 1e12 if k_ms > 0 else None,
        )
        log(f"[time] fused_eval {name:6s} R={R} S={S}: kernel {k_ms:.3f} / {k_ms2:.3f} ms, "
            f"plain {p_ms:.3f} ms, fp32 bound {bound_ms:.3f} ms "
            f"({per_level[name]['bound_by']}), TF32 bound {flops / TF32_FLOPS * 1e3:.3f} ms, "
            f"{flops / 1e12:.3f} TFLOP -> {per_level[name]['achieved_tflops_s']:.2f} TFLOP/s")

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
    trace = profile_frame(lambda: render_image(fused, RES, RES, K, orbit_poses(160)[0][:3, :4]))
    ft.LAUNCHES["eval"] = 0
    log(f"[time] render_image {RES}x{RES} lego_hierarchical: frames {times} s -> "
        f"{frame_s:.4f} s/frame, {RES * RES / frame_s:.1f} rays/s; "
        f"render_only frame seconds {res['frame_seconds']}")
    return per_level, {"frame_seconds": times, "rays_per_s": RES * RES / frame_s, "trace": trace}


def main() -> int:
    import torch

    name, smi = phase_device()
    device = torch.device("cuda", 0)
    phase_build()
    max_err = phase_compare(device)
    launches, res, fused = phase_main_path(device)
    per_level, frame = phase_timing(fused, res, device)

    # one entry per kernel; its times are the mean per launch over the main
    # path's mix, which runs the coarse and the fine level equally often
    lv = list(per_level.values())

    def mean(key):
        return sum(d[key] for d in lv) / len(lv)

    kernels = [{
        "name": "fused_eval",
        "route": "cuda",
        "source": "nerf_meets_mlx_torch/csrc/fused_eval.cu",
        "replaces": "nerf_meets_mlx_tpu/kernels/fused_train.py:523",
        "launches": launches["eval"],
        "max_abs_err": max_err,
        "ms": mean("ms"),
        "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"),
        "bound_by": "operations" if all(d["bound_by"] == "operations" for d in lv) else "bytes",
        "library_ms": None,
    }]
    detail = {"per_level": per_level, "frame": frame, "card": smi}
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "result.json").write_text(json.dumps({"kernels": kernels, **detail}, indent=1))
    log("[detail] " + json.dumps(detail))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
