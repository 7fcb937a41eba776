"""Where the image train call's time goes, on one card.

    python nerf_meets_mlx_torch/tools/image_kernel_probe.py [--base <other checkout>] [--no-head]

Each checkout runs in a process of its own, with its root first on
``PYTHONPATH`` (``--base`` first, then this file's checkout unless
``--no-head``), at image2d's shapes (8 x 256 MLP with the skip after layer
4, 10 bands of 2 axes: 40 encoded features, 3 outputs; seeded init), on
pixels drawn from the 400 x 400 test image. For 4096 and 4001 pixels it
prints a ``[call]`` line of ``fused_image_train(...).backward()``:

* the device ms a call of each kernel it launches (torch.profiler over 20
  calls), the image kernels by name and the rest (the wrapper's packs and
  copies, the autograd scale by dsse) by name and count;
* the kernel launches a call the host made (the profiler's
  ``cudaLaunchKernel`` events) and the allocations it asked of PyTorch's
  caching allocator;
* the host ms of the call and of its backward (host clock, a synchronize
  before each call, none inside it), and the event ms of the two together
  (CUDA events over 20 calls);

then ``[step]``: the warm image step on the fused route (50 steps of 4096
pixels ending in one synchronize, as ``chip_smoke.py``'s
``phase_image_timing`` runs them), and the share of it that the call's
device and host time take. With ``--variants`` the head's worker then
times ``csrc/image_train_tc.cu``'s timing variants (``[variant]``, 4096
pixels, the call without its backward, each kernel's device ms; their
results are wrong): the tile kernel and the dW GEMM without their
tensor-core products, their loads or their stores, with other pipeline
depths, 512 threads a tile, 64-point dW slices, and the dW GEMM aimed at
other block counts. The card's name and power limit come
first; the last line is one JSON object with every number printed.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

HEAD = Path(__file__).resolve().parents[2]
SIZES = (4096, 4001)
CALLS = 20
STEPS = 50
# substrings of the image train kernels' names, in both designs
IMAGE_KERNELS = ("image_train", "image_tc", "dw_gemm_kernel", "image_dw", "reduce_kernel",
                 "image_reduce")
# -D sets of csrc/image_train_tc.cu's timing variants (wrong results)
VARIANTS = {
    "kernel": {},
    "tc_no_mma": {"IMAGE_TC_NO_MMA": 1},
    "tc_no_load": {"IMAGE_TC_NO_LOAD": 1},
    "tc_no_store": {"IMAGE_TC_NO_STORE": 1},
    "tc_stages_2": {"IMAGE_TC_STAGES": 2},
    "tc_stages_4": {"IMAGE_TC_STAGES": 4},
    "tc_threads_512": {"IMAGE_TC_THREADS": 512},
    "dw_no_mma": {"IMAGE_DW_NO_MMA": 1},
    "dw_no_load": {"IMAGE_DW_NO_LOAD": 1},
    "dw_no_store": {"IMAGE_DW_NO_STORE": 1},
    "dw_stages_5": {"IMAGE_DW_STAGES": 5},
    "dw_kp_64": {"IMAGE_DW_KP": 64},
    "dw_blocks_132": {"IMAGE_DW_BLOCKS": 132},
    "dw_blocks_264": {"IMAGE_DW_BLOCKS": 264},
}


def _profile(fn, n):
    """({kernel name: (device us, count)}, kernel launches) over ``n`` calls
    of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev, launches = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                continue
            us = getattr(e, "self_device_time_total", None)
            us = float(getattr(e, "self_cuda_time_total", 0.0) if us is None else us)
            t, c = dev.get(e.name, (0.0, 0))
            dev[e.name] = (t + us, c + 1)
        elif e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"):
            launches += 1
    return dev, launches


def _variants(mlp, enc, x, y) -> dict:
    """Each timing variant's kernels at these pixels (device ms a call)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from nerf_meets_mlx_torch.kernels import _build
    from nerf_meets_mlx_torch.kernels import fused_image as fim

    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        for f in [ex.submit(_build.build, fim.TRAIN_SOURCE, d) for d in VARIANTS.values()]:
            f.result()
    build = fim.train_build
    out = {}
    try:
        for name, defines in VARIANTS.items():
            fim.train_build = lambda width, d=defines: (fim.TRAIN_SOURCE, d)
            fim._PLANS.clear()

            def call():
                with torch.no_grad():
                    fim.fused_image_train(mlp, enc, x, y)

            for _ in range(3):
                call()
            dev_us, _ = _profile(call, CALLS)
            ms = {re.search(r"(image_\w+)", k).group(1): v[0] / CALLS / 1e3
                  for k, v in dev_us.items() if "image_" in k}
            out[name] = ms
            print(f"[variant] {name:22s} " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
                  + f"; sum {sum(ms.values()):.4f} ms", flush=True)
    finally:
        fim.train_build = build
        fim._PLANS.clear()
    return out


def worker(variants: bool) -> None:
    import torch

    from nerf_meets_mlx_torch.config import image2d
    from nerf_meets_mlx_torch.datasets.image import make_test_image, pixel_dataset
    from nerf_meets_mlx_torch.engine import TrainState, make_image_train_step
    from nerf_meets_mlx_torch.kernels import fused_image as fim
    from nerf_meets_mlx_torch.models import create_nerf

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    coords, colors = (torch.as_tensor(a, device=dev) for a in pixel_dataset(make_test_image(400)))
    model = create_nerf(image2d().replace(use_fused_kernel=True), device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    mlp, enc = model.coarse, model.pos_enc
    gen = torch.Generator(device=dev).manual_seed(24)
    out = {}
    for n in SIZES:
        idx = torch.randint(0, coords.shape[0], (n,), generator=gen, device=dev)
        x, y = coords[idx].contiguous(), colors[idx].contiguous()

        params = [q for _, lin in mlp.linears() for q in (lin.weight, lin.bias)]

        def call():
            for q in params:  # as the optimizer leaves them: no accumulation
                q.grad = None
            fim.fused_image_train(mlp, enc, x, y).backward()

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        dev_us, launches = _profile(call, CALLS)
        ours = {k: v[0] / CALLS / 1e3 for k, v in dev_us.items()
                if any(s in k for s in IMAGE_KERNELS) and "at::" not in k}
        rest = {k: (v[0] / CALLS / 1e3, v[1] / CALLS) for k, v in dev_us.items() if k not in ours}
        host_fwd, host_bwd = [], []
        alloc0 = torch.cuda.memory_stats(dev).get("allocation.all.allocated", 0)
        for _ in range(CALLS):
            for q in params:
                q.grad = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sse = fim.fused_image_train(mlp, enc, x, y)
            t1 = time.perf_counter()
            sse.backward()
            t2 = time.perf_counter()
            host_fwd.append((t1 - t0) * 1e3)
            host_bwd.append((t2 - t1) * 1e3)
        allocs = (torch.cuda.memory_stats(dev).get("allocation.all.allocated", 0) - alloc0) / CALLS
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(CALLS):
            call()
        b.record()
        torch.cuda.synchronize()
        row = {
            "kernels_ms": ours, "other_ms": {k: v[0] for k, v in rest.items()},
            "other_count": {k: v[1] for k, v in rest.items()},
            "device_ms": sum(ours.values()) + sum(v[0] for v in rest.values()),
            "launches": launches / CALLS, "allocations": allocs,
            "host_call_ms": sorted(host_fwd)[CALLS // 2], "host_backward_ms": sorted(host_bwd)[CALLS // 2],
            "event_ms": a.elapsed_time(b) / CALLS,
        }
        out[n] = row
        print(f"[call] N={n}: device {row['device_ms']:.4f} ms a call: "
              + ", ".join(f"{k} {v:.4f}" for k, v in ours.items())
              + f"; other {sum(v[0] for v in rest.values()):.4f} ms in "
              f"{sum(v[1] for v in rest.values()):.1f} kernels ("
              + ", ".join(f"{k[:60]} x{c:.1f} {t:.4f}" for k, (t, c) in
                          sorted(rest.items(), key=lambda kv: -kv[1][0]))
              + f"); {row['launches']:.1f} launches and {allocs:.1f} allocations a call; host "
              f"{row['host_call_ms']:.4f} ms the call, {row['host_backward_ms']:.4f} ms its "
              f"backward (medians); events {row['event_ms']:.4f} ms a call with its backward",
              flush=True)

    state = TrainState(model, model.cfg.train)
    step = make_image_train_step(model)
    for _ in range(5):
        step(state, coords, colors, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step(state, coords, colors, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / STEPS * 1e3
    dev_us, launches = _profile(lambda: step(state, coords, colors, gen), 10)
    step_dev = sum(v[0] for v in dev_us.values()) / 10 / 1e3
    c = out[4096]
    out["step"] = {"step_ms": step_ms, "step_device_ms": step_dev, "step_launches": launches / 10,
                   "call_device_share": c["device_ms"] / step_ms,
                   "call_host_share": (c["host_call_ms"] + c["host_backward_ms"]) / step_ms}
    print(f"[step] warm image step {step_ms:.4f} ms ({STEPS} steps of 4096 pixels, fused "
          f"route); device "
          f"{step_dev:.4f} ms and {launches / 10:.1f} launches a step (profiler); the call's "
          f"device time {out['step']['call_device_share']:.3f} of the step, its host time "
          f"(call + backward) {out['step']['call_host_share']:.3f}", flush=True)
    if variants:
        idx = torch.randint(0, coords.shape[0], (SIZES[0],), generator=gen, device=dev)
        out["variants"] = _variants(mlp, enc, coords[idx].contiguous(), colors[idx].contiguous())
    print(json.dumps(out), flush=True)


def _run(tag: str, root: Path, variants: bool = False) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root.resolve()))
    cmd = [sys.executable, __file__, "--worker"] + (["--variants"] if variants else [])
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(f"[{tag}] {line}", flush=True)
    if proc.returncode != 0:
        print(proc.stdout[-3000:], proc.stderr[-6000:], file=sys.stderr)
        raise RuntimeError(f"the {tag} worker failed")
    return json.loads(lines[-1])


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--base", help="the other checkout's root")
    p.add_argument("--no-head", action="store_true", help="probe the other checkout only")
    p.add_argument("--variants", action="store_true",
                   help="also time this checkout's timing variants")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    a = p.parse_args()
    if a.worker:
        worker(a.variants)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("image_kernel_probe needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[card] {torch.cuda.get_device_name(0)} | {smi}", flush=True)
    out = {"card": smi}
    if a.base:
        out["base"] = _run("base", Path(a.base))
    if not a.no_head:
        out["head"] = _run("head", HEAD, a.variants)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
