"""CLI shell: ``python -m nerf_meets_mlx_torch <command> [args]``.

Counterpart of ``nerf_meets_mlx_tpu/__main__.py``. This slice of the port
has the ``render`` command; ``train`` and ``image`` come with later slices.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(prog="nerf_meets_mlx_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    from nerf_meets_mlx_torch.config import PRESETS

    r = sub.add_parser("render", help="render from a checkpoint (orbit frames or test views)")
    r.add_argument("--preset", default="lego_hierarchical", choices=sorted(PRESETS))
    r.add_argument("--log-dir", required=True, help="experiment dir containing ckpt/")
    r.add_argument("--data-dir", default=None)
    r.add_argument("--render-test", action="store_true", help="render + score held-out test views")
    r.add_argument("--out-dir", default=None)
    r.add_argument("--n-orbit", type=int, default=160)
    r.add_argument("--spherify", action="store_true", help="LLFF 360 capture: spherical re-framing instead of NDC")
    r.add_argument("--shape", default=None, help="DeepVoxels object: armchair / cube / greek / vase")
    r.add_argument("--device", default=None, help="torch device (default: cuda; 'cpu' runs the plain path)")
    r.add_argument("--synth-resolution", type=int, default=None, help="procedural scene resolution (synthetic dataset only)")

    args = p.parse_args(argv)
    from nerf_meets_mlx_torch.entrypoints import render_only

    out = render_only(
        preset=args.preset,
        log_dir=args.log_dir,
        data_dir=args.data_dir,
        render_test=args.render_test,
        out_dir=args.out_dir,
        n_orbit=args.n_orbit,
        spherify=args.spherify,
        dv_shape=args.shape,
        device=args.device,
        synth_resolution=args.synth_resolution,
    )
    print(out)


if __name__ == "__main__":
    main()
