"""CLI shell: ``python -m nerf_meets_mlx_torch <command> [args]``.

Counterpart of ``nerf_meets_mlx_tpu/__main__.py``: the ``train``, ``render``
and ``image`` commands, each with ``--device``.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(prog="nerf_meets_mlx_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    from nerf_meets_mlx_torch.config import PRESETS

    dev_help = "torch device (default: cuda; 'cpu' runs the plain path)"
    t = sub.add_parser("train", help="train a NeRF (volume learning)")
    t.add_argument("--preset", default="lego_hierarchical", choices=sorted(PRESETS))
    t.add_argument("--data-dir", default=None, help="Blender scene dir; omit for the procedural synthetic scene")
    t.add_argument("--config-txt", default=None, help="reference-format key = value config overlay")
    t.add_argument("--max-iters", type=int, default=None)
    t.add_argument("--log-dir", default=None)
    t.add_argument("--no-resume", action="store_true")
    t.add_argument("--no-video", action="store_true")
    t.add_argument("--nan-check", action="store_true", help="raise at the first non-finite loss")
    t.add_argument("--profile-dir", default=None, help="write a torch.profiler trace here")
    t.add_argument("--synth-resolution", type=int, default=None, help="procedural scene resolution (synthetic dataset only)")
    t.add_argument("--synth-scene", default=None, choices=("blobs", "hard"), help="procedural scene: smooth blobs or the hard CSG benchmark scene")
    t.add_argument("--no-shard", action="store_true", help="train on one device even with several visible")
    t.add_argument("--inner", type=int, default=1, help="optimizer steps per step call (cadences quantize to it)")
    t.add_argument("--precrop-iters", type=int, default=None, help="override the preset's central-crop warmup length")
    t.add_argument("--viewer-port", type=int, default=None, help="serve the live web viewer on this port")
    t.add_argument("--llff-factor", type=int, default=None, help="LLFF image downsample factor (llff preset)")
    t.add_argument("--spherify", action="store_true", help="LLFF 360 capture: spherical re-framing instead of NDC")
    t.add_argument("--shape", default=None, help="DeepVoxels object: armchair / cube / greek / vase")
    t.add_argument("--device", default=None, help=dev_help)

    r = sub.add_parser("render", help="render from a checkpoint (orbit frames or test views)")
    r.add_argument("--preset", default="lego_hierarchical", choices=sorted(PRESETS))
    r.add_argument("--log-dir", required=True, help="experiment dir containing ckpt/")
    r.add_argument("--data-dir", default=None)
    r.add_argument("--render-test", action="store_true", help="render + score held-out test views")
    r.add_argument("--out-dir", default=None)
    r.add_argument("--n-orbit", type=int, default=160)
    r.add_argument("--spherify", action="store_true", help="LLFF 360 capture: spherical re-framing instead of NDC")
    r.add_argument("--shape", default=None, help="DeepVoxels object: armchair / cube / greek / vase")
    r.add_argument("--device", default=None, help=dev_help)
    r.add_argument("--synth-resolution", type=int, default=None, help="procedural scene resolution (synthetic dataset only)")

    i = sub.add_parser("image", help="2-D image learning")
    i.add_argument("--image-path", default=None)
    i.add_argument("--size", type=int, default=400)
    i.add_argument("--max-iters", type=int, default=1000)
    i.add_argument("--log-dir", default=None)
    i.add_argument("--viewer-port", type=int, default=None, help="serve the live web viewer on this port")
    i.add_argument("--device", default=None, help=dev_help)

    args = p.parse_args(argv)
    if args.cmd == "image":
        from nerf_meets_mlx_torch.entrypoints import image_learning

        out = image_learning(
            image_path=args.image_path,
            size=args.size,
            max_iters=args.max_iters,
            log_dir=args.log_dir,
            viewer_port=args.viewer_port,
            device=args.device,
        )
    elif args.cmd == "train":
        from nerf_meets_mlx_torch.entrypoints import train_nerf

        out = train_nerf(
            preset=args.preset,
            data_dir=args.data_dir,
            config_txt=args.config_txt,
            max_iters=args.max_iters,
            log_dir=args.log_dir,
            resume=not args.no_resume,
            render_video=not args.no_video,
            nan_check=args.nan_check,
            profile_dir=args.profile_dir,
            synth_resolution=args.synth_resolution,
            synth_scene=args.synth_scene,
            precrop_iters=args.precrop_iters,
            viewer_port=args.viewer_port,
            llff_factor=args.llff_factor,
            spherify=args.spherify,
            shard=not args.no_shard,
            dv_shape=args.shape,
            inner=args.inner,
            device=args.device,
        )
    else:
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
