"""The port's serving slice as a whole, against the JAX package.

``render_rays(train=False)`` on both routes (fused eval op and standard
query + raw2outputs), the full-frame renderer, the synthetic scene's ground
truth, and the ``render_only`` entry point from a checkpoint the port saved
— all on the same weights as the JAX package (via ``interop``). Tolerance
rtol 2e-4 / atol 2e-5 for rendered maps, the bound the JAX package's own
fused-vs-standard eval test uses: the fine level's samples come from the
coarse weights through the inverse CDF, which carries the coarse level's
rounding into the fine depths.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_meets_mlx_torch import interop
from nerf_meets_mlx_torch.__main__ import main as t_main
from nerf_meets_mlx_torch.config import lego_hierarchical as t_lego
from nerf_meets_mlx_torch.datasets import synthetic as tsyn
from nerf_meets_mlx_torch.engine.checkpoint import save_checkpoint
from nerf_meets_mlx_torch.entrypoints import render_only
from nerf_meets_mlx_torch.kernels import fused_train as tft
from nerf_meets_mlx_torch.models import create_nerf as t_create
from nerf_meets_mlx_torch.rendering import render_image as t_render_image
from nerf_meets_mlx_tpu.config import lego_hierarchical as j_lego
from nerf_meets_mlx_tpu.datasets import synthetic as jsyn
from nerf_meets_mlx_tpu.models import create_nerf as j_create
from nerf_meets_mlx_tpu.ops import psnr as j_psnr
from nerf_meets_mlx_tpu.rendering import render_image as j_render_image
from torch_threads import one_torch_thread_per_worker  # noqa: F401  (autouse fixture)

RTOL, ATOL = 2e-4, 2e-5


def _cfgs(**render_kw):
    out = []
    for make in (t_lego, j_lego):
        cfg = make()
        out.append(cfg.replace(render=dataclasses.replace(cfg.render, **render_kw)))
    return out


def _pair(fused, seed=0, **render_kw):
    tc, jc = _cfgs(**render_kw)
    tc = tc.replace(use_fused_kernel=fused, use_fused_train=True)
    jc = jc.replace(use_fused_kernel=fused, use_fused_train=True)
    jm = j_create(jc)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = t_create(tc, device="cpu")
    interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tm)
    return tm, jm, params


def _close(t, j, msg=""):
    np.testing.assert_allclose(
        t.detach().cpu().numpy(), np.asarray(j), rtol=RTOL, atol=ATOL, err_msg=msg
    )


def _rays(B=37, seed=2):
    rng = np.random.default_rng(seed)
    ro = (rng.normal(size=(B, 3)) * 0.1).astype(np.float32)
    rd = rng.normal(size=(B, 3)).astype(np.float32)
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True) * 1.3).astype(np.float32)
    return ro, rd


@pytest.mark.parametrize("fused", [True, False], ids=["fused_route", "standard_route"])
@pytest.mark.parametrize("n_importance", [0, 16])
def test_render_rays_eval_matches_jax(fused, n_importance):
    tm, jm, params = _pair(fused, n_samples=16, n_importance=n_importance)
    assert (tm._fused_train_mode == "sinusoidal") == fused
    assert (jm._fused_train_mode == "sinusoidal") == fused
    ro, rd = _rays()
    out_t = tm.render_rays(torch.from_numpy(ro), torch.from_numpy(rd), train=False)
    out_j = jm.render_rays(params, jnp.asarray(ro), jnp.asarray(rd), train=False)
    assert set(out_t) == set(out_j)
    for k in out_j:
        _close(out_t[k], out_j[k], k)


def test_eval_render_gradients_match_jax_on_the_standard_route():
    """d(sum of rgb_map)/d(every MLP parameter) through
    ``render_rays(train=False)`` on the standard route (both levels, 16 + 16
    samples), against ``jax.grad`` of the JAX model's eval render on the
    same weights: JAX's standard eval route keeps its gradients (only its
    fused eval op stops them). The fine MLP's gradients at this file's
    bound for rendered maps, rtol 2e-4 and atol 2e-5 scaled by the largest
    JAX gradient entry (sums over the rays of the maps' cotangents: the
    density path's arrays cancel to 1e-4 of the largest entry and keep
    the rounding of their terms); the coarse MLP's zero on both sides (the
    fine depths are sampled without gradient)."""
    tm, jm, params = _pair(False, n_samples=16, n_importance=16)
    ro, rd = _rays()
    out = tm.render_rays(torch.from_numpy(ro), torch.from_numpy(rd), train=False)
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(out["rgb_map"].sum(), list(tm.parameters()), allow_unused=True)

    def loss(p):
        return jnp.sum(jm.render_rays(p, jnp.asarray(ro), jnp.asarray(rd), train=False)["rgb_map"])

    jg = jax.grad(loss)(params)
    want = t_create(_cfgs(n_samples=16, n_importance=16)[0], device="cpu")
    interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jg), want)
    want = dict(want.named_parameters())
    assert len(grads) == len(want) > 0
    scale = max(float(w.abs().max()) for w in want.values())
    n_fine = 0
    for name, g in zip(names, grads):
        w = want[name].detach()
        if name.startswith("coarse."):
            assert g is None and not bool(w.any()), name
            continue
        n_fine += 1
        assert bool(w.any()), name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL, atol=ATOL * scale,
                                   err_msg=name)
    assert n_fine == 2 * len(tm.fine.linears())


@pytest.mark.parametrize("fused", [True, False], ids=["fused_route", "standard_route"])
def test_render_rays_eval_aabb_matches_jax(fused):
    """lego_fast's AABB slab test tightens [near, far] on both routes."""
    box = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
    tm, jm, params = _pair(fused, n_samples=16, n_importance=16, aabb=box)
    ro, rd = _rays(B=29, seed=5)
    ro = ro * 20.0  # some rays start outside the box or miss it
    out_t = tm.render_rays(torch.from_numpy(ro), torch.from_numpy(rd), train=False)
    out_j = jm.render_rays(params, jnp.asarray(ro), jnp.asarray(rd), train=False)
    for k in out_j:
        _close(out_t[k], out_j[k], k)


def test_train_mode_is_the_next_slice():
    """Training came with the slice after serving: train-mode renders are
    differentiable (render_rays on the standard route, sse of
    render_rays_train on the fused one); occupancy came with the slice after
    that: a model with the grid on renders on both routes, with a grid and
    without one."""
    tm, _, _ = _pair(True, n_samples=8, n_importance=0)
    ro, rd = (torch.from_numpy(a) for a in _rays(B=4))
    gen = torch.Generator().manual_seed(0)
    assert tm.render_rays(ro, rd, train=True, generator=gen)["rgb_map"].requires_grad
    out = tm.render_rays_train(ro, rd, torch.zeros(4, 3), generator=gen)
    assert out["sse_coarse"].requires_grad and not out["rgb_coarse"].requires_grad
    box = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
    occ, _, _ = _pair(True, n_samples=8, n_importance=0, occupancy=True, aabb=box,
                      occ_resolution=4)
    for grid in (None, torch.ones(4, 4, 4)):
        out = occ.render_rays(ro, rd, train=True, generator=gen, occ_grid=grid)
        assert out["rgb_map"].requires_grad and bool(torch.isfinite(out["rgb_map"]).all())
        out = occ.render_rays_train(ro, rd, torch.zeros(4, 3), generator=gen, occ_grid=grid)
        assert out["sse_coarse"].requires_grad


def _camera(res):
    focal = 0.5 * res / np.tan(0.5 * tsyn.CAMERA_ANGLE_X)
    K = np.array([[focal, 0, res / 2], [0, focal, res / 2], [0, 0, 1]], np.float32)
    return K, tsyn.orbit_poses(160)


def test_render_image_matches_jax():
    """8 x 8 frame, full-width hierarchical model, chunk 24: the last chunk
    is padded."""
    tm, jm, params = _pair(False)
    K, poses = _camera(8)
    c2w = poses[5][:3, :4]
    out_t = t_render_image(tm, 8, 8, K, c2w, chunk=24)
    out_j = j_render_image(jm, params, 8, 8, K, c2w, chunk=24)
    assert set(out_t) == set(out_j)
    for k in out_j:
        assert tuple(out_t[k].shape) == tuple(out_j[k].shape)
        _close(out_t[k], out_j[k], k)


@pytest.mark.parametrize("scene", ["blobs", "hard"])
def test_synthetic_ground_truth_matches_jax(scene):
    K, _ = _camera(8)
    pose = jsyn._split_poses(1, 3)[0][:3, :4]
    np.testing.assert_array_equal(tsyn._split_poses(3, 3), jsyn._split_poses(3, 3))
    gt_t = tsyn.render_gt_image(8, 8, K, pose, scene=scene, device="cpu")
    gt_j = jsyn.render_gt_image(8, 8, K, pose, scene=scene)
    assert gt_t.shape == gt_j.shape == (8, 8, 4)
    # sums of 256 (blobs) or 512 (hard) samples per pixel in another order
    np.testing.assert_allclose(gt_t, gt_j, rtol=1e-5, atol=1e-5)


def test_synthetic_scene_matches_jax():
    ds_t = tsyn.make_synthetic_scene(1, 1, 1, resolution=8, device="cpu")
    ds_j = jsyn.make_synthetic_scene(1, 1, 1, resolution=8)
    assert (ds_t.H, ds_t.W, ds_t.focal) == (ds_j.H, ds_j.W, ds_j.focal)
    np.testing.assert_array_equal(ds_t.K, ds_j.K)
    np.testing.assert_array_equal(ds_t.poses, ds_j.poses)
    np.testing.assert_array_equal(ds_t.render_poses, ds_j.render_poses)
    np.testing.assert_allclose(ds_t.images, ds_j.images, rtol=1e-5, atol=1e-5)


def _saved_model(tmp_path, seed=0):
    tm = t_create(t_lego(), device="cpu").init(torch.Generator().manual_seed(seed))
    save_checkpoint(tmp_path / "ckpt", tm, 3)
    jm = j_create(j_lego())
    params = jax.tree_util.tree_map(jnp.asarray, interop.params_to_numpy(tm))
    return jm, params


def test_render_only_orbit_matches_jax(tmp_path):
    jm, params = _saved_model(tmp_path)
    tft.LAUNCHES["eval"] = 0
    res = render_only(log_dir=str(tmp_path), device="cpu", synth_resolution=8, n_orbit=2)
    assert tft.LAUNCHES["eval"] == 0  # the CPU takes the standard route
    assert res["step"] == 3 and len(res["frame_seconds"]) == 2
    frames = np.load(res["frames"])
    assert frames.shape == (2, 8, 8, 3) and frames.dtype == np.uint8
    K, poses = _camera(8)
    for frame, pose in zip(frames, poses[:2]):
        rgb = np.asarray(j_render_image(jm, params, 8, 8, K, pose[:3, :4])["rgb_map"])
        want = (np.clip(rgb, 0.0, 1.0) * 255.0).astype(np.int16)
        # uint8 quantization: a value within atol of a level boundary may
        # round to the neighbouring level
        assert np.abs(frame.astype(np.int16) - want).max() <= 1


def test_render_only_test_views_match_jax(tmp_path):
    """16 x 16 views: render_test scores SSIM too, whose 11 x 11 window
    needs at least 11 pixels a side."""
    jm, params = _saved_model(tmp_path, seed=1)
    res = render_only(log_dir=str(tmp_path), device="cpu", synth_resolution=16, render_test=True)
    ds = jsyn.make_synthetic_scene(20, 4, 4, 16)
    want = [
        float(j_psnr(j_render_image(jm, params, 16, 16, ds.K, ds.poses[i, :3, :4])["rgb_map"],
                     jnp.asarray(ds.images[i])))
        for i in ds.i_test
    ]
    np.testing.assert_allclose(res["test_psnrs"], want, rtol=1e-4)
    assert res["test_psnr_mean"] == pytest.approx(float(np.mean(want)), rel=1e-4)


def test_render_only_ssim_matches_jax_entry_point(tmp_path, monkeypatch):
    """render_only(render_test=True) returns test_ssim_mean, as the JAX
    entry point does: both packages serve the same weights (each from its
    own checkpoint) on a tiny preset (depth 4, width 64, 8 + 8 samples,
    16 x 16 views: SSIM's 11 x 11 window needs 11 pixels)."""
    from nerf_meets_mlx_tpu.config import PRESETS as J_PRESETS
    from nerf_meets_mlx_tpu.engine.checkpoint import save_checkpoint as j_save
    from nerf_meets_mlx_tpu.engine.train_state import create_train_state
    from nerf_meets_mlx_tpu.entrypoints.render_only import render_only as j_render_only
    from nerf_meets_mlx_torch.config import PRESETS as T_PRESETS

    def tiny(make):
        cfg = make()
        mlp = dataclasses.replace(cfg.mlp, net_depth=4, net_width=64, skips=(2,))
        return cfg.replace(
            mlp=mlp, mlp_fine=mlp,
            render=dataclasses.replace(cfg.render, n_samples=8, n_importance=8),
            data=dataclasses.replace(cfg.data, dataset_type="synthetic", synth_resolution=16,
                                     synth_n_test=2),
        )

    monkeypatch.setitem(T_PRESETS, "tiny", lambda: tiny(t_lego))
    monkeypatch.setitem(J_PRESETS, "tiny", lambda: tiny(j_lego))
    jm = j_create(tiny(j_lego))
    params = jm.init(jax.random.PRNGKey(4))
    j_save(tmp_path / "jax" / "ckpt", create_train_state(params, jm.cfg.train), 2)
    tm = t_create(tiny(t_lego), device="cpu")
    interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tm)
    save_checkpoint(tmp_path / "torch" / "ckpt", tm, 2)

    want = j_render_only(preset="tiny", log_dir=str(tmp_path / "jax"), render_test=True)
    got = render_only(preset="tiny", log_dir=str(tmp_path / "torch"), device="cpu",
                      render_test=True)
    assert len(got["test_psnrs"]) == 2
    np.testing.assert_allclose(got["test_psnrs"], want["test_psnrs"], rtol=1e-4)
    assert 0.0 < got["test_ssim_mean"] <= 1.0
    assert got["test_ssim_mean"] == pytest.approx(want["test_ssim_mean"], rel=1e-4)


def test_cli_render(tmp_path, capsys):
    _saved_model(tmp_path)
    t_main(["render", "--log-dir", str(tmp_path), "--device", "cpu",
            "--synth-resolution", "8", "--n-orbit", "1", "--out-dir", str(tmp_path / "out")])
    assert "orbit_frames.npy" in capsys.readouterr().out
    assert np.load(tmp_path / "out" / "orbit_frames.npy").shape == (1, 8, 8, 3)


def test_render_only_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    _saved_model(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        render_only(log_dir=str(tmp_path), synth_resolution=8, n_orbit=1)


def _ingp_pair(fused, fused_train, seed=0, **render_kw):
    """lego_ingp in both packages with the tables cut to 4 levels of
    T = 2^9 (resolutions 4..16), on the same weights and tables."""
    from nerf_meets_mlx_torch.config import lego_ingp as t_ingp
    from nerf_meets_mlx_tpu.config import lego_ingp as j_ingp

    out = []
    for make in (t_ingp, j_ingp):
        cfg = make()
        out.append(cfg.replace(
            pos_encoding=dataclasses.replace(
                cfg.pos_encoding, hash_n_levels=4, hash_log2_table_size=9, hash_min_res=4,
                hash_max_res=16,
            ),
            render=dataclasses.replace(cfg.render, **render_kw),
            use_fused_kernel=fused, use_fused_train=fused_train,
        ))
    tc, jc = out
    jm = j_create(jc)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = t_create(tc, device="cpu")
    interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tm)
    assert tm._fused_train_mode == jm._fused_train_mode
    return tm, jm, params


@pytest.mark.parametrize(
    "fused,fused_train",
    [(True, True), (True, False), (False, True)],
    ids=["fused_ingp_route", "hash_kernel_route", "standard_route"],
)
def test_render_rays_eval_ingp_matches_jax(fused, fused_train):
    """lego_ingp's eval render (8 + 8 samples, 21 rays): on the fused route
    each level is the fused INGP eval op (JAX: the Pallas
    _ingp_eval_kernel in interpret mode), with use_fused_train off the
    query's hash encode is hash_encode_apply (JAX: the Pallas hash
    forward), else the plain encode and MLP; every map as the JAX model's."""
    tm, jm, params = _ingp_pair(fused, fused_train, n_samples=8, n_importance=8)
    assert (tm._fused_train_mode == "ingp") == (fused and fused_train)
    ro, rd = _rays(B=21, seed=7)
    ro = ro + np.float32([0.0, 0.0, 0.5])
    out_t = tm.render_rays(torch.from_numpy(ro), torch.from_numpy(rd), train=False)
    out_j = jm.render_rays(params, jnp.asarray(ro), jnp.asarray(rd), train=False)
    assert set(out_t) == set(out_j)
    for k in out_j:
        _close(out_t[k], out_j[k], k)


def _ingp_overlay(tmp_path):
    """A text overlay that keeps the INGP presets' MLPs and tables and cuts
    the samples, the batch and the scene for a CPU run."""
    p = tmp_path / "tiny.txt"
    p.write_text(
        "N_samples = 8\nN_importance = 8\nN_rand = 32\ni_print = 1\n"
        "synth_n_train = 2\ni_testset = 2\n"
    )
    return str(p)


@pytest.mark.parametrize("preset", ["lego_ingp", "lego_ingp_occ"])
def test_train_nerf_ingp_resume_then_render_only(tmp_path, preset):
    """``train_nerf`` on the CPU (the plain versions) for 2 steps, then
    again to 3, which resumes from the step-2 checkpoint (its tables and
    their Adam moments, and the grid); then ``render_only`` and the
    ``render`` CLI serve the step-3 checkpoint."""
    from nerf_meets_mlx_torch.engine.checkpoint import latest_step
    from nerf_meets_mlx_torch.entrypoints import train_nerf

    log_dir = tmp_path / "run"
    kw = dict(preset=preset, config_txt=_ingp_overlay(tmp_path), synth_resolution=12,
              precrop_iters=1, render_video=False, device="cpu", log_dir=str(log_dir))
    res = train_nerf(max_iters=2, **kw)
    assert res["step"] == 2 and np.isfinite(res["loss"])
    ck = torch.load(log_dir / "ckpt" / "step_00000002" / "state.pt", weights_only=True)
    tables = ck["params"]["pos_enc.tables"]
    assert tuple(tables.shape) == (8, 1 << 14, 2)
    moments = [s for s in ck["optimizer"]["state"].values() if s["exp_avg"].shape == tables.shape]
    assert len(moments) == 1 and float(moments[0]["exp_avg"].abs().max()) > 0.0
    assert ("occ_grid" in ck) == (preset == "lego_ingp_occ")
    res = train_nerf(max_iters=3, **kw)
    assert res["step"] == 3 and latest_step(log_dir / "ckpt") == 3
    ck3 = torch.load(log_dir / "ckpt" / "step_00000003" / "state.pt", weights_only=True)
    assert not torch.equal(ck3["params"]["pos_enc.tables"], tables)
    assert int(next(iter(ck3["optimizer"]["state"].values()))["step"]) == 3
    served = render_only(preset=preset, log_dir=str(log_dir), device="cpu", synth_resolution=12,
                         n_orbit=1)
    assert served["step"] == 3
    frames = np.load(served["frames"])
    assert frames.shape == (1, 12, 12, 3) and frames.dtype == np.uint8
    t_main(["render", "--preset", preset, "--log-dir", str(log_dir), "--device", "cpu",
            "--synth-resolution", "12", "--n-orbit", "1", "--out-dir", str(tmp_path / "cli")])
    np.testing.assert_array_equal(np.load(tmp_path / "cli" / "orbit_frames.npy"), frames)
