"""The port's learned occupancy grid (acceleration/occupancy.py) and the
lego_occ serving path, against the JAX package.

* Each function against its JAX counterpart on inputs made with numpy (the
  cell jitter is JAX's own ``jax.random.uniform`` draw, injected): the cell
  points and the binary grid exactly; the grid update on the fused query
  route (JAX: Pallas interpret mode) and the standard one, both compositing
  modes, at rtol 1e-5 / atol 1e-6; the tightened [near, far] exactly (the
  probe cells are computed in JAX's order of operations).
* An eval render with a grid on the fused eval route against JAX's
  ``render_rays(train=False, occ_grid=...)`` at the render tests' rtol 2e-4
  / atol 2e-5.
* ``train_nerf(preset="lego_occ")`` at a tiny size, its checkpoint's grid,
  and ``render_only`` serving it with the restored grid.
* ``gpu``-marked: the grid update through the CUDA forward kernel against
  the plain route, on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nerf_meets_mlx_torch import interop
from nerf_meets_mlx_torch.acceleration import occupancy as tocc
from nerf_meets_mlx_torch.config import PRESETS as T_PRESETS
from nerf_meets_mlx_torch.config import lego_occ as t_lego_occ
from nerf_meets_mlx_torch.kernels.fused_train import LAUNCHES
from nerf_meets_mlx_torch.models import create_nerf as t_create
from torch_threads import one_torch_thread_per_worker  # noqa: F401  (autouse fixture)

# JAX is imported by the tests that compare with it, not at module level
# (the gpu-marked test runs on the card's machine, which has no JAX).

AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)


def _small(cfg, fused, compositing="canonical", res=8):
    mlp = dataclasses.replace(cfg.mlp, net_depth=4, net_width=64, skips=(2,))
    return cfg.replace(
        mlp=mlp, mlp_fine=mlp, use_fused_kernel=fused, use_fused_train=True,
        render=dataclasses.replace(
            cfg.render, n_samples=16, n_importance=16, occ_resolution=res,
            compositing=compositing,
        ),
    )


def _pair(fused, compositing="canonical", res=8, seed=0):
    import jax

    from nerf_meets_mlx_tpu.config import lego_occ as j_lego_occ
    from nerf_meets_mlx_tpu.models import create_nerf as j_create

    jm = j_create(_small(j_lego_occ(), fused, compositing, res))
    params = jm.init(jax.random.PRNGKey(seed))
    tm = t_create(_small(t_lego_occ(), fused, compositing, res), device="cpu")
    interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tm)
    return jm, params, tm


def _random_grid(res, seed=0, frac=0.05):
    """A density grid with about ``frac`` of its cells above the 0.01
    threshold, the rest below it."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.0, 0.009, size=(res,) * 3).astype(np.float32)
    hot = rng.uniform(size=g.shape) < frac
    g[hot] = rng.uniform(0.02, 2.0, size=int(hot.sum())).astype(np.float32)
    return g


@pytest.mark.parametrize("res", [5, 8])
def test_cell_points_match_jax(res):
    import jax
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.acceleration.occupancy import _cell_points as j_cell_points

    key = jax.random.PRNGKey(res)
    lo, hi = jnp.asarray(AABB[:3]), jnp.asarray(AABB[3:])
    want = np.asarray(j_cell_points(key, res, lo, hi))
    u = torch.tensor(np.asarray(jax.random.uniform(key, (res**3, 3))))
    got = tocc._cell_points(res, torch.tensor(AABB[:3]), torch.tensor(AABB[3:]), u=u)
    assert got.shape == (res**3, 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("compositing", ["canonical", "reference"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused_query", "standard_query"])
@pytest.mark.parametrize("res", [8, 16])
def test_update_occupancy_grid_matches_jax(res, fused, compositing):
    """One EMA-max update from a random grid with JAX's jitter injected; the
    fused route runs the port's fused_mlp query (its plain version here)
    against JAX's Pallas forward in interpret mode."""
    import jax
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.acceleration.occupancy import update_occupancy_grid as j_update

    jm, params, tm = _pair(fused, compositing, res)
    grid = _random_grid(res, seed=res)
    key = jax.random.PRNGKey(11)
    want = j_update(jm, params, jnp.asarray(grid), key, decay=0.9)
    u = torch.tensor(np.asarray(jax.random.uniform(key, (res**3, 3))))
    got = tocc.update_occupancy_grid(tm, interop.occ_grid_from_numpy(grid), 0.9, u=u)
    assert got.shape == (res,) * 3
    np.testing.assert_allclose(interop.occ_grid_to_numpy(got), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_occupancy_binary_matches_jax():
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.acceleration.occupancy import occupancy_binary as j_binary

    g = _random_grid(12, seed=3, frac=0.02)
    g[0, 0, 0] = g[11, 11, 11] = g[0, 11, 5] = 1.0  # corners and faces dilate inward
    want = np.asarray(j_binary(jnp.asarray(g), 0.01))
    got = tocc.occupancy_binary(torch.from_numpy(g), 0.01).numpy()
    np.testing.assert_array_equal(got, want)


def _probe_rays(B=200, seed=4):
    rng = np.random.default_rng(seed)
    ro = (rng.normal(size=(B, 3)) * 1.5).astype(np.float32)
    ro[:, 2] += 3.5  # most rays start outside the box and cross it
    rd = rng.normal(size=(B, 3)).astype(np.float32)
    rd[:, 2] = -np.abs(rd[:, 2]) - 0.5
    rd[: B // 8] *= -1.0  # these point away and miss the box
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True) * 1.3).astype(np.float32)
    near = rng.uniform(0.0, 2.0, size=(B, 1)).astype(np.float32)
    far = near + rng.uniform(2.0, 6.0, size=(B, 1)).astype(np.float32)
    return ro, rd, near, far


@pytest.mark.parametrize("active", [True, False])
def test_tighten_near_far_matches_jax(active):
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.acceleration.occupancy import tighten_near_far as j_tighten

    g = _random_grid(16, seed=5, frac=0.1)
    ro, rd, near, far = _probe_rays()
    args = (AABB, 0.01, 64)
    n_j, f_j = j_tighten(jnp.asarray(g), *(jnp.asarray(a) for a in (ro, rd, near, far)), *args,
                         active=active)
    n_t, f_t = tocc.tighten_near_far(torch.from_numpy(g), *(torch.from_numpy(a) for a in
                                                          (ro, rd, near, far)), *args,
                                     active=active)
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    changed = (n_t.numpy() != near) | (f_t.numpy() != far)
    if active:
        assert 0 < changed.sum() < len(near)  # some rays tightened, the misses kept
    else:
        assert not changed.any()


def test_eval_render_with_grid_matches_jax():
    """The fused eval route with a grid tightening the coarse samples."""
    import jax.numpy as jnp

    jm, params, tm = _pair(True, res=16)
    assert jm._fused_train_mode == tm._fused_train_mode == "sinusoidal"
    g = _random_grid(16, seed=6, frac=0.003)  # ~8% occupied after the dilation
    ro, rd, _, _ = _probe_rays(B=37, seed=7)
    out_j = jm.render_rays(params, jnp.asarray(ro), jnp.asarray(rd), train=False,
                           occ_grid=jnp.asarray(g))
    out_t = tm.render_rays(torch.from_numpy(ro), torch.from_numpy(rd), train=False,
                           occ_grid=interop.occ_grid_from_numpy(g))
    plain = tm.render_rays(torch.from_numpy(ro), torch.from_numpy(rd), train=False)
    assert set(out_t) == set(out_j)
    for k in out_j:
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]), rtol=2e-4,
                                   atol=2e-5, err_msg=k)
    assert not torch.equal(out_t["z_vals"], plain["z_vals"])  # the grid tightened


def test_sharded_update_waits_for_the_parallel_slice():
    tm = t_create(_small(t_lego_occ(), False), device="cpu").init(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="parallel"):
        tocc.update_occupancy_grid(tm, tocc.init_occupancy_grid(8), mesh=object())


def _tiny_lego_occ():
    cfg = _small(t_lego_occ(), False)
    return cfg.replace(
        render=dataclasses.replace(cfg.render, n_samples=8, n_importance=8, occ_update_every=2,
                                   occ_warmup=0),
        train=dataclasses.replace(cfg.train, n_rand=32, i_print=1, i_testset=2),
        data=dataclasses.replace(cfg.data, synth_n_train=2, synth_n_test=2),
    )


def test_train_then_serve_with_the_grid(tmp_path, monkeypatch):
    """lego_occ (cut to depth 4, width 64, an 8³ grid updated every 2 steps)
    trains 3 steps on the CPU; its checkpoint holds the grid the trainer
    kept, and render_only restores it and renders with it."""
    from nerf_meets_mlx_torch.engine.checkpoint import restore_checkpoint
    from nerf_meets_mlx_torch.entrypoints import render_only, train_nerf
    from nerf_meets_mlx_torch.rendering import render_image
    from nerf_meets_mlx_torch.rendering.renderer import to8b

    monkeypatch.setitem(T_PRESETS, "lego_occ", _tiny_lego_occ)
    log_dir = tmp_path / "run"
    res = train_nerf(preset="lego_occ", max_iters=3, synth_resolution=12, precrop_iters=1,
                     render_video=False, device="cpu", log_dir=str(log_dir))
    assert res["step"] == 3 and np.isfinite(res["loss"]) and np.isfinite(res["test_ssim_mean"])
    state = torch.load(log_dir / "ckpt" / "step_00000003" / "state.pt", weights_only=True)
    grid = state["occ_grid"]
    assert grid.shape == (8, 8, 8) and float(grid.min()) > 0.0  # softplus: every cell set

    served = render_only(preset="lego_occ", log_dir=str(log_dir), device="cpu",
                         synth_resolution=12, n_orbit=1)
    assert served["step"] == 3
    frames = np.load(served["frames"])
    model = t_create(_tiny_lego_occ(), device="cpu")
    occ = tocc.init_occupancy_grid(8)
    restore_checkpoint(log_dir / "ckpt", model, 3, occ_grid=occ)
    assert torch.equal(occ, grid)
    from nerf_meets_mlx_torch.datasets.synthetic import make_synthetic_scene

    ds = make_synthetic_scene(2, 1, 2, 12, device="cpu")
    want = to8b(render_image(model, 12, 12, ds.K, ds.render_poses[0][:3, :4],
                             occ_grid=occ)["rgb_map"])
    np.testing.assert_array_equal(frames[0], want)


def test_restoring_a_checkpoint_without_a_grid_raises(tmp_path):
    from nerf_meets_mlx_torch.engine.checkpoint import restore_checkpoint, save_checkpoint

    tm = t_create(_tiny_lego_occ(), device="cpu").init(torch.Generator().manual_seed(0))
    save_checkpoint(tmp_path, tm, 1)
    assert restore_checkpoint(tmp_path, tm, 1) == 1  # occupancy off: no grid wanted
    with pytest.raises(ValueError, match="occupancy grid"):
        restore_checkpoint(tmp_path, tm, 1, occ_grid=tocc.init_occupancy_grid(8))


@pytest.mark.gpu
def test_cuda_grid_update_matches_plain_route():
    """lego_occ at full width: one 64³ update through the fused MLP forward
    kernel (one launch) against the same update on the plain route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = t_lego_occ()
    fused = t_create(cfg.replace(use_fused_kernel=True), device=dev).init(
        torch.Generator().manual_seed(0))
    plain = t_create(cfg, device=dev).init(torch.Generator().manual_seed(0))
    res = cfg.render.occ_resolution
    u = torch.rand((res**3, 3), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    grid = tocc.init_occupancy_grid(res, device=dev)
    LAUNCHES["mlp_fwd"] = 0
    got = tocc.update_occupancy_grid(fused, grid, u=u)
    torch.cuda.synchronize()
    assert LAUNCHES["mlp_fwd"] == 1
    want = tocc.update_occupancy_grid(plain, grid, u=u)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
