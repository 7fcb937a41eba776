"""The port's training slice as a whole, against the JAX package.

* Ray sampling (``sample_train_rays``), the train-mode render on both
  routes, and one whole train step (``make_nerf_train_step``: sampling,
  coarse and fine level, loss, gradients, Adam) at a small size (depth 4,
  width 64, 16 x 16 images, 32 rays), on the same weights (via ``interop``)
  and the same random draws: JAX's threefry draws are derived here from its
  keys, as ``engine/trainer.py`` and ``models/factory.py`` derive them, and
  injected into the port. Loss at rtol 5e-4, updated parameters at rtol
  5e-3 / atol 1e-4 (the JAX package's own fused-vs-standard step bounds:
  Adam divides by sqrt(v), so float-level gradient differences on
  near-zero moments show up scaled).
* Adam and the lr schedule against optax; checkpoint save/resume of the
  step, the moments and the draws' generator; SSIM against the JAX SSIM;
  ``train_nerf`` and the ``train`` CLI on the CPU, and ``render_only``
  serving what they wrote.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_meets_mlx_torch import interop
from nerf_meets_mlx_torch.__main__ import main as t_main
from nerf_meets_mlx_torch.config import lego_hierarchical as t_lego
from nerf_meets_mlx_torch.engine import checkpoint as tckpt
from nerf_meets_mlx_torch.engine import train_state as tts
from nerf_meets_mlx_torch.engine import trainer as ttr
from nerf_meets_mlx_torch.entrypoints import render_only, train_nerf
from nerf_meets_mlx_torch.models import create_nerf as t_create
from nerf_meets_mlx_torch.ops import ssim as t_ssim
from nerf_meets_mlx_tpu.config import lego_hierarchical as j_lego
from nerf_meets_mlx_tpu.engine import train_state as jts
from nerf_meets_mlx_tpu.engine import trainer as jtr
from nerf_meets_mlx_tpu.models import create_nerf as j_create
from nerf_meets_mlx_tpu.ops.metrics import ssim as j_ssim

H = W = 16
FOCAL = 15.0
N_RAND = 32
LOSS_RTOL = 5e-4
PARAM_RTOL, PARAM_ATOL = 5e-3, 1e-4


def _small(make, fused, noise, pixel_sampling="replacement", precrop=5):
    cfg = make()
    mlp = dataclasses.replace(cfg.mlp, net_depth=4, net_width=64, skips=(2,))
    return cfg.replace(
        mlp=mlp,
        mlp_fine=mlp,
        train=dataclasses.replace(
            cfg.train, n_rand=N_RAND, precrop_iters=precrop, pixel_sampling=pixel_sampling,
        ),
        render=dataclasses.replace(cfg.render, n_samples=16, n_importance=16, raw_noise_std=noise),
        use_fused_kernel=fused,
        use_fused_train=True,
    )


def _pair(fused, noise=0.0, seed=0, **kw):
    jc, tc = _small(j_lego, fused, noise, **kw), _small(t_lego, fused, noise, **kw)
    jm = j_create(jc)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = t_create(tc, device="cpu")
    interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tm)
    assert jm.supports_fused_train == tm.supports_fused_train == fused
    return jc, tc, jm, tm, params


def _scene(seed=0, n=2):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(n, H, W, 3)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32)[None, :3, :4], (n, 1, 1))
    poses[:, 2, 3] = 4.0
    poses[1, 0, 3] = 0.3
    return images, poses


def _K():
    return np.array([[FOCAL, 0, 0.5 * W], [0, FOCAL, 0.5 * H], [0, 0, 1]], np.float32)


def _jax_draws(cfg, key, step, n_images):
    """The draws of JAX's train step ``step`` from ``key``: the image, the
    pixels (or the no-replacement scores), then the render's jitter, noise
    and importance queries, keyed as trainer.py:58-90 and factory.py:577
    key them."""
    k_img, k_pix, k_render = jax.random.split(jax.random.fold_in(key, step), 3)
    d = {"img_i": jax.random.randint(k_img, (), 0, n_images)}
    if cfg.train.pixel_sampling == "no_replacement":
        d["scores"] = jax.random.uniform(k_pix, (H * W,))
    else:
        lo_hi = (0, W, 0, H)
        if cfg.train.precrop_iters > 0 and step < cfg.train.precrop_iters:
            f = cfg.train.precrop_frac
            lo_hi = (int(W * (0.5 - f / 2)), int(W * (0.5 + f / 2)),
                     int(H * (0.5 - f / 2)), int(H * (0.5 + f / 2)))
        kx, ky = jax.random.split(k_pix)
        d["px"] = jax.random.randint(kx, (N_RAND,), lo_hi[0], lo_hi[1])
        d["py"] = jax.random.randint(ky, (N_RAND,), lo_hi[2], lo_hi[3])
    d.update(_jax_render_draws(cfg, k_render, N_RAND))
    if cfg.render.occupancy:  # the grid update's cell jitter (trainer.py:163)
        k_occ = jax.random.fold_in(jax.random.fold_in(key, step), 0x0CC)
        d["occ_u"] = jax.random.uniform(k_occ, (cfg.render.occ_resolution**3, 3))
    return d, k_render


def _jax_render_draws(cfg, k_render, B):
    S, S_imp = cfg.render.n_samples, cfg.render.n_importance
    k_jitter, k_noise_c, k_imp, k_noise_f = jax.random.split(k_render, 4)
    return {
        "t": jax.random.uniform(k_jitter, (B, S), dtype=jnp.float32),
        "noise_c": jax.random.normal(k_noise_c, (B, S)),
        "u": jax.random.uniform(k_imp, (B, S_imp), dtype=jnp.float32),
        "noise_f": jax.random.normal(k_noise_f, (B, S + S_imp)),
    }


def _to_torch(d):
    out = {}
    for k, v in d.items():
        a = np.asarray(v)
        out[k] = torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i" else a.copy())
    return out


@pytest.mark.parametrize(
    "pixel_sampling,step", [("replacement", 0), ("replacement", 9), ("no_replacement", 0)]
)
def test_sample_train_rays_matches_jax(pixel_sampling, step):
    jc, tc, _, _, _ = _pair(False, pixel_sampling=pixel_sampling)
    images, poses = _scene()
    key = jax.random.PRNGKey(3)
    draws, k_render = _jax_draws(jc, key, step, len(images))
    ro_j, rd_j, tg_j, k_j = jtr.sample_train_rays(
        jc, step, jnp.asarray(images), jnp.asarray(poses), _K(), H, W, N_RAND, key
    )
    assert np.array_equal(np.asarray(k_j), np.asarray(k_render))
    ro_t, rd_t, tg_t = ttr.sample_train_rays(
        tc, step, torch.from_numpy(images), torch.from_numpy(poses),
        torch.from_numpy(_K()), H, W, N_RAND, draws=_to_torch(draws),
    )
    np.testing.assert_allclose(ro_t.numpy(), np.asarray(ro_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rd_t.numpy(), np.asarray(rd_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tg_t.numpy(), np.asarray(tg_j))


def _rays(B=N_RAND, seed=2):
    rng = np.random.default_rng(seed)
    ro = (rng.normal(size=(B, 3)) * 0.1).astype(np.float32)
    rd = rng.normal(size=(B, 3)).astype(np.float32)
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True) * 1.3).astype(np.float32)
    tg = rng.uniform(size=(B, 3)).astype(np.float32)
    return ro, rd, tg


@pytest.mark.parametrize("fused", [True, False], ids=["fused_route", "standard_route"])
def test_train_render_matches_jax(fused):
    """render_rays_train (fused) / render_rays(train=True) (standard) on
    the same draws: the coarse and fine outputs, and the coarse weights that
    feed the sampler."""
    jc, tc, jm, tm, params = _pair(fused, noise=0.5)
    ro, rd, tg = _rays()
    key = jax.random.PRNGKey(5)
    draws = _to_torch(_jax_render_draws(jc, key, N_RAND))
    args_t = [torch.from_numpy(a) for a in (ro, rd)]
    if fused:
        out_j = jm.render_rays_train(params, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tg), key)
        out_t = tm.render_rays_train(*args_t, torch.from_numpy(tg), draws=draws)
        keys = ("sse_coarse", "sse_fine", "rgb_coarse", "rgb_fine", "z_vals", "weights")
    else:
        out_j = jm.render_rays(params, jnp.asarray(ro), jnp.asarray(rd), key, train=True)
        out_t = tm.render_rays(*args_t, train=True, draws=draws)
        keys = ("rgb_coarse", "rgb_fine", "depth_fine", "acc_fine", "z_vals", "weights")
    for k in keys:
        np.testing.assert_allclose(
            out_t[k].detach().numpy(), np.asarray(out_j[k]), rtol=2e-4, atol=2e-5, err_msg=k
        )


def _grad_tree(model):
    """The parameters' ``.grad`` as the JAX pytree (numpy leaves), the hash
    tables' included."""
    tree = {}
    for level in ("coarse", "fine"):
        mlp = getattr(model, level)
        sub = {"pos_linears": []}
        for name, lin in mlp.linears():
            leaf = {"w": lin.weight.grad.t().numpy().copy(), "b": lin.bias.grad.numpy().copy()}
            if name.startswith("pos_linears."):
                sub["pos_linears"].append(leaf)
            else:
                sub[name] = leaf
        tree[level] = sub
    tables = getattr(model.pos_enc, "tables", None)
    if tables is not None:
        tree["pos_enc"] = {"tables": tables.grad.numpy().copy()}
    return tree


def _adam_mu(opt_state):
    """Adam's first moment in an optax state (plain adam, or chained with
    the encoding weight decay)."""
    if hasattr(opt_state, "mu"):
        return opt_state.mu
    for sub in opt_state:
        if isinstance(sub, tuple) or hasattr(sub, "mu"):
            mu = _adam_mu(sub)
            if mu is not None:
                return mu
    return None


@pytest.mark.parametrize("seed,key", [(0, 7), (1, 7), (0, 11)])
@pytest.mark.parametrize("noise", [0.0, 0.5], ids=["no_noise", "noise"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused_route", "standard_route"])
def test_train_step_matches_jax(fused, noise, seed, key):
    """One step of each package from the same weights and draws.

    Adam's first update is lr·g/(|g| + eps), i.e. ±lr wherever |g| ≫ eps,
    so a parameter whose gradient lies within the two packages' rounding of
    zero may step either way (the JAX package's own fused and standard
    steps differ so at some seeds). The gradients are therefore compared
    first, every element at rtol 2e-4 / atol 5e-6 (the kernel-test bounds);
    then every parameter whose two gradients agree within 25% (so its two
    Adam steps differ by at most lr/12, below atol) is held to rtol 5e-3 /
    atol 1e-4, and the rest (gradients within 5e-6 of zero, by the first
    check) to one Adam step each way."""
    jc, tc, jm, tm, params = _pair(fused, noise=noise, seed=seed)
    images, poses = _scene()
    jkey = jax.random.PRNGKey(key)
    jstate = jts.create_train_state(params, jc.train)
    jstate, aux_j = jtr.make_nerf_train_step(jm, H, W, FOCAL)(
        jstate, jnp.asarray(images), jnp.asarray(poses), jkey
    )
    draws, _ = _jax_draws(jc, jkey, 0, len(images))
    tstate = tts.TrainState(tm, tc.train)
    grads = {}
    apply = tstate.apply_gradients

    def record_then_apply():
        grads.update(_grad_tree(tm))
        apply()

    tstate.apply_gradients = record_then_apply
    aux_t = ttr.make_nerf_train_step(tm, H, W, FOCAL)(
        tstate, torch.from_numpy(images), torch.from_numpy(poses), None, _to_torch(draws)
    )
    assert tstate.step == 1 == int(jstate.step)
    assert set(aux_t) == set(aux_j)
    for k in aux_j:
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]), rtol=LOSS_RTOL, err_msg=k)

    # JAX's gradient from its first moment: mu = (1 - b1)·g after one step
    g_j = jax.tree_util.tree_map(lambda m: np.asarray(m) / (1.0 - jc.train.adam_b1),
                                 _adam_mu(jstate.opt_state))
    g_t = dict(jax.tree_util.tree_leaves_with_path(grads))
    got = dict(jax.tree_util.tree_leaves_with_path(interop.params_to_numpy(tm)))
    want = jax.tree_util.tree_leaves_with_path(jstate.params)
    assert len(got) == len(want) == len(g_t)
    lr = jc.train.lrate
    for path, leaf in want:
        msg = jax.tree_util.keystr(path)
        gj = dict(jax.tree_util.tree_leaves_with_path(g_j))[path]
        np.testing.assert_allclose(g_t[path], gj, rtol=2e-4, atol=5e-6, err_msg=msg)
        settled = np.abs(g_t[path] - gj) <= 0.25 * np.abs(gj)
        a, b = got[path], np.asarray(leaf)
        np.testing.assert_allclose(
            a[settled], b[settled], rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=msg
        )
        assert np.all(np.abs(a - b)[~settled] <= 2.0 * lr + PARAM_ATOL), msg


OCC_STEPS = 3


def _steps_match_jax(jc, tc, n_steps, grid_res=None, key=7):
    """``n_steps`` steps of both packages from the same weights and draws
    (with the grid of ``grid_res``³ when given). Losses at rtol 5e-4; the
    first step's gradients at the kernel-test bounds; the parameters after
    the last step as test_train_step_matches_jax holds them after one
    (those whose gradients agree within 25% at every step at rtol 5e-3 /
    atol 1e-4, the rest within one Adam step each way per step); the grid
    at rtol 5e-3 / atol 1e-4. Returns the port's model and train state."""
    jm = j_create(jc)
    params = jm.init(jax.random.PRNGKey(0))
    tm = t_create(tc, device="cpu")
    interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tm)
    assert jm.supports_fused_train == tm.supports_fused_train
    assert jm._fused_train_mode == tm._fused_train_mode
    images, poses = _scene()
    jkey = jax.random.PRNGKey(key)
    jstep = jtr.make_nerf_train_step(jm, H, W, FOCAL)
    if grid_res is None:
        jstate = jts.create_train_state(params, jc.train)
        tstate = tts.TrainState(tm, tc.train)
    else:
        from nerf_meets_mlx_torch.acceleration.occupancy import init_occupancy_grid as t_grid
        from nerf_meets_mlx_tpu.acceleration.occupancy import init_occupancy_grid as j_grid

        jstate = jts.create_train_state(params, jc.train, occ_grid=j_grid(grid_res))
        tstate = tts.TrainState(tm, tc.train, occ_grid=t_grid(grid_res))
    tstep = ttr.make_nerf_train_step(tm, H, W, FOCAL)
    grads_t = []
    apply = tstate.apply_gradients

    def record_then_apply():
        grads_t.append(_grad_tree(tm))
        apply()

    tstate.apply_gradients = record_then_apply
    b1 = jc.train.adam_b1
    grads_j, mu_prev = [], None
    for k in range(n_steps):
        draws, _ = _jax_draws(jc, jkey, k, len(images))
        jstate, aux_j = jstep(jstate, jnp.asarray(images), jnp.asarray(poses), jkey)
        aux_t = tstep(tstate, torch.from_numpy(images), torch.from_numpy(poses), None,
                      _to_torch(draws))
        for name in aux_j:
            np.testing.assert_allclose(float(aux_t[name]), float(aux_j[name]), rtol=LOSS_RTOL,
                                       err_msg=name)
        # this step's gradient from Adam's first moment
        mu = jax.tree_util.tree_map(np.asarray, _adam_mu(jstate.opt_state))
        grads_j.append(jax.tree_util.tree_map(
            lambda m, p: (m - b1 * p) / (1.0 - b1), mu,
            mu_prev if mu_prev is not None else jax.tree_util.tree_map(np.zeros_like, mu)))
        mu_prev = mu
    assert tstate.step == n_steps == int(jstate.step)

    if grid_res is not None:
        np.testing.assert_allclose(interop.occ_grid_to_numpy(tstate.occ_grid),
                                   np.asarray(jstate.occ_grid), rtol=PARAM_RTOL, atol=PARAM_ATOL)
        assert float(np.asarray(jstate.occ_grid).min()) > 0.0
    got = dict(jax.tree_util.tree_leaves_with_path(interop.params_to_numpy(tm)))
    lr = jc.train.lrate
    # a gradient difference of r moves an Adam step by up to ~r·lr: the 25%
    # of lego's lr 5e-4 stays below atol; at the INGP presets' lr 1e-2 the
    # settled parameters are those whose gradients agree within 1.25%
    settle = min(0.25, 0.25 * 5e-4 / lr)
    gt = [dict(jax.tree_util.tree_leaves_with_path(g)) for g in grads_t]
    gj = [dict(jax.tree_util.tree_leaves_with_path(g)) for g in grads_j]
    want = jax.tree_util.tree_leaves_with_path(jstate.params)
    assert len(want) == len(got) == len(gt[0])
    for path, leaf in want:
        msg = jax.tree_util.keystr(path)
        np.testing.assert_allclose(gt[0][path], gj[0][path], rtol=2e-4, atol=5e-6, err_msg=msg)
        settled = np.ones(leaf.shape, bool)
        for a, b in zip(gt, gj):
            settled &= np.abs(a[path] - b[path]) <= settle * np.abs(b[path])
        a, b = got[path], np.asarray(leaf)
        np.testing.assert_allclose(a[settled], b[settled], rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=msg)
        assert np.all(np.abs(a - b)[~settled] <= 2.0 * n_steps * lr + PARAM_ATOL), msg
    return tm, tstate


@pytest.mark.parametrize("fused_train", [True, False], ids=["fused_train_route", "value_and_grad_route"])
def test_lego_occ_train_steps_match_jax(fused_train):
    """Three lego_occ steps (cut to depth 4, width 64, 16 + 16 samples, an
    8³ grid updated every step and gating from step 0) from the same weights
    and draws, with use_fused_kernel on: on the fused-train route the grid
    update runs the fused MLP query (JAX: the Pallas forward in interpret
    mode), on use_fused_train=False the whole loss does (JAX: forward and
    backward kernels). Losses at rtol 5e-4; the first step's gradients at
    the kernel-test bounds; the parameters after 3 steps as
    test_train_step_matches_jax holds them after one (those whose gradients
    agree within 25% at every step at rtol 5e-3 / atol 1e-4, the rest within
    one Adam step each way per step); the grid at rtol 5e-3 / atol 1e-4."""
    from nerf_meets_mlx_torch.config import lego_occ as t_occ
    from nerf_meets_mlx_tpu.config import lego_occ as j_occ

    def cfg_of(make):
        cfg = _small(make, True, 0.0)
        return cfg.replace(
            use_fused_train=fused_train,
            render=dataclasses.replace(cfg.render, occ_resolution=8, occ_update_every=1,
                                       occ_warmup=0),
        )

    jc, tc = cfg_of(j_occ), cfg_of(t_occ)
    assert j_create(jc).supports_fused_train == fused_train
    _steps_match_jax(jc, tc, OCC_STEPS, grid_res=8)


def _ingp(make, fused_train, occ=False):
    """lego_ingp / lego_ingp_occ at the preset's MLPs, lr, Adam b2 and
    encoding weight decay, with the tables cut to 4 levels of T = 2^9
    (resolutions 4..16), 32 rays of 16 x 16 images, 8 + 8 samples, density
    noise on, use_fused_kernel on; with the grid, 8³ cells updated every
    step and gating from step 0."""
    cfg = make()
    render = dataclasses.replace(cfg.render, n_samples=8, n_importance=8, raw_noise_std=0.5)
    if occ:
        render = dataclasses.replace(render, occ_resolution=8, occ_update_every=1, occ_warmup=0)
    return cfg.replace(
        pos_encoding=dataclasses.replace(
            cfg.pos_encoding, hash_n_levels=4, hash_log2_table_size=9, hash_min_res=4,
            hash_max_res=16,
        ),
        train=dataclasses.replace(cfg.train, n_rand=N_RAND, precrop_iters=1),
        render=render,
        use_fused_kernel=True,
        use_fused_train=fused_train,
    )


@pytest.mark.parametrize("fused_train", [True, False], ids=["fused_train_route", "value_and_grad_route"])
def test_lego_ingp_train_step_matches_jax(fused_train):
    """One lego_ingp step (``_ingp``) from the same weights, tables and
    draws: on the fused route each level is the port's fused INGP op (JAX:
    the Pallas ``_ingp_train_kernel`` in interpret mode), on
    use_fused_train=False the hash encode goes through hash_encode_apply
    (JAX: the Pallas hash forward and backward) and the MLP through
    autograd. Losses, gradients and the parameters and tables after Adam
    with the encoding weight decay, as ``_steps_match_jax`` holds them."""
    from nerf_meets_mlx_torch.config import lego_ingp as t_make
    from nerf_meets_mlx_tpu.config import lego_ingp as j_make

    jc, tc = _ingp(j_make, fused_train), _ingp(t_make, fused_train)
    assert tc.train.encoding_weight_decay == 1e-4 and tc.train.lrate == 1e-2
    tm, _ = _steps_match_jax(jc, tc, 1, key=11)
    assert tm._fused_train_mode == ("ingp" if fused_train else None)


def test_lego_ingp_occ_train_steps_match_jax():
    """Three lego_ingp_occ steps (``_ingp`` with the grid) on the fused
    route: the grid update queries the hash encode through
    hash_encode_apply (JAX: the Pallas forward), the levels run the fused
    INGP op; the grid against JAX's after the last step."""
    from nerf_meets_mlx_torch.config import lego_ingp_occ as t_make
    from nerf_meets_mlx_tpu.config import lego_ingp_occ as j_make

    jc, tc = _ingp(j_make, True, occ=True), _ingp(t_make, True, occ=True)
    _, tstate = _steps_match_jax(jc, tc, OCC_STEPS, grid_res=8)
    assert float(tstate.occ_grid.max()) > 0.0


@pytest.mark.parametrize("trigger", ["paper_tables", "long_rays"])
def test_feats_train_step_matches_jax(trigger):
    """One lego_ingp step on the "feats" route, for each of its triggers
    (``_ingp`` with the Instant-NGP paper's 16 levels of 2^19 entries at 8 +
    8 samples, or its small tables at 8 + 250 samples), from the same
    weights and draws: per level the hash encode (JAX: the XLA gather, or
    the Pallas hash kernels in interpret mode) and the port's feat train op
    (JAX: the Pallas ``_feat_train_kernel`` in interpret mode). Losses,
    gradients and the parameters and tables after Adam with the encoding
    weight decay, as ``_steps_match_jax`` holds them."""
    from nerf_meets_mlx_torch.config import lego_ingp as t_make
    from nerf_meets_mlx_tpu.config import lego_ingp as j_make

    def cfg_of(make):
        cfg = _ingp(make, True)
        if trigger == "paper_tables":
            return cfg.replace(pos_encoding=dataclasses.replace(
                cfg.pos_encoding, hash_n_levels=16, hash_log2_table_size=19, hash_min_res=16,
                hash_max_res=512))
        return cfg.replace(render=dataclasses.replace(cfg.render, n_importance=250))

    jc, tc = cfg_of(j_make), cfg_of(t_make)
    tm, _ = _steps_match_jax(jc, tc, 1, key=13)
    assert tm._fused_train_mode == "feats"
    assert tm._use_hash_kernel() == (trigger == "long_rays")


def _tiny_module(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(5, 7), torch.nn.ReLU(), torch.nn.Linear(7, 3))


@pytest.mark.parametrize("lrate_decay", [1, 0])
def test_adam_and_lr_schedule_match_optax(lrate_decay):
    jcfg = dataclasses.replace(j_lego().train, lrate=1e-2, lrate_decay=lrate_decay)
    tcfg = dataclasses.replace(t_lego().train, lrate=1e-2, lrate_decay=lrate_decay)
    sched = jts.lr_schedule(jcfg)
    for count in (0, 1, 7, 1000, 12_345):
        want = float(sched(count)) if callable(sched) else sched
        # optax raises 0.1 to the float32 power count/1000
        np.testing.assert_allclose(tts.lr_at(tcfg, count), want, rtol=1e-5)
    assert tts.lr_at(tcfg, 0) == tcfg.lrate  # the first update uses lrate

    mod = _tiny_module()
    params_j = [p.detach().numpy().copy() for p in mod.parameters()]
    tx = jts.make_optimizer(jcfg)
    opt_j = tx.init(params_j)
    state = tts.TrainState(mod, tcfg)
    rng = np.random.default_rng(0)
    for k in range(3):
        grads = [rng.normal(size=p.shape).astype(np.float32) for p in params_j]
        upd, opt_j = tx.update(grads, opt_j, params_j)
        params_j = optax.apply_updates(params_j, upd)
        for p, g in zip(mod.parameters(), grads):
            p.grad = torch.from_numpy(g)
        state.apply_gradients()
        assert state.step == k + 1
        # optax forms 1 - b2**t in float32 (~1e-4 relative error at t=1),
        # torch in float64: an update may differ by ~1e-4 of lr
        for p, pj in zip(mod.parameters(), params_j):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(pj), rtol=1e-6, atol=1e-6)
    adam_j = opt_j[0]
    for i, p in enumerate(mod.parameters()):
        st = state.optimizer.state[p]
        np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(adam_j.mu[i]), rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(adam_j.nu[i]), rtol=1e-6, atol=1e-8)
        assert int(st["step"]) == int(adam_j.count) == 3


class _EncModel(torch.nn.Module):
    """A hash grid beside a linear layer: only the grid is decayed."""

    def __init__(self):
        super().__init__()
        from nerf_meets_mlx_torch.encoding.hash_grid import HashGridEncoding

        self.lin = torch.nn.Linear(3, 2)
        self.pos_enc = HashGridEncoding(n_levels=2, min_res=2, max_res=4, log2_table_size=4)


def test_encoding_weight_decay_matches_optax():
    """The port's Adam + encoding_weight_decay against the JAX package's
    optax.chain(adam, add_decayed_weights(-wd, mask=pos_enc)) over three
    updates: the decay takes wd times the values from before each update,
    not scaled by the lr, from the position encoding's tables alone."""
    jcfg = dataclasses.replace(j_lego().train, lrate=1e-2, lrate_decay=0, adam_b2=0.99,
                               encoding_weight_decay=0.05)
    tcfg = dataclasses.replace(t_lego().train, lrate=1e-2, lrate_decay=0, adam_b2=0.99,
                               encoding_weight_decay=0.05)
    mod = _EncModel()
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(torch.from_numpy(rng.normal(size=p.shape).astype(np.float32)))
    named = dict(mod.named_parameters())
    params_j = {"lin": {"bias": named["lin.bias"].detach().numpy().copy(),
                        "weight": named["lin.weight"].detach().numpy().copy()},
                "pos_enc": {"tables": named["pos_enc.tables"].detach().numpy().copy()}}
    tx = jts.make_optimizer(jcfg)
    opt_j = tx.init(params_j)
    state = tts.TrainState(mod, tcfg)
    assert state.decayed == [mod.pos_enc.tables]
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), params_j)
        grads["pos_enc"]["tables"][0, :5] = 0.0  # rows no point touched: decay alone
        upd, opt_j = tx.update(grads, opt_j, params_j)
        params_j = optax.apply_updates(params_j, upd)
        for key, g in (("lin.bias", grads["lin"]["bias"]), ("lin.weight", grads["lin"]["weight"]),
                       ("pos_enc.tables", grads["pos_enc"]["tables"])):
            named[key].grad = torch.from_numpy(g.copy())
        state.apply_gradients()
    for key, want in (("lin.bias", params_j["lin"]["bias"]),
                      ("lin.weight", params_j["lin"]["weight"]),
                      ("pos_enc.tables", params_j["pos_enc"]["tables"])):
        np.testing.assert_allclose(named[key].detach().numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6, err_msg=key)


def test_encoding_weight_decay_needs_learned_encodings():
    cfg = dataclasses.replace(t_lego().train, encoding_weight_decay=0.1)
    with pytest.raises(ValueError, match="encoding"):
        tts.TrainState(_tiny_module(), cfg)


def _trainer(tmp_path, seed=0):
    tc = _small(t_lego, True, 0.5)
    tc = tc.replace(train=dataclasses.replace(tc.train, seed=seed, i_print=1, i_weights=0))
    tm = t_create(tc, device="cpu")
    images, poses = _scene()
    step_fn = ttr.make_nerf_train_step(tm, H, W, FOCAL)
    return ttr.Trainer(
        tc, tm, step_fn, (torch.from_numpy(images), torch.from_numpy(poses)),
        log_dir=tmp_path, save_secs=0,
    )


def test_checkpoint_resume_continues_the_run(tmp_path):
    """A run saved after 2 steps and resumed by a fresh trainer (other
    seed) continues at step 2 with the same moments and draws: its third
    step equals the uninterrupted run's."""
    a = _trainer(tmp_path / "a")
    a.run(2)
    a.save()
    assert (tmp_path / "a" / "ckpt" / "step_00000002" / "state.pt").is_file()
    b = _trainer(tmp_path / "a", seed=1)
    assert b.restore() == 2 == b.step
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(pa, pb)
        sa, sb = a.state.optimizer.state[pa], b.state.optimizer.state[pb]
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[k], sb[k]), k
    ma, mb = a.run(1), b.run(1)
    assert ma == mb and a.step == b.step == 3
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(pa, pb)
    logged = [json.loads(line) for line in (tmp_path / "a" / "metrics.jsonl").open()]
    assert [r["step"] for r in logged] == [1, 2, 3, 3]


def test_restore_without_optimizer_state_raises(tmp_path):
    tm = t_create(_small(t_lego, True, 0.0), device="cpu").init(torch.Generator().manual_seed(0))
    tckpt.save_checkpoint(tmp_path, tm, 4)
    assert tckpt.restore_checkpoint(tmp_path, tm, 4) == 4
    with pytest.raises(ValueError, match="optimizer"):
        tckpt.restore_checkpoint(tmp_path, tm, 4, tts.TrainState(tm, t_lego().train).optimizer)


@pytest.mark.parametrize("same", [False, True])
def test_ssim_matches_jax(same):
    rng = np.random.default_rng(1)
    a = rng.uniform(size=(24, 20, 3)).astype(np.float32)
    b = a if same else np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1).astype(np.float32)
    got = float(t_ssim(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got, float(j_ssim(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)
    if same:
        np.testing.assert_allclose(got, 1.0, rtol=1e-6)


def _overlay(tmp_path):
    """A text overlay that keeps lego_hierarchical's MLPs and cuts the
    samples, the batch and the scene for a CPU run."""
    p = tmp_path / "tiny.txt"
    p.write_text(
        "N_samples = 8\nN_importance = 8\nN_rand = 32\ni_print = 1\n"
        "synth_n_train = 2\ni_testset = 2\n"
    )
    return str(p)


def test_train_nerf_on_cpu_then_render_only(tmp_path):
    log_dir = tmp_path / "run"
    res = train_nerf(
        config_txt=_overlay(tmp_path), max_iters=3, synth_resolution=12, precrop_iters=1,
        render_video=False, device="cpu", log_dir=str(log_dir),
    )
    assert res["step"] == 3
    for k in ("loss", "psnr", "test_psnr_mean", "test_ssim_mean"):
        assert np.isfinite(res[k]), k
    assert 0.0 < res["test_ssim_mean"] <= 1.0
    assert tckpt.latest_step(log_dir / "ckpt") == 3
    assert sorted(p.name for p in log_dir.glob("render_*.npy")) == [
        "render_00000002.npy", "render_00000003.npy"
    ]
    served = render_only(log_dir=str(log_dir), device="cpu", synth_resolution=12, n_orbit=1)
    assert served["step"] == 3
    assert np.load(served["frames"]).shape == (1, 12, 12, 3)


def test_train_cli_on_cpu(tmp_path, capsys):
    """The CLI with the options train_nerf takes beyond the preset: two
    optimizer steps per call, the per-step NaN check, a profiler trace of
    10 + 10 steps (which already pass max_iters), and the orbit frames."""
    log_dir = tmp_path / "cli"
    t_main([
        "train", "--device", "cpu", "--config-txt", _overlay(tmp_path), "--max-iters", "4",
        "--synth-resolution", "12", "--precrop-iters", "0", "--log-dir", str(log_dir),
        "--inner", "2", "--nan-check", "--profile-dir", str(tmp_path / "prof"),
    ])
    out = capsys.readouterr().out
    assert "test_ssim_mean" in out
    assert (tmp_path / "prof" / "train_trace.json").is_file()
    assert tckpt.latest_step(log_dir / "ckpt") == 20
    logged = [json.loads(x)["step"] for x in (log_dir / "metrics.jsonl").open()]
    assert logged[:3] == [2, 4, 6]
    assert np.load(log_dir / "orbit_frames.npy").shape == (160, 12, 12, 3)


def test_train_nerf_paper_tables_resume_on_cpu(tmp_path):
    """``train_nerf`` on lego_ingp with the Instant-NGP paper's tables (the
    "feats" route) through a text overlay: the checkpoint holds the [16,
    2^19, 2] tables and their Adam moments, a resumed run continues from
    them, the encoding weight decay reaches all 16.8M entries (entries no
    point touched are the init decayed once a step), and the tables cross
    ``interop`` as they are."""
    txt = tmp_path / "paper.txt"
    txt.write_text(
        "hash_n_levels = 16\nhash_log2_table_size = 19\nhash_max_res = 512\n"
        "N_samples = 8\nN_importance = 8\nN_rand = 16\ni_print = 1\nsynth_n_train = 2\n"
        "i_testset = 0\n"
    )
    log_dir = tmp_path / "run"
    kw = dict(preset="lego_ingp", config_txt=str(txt), synth_resolution=12, precrop_iters=0,
              render_video=False, device="cpu", log_dir=str(log_dir))
    res = train_nerf(max_iters=2, **kw)
    assert res["step"] == 2 and np.isfinite(res["test_psnr_mean"])
    state = torch.load(log_dir / "ckpt" / "step_00000002" / "state.pt", weights_only=True)
    tables = state["params"]["pos_enc.tables"]
    assert tuple(tables.shape) == (16, 1 << 19, 2)
    moments = [s for s in state["optimizer"]["state"].values()
               if tuple(s["exp_avg"].shape) == (16, 1 << 19, 2)]
    assert len(moments) == 1 and int(moments[0]["step"]) == 2
    untouched = moments[0]["exp_avg"] == 0
    tc = t_create(tts_cfg(txt), device="cpu").init(torch.Generator().manual_seed(0))
    init = tc.pos_enc.tables.detach()
    decayed = init.clone()
    for _ in range(2):  # TrainState's decay: p -= wd * p, after Adam's zero step
        decayed = decayed - 1e-4 * decayed
    assert int(untouched.sum()) > 16_000_000
    assert torch.equal(tables[untouched], decayed[untouched])
    res = train_nerf(max_iters=3, **kw)
    assert res["step"] == 3
    later = torch.load(log_dir / "ckpt" / "step_00000003" / "state.pt", weights_only=True)
    moved = later["params"]["pos_enc.tables"] != tables
    assert bool(moved.any()) and int((~moved).sum()) == 0  # decay moves every entry
    back = interop.params_to_numpy(tc)
    assert back["pos_enc"]["tables"].shape == (16, 1 << 19, 2)
    interop.params_from_numpy(back, t_create(tts_cfg(txt), device="cpu"))


def tts_cfg(txt):
    from nerf_meets_mlx_torch.config import config_from_text, lego_ingp

    return config_from_text(txt, lego_ingp())


def test_train_nerf_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_nerf(max_iters=1)


def test_viewer_and_sharding_are_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        train_nerf(viewer_port=8000, device="cpu")
