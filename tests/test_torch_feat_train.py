"""The port's fused feat train op (kernels/fused_feat_train.py,
csrc/fused_feat.cu) and the "feats" train route of ``render_rays_train``.

* The plain op against the JAX ``fused_feat_train_apply``, which runs the
  Pallas ``_feat_train_kernel`` in interpret mode here, on the same weights
  (via ``interop``) and inputs made with numpy, at the JAX package's own
  bounds (tests/test_fused_feat_train.py): sse at rtol 1e-5, rgb and
  weights at rtol 1e-5 / atol 1e-6, every dW and d(feats) at rtol 3e-4 /
  atol 5e-6. Both compositing modes, the white background on and off, a
  ragged ray count, and sample counts that are not a multiple of the JAX
  block's or of the CUDA kernel's 32-sample scan chunk.
* The feats route of ``render_rays_train`` against the JAX model's, with
  the JAX draws injected, for both of its triggers: tables past the INGP
  kernel's budget (the Instant-NGP paper's 16 levels of 2^19 entries, the
  plain gather) and more than 256 samples a ray (the hash kernels' route):
  sse, rgb and weights at rtol 2e-4 / atol 2e-5, the gradients of the MLPs
  and the tables at rtol 3e-4 / atol 5e-6.
* The wrapper's routing and shape guards.
* ``gpu``-marked: the CUDA kernel against the plain version on the card
  (skipped where no card is present).
"""

import dataclasses

import numpy as np
import pytest
import torch

from nerf_meets_mlx_torch import interop
from nerf_meets_mlx_torch.config import MLPConfig
from nerf_meets_mlx_torch.config import lego_ingp as t_ingp
from nerf_meets_mlx_torch.kernels import fused_feat_train as tff
from nerf_meets_mlx_torch.kernels.fused_train import LAUNCHES, TrainSpec
from nerf_meets_mlx_torch.models import NeRFMLP
from nerf_meets_mlx_torch.models import create_nerf as t_create
from torch_threads import one_torch_thread_per_worker  # noqa: F401  (autouse fixture)

# JAX is imported by the tests that compare with it, not at module level:
# the gpu-marked tests run on the card's machine, which has no JAX
# (python -m pytest --noconftest -m gpu tests/test_torch_feat_train.py).

D_SH = 25


def _inputs(R, S, P, seed=0, noise=0.01):
    rng = np.random.default_rng(seed)
    feats = (rng.normal(size=(R, S, P)) * 0.5).astype(np.float32)
    sh = (rng.normal(size=(R, D_SH)) * 0.5).astype(np.float32)
    deltas = rng.uniform(0.01, 0.1, size=(R, S)).astype(np.float32)
    deltas[:, -1] = 1e10
    nz = (rng.normal(size=(R, S)) * noise).astype(np.float32)
    target = rng.uniform(size=(R, 3)).astype(np.float32)
    return feats, sh, deltas, nz, target


def _mlps(P, seed=0, depth=2, width=64):
    """JAX (spec, params) and the port's NeRFMLP on the same weights: width
    64 (or ``width``), the view head, no skips (the hash presets' MLP)."""
    import jax

    from nerf_meets_mlx_tpu.config import MLPConfig as JMLPConfig
    from nerf_meets_mlx_tpu.kernels.fused_feat_train import FeatMLPSpec
    from nerf_meets_mlx_tpu.models.nerf_mlp import init_nerf_mlp

    cfg = JMLPConfig(net_depth=depth, net_width=width, skips=(), use_viewdirs=True)
    params = init_nerf_mlp(jax.random.PRNGKey(seed), cfg, P, D_SH)
    tmlp = NeRFMLP(MLPConfig(**dataclasses.asdict(cfg)), P, D_SH)
    interop._mlp_from_numpy(jax.tree_util.tree_map(np.asarray, params), tmlp)
    return FeatMLPSpec.from_configs(cfg, P, D_SH), params, tmlp


def _grad_tree(mlp):
    out = {"pos_linears": []}
    for name, lin in mlp.linears():
        leaf = {"w": lin.weight.grad.t().numpy(), "b": lin.bias.grad.numpy()}
        if name.startswith("pos_linears."):
            out["pos_linears"].append(leaf)
        else:
            out[name] = leaf
    return out


@pytest.mark.parametrize(
    "mode,act,white,R,S,P",
    [
        ("canonical", "softplus", True, 10, 16, 16),
        ("canonical", "relu", False, 7, 13, 32),
        ("reference", "softplus", False, 5, 40, 16),
        ("reference", "softplus", True, 3, 70, 32),
    ],
)
def test_feat_train_op_matches_jax(mode, act, white, R, S, P):
    _check_feat_op_against_jax(mode, act, white, R, S, P, 64)


@pytest.mark.parametrize(
    "mode,act,white,R,S,P,W",
    [
        # the shapes the overlay keys reach: width 32, 64 channels (16
        # levels of 4 features), a count that fills no register width
        ("canonical", "softplus", True, 6, 24, 16, 32),
        ("canonical", "softplus", False, 4, 20, 64, 64),
        ("reference", "softplus", True, 5, 12, 24, 32),
        # the runtime-shape build: widths past 64 or odd multiples of 16,
        # and up to 128 channels (32 levels of 4 features)
        ("canonical", "softplus", True, 4, 12, 32, 128),
        ("reference", "softplus", False, 3, 10, 16, 48),
        ("canonical", "softplus", True, 3, 10, 128, 64),
        ("canonical", "relu", True, 3, 8, 64, 96),
    ],
)
def test_feat_train_op_matches_jax_at_new_shapes(mode, act, white, R, S, P, W):
    _check_feat_op_against_jax(mode, act, white, R, S, P, W)


def _check_feat_op_against_jax(mode, act, white, R, S, P, W):
    import jax
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.kernels.fused_feat_train import (
        fused_feat_train_apply as j_apply,
        pack_feat_inputs as j_pack,
        pack_feat_params,
    )
    from nerf_meets_mlx_tpu.kernels.fused_train import TrainSpec as JSpec

    spec, params, tmlp = _mlps(P, width=W)
    feats, sh, deltas, nz, target = _inputs(R, S, P)
    kw = dict(n_samples=S, rays_block=4, mode=mode, density_activation=act, white_bkgd=white)

    def loss(p, f):
        x = j_pack(f, jnp.asarray(sh), jnp.asarray(deltas), jnp.asarray(nz))
        sse, rgb, wts = j_apply(spec, JSpec(n_rays=R, **kw), pack_feat_params(spec, p), x,
                                jnp.asarray(target))
        return sse, (rgb, wts)

    (sse_j, (rgb_j, w_j)), (g_p, g_f) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True
    )(params, jnp.asarray(feats))

    f_t = torch.from_numpy(feats).requires_grad_(True)
    x = tff.pack_feat_inputs(f_t, *(torch.from_numpy(a) for a in (sh, deltas, nz)))
    assert tuple(x.shape) == (R * S, P + D_SH + 2)
    LAUNCHES["feat_train"] = 0
    sse, rgb, w = tff.fused_feat_train_apply(tmlp, TrainSpec(**kw), x, torch.from_numpy(target))
    sse.backward()
    assert LAUNCHES["feat_train"] == 0  # the CPU runs the plain version
    assert not rgb.requires_grad and not w.requires_grad
    np.testing.assert_allclose(float(sse.detach()), float(sse_j), rtol=1e-5)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=1e-5, atol=1e-6)
    got = jax.tree_util.tree_leaves(_grad_tree(tmlp))
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, g_p))
    assert len(got) == len(want) == 12
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=3e-4, atol=5e-6)
    assert np.count_nonzero(np.asarray(g_f)) > 0
    np.testing.assert_allclose(f_t.grad.numpy(), np.asarray(g_f), rtol=3e-4, atol=5e-6)


# the two triggers of the feats route on lego_ingp: the Instant-NGP paper's
# tables (past the INGP kernel's 6 MiB budget), and more than 256 samples
TRIGGERS = {
    "paper_tables": (dict(hash_n_levels=16, hash_log2_table_size=19, hash_max_res=512),
                     dict(n_samples=8, n_importance=8)),
    "long_rays": (dict(hash_n_levels=4, hash_log2_table_size=9, hash_min_res=4,
                       hash_max_res=16),
                  dict(n_samples=8, n_importance=250)),
}


def feats_cfg(make, trigger, n_rand=4):
    """lego_ingp with use_fused_kernel on and one of the feats triggers,
    density noise on, ``n_rand`` rays a step."""
    enc, render = TRIGGERS[trigger]
    cfg = make()
    return cfg.replace(
        pos_encoding=dataclasses.replace(cfg.pos_encoding, **enc),
        render=dataclasses.replace(cfg.render, raw_noise_std=0.5, **render),
        train=dataclasses.replace(cfg.train, n_rand=n_rand),
        use_fused_kernel=True,
    )


@pytest.mark.parametrize("trigger", sorted(TRIGGERS))
def test_feats_route_render_matches_jax(trigger):
    """render_rays_train on the feats route in both packages, from the same
    weights and tables (JAX's init plus N(0, 0.1)) and the JAX draws: the
    paper tables take the plain gather in both, the long rays the hash
    kernels (JAX: the Pallas hash encode and the feat train kernel in
    interpret mode). The values, and the gradients of sse_coarse +
    sse_fine with respect to both MLPs and the tables."""
    import jax
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.config import lego_ingp as j_ingp
    from nerf_meets_mlx_tpu.models import create_nerf as j_create

    jc, tc = feats_cfg(j_ingp, trigger), feats_cfg(t_ingp, trigger)
    jm = j_create(jc)
    params = jm.init(jax.random.PRNGKey(3))
    tables = np.asarray(params["pos_enc"]["tables"])
    tables = tables + np.random.default_rng(3).normal(scale=0.1, size=tables.shape).astype(
        np.float32)
    params = {**params, "pos_enc": {"tables": jnp.asarray(tables)}}
    tm = t_create(tc, device="cpu")
    interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tm)
    assert jm._fused_train_mode == tm._fused_train_mode == "feats"
    assert tm._use_hash_kernel() == (trigger == "long_rays")

    B = 4
    rng = np.random.default_rng(2)
    ro = (rng.normal(size=(B, 3)) * 0.1).astype(np.float32)
    rd = rng.normal(size=(B, 3)).astype(np.float32)
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True) * 1.3).astype(np.float32)
    tg = rng.uniform(size=(B, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    # the render's draws, keyed as the JAX model keys them (factory.py)
    S, S_imp = jc.render.n_samples, jc.render.n_importance
    k_jitter, k_noise_c, k_imp, k_noise_f = jax.random.split(key, 4)
    draws = {
        "t": jax.random.uniform(k_jitter, (B, S), dtype=jnp.float32),
        "noise_c": jax.random.normal(k_noise_c, (B, S)),
        "u": jax.random.uniform(k_imp, (B, S_imp), dtype=jnp.float32),
        "noise_f": jax.random.normal(k_noise_f, (B, S + S_imp)),
    }
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}

    def loss(p):
        out = jm.render_rays_train(p, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tg), key)
        return out["sse_coarse"] + out["sse_fine"], out

    (_, out_j), g_j = jax.value_and_grad(loss, has_aux=True)(params)
    LAUNCHES["feat_train"] = 0
    out_t = tm.render_rays_train(*(torch.from_numpy(a) for a in (ro, rd, tg)), draws=draws)
    (out_t["sse_coarse"] + out_t["sse_fine"]).backward()
    assert LAUNCHES["feat_train"] == 0
    for k in ("sse_coarse", "sse_fine", "rgb_coarse", "rgb_fine", "z_vals", "weights"):
        np.testing.assert_allclose(out_t[k].detach().numpy(), np.asarray(out_j[k]), rtol=2e-4,
                                   atol=2e-5, err_msg=k)
    g_t = {"coarse": _grad_tree(tm.coarse), "fine": _grad_tree(tm.fine),
           "pos_enc": {"tables": tm.pos_enc.tables.grad.numpy()}}
    want = dict(jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, g_j)))
    got = dict(jax.tree_util.tree_leaves_with_path(g_t))
    assert sorted(map(str, want)) == sorted(map(str, got))
    for path, b in want.items():
        np.testing.assert_allclose(got[path], b, rtol=3e-4, atol=5e-6,
                                   err_msg=jax.tree_util.keystr(path))
    assert np.count_nonzero(g_t["pos_enc"]["tables"]) > 0


def _mlp_port(P, seed=0, width=64):
    cfg = MLPConfig(net_depth=2, net_width=width, skips=(), use_viewdirs=True)
    mlp = NeRFMLP(cfg, P, D_SH)
    return cfg, mlp.init(torch.Generator().manual_seed(seed))


def test_wrapper_routes_by_device_and_guards_shapes():
    _, tmlp = _mlp_port(16)
    x = torch.zeros((2 * 8, 16 + D_SH + 2))
    target = torch.zeros((2, 3))
    tspec = TrainSpec(n_samples=8, rays_block=4, mode="canonical",
                      density_activation="softplus", white_bkgd=True)
    with pytest.raises(ValueError):
        tff.fused_feat_train_apply(tmlp, tspec, x.to("meta"), target.to("meta"))
    assert tff.feat_rays_block(48) == 10 and tff.feat_rays_block(96) == 5
    assert tff.feat_rays_block(2048) == 1 and tff.feat_group(96, 5) == 8
    with pytest.raises(ValueError, match="2048"):
        tff.feat_rays_block(2049)
    assert tff.WIDTHS == (32, 64)
    assert tff.kernel_defines(64, 16) == {"FEAT_W": 64, "FEAT_PP": 16}
    assert tff.kernel_defines(32, 24) == {"FEAT_W": 32, "FEAT_PP": 32}
    assert tff.kernel_defines(64, 64) == {"FEAT_W": 64, "FEAT_PP": 64}
    # past the register builds: the runtime-shape build
    assert tff.kernel_defines(128, 32) == {"FEAT_W": 0, "FEAT_PP": 0}
    assert tff.kernel_defines(64, 128) == {"FEAT_W": 0, "FEAT_PP": 0}
    tff._check_feat_config(_mlp_port(128, width=256)[1])
    for P, width in ((16, 272), (16, 40), (129, 64)):
        _, wide = _mlp_port(P, width=width)
        with pytest.raises(ValueError, match="multiple of 16 from 32 to 256"):
            tff._check_feat_config(wide)


@pytest.mark.gpu
@pytest.mark.parametrize("R,S,P", [(1001, 96, 32), (300, 40, 16), (3, 2048, 32), (33, 1, 16)])
def test_cuda_feat_kernel_matches_plain(R, S, P):
    _check_cuda_feat_kernel(R, S, P, 64)


@pytest.mark.gpu
@pytest.mark.parametrize("R,S,P,W", [
    (501, 48, 16, 32), (257, 48, 64, 64), (129, 40, 24, 32),
    (257, 48, 32, 128), (129, 40, 128, 64), (65, 96, 16, 256), (101, 48, 24, 48),
])
def test_cuda_feat_kernel_matches_plain_at_new_shapes(R, S, P, W):
    """As test_cuda_feat_kernel_matches_plain at width 32, 64 channels and a
    channel count that fills no register width, and in the runtime-shape
    build: widths 128, 256 and 48, 128 channels."""
    _check_cuda_feat_kernel(R, S, P, W)


def _check_cuda_feat_kernel(R, S, P, W):
    """The CUDA kernel against the plain version at the hash presets'
    widths: a ray count that is not a multiple of the block's rays, sample
    counts inside one 32-sample scan chunk, across chunks, and longer than
    a block of threads (2048), both compositing modes, the white background
    on and off, density noise on. Values at rtol 1e-4 / atol 1e-4 (fp32
    sums in another order than cuBLAS's and the scan's), every dW and
    d(feats) within 1e-3 of its array's largest plain value plus 1e-6 of
    the largest plain gradient entry of all the arrays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _, mlp = _mlp_port(P, width=W)
    mlp = mlp.to(dev)
    g = torch.Generator(device=dev).manual_seed(2)
    feats = torch.randn((R, S, P), generator=g, device=dev) * 0.5
    sh = torch.randn((R, D_SH), generator=g, device=dev) * 0.5
    deltas = torch.rand((R, S), generator=g, device=dev) * 0.05 + 0.005
    deltas[:, -1] = 1e10
    noise = torch.randn((R, S), generator=g, device=dev)
    target = torch.rand((R, 3), generator=g, device=dev)
    rb = tff.feat_rays_block(S)
    params = [p for _, lin in mlp.linears() for p in (lin.weight, lin.bias)]
    for mode in ("canonical", "reference"):
        for white in (True, False):
            tspec = TrainSpec(n_samples=S, rays_block=rb, mode=mode, density_activation="softplus",
                              white_bkgd=white, group=tff.feat_group(S, rb))
            f = feats.clone().requires_grad_(True)
            x = tff.pack_feat_inputs(f, sh, deltas, noise)
            n0 = LAUNCHES["feat_train"]
            sse, rgb, w = tff.fused_feat_train_apply(mlp, tspec, x, target)
            grads = torch.autograd.grad(sse, params + [f])
            torch.cuda.synchronize()
            assert LAUNCHES["feat_train"] == n0 + 1
            sse_p, rgb_p, w_p = tff.fused_feat_train_reference(mlp, tspec, x, target)
            grads_p = torch.autograd.grad(sse_p, params + [f])
            floor = 1e-6 * max(float(b.abs().max()) for b in grads_p)
            torch.testing.assert_close(sse, sse_p, rtol=1e-4, atol=1e-4)
            torch.testing.assert_close(rgb, rgb_p.detach(), rtol=1e-4, atol=1e-4)
            torch.testing.assert_close(w, w_p.detach(), rtol=1e-4, atol=1e-4)
            for i, (a, b) in enumerate(zip(grads, grads_p)):
                err, scale = float((a - b).abs().max()), float(b.abs().max())
                assert bool(torch.isfinite(a).all()) and err <= 1e-3 * scale + floor, (
                    mode, white, i, err, scale)
