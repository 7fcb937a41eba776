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
from nerf_meets_mlx_torch.kernels import fused_ingp_train as tfi
from nerf_meets_mlx_torch.kernels.fused_train import LAUNCHES, TrainSpec
from nerf_meets_mlx_torch.models import NeRFMLP
from nerf_meets_mlx_torch.models import create_nerf as t_create
from test_torch_fused_ingp import _tc
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


def _mlp_port(P, seed=0, width=64, depth=2):
    cfg = MLPConfig(net_depth=depth, net_width=width, skips=(), use_viewdirs=True)
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


# the build each gpu case names: the tensor-core kernel, a register build
# of csrc/fused_feat.cu (width, layer-0 registers) or its runtime-shape one
_BUILDS = {
    "tc": (tff.TC_SOURCE, {}),
    "rt": ("fused_feat", {"FEAT_W": 0, "FEAT_PP": 0}),
    **{f"w{w}pp{pp}": ("fused_feat", {"FEAT_W": w, "FEAT_PP": pp})
       for w in (32, 64) for pp in (16, 32, 64)},
}


@pytest.mark.gpu
@pytest.mark.parametrize("R,S,P,build", [
    (1001, 96, 32, "tc"), (1001, 48, 32, "tc"), (1001, 96, 16, "tc"), (1001, 48, 16, "tc"),
    (300, 40, 16, "tc"), (33, 1, 16, "tc"), (3, 2048, 32, "w64pp32"),
])
def test_cuda_feat_kernel_matches_plain(R, S, P, build):
    """At width 64: the feats route's levels (P = 16, lego_ingp's channels;
    P = 32, the paper tables'; S = 48 / 96, a ragged last tile at 2 rays a
    tile), a ray inside one 32-sample scan chunk and across chunks, and
    rays longer than a block of threads (2048), each in the build the
    router names."""
    _check_cuda_feat_kernel(R, S, P, 64, build)


@pytest.mark.gpu
@pytest.mark.parametrize("R,S,P,W,depth,build", [
    (501, 48, 16, 32, 2, "tc"), (257, 48, 64, 64, 2, "tc"), (129, 40, 24, 32, 2, "tc"),
    (257, 48, 32, 128, 2, "rt"), (129, 40, 128, 64, 2, "rt"), (65, 96, 16, 256, 2, "rt"),
    (101, 48, 24, 48, 2, "rt"),
    (257, 48, 32, 64, 4, "w64pp32"), (257, 128, 16, 32, 2, "w32pp16"),
    (129, 384, 16, 64, 2, "w64pp16"), (129, 96, 64, 64, 2, "w64pp64"),
    (129, 160, 24, 32, 2, "w32pp32"), (65, 128, 48, 32, 2, "w32pp64"),
])
def test_cuda_feat_kernel_matches_plain_at_new_shapes(R, S, P, W, depth, build):
    """As test_cuda_feat_kernel_matches_plain at width 32, 64 channels and a
    channel count that fills no register width on the tensor-core kernel;
    in the runtime-shape build: widths 128, 256 and 48, 128 channels; and
    in every register build of csrc/fused_feat.cu, at the shapes the tile
    does not take (a deeper trunk, the long-ray overlay's 128 and 384
    samples, 64 channels at 96 samples, rays past 96 samples)."""
    _check_cuda_feat_kernel(R, S, P, W, build, depth)


def _check_cuda_feat_kernel(R, S, P, W, build, depth=2):
    """The CUDA kernel against the plain version at the hash presets'
    widths: a ray count that is not a multiple of the block's rays, sample
    counts inside one 32-sample scan chunk, across chunks, and longer than
    a block of threads (2048), both compositing modes, the white background
    on and off, density noise on, in the build ``build`` names (asserted of
    the router first). Values at rtol 1e-4 / atol 1e-4 (fp32
    sums in another order than cuBLAS's and the scan's), every dW and
    d(feats) within 1e-3 of its array's largest plain value plus 1e-6 of
    the largest plain gradient entry of all the arrays."""
    assert tff.train_build(W, depth, P, D_SH, S) == _BUILDS[build]
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _, mlp = _mlp_port(P, width=W, depth=depth)
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


# ---------------------------------------------------------------------------
# The tensor-core kernel (csrc/ingp_train_tc.cu's feat_tc_kernel)
# ---------------------------------------------------------------------------

# the paper tables' shape on the feats route: lego_ingp's 2 x 64 MLPs over
# 16 levels of 2 features and degree-4 SH
PAPER = dict(width=64, depth=2, p_dim=32, n_channels=25)


@pytest.mark.parametrize("width,depth,P,dd,S,rays", [
    (64, 2, 32, 25, 48, 2),     # the paper tables, coarse
    (64, 2, 32, 25, 96, 1),     # the paper tables, fine
    (64, 2, 16, 25, 48, 2),     # lego_ingp's 16 channels on the feats route
    (64, 2, 16, 25, 96, 1),
    (32, 2, 32, 25, 96, 1),     # netwidth = 32
    (64, 2, 64, 25, 48, 1),     # 64 channels (16 levels of 4 features)
    (64, 2, 32, 25, 1, 16),     # short rays: TC_MAX_RAYS a tile
    (64, 2, 64, 25, 96, 0),     # 64 channels and a ray of 96: one ray's tile does not fit
    (64, 4, 32, 25, 48, 0),     # a deeper trunk: one ray's tile does not fit
    (64, 2, 16, 25, 128, 0),    # the long-ray overlay: 128 + 256 samples
    (64, 2, 16, 25, 384, 0),
    (128, 2, 32, 25, 48, 0),    # widths past 64
    (48, 2, 32, 25, 48, 0),
    (64, 2, 128, 25, 48, 0),    # 128 channels
])
def test_train_routes_by_shape(width, depth, P, dd, S, rays):
    """The feat call's build is decided from the shape alone: the
    tensor-core kernel (with that many rays a tile) where a tile of whole
    rays fits its shared memory, csrc/fused_feat.cu's build of the shape
    everywhere else; the budget twin is the INGP kernel's without the
    points, and each tile is the largest that fits."""
    assert tff.tc_rays_per_tile(width, depth, P, dd, S) == rays
    want = (tff.TC_SOURCE, {}) if rays else ("fused_feat", tff.kernel_defines(width, P))
    assert tff.train_build(width, depth, P, dd, S) == want
    if rays:
        tp = -(-rays * S // 16) * 16
        assert tp <= 96
        smem = tff.tc_smem_bytes(width, depth, P, dd, S, rays)
        assert smem <= tfi.SMEM_LIMIT
        assert smem == tfi.tc_smem_bytes(width, depth, P, dd, S, rays) - 4 * 3 * tp
        assert tff.tc_smem_bytes(width, depth, P, dd, S, rays + 1) > tfi.SMEM_LIMIT \
            or rays == tfi.TC_MAX_RAYS or -(-(rays + 1) * S // 16) * 16 > tfi.TC_MAX_POINTS


def test_paper_tables_train_on_the_tensor_cores():
    """The paper-tables overlay on lego_ingp (the feats route's main path:
    16 levels of 2 features, degree-4 SH) routes both levels of both MLPs
    to the tensor-core kernel, 2 rays a tile at 48 samples and 1 at 96,
    whose block takes 231,712 / 231,488 bytes of the 232,448 a block may
    use; the INGP kernel's tile at this shape (the points kept) would not
    fit."""
    cfg = t_ingp()
    enc, dd = cfg.pos_encoding, cfg.dir_encoding.out_dim
    P = 16 * enc.hash_features_per_level
    assert (P, dd) == (PAPER["p_dim"], PAPER["n_channels"])
    for S in (cfg.render.n_samples, cfg.render.n_samples + cfg.render.n_importance):
        for mlp in (cfg.mlp, cfg.mlp_fine):
            assert tff.train_build(mlp.net_width, mlp.net_depth, P, dd, S)[0] == tff.TC_SOURCE
    assert tff.tc_rays_per_tile(**PAPER, n_samples=48) == 2
    assert tff.tc_rays_per_tile(**PAPER, n_samples=96) == 1
    assert tff.tc_smem_bytes(64, 2, 32, 25, 48, 2) == 231_712
    assert tff.tc_smem_bytes(64, 2, 32, 25, 96, 1) == 231_488
    assert tfi.tc_smem_bytes(64, 2, 32, 25, 48, 2) > tfi.SMEM_LIMIT
    assert tfi.tc_smem_bytes(64, 2, 32, 25, 96, 1) > tfi.SMEM_LIMIT


def _fma_rows(a, b):
    """sum_p a[p] * b[p] along dim 0, one fused multiply-add a point in
    point order into an fp32 sum, as a thread of the kernel sums its
    column over a tile."""
    s = torch.zeros(a.shape[1:], dtype=torch.float32)
    for p in range(a.shape[0]):
        s = (a[p].double() * b[p].double() + s.double()).float()
    return s


def _emulate_feat_tc_kernel(mlp, tspec, x, target, rays, blocks):
    """csrc/ingp_train_tc.cu's feat kernel in torch: the N >= 16 products
    of the forward and the cotangents through ``_tc`` per k-step (3xTF32,
    each k-step summed from zero in the truncating accumulator, then added
    in fp32); the heads, the view layer's SH term per ray (from each ray's
    first row) and the compositing in fp32; each tile's dW = X^T dZ through
    ``_tc`` with the tile's points in the accumulator (zero-padded to a
    multiple of 16); the heads' dW, every db and the view layer's SH rows
    on the CUDA cores (a fused multiply-add a point, in point order); each
    block's partial summed over its tiles (block b takes tiles b, b +
    blocks, ...) in fp32, and the blocks' partials summed in block order.
    Returns (sse, rgb, weights, grads in the order of the plain version's
    parameters, dfeats)."""
    R, S = target.shape[0], tspec.n_samples
    P, DD, W = mlp.in_dim, mlp.in_dim_views, mlp.cfg.net_width
    D = mlp.cfg.net_depth
    trunk = list(mlp.pos_linears)
    la, lf, lv, lr = mlp.alpha_linear, mlp.feature_linear, mlp.dir_linear, mlp.rgb_linear
    feats, sh = x[:, :P], x[::S, P:P + DD]
    dl, noise = x[:, P + DD].reshape(R, S), x[:, P + DD + 1].reshape(R, S)
    with torch.no_grad():
        xs, h = [], feats
        for lin in trunk:
            xs.append(h)
            h = torch.relu(_tc(h, lin.weight.t(), True) + lin.bias)
        sigma = h @ la.weight.t() + la.bias
        feat = _tc(h, lf.weight.t(), True) + lf.bias
        vsh = (lv.bias + sh @ lv.weight[:, W:].t()).repeat_interleave(S, 0)
        hd = torch.relu(_tc(feat, lv.weight[:, :W].t(), True) + vsh)
        raw = torch.cat([hd @ lr.weight.t() + lr.bias, sigma], -1).reshape(R, S, 4)
    raw.requires_grad_(True)
    rgb, w = tfi._composite(tspec, raw, dl, noise)
    sse = torch.sum((rgb - target) ** 2)
    (draw,) = torch.autograd.grad(sse, raw)
    draw = draw.reshape(-1, 4)
    tp = -(-rays * S // 16) * 16
    n_tiles = -(-R // rays)

    def tiles(*arrays):
        """each array's rows per tile, zero-padded to tp"""
        for r0 in range(0, R, rays):
            rows = slice(r0 * S, min(R, r0 + rays) * S)
            yield [torch.nn.functional.pad(a[rows], (0, 0, 0, tp - a[rows].shape[0]))
                   for a in arrays]

    def blockwise(per_tile):
        """the tiles' sums into the blocks' partials, then the partials in
        block order, all in fp32"""
        parts = [None] * min(blocks, n_tiles)
        for i, v in enumerate(per_tile):
            b = i % len(parts)
            parts[b] = v if parts[b] is None else parts[b] + v
        out = torch.zeros_like(parts[0])
        for v in parts:
            out = out + v
        return out

    with torch.no_grad():
        drgb, dsig = draw[:, :3], draw[:, 3:]
        dhd = (drgb @ lr.weight) * (hd > 0)
        dfeat = _tc(dhd, lv.weight[:, :W], True)
        dz = (_tc(dfeat, lf.weight, True) + dsig * la.weight) * (h > 0)
        dzs = [None] * D
        for l in range(D - 1, -1, -1):
            dzs[l] = dz
            if l > 0:
                dz = _tc(dz, trunk[l].weight, True) * (xs[l] > 0)
        dfeats = _tc(dz, trunk[0].weight, True)

        def dw(a, d):
            return blockwise(_tc(at.t(), dt) for at, dt in tiles(a, d)).t()

        def heads(a, d):
            return blockwise(_fma_rows(at[:, :, None], dt[:, None, :])
                             for at, dt in tiles(a, d)).t()

        def db(d):
            return blockwise(_fma_rows(dt, torch.ones_like(dt)) for (dt,) in tiles(d))

        grads = []
        for l in range(D):
            grads += [dw(xs[l], dzs[l]), db(dzs[l])]
        grads += [heads(h, dsig), db(dsig)]
        grads += [dw(h, dfeat), db(dfeat)]
        ones = torch.ones(S, 1)
        dsum = torch.stack([_fma_rows(dhd[r * S:(r + 1) * S], ones) for r in range(R)])
        db_v = blockwise(_fma_rows(dsum[r0:r0 + rays], torch.ones(dsum[r0:r0 + rays].shape))
                         for r0 in range(0, R, rays))
        w_sh = blockwise(_fma_rows(sh[r0:r0 + rays, :, None], dsum[r0:r0 + rays, None, :])
                         for r0 in range(0, R, rays)).t()
        grads += [torch.cat([dw(feat, dhd), w_sh], 1), db_v]
        grads += [heads(hd, drgb), db(drgb)]
    return (sse.detach(), rgb.detach(), w.detach(), *grads, dfeats)


@pytest.mark.parametrize("S", [48, 96])
@pytest.mark.parametrize("white", [True, False])
def test_feat_tc_arithmetic_holds_the_card_criterion(S, white):
    """The tensor-core feat kernel's arithmetic (``_emulate_feat_tc_kernel``)
    at the paper tables' shape (2 x 64 MLP, P = 32, 25 SH channels) on 60
    rays in 7 blocks (several tiles a block, a ragged last tile at 2 rays a
    tile), canonical mode with the 1e10 terminal bin and unit density
    noise, against the plain version: sse, rgb and weights within atol
    1e-4 + rtol 1e-4 of the fp32 plain version; each gradient array, dfeats
    included, by the card's feat criterion (chip_smoke.py's feat_case):
    (i) within 1e-3 of the array's largest fp32 plain value plus 1e-6 of
    the largest plain entry of all arrays, or (ii) no more than twice as
    far as the fp32 plain version from the plain version in float64."""
    import copy

    R, P, dd = 60, PAPER["p_dim"], PAPER["n_channels"]
    rays = tff.tc_rays_per_tile(**PAPER, n_samples=S)
    cfg = MLPConfig(net_depth=2, net_width=64, skips=(), use_viewdirs=True)
    mlp = NeRFMLP(cfg, P, dd).init(torch.Generator().manual_seed(4))
    rng = np.random.default_rng(5)
    feats = torch.from_numpy((rng.normal(size=(R, S, P)) * 0.5).astype(np.float32))
    sh = torch.from_numpy((rng.normal(size=(R, dd)) * 0.5).astype(np.float32))
    z = np.sort(rng.uniform(2.0, 6.0, (R, S)), -1)
    dl = torch.from_numpy(np.concatenate([np.diff(z, axis=-1), np.full((R, 1), 1e10)], -1)
                          .astype(np.float32))
    nz = torch.from_numpy(rng.normal(size=(R, S)).astype(np.float32))
    target = torch.from_numpy(rng.uniform(size=(R, 3)).astype(np.float32))
    tspec = TrainSpec(n_samples=S, rays_block=1, mode="canonical",
                      density_activation="softplus", white_bkgd=white)
    params = [p for _, lin in mlp.linears() for p in (lin.weight, lin.bias)]
    got = _emulate_feat_tc_kernel(mlp, tspec, tff.pack_feat_inputs(feats, sh, dl, nz), target,
                                  rays, blocks=7)
    f = feats.clone().requires_grad_(True)
    sse, rgb, w = tff.fused_feat_train_reference(mlp, tspec, tff.pack_feat_inputs(f, sh, dl, nz),
                                                 target)
    want = torch.autograd.grad(sse, params + [f])
    mlp64 = copy.deepcopy(mlp).double()
    f64 = feats.double().requires_grad_(True)
    sse64, _, _ = tff.fused_feat_train_reference(
        mlp64, tspec, tff.pack_feat_inputs(f64, sh.double(), dl.double(), nz.double()),
        target.double())
    want64 = torch.autograd.grad(sse64, [p for _, lin in mlp64.linears()
                                         for p in (lin.weight, lin.bias)] + [f64])
    for a, b in zip(got[:3], (sse, rgb, w)):
        torch.testing.assert_close(a, b.detach(), rtol=1e-4, atol=1e-4)
    grads = list(got[3:-1]) + [got[-1].reshape(R, S, P)]
    assert len(grads) == len(want) == 13
    floor = 1e-6 * max(float(b.abs().max()) for b in want)
    for i, (a, b, c) in enumerate(zip(grads, want, want64)):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        err = float((a - b).abs().max())
        by_i = err <= 1e-3 * float(b.abs().max()) + floor
        k64 = float((a.double() - c).abs().max())
        p64 = float((b.double() - c).abs().max())
        assert by_i or k64 <= 2.0 * p64, (i, err, float(b.abs().max()), k64, p64)


@pytest.mark.gpu
def test_cuda_feat_tc_kernel_is_deterministic():
    """Two launches of the tensor-core kernel on the same inputs give
    bit-identical sse, dW and dfeats: the per-block partials are summed in
    block order and dfeats is stored, not added."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    R, S, P = 4096, 48, 32
    _, mlp = _mlp_port(P)
    mlp = mlp.to(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    feats = torch.randn((R, S, P), generator=g, device=dev) * 0.5
    sh = torch.randn((R, D_SH), generator=g, device=dev) * 0.5
    deltas = torch.rand((R, S), generator=g, device=dev) * 0.05 + 0.005
    deltas[:, -1] = 1e10
    noise = torch.randn((R, S), generator=g, device=dev)
    target = torch.rand((R, 3), generator=g, device=dev)
    tspec = TrainSpec(n_samples=S, rays_block=1, mode="canonical", density_activation="softplus",
                      white_bkgd=True)
    params = [p for _, lin in mlp.linears() for p in (lin.weight, lin.bias)]
    runs = []
    for _ in range(2):
        f = feats.clone().requires_grad_(True)
        sse, _, _ = tff.fused_feat_train_apply(mlp, tspec, tff.pack_feat_inputs(f, sh, deltas,
                                                                                noise), target)
        runs.append([sse.detach()] + list(torch.autograd.grad(sse, params + [f])))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_packed_rows_of_a_ray_carry_its_sh():
    """The precondition of the CUDA call (``fused_feat_train_apply``): the
    rows ``pack_feat_inputs`` makes for a ray all carry the ray's SH, which
    the tensor-core kernel reads from the first row only; the plain
    version reads every row's, so a ray whose rows differ there gives
    another sse on the CPU."""
    R, S, P = 3, 8, 16
    feats, sh, deltas, nz, target = (torch.from_numpy(a) for a in _inputs(R, S, P))
    x = tff.pack_feat_inputs(feats, sh, deltas, nz).reshape(R, S, -1)
    assert torch.equal(x[:, :, P:P + D_SH], sh[:, None, :].expand(R, S, D_SH))
    _, mlp = _mlp_port(P)
    tspec = TrainSpec(n_samples=S, rays_block=4, mode="canonical",
                      density_activation="softplus", white_bkgd=True)
    x = x.reshape(R * S, -1)
    varied = x.clone()
    varied[1::S, P:P + D_SH] += 0.5  # each ray's second row
    sse, _, _ = tff.fused_feat_train_apply(mlp, tspec, x, target)
    sse_v, _, _ = tff.fused_feat_train_apply(mlp, tspec, varied, target)
    assert sse.item() != sse_v.item()


@pytest.mark.gpu
def test_cuda_feat_tc_kernel_reads_each_rays_sh_from_its_first_row():
    """Pins the precondition of the CUDA call: at a shape the tensor-core
    kernel takes, rows of a ray whose SH differ from the first row's change
    nothing (sse, dW and dfeats bit-identical to the call on x with every
    row carrying the first row's SH), while the plain version reads them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    R, S, P = 257, 48, 32
    assert tff.train_build(64, 2, P, D_SH, S)[0] == tff.TC_SOURCE
    _, mlp = _mlp_port(P)
    mlp = mlp.to(dev)
    g = torch.Generator(device=dev).manual_seed(4)
    feats = torch.randn((R, S, P), generator=g, device=dev) * 0.5
    sh = torch.randn((R, D_SH), generator=g, device=dev) * 0.5
    deltas = torch.rand((R, S), generator=g, device=dev) * 0.05 + 0.005
    deltas[:, -1] = 1e10
    noise = torch.randn((R, S), generator=g, device=dev)
    target = torch.rand((R, 3), generator=g, device=dev)
    tspec = TrainSpec(n_samples=S, rays_block=1, mode="canonical", density_activation="softplus",
                      white_bkgd=True)
    params = [p for _, lin in mlp.linears() for p in (lin.weight, lin.bias)]
    x = tff.pack_feat_inputs(feats, sh, deltas, noise)
    varied = x.clone()
    varied.view(R, S, -1)[:, 1:, P:P + D_SH] += torch.randn((R, S - 1, D_SH), generator=g,
                                                            device=dev)
    runs = []
    for xi in (x, varied):
        xi = xi.clone().requires_grad_(True)
        sse, _, _ = tff.fused_feat_train_apply(mlp, tspec, xi, target)
        runs.append([sse.detach()] + list(torch.autograd.grad(sse, params + [xi])))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    sse_p = tff.fused_feat_train_reference(mlp, tspec, x, target)[0]
    sse_v = tff.fused_feat_train_reference(mlp, tspec, varied, target)[0]
    torch.testing.assert_close(runs[0][0], sse_p.detach(), rtol=1e-4, atol=1e-4)
    assert not torch.allclose(sse_v, sse_p, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_cuda_feat_tc_smem_matches_its_python_twin():
    """The kernel's own shared-memory count equals tc_smem_bytes, which the
    routing reads, at the shapes it takes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    lib = tfi._tc_lib()
    for width, depth, P, dd, S in ((64, 2, 32, 25, 48), (64, 2, 32, 25, 96), (32, 3, 16, 25, 32),
                                   (64, 2, 64, 64, 48), (64, 1, 24, 0, 40)):
        rays = tff.tc_rays_per_tile(width, depth, P, dd, S)
        assert rays >= 1
        assert lib.feat_tc_smem_bytes(width, depth, P, dd, S, rays) == tff.tc_smem_bytes(
            width, depth, P, dd, S, rays)
    assert lib.feat_tc_smem_bytes(128, 2, 32, 25, 48, 1) == 0
