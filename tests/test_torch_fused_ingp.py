"""The port's fused INGP ops (kernels/fused_ingp_train.py,
csrc/fused_ingp.cu).

* Their plain versions against the JAX ``fused_ingp_train_apply`` and
  ``fused_ingp_eval_apply``, which run the Pallas ``_ingp_train_kernel`` /
  ``_ingp_eval_kernel`` in interpret mode here, on the same weights (via
  ``interop``) and inputs made with numpy, at the JAX package's own bounds
  (tests/test_fused_ingp_train.py): sse at rtol 1e-5, rgb and weights at
  rtol 1e-5 / atol 1e-6, every dW and the table gradient dG at rtol 3e-4 /
  atol 5e-6. Both compositing modes, the white background on and off, a
  ragged ray count.
* The wrappers' routing and the weight layout the kernels read.
* ``gpu``-marked: both CUDA kernels against the plain version at the
  lego_ingp size, on the card (skipped where no card is present).
"""

import dataclasses

import numpy as np
import pytest
import torch

from nerf_meets_mlx_torch import interop
from nerf_meets_mlx_torch.config import MLPConfig
from nerf_meets_mlx_torch.config import lego_ingp as t_ingp
from nerf_meets_mlx_torch.encoding.hash_grid import HashGridEncoding
from nerf_meets_mlx_torch.encoding.spherical_harmonics import sh_encode
from nerf_meets_mlx_torch.kernels import fused_ingp_train as tfi
from nerf_meets_mlx_torch.kernels.fused_train import LAUNCHES, TrainSpec
from nerf_meets_mlx_torch.models import NeRFMLP
from nerf_meets_mlx_torch.models import create_nerf as t_create

# JAX is imported by the tests that compare with it, not at module level:
# the gpu-marked tests run on the card's machine, which has no JAX
# (python -m pytest --noconftest -m gpu tests/test_torch_fused_ingp.py).

ENC = dict(n_levels=4, min_res=4, max_res=16, features_per_level=2, log2_table_size=9)


def _inputs(R, S, seed=0):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-0.3, 0.3, (R, 3)).astype(np.float32)
    rd = rng.normal(size=(R, 3)).astype(np.float32)
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(0.1, 1.5, (R, S)), axis=-1).astype(np.float32)
    deltas = rng.uniform(0.01, 0.1, (R, S)).astype(np.float32)
    noise = (rng.normal(size=(R, S)) * 0.01).astype(np.float32)
    target = rng.uniform(size=(R, 3)).astype(np.float32)
    return ro, rd, vd, z, deltas, noise, target


def _models(seed=0, enc=None, width=32, dtype="float32", noisy=True):
    """JAX (hash encoding, MLP spec, MLP params, tables) and the port's
    (encoding, MLP) on the same weights: depth 2, width 32, 4 levels of
    T = 2^9 (or ``enc``, ``width``), the hash compute type ``dtype``,
    tables at their init plus N(0, 0.1) when ``noisy``."""
    import jax
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.config import MLPConfig as JMLPConfig
    from nerf_meets_mlx_tpu.encoding.hash_grid import HashGridEncoding as JHash
    from nerf_meets_mlx_tpu.kernels.fused_feat_train import FeatMLPSpec
    from nerf_meets_mlx_tpu.models.nerf_mlp import init_nerf_mlp

    enc = dict(ENC if enc is None else enc, compute_dtype=dtype)
    jenc = JHash(**enc)
    mlp_cfg = JMLPConfig(net_depth=2, net_width=width, skips=(), use_viewdirs=True)
    fspec = FeatMLPSpec.from_configs(mlp_cfg, jenc.out_dim, 25)
    params = init_nerf_mlp(jax.random.PRNGKey(seed), mlp_cfg, jenc.out_dim, 25)
    tables = jenc.init_params(jax.random.PRNGKey(seed + 1))["tables"]
    if noisy:
        tables = tables + jnp.asarray(
            np.random.default_rng(seed).normal(scale=0.1, size=tables.shape), jnp.float32
        )
    tenc = HashGridEncoding(**enc)
    with torch.no_grad():
        tenc.tables.copy_(torch.from_numpy(np.asarray(tables)))
    tmlp = NeRFMLP(MLPConfig(**dataclasses.asdict(mlp_cfg)), tenc.out_dim, 25)
    interop._mlp_from_numpy(jax.tree_util.tree_map(np.asarray, params), tmlp)
    return (jenc, fspec, params, tables), (tenc, tmlp)


def _tspecs(R, S, mode, white, group):
    from nerf_meets_mlx_tpu.kernels.fused_train import TrainSpec as JSpec

    kw = dict(n_samples=S, rays_block=8, mode=mode, density_activation="softplus",
              white_bkgd=white, group=group)
    return JSpec(n_rays=R, **kw), TrainSpec(**kw)


def _params(mlp):
    return [p for _, lin in mlp.linears() for p in (lin.weight, lin.bias)]


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
    "mode,white,group,R",
    [("canonical", True, 1, 10), ("canonical", False, 2, 10), ("reference", True, 2, 25)],
)
def test_ingp_train_op_matches_jax(mode, white, group, R):
    import jax
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.kernels.fused_feat_train import pack_feat_params
    from nerf_meets_mlx_tpu.kernels.fused_ingp_train import fused_ingp_train_apply as j_apply
    from nerf_meets_mlx_tpu.kernels.hash_encode import HashEncodeSpec, pack_tables

    S = 8
    (jenc, fspec, params, tables), (tenc, tmlp) = _models()
    hspec = HashEncodeSpec.from_encoding(jenc)
    ro, rd, vd, z, deltas, noise, target = _inputs(R, S)
    sh = sh_encode(torch.from_numpy(vd), 4)
    jspec, tspec = _tspecs(R, S, mode, white, group)

    def loss(p, t):
        sse, rgb, wts = j_apply(
            fspec, hspec, jspec, pack_feat_params(fspec, p), pack_tables(hspec, t),
            *(jnp.asarray(a) for a in (ro, rd, sh.numpy(), z, deltas, noise, target)),
        )
        return sse, (rgb, wts)

    (sse_j, (rgb_j, w_j)), (g_p, g_t) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True
    )(params, tables)

    LAUNCHES["ingp_train"] = 0
    sse, rgb, w = tfi.fused_ingp_train_apply(
        tmlp, tenc, sh, tspec, *(torch.from_numpy(a) for a in (ro, rd, z, deltas, noise, target))
    )
    sse.backward()
    assert LAUNCHES["ingp_train"] == 0  # the CPU runs the plain version
    assert not rgb.requires_grad and not w.requires_grad
    np.testing.assert_allclose(float(sse), float(sse_j), rtol=1e-5)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=1e-5, atol=1e-6)
    got = jax.tree_util.tree_leaves(_grad_tree(tmlp))
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, g_p))
    assert len(got) == len(want) == 12
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=3e-4, atol=5e-6)
    assert np.count_nonzero(np.asarray(g_t)) > 0
    np.testing.assert_allclose(tenc.tables.grad.numpy(), np.asarray(g_t), rtol=3e-4, atol=5e-6)


@pytest.mark.parametrize("mode,white,R", [("canonical", True, 10), ("reference", False, 25)])
def test_ingp_eval_op_matches_jax(mode, white, R):
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.kernels.fused_feat_train import pack_feat_params
    from nerf_meets_mlx_tpu.kernels.fused_ingp_train import fused_ingp_eval_apply as j_apply
    from nerf_meets_mlx_tpu.kernels.hash_encode import HashEncodeSpec, pack_tables

    S = 8
    (jenc, fspec, params, tables), (tenc, tmlp) = _models(seed=1)
    hspec = HashEncodeSpec.from_encoding(jenc)
    ro, rd, vd, z, deltas, _, _ = _inputs(R, S, seed=1)
    sh = sh_encode(torch.from_numpy(vd), 4)
    jspec, tspec = _tspecs(R, S, mode, white, 2)
    rgb_j, w_j = j_apply(
        fspec, hspec, jspec, pack_feat_params(fspec, params), pack_tables(hspec, tables),
        *(jnp.asarray(a) for a in (ro, rd, sh.numpy(), z, deltas)),
    )
    LAUNCHES["ingp_eval"] = 0
    rgb, w = tfi.fused_ingp_eval_apply(
        tmlp, tenc, sh, tspec, *(torch.from_numpy(a) for a in (ro, rd, z, deltas))
    )
    assert LAUNCHES["ingp_eval"] == 0
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=1e-5, atol=1e-6)


def test_pack_weights_layout():
    """Every piece as [fan_in, fan_out] (nn.Linear.weight transposed) and
    its bias, in linears() order, each on 16 bytes: 12,452 parameters at
    lego_ingp width."""
    tm = t_create(t_ingp(), device="cpu").init(torch.Generator().manual_seed(0))
    wbuf, offs = tfi.pack_weights(tm.coarse)
    lins = tm.coarse.linears()
    assert len(offs) == 2 * len(lins) == 12 and all(o % 4 == 0 for o in offs)
    assert sum(p.numel() for p in tm.coarse.parameters()) == 12_452
    assert wbuf.numel() % 4 == 0
    for i, (_, lin) in enumerate(lins):
        fi, fo = lin.in_features, lin.out_features
        w = wbuf[offs[2 * i] : offs[2 * i] + fi * fo].view(fi, fo)
        torch.testing.assert_close(w, lin.weight.detach().t(), rtol=0, atol=0)
        torch.testing.assert_close(wbuf[offs[2 * i + 1] : offs[2 * i + 1] + fo],
                                   lin.bias.detach(), rtol=0, atol=0)


def test_pack_weights_pads_layer0_to_the_register_width():
    """With rows0 (the build's PP), layer 0's weight gains zero rows, so the
    kernel multiplies all PP columns branch-free; the other pieces keep
    their values."""
    tm = t_create(t_ingp(), device="cpu").init(torch.Generator().manual_seed(0))
    wbuf, offs = tfi.pack_weights(tm.coarse, rows0=32)
    lin0 = tm.coarse.linears()[0][1]
    w0 = wbuf[offs[0] : offs[0] + 32 * 64].view(32, 64)
    torch.testing.assert_close(w0[:16], lin0.weight.detach().t(), rtol=0, atol=0)
    assert not bool(w0[16:].any())
    ref, ref_offs = tfi.pack_weights(tm.coarse)
    assert wbuf.numel() == ref.numel() + 16 * 64
    torch.testing.assert_close(wbuf[offs[2]:], ref[ref_offs[2]:], rtol=0, atol=0)
    assert tfi._layer0_rows(tm.coarse, tm.pos_enc) == 16


def test_wrappers_route_by_device():
    (_, _, _, _), (tenc, tmlp) = _models()
    ro, rd, vd, z, deltas, noise, target = (torch.from_numpy(a) for a in _inputs(4, 8))
    sh = sh_encode(vd, 4)
    _, tspec = _tspecs(4, 8, "canonical", True, 1)
    meta = [t.to("meta") for t in (ro, rd, z, deltas, noise, target)]
    with pytest.raises(ValueError):
        tfi.fused_ingp_eval_apply(tmlp, tenc, sh.to("meta"), tspec, *meta[:4])
    with pytest.raises(ValueError):
        tfi.fused_ingp_train_apply(tmlp, tenc, sh.to("meta"), tspec, *meta)
    assert tfi.ingp_rays_block(96) == 5 and tfi.ingp_rays_block(32) == 16
    assert tfi.ingp_group(96, 5) == 8


def _cuda_model():
    dev = torch.device("cuda")
    tm = t_create(t_ingp(), device=dev).init(torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        tm.pos_enc.tables.add_(
            torch.randn(tm.pos_enc.tables.shape, generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev) * 0.1
        )
    return tm, dev


@pytest.mark.gpu
@pytest.mark.parametrize("S", [96, 32])
def test_cuda_ingp_kernels_match_plain(S):
    """Both kernels at the lego_ingp width and levels, 1,001 rays (not a
    multiple of the block's rays), both compositing modes, the white
    background on and off: values at rtol 1e-4 / atol 1e-4 (fp32 sums in
    another order than cuBLAS's), every dW within 1e-3 of its array's
    largest plain value, dG within 1e-3 of its largest plain value (atomics
    add in another order), each up to 1e-6 of the largest plain gradient
    entry of all the arrays (an array whose sum cancels, the alpha head's,
    keeps the rounding of the terms it sums)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    tm, dev = _cuda_model()
    g = torch.Generator(device=dev).manual_seed(2)
    R = 1001
    ro = torch.randn((R, 3), generator=g, device=dev) * 0.2 + torch.tensor([0.0, 0.0, 3.0], device=dev)
    rd = torch.randn((R, 3), generator=g, device=dev) * 0.2 + torch.tensor([0.0, 0.0, -1.0], device=dev)
    sh = sh_encode(rd / rd.norm(dim=-1, keepdim=True), 4)
    z = torch.sort(torch.rand((R, S), generator=g, device=dev) * 4.0 + 1.0, dim=-1).values
    dl = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1) * rd.norm(
        dim=-1, keepdim=True)
    noise = torch.randn((R, S), generator=g, device=dev)
    target = torch.rand((R, 3), generator=g, device=dev)
    rb = tfi.ingp_rays_block(S)
    params = _params(tm.fine) + [tm.pos_enc.tables]
    for mode in ("canonical", "reference"):
        for white in (True, False):
            tspec = TrainSpec(n_samples=S, rays_block=rb, mode=mode, density_activation="softplus",
                              white_bkgd=white, group=tfi.ingp_group(S, rb))
            n0 = dict(LAUNCHES)
            with torch.no_grad():
                rgb, w = tfi.fused_ingp_eval_apply(tm.fine, tm.pos_enc, sh, tspec, ro, rd, z, dl)
                torch.cuda.synchronize()
                rgb_p, w_p = tfi.fused_ingp_eval_reference(tm.fine, tm.pos_enc, sh, tspec, ro, rd,
                                                           z, dl)
            torch.testing.assert_close(rgb, rgb_p, rtol=1e-4, atol=1e-4)
            torch.testing.assert_close(w, w_p, rtol=1e-4, atol=1e-4)
            args = (tm.fine, tm.pos_enc, sh, tspec, ro, rd, z, dl, noise, target)
            sse, rgb, w = tfi.fused_ingp_train_apply(*args)
            grads = torch.autograd.grad(sse, params)
            torch.cuda.synchronize()
            assert LAUNCHES["ingp_eval"] == n0["ingp_eval"] + 1
            assert LAUNCHES["ingp_train"] == n0["ingp_train"] + 1
            sse_p, rgb_p, w_p = tfi.fused_ingp_train_reference(*args)
            grads_p = torch.autograd.grad(sse_p, params)
            floor = 1e-6 * max(float(b.abs().max()) for b in grads_p)
            torch.testing.assert_close(sse, sse_p, rtol=1e-4, atol=1e-4)
            torch.testing.assert_close(rgb, rgb_p.detach(), rtol=1e-4, atol=1e-4)
            torch.testing.assert_close(w, w_p.detach(), rtol=1e-4, atol=1e-4)
            for i, (a, b) in enumerate(zip(grads, grads_p)):
                err, scale = float((a - b).abs().max()), float(b.abs().max())
                assert bool(torch.isfinite(a).all()) and err <= 1e-3 * scale + floor, (
                    mode, white, i, err, scale)


# The shapes the overlay keys reach (width 32 / 64, up to 16 levels, 1, 2
# or 4 features a level) and the bf16 hash compute, on the train and eval
# ops. bf16: the Pallas kernel normalises by multiplying with 1/(box size),
# the port divides (as its fp32 kernels and the plain encode do), which
# moves some trilinear weights by an ulp and, in bf16, across a rounding
# boundary; so the bf16 cases run on JAX's init tables (U(-1e-4, 1e-4)), as
# tests/test_hash_encode.py's bf16 test does, where that is far below the
# tolerances.
SHAPE_CASES = [
    pytest.param(64, dict(ENC, n_levels=16, max_res=64), "float32", True, id="w64-L16F2"),
    pytest.param(32, dict(ENC, features_per_level=4), "float32", True, id="w32-L4F4"),
    pytest.param(64, dict(ENC, features_per_level=1), "float32", True, id="w64-L4F1"),
    pytest.param(32, ENC, "bfloat16", False, id="w32-L4F2-bf16"),
    pytest.param(64, dict(ENC, n_levels=8, features_per_level=4), "bfloat16", False,
                 id="w64-L8F4-bf16"),
]


@pytest.mark.parametrize("width,enc,dtype,noisy", SHAPE_CASES)
def test_ingp_ops_match_jax_at_new_shapes(width, enc, dtype, noisy):
    """Both ops at the new shapes against the Pallas kernels in interpret
    mode, at the bounds of the tests above (sse rtol 1e-5; rgb, weights
    rtol 1e-5 / atol 1e-6; dW and dG rtol 3e-4 / atol 5e-6)."""
    import jax
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.kernels.fused_feat_train import pack_feat_params
    from nerf_meets_mlx_tpu.kernels.fused_ingp_train import (
        fused_ingp_eval_apply as j_eval,
        fused_ingp_train_apply as j_train,
    )
    from nerf_meets_mlx_tpu.kernels.hash_encode import HashEncodeSpec, pack_tables

    R, S = 10, 8
    (jenc, fspec, params, tables), (tenc, tmlp) = _models(
        seed=3, enc=enc, width=width, dtype=dtype, noisy=noisy
    )
    hspec = HashEncodeSpec.from_encoding(jenc)
    assert hspec.compute_dtype == dtype
    ro, rd, vd, z, deltas, noise, target = _inputs(R, S, seed=3)
    sh = sh_encode(torch.from_numpy(vd), 4)
    jspec, tspec = _tspecs(R, S, "canonical", True, 2)
    jargs = [jnp.asarray(a) for a in (ro, rd, sh.numpy(), z, deltas)]

    def loss(p, t):
        sse, rgb, wts = j_train(fspec, hspec, jspec, pack_feat_params(fspec, p),
                                pack_tables(hspec, t), *jargs, jnp.asarray(noise),
                                jnp.asarray(target))
        return sse, (rgb, wts)

    (sse_j, (rgb_j, w_j)), (g_p, g_t) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True
    )(params, tables)
    sse, rgb, w = tfi.fused_ingp_train_apply(
        tmlp, tenc, sh, tspec, *(torch.from_numpy(a) for a in (ro, rd, z, deltas, noise, target))
    )
    sse.backward()
    np.testing.assert_allclose(float(sse), float(sse_j), rtol=1e-5)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=1e-5, atol=1e-6)
    got = jax.tree_util.tree_leaves(_grad_tree(tmlp))
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, g_p))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=3e-4, atol=5e-6)
    np.testing.assert_allclose(tenc.tables.grad.numpy(), np.asarray(g_t), rtol=3e-4, atol=5e-6)

    rgb_j, w_j = j_eval(fspec, hspec, jspec, pack_feat_params(fspec, params),
                        pack_tables(hspec, tables), *jargs)
    rgb, w = tfi.fused_ingp_eval_apply(
        tmlp, tenc, sh, tspec, *(torch.from_numpy(a) for a in (ro, rd, z, deltas))
    )
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("width,levels,features,pp", [
    (64, 8, 2, 16), (32, 8, 2, 16), (64, 16, 2, 32), (64, 8, 4, 32), (64, 16, 4, 64),
    (32, 16, 1, 16), (32, 3, 1, 16),
])
def test_kernel_builds_cover_the_shapes(width, levels, features, pp):
    """Each (width, levels, features) the wrapper takes maps to one build of
    csrc/fused_ingp.cu, the smallest layer-0 register width that holds the
    features; past width 64 or 16 levels the wrapper raises, naming the
    bound."""
    assert tfi.kernel_defines(width, levels * features) == {"INGP_W": width, "INGP_PP": pp}
    tm = NeRFMLP(MLPConfig(net_depth=2, net_width=width, skips=(), use_viewdirs=True),
                 levels * features, 25)
    tenc = HashGridEncoding(n_levels=levels, min_res=4, max_res=64,
                            features_per_level=features, log2_table_size=9)
    tfi._check_ingp_config(tm, tenc, torch.zeros((1, 25)), "train")


def test_ingp_shape_bounds_raise():
    wide = NeRFMLP(MLPConfig(net_depth=2, net_width=128, skips=(), use_viewdirs=True), 16, 25)
    enc = HashGridEncoding(**ENC)
    with pytest.raises(ValueError, match="registers"):
        tfi._check_ingp_config(wide, enc, torch.zeros((1, 25)), "train")
    deep = HashGridEncoding(**dict(ENC, n_levels=17))
    tm = NeRFMLP(MLPConfig(net_depth=2, net_width=64, skips=(), use_viewdirs=True), 34, 25)
    with pytest.raises(ValueError, match="1..16 levels"):
        tfi._check_ingp_config(tm, deep, torch.zeros((1, 25)), "eval")


def _cuda_shape_model(width, enc, dtype, dev):
    from nerf_meets_mlx_torch.config import EncodingConfig

    pcfg = dataclasses.replace(EncodingConfig(kind="hash_grid", in_dim=3), **enc,
                               hash_compute_dtype=dtype)
    cfg = t_ingp()
    mlp = dataclasses.replace(cfg.mlp, net_width=width)
    cfg = cfg.replace(pos_encoding=pcfg, mlp=mlp, mlp_fine=mlp)
    tm = t_create(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        tm.pos_enc.tables.add_(torch.randn(tm.pos_enc.tables.shape, device=dev) * 0.1)
    return tm


CUDA_SHAPES = [
    (32, dict(hash_n_levels=8, hash_features_per_level=2), "float32"),
    (64, dict(hash_n_levels=16, hash_features_per_level=2), "float32"),
    (64, dict(hash_n_levels=8, hash_features_per_level=4), "float32"),
    (64, dict(hash_n_levels=16, hash_features_per_level=4), "float32"),
    (64, dict(hash_n_levels=8, hash_features_per_level=2), "bfloat16"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("width,enc,dtype", CUDA_SHAPES)
def test_cuda_ingp_kernels_match_plain_at_new_shapes(width, enc, dtype):
    """The new shapes and the bf16 hash compute on the card against the
    plain version (bf16: its rounding twin), 501 rays of 48 samples, at
    the criteria of test_cuda_ingp_kernels_match_plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    tm = _cuda_shape_model(width, enc, dtype, dev)
    g = torch.Generator(device=dev).manual_seed(2)
    R, S = 501, 48
    ro = torch.randn((R, 3), generator=g, device=dev) * 0.2 + torch.tensor([0.0, 0.0, 3.0], device=dev)
    rd = torch.randn((R, 3), generator=g, device=dev) * 0.2 + torch.tensor([0.0, 0.0, -1.0], device=dev)
    sh = sh_encode(rd / rd.norm(dim=-1, keepdim=True), 4)
    z = torch.sort(torch.rand((R, S), generator=g, device=dev) * 4.0 + 1.0, dim=-1).values
    dl = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1) * rd.norm(
        dim=-1, keepdim=True)
    noise = torch.randn((R, S), generator=g, device=dev)
    target = torch.rand((R, 3), generator=g, device=dev)
    rb = tfi.ingp_rays_block(S)
    tspec = TrainSpec(n_samples=S, rays_block=rb, mode="canonical", density_activation="softplus",
                      white_bkgd=True, group=tfi.ingp_group(S, rb))
    params = _params(tm.fine) + [tm.pos_enc.tables]
    with torch.no_grad():
        rgb, w = tfi.fused_ingp_eval_apply(tm.fine, tm.pos_enc, sh, tspec, ro, rd, z, dl)
        rgb_p, w_p = tfi.fused_ingp_eval_reference(tm.fine, tm.pos_enc, sh, tspec, ro, rd, z, dl)
    torch.testing.assert_close(rgb, rgb_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(w, w_p, rtol=1e-4, atol=1e-4)
    args = (tm.fine, tm.pos_enc, sh, tspec, ro, rd, z, dl, noise, target)
    n0 = LAUNCHES["ingp_train"]
    sse, rgb, w = tfi.fused_ingp_train_apply(*args)
    grads = torch.autograd.grad(sse, params)
    torch.cuda.synchronize()
    assert LAUNCHES["ingp_train"] == n0 + 1
    sse_p, rgb_p, w_p = tfi.fused_ingp_train_reference(*args)
    grads_p = torch.autograd.grad(sse_p, params)
    floor = 1e-6 * max(float(b.abs().max()) for b in grads_p)
    torch.testing.assert_close(sse, sse_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(rgb, rgb_p.detach(), rtol=1e-4, atol=1e-4)
    for i, (a, b) in enumerate(zip(grads, grads_p)):
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        assert bool(torch.isfinite(a).all()) and err <= 1e-3 * scale + floor, (i, err, scale)
