"""The port's fused INGP ops (kernels/fused_ingp_train.py; csrc/ingp_eval_tc.cu,
csrc/ingp_train_tc.cu and csrc/fused_ingp.cu).

* Their plain versions against the JAX ``fused_ingp_train_apply`` and
  ``fused_ingp_eval_apply``, which run the Pallas ``_ingp_train_kernel`` /
  ``_ingp_eval_kernel`` in interpret mode here, on the same weights (via
  ``interop``) and inputs made with numpy, at the JAX package's own bounds
  (tests/test_fused_ingp_train.py): sse at rtol 1e-5, rgb and weights at
  rtol 1e-5 / atol 1e-6, every dW and the table gradient dG at rtol 3e-4 /
  atol 5e-6. Both compositing modes, the white background on and off, a
  ragged ray count.
* The wrappers' routing and the weight layout the kernels read.
* ``gpu``-marked: both CUDA calls against the plain version at the
  lego_ingp size, on the card (skipped where no card is present).
* The train kernel's arithmetic emulated on the CPU
  (``_emulate_tc_kernel``); the eval kernel's is in
  tests/test_torch_ingp_eval.py.
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
from tf32_products import _trunc32
from torch_threads import one_torch_thread_per_worker  # noqa: F401  (autouse fixture)

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
    """What took the place of the register builds' zero rows: the eval
    kernel's layer 0 (csrc/ingp_eval_tc.cu) takes K = L·F rounded up to 8,
    its image written by each block from nn.Linear's weight with zero
    columns past L·F (``_eval_image``, the twin of its put_image); the
    pack of csrc/fused_ingp.cu keeps layer 0 at its L·F rows."""
    from test_torch_fused_eval import _unpack_image
    from test_torch_ingp_eval import _eval_image

    mlp = NeRFMLP(MLPConfig(net_depth=2, net_width=64, skips=(), use_viewdirs=True), 12, 25)
    mlp.init(torch.Generator().manual_seed(0))
    w0 = mlp.linears()[0][1].weight.detach()
    img = _eval_image(w0, 12)
    assert img.numel() == 2 * 16 * 64
    hi, lo = _unpack_image(img, 64, 16)
    assert bool(((hi[:12] + lo[:12] - w0.t()).abs() <= 2.0**-22 * w0.t().abs()).all())
    assert not bool(hi[12:].any()) and not bool(lo[12:].any())
    wbuf, offs = tfi.pack_weights(mlp)
    assert offs[1] - offs[0] == 12 * 64
    torch.testing.assert_close(wbuf[offs[0] : offs[1]].view(12, 64), w0.t(), rtol=0, atol=0)


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
    assert tfi.eval_build(64, 2, 8, 2, tm.fine.in_dim_views) == (tfi.EVAL_SOURCE, {})
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
    # the runtime-shape build: widths 48, 96 and 128, 32 levels, 8
    # features a level, 128 channels
    pytest.param(48, ENC, "float32", True, id="w48-L4F2"),
    pytest.param(96, ENC, "float32", True, id="w96-L4F2"),
    pytest.param(128, ENC, "float32", True, id="w128-L4F2"),
    pytest.param(32, dict(ENC, n_levels=32, max_res=64), "float32", True, id="w32-L32F2"),
    pytest.param(64, dict(ENC, features_per_level=8), "float32", True, id="w64-L4F8"),
    pytest.param(32, dict(ENC, n_levels=16, max_res=64, features_per_level=8), "float32", True,
                 id="w32-L16F8"),
    pytest.param(48, dict(ENC, features_per_level=8), "bfloat16", False, id="w48-L4F8-bf16"),
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


@pytest.mark.parametrize("width,levels,features,tc", [
    # the shapes the register builds of csrc/fused_ingp.cu took: now
    # csrc/ingp_eval_tc.cu's
    (64, 8, 2, True), (32, 8, 2, True), (64, 16, 2, True), (64, 8, 4, True),
    (64, 16, 4, True), (32, 16, 1, True), (32, 3, 1, True), (32, 16, 4, True),
    (64, 1, 1, True),
    # csrc/fused_ingp.cu
    (128, 8, 2, False), (256, 8, 2, False), (48, 8, 2, False), (64, 32, 2, False),
    (64, 12, 8, False), (64, 17, 1, False), (64, 32, 4, False),
])
def test_kernel_builds_cover_the_shapes(width, levels, features, tc):
    """Each (width, levels, features) the wrapper takes evaluates in one
    build, decided by ``eval_build`` from the shape alone: the wgmma
    kernel for widths 32 and 64 with up to 16 levels of 1, 2 or 4
    features, csrc/fused_ingp.cu past width 64, 16 levels or 4 features."""
    want = (tfi.EVAL_SOURCE, {}) if tc else (tfi.RT_SOURCE, {})
    assert tfi.eval_build(width, 2, levels, features, 25) == want
    tm = NeRFMLP(MLPConfig(net_depth=2, net_width=width, skips=(), use_viewdirs=True),
                 levels * features, 25)
    tenc = HashGridEncoding(n_levels=levels, min_res=4, max_res=64,
                            features_per_level=features, log2_table_size=9)
    tfi._check_ingp_config(tm, tenc, torch.zeros((1, 25)), "train")


def test_ingp_shape_bounds_raise():
    """Past width 256 (or a width that is no multiple of 16), 32 levels, 8
    features or 128 feature channels the wrapper raises, naming the
    bounds."""
    enc = HashGridEncoding(**ENC)
    for width in (272, 40):
        wide = NeRFMLP(MLPConfig(net_depth=2, net_width=width, skips=(), use_viewdirs=True),
                       8, 25)
        with pytest.raises(ValueError, match="multiple of 16 from 32 to 256"):
            tfi._check_ingp_config(wide, enc, torch.zeros((1, 25)), "train")
    for kw in (dict(n_levels=33), dict(features_per_level=16), dict(n_levels=32,
                                                                      features_per_level=8)):
        deep = HashGridEncoding(**dict(ENC, **kw))
        tm = NeRFMLP(MLPConfig(net_depth=2, net_width=64, skips=(), use_viewdirs=True),
                     deep.out_dim, 25)
        with pytest.raises(ValueError, match="1..32 levels|feature channels"):
            tfi._check_ingp_config(tm, deep, torch.zeros((1, 25)), "eval")


def _cuda_shape_model(width, enc, dtype, dev, generator=None):
    """A lego_ingp model at ``width`` and hash ``enc`` on ``dev``, seeded
    init, tables + N(0, 0.1) drawn from ``generator`` (the device's global
    generator where None)."""
    from nerf_meets_mlx_torch.config import EncodingConfig

    pcfg = dataclasses.replace(EncodingConfig(kind="hash_grid", in_dim=3), **enc,
                               hash_compute_dtype=dtype)
    cfg = t_ingp()
    mlp = dataclasses.replace(cfg.mlp, net_width=width)
    cfg = cfg.replace(pos_encoding=pcfg, mlp=mlp, mlp_fine=mlp)
    tm = t_create(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        tm.pos_enc.tables.add_(
            torch.randn(tm.pos_enc.tables.shape, generator=generator, device=dev) * 0.1)
    return tm


CUDA_SHAPES = [
    (32, dict(hash_n_levels=8, hash_features_per_level=2), "float32"),
    (64, dict(hash_n_levels=16, hash_features_per_level=2), "float32"),
    (64, dict(hash_n_levels=8, hash_features_per_level=4), "float32"),
    (64, dict(hash_n_levels=16, hash_features_per_level=4), "float32"),
    (64, dict(hash_n_levels=8, hash_features_per_level=2), "bfloat16"),
    # the runtime-shape build
    (128, dict(hash_n_levels=8, hash_features_per_level=2), "float32"),
    (256, dict(hash_n_levels=8, hash_features_per_level=2), "float32"),
    (48, dict(hash_n_levels=8, hash_features_per_level=2), "float32"),
    (64, dict(hash_n_levels=32, hash_features_per_level=2, hash_log2_table_size=12), "float32"),
    (64, dict(hash_n_levels=12, hash_features_per_level=8), "float32"),
    (96, dict(hash_n_levels=16, hash_features_per_level=8), "bfloat16"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("width,enc,dtype", CUDA_SHAPES)
def test_cuda_ingp_kernels_match_plain_at_new_shapes(width, enc, dtype):
    """The new shapes and the bf16 hash compute on the card against the
    plain version (bf16: its rounding twin), 501 rays of 48 samples, at
    the criteria of test_cuda_ingp_kernels_match_plain. The tables' noise
    comes from a generator of the test's own (seed 1, as _tc_case's), not
    the device's global one: at width 256 two of 20 draws fail these
    criteria, each where the fp32 plain version, not the kernel, is the one
    off float64 (tools/ingp_kernel_probe.py --draws 20 --draws-width 256)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    tm = _cuda_shape_model(width, enc, dtype, dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    L, F = tm.pos_enc.n_levels, tm.pos_enc.features_per_level
    tc = width in (32, 64) and L <= 16 and F <= 4
    assert tfi.eval_build(width, 2, L, F, tm.fine.in_dim_views)[0] == (
        tfi.EVAL_SOURCE if tc else tfi.RT_SOURCE)
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


# ---------------------------------------------------------------------------
# The train kernel on the tensor cores (csrc/ingp_train_tc.cu)
# ---------------------------------------------------------------------------


def _tc_case(S, R, dtype="float32", seed=5):
    """lego_ingp's fine MLP and tables (N(0, 0.1) added from seed 1, as
    _cuda_model's; ``dtype`` the hash compute type) and R rays of S samples
    on the card from ``seed``."""
    dev = torch.device("cuda")
    tm = _cuda_shape_model(64, dict(hash_n_levels=8, hash_features_per_level=2), dtype, dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    g = torch.Generator(device=dev).manual_seed(seed)
    ro = torch.randn((R, 3), generator=g, device=dev) * 0.2 + torch.tensor([0.0, 0.0, 3.0], device=dev)
    rd = torch.randn((R, 3), generator=g, device=dev) * 0.2 + torch.tensor([0.0, 0.0, -1.0], device=dev)
    sh = sh_encode(rd / rd.norm(dim=-1, keepdim=True), 4)
    z = torch.sort(torch.rand((R, S), generator=g, device=dev) * 4.0 + 1.0, dim=-1).values
    dl = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1) * rd.norm(
        dim=-1, keepdim=True)
    noise = torch.randn((R, S), generator=g, device=dev)
    target = torch.rand((R, 3), generator=g, device=dev)
    return tm, (sh, ro, rd, z, dl, noise, target)


def _tc_spec(S, mode, white):
    rb = tfi.ingp_rays_block(S)
    return TrainSpec(n_samples=S, rays_block=rb, mode=mode, density_activation="softplus",
                     white_bkgd=white, group=tfi.ingp_group(S, rb))


@pytest.mark.gpu
@pytest.mark.parametrize("S,dtype", [(96, "float32"), (48, "float32"), (32, "float32"),
                                     (48, "bfloat16")])
def test_cuda_tc_train_kernel_matches_plain(S, dtype):
    """csrc/ingp_train_tc.cu at lego_ingp's shape (the route takes it) and
    S = 96, 48, 32, fp32 and bf16 hash compute, 1,001 rays (the last tile
    ragged at 2 and 4 rays a tile), both compositing modes, the white
    background on and off, unit density noise: sse, rgb and weights within
    atol 1e-4 + rtol 1e-4; every dW within 1e-3 of its array's largest
    plain value, up to 1e-6 of the largest plain gradient entry of all the
    arrays, and dG within 1e-3 of its largest plain value, as
    test_cuda_ingp_kernels_match_plain holds them. Whether dG is within 1e-4
    is printed: a relu input within rounding of zero flips one point's
    cotangent in one fp32 order and not in the other, which moves the dG
    rows of that point's corners by their whole value (PERF.md, the
    probe's [draws])."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    R = 1001
    tm, (sh, ro, rd, z, dl, noise, target) = _tc_case(S, R, dtype)
    assert tfi.train_build(64, 2, 8, 2, 16, S) == (tfi.TC_SOURCE, {})
    params = _params(tm.fine) + [tm.pos_enc.tables]
    for mode in ("canonical", "reference"):
        for white in (True, False):
            args = (tm.fine, tm.pos_enc, sh, _tc_spec(S, mode, white), ro, rd, z, dl, noise, target)
            n0 = LAUNCHES["ingp_train"]
            sse, rgb, w = tfi.fused_ingp_train_apply(*args)
            grads = torch.autograd.grad(sse, params)
            torch.cuda.synchronize()
            assert LAUNCHES["ingp_train"] == n0 + 1
            sse_p, rgb_p, w_p = tfi.fused_ingp_train_reference(*args)
            grads_p = torch.autograd.grad(sse_p, params)
            floor = 1e-6 * max(float(b.abs().max()) for b in grads_p)
            torch.testing.assert_close(sse, sse_p.detach(), rtol=1e-4, atol=1e-4)
            torch.testing.assert_close(rgb, rgb_p.detach(), rtol=1e-4, atol=1e-4)
            torch.testing.assert_close(w, w_p.detach(), rtol=1e-4, atol=1e-4)
            for i, (a, b) in enumerate(zip(grads, grads_p)):
                err, scale = float((a - b).abs().max()), float(b.abs().max())
                if i == len(grads) - 1:
                    print(f"[tc] S={S} {dtype} {mode} white={int(white)}: dG {err / scale:.1e} "
                          f"of max (within 1e-4: {err <= 1e-4 * scale})")
                    bound = 1e-3 * scale
                else:
                    bound = 1e-3 * scale + floor
                assert bool(torch.isfinite(a).all()) and err <= bound, (mode, white, i, err, scale)


@pytest.mark.gpu
def test_cuda_tc_train_kernel_is_deterministic():
    """Two launches on the same inputs give bit-identical sse and dW (the
    per-block partials are summed in block order); dG may differ in its
    last bits (atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    tm, (sh, ro, rd, z, dl, noise, target) = _tc_case(48, 4096)
    args = (tm.fine, tm.pos_enc, sh, _tc_spec(48, "canonical", True), ro, rd, z, dl, noise, target)
    params = _params(tm.fine)
    runs = []
    for _ in range(2):
        sse, _, _ = tfi.fused_ingp_train_apply(*args)
        runs.append([sse.detach()] + list(torch.autograd.grad(sse, params)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_tc_smem_matches_its_python_twin():
    """The kernel's own shared-memory count equals tc_smem_bytes, which the
    routing reads, at the shapes it takes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    lib = tfi._tc_lib()
    for width, depth, L, F, DD, S in ((64, 2, 8, 2, 16, 48), (64, 2, 8, 2, 16, 96),
                                      (32, 3, 16, 4, 25, 32), (64, 3, 16, 1, 64, 32)):
        rays = tfi.tc_rays_per_tile(width, depth, L, F, DD, S)
        assert rays >= 1
        assert lib.ingp_tc_smem_bytes(width, depth, L, F, DD, S, rays) == tfi.tc_smem_bytes(
            width, depth, L * F, DD, S, rays)


@pytest.mark.parametrize("width,depth,levels,features,dd,S,rays", [
    (64, 2, 8, 2, 16, 48, 2),    # lego_ingp, coarse
    (64, 2, 8, 2, 16, 96, 1),    # lego_ingp, fine
    (64, 2, 8, 2, 16, 32, 3),    # lego_ingp_occ, both levels
    (32, 2, 8, 2, 16, 48, 2),    # netwidth = 32
    (64, 2, 16, 2, 16, 96, 1),   # 16 levels
    (64, 2, 8, 4, 16, 48, 2),    # 4 features a level
    (64, 2, 16, 4, 16, 48, 1),   # 64 feature channels
    (64, 2, 16, 4, 16, 96, 0),   # 64 channels and a ray of 96: one ray's tile does not fit
    (48, 2, 8, 2, 16, 48, 0),    # the runtime-shape build's widths
    (128, 2, 8, 2, 16, 48, 0),
    (64, 2, 32, 2, 16, 96, 0),   # 32 levels
    (64, 2, 12, 8, 16, 96, 0),   # 8 features a level
    (64, 8, 8, 2, 16, 48, 0),    # depth 8 at width 64: one ray's tile does not fit
    (64, 2, 8, 2, 16, 256, 0),   # a ray longer than a tile
])
def test_train_routes_by_shape(width, depth, levels, features, dd, S, rays):
    """The train call's build is decided from the shape alone: the
    tensor-core kernel (with that many rays a tile) for lego_ingp's and
    lego_ingp_occ's shapes and the register builds' range where a tile fits
    the shared memory; the runtime-shape build for widths other than 32 and
    64, more than 16 levels, 8 features, a deep trunk or long rays."""
    assert tfi.tc_rays_per_tile(width, depth, levels, features, dd, S) == rays
    want = (tfi.TC_SOURCE, {}) if rays else (tfi.RT_SOURCE, {})
    assert tfi.train_build(width, depth, levels, features, dd, S) == want
    if rays:
        tp = -(-rays * S // 16) * 16
        assert tp <= tfi.TC_MAX_POINTS
        assert tfi.tc_smem_bytes(width, depth, levels * features, dd, S, rays) <= tfi.SMEM_LIMIT
        assert tfi.tc_smem_bytes(width, depth, levels * features, dd, S, rays + 1) > tfi.SMEM_LIMIT \
            or rays == tfi.TC_MAX_RAYS or -(-(rays + 1) * S // 16) * 16 > tfi.TC_MAX_POINTS


def test_presets_train_on_the_tensor_cores():
    """lego_ingp (48 + 48 samples) and lego_ingp_occ (32 + 32) route both
    levels to the tensor-core kernel at their own SH channel count (degree
    4: 25 channels, the MLP's ``in_dim_views``, which routing reads), whose
    block takes 218,016 / 217,792 bytes of shared memory at lego_ingp's
    coarse / fine level and 218,240 at lego_ingp_occ's (the budget in
    csrc/ingp_train_tc.cu)."""
    from nerf_meets_mlx_torch.config import lego_ingp_occ as t_ingp_occ

    for cfg in (t_ingp(), t_ingp_occ()):
        enc, dd = cfg.pos_encoding, cfg.dir_encoding.out_dim
        assert dd == 25
        for S in (cfg.render.n_samples, cfg.render.n_samples + cfg.render.n_importance):
            for mlp in (cfg.mlp, cfg.mlp_fine):
                assert tfi.train_build(mlp.net_width, mlp.net_depth, enc.hash_n_levels,
                                       enc.hash_features_per_level, dd, S)[0] == tfi.TC_SOURCE
    assert tfi.tc_smem_bytes(64, 2, 16, 25, 48, 2) == 218_016
    assert tfi.tc_smem_bytes(64, 2, 16, 25, 96, 1) == 217_792
    assert tfi.tc_smem_bytes(64, 2, 16, 25, 32, 3) == 218_240


def _trunc_sum(parts):
    """float64 sums added one after another into a float32 accumulator that
    rounds toward zero, as the tensor cores add."""
    acc = torch.zeros_like(parts[0][0])
    for step in zip(*parts):
        for x in step:
            acc = _trunc32(acc + x).double()
    return acc.float()


def _tc(a, b, per_step=False):
    """a [P, K] @ b [K, N] as csrc/ingp_train_tc.cu's mma.sync products:
    both operands split into TF32 halves (split_tf32), K in steps of 8,
    each step's lo*hi, hi*lo and hi*hi summed exactly and added with
    truncation to one accumulator (dW: a tile's points), or with
    ``per_step`` (the forward and cotangent products) to one that starts
    from zero each k-step and is then added to the sum in fp32."""
    from nerf_meets_mlx_torch.kernels.fused_train import _tf32

    K = a.shape[1]
    a = torch.nn.functional.pad(a, (0, -K % 8))
    b = torch.nn.functional.pad(b, (0, 0, 0, -K % 8))
    steps = a.shape[1] // 8
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    parts = [torch.einsum("psk,skn->spn", x.double().reshape(-1, steps, 8),
                          y.double().reshape(steps, 8, -1))
             for x, y in ((al, bh), (ah, bl), (ah, bh))]
    if not per_step:
        return _trunc_sum(parts)
    out = torch.zeros(parts[0].shape[1:], dtype=torch.float32)
    for step in zip(*parts):
        out = out + _trunc_sum([[x] for x in step])
    return out


def _emulate_tc_kernel(mlp, enc, sh, tspec, ro, rd, z, dl, noise, target, rays):
    """csrc/ingp_train_tc.cu's arithmetic in torch: the N >= 16 products of
    the forward and the cotangents through ``_tc`` per k-step, the heads,
    the view layer's SH term per ray, the biases and the compositing in
    fp32; each tile's dW = X^T dZ through ``_tc`` with the tile's points in
    the accumulator (K zero-padded to a multiple of 16) and the tiles' sums
    added in fp32 in tile order; dG from d(features) by the fp32 scatter.
    Returns (sse, rgb, weights, grads in the order of the plain version's
    parameters, the tables' last)."""
    from nerf_meets_mlx_torch.kernels.hash_encode import hash_encode_reference

    R, S = z.shape
    D, W = mlp.cfg.net_depth, mlp.cfg.net_width
    trunk = list(mlp.pos_linears)
    la, lf, lv, lr = mlp.alpha_linear, mlp.feature_linear, mlp.dir_linear, mlp.rgb_linear
    pts = (ro[:, None] + z[..., None] * rd[:, None]).reshape(-1, 3)
    feats = hash_encode_reference(enc, pts).detach()
    with torch.no_grad():
        xs, h = [], feats
        for lin in trunk:
            xs.append(h)
            h = torch.relu(_tc(h, lin.weight.t(), True) + lin.bias)
        hs = xs[1:] + [h]
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
        denc = _tc(dz, trunk[0].weight, True)
        tp = -(-rays * S // 16) * 16

        def dw(x, d):
            out = None
            for r0 in range(0, R, rays):
                rows = slice(r0 * S, min(R, r0 + rays) * S)
                xt = torch.nn.functional.pad(x[rows], (0, 0, 0, tp - x[rows].shape[0]))
                dt = torch.nn.functional.pad(d[rows], (0, 0, 0, tp - d[rows].shape[0]))
                part = _tc(xt.t(), dt)
                out = part if out is None else out + part
            return out.t()

        grads = []
        for l in range(D):
            grads += [dw(xs[l], dzs[l]), dzs[l].sum(0)]
        grads += [dsig.t() @ h, dsig.sum(0)]
        grads += [dw(h, dfeat), dfeat.sum(0)]
        dsum = dhd.reshape(R, S, -1).sum(1)
        grads += [torch.cat([dw(feat, dhd), dsum.t() @ sh], 1), dhd.sum(0)]
        grads += [drgb.t() @ hd, drgb.sum(0)]
    (dG,) = torch.autograd.grad(hash_encode_reference(enc, pts), enc.tables, denc)
    return (sse.detach(), rgb.detach(), w.detach(), *grads, dG)


@pytest.mark.parametrize("S", [48, 96, 32])
@pytest.mark.parametrize("mode", ["canonical", "reference"])
def test_tc_arithmetic_holds_the_card_tolerances(S, mode):
    """The tensor-core kernel's arithmetic (``_emulate_tc_kernel``: 3xTF32
    splits, the truncating accumulator within a k-step of the forward and
    cotangent products and within a tile of dW, fp32 sums across k-steps
    and tiles) at lego_ingp's widths on 5 rays (a ragged last
    tile at 2 and 4 rays a tile), density noise on, against the fp32 plain
    version under PERF.md's card tolerances: sse, rgb and weights within
    atol 1e-4 + rtol 1e-4, every dW within 1e-3 of its array's largest plain
    value and dG within 1e-4 of its largest."""
    tm = t_create(t_ingp(), device="cpu").init(torch.Generator().manual_seed(6))
    with torch.no_grad():
        tm.pos_enc.tables.add_(torch.randn(tm.pos_enc.tables.shape,
                                           generator=torch.Generator().manual_seed(7)) * 0.1)
    rng = np.random.default_rng(8)
    R = 5
    ro = torch.from_numpy((rng.normal(size=(R, 3)) * 0.2 + [0.0, 0.0, 3.0]).astype(np.float32))
    rd = torch.from_numpy((rng.normal(size=(R, 3)) * 0.2 + [0.0, 0.0, -1.0]).astype(np.float32))
    z = torch.from_numpy(np.sort(rng.uniform(1.0, 5.0, (R, S)), -1).astype(np.float32))
    dl = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1) * rd.norm(
        dim=-1, keepdim=True)
    noise = torch.from_numpy(rng.normal(size=(R, S)).astype(np.float32))
    target = torch.from_numpy(rng.uniform(size=(R, 3)).astype(np.float32))
    sh = sh_encode(rd / rd.norm(dim=-1, keepdim=True), 4)
    rays = tfi.tc_rays_per_tile(64, 2, 8, 2, 16, S)
    tspec = _tc_spec(S, mode, True)
    mlp = tm.fine
    args = (mlp, tm.pos_enc, sh, tspec, ro, rd, z, dl, noise, target)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = _emulate_tc_kernel(*args, rays=rays)
        sse, rgb, w = tfi.fused_ingp_train_reference(*args)
        want = torch.autograd.grad(sse, _params(mlp) + [tm.pos_enc.tables])
    finally:
        torch.set_num_threads(threads)
    for a, b in zip(got[:3], (sse, rgb, w)):
        torch.testing.assert_close(a, b.detach(), rtol=1e-4, atol=1e-4)
    grads = got[3:]
    assert len(grads) == len(want) == 13
    for i, (a, b) in enumerate(zip(grads, want)):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        rel = 1e-4 if i == len(want) - 1 else 1e-3
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        assert err <= rel * scale, (i, err, scale)
