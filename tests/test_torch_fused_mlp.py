"""The port's fused point-major MLP op (kernels/fused_mlp.py; the forward
kernel csrc/mlp_fwd_tc.cu, the backward csrc/fused_mlp.cu).

* Its plain version against the JAX ``fused_apply``, which runs the Pallas
  ``_fwd_kernel`` / ``_bwd_kernel`` in interpret mode here, on the same
  weights (via ``interop``) and inputs made with numpy: values at rtol 1e-4
  / atol 1e-5 (tests/test_fused_mlp.py's kernel-vs-twin bound), at lego
  width against ``fused_apply_reference`` at 2e-4; every dW, db and dX of
  Σ raw² at rtol 5e-3 / atol 1e-4 (the same file's gradient bound).
* The forward kernel's arithmetic (``_emulate_forward``: every dense layer
  in 3xTF32 with one truncating accumulator a layer, ``mm_wgmma``) against
  the JAX kernel at atol 1e-4 + rtol 1e-4 and against the fp32 plain
  version at ``MLP_TIGHT``, which one TF32 pass misses; the relu decisions
  it takes apart from fp32 counted. Its weight images' size and its
  shared-memory plan against their C twins' formulas.
* ``NeRFModel.query`` on the fused route against the JAX model's fused
  query.
* The CUDA backward's algorithm replayed in torch from the buffer it reads
  (``pack_mlp_weights``) and into the dW layout it writes, dX included,
  against autograd through the plain version.
* The wrapper's routing: CPU tensors run the plain version and launch
  nothing; other devices raise.
* ``gpu``-marked: both CUDA kernels against the plain version at widths
  256, 128, 64, 32, 48 and 96 with a ragged point count; the forward
  kernel within ``MLP_TIGHT`` of plain at those widths, over several tiles
  a block, where the same source built with one TF32 pass
  (``MLP_FWD_ONE_PASS``) is not; one launch a call, bit-identical over two
  (skipped where no card is present).
"""

import dataclasses

import numpy as np
import pytest
import torch

from nerf_meets_mlx_torch import interop
from nerf_meets_mlx_torch.config import EncodingConfig, MLPConfig
from nerf_meets_mlx_torch.config import lego_hierarchical as t_lego
from nerf_meets_mlx_torch.encoding.sinusoidal import sinusoidal_encode
from nerf_meets_mlx_torch.kernels import fused_mlp as tfm
from nerf_meets_mlx_torch.kernels import fused_train as tft
from nerf_meets_mlx_torch.kernels.fused_train import LAUNCHES
from nerf_meets_mlx_torch.models import create_nerf as t_create
from tf32_products import _mm_1xtf32, mm_wgmma
from torch_threads import one_torch_thread_per_worker  # noqa: F401  (autouse fixture)

# The tight tolerance (atol = rtol) of the forward kernel's raw against the
# fp32 plain version, as chip_smoke.py's MLP_TIGHT: its 3xTF32 products
# meet it, one TF32 pass does not (which meets atol 1e-4 + rtol 1e-4 at
# most shapes). The emulation below puts 3xTF32 at 0.13-0.38 of 1e-6 and
# one pass at 42-110 times 1e-6 at widths 32-256 (lego_occ's 8 layers).
MLP_TIGHT = 5e-6

# JAX is imported by the tests that compare with it, not at module level:
# the gpu-marked tests run on the card's machine, which has no JAX
# (python -m pytest --noconftest -m gpu tests/test_torch_fused_mlp.py).


def _configs(depth=4, width=64, skips=(2,), pos_f=6, dir_f=3, bands="canonical"):
    mlp = MLPConfig(net_depth=depth, net_width=width, skips=skips)
    pos = EncodingConfig(kind="sinusoidal", in_dim=3, n_freqs=pos_f, include_input=True,
                         frequency_bands=bands)
    dir_ = EncodingConfig(kind="sinusoidal", in_dim=3, n_freqs=dir_f, include_input=True,
                          frequency_bands=bands)
    return mlp, pos, dir_


def _pair(seed=0, block=128, compute_dx=True, **kw):
    """(JAX spec, JAX params, port model) on the same weights."""
    import jax

    from nerf_meets_mlx_tpu import config as jconf
    from nerf_meets_mlx_tpu.kernels.fused_mlp import FusedMLPSpec
    from nerf_meets_mlx_tpu.models import init_nerf_mlp

    mlp, pos, dir_ = _configs(**kw)
    jmlp = jconf.MLPConfig(**dataclasses.asdict(mlp))
    jpos = jconf.EncodingConfig(**dataclasses.asdict(pos))
    jdir = jconf.EncodingConfig(**dataclasses.asdict(dir_))
    spec = FusedMLPSpec.from_configs(jmlp, jpos, jdir, block=block, compute_dx=compute_dx)
    params = init_nerf_mlp(jax.random.PRNGKey(seed), jmlp, jpos.out_dim, jdir.out_dim)
    tm = t_create(
        t_lego().replace(pos_encoding=pos, dir_encoding=dir_, mlp=mlp, mlp_fine=None),
        device="cpu",
    )
    interop.params_from_numpy(
        {"coarse": jax.tree_util.tree_map(np.asarray, params), "pos_enc": {}, "dir_enc": {}}, tm
    )
    return spec, params, tm


def _points(N, seed=1):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(N, 3)).astype(np.float32)
    dirs = rng.normal(size=(N, 3)).astype(np.float32)
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    return pts, dirs


def _x8(pts, dirs):
    """The JAX kernel's packed input [N, 8]: points, directions, padding."""
    return np.concatenate([pts, dirs, np.zeros((pts.shape[0], 2), np.float32)], axis=-1)


def _port_raw(tm, pts, dirs, compute_dx=False):
    return tfm.fused_mlp_apply(
        tm.coarse, tm.pos_enc, tm.dir_enc, torch.from_numpy(pts), torch.from_numpy(dirs),
        compute_dx=compute_dx,
    )


@pytest.mark.parametrize("N", [256, 70], ids=["two_blocks", "ragged"])
def test_forward_matches_jax_kernel(N):
    """256 points are two of the Pallas kernel's 128-point blocks; 70 pad
    to one."""
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.kernels.fused_mlp import fused_apply, pack_params

    spec, params, tm = _pair()
    pts, dirs = _points(N)
    want = fused_apply(spec, pack_params(spec, params), jnp.asarray(_x8(pts, dirs)))
    assert want.shape == (N, 8)
    got = _port_raw(tm, pts, dirs)
    assert got.shape == (N, 4)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want)[:, :4], rtol=1e-4, atol=1e-5)


def test_forward_lego_width_matches_jax_twin():
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.kernels.fused_mlp import fused_apply_reference, pack_params

    spec, params, tm = _pair(depth=8, width=256, skips=(4,), pos_f=10, dir_f=4, block=64)
    pts, dirs = _points(64, seed=3)
    want = fused_apply_reference(spec, pack_params(spec, params), jnp.asarray(_x8(pts, dirs)))
    got = _port_raw(tm, pts, dirs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want)[:, :4], rtol=2e-4, atol=2e-4)


def test_forward_reference_squared_bands_matches_jax_kernel():
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.kernels.fused_mlp import fused_apply, pack_params

    spec, params, tm = _pair(depth=3, skips=(), pos_f=5, dir_f=3, bands="reference_squared")
    assert spec.pos_band_mode == "reference_squared"
    pts, dirs = _points(64, seed=4)
    want = fused_apply(spec, pack_params(spec, params), jnp.asarray(_x8(pts, dirs)))
    got = _port_raw(tm, pts, dirs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want)[:, :4], rtol=1e-4, atol=1e-5)


def _pad8(x):
    return torch.nn.functional.pad(x, (0, -x.shape[1] % 8))


def _emulate_forward(mlp, pos_enc, dir_enc, pts, dirs, mm=mm_wgmma):
    """csrc/mlp_fwd_tc.cu's arithmetic in torch: the encodings as the plain
    version's; each dense layer (trunk, feature, view) with its input
    segments zero-padded to whole k-steps of 8 as the kernel's B images
    are (fused_train.pack_eval_wgmma), multiplied by ``mm`` (``mm_wgmma``:
    3xTF32 with one truncating accumulator a layer, the kernel's form), plus
    the bias from the buffer the kernel reads; the alpha and rgb heads in
    fp32. Returns (raw [N, 4], the pre-activations of every relu layer)."""
    cfg = mlp.cfg
    D = cfg.net_depth
    wbuf, offs = tfm.pack_mlp_weights(mlp, pos_enc, dir_enc)

    def vec(i, n):
        return wbuf[offs[i] : offs[i] + n]

    xp, xd = pos_enc.apply(pts), dir_enc.apply(dirs)

    def dense(i, lin, segs):
        wt, a, b, at = lin.weight.t(), [], [], 0
        for x in segs:
            a.append(_pad8(x))
            b.append(_pad8(wt[at : at + x.shape[1]].t()).t())
            at += x.shape[1]
        return mm(torch.cat(a, 1), torch.cat(b, 0)) + vec(2 * i + 1, lin.out_features)

    pre, h = [], None
    for j, lin in enumerate(mlp.pos_linears):
        pre.append(dense(j, lin, [xp] if j == 0 else ([xp, h] if (j - 1) in cfg.skips else [h])))
        h = torch.relu(pre[-1])
    sigma = h @ vec(2 * D, cfg.net_width)[:, None] + vec(2 * D + 1, 1)
    feat = dense(D + 1, mlp.feature_linear, [h])
    pre.append(dense(D + 2, mlp.dir_linear, [feat, xd]))
    W2 = cfg.net_width // 2
    rgb = torch.relu(pre[-1]) @ vec(2 * D + 6, W2 * 3).reshape(W2, 3) + vec(2 * D + 7, 3)
    return torch.cat([rgb, sigma], -1), pre


def _plain_pre_activations(mlp, pos_enc, dir_enc, pts, dirs):
    """The fp32 plain version's pre-activations of the same relu layers."""
    cfg = mlp.cfg
    xp, xd = pos_enc.apply(pts), dir_enc.apply(dirs)
    pre, h = [], None
    for j, lin in enumerate(mlp.pos_linears):
        pre.append(lin(xp if j == 0 else (torch.cat([xp, h], -1) if (j - 1) in cfg.skips else h)))
        h = torch.relu(pre[-1])
    pre.append(mlp.dir_linear(torch.cat([mlp.feature_linear(h), xd], -1)))
    return pre


def _over(got, want, tol):
    """max |got - want| / (tol + tol·|want|): at most 1 within atol = rtol = tol."""
    return float(((got - want).abs() / (tol * (1.0 + want.abs()))).max())


@pytest.mark.parametrize("width,skips", [(32, (1,)), (48, (2,))])
def test_forward_kernel_arithmetic_matches_jax_kernel(width, skips):
    """The forward kernel's 3xTF32 arithmetic (``_emulate_forward``) at
    depth 4 with a skip, 70 points (a ragged 128-point tile), on the JAX
    weights: within atol 1e-4 + rtol 1e-4 of the Pallas ``fused_apply`` in
    interpret mode, and within MLP_TIGHT of the fp32 plain version, where
    one TF32 pass (the kernel's one-pass build, ``mm_wgmma(passes=1)``, and
    ``_mm_1xtf32``) is not. A relu decision apart from fp32 can only sit
    where a pre-activation lies within the products' error of 0, so it
    moves no value by more than that error: the largest pre-activation
    error and the decisions apart are printed, the values held above."""
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.kernels.fused_mlp import fused_apply, pack_params

    spec, params, tm = _pair(depth=4, width=width, skips=skips)
    pts, dirs = _points(70, seed=12)
    want = np.asarray(fused_apply(spec, pack_params(spec, params), jnp.asarray(_x8(pts, dirs))))
    p, d = torch.from_numpy(pts), torch.from_numpy(dirs)
    args = (tm.coarse, tm.pos_enc, tm.dir_enc, p, d)
    with torch.no_grad():
        three, pre3 = _emulate_forward(*args)
        one, _ = _emulate_forward(*args, mm=lambda a, b: mm_wgmma(a, b, passes=1))
        one_x, _ = _emulate_forward(*args, mm=_mm_1xtf32)
        plain = tfm.fused_mlp_reference(*args)
        pre_p = _plain_pre_activations(*args)
    np.testing.assert_allclose(three.numpy(), want[:, :4], rtol=1e-4, atol=1e-4)
    over = {"3xTF32": _over(three, plain, MLP_TIGHT), "one pass": _over(one, plain, MLP_TIGHT),
            "_mm_1xtf32": _over(one_x, plain, MLP_TIGHT)}
    err = max(float((a - b).abs().max()) for a, b in zip(pre3, pre_p))
    flips = sum(int(((a > 0) != (b > 0)).sum()) for a, b in zip(pre3, pre_p))
    print(f"[tf32] width {width}: over MLP_TIGHT {over}; pre-activations within {err:.2e} of "
          f"fp32, {flips} relu decisions apart")
    assert over["3xTF32"] <= 1.0, over
    assert over["one pass"] > 1.0 and over["_mm_1xtf32"] > 1.0, over


def test_forward_image_and_smem_plan_match_the_kernel():
    """``pack_eval_wgmma``'s buffer has the size the kernel's producer
    streams (``mlp_fwd_tc_image_floats``: per trunk, feature and view layer
    its k-steps of 8 rows x N columns x (hi, lo), a skip layer's position
    segment padded apart), at every depth, skip set and band count the
    wrapper takes; and the kernel's shared memory (ring of 4 stages of
    16·W floats, a 128 x (W + 8) activation tile, 8 mbarriers, 128 x 8
    floats of points) fits a block at every width."""
    def image_floats(D, W, skips, P, Dd):
        k = -(-P // 8)
        steps = k + W // 8 + sum(W // 8 + (k if (j - 1) in skips else 0) for j in range(1, D))
        return steps * 16 * W + (W // 8 + -(-Dd // 8)) * 16 * (W // 2)

    for depth, width, skips, pos_f, dir_f in ((2, 32, (), 4, 2), (4, 48, (1, 2), 6, 3),
                                              (8, 64, (4,), 10, 4), (17, 32, (3, 9, 15), 2, 1)):
        mlp, pos, dir_ = _configs(depth=depth, width=width, skips=skips, pos_f=pos_f, dir_f=dir_f)
        cfg = t_lego().replace(pos_encoding=pos, dir_encoding=dir_, mlp=mlp, mlp_fine=mlp)
        tm = t_create(cfg, device="cpu").init(torch.Generator().manual_seed(1))
        img = tft.pack_eval_wgmma(tm.coarse, tm.pos_enc, tm.dir_enc)
        assert img.numel() == image_floats(depth, width, skips, tm.pos_enc.out_dim,
                                           tm.dir_enc.out_dim)
        assert len(tfm.pack_mlp_weights(tm.coarse, tm.pos_enc, tm.dir_enc)[1]) == 2 * depth + 10
    for width in range(32, 257, 16):
        smem = 4 * (4 * 16 * width + 128 * (width + 8)) + 8 * 8 + 4 * 128 * 8
        assert smem <= 232448, (width, smem)


def _port_grads(tm, pts, dirs, compute_dx):
    """d(Σ raw²) with respect to every parameter (as the JAX pytree) and,
    with compute_dx, to the points and directions."""
    p = torch.from_numpy(pts).requires_grad_(True)
    d = torch.from_numpy(dirs).requires_grad_(True)
    raw = tfm.fused_mlp_apply(tm.coarse, tm.pos_enc, tm.dir_enc, p, d, compute_dx=compute_dx)
    tm.coarse.zero_grad(set_to_none=True)
    (raw**2).sum().backward()
    tree = {"pos_linears": []}
    for name, lin in tm.coarse.linears():
        leaf = {"w": lin.weight.grad.t().numpy().copy(), "b": lin.bias.grad.numpy().copy()}
        if name.startswith("pos_linears."):
            tree["pos_linears"].append(leaf)
        else:
            tree[name] = leaf
    return tree, p.grad, d.grad


def test_gradients_match_jax_kernel():
    """Every dW, db and dX of Σ raw² against jax.grad through the Pallas
    backward (compute_dx on)."""
    import jax
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.kernels.fused_mlp import fused_apply, pack_params

    spec, params, tm = _pair()
    pts, dirs = _points(256, seed=5)

    def loss(p, x):
        return jnp.sum(fused_apply(spec, pack_params(spec, p), x)[:, :4] ** 2)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(_x8(pts, dirs)))
    g_t, gpts, gdirs = _port_grads(tm, pts, dirs, compute_dx=True)
    want = dict(jax.tree_util.tree_leaves_with_path(gp))
    got = jax.tree_util.tree_leaves_with_path(g_t)
    assert len(got) == len(want) == 2 * len(tm.coarse.linears())
    for path, a in got:
        np.testing.assert_allclose(a, np.asarray(want[path]), rtol=5e-3, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    gx = np.asarray(gx)
    np.testing.assert_allclose(gpts.numpy(), gx[:, :3], rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(gdirs.numpy(), gx[:, 3:6], rtol=5e-3, atol=1e-4)
    assert np.abs(gx[:, :6]).max() > 0.0


def test_forward_and_gradients_match_jax_kernel_at_width_32():
    """netwidth = 32 (the view layer has 16 outputs): the forward and every
    dW, db and dX against the Pallas kernels, at the bounds above."""
    import jax
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.kernels.fused_mlp import fused_apply, pack_params

    spec, params, tm = _pair(width=32)
    pts, dirs = _points(200, seed=8)
    x = jnp.asarray(_x8(pts, dirs))
    want = fused_apply(spec, pack_params(spec, params), x)
    np.testing.assert_allclose(_port_raw(tm, pts, dirs).detach().numpy(),
                               np.asarray(want)[:, :4], rtol=1e-4, atol=1e-5)

    def loss(p, x):
        return jnp.sum(fused_apply(spec, pack_params(spec, p), x)[:, :4] ** 2)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, x)
    g_t, gpts, gdirs = _port_grads(tm, pts, dirs, compute_dx=True)
    want = dict(jax.tree_util.tree_leaves_with_path(gp))
    for path, a in jax.tree_util.tree_leaves_with_path(g_t):
        np.testing.assert_allclose(a, np.asarray(want[path]), rtol=5e-3, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    gx = np.asarray(gx)
    np.testing.assert_allclose(gpts.numpy(), gx[:, :3], rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(gdirs.numpy(), gx[:, 3:6], rtol=5e-3, atol=1e-4)


def test_without_dx_parameter_gradients_are_the_same():
    """compute_dx=False (the model path): the same parameter gradients, and
    no gradient reaches the points or the directions."""
    _, _, tm = _pair()
    pts, dirs = _points(128, seed=6)
    g_dx, gp_dx, _ = _port_grads(tm, pts, dirs, compute_dx=True)
    g_no, gp_no, gd_no = _port_grads(tm, pts, dirs, compute_dx=False)
    assert gp_dx is not None and gp_no is None and gd_no is None
    for level_a, level_b in zip(g_dx["pos_linears"], g_no["pos_linears"]):
        np.testing.assert_array_equal(level_a["w"], level_b["w"])
    for name in ("alpha_linear", "feature_linear", "dir_linear", "rgb_linear"):
        np.testing.assert_array_equal(g_dx[name]["w"], g_no[name]["w"])
        np.testing.assert_array_equal(g_dx[name]["b"], g_no[name]["b"])


def test_fused_query_matches_jax_fused_query():
    """NeRFModel.query with use_fused_kernel on both sides: the port's
    fused_mlp route (plain version on the CPU) against the JAX model's
    fused_apply (interpret mode)."""
    import jax
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.config import lego_hierarchical as j_lego
    from nerf_meets_mlx_tpu.models import create_nerf as j_create

    def small(cfg):
        mlp = dataclasses.replace(cfg.mlp, net_depth=4, net_width=64, skips=(2,))
        return cfg.replace(mlp=mlp, mlp_fine=mlp, use_fused_kernel=True)

    jm = j_create(small(j_lego()))
    params = jm.init(jax.random.PRNGKey(2))
    tm = t_create(small(t_lego()), device="cpu")
    interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tm)
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(16, 4, 3)).astype(np.float32)
    _, vd = _points(16, seed=8)
    LAUNCHES["mlp_fwd"] = 0
    for level in ("coarse", "fine"):
        want = jm.query(params, level, jnp.asarray(pts), jnp.asarray(vd))
        got = tm.query(level, torch.from_numpy(pts), torch.from_numpy(vd))
        assert got.shape == (16, 4, 4)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    assert LAUNCHES["mlp_fwd"] == 0  # the CPU runs the plain version


def _emulate_backward(mlp, pos_enc, dir_enc, pts, dirs, dout):
    """csrc/fused_mlp.cu's backward in torch, reading the weights from the
    buffer the kernel reads and writing dW into the layout it writes:
    (grads as ``_bwd_launch`` returns them, dX [N, 6])."""
    cfg = mlp.cfg
    D, W = cfg.net_depth, cfg.net_width
    WH = W // 2
    wbuf, offs = tfm.pack_mlp_weights(mlp, pos_enc, dir_enc, backward=True, compute_dx=True)
    n_skips = len(cfg.skips)
    assert len(offs) == 3 * D + 11 + 2 + n_skips and all(o % 4 == 0 for o in offs)

    def mat(i, rows, cols):
        return wbuf[offs[i] : offs[i] + rows * cols].reshape(rows, cols)

    def vec(i, n):
        return wbuf[offs[i] : offs[i] + n]

    pb, db = vec(2 * D + 8, pos_enc.n_freqs), vec(2 * D + 9, dir_enc.n_freqs)
    xp = sinusoidal_encode(pts, pb, pos_enc.include_input)
    xd = sinusoidal_encode(dirs, db, dir_enc.include_input)
    Pd, Dd = xp.shape[1], xd.shape[1]
    hs = [torch.relu(xp @ mat(0, Pd, W) + vec(1, W))]
    for j in range(1, D):
        if (j - 1) in cfg.skips:
            hs.append(torch.relu(torch.cat([xp, hs[-1]], -1) @ mat(2 * j, Pd + W, W)
                                 + vec(2 * j + 1, W)))
        else:
            hs.append(torch.relu(hs[-1] @ mat(2 * j, W, W) + vec(2 * j + 1, W)))
    feat = hs[-1] @ mat(2 * D + 2, W, W) + vec(2 * D + 3, W)
    hd = torch.relu(torch.cat([feat, xd], -1) @ mat(2 * D + 4, W + Dd, WH) + vec(2 * D + 5, WH))

    drgb, dalpha = dout[:, :3], dout[:, 3:]
    ddir = (drgb @ mat(2 * D + 6, WH, 3).t()) * (hd > 0)
    dfeat = ddir @ mat(3 * D + 10, WH, W)
    dzs = [None] * D
    dzs[D - 1] = (torch.cat([dfeat, dalpha], -1) @ mat(3 * D + 9, W + 1, W)) * (hs[-1] > 0)
    for j in range(D - 1, 0, -1):
        dzs[j - 1] = (dzs[j] @ mat(2 * D + 10 + j - 1, W, W)) * (hs[j - 1] > 0)

    # dS: the encoding rows of layer 0, the skip layers and the view layer
    o_dx = 3 * D + 11
    ngp, ngd = -(-Pd // 64), -(-Dd // 64)
    enc_layers = [0] + [s + 1 for s in sorted(cfg.skips)]
    dS_pos = sum(dzs[j] @ mat(o_dx + k, W, 64 * ngp)[:, :Pd] for k, j in enumerate(enc_layers))
    dS_dir = ddir @ mat(o_dx + 1 + n_skips, WH, 64 * ngd)[:, :Dd]

    def dx_of(x, dS, bands, inc):
        F = bands.shape[0]
        ph = x[..., None] * bands                                      # [N, 3, F]
        s = dS[:, : 3 * F].reshape(-1, 3, F) * torch.cos(ph)
        c = dS[:, 3 * F : 6 * F].reshape(-1, 3, F) * torch.cos(ph + np.pi / 2)
        out = ((s + c) * bands).sum(-1)
        return out + dS[:, 6 * F : 6 * F + 3] if inc else out

    dx = torch.cat([dx_of(pts, dS_pos, pb, pos_enc.include_input),
                    dx_of(dirs, dS_dir, db, dir_enc.include_input)], -1)

    dwbuf = torch.zeros(offs[2 * D + 8])

    def job(X, dZ, c_off, bias_off=None):
        blk = X.t() @ dZ
        dwbuf[c_off : c_off + blk.numel()] = blk.reshape(-1)
        if bias_off is not None:
            dwbuf[bias_off : bias_off + dZ.shape[1]] = dZ.sum(0)

    job(xp, dzs[0], offs[0], offs[1])
    for j in range(1, D):
        if (j - 1) in cfg.skips:
            job(xp, dzs[j], offs[2 * j], offs[2 * j + 1])
            job(hs[j - 1], dzs[j], offs[2 * j] + Pd * W)
        else:
            job(hs[j - 1], dzs[j], offs[2 * j], offs[2 * j + 1])
    job(hs[-1], dalpha, offs[2 * D], offs[2 * D + 1])
    job(hs[-1], dfeat, offs[2 * D + 2], offs[2 * D + 3])
    job(feat, ddir, offs[2 * D + 4], offs[2 * D + 5])
    job(xd, ddir, offs[2 * D + 4] + W * WH)
    job(hd, drgb, offs[2 * D + 6], offs[2 * D + 7])
    grads = []
    for i, (_, lin) in enumerate(mlp.linears()):
        fi, fo = lin.in_features, lin.out_features
        grads.append(dwbuf[offs[2 * i] : offs[2 * i] + fi * fo].view(fi, fo).t())
        grads.append(dwbuf[offs[2 * i + 1] : offs[2 * i + 1] + fo])
    return grads, dx


@pytest.mark.parametrize("shape", ["lego", "two_skips"])
def test_backward_algorithm_and_layout_match_autograd(shape):
    if shape == "lego":
        tm = t_create(t_lego(), device="cpu").init(torch.Generator().manual_seed(3))
    else:  # two skips, an encoding wider than 64 features (two dS column groups)
        mlp, pos, dir_ = _configs(depth=5, width=128, skips=(1, 3), pos_f=12, dir_f=4)
        cfg = t_lego().replace(pos_encoding=pos, dir_encoding=dir_, mlp=mlp, mlp_fine=mlp)
        tm = t_create(cfg, device="cpu").init(torch.Generator().manual_seed(4))
    mlp = tm.fine
    pts, dirs = (torch.from_numpy(a) for a in _points(40, seed=9))
    pts = pts * 0.5
    dout = torch.from_numpy(np.random.default_rng(10).normal(size=(40, 4)).astype(np.float32))
    with torch.no_grad():
        g_e, dx_e = _emulate_backward(mlp, tm.pos_enc, tm.dir_enc, pts, dirs, dout)
    p, d = pts.clone().requires_grad_(True), dirs.clone().requires_grad_(True)
    params = [q for _, lin in mlp.linears() for q in (lin.weight, lin.bias)]
    raw = tfm.fused_mlp_reference(mlp, tm.pos_enc, tm.dir_enc, p, d)
    g = torch.autograd.grad((raw * dout).sum(), params + [p, d])
    assert max(float(x.abs().max()) for x in g) > 0
    for i, (ge, ga) in enumerate(zip(g_e, g)):
        assert ge.shape == ga.shape
        torch.testing.assert_close(ge, ga, rtol=2e-4, atol=5e-6, msg=f"param {i}")
    torch.testing.assert_close(dx_e, torch.cat(g[-2:], -1), rtol=2e-4, atol=5e-5)


def test_cpu_call_runs_plain_and_launches_nothing():
    _, _, tm = _pair()
    pts, dirs = _points(33)
    LAUNCHES["mlp_fwd"] = LAUNCHES["mlp_bwd"] = 0
    got = _port_raw(tm, pts, dirs)
    want = tfm.fused_mlp_reference(
        tm.coarse, tm.pos_enc, tm.dir_enc, torch.from_numpy(pts), torch.from_numpy(dirs)
    )
    got.sum().backward()
    assert LAUNCHES["mlp_fwd"] == LAUNCHES["mlp_bwd"] == 0
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_other_devices_raise():
    _, _, tm = _pair()
    pts = torch.empty((8, 3), device="meta")
    with pytest.raises(ValueError):
        tfm.fused_mlp_apply(tm.coarse, tm.pos_enc, tm.dir_enc, pts, pts)


def _rel_close(got, want, rel):
    """max |got - want| <= rel * max |want| (and finite)."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    return bool(torch.isfinite(got).all()) and err <= rel * max(scale, 1e-30), err, scale


@pytest.mark.gpu
@pytest.mark.parametrize("width", [256, 128])
def test_cuda_kernels_match_plain(width):
    """Both kernels at full depth with the skip, 5,000 points (not a
    multiple of the forward's 128-point tile, nor of the backward's 64-point
    tile or 512-point block), both MLPs; the backward with compute_dx off
    and on."""
    _check_cuda_kernels(width)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [64, 32, 48, 96])
def test_cuda_kernels_match_plain_at_narrow_widths(width):
    """As test_cuda_kernels_match_plain at the widths the overlay key
    netwidth reaches below 128."""
    _check_cuda_kernels(width)


def _check_cuda_kernels(width):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = t_lego()
    mlp_cfg = dataclasses.replace(cfg.mlp, net_width=width)
    tm = t_create(cfg.replace(mlp=mlp_cfg, mlp_fine=mlp_cfg), device=dev).init(
        torch.Generator().manual_seed(0)
    )
    N = 5000
    pts, dirs = (torch.from_numpy(a).to(dev) for a in _points(N, seed=11))
    pts = pts * 0.8
    dout = torch.randn((N, 4), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    for level in ("coarse", "fine"):
        mlp = getattr(tm, level)
        params = [q for _, lin in mlp.linears() for q in (lin.weight, lin.bias)]
        with torch.no_grad():
            n0 = LAUNCHES["mlp_fwd"]
            raw = tfm.fused_mlp_apply(mlp, tm.pos_enc, tm.dir_enc, pts, dirs)
            torch.cuda.synchronize()
            assert LAUNCHES["mlp_fwd"] == n0 + 1
            raw_p = tfm.fused_mlp_reference(mlp, tm.pos_enc, tm.dir_enc, pts, dirs)
        # fp32 sums in another order than cuBLAS's (chip_smoke.py's bounds)
        torch.testing.assert_close(raw, raw_p, rtol=1e-4, atol=1e-4)
        for compute_dx in (False, True):
            p, d = pts.clone().requires_grad_(compute_dx), dirs.clone().requires_grad_(compute_dx)
            wrt = params + ([p, d] if compute_dx else [])
            n0 = LAUNCHES["mlp_bwd"]
            out = tfm.fused_mlp_apply(mlp, tm.pos_enc, tm.dir_enc, p, d, compute_dx=compute_dx)
            g = torch.autograd.grad((out * dout).sum(), wrt)
            torch.cuda.synchronize()
            assert LAUNCHES["mlp_bwd"] == n0 + 1
            out_p = tfm.fused_mlp_reference(mlp, tm.pos_enc, tm.dir_enc, p, d)
            g_p = torch.autograd.grad((out_p * dout).sum(), wrt)
            for i, (a, b) in enumerate(zip(g, g_p)):
                ok, err, scale = _rel_close(a, b, 1e-3)
                assert ok, (level, compute_dx, i, err, scale)


def _cuda_forward_case(width, N=40_000):
    """lego_occ's MLPs at ``width`` on the card (seeded init) and N points
    with view directions, and the same points with zero directions (the
    grid update's form). 40,000 points are 313 tiles of 128: two or three
    tiles a block of the 132-block persistent grid, the last ragged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    from nerf_meets_mlx_torch.config import lego_occ

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = lego_occ()
    mlp_cfg = dataclasses.replace(cfg.mlp, net_width=width)
    tm = t_create(cfg.replace(mlp=mlp_cfg, mlp_fine=mlp_cfg), device=dev).init(
        torch.Generator().manual_seed(0)
    )
    pts, dirs = (torch.from_numpy(a).to(dev) for a in _points(N, seed=13))
    pts = pts * 0.8
    return tm, [("dirs", pts, dirs), ("grid", pts, torch.zeros_like(dirs))]


@pytest.mark.gpu
@pytest.mark.parametrize("width", [256, 128, 64, 32, 48, 96])
def test_cuda_forward_kernel_matches_plain_tightly(width):
    """The forward kernel (csrc/mlp_fwd_tc.cu) at lego_occ's depth and skip,
    both MLPs, on ``_cuda_forward_case``'s points: one launch a call, raw
    within atol 1e-4 + rtol 1e-4 and within MLP_TIGHT (atol = rtol) of the
    fp32 plain version; each case's error is printed."""
    tm, sets = _cuda_forward_case(width)
    for level in ("coarse", "fine"):
        mlp = getattr(tm, level)
        for name, pts, dirs in sets:
            with torch.no_grad():
                n0 = LAUNCHES["mlp_fwd"]
                raw = tfm.fused_mlp_apply(mlp, tm.pos_enc, tm.dir_enc, pts, dirs)
                torch.cuda.synchronize()
                assert LAUNCHES["mlp_fwd"] == n0 + 1
                want = tfm.fused_mlp_reference(mlp, tm.pos_enc, tm.dir_enc, pts, dirs)
            over = _over(raw, want, MLP_TIGHT)
            print(f"[tf32] width {width} {level} {name}: max abs "
                  f"{float((raw - want).abs().max()):.3e}, {over:.3f} of MLP_TIGHT")
            torch.testing.assert_close(raw, want, rtol=1e-4, atol=1e-4)
            assert over <= 1.0, (level, name, over)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [256, 128, 64, 32])
def test_cuda_forward_kernel_runs_three_tf32_passes(width):
    """The forward kernel lies within MLP_TIGHT of plain, and the same
    source built with one TF32 product in place of three
    (``MLP_FWD_ONE_PASS``: hi·hi alone) lies outside it, on every case of
    ``_cuda_forward_case`` at the default build's widths: the tight
    tolerance tells the 3xTF32 kernel from a one-pass one (which can meet
    atol 1e-4 + rtol 1e-4). Both builds' errors are printed."""
    from nerf_meets_mlx_torch.kernels import _build

    tm, sets = _cuda_forward_case(width)
    one_pass = tfm.type_fwd_lib(_build.load_library(tfm.FWD_SOURCE, {"MLP_FWD_ONE_PASS": 1}))
    for level in ("coarse", "fine"):
        mlp = getattr(tm, level)
        for name, pts, dirs in sets:
            with torch.no_grad():
                three = tfm.fused_mlp_apply(mlp, tm.pos_enc, tm.dir_enc, pts, dirs)
                one = tfm._fwd_launch(mlp, tm.pos_enc, tm.dir_enc, pts, dirs, lib=one_pass)
                torch.cuda.synchronize()
                want = tfm.fused_mlp_reference(mlp, tm.pos_enc, tm.dir_enc, pts, dirs)
            over = {"3xTF32": _over(three, want, MLP_TIGHT), "one pass": _over(one, want, MLP_TIGHT)}
            print(f"[tf32] width {width} {level} {name}: " + ", ".join(
                f"{k} max abs {float((o - want).abs().max()):.3e} ({over[k]:.3f} of MLP_TIGHT)"
                for k, o in (("3xTF32", three), ("one pass", one))))
            assert over["3xTF32"] <= 1.0, over
            assert over["one pass"] > 1.0, over


@pytest.mark.gpu
def test_cuda_forward_kernel_is_deterministic():
    """No atomics: two launches on the same inputs give bit-identical raw."""
    tm, sets = _cuda_forward_case(256)
    _, pts, dirs = sets[0]
    with torch.no_grad():
        a = tfm.fused_mlp_apply(tm.fine, tm.pos_enc, tm.dir_enc, pts, dirs)
        b = tfm.fused_mlp_apply(tm.fine, tm.pos_enc, tm.dir_enc, pts, dirs)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
