"""The port's fused point-major MLP op (kernels/fused_mlp.py; the forward
kernel csrc/mlp_fwd_tc.cu, the backward csrc/mlp_bwd_tc.cu).

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
* The backward's arithmetic (``_emulate_backward``: B read from the weight
  images its pack kernel writes, every product in 3xTF32 with each k-step
  summed from zero and added in fp32, the feature-major workspace, dW by
  slices of 32 points and point ranges, the gradients in nn.Linear's
  layout) against autograd through the plain version and against the
  Pallas ``_bwd_kernel`` in interpret mode, where one TF32 pass misses the
  dW tolerance; its images' forward part against ``pack_eval_wgmma`` and
  their size and the shared-memory plans against the C formulas.
* The wrapper's routing: CPU tensors run the plain version and launch
  nothing; other devices raise.
* ``gpu``-marked: both CUDA kernels against the plain version at widths
  256, 128, 64, 32, 48 and 96 with a ragged point count; the forward
  kernel within ``MLP_TIGHT`` of plain at those widths, over several tiles
  a block, where the same source built with one TF32 pass
  (``MLP_FWD_ONE_PASS``) is not; one launch a call, bit-identical over two;
  the backward at lego_occ's fine shape within the gradient criterion
  (``fused_mlp.grad_check``) that its one-pass build (``MLP_BWD_ONE_PASS``)
  misses, bit-identical over two launches, its four kernels a call and
  nothing else (skipped where no card is present).
"""

import dataclasses

import numpy as np
import pytest
import torch

from nerf_meets_mlx_torch import interop
from nerf_meets_mlx_torch.config import EncodingConfig, MLPConfig
from nerf_meets_mlx_torch.config import lego_hierarchical as t_lego
from nerf_meets_mlx_torch.kernels import fused_mlp as tfm
from nerf_meets_mlx_torch.kernels import fused_train as tft
from nerf_meets_mlx_torch.kernels.fused_train import LAUNCHES
from nerf_meets_mlx_torch.models import create_nerf as t_create
from tf32_products import _mm_1xtf32, _split, mm_wgmma, mm_wgmma_runs
from torch_threads import one_torch_thread_per_worker  # noqa: F401  (autouse fixture)

# The tight tolerance (atol = rtol) of the forward kernel's raw against the
# fp32 plain version, as chip_smoke.py's MLP_TIGHT: its 3xTF32 products
# meet it, one TF32 pass does not (which meets atol 1e-4 + rtol 1e-4 at
# most shapes). The emulation below puts 3xTF32 at 0.13-0.38 of 1e-6 and
# one pass at 42-110 times 1e-6 at widths 32-256 (lego_occ's 8 layers).
MLP_TIGHT = 5e-6
# chip_smoke.py's DW_REL: the bound of a gradient array against the fp32
# plain version that fused_mlp.grad_check takes first
DW_REL = 1e-3

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


# csrc/mlp_bwd_tc.cu's tile: the workspace holds N rounded up to 128 points
_TILE = 128


def _dx_cols(dim):
    return 64 if dim <= 64 else 128


def _bwd_segments(mlp, pos_enc, dir_enc, compute_dx):
    """The B operands csrc/mlp_bwd_tc.cu's tile kernel streams, in its order
    (``make_plan``): (M, np) with B[k][n] = M[n][k], np the product's
    columns. The forward reads M = weight ([fan_out][fan_in]), the
    cotangent and dS products M = weight^T."""
    cfg = mlp.cfg
    D, W = cfg.net_depth, cfg.net_width
    P = pos_enc.out_dim
    w = [lin.weight.detach() for _, lin in mlp.linears()]

    def skip(j):
        return (j - 1) in cfg.skips

    fwd = [(w[0], W)]
    for j in range(1, D):
        fwd += [(w[j][:, :P], W), (w[j][:, P:], W)] if skip(j) else [(w[j], W)]
    fwd += [(w[D + 1], W), (w[D + 2][:, :W], W // 2), (w[D + 2][:, W:], W // 2)]
    bwd = []
    if compute_dx:
        bwd.append((w[D + 2][:, W:].t(), _dx_cols(dir_enc.out_dim)))
    bwd += [(w[D + 2][:, :W].t(), W), (w[D + 1].t(), W)]
    for j in range(D - 1, 0, -1):
        if skip(j):
            if compute_dx:
                bwd.append((w[j][:, :P].t(), _dx_cols(P)))
            bwd.append((w[j][:, P:].t(), W))
        else:
            bwd.append((w[j].t(), W))
    if compute_dx:
        bwd.append((w[0].t(), _dx_cols(P)))
    return fwd, bwd


def _bwd_image(segments):
    """The weight images as mlp_bwd_pack_kernel writes them: per segment
    its M padded to np rows, each k-step's TF32 hi then lo image in the
    wgmma core-matrix layout (``fused_train._wgmma_image``)."""
    pieces = []
    for M, np_ in segments:
        Mp = torch.nn.functional.pad(M.contiguous(), (0, 0, 0, np_ - M.shape[0]))
        pieces.append(tft._wgmma_image(Mp, [M.shape[1]]))
    return torch.cat(pieces)


# the wgmma K order of a k-step (fused_train.WGMMA_K_ORDER) inverted: row f
# of the step sits at position _K_INV[f]
_K_INV = [tft.WGMMA_K_ORDER.index(f) for f in range(8)]


def _image_b(img, segments):
    """Each segment's B [8·steps, np] read back from the images: (hi, lo),
    the rows in natural order."""
    out, at = [], 0
    for M, np_ in segments:
        steps = -(-M.shape[1] // 8)
        x = img[at : at + 16 * np_ * steps].reshape(steps, 2, 2, np_ // 8, 8, 4)
        at += 16 * np_ * steps
        # [step][hi/lo][K half][N/8][8 of N][4 of K] -> [hi/lo][step][K position][N]
        x = x.permute(1, 0, 2, 5, 3, 4).reshape(2, steps, 8, np_)[:, :, _K_INV]
        out.append(tuple(x.reshape(2, 8 * steps, np_)))
    assert at == img.numel()
    return out


def _emulate_backward(mlp, pos_enc, dir_enc, pts, dirs, dout, passes=3):
    """csrc/mlp_bwd_tc.cu's arithmetic in torch: (grads as ``_bwd_launch``
    returns them, dX [N, 6]). The points padded to whole tiles (dout 0
    there); every dense product reads its B from the weight images the pack
    kernel writes (``_bwd_image``) and runs as ``mm_wgmma_runs`` (3xTF32,
    each k-step summed from zero and added in fp32; ``passes=1``: hi·hi
    alone); every layer's input and dZ go to a feature-major workspace;
    dW = X^T dZ from it per product (``make_plan``'s jobs), each slice of 32
    points summed from zero, the point ranges of DW_SPLIT_POINTS added in
    order; the heads, the biases and dX in fp32. Also returns the
    workspace [rows, N padded to 128] and the image floats before it."""
    cfg = mlp.cfg
    D, W = cfg.net_depth, cfg.net_width
    WH = W // 2
    P, Dd = pos_enc.out_dim, dir_enc.out_dim
    lins = [lin for _, lin in mlp.linears()]
    N = pts.shape[0]
    npad = -(-N // _TILE) * _TILE
    pts = torch.nn.functional.pad(pts, (0, 0, 0, npad - N))
    dirs = torch.nn.functional.pad(dirs, (0, 0, 0, npad - N))
    dout = torch.nn.functional.pad(dout, (0, 0, 0, npad - N))
    segs = _bwd_segments(mlp, pos_enc, dir_enc, True)
    bs = iter(_image_b(_bwd_image(segs[0] + segs[1]), segs[0] + segs[1]))

    def gemm(inputs, ncols):
        """[inputs] (each zero-padded to whole k-steps) times the next
        len(inputs) segments' B, the first ncols columns."""
        a = torch.cat([_pad8(x) for x in inputs], 1)
        b = [next(bs) for _ in inputs]
        bh, bl = torch.cat([x[0] for x in b]), torch.cat([x[1] for x in b])
        return mm_wgmma_runs(a, bh, bl, 1, passes)[:, :ncols]

    def bias(i):
        return lins[i].bias.detach()

    xp, xd = pos_enc.apply(pts), dir_enc.apply(dirs)
    rows, n_rows = tfm.bwd_ws_rows(mlp, pos_enc, dir_enc)
    ws = torch.zeros((n_rows, npad))

    def put(name, x, at=0):
        ws[rows[name] + at : rows[name] + at + x.shape[1]] = x.t()

    put("encP", xp)
    put("encD", xd)
    put("dout", dout)
    # the forward again
    hs = []
    for j in range(D):
        x = [xp] if j == 0 else ([xp, hs[-1]] if (j - 1) in cfg.skips else [hs[-1]])
        hs.append(torch.relu(gemm(x, W) + bias(j)))
        put("h", hs[-1], j * W)
    feat = gemm([hs[-1]], W) + bias(D + 1)
    put("feat", feat)
    zv = gemm([feat, xd], WH) + bias(D + 2)
    put("hd", torch.relu(zv))
    # the backward: the rgb head on the CUDA cores, then the products
    wr, wa = lins[D + 3].weight.detach(), lins[D].weight.detach()
    ddir = (dout[:, :3] @ wr) * (zv > 0)
    put("ddir", ddir)

    def dx_of(x, dS, bands, inc):  # sum over features of d(feature)/dx * dS
        F = bands.shape[0]
        ph = x[..., None] * bands                                      # [N, 3, F]
        s = dS[:, : 3 * F].reshape(-1, 3, F) * torch.cos(ph)
        c = dS[:, 3 * F : 6 * F].reshape(-1, 3, F) * torch.cos(ph + np.pi / 2)
        out = ((s + c) * bands).sum(-1)
        return out + dS[:, 6 * F : 6 * F + 3] if inc else out

    pb, db = tfm._bands(pos_enc, pts.device), tfm._bands(dir_enc, pts.device)
    dx_dir = dx_of(dirs, gemm([ddir], Dd), db, dir_enc.include_input)
    dfeat = gemm([ddir], W)
    put("dfeat", dfeat)
    dz = [None] * D
    dz[D - 1] = (gemm([dfeat], W) + dout[:, 3:] * wa) * (hs[-1] > 0)
    put("dz", dz[D - 1], (D - 1) * W)
    dx_pos = torch.zeros((npad, 3))
    for j in range(D - 1, 0, -1):
        if (j - 1) in cfg.skips:
            dx_pos = dx_pos + dx_of(pts, gemm([dz[j]], P), pb, pos_enc.include_input)
        dz[j - 1] = gemm([dz[j]], W) * (hs[j - 1] > 0)
        put("dz", dz[j - 1], (j - 1) * W)
    dx_pos = dx_pos + dx_of(pts, gemm([dz[0]], P), pb, pos_enc.include_input)
    assert next(bs, None) is None  # every image segment read, in order
    dx = torch.cat([dx_pos, dx_dir], -1)[:N]

    # dW = X^T dZ per product, from the workspace
    offs, n_dw = tfm.grad_offsets(mlp)
    flat = torch.zeros(n_dw)

    def job(x_row, m, z_row, n, lin, ldo, col0, with_bias):
        X, Z = ws[x_row : x_row + m], ws[z_row : z_row + n]
        dw = torch.zeros((m, n))
        dbias = torch.zeros(n)
        for p0 in range(0, npad, tft.DW_SPLIT_POINTS):
            s = slice(p0, min(npad, p0 + tft.DW_SPLIT_POINTS))
            zh, zl = _split(Z[:, s].t().contiguous())
            dw = dw + mm_wgmma_runs(X[:, s], zh, zl, 4, passes)
            dbias = dbias + Z[:, s].sum(1)
        o = lins[lin].out_features
        flat[offs[2 * lin] : offs[2 * lin] + o * ldo].view(o, ldo)[:, col0 : col0 + m] = dw.t()
        if with_bias:
            flat[offs[2 * lin + 1] : offs[2 * lin + 1] + o] = dbias

    r = rows
    job(r["encP"], P, r["dz"], W, 0, P, 0, True)
    for j in range(1, D):
        dzr, hprev = r["dz"] + j * W, r["h"] + (j - 1) * W
        if (j - 1) in cfg.skips:
            job(r["encP"], P, dzr, W, j, P + W, 0, True)
            job(hprev, W, dzr, W, j, P + W, P, False)
        else:
            job(hprev, W, dzr, W, j, W, 0, True)
    h_last = r["h"] + (D - 1) * W
    job(h_last, W, r["dout"] + 3, 1, D, W, 0, True)
    job(h_last, W, r["dfeat"], W, D + 1, W, 0, True)
    job(r["feat"], W, r["ddir"], WH, D + 2, W + Dd, 0, True)
    job(r["encD"], Dd, r["ddir"], WH, D + 2, W + Dd, W, False)
    job(r["hd"], WH, r["dout"], 3, D + 3, WH, 0, True)
    grads = []
    for i, lin in enumerate(lins):
        grads.append(flat[offs[2 * i] : offs[2 * i] + lin.weight.numel()].view_as(lin.weight))
        grads.append(flat[offs[2 * i + 1] : offs[2 * i + 1] + lin.bias.numel()])
    return grads, dx, ws, sum(16 * np_ * -(-M.shape[1] // 8) for M, np_ in segs[0] + segs[1])


@pytest.mark.parametrize("shape", ["lego", "two_skips"])
def test_backward_algorithm_and_layout_match_autograd(shape):
    """csrc/mlp_bwd_tc.cu's arithmetic and layouts (``_emulate_backward``:
    the weight images, the feature-major workspace, dW's products and
    point ranges, the gradients in nn.Linear's layout) against autograd
    through the fp32 plain version, dX included."""
    if shape == "lego":
        tm = t_create(t_lego(), device="cpu").init(torch.Generator().manual_seed(3))
    else:  # two skips, an encoding wider than 64 features (dS of 128 columns)
        mlp, pos, dir_ = _configs(depth=5, width=128, skips=(1, 3), pos_f=12, dir_f=4)
        cfg = t_lego().replace(pos_encoding=pos, dir_encoding=dir_, mlp=mlp, mlp_fine=mlp)
        tm = t_create(cfg, device="cpu").init(torch.Generator().manual_seed(4))
    mlp = tm.fine
    pts, dirs = (torch.from_numpy(a) for a in _points(40, seed=9))
    pts = pts * 0.5
    dout = torch.from_numpy(np.random.default_rng(10).normal(size=(40, 4)).astype(np.float32))
    with torch.no_grad():
        g_e, dx_e, _, _ = _emulate_backward(mlp, tm.pos_enc, tm.dir_enc, pts, dirs, dout)
    p, d = pts.clone().requires_grad_(True), dirs.clone().requires_grad_(True)
    params = [q for _, lin in mlp.linears() for q in (lin.weight, lin.bias)]
    raw = tfm.fused_mlp_reference(mlp, tm.pos_enc, tm.dir_enc, p, d)
    g = torch.autograd.grad((raw * dout).sum(), params + [p, d])
    assert max(float(x.abs().max()) for x in g) > 0
    for i, (ge, ga) in enumerate(zip(g_e, g)):
        assert ge.shape == ga.shape
        torch.testing.assert_close(ge, ga, rtol=2e-4, atol=5e-6, msg=f"param {i}")
    torch.testing.assert_close(dx_e, torch.cat(g[-2:], -1), rtol=2e-4, atol=5e-5)


def _worst_over(got, want, rtol, atol):
    """max |got - want| / (atol + rtol·|want|) over the arrays: at most 1
    within the tolerance."""
    return max(float(((a - b).abs() / (atol + rtol * b.abs())).max()) for a, b in zip(got, want))


@pytest.mark.parametrize("width,skips", [(64, (2,)), (128, (1, 3))])
def test_backward_arithmetic_matches_jax_kernel(width, skips):
    """The backward's 3xTF32 arithmetic (``_emulate_backward``) at depth 5,
    with one or two skips and 12 / 4 bands (75 position features, 27
    direction), 200 points (a ragged tile), on the JAX weights: every dW and
    db of Σ dout · raw within rtol 2e-4 / atol 5e-6 of jax.grad through the
    Pallas ``_bwd_kernel`` in interpret mode, and dX as
    test_gradients_match_jax_kernel holds it; the same emulation with one
    TF32 pass (the ``MLP_BWD_ONE_PASS`` build's arithmetic) misses the dW
    tolerance. Both distances are printed."""
    import jax
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.kernels.fused_mlp import fused_apply, pack_params

    spec, params, tm = _pair(depth=5, width=width, skips=skips, pos_f=12, dir_f=4)
    assert tm.pos_enc.out_dim == 75 and tm.dir_enc.out_dim == 27
    pts, dirs = _points(200, seed=21)
    dout = np.random.default_rng(22).normal(size=(200, 4)).astype(np.float32)

    def loss(p, x):
        return jnp.sum(fused_apply(spec, pack_params(spec, p), x)[:, :4] * dout)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(_x8(pts, dirs)))
    want = []
    for name, lin in tm.coarse.linears():
        leaf = (gp["pos_linears"][int(name.split(".")[1])] if name.startswith("pos_linears.")
                else gp[name])
        want += [torch.from_numpy(np.asarray(leaf["w"]).T.copy()),
                 torch.from_numpy(np.asarray(leaf["b"]).copy())]
    args = (tm.coarse, tm.pos_enc, tm.dir_enc, torch.from_numpy(pts), torch.from_numpy(dirs),
            torch.from_numpy(dout))
    with torch.no_grad():
        three, dx3, _, _ = _emulate_backward(*args)
        one = _emulate_backward(*args, passes=1)[0]
    over = {"3xTF32": _worst_over(three, want, 2e-4, 5e-6), "one pass": _worst_over(one, want, 2e-4, 5e-6)}
    print(f"[tf32] backward width {width} skips {skips}: dW over rtol 2e-4 / atol 5e-6 {over}")
    for i, (a, b) in enumerate(zip(three, want)):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=5e-6, msg=f"param {i}")
    gx = torch.from_numpy(np.asarray(gx)[:, :6].copy())
    torch.testing.assert_close(dx3, gx, rtol=5e-3, atol=1e-4)
    assert float(gx.abs().max()) > 0
    assert over["one pass"] > 1.0, over


def test_relu_reference_and_workspace_masks():
    """``relu_reference`` with the plain version's own relu decisions
    (``relu_decisions``) is the plain version, values and gradients; its
    margin leaves few decisions open to rounding; and ``workspace_masks``
    reads the kernel's decisions from the rows of the workspace where
    ``_emulate_backward`` lays out h_j and the view layer's output, after
    the weight images (rounded up to 32 floats)."""
    import types

    mlp, pos, dir_ = _configs(depth=4, width=64, skips=(1,))
    cfg = t_lego().replace(pos_encoding=pos, dir_encoding=dir_, mlp=mlp, mlp_fine=mlp)
    tm = t_create(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    mlp = tm.fine
    pts, dirs = (torch.from_numpy(a) for a in _points(150, seed=23))
    dout = torch.from_numpy(np.random.default_rng(24).normal(size=(150, 4)).astype(np.float32))
    dec = tfm.relu_decisions(mlp, tm.pos_enc, tm.dir_enc, pts, dirs, 1e-5)
    assert len(dec) == mlp.cfg.net_depth + 1
    assert all(bool(sure.float().mean() > 0.99) for _, sure in dec)
    params = [q for _, lin in mlp.linears() for q in (lin.weight, lin.bias)]
    raw = tfm.relu_reference(mlp, tm.pos_enc, tm.dir_enc, pts, dirs, [on for on, _ in dec])
    want = tfm.fused_mlp_reference(mlp, tm.pos_enc, tm.dir_enc, pts, dirs)
    torch.testing.assert_close(raw, want, rtol=0, atol=0)
    for a, b in zip(torch.autograd.grad((raw * dout).sum(), params),
                    torch.autograd.grad((want * dout).sum(), params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with torch.no_grad():
        _, _, ws, img = _emulate_backward(mlp, tm.pos_enc, tm.dir_enc, pts, dirs, dout)
        scratch = torch.cat([torch.full((-(-img // 32) * 32,), float("nan")), ws.reshape(-1)])
        lib = types.SimpleNamespace(mlp_bwd_tc_image_floats=lambda *a: img)
        masks = tfm.workspace_masks(mlp, tm.pos_enc, tm.dir_enc, 150, scratch, True, lib=lib)
    assert [tuple(m.shape) for m in masks] == [(150, 64)] * 4 + [(150, 32)]
    for m, (on, sure) in zip(masks, dec):
        assert bool(((m == on) | ~sure).all())


def _criterion_arrays():
    """(fp32 plain, float64) gradient arrays made with numpy: [64, 48] and
    [48], float64 within 1e-7 of fp32."""
    rng = np.random.default_rng(31)
    g64 = [torch.from_numpy(rng.normal(size=s)) for s in ((64, 48), (48,))]
    g_p = [(a * (1 + 1e-7 * torch.from_numpy(rng.normal(size=a.shape)))).float() for a in g64]
    return g_p, g64


@pytest.mark.parametrize("case,want", [
    ("plain", ["i", "i"]),
    ("flip", ["ii", "i"]),
    ("flip_loose", ["no", "i"]),
    ("flip_far_decision", ["no", "i"]),
    ("flip_near_at_bound", ["ii", "i"]),
    ("flip_many_near", ["no", "i"]),
    ("not_finite", ["no", "i"]),
])
def test_gradient_criterion(case, want):
    """``grad_criteria``: an array within DW_REL of the fp32 plain version
    is held by "i"; one that misses it (a relu decision taken the other way
    moves a unit's share of it) only by "ii": within GRAD_TIGHT of float64
    with the kernel's decisions, none of them apart from float64's beyond
    the margin, and those inside it at most NEAR_FACTOR times the fp32 plain
    version's plus NEAR_SLACK."""
    g_p, g64 = _criterion_arrays()
    g_k = [a.clone() for a in g_p]
    apart, near, plain_near = 0, 3, 2
    if case != "plain":
        # a decision the other way than cuBLAS's: 5e-3 of the array moves,
        # the kernel's arithmetic within 1e-6 of float64 with its decisions
        g64[0][3, :] += 5e-3 * float(g64[0].abs().max())
        g_k[0] = (g64[0] * (1 + 1e-6)).float()
    if case == "flip_loose":
        g_k[0][0, 0] += 2 * tfm.GRAD_TIGHT * float(g64[0].abs().max())
    if case == "flip_far_decision":
        apart = 1
    if case in ("flip_near_at_bound", "flip_many_near"):
        near = int(tfm.NEAR_FACTOR * plain_near) + tfm.NEAR_SLACK + (case == "flip_many_near")
    if case == "not_finite":
        g_k[0][1, 1] = float("nan")
    by, r32, r64 = tfm.grad_criteria(g_k, g_p, g64, apart, near, plain_near, DW_REL)
    assert by == want, (by, r32, r64)


@pytest.mark.parametrize("passes", [3, 1], ids=["3xTF32", "one_pass"])
def test_grad_reference_holds_the_emulated_backward(passes):
    """``grad_reference`` and ``grad_criteria`` on the backward's emulated
    arithmetic (``_emulate_backward``) and its workspace, read back by
    ``workspace_masks`` as ``grad_check`` reads the card's: 3xTF32 takes no
    relu decision apart from float64's beyond the margin and meets the
    criterion, every array within GRAD_TIGHT of float64 with its own
    decisions; one TF32 pass lies beyond GRAD_TIGHT there."""
    import types

    mlp, pos, dir_ = _configs(depth=5, width=64, skips=(1, 3))
    cfg = t_lego().replace(pos_encoding=pos, dir_encoding=dir_, mlp=mlp, mlp_fine=mlp)
    tm = t_create(cfg, device="cpu").init(torch.Generator().manual_seed(7))
    mlp = tm.fine
    N = 300
    pts, dirs = (torch.from_numpy(a) for a in _points(N, seed=29))
    dout = torch.from_numpy(np.random.default_rng(30).normal(size=(N, 4)).astype(np.float32))
    with torch.no_grad():
        grads, dx, ws, img = _emulate_backward(mlp, tm.pos_enc, tm.dir_enc, pts, dirs, dout,
                                               passes=passes)
        scratch = torch.cat([torch.full((-(-img // 32) * 32,), float("nan")), ws.reshape(-1)])
        lib = types.SimpleNamespace(mlp_bwd_tc_image_floats=lambda *a: img)
        masks = tfm.workspace_masks(mlp, tm.pos_enc, tm.dir_enc, N, scratch, True, lib=lib)
    g_k = list(grads) + [dx[:, :3], dx[:, 3:]]
    p, d = pts.clone().requires_grad_(True), dirs.clone().requires_grad_(True)
    out = tfm.fused_mlp_reference(mlp, tm.pos_enc, tm.dir_enc, p, d)
    g_p = torch.autograd.grad((out * dout).sum(), tfm._params(mlp) + [p, d])
    g64, apart, near, plain_near = tfm.grad_reference(mlp, tm.pos_enc, tm.dir_enc, pts, dirs,
                                                      dout, True, masks)
    by, r32, r64 = tfm.grad_criteria(g_k, g_p, g64, apart, near, plain_near, DW_REL)
    print(f"[grad] emulated {passes} pass(es): held by {' '.join(by)}; against float64 "
          + " ".join(f"{r:.1e}" for r in r64)
          + f"; decisions apart {near} (fp32 plain {plain_near}), {apart} beyond the margin")
    if passes == 3:
        assert apart == 0 and "no" not in by, (by, r64, apart, near)
        assert max(r64) <= tfm.GRAD_TIGHT, r64
    else:
        assert max(r64) > tfm.GRAD_TIGHT, r64


def test_backward_images_and_smem_plan_match_the_kernel():
    """The backward's weight images: their forward part is
    ``pack_eval_wgmma``'s buffer bit for bit (the layout the forward kernel
    reads), and their size is ``mlp_bwd_tc_image_floats``' (per segment its
    k-steps x 16 x np floats: the forward's, then with compute_dx a dS
    product a skip layer, layer 0 and the view layer, np 64 or 128), at
    every depth, skip set and band count the wrapper takes; the tile
    kernel's shared memory (4 stages of 16 x max(W, 128) floats, a 128 x
    (W + 8) activation tile, 8 mbarriers, 128 x 16 floats of points) and the
    dW kernel's (three stages of 128 rows of 36 floats of X and of the 4
    k-steps' hi / lo images of 128 dZ rows, 256 floats of row sums) fit a
    block at every width."""
    def image_floats(D, W, skips, P, Dd, dx):
        k = -(-P // 8)
        steps = k + W // 8 + sum(W // 8 + (k if (j - 1) in skips else 0) for j in range(1, D))
        fwd = steps * 16 * W + (W // 8 + -(-Dd // 8)) * 16 * (W // 2)
        bwd = (W // 16 + W // 8 + (D - 1) * W // 8) * 16 * W
        if dx:
            bwd += W // 16 * 16 * _dx_cols(Dd) + (1 + len(skips)) * W // 8 * 16 * _dx_cols(P)
        return fwd + bwd

    for depth, width, skips, pos_f, dir_f in ((2, 32, (), 4, 2), (4, 48, (1, 2), 6, 3),
                                              (8, 64, (4,), 10, 4), (5, 96, (1, 3), 12, 4),
                                              (17, 32, (3, 9, 15), 2, 1)):
        mlp, pos, dir_ = _configs(depth=depth, width=width, skips=skips, pos_f=pos_f, dir_f=dir_f)
        cfg = t_lego().replace(pos_encoding=pos, dir_encoding=dir_, mlp=mlp, mlp_fine=mlp)
        tm = t_create(cfg, device="cpu").init(torch.Generator().manual_seed(1))
        P, Dd = tm.pos_enc.out_dim, tm.dir_enc.out_dim
        for dx in (False, True):
            fwd, bwd = _bwd_segments(tm.coarse, tm.pos_enc, tm.dir_enc, dx)
            assert len(fwd) + len(bwd) <= 80  # MAX_SEGS
            img = _bwd_image(fwd + bwd)
            assert img.numel() == image_floats(depth, width, skips, P, Dd, dx)
            n_fwd = _bwd_image(fwd).numel()
            torch.testing.assert_close(img[:n_fwd], tft.pack_eval_wgmma(tm.coarse, tm.pos_enc,
                                                                       tm.dir_enc), rtol=0, atol=0)
    for width in range(32, 257, 16):
        smem = 4 * (4 * 16 * max(width, 128) + 128 * (width + 8)) + 8 * 8 + 4 * 128 * 16
        assert smem <= 232448, (width, smem)
    assert 4 * (3 * (128 * 36 + 64 * 128) + 256) <= 232448


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


@pytest.mark.gpu
@pytest.mark.parametrize("width", [256, 128])
def test_cuda_kernels_match_plain(width):
    """Both kernels at full depth with the skip, 5,000 points (not a
    multiple of either kernel's 128-point tile), both MLPs; the backward
    with compute_dx off and on, every dW, db and dX held to
    ``fused_mlp.grad_check``."""
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
            check = tfm.grad_check(mlp, tm.pos_enc, tm.dir_enc, pts, dirs, dout, compute_dx, g,
                                   DW_REL)
            print(f"[grad] width {width} {level} dx={int(compute_dx)}: {check.describe()}")
            assert check.ok, (level, compute_dx, check.describe())


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


def _cuda_backward_case(N=4096 * 96):
    """lego_occ's fine MLP on the card (seeded init), lego_occ's fine
    shape's 393,216 points (``_points``, seed 13, scaled 0.8) and a random
    dout."""
    tm, sets = _cuda_forward_case(256, N)
    _, pts, dirs = sets[0]
    dout = torch.randn((N, 4), generator=torch.Generator(device=pts.device).manual_seed(3),
                       device=pts.device)
    return tm, pts, dirs, dout


@pytest.mark.gpu
def test_cuda_backward_runs_three_tf32_passes():
    """The backward's 3xTF32 build meets ``fused_mlp.grad_check`` at
    lego_occ's fine shape, and the same source built with one TF32 product
    in place of three (``MLP_BWD_ONE_PASS``: hi·hi alone) misses it, and
    lies beyond GRAD_TIGHT of float64 with its own relu decisions on some
    array. Both builds' readings are printed."""
    from nerf_meets_mlx_torch.kernels import _build

    tm, pts, dirs, dout = _cuda_backward_case()
    one_pass = tfm.type_bwd_lib(_build.load_library(tfm.BWD_SOURCE, {"MLP_BWD_ONE_PASS": 1}))
    checks = {}
    for name, lib in (("3xTF32", None), ("one pass", one_pass)):
        g, _ = tfm._bwd_launch(tm.fine, tm.pos_enc, tm.dir_enc, pts, dirs, dout, False, lib=lib)
        checks[name] = tfm.grad_check(tm.fine, tm.pos_enc, tm.dir_enc, pts, dirs, dout, False, g,
                                      DW_REL, lib=lib)
        print(f"[tf32] backward {name}: {checks[name].describe()}")
        assert checks[name].same
    assert checks["3xTF32"].ok, checks["3xTF32"].describe()
    assert not checks["one pass"].ok
    # the one-pass build misses GRAD_TIGHT itself, not only the decisions
    assert max(checks["one pass"].r64) > tfm.GRAD_TIGHT, checks["one pass"].r64


@pytest.mark.gpu
def test_cuda_backward_is_deterministic():
    """No atomics: two backward calls on the same inputs give bit-identical
    gradients and dX."""
    tm, pts, dirs, dout = _cuda_backward_case(4096 * 32)
    a, xa = tfm._bwd_launch(tm.fine, tm.pos_enc, tm.dir_enc, pts, dirs, dout, True)
    b, xb = tfm._bwd_launch(tm.fine, tm.pos_enc, tm.dir_enc, pts, dirs, dout, True)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(xa, xb)


@pytest.mark.gpu
def test_cuda_backward_launches_as_designed():
    """A backward call launches csrc/mlp_bwd_tc.cu's four kernels, the
    weight-image pack, the tile kernel, dW and the reduction, once each,
    and nothing else on the device (no host pack, no copy of the
    gradients); ``LAUNCHES["mlp_bwd"]`` counts it once."""
    from torch.profiler import ProfilerActivity, profile

    tm, pts, dirs, dout = _cuda_backward_case(4096 * 32)
    call = lambda: tfm._bwd_launch(tm.fine, tm.pos_enc, tm.dir_enc, pts, dirs, dout, False)  # noqa: E731
    call()
    torch.cuda.synchronize()
    n0 = LAUNCHES["mlp_bwd"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    assert LAUNCHES["mlp_bwd"] == n0 + 1
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)]
    kinds = sorted(k for k in ("pack", "tile", "dw", "reduce") for n in names
                   if f"mlp_bwd_{k}_kernel" in n)
    assert kinds == ["dw", "pack", "reduce", "tile"], names
    assert len(names) == 4, names
