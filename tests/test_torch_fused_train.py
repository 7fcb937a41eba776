"""The port's fused train op (kernels/fused_train.py, csrc/fused_train.cu).

* Its plain version against the JAX ``fused_train_apply``, which runs the
  Pallas ``_train_kernel`` in interpret mode here (rays_block 8, so R = 10
  pads), and against the JAX twin ``fused_train_reference``, on the same
  weights (via ``interop``) and inputs: values at rtol 1e-5 / atol 1e-6,
  every dW and db at rtol 2e-4 / atol 5e-6 (the JAX kernel-vs-twin bounds).
* The CUDA kernel's algorithm replayed in torch from the buffer it reads
  (``pack_train_weights``) and into the dW layout it writes: the closed-form
  compositing backward, the transposed backward matrices and the per-job
  dW blocks, against autograd through the plain version.
* The kernel's precision: the same algorithm with its tensor-core products
  in emulated 3xTF32 holds the card's tolerances at lego_hierarchical's
  width; one TF32 pass lands further off.
* The wrapper's routing: CPU tensors run the plain version and launch
  nothing; other devices raise.
* ``gpu``-marked: the CUDA kernel against the plain version at S = 64, 192
  and 1024 (one ray a block), widths 256 and 128, and at the narrow widths;
  two launches on the same inputs give bit-identical results (skipped
  where no card is present).
"""

import dataclasses

import numpy as np
import pytest
import torch

from nerf_meets_mlx_torch import interop
from nerf_meets_mlx_torch.config import lego_hierarchical as t_lego
from nerf_meets_mlx_torch.encoding.sinusoidal import sinusoidal_encode
from nerf_meets_mlx_torch.kernels import fused_train as tft
from nerf_meets_mlx_torch.models import create_nerf as t_create
from nerf_meets_mlx_torch.rendering.volume import exclusive_cumsum
from tf32_products import _mm_1xtf32, _mm_3xtf32, _tf32
from torch_threads import one_torch_thread_per_worker  # noqa: F401  (autouse fixture)

VAL_RTOL, VAL_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 2e-4, 5e-6

# JAX is imported by the tests that compare with it, not at module level:
# the gpu-marked tests run on the card's machine, which has no JAX
# (python -m pytest --noconftest -m gpu tests/test_torch_fused_train.py).

MODES = [
    ("canonical", "softplus", True),
    ("canonical", "relu", False),
    ("reference", "softplus", False),
    ("reference", "softplus", True),
]


def _narrow(cfg, width):
    """``cfg`` with both MLPs at ``width`` (None: as published)."""
    if width is None:
        return cfg
    mlp = dataclasses.replace(cfg.mlp, net_width=width)
    return cfg.replace(mlp=mlp, mlp_fine=mlp)


def _models(seed=0, width=None):
    import jax

    from nerf_meets_mlx_tpu.config import lego_hierarchical as j_lego
    from nerf_meets_mlx_tpu.models import create_nerf as j_create

    jcfg = _narrow(j_lego(), width)
    params = j_create(jcfg).init(jax.random.PRNGKey(seed))
    tm = t_create(_narrow(t_lego(), width), device="cpu")
    interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tm)
    return jcfg, params, tm


def _inputs(R, S, noise=0.01, seed=0):
    """rays_o, rays_d, viewdirs, z, deltas, noise, target as numpy, drawn as
    the JAX package's own fused-train test draws them."""
    rng = np.random.default_rng(seed)
    ro = rng.normal(size=(R, 3)).astype(np.float32)
    rd = rng.normal(size=(R, 3)).astype(np.float32)
    vd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    z = np.sort(rng.uniform(0.5, 4.0, size=(R, S)), -1).astype(np.float32)
    dl = rng.uniform(0.01, 0.1, size=(R, S)).astype(np.float32)
    nz = (rng.normal(size=(R, S)) * noise).astype(np.float32)
    tg = rng.uniform(size=(R, 3)).astype(np.float32)
    return ro, rd, vd, z, dl, nz, tg


def _tspec(S, mode, act, white, rays_block=8):
    return tft.TrainSpec(
        n_samples=S, rays_block=rays_block, mode=mode,
        density_activation=act, white_bkgd=white,
    )


def _params(mlp):
    return [p for _, lin in mlp.linears() for p in (lin.weight, lin.bias)]


def _grads_as_jax_tree(mlp, grads):
    """Per-parameter grads of ``mlp.linears()`` order as the JAX pytree
    ({"w": [fan_in, fan_out], "b"} per layer)."""
    tree = {"pos_linears": []}
    for i, (name, _) in enumerate(mlp.linears()):
        leaf = {"w": grads[2 * i].t().numpy(), "b": grads[2 * i + 1].numpy()}
        if name.startswith("pos_linears."):
            tree["pos_linears"].append(leaf)
        else:
            tree[name] = leaf
    return tree


def _torch_loss_and_grads(tm, tspec, arrays, R):
    mlp = tm.coarse
    for p in _params(mlp):
        p.grad = None
    sse, rgb, w = tft.fused_train_apply(
        mlp, tm.pos_enc, tm.dir_enc, tspec, *(torch.from_numpy(a) for a in arrays)
    )
    assert not rgb.requires_grad and not w.requires_grad
    (sse / (R * 3)).backward()
    return sse.detach(), rgb, w, [p.grad.clone() for p in _params(mlp)]


@pytest.mark.parametrize("mode,act,white", MODES)
def test_plain_matches_jax_train_kernel_and_twin(mode, act, white):
    _check_train_against_jax(mode, act, white)


@pytest.mark.parametrize("width", [32, 64, 48, 96, 128])
def test_plain_matches_jax_train_kernel_at_narrow_widths(width):
    """The widths the overlay key netwidth reaches below 128: sse, rgb and
    weights against JAX's Pallas kernel and its twin, the gradients against
    the twin, at the bounds above. (At width 32 JAX's Pallas train kernel in
    interpret mode is itself up to 2.2% of an array's largest value from
    its own twin on the trunk's dW; the port's plain version is within
    3e-8 of the twin.)"""
    _check_train_against_jax("canonical", "softplus", True, width, grads_of_kernel=width != 32)


def _check_train_against_jax(mode, act, white, width=None, grads_of_kernel=True):
    import jax
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.kernels import fused_train as jft
    from nerf_meets_mlx_tpu.kernels.fused_mlp import FusedMLPSpec, pack_params

    R, S = 10, 16  # rays_block 8: the Pallas kernel pads to 16 rays
    jcfg, params, tm = _models(width=width)
    spec = FusedMLPSpec.from_configs(
        jcfg.mlp, jcfg.pos_encoding, jcfg.dir_encoding, compute_dx=False
    )
    jspec = jft.TrainSpec(
        n_samples=S, rays_block=8, n_rays=R, mode=mode,
        density_activation=act, white_bkgd=white,
    )
    arrays = _inputs(R, S)
    jargs = [jnp.asarray(a) for a in arrays]
    sse_t, rgb_t, w_t, g_t = _torch_loss_and_grads(tm, _tspec(S, mode, act, white), arrays, R)
    g_t = _grads_as_jax_tree(tm.coarse, g_t)

    for fn in (jft.fused_train_apply, jft.fused_train_reference):
        def loss(p, fn=fn):
            sse, rgb, w = fn(spec, jspec, pack_params(spec, p), *jargs)
            return sse / (R * 3), (sse, rgb, w)

        (_, (sse_j, rgb_j, w_j)), g_j = jax.value_and_grad(loss, has_aux=True)(params["coarse"])
        np.testing.assert_allclose(float(sse_t), float(sse_j), rtol=VAL_RTOL)
        np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=VAL_RTOL, atol=VAL_ATOL)
        np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=VAL_RTOL, atol=VAL_ATOL)
        if fn is jft.fused_train_apply and not grads_of_kernel:
            continue
        flat_t = jax.tree_util.tree_leaves_with_path(g_t)
        flat_j = dict(jax.tree_util.tree_leaves_with_path(g_j))
        assert len(flat_t) == len(flat_j) == 2 * len(tm.coarse.linears())
        for path, gt in flat_t:
            np.testing.assert_allclose(
                gt, np.asarray(flat_j[path]), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                err_msg=f"{fn.__name__} {jax.tree_util.keystr(path)}",
            )


def _emulate_kernel(mlp, pos_enc, dir_enc, tspec, ro, rd, vd, z, dl, nz, tg, mm=torch.matmul):
    """csrc/fused_train.cu's algorithm in torch, reading the weights from
    the buffer the kernel reads and writing dW into the layout it writes;
    returns (sse, rgb, weights, grads) as ``_train_launch`` does. ``mm``
    takes the products the kernel runs on the tensor cores (the dense
    layers, their cotangents, dW of every job wider than 4 columns); the
    alpha and rgb heads and their dW stay fp32 products, as on the CUDA
    cores."""
    cfg = mlp.cfg
    D, W = cfg.net_depth, cfg.net_width
    WH = W // 2
    wbuf, offs = tft.pack_train_weights(mlp, pos_enc, dir_enc)
    assert len(offs) == 3 * D + 11 and all(o % 4 == 0 for o in offs)

    def mat(i, rows, cols):
        return wbuf[offs[i] : offs[i] + rows * cols].reshape(rows, cols)

    def vec(i, n):
        return wbuf[offs[i] : offs[i] + n]

    R, S = z.shape
    pts = (ro[:, None, :] + z[..., None] * rd[:, None, :]).reshape(-1, 3)
    dirs = vd[:, None, :].expand(R, S, 3).reshape(-1, 3)
    xp = sinusoidal_encode(pts, vec(2 * D + 8, pos_enc.n_freqs), pos_enc.include_input)
    xd = sinusoidal_encode(dirs, vec(2 * D + 9, dir_enc.n_freqs), dir_enc.include_input)
    Pd, Dd = xp.shape[1], xd.shape[1]
    hs = [torch.relu(mm(xp, mat(0, Pd, W)) + vec(1, W))]
    for j in range(1, D):
        if (j - 1) in cfg.skips:
            x = torch.cat([xp, hs[-1]], -1)
            hs.append(torch.relu(mm(x, mat(2 * j, Pd + W, W)) + vec(2 * j + 1, W)))
        else:
            hs.append(torch.relu(mm(hs[-1], mat(2 * j, W, W)) + vec(2 * j + 1, W)))
    raw_a = (hs[-1] @ mat(2 * D, W, 1) + vec(2 * D + 1, 1)).reshape(R, S)
    feat = mm(hs[-1], mat(2 * D + 2, W, W)) + vec(2 * D + 3, W)
    hd = torch.relu(mm(torch.cat([feat, xd], -1), mat(2 * D + 4, W + Dd, WH)) + vec(2 * D + 5, WH))
    raw_rgb = (hd @ mat(2 * D + 6, WH, 3) + vec(2 * D + 7, 3)).reshape(R, S, 3)

    # per point: q, alpha, d(alpha)/dq, dq/d(raw sigma)
    raw = raw_a + nz
    if tspec.mode == "canonical":
        if tspec.density_activation == "relu":
            sigma, dsig = torch.relu(raw), (raw > 0).float()
        else:
            sigma, dsig = tft.softplus(raw), torch.sigmoid(raw)
        q = sigma * dl
        e = torch.exp(-q)
        alpha, da, dqd = 1.0 - e, e, dl * dsig
        c = torch.sigmoid(raw_rgb)
    else:
        q = dl * raw
        e = torch.exp(-torch.relu(q))
        alpha, da, dqd = 1.0 - e, e * (q > 0).float(), dl
        c = raw_rgb
    T = torch.exp(-exclusive_cumsum(q))
    w = alpha * T
    rgb = (w[..., None] * c).sum(1)
    if tspec.white_bkgd:
        rgb = rgb + (1.0 - w.sum(1, keepdim=True))
    resid = rgb - tg
    sse = (resid**2).sum()

    # closed-form cotangents of the composite
    g = 2.0 * resid
    dw = (c * g[:, None, :]).sum(-1)
    if tspec.white_bkgd:
        dw = dw - g.sum(-1, keepdim=True)
    x = dw * w
    suffix = x.flip(-1).cumsum(-1).flip(-1) - x  # sum over s > t
    dsigma = (dw * T * da - suffix) * dqd
    drgb = w[..., None] * g[:, None, :]
    if tspec.mode == "canonical":
        drgb = drgb * c * (1.0 - c)
    drgb, dsigma = drgb.reshape(-1, 3), dsigma.reshape(-1, 1)

    # backprop with the transposed matrices of the buffer
    ddir = (drgb @ mat(2 * D + 6, WH, 3).t()) * (hd > 0)
    dfeat = mm(ddir, mat(3 * D + 10, WH, W))
    dzs = [None] * D
    dzs[D - 1] = mm(torch.cat([dfeat, dsigma], -1), mat(3 * D + 9, W + 1, W)) * (hs[-1] > 0)
    for j in range(D - 1, 0, -1):
        dzs[j - 1] = mm(dzs[j], mat(2 * D + 10 + j - 1, W, W)) * (hs[j - 1] > 0)

    # dW = X^T dZ per job, into the forward layout
    dwbuf = torch.zeros(offs[2 * D + 8])

    def job(X, dZ, c_off, bias_off=None):
        blk = X.t() @ dZ if dZ.shape[1] <= 4 else mm(X.t(), dZ)
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
    job(hs[-1], dsigma, offs[2 * D], offs[2 * D + 1])
    job(hs[-1], dfeat, offs[2 * D + 2], offs[2 * D + 3])
    job(feat, ddir, offs[2 * D + 4], offs[2 * D + 5])
    job(xd, ddir, offs[2 * D + 4] + W * WH)
    job(hd, drgb, offs[2 * D + 6], offs[2 * D + 7])
    grads = []
    for i, (_, lin) in enumerate(mlp.linears()):
        fi, fo = lin.in_features, lin.out_features
        grads.append(dwbuf[offs[2 * i] : offs[2 * i] + fi * fo].view(fi, fo).t())
        grads.append(dwbuf[offs[2 * i + 1] : offs[2 * i + 1] + fo])
    return sse, rgb, w, grads


@pytest.mark.parametrize("mode,act,white", MODES)
@pytest.mark.parametrize("level", ["coarse", "fine"])
def test_kernel_algorithm_and_layout_match_autograd(level, mode, act, white):
    tm = t_create(t_lego(), device="cpu").init(torch.Generator().manual_seed(3))
    mlp = getattr(tm, level)
    R, S = 6, 12
    arrays = [torch.from_numpy(a) for a in _inputs(R, S, noise=0.5, seed=4)]
    arrays[0] *= 0.3  # origins near the scene, so the densities vary
    tspec = _tspec(S, mode, act, white)
    with torch.no_grad():
        sse_e, rgb_e, w_e, g_e = _emulate_kernel(mlp, tm.pos_enc, tm.dir_enc, tspec, *arrays)
    sse, rgb, w = tft.fused_train_reference(mlp, tm.pos_enc, tm.dir_enc, tspec, *arrays)
    g = torch.autograd.grad(sse, _params(mlp))
    torch.testing.assert_close(sse_e, sse.detach(), rtol=VAL_RTOL, atol=VAL_ATOL)
    torch.testing.assert_close(rgb_e, rgb.detach(), rtol=VAL_RTOL, atol=VAL_ATOL)
    torch.testing.assert_close(w_e, w.detach(), rtol=VAL_RTOL, atol=VAL_ATOL)
    assert max(float(x.abs().max()) for x in g) > 0
    for i, (ge, ga) in enumerate(zip(g_e, g)):
        assert ge.shape == ga.shape
        torch.testing.assert_close(ge, ga, rtol=GRAD_RTOL, atol=GRAD_ATOL, msg=f"param {i}")


@pytest.mark.parametrize("width", [32, 64, 48, 96])
def test_kernel_algorithm_and_layout_match_autograd_at_narrow_widths(width):
    """The kernel's algorithm and weight layout at widths 32 and 64."""
    tm = t_create(_narrow(t_lego(), width), device="cpu").init(torch.Generator().manual_seed(3))
    R, S = 6, 12
    arrays = [torch.from_numpy(a) for a in _inputs(R, S, noise=0.5, seed=4)]
    arrays[0] *= 0.3
    tspec = _tspec(S, "canonical", "softplus", True)
    with torch.no_grad():
        sse_e, rgb_e, w_e, g_e = _emulate_kernel(tm.fine, tm.pos_enc, tm.dir_enc, tspec, *arrays)
    sse, rgb, w = tft.fused_train_reference(tm.fine, tm.pos_enc, tm.dir_enc, tspec, *arrays)
    g = torch.autograd.grad(sse, _params(tm.fine))
    torch.testing.assert_close(sse_e, sse.detach(), rtol=VAL_RTOL, atol=VAL_ATOL)
    torch.testing.assert_close(w_e, w.detach(), rtol=VAL_RTOL, atol=VAL_ATOL)
    for i, (ge, ga) in enumerate(zip(g_e, g)):
        torch.testing.assert_close(ge, ga, rtol=GRAD_RTOL, atol=GRAD_ATOL, msg=f"param {i}")


def test_tf32_rounding_is_round_to_nearest_away():
    one_ulp = 2.0**-10  # TF32's spacing at 1
    x = torch.tensor([1.0, 1.0 + one_ulp / 2, 1.0 + one_ulp / 2 - 2.0**-23, -1.0 - one_ulp / 2,
                      3.0 + 2.0**-12], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + one_ulp, 1.0, -1.0 - one_ulp, 3.0], dtype=torch.float32)
    assert torch.equal(_tf32(x), want)
    y = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32))
    hi = _tf32(y)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((y - hi).abs() / y.abs()).max()) <= 2.0**-11  # half a TF32 ulp


@pytest.mark.parametrize("mode,act,white", [MODES[0], MODES[2]])
@pytest.mark.parametrize("level,S", [("coarse", 64), ("fine", 192)])
def test_3xtf32_holds_the_card_tolerances(level, S, mode, act, white):
    """The kernel's algorithm with its tensor-core products in 3xTF32,
    against the fp32 plain version (autograd) under the tolerances the card
    holds the kernel to (chip_smoke.py and the gpu tests below: values atol
    1e-4 + rtol 1e-4, every dW and db within 1e-3 of the largest plain
    value), at lego_hierarchical's 8 x 256 with the skip and both levels'
    sample counts; one TF32 pass lands further from the plain version,
    which is why the kernel takes three."""
    tm = t_create(t_lego(), device="cpu").init(torch.Generator().manual_seed(3))
    mlp = getattr(tm, level)
    R = 8
    arrays = [torch.from_numpy(a) for a in _inputs(R, S, noise=0.5, seed=4)]
    arrays[0] *= 0.3
    tspec = _tspec(S, mode, act, white)
    sse, rgb, w = tft.fused_train_reference(mlp, tm.pos_enc, tm.dir_enc, tspec, *arrays)
    g = torch.autograd.grad(sse, _params(mlp))
    worst = {}
    for name, mm in (("3xtf32", _mm_3xtf32), ("1xtf32", _mm_1xtf32)):
        with torch.no_grad():
            sse_e, rgb_e, w_e, g_e = _emulate_kernel(
                mlp, tm.pos_enc, tm.dir_enc, tspec, *arrays, mm=mm
            )
        vals = [(sse_e, sse.detach()), (rgb_e, rgb.detach()), (w_e, w.detach())]
        # each value's error over its tolerance, each gradient's over its largest value
        val_err = max(float(((a - b).abs() / (1e-4 + 1e-4 * b.abs())).max()) for a, b in vals)
        ratios = [float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(g_e, g)]
        worst[name] = (val_err, max(ratios))
        if name == "3xtf32":
            for a, b in vals:
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
            assert max(ratios) <= 1e-3, ratios
    assert worst["1xtf32"][0] > worst["3xtf32"][0], worst
    assert worst["1xtf32"][1] > worst["3xtf32"][1], worst


def test_cpu_call_runs_plain_and_launches_nothing():
    _, _, tm = _models()
    R, S = 5, 16
    arrays = [torch.from_numpy(a) for a in _inputs(R, S, seed=3)]
    tspec = _tspec(S, "canonical", "softplus", True)
    tft.LAUNCHES["train"] = 0
    got = tft.fused_train_apply(tm.coarse, tm.pos_enc, tm.dir_enc, tspec, *arrays)
    want = tft.fused_train_reference(tm.coarse, tm.pos_enc, tm.dir_enc, tspec, *arrays)
    assert tft.LAUNCHES["train"] == 0
    assert got[0].requires_grad
    for g, w in zip(got, want):
        torch.testing.assert_close(g.detach(), w.detach(), rtol=0, atol=0)


def test_other_devices_raise():
    _, _, tm = _models()
    arrays = [torch.empty(a.shape, device="meta") for a in _inputs(4, 8)]
    with pytest.raises(ValueError):
        tft.fused_train_apply(
            tm.coarse, tm.pos_enc, tm.dir_enc, _tspec(8, "canonical", "softplus", True), *arrays
        )


@pytest.mark.parametrize("S", [16, 64, 128, 192, 1024])
def test_train_block_sizes_fit(S):
    """default_rays_block fills about 512 points and fits shared memory (the
    kernel's own formula, csrc/fused_train.cu smem_bytes: tiles of row
    stride 72, a 16-row weight slice of row stride 264); default_group
    makes dW partials of about 8192 points."""
    rb = tft.default_rays_block(S)
    assert rb >= 1 and (rb == 1 or rb * S <= tft.TRAIN_TARGET_POINTS)
    smem = 4 * ((2 * 256 + 64 + 32) * 72 + 16 * 264 + rb * S * 7 + rb)
    assert smem <= 232448, (S, rb, smem)
    grp = tft.default_group(S, rb)
    assert grp >= 1 and (grp == 1 or grp * rb * S <= tft.DW_SPLIT_POINTS)


def test_default_rays_block_rejects_past_the_bound():
    with pytest.raises(ValueError):
        tft.default_rays_block(tft.max_fused_samples() + 1)


def _rel_close(got, want, rel):
    """max |got - want| <= rel * max |want| (and finite)."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    return bool(torch.isfinite(got).all()) and err <= rel * max(scale, 1e-30), err, scale


@pytest.mark.gpu
@pytest.mark.parametrize("width", [256, 128])
@pytest.mark.parametrize("S", [64, 192, 1024])
def test_cuda_kernel_matches_plain(S, width):
    _check_cuda_kernel(S, width)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [64, 32, 48, 96])
def test_cuda_kernel_matches_plain_at_narrow_widths(width):
    """The widths the overlay key netwidth reaches below 128."""
    _check_cuda_kernel(64, width)


def _check_cuda_kernel(S, width):
    """Both widths the kernel is built for (lego's 256 and 128), at full
    depth with the skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = t_lego()
    mlp = dataclasses.replace(cfg.mlp, net_width=width)
    cfg = cfg.replace(mlp=mlp, mlp_fine=mlp)
    tm = t_create(cfg, device=dev).init(torch.Generator().manual_seed(0))
    R = 1000  # not a multiple of default_rays_block(S)
    arrays = [torch.from_numpy(a).to(dev) for a in _inputs(R, S, noise=0.1, seed=4)]
    arrays[0] *= 0.3
    rb = tft.default_rays_block(S)
    for level in ("coarse", "fine"):
        mlp = getattr(tm, level)
        for mode, act, white in MODES:
            tspec = tft.TrainSpec(
                n_samples=S, rays_block=rb, mode=mode, density_activation=act,
                white_bkgd=white, group=tft.default_group(S, rb),
            )
            n0 = tft.LAUNCHES["train"]
            sse, rgb, w = tft.fused_train_apply(mlp, tm.pos_enc, tm.dir_enc, tspec, *arrays)
            g = torch.autograd.grad(sse, _params(mlp))
            torch.cuda.synchronize()
            assert tft.LAUNCHES["train"] == n0 + 1
            sse_p, rgb_p, w_p = tft.fused_train_reference(
                mlp, tm.pos_enc, tm.dir_enc, tspec, *arrays
            )
            g_p = torch.autograd.grad(sse_p, _params(mlp))
            # fp32 sums in another order than cuBLAS's (chip_smoke.py's bounds)
            for got, want in ((sse, sse_p), (rgb, rgb_p), (w, w_p)):
                torch.testing.assert_close(got.detach(), want.detach(), rtol=1e-4, atol=1e-4)
            for i, (a, b) in enumerate(zip(g, g_p)):
                ok, err, scale = _rel_close(a, b, 1e-3)
                assert ok, (level, mode, act, white, i, err, scale)


@pytest.mark.gpu
def test_cuda_kernel_is_deterministic():
    """Two launches on the same inputs give bit-identical sse, rgb, weights
    and dW: the dW partials are summed in a fixed order, with no atomics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    tm = t_create(t_lego(), device=dev).init(torch.Generator().manual_seed(0))
    R, S = 1000, 192
    arrays = [torch.from_numpy(a).to(dev) for a in _inputs(R, S, noise=0.1, seed=4)]
    arrays[0] *= 0.3
    rb = tft.default_rays_block(S)
    tspec = tft.TrainSpec(
        n_samples=S, rays_block=rb, mode="canonical", density_activation="softplus",
        white_bkgd=True, group=tft.default_group(S, rb),
    )
    runs = []
    for _ in range(2):
        sse, rgb, w = tft.fused_train_apply(tm.fine, tm.pos_enc, tm.dir_enc, tspec, *arrays)
        g = torch.autograd.grad(sse, _params(tm.fine))
        runs.append((sse.detach(), rgb, w, *g))
    torch.cuda.synchronize()
    assert len(runs[0]) == 3 + 2 * len(tm.fine.linears())
    for i, (a, b) in enumerate(zip(*runs)):
        assert torch.equal(a, b), i
