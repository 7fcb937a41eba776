"""The port's fused eval op (kernels/fused_train.py, csrc/fused_eval.cu).

* Its plain version against the JAX ``fused_eval_apply``, which runs the
  Pallas ``_eval_kernel`` in interpret mode here, on the same weights (via
  ``interop``) and inputs: rtol 1e-5 / atol 1e-6, the JAX kernel-vs-twin
  bound.
* The packed weight buffer the CUDA kernel reads, replayed in torch by the
  kernel's own offsets, against the plain version; and the wgmma B images
  (``pack_eval_wgmma``) unpacked from the layout the kernel's descriptors
  read: every weight in its place, hi + lo within 2^-22 of it, the
  padding zero.
* The kernel's algorithm: 3xTF32 products from those images with every
  wgmma's add truncated toward zero and one accumulator a layer holds the
  card's value tolerance at lego_hierarchical's 8 x 256, both levels; one
  TF32 pass lands further off.
* The wrapper's routing: CPU tensors run the plain version and launch
  nothing; other devices raise.
* ``gpu``-marked: the CUDA kernel against the plain version at S = 64, 192
  and 1024 (one ray a block), widths 256, 128 and the narrow ones, white
  background off; two launches give bit-identical results (skipped where
  no card is present).
"""

import dataclasses

import numpy as np
import pytest
import torch

from nerf_meets_mlx_torch import interop
from nerf_meets_mlx_torch.config import lego_hierarchical as t_lego
from nerf_meets_mlx_torch.kernels import fused_train as tft
from nerf_meets_mlx_torch.models import create_nerf as t_create
from torch_threads import one_torch_thread_per_worker  # noqa: F401  (autouse fixture)

RTOL, ATOL = 1e-5, 1e-6

# JAX is imported by the tests that compare with it, not at module level:
# the gpu-marked test runs on the card's machine, which has no JAX
# (python -m pytest --noconftest -m gpu tests/test_torch_fused_eval.py).


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
    jm = j_create(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = t_create(_narrow(t_lego(), width), device="cpu")
    interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tm)
    return jcfg, params, tm


def _inputs(R, S, seed=0):
    """Ray inputs as numpy: rays_o, rays_d, viewdirs, z, deltas (the last
    bin 1e10·|d|, as the render path makes them)."""
    rng = np.random.default_rng(seed)
    ro = rng.normal(size=(R, 3)).astype(np.float32)
    rd = rng.normal(size=(R, 3)).astype(np.float32)
    vd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    z = np.sort(rng.uniform(0.5, 4.0, size=(R, S)), -1).astype(np.float32)
    dl = rng.uniform(0.01, 0.1, size=(R, S)).astype(np.float32)
    dl[:, -1] = 1e10 * np.linalg.norm(rd, axis=-1)
    return ro, rd, vd, z, dl


def _tspec(S, R, mode, act, white, rays_block=8):
    return tft.TrainSpec(
        n_samples=S, rays_block=rays_block, mode=mode,
        density_activation=act, white_bkgd=white,
    )


def _compare_with_jax(R, S, mode, act, white, group, width=None):
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.kernels import fused_train as jft
    from nerf_meets_mlx_tpu.kernels.fused_mlp import FusedMLPSpec, pack_params

    jcfg, params, tm = _models(width=width)
    spec = FusedMLPSpec.from_configs(
        jcfg.mlp, jcfg.pos_encoding, jcfg.dir_encoding, compute_dx=False
    )
    jspec = jft.TrainSpec(
        n_samples=S, rays_block=8, n_rays=R, mode=mode,
        density_activation=act, white_bkgd=white, group=group,
    )
    arrays = _inputs(R, S)
    rgb_j, w_j = jft.fused_eval_apply(
        spec, jspec, pack_params(spec, params["coarse"]), *(jnp.asarray(a) for a in arrays)
    )
    rgb_t, w_t = tft.fused_eval_apply(
        tm.coarse, tm.pos_enc, tm.dir_enc, _tspec(S, R, mode, act, white),
        *(torch.from_numpy(a) for a in arrays),
    )
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "mode,act,white",
    [
        ("canonical", "softplus", True),
        ("canonical", "relu", False),
        ("reference", "softplus", False),
        ("reference", "softplus", True),
    ],
)
def test_plain_matches_jax_eval_kernel(mode, act, white):
    _compare_with_jax(R=10, S=16, mode=mode, act=act, white=white, group=1)


@pytest.mark.parametrize("width", [32, 64, 48, 96, 128])
def test_plain_matches_jax_eval_kernel_at_narrow_widths(width):
    """The widths the overlay key netwidth reaches below 256 (the view
    layer then has 16, 32, 24, 48 or 64 outputs)."""
    _compare_with_jax(R=10, S=16, mode="canonical", act="softplus", white=True, group=1,
                      width=width)


@pytest.mark.parametrize("group,R", [(2, 10), (3, 25)])
def test_plain_matches_jax_eval_kernel_grouped_padded(group, R):
    """R not a multiple of the JAX kernel's rays_block·group: its padded
    rays are sliced off, and the port's output has exactly R rows."""
    _compare_with_jax(R=R, S=16, mode="canonical", act="softplus", white=True, group=group)


def _replay_packed(wbuf, offs, mlp, pos_enc, dir_enc, tspec, ro, rd, vd, z, dl):
    """The kernel's reads of the packed buffer, in torch: every weight,
    bias and band taken at the offset the kernel takes it from."""
    cfg = mlp.cfg
    D, W = cfg.net_depth, cfg.net_width
    offs = offs.tolist()

    def mat(i, rows, cols):
        return wbuf[offs[i] : offs[i] + rows * cols].reshape(rows, cols)

    def vec(i, n):
        return wbuf[offs[i] : offs[i] + n]

    R, S = z.shape
    pts = (ro[:, None, :] + z[..., None] * rd[:, None, :]).reshape(-1, 3)
    dirs = vd[:, None, :].expand(R, S, 3).reshape(-1, 3)

    def enc(x, band_idx, n_freqs, include_input):
        from nerf_meets_mlx_torch.encoding.sinusoidal import sinusoidal_encode

        return sinusoidal_encode(x, vec(band_idx, n_freqs), include_input)

    xp = enc(pts, 2 * D + 8, pos_enc.n_freqs, pos_enc.include_input)
    xd = enc(dirs, 2 * D + 9, dir_enc.n_freqs, dir_enc.include_input)
    P = xp.shape[1]
    h = torch.relu(xp @ mat(0, P, W) + vec(1, W))
    for j in range(1, D):
        if (j - 1) in cfg.skips:
            h = torch.relu(torch.cat([xp, h], -1) @ mat(2 * j, P + W, W) + vec(2 * j + 1, W))
        else:
            h = torch.relu(h @ mat(2 * j, W, W) + vec(2 * j + 1, W))
    alpha = h @ mat(2 * D, W, 1) + vec(2 * D + 1, 1)
    feat = h @ mat(2 * D + 2, W, W) + vec(2 * D + 3, W)
    hd = torch.relu(
        torch.cat([feat, xd], -1) @ mat(2 * D + 4, W + xd.shape[1], W // 2) + vec(2 * D + 5, W // 2)
    )
    rgb = hd @ mat(2 * D + 6, W // 2, 3) + vec(2 * D + 7, 3)
    raw = torch.cat([rgb, alpha], -1).reshape(R, S, 4)
    q, a = tft._alpha_terms(tspec, raw[..., 3], dl)
    w = a * torch.exp(-tft.exclusive_cumsum(q))
    c = torch.sigmoid(raw[..., :3]) if tspec.mode == "canonical" else raw[..., :3]
    out = (w[..., None] * c).sum(1)
    if tspec.white_bkgd:
        out = out + (1.0 - w.sum(1, keepdim=True))
    return out, w


@pytest.mark.parametrize("level", ["coarse", "fine"])
def test_packed_weights_follow_the_kernel_layout(level):
    _, _, tm = _models(seed=1)
    mlp = getattr(tm, level)
    wbuf, offs = tft.pack_eval_weights(mlp, tm.pos_enc, tm.dir_enc)
    assert offs.dtype == torch.int32 and len(offs) == 2 * mlp.cfg.net_depth + 10
    assert all(o % 4 == 0 for o in offs.tolist())  # 16-byte aligned float4 rows
    R, S = 7, 12
    arrays = [torch.from_numpy(a) for a in _inputs(R, S, seed=2)]
    tspec = _tspec(S, R, "canonical", "softplus", True)
    want = tft.fused_eval_reference(mlp, tm.pos_enc, tm.dir_enc, tspec, *arrays)
    got = _replay_packed(wbuf, offs, mlp, tm.pos_enc, tm.dir_enc, tspec, *arrays)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)


def test_cpu_call_runs_plain_and_launches_nothing():
    _, _, tm = _models()
    R, S = 5, 16
    arrays = [torch.from_numpy(a) for a in _inputs(R, S, seed=3)]
    tspec = _tspec(S, R, "canonical", "softplus", True)
    tft.LAUNCHES["eval"] = 0
    got = tft.fused_eval_apply(tm.coarse, tm.pos_enc, tm.dir_enc, tspec, *arrays)
    want = tft.fused_eval_reference(tm.coarse, tm.pos_enc, tm.dir_enc, tspec, *arrays)
    assert tft.LAUNCHES["eval"] == 0
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_other_devices_raise():
    _, _, tm = _models()
    arrays = [torch.empty(a.shape, device="meta") for a in _inputs(4, 8)]
    with pytest.raises(ValueError):
        tft.fused_eval_apply(
            tm.coarse, tm.pos_enc, tm.dir_enc, _tspec(8, 4, "canonical", "softplus", True),
            *arrays,
        )


def test_eval_block_fits_shared_memory():
    """csrc/fused_eval.cu's smem_bytes at W = 256: four weight stages of 8
    rows x 256 columns x (hi, lo), the 128-point activation tile of row
    stride 264, the ring's 8 mbarriers, the tile's points (8 floats a
    row), and 20 bytes a point."""
    for S in (16, 64, 192, tft.max_fused_samples()):
        rb = tft.eval_block(S)
        assert rb >= 1
        smem = 4 * 16 * 256 * 4 + 4 * 128 * 264 + 8 * 8 + 4 * 128 * 8 + 4 * rb * S * 5
        assert smem <= 232448, (S, rb, smem)


def _trunc32(x64):
    """float64 values to float32, rounded toward zero, as the tensor cores
    round their adds: the nearest float32, one step back toward zero where
    it lies past the value (a step of its magnitude bits, either sign)."""
    y = x64.to(torch.float32)
    over = (y.double().abs() > x64.abs()).to(torch.int32)
    return (y.view(torch.int32) - over).view(torch.float32)


def _unpack_image(img, n, k_pad):
    """(hi, lo) as [k_pad, n] in feature order from one layer's B images,
    read as the kernel's descriptors read them: per k-step of 8 rows, the
    hi then the lo image, each core matrices [K half][n / 8][8 rows][4],
    K index i of the step holding feature WGMMA_K_ORDER[i]."""
    steps = k_pad // 8
    x = img.reshape(steps, 2, 2, n // 8, 8, 4).permute(1, 0, 2, 5, 3, 4)
    x = x.reshape(2, steps, 8, n)  # [hi/lo, step, K index, column]
    out = torch.empty_like(x)
    out[:, :, list(tft.WGMMA_K_ORDER)] = x
    hi, lo = out.reshape(2, k_pad, n)
    return hi, lo


def _layers(mlp, pos_dim, dir_dim):
    """(name, nn.Linear, input segment widths) of every wgmma layer, in
    the kernel's order."""
    cfg = mlp.cfg
    W = cfg.net_width
    out = []
    for j, lin in enumerate(mlp.pos_linears):
        segs = [pos_dim] if j == 0 else ([pos_dim, W] if (j - 1) in cfg.skips else [W])
        out.append((f"pos_linears.{j}", lin, segs))
    out.append(("feature_linear", mlp.feature_linear, [W]))
    out.append(("dir_linear", mlp.dir_linear, [W, dir_dim]))
    return out


def _split_image(mlp, pos_enc, dir_enc):
    """{layer name: (hi, lo, padded W^T)} from pack_eval_wgmma's buffer."""
    img = tft.pack_eval_wgmma(mlp, pos_enc, dir_enc)
    out, at = {}, 0
    for name, lin, segs in _layers(mlp, pos_enc.out_dim, dir_enc.out_dim):
        n = lin.out_features
        k_pad = sum(-(-w // 8) * 8 for w in segs)
        hi, lo = _unpack_image(img[at : at + 2 * k_pad * n], n, k_pad)
        at += 2 * k_pad * n
        wt = lin.weight.detach().t()
        cols, a = [], 0
        for w in segs:
            cols += [wt[a : a + w], wt.new_zeros((-w % 8, n))]
            a += w
        out[name] = (hi, lo, torch.cat(cols))
    assert at == img.numel()
    return out


@pytest.mark.parametrize("width", [256, 48])
def test_wgmma_image_puts_every_weight_in_its_place(width):
    """pack_eval_wgmma read back through the descriptor layout: each (k, n)
    of each layer is where the kernel reads it, hi and lo are TF32 (low 13
    bits clear), |hi + lo - w| <= 2^-22 |w|, and the padding of the odd
    segments (63 position features, 27 direction features) is zero."""
    tm = t_create(_narrow(t_lego(), width), device="cpu").init(torch.Generator().manual_seed(5))
    for mlp in (tm.coarse, tm.fine):
        layers = _split_image(mlp, tm.pos_enc, tm.dir_enc)
        assert len(layers) == mlp.cfg.net_depth + 2
        for name, (hi, lo, w) in layers.items():
            for half in (hi, lo):
                assert bool(((half.view(torch.int32) & 0x1FFF) == 0).all()), name
            assert bool(((hi + lo - w).abs() <= 2.0**-22 * w.abs()).all()), name
            assert bool((hi[w == 0] == 0).all() and (lo[w == 0] == 0).all()), name
            assert float((hi - w).abs().max()) > 0  # the lo half carries bits
        k0 = layers["pos_linears.0"][2]
        assert k0.shape[0] == 64 and bool((k0[63] == 0).all())
        kd = layers["dir_linear"][2]
        assert kd.shape[0] == width + 32 and bool((kd[width + 27 :] == 0).all())


def _emulate_kernel(mlp, pos_enc, dir_enc, tspec, ro, rd, vd, z, dl, passes=3):
    """csrc/fused_eval.cu's algorithm in torch: every wgmma layer's B from
    pack_eval_wgmma, its A split into TF32 halves as split_tf32 splits it,
    and per k-step the products lo*hi, hi*lo, hi*hi (or hi*hi alone with
    passes=1) each summed exactly over the step's 8 rows and added to the
    layer's one accumulator with truncation toward zero; the heads and the
    compositing in fp32."""
    cfg = mlp.cfg
    R, S = z.shape
    pts = (ro[:, None] + z[..., None] * rd[:, None]).reshape(-1, 3)
    xp = pos_enc.apply(pts)
    xd = dir_enc.apply(vd[:, None].expand(R, S, 3).reshape(-1, 3))
    images = _split_image(mlp, pos_enc, dir_enc)

    def dense(name, segs):
        hi, lo, _ = images[name]
        a = torch.cat([torch.nn.functional.pad(x, (0, -x.shape[1] % 8)) for x in segs], 1)
        ah = tft._tf32(a)
        al = tft._tf32(a - ah)
        pairs = ((al, hi), (ah, lo), (ah, hi)) if passes == 3 else ((ah, hi),)
        steps = a.shape[1] // 8
        # every k-step's exact sums at once ([step, point, column], float64),
        # then the accumulator's truncating adds in the kernel's order
        sums = [torch.einsum("psk,skn->spn", x.double().reshape(-1, steps, 8),
                             y.double().reshape(steps, 8, -1)) for x, y in pairs]
        acc = torch.zeros(sums[0].shape[1:], dtype=torch.float64)
        for s in range(steps):
            for part in sums:
                acc = _trunc32(acc + part[s]).double()
        return acc.float() + dict(mlp.linears())[name].bias

    h = torch.relu(dense("pos_linears.0", [xp]))
    for j in range(1, cfg.net_depth):
        segs = [xp, h] if (j - 1) in cfg.skips else [h]
        h = torch.relu(dense(f"pos_linears.{j}", segs))
    alpha = h @ mlp.alpha_linear.weight.t() + mlp.alpha_linear.bias
    feat = dense("feature_linear", [h])
    hd = torch.relu(dense("dir_linear", [feat, xd]))
    rgb = hd @ mlp.rgb_linear.weight.t() + mlp.rgb_linear.bias
    raw = torch.cat([rgb, alpha], -1).reshape(R, S, 4)
    q, a = tft._alpha_terms(tspec, raw[..., 3], dl)
    w = a * torch.exp(-tft.exclusive_cumsum(q))
    c = torch.sigmoid(raw[..., :3]) if tspec.mode == "canonical" else raw[..., :3]
    out = (w[..., None] * c).sum(1)
    if tspec.white_bkgd:
        out = out + (1.0 - w.sum(1, keepdim=True))
    return out, w


@pytest.mark.parametrize("mode", ["canonical", "reference"])
@pytest.mark.parametrize("level,S", [("coarse", 64), ("fine", 192)])
def test_3xtf32_holds_the_card_tolerance(level, S, mode):
    """The kernel's algorithm (``_emulate_kernel``) against the fp32 plain
    version under the card's value tolerance (atol 1e-4 + rtol 1e-4:
    chip_smoke.py and the gpu tests below) at lego_hierarchical's 8 x 256
    with the skip, both levels' sample counts; one TF32 pass lands further
    off, which is why the kernel takes three."""
    tm = t_create(t_lego(), device="cpu").init(torch.Generator().manual_seed(3))
    mlp = getattr(tm, level)
    R = 8
    arrays = [torch.from_numpy(a) for a in _inputs(R, S, seed=4)]
    arrays[0] *= 0.3  # origins near the scene, so the densities vary
    tspec = _tspec(S, R, mode, "softplus", True)
    threads = torch.get_num_threads()
    # one thread: the emulation's many small ops would otherwise contend
    # with the other test workers' threads for the cores
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            want = tft.fused_eval_reference(mlp, tm.pos_enc, tm.dir_enc, tspec, *arrays)
            got = {p: _emulate_kernel(mlp, tm.pos_enc, tm.dir_enc, tspec, *arrays, passes=p)
                   for p in (3, 1)}
    finally:
        torch.set_num_threads(threads)
    for g, w in zip(got[3], want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    # each pass's worst error over the tolerance
    worst = {p: max(float(((g - w).abs() / (1e-4 + 1e-4 * w.abs())).max())
                    for g, w in zip(got[p], want)) for p in got}
    assert worst[1] > worst[3], worst


def _cuda_case(width, S, R, cases, seed=4):
    """The CUDA kernel against the plain version on the card for each
    (mode, density activation, white background) in ``cases``: one launch
    each, values within atol 1e-4 + rtol 1e-4 (fp32 sums in another order
    than cuBLAS's, chip_smoke.py's bound)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    tm = t_create(_narrow(t_lego(), width), device=dev).init(torch.Generator().manual_seed(0))
    arrays = [torch.from_numpy(a).to(dev) for a in _inputs(R, S, seed=seed)]
    arrays[0] *= 0.3  # origins near the scene, so the densities vary
    for mode, act, white in cases:
        tspec = tft.TrainSpec(
            n_samples=S, rays_block=tft.eval_block(S), mode=mode,
            density_activation=act, white_bkgd=white,
        )
        n0 = tft.LAUNCHES["eval"]
        got = tft.fused_eval_apply(tm.fine, tm.pos_enc, tm.dir_enc, tspec, *arrays)
        torch.cuda.synchronize()
        assert tft.LAUNCHES["eval"] == n0 + 1
        want = tft.fused_eval_reference(tm.fine, tm.pos_enc, tm.dir_enc, tspec, *arrays)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    return tm, arrays


@pytest.mark.gpu
@pytest.mark.parametrize("S", [64, 192])
def test_cuda_kernel_matches_plain(S):
    # R = 1000: not a multiple of eval_block(S)
    _cuda_case(None, S, 1000, [("canonical", "softplus", True), ("reference", "softplus", True)])


@pytest.mark.gpu
@pytest.mark.parametrize("width", [32, 64, 48, 96])
def test_cuda_kernel_matches_plain_at_narrow_widths(width):
    """The eval kernel at the narrow widths (lego_hierarchical's depth and
    skip; the view layer of width 48 has 24 columns, n16 + n8), as
    test_cuda_kernel_matches_plain."""
    _cuda_case(width, 64, 1000, [("canonical", "softplus", True)])


@pytest.mark.gpu
@pytest.mark.parametrize("width", [128, 256])
def test_cuda_kernel_matches_plain_at_1024_samples(width):
    """S = 1024, the routing bound (max_fused_samples): one ray a block,
    eight tiles, the largest shared-memory footprint."""
    assert tft.eval_block(1024) == 1
    _cuda_case(width, 1024, 300, [("canonical", "softplus", True), ("reference", "softplus", True)])


@pytest.mark.gpu
@pytest.mark.parametrize("S", [64, 192])
def test_cuda_kernel_matches_plain_without_white_background(S):
    _cuda_case(None, S, 1000, [("reference", "softplus", False), ("canonical", "relu", False)])


@pytest.mark.gpu
def test_cuda_kernel_is_deterministic():
    """No atomics: two launches on the same inputs give bit-identical rgb
    and weights."""
    tm, arrays = _cuda_case(None, 192, 1000, [("canonical", "softplus", True)])
    tspec = tft.TrainSpec(n_samples=192, rays_block=tft.eval_block(192), mode="canonical",
                          density_activation="softplus", white_bkgd=True)
    a = tft.fused_eval_apply(tm.fine, tm.pos_enc, tm.dir_enc, tspec, *arrays)
    b = tft.fused_eval_apply(tm.fine, tm.pos_enc, tm.dir_enc, tspec, *arrays)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)
