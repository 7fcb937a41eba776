"""The port's fused eval op (kernels/fused_train.py, csrc/fused_eval.cu).

* Its plain version against the JAX ``fused_eval_apply``, which runs the
  Pallas ``_eval_kernel`` in interpret mode here, on the same weights (via
  ``interop``) and inputs: rtol 1e-5 / atol 1e-6, the JAX kernel-vs-twin
  bound.
* The packed weight buffer the CUDA kernel reads, replayed in torch by the
  kernel's own offsets, against the plain version.
* The wrapper's routing: CPU tensors run the plain version and launch
  nothing; other devices raise.
* ``gpu``-marked: the CUDA kernel against the plain version at S = 64 and
  192 on the card (skipped where no card is present).
"""

import dataclasses

import numpy as np
import pytest
import torch

from nerf_meets_mlx_torch import interop
from nerf_meets_mlx_torch.config import lego_hierarchical as t_lego
from nerf_meets_mlx_torch.kernels import fused_train as tft
from nerf_meets_mlx_torch.models import create_nerf as t_create

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


@pytest.mark.parametrize("width", [32, 64])
def test_plain_matches_jax_eval_kernel_at_narrow_widths(width):
    """The widths the overlay key netwidth reaches below 128 (the view
    layer then has 16 or 32 outputs)."""
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
    for S in (16, 64, 192, tft.max_fused_samples()):
        rb = tft.eval_block(S)
        assert rb >= 1
        smem = 4 * ((2 * 256 + 64 + 32) * 68 + 16 * 256 + rb * S * 5)
        assert smem <= 232448, (S, rb, smem)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [64, 192])
def test_cuda_kernel_matches_plain(S):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    tm = t_create(t_lego(), device=dev).init(torch.Generator().manual_seed(0))
    R = 1000  # not a multiple of eval_block(S)
    arrays = [torch.from_numpy(a).to(dev) for a in _inputs(R, S, seed=4)]
    arrays[0] *= 0.3  # origins near the scene, so the densities vary
    for mode in ("canonical", "reference"):
        tspec = tft.TrainSpec(
            n_samples=S, rays_block=tft.eval_block(S), mode=mode,
            density_activation="softplus", white_bkgd=True,
        )
        n0 = tft.LAUNCHES["eval"]
        got = tft.fused_eval_apply(tm.fine, tm.pos_enc, tm.dir_enc, tspec, *arrays)
        torch.cuda.synchronize()
        assert tft.LAUNCHES["eval"] == n0 + 1
        want = tft.fused_eval_reference(tm.fine, tm.pos_enc, tm.dir_enc, tspec, *arrays)
        # fp32 sums in another order than cuBLAS's (chip_smoke.py's bound)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [32, 64])
def test_cuda_kernel_matches_plain_at_narrow_widths(width):
    """The eval kernel at widths 32 and 64 (lego_hierarchical's depth and
    skip), as test_cuda_kernel_matches_plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    tm = t_create(_narrow(t_lego(), width), device=dev).init(torch.Generator().manual_seed(0))
    S, R = 64, 1000
    arrays = [torch.from_numpy(a).to(dev) for a in _inputs(R, S, seed=4)]
    arrays[0] *= 0.3
    tspec = tft.TrainSpec(n_samples=S, rays_block=tft.eval_block(S), mode="canonical",
                          density_activation="softplus", white_bkgd=True)
    n0 = tft.LAUNCHES["eval"]
    got = tft.fused_eval_apply(tm.fine, tm.pos_enc, tm.dir_enc, tspec, *arrays)
    torch.cuda.synchronize()
    assert tft.LAUNCHES["eval"] == n0 + 1
    want = tft.fused_eval_reference(tm.fine, tm.pos_enc, tm.dir_enc, tspec, *arrays)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
