"""The port's CP encode op (kernels/cp_encode.py, csrc/cp_encode.cu).

* ``cp_encode_reference`` (``cp_fwd_reference`` / ``cp_bwd_reference``)
  and ``cp_encode_apply`` on the CPU against JAX's
  ``cp_encode_apply``, whose forward and backward are the Pallas
  ``_fwd_grid_kernel`` / ``_bwd_grid_kernel`` in interpret mode, at
  ``block=128`` with N not a multiple of the block, in both compute types,
  within tests/test_cp_encode.py's own bounds: the bf16 forward at rtol
  1e-3 / atol 1e-5 (:31), the fp32 forward at rtol 1e-5 / atol 1e-6 (:40),
  the fp32 dLines at rtol 1e-3 / atol 2e-5 (:59) and the bf16 dLines at
  rtol 3e-2 / atol 2e-2 of their largest value (:76-78), per level with
  the levels' own shapes.
* The Pallas semantics against the XLA ``CPGridEncoding.apply``: the
  normalisation and the dLines rounding are the only differences.
* The wrapper's routing, its bounds, and the op as a drop-in for the
  model's encode (lego_cp's query), as ``chip_smoke.py`` uses it.
* ``gpu``-marked: both CUDA kernels against the plain versions at the
  lego_cp size, on the card (skipped where no card is present).
"""

import dataclasses

import numpy as np
import pytest
import torch

from nerf_meets_mlx_torch.config import lego_cp as t_cp
from nerf_meets_mlx_torch.encoding.cp_grid import CPGridEncoding, two_taps
from nerf_meets_mlx_torch.kernels import cp_encode as tce
from nerf_meets_mlx_torch.kernels.fused_train import LAUNCHES
from nerf_meets_mlx_torch.models import create_nerf as t_create

# JAX is imported by the tests that compare with it, not at module level:
# the gpu-marked tests run on the card's machine, which has no JAX
# (python -m pytest --noconftest -m gpu tests/test_torch_cp_encode.py).

SMALL = dict(n_levels=3, min_res=8, max_res=40, n_components=16)


def _pair(dtype, seed=0):
    """(port encoding, JAX encoding, JAX params) on JAX's init lines."""
    import jax

    from nerf_meets_mlx_tpu.encoding.cp_grid import CPGridEncoding as JCP

    jenc = JCP(**SMALL, compute_dtype=dtype)
    tenc = CPGridEncoding(**SMALL, compute_dtype=dtype)
    params = jenc.init_params(jax.random.PRNGKey(seed))
    with torch.no_grad():
        for dst, src in zip(tenc.lines, params["lines"]):
            dst.copy_(torch.from_numpy(np.array(src)))
    return tenc, jenc, params


def _points(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.5 * 0.95, 1.5 * 0.95, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("dtype,n", [("bfloat16", 300), ("float32", 257), ("bfloat16", 130)])
def test_cp_encode_matches_jax_pallas(dtype, n):
    import jax
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.kernels.cp_encode import cp_encode_apply as j_apply

    tenc, jenc, params = _pair(dtype)
    x = _points(n)
    co = np.random.default_rng(3).normal(size=(n, tenc.out_dim)).astype(np.float32)
    LAUNCHES["cp_fwd"] = LAUNCHES["cp_bwd"] = 0
    feats = tce.cp_encode_apply(tenc, torch.from_numpy(x))
    grads = torch.autograd.grad((feats * torch.from_numpy(co)).sum(), list(tenc.lines))
    assert LAUNCHES["cp_fwd"] == LAUNCHES["cp_bwd"] == 0  # the CPU runs the plain versions
    twin = tce.cp_encode_reference(tenc, torch.from_numpy(x))
    torch.testing.assert_close(twin, feats, rtol=0, atol=0)
    want = np.asarray(j_apply(jenc, params, jnp.asarray(x), block=128))
    g_j = jax.grad(lambda p: jnp.sum(j_apply(jenc, p, jnp.asarray(x), block=128) * co))(
        params)["lines"]
    if dtype == "float32":
        np.testing.assert_allclose(feats.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(feats.detach().numpy(), want, rtol=1e-3, atol=1e-5)
    assert len(grads) == len(g_j) == 3
    for a, b in zip(grads, g_j):
        assert a.shape == b.shape  # per-level shapes, no padding
        b = np.asarray(b)
        if dtype == "float32":
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-3, atol=2e-5)
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=3e-2, atol=2e-2 * np.abs(b).max())


def test_pallas_semantics_differ_from_xla_by_rounding_only():
    """The twin against CPGridEncoding.apply (the XLA semantics): in fp32 the
    normalisation (multiply by f32(1/3) vs divide by 3) moves a weight by an
    ulp; in bf16 that can cross a rounding boundary, and dLines keeps fp32
    sums where the XLA path rounds them to bf16 once."""
    for dtype, fwd, grad in (("float32", 1e-5, 1e-4), ("bfloat16", 1e-2, 8e-3)):
        tenc, _, _ = _pair(dtype)
        x = torch.from_numpy(_points(400, seed=5))
        a = tce.cp_encode_apply(tenc, x)
        b = tenc.apply(x)
        torch.testing.assert_close(a, b, rtol=fwd, atol=fwd * float(b.abs().max()))
        ga = torch.autograd.grad((a ** 2).sum(), list(tenc.lines))
        gb = torch.autograd.grad((b ** 2).sum(), list(tenc.lines))
        for p, q in zip(ga, gb):
            torch.testing.assert_close(p, q, rtol=grad, atol=grad * float(q.abs().max()))


def test_reference_functions_and_flat_layout():
    """cp_bwd_reference is the gradient of cp_fwd_reference's Σ dout·feats
    in fp32 (autograd through the twin's gathers agrees), and the flat
    buffer's per-level split recovers the lines."""
    tenc, _, _ = _pair("float32")
    spec = tce.CPEncodeSpec.from_encoding(tenc)
    assert spec.resolutions == (8, 17, 40) and spec.out_dim == 48
    assert spec.inv_range == float(np.float32(1.0 / 3.0))
    x = torch.from_numpy(_points(100, seed=6))
    dout = torch.randn((100, 48), generator=torch.Generator().manual_seed(0))
    lines = [p.detach().clone().requires_grad_(True) for p in tenc.lines]
    with torch.enable_grad():
        u = torch.clamp((x - spec.bbox_min) * spec.inv_range, 0.0, 1.0)
        feats = []
        for r, lv in zip(spec.resolutions, lines):
            i0, w0, w1 = two_taps(u * (r - 1), r)
            f = [w0[:, a:a + 1] * lv[a][i0[:, a]] + w1[:, a:a + 1] * lv[a][i0[:, a] + 1]
                 for a in range(3)]
            feats.append((f[0] * f[1]) * f[2])
        auto = torch.autograd.grad((torch.cat(feats, -1) * dout).sum(), lines)
    torch.testing.assert_close(torch.cat(feats, -1).detach(),
                               tce.cp_fwd_reference(spec, tenc.lines, x), rtol=0, atol=0)
    for a, b in zip(tce.cp_bwd_reference(spec, tenc.lines, x, dout), auto):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    flat = tce.flatten_lines(tenc.lines)
    assert flat.numel() == 3 * (8 + 17 + 40) * 16
    for a, b in zip(tce.split_lines(spec, flat), tenc.lines):
        assert torch.equal(a, b.detach())


def test_wrapper_routes_by_device_and_guards_shapes():
    tenc, _, _ = _pair("bfloat16")
    x = torch.from_numpy(_points(10)).requires_grad_(True)
    out = tce.cp_encode_apply(tenc, x)
    out.sum().backward()
    assert x.grad is None and all(p.grad is not None for p in tenc.lines)
    with pytest.raises(ValueError):
        tce.cp_encode_apply(tenc, x.detach().to("meta"))
    tce.check_cp_encoding(tce.CPEncodeSpec.from_encoding(CPGridEncoding()))  # lego_cp
    with pytest.raises(ValueError, match="multiples of 4"):
        tce.check_cp_encoding(tce.CPEncodeSpec.from_encoding(CPGridEncoding(n_components=6)))
    with pytest.raises(ValueError, match="shared memory"):
        tce.check_cp_encoding(tce.CPEncodeSpec.from_encoding(
            CPGridEncoding(n_levels=1, min_res=4096, max_res=4096, n_components=16)))


def test_cp_encode_as_lego_cp_query_encode():
    """The drop-in behind lego_cp's query, as chip_smoke.py puts it there (no
    config key): the model's encode replaced on its own instance by
    cp_encode_apply. A train-mode render on both model objects, from the
    same weights and draws: losses within the bf16 semantics' difference,
    and the lines receive gradients through the op."""
    cfg = t_cp()
    cfg = cfg.replace(render=dataclasses.replace(cfg.render, n_samples=8, n_importance=8))
    tm = t_create(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    km = t_create(cfg, device="cpu")
    km.load_state_dict(tm.state_dict())
    km._encode_pos = lambda pts: tce.cp_encode_apply(km.pos_enc, pts)
    g = torch.Generator().manual_seed(1)
    ro = torch.randn((16, 3), generator=g) * 0.1 + torch.tensor([0.0, 0.0, 3.0])
    rd = torch.randn((16, 3), generator=g) * 0.2 + torch.tensor([0.0, 0.0, -1.0])
    draws = {"t": torch.rand((16, 8), generator=g), "u": torch.rand((16, 8), generator=g),
             "noise_c": torch.zeros((16, 8)), "noise_f": torch.zeros((16, 16))}
    out_t = tm.render_rays(ro, rd, train=True, draws=draws)
    out_k = km.render_rays(ro, rd, train=True, draws=draws)
    torch.testing.assert_close(out_k["rgb_map"], out_t["rgb_map"], rtol=1e-2, atol=1e-3)
    out_k["rgb_map"].sum().backward()
    assert all(float(p.grad.abs().max()) > 0 for p in km.pos_enc.lines)


def _cuda_pair(dtype, dev):
    enc = CPGridEncoding(compute_dtype=dtype, device=dev)  # lego_cp's grid
    return enc.init(torch.Generator(device=dev).manual_seed(0))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_cp_kernels_match_twin(dtype):
    """Both kernels at lego_cp's grid (4 levels of 64..512 nodes, C = 16) on
    100,003 points (some outside the box): the features within atol 1e-6 +
    rtol 1e-5 of the plain version (the same roundings; sums of two exact
    products), dLines within 1e-4 of the plain version's largest value
    (atomics add in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    enc = _cuda_pair(dtype, dev)
    spec = tce.CPEncodeSpec.from_encoding(enc)
    g = torch.Generator(device=dev).manual_seed(1)
    x = (torch.rand((100_003, 3), generator=g, device=dev) * 3.4 - 1.7).contiguous()
    dout = torch.randn((100_003, spec.out_dim), generator=g, device=dev)
    n0 = dict(LAUNCHES)
    feats = tce.cp_encode_apply(enc, x)
    grads = torch.autograd.grad((feats * dout).sum(), list(enc.lines))
    torch.cuda.synchronize()
    assert LAUNCHES["cp_fwd"] == n0["cp_fwd"] + 1 and LAUNCHES["cp_bwd"] == n0["cp_bwd"] + 1
    torch.testing.assert_close(feats, tce.cp_fwd_reference(spec, enc.lines, x), rtol=1e-5,
                               atol=1e-6)
    for a, b in zip(grads, tce.cp_bwd_reference(spec, enc.lines, x, dout)):
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        assert a.shape == b.shape and err <= 1e-4 * scale, (err, scale)
