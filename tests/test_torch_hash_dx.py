"""The hash encode's compute_dx path and its one-level-per-grid-step path
(kernels/hash_encode.py, csrc/hash_encode.cu).

* ``hash_encode_apply(enc, x, compute_dx=True)`` (on the CPU its plain
  version, ``hash_encode_dx_reference``) against JAX's
  ``hash_encode_apply(..., compute_dx=True)``, the Pallas ``_fwd_kernel`` /
  ``_bwd_kernel`` in interpret mode, on the same tables (JAX's init plus
  N(0, 0.1)) and points made with numpy: features at atol 1e-6, dX at
  rtol 1e-4 / atol 1e-5 and dG at rtol 1e-3 / atol 2e-5, the bounds of
  tests/test_hash_encode.py. With a bf16 encoding too: the compute_dx path
  computes in fp32 whatever ``hash_compute_dtype`` says, as the Pallas
  kernels do. The points lie strictly inside the box, as JAX's test's do:
  at the clip's ends ``jax.grad`` of the XLA apply splits the gradient,
  while the Pallas kernel and ``torch.clamp``'s backward pass it whole.
* ``compute_dx=False``: the points get no gradient (x is detached; JAX's op
  returns a zero dX).
* ``levels_in_body=False`` against JAX's ``hash_encode`` with
  ``levels_in_body=False`` (the Pallas ``_fwd_grid_kernel`` /
  ``_bwd_grid_kernel``) for 1, 2, 4 and 8 features a level, in fp32 and
  bf16, at points where the Pallas normalisation (·f32(1/3)) and the
  port's (/3) agree: features and dG to fp32 summation order.
* ``gpu``-marked: the four CUDA kernels against their plain versions at the
  lego_ingp size and at the Instant-NGP paper's tables, on the card
  (skipped where no card is present).
"""

import dataclasses

import numpy as np
import pytest
import torch

from nerf_meets_mlx_torch.encoding.hash_grid import HashGridEncoding
from nerf_meets_mlx_torch.kernels import hash_encode as the
from nerf_meets_mlx_torch.kernels.fused_train import LAUNCHES
from torch_threads import one_torch_thread_per_worker  # noqa: F401  (autouse fixture)

# JAX is imported by the tests that compare with it, not at module level:
# the gpu-marked tests run on the card's machine, which has no JAX
# (python -m pytest --noconftest -m gpu tests/test_torch_hash_dx.py).

SMALL = dict(n_levels=4, min_res=4, max_res=64, features_per_level=2, log2_table_size=9)


def _pair(seed=0, **kw):
    """(port encoding, JAX encoding, JAX params) on the same tables: JAX's
    init plus N(0, 0.1), so that every corner's row shows at full scale."""
    import jax
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.encoding.hash_grid import HashGridEncoding as JHash

    jenc = JHash(**kw)
    tenc = HashGridEncoding(**kw)
    tables = np.asarray(jenc.init_params(jax.random.PRNGKey(seed))["tables"])
    rng = np.random.default_rng(seed)
    tables = (tables + rng.normal(scale=0.1, size=tables.shape)).astype(np.float32)
    with torch.no_grad():
        tenc.tables.copy_(torch.from_numpy(tables))
    return tenc, jenc, {"tables": jnp.asarray(tables)}


def _interior(n, seed=1):
    """Points strictly inside the box [-1.5, 1.5]^3 (JAX's test draws them
    from 0.9 of it)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.35, 1.35, size=(n, 3)).astype(np.float32)


def _agreeing_points(n, seed):
    """Points (some outside the box) whose unit-cube coordinates the
    Pallas kernels' normalisation, (x − bmin)·f32(1/3), and the port's body
    kernels', (x − bmin)/3, round to the same float32 on every axis."""
    x = np.random.default_rng(seed).uniform(-1.6, 1.6, size=(4 * n, 3)).astype(np.float32)
    d = x - np.float32(-1.5)
    same = (d / np.float32(3.0) == d * np.float32(1.0 / 3.0)).all(axis=1)
    return np.ascontiguousarray(x[same][:n])


@pytest.mark.parametrize("f", [2, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compute_dx_matches_jax_pallas(dtype, f):
    """Features, dX and dG of the port's compute_dx path against the Pallas
    compute_dx kernels in interpret mode, at tests/test_hash_encode.py's
    bounds; with a bf16 encoding both compute in fp32."""
    import jax
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.kernels.hash_encode import hash_encode_apply as j_apply

    kw = dict(SMALL, features_per_level=f, compute_dtype=dtype)
    tenc, jenc, params = _pair(**kw)
    x = _interior(160)
    co = np.random.default_rng(5).normal(size=(160, tenc.out_dim)).astype(np.float32)

    xt = torch.from_numpy(x).requires_grad_(True)
    feats = the.hash_encode_apply(tenc, xt, compute_dx=True)
    g_x, g_t = torch.autograd.grad((feats * torch.from_numpy(co)).sum(), [xt, tenc.tables])

    def loss(p, xx):
        return jnp.sum(j_apply(jenc, p, xx, block=128, compute_dx=True) * co)

    want = np.asarray(j_apply(jenc, params, jnp.asarray(x), block=128, compute_dx=True))
    gp_j, gx_j = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    np.testing.assert_allclose(feats.detach().numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(g_x.numpy(), np.asarray(gx_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(gp_j["tables"]), rtol=1e-3, atol=2e-5)
    assert float(np.abs(np.asarray(gx_j)).max()) > 1.0  # dX at full scale, not ~0


def test_compute_dx_ignores_the_compute_dtype():
    """A bf16 encoding's compute_dx path is the fp32 one (the Pallas
    compute_dx kernels never read compute_dtype), not the bf16 body."""
    kw = dict(SMALL, features_per_level=2)
    bf16 = HashGridEncoding(**kw, compute_dtype="bfloat16").init(torch.Generator().manual_seed(0))
    f32 = HashGridEncoding(**kw)
    with torch.no_grad():
        bf16.tables.mul_(1000.0)
        f32.tables.copy_(bf16.tables)
    x = torch.from_numpy(_interior(200, seed=3))
    dx_bf16 = the.hash_encode_apply(bf16, x, compute_dx=True)
    torch.testing.assert_close(dx_bf16, the.hash_encode_apply(f32, x, compute_dx=True),
                               rtol=0, atol=0)
    assert not torch.equal(dx_bf16, the.hash_encode_apply(bf16, x))


def test_without_compute_dx_the_points_get_no_gradient():
    """compute_dx=False: x is detached (JAX returns a zero dX there); the
    tables still get their gradient. CPU tensors launch nothing."""
    tenc = HashGridEncoding(**SMALL).init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_interior(50)).requires_grad_(True)
    n0 = dict(LAUNCHES)
    for kw in (dict(), dict(levels_in_body=False)):
        the.hash_encode_apply(tenc, x, **kw).sum().backward()
        assert x.grad is None and tenc.tables.grad is not None
    out = the.hash_encode_apply(tenc, x, compute_dx=True)
    out.sum().backward()
    assert x.grad is not None and float(x.grad.abs().max()) > 0
    assert LAUNCHES == n0


@pytest.mark.parametrize("f", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grid_path_matches_jax_pallas(dtype, f):
    """levels_in_body=False: the port's op against JAX's hash_encode with
    the one-level-per-grid-step kernels in interpret mode, features and dG
    to fp32 summation order (rtol 1e-5 / atol 1e-7; dG atol 1e-6)."""
    import jax
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.kernels.hash_encode import HashEncodeSpec, hash_encode, pack_tables

    kw = dict(SMALL, features_per_level=f, compute_dtype=dtype)
    tenc, jenc, params = _pair(**kw)
    spec = dataclasses.replace(HashEncodeSpec.from_encoding(jenc, block=128),
                               levels_in_body=False)
    assert spec.compute_dtype == dtype
    x = _agreeing_points(300, seed=4)
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (0, 5)))  # the lane padding hash_encode_apply makes
    co = np.random.default_rng(9).normal(size=(len(x), tenc.out_dim)).astype(np.float32)

    feats = the.hash_encode_apply(tenc, torch.from_numpy(x), levels_in_body=False)
    (g_t,) = torch.autograd.grad((feats * torch.from_numpy(co)).sum(), tenc.tables)
    want = np.asarray(hash_encode(spec, pack_tables(spec, params["tables"]), xp))
    g_j = jax.grad(lambda t: jnp.sum(hash_encode(spec, pack_tables(spec, t), xp) * co))(
        params["tables"])
    np.testing.assert_allclose(feats.detach().numpy(), want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-6)


def test_shape_bounds():
    """The CUDA hash kernels take 1..32 levels of 1, 2, 4 or 8 features and
    at most 128 feature channels; past them the check raises."""
    for kw in (dict(n_levels=32, features_per_level=4), dict(n_levels=16, features_per_level=8),
               dict(n_levels=1, features_per_level=1)):
        the.check_hash_encoding(HashGridEncoding(**dict(SMALL, **kw)))
    for kw in (dict(n_levels=33, features_per_level=1), dict(n_levels=4, features_per_level=3),
               dict(n_levels=32, features_per_level=8)):
        with pytest.raises(ValueError, match="feature channels"):
            the.check_hash_encoding(HashGridEncoding(**dict(SMALL, **kw)))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

LEGO_INGP = dict(n_levels=8, min_res=16, max_res=256, features_per_level=2, log2_table_size=14)
PAPER = dict(n_levels=16, min_res=16, max_res=512, features_per_level=2, log2_table_size=19)


def _cuda_encoding(kw, dtype="float32"):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    tenc = HashGridEncoding(**kw, compute_dtype=dtype, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        tenc.tables.add_(torch.randn(tenc.tables.shape, device=dev) * 0.1)
    return tenc, dev


def _cuda_points(n, dev, seed=6):
    # some outside the box: the clip and its mask are part of the function
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand((n, 3), generator=g, device=dev) * 3.2 - 1.6


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("enc", ["lego_ingp", "paper"])
def test_cuda_compute_dx_kernels_match_plain(enc, dtype):
    """The compute_dx forward and backward kernels against autograd through
    ``hash_encode_dx_reference`` on 100,003 points: features to atol 1e-6
    (the same fp32 operations, corners in the same order), dX within 1e-4
    of its largest plain value (sums over levels and corners in another
    order), dG within 1e-3 of its largest plain value (atomics)."""
    tenc, dev = _cuda_encoding(LEGO_INGP if enc == "lego_ingp" else PAPER, dtype)
    x = _cuda_points(100_003, dev).requires_grad_(True)
    n0 = dict(LAUNCHES)
    feats = the.hash_encode_apply(tenc, x, compute_dx=True)
    dout = torch.randn(feats.shape, generator=torch.Generator(device=dev).manual_seed(1),
                       device=dev)
    g_x, g_t = torch.autograd.grad((feats * dout).sum(), [x, tenc.tables])
    torch.cuda.synchronize()
    assert LAUNCHES["hash_dx_fwd"] == n0["hash_dx_fwd"] + 1
    assert LAUNCHES["hash_dx_bwd"] == n0["hash_dx_bwd"] + 1
    feats_p = the.hash_encode_dx_reference(tenc, x)
    p_x, p_t = torch.autograd.grad((feats_p * dout).sum(), [x, tenc.tables])
    torch.testing.assert_close(feats, feats_p, rtol=0, atol=1e-6)
    assert float((g_x - p_x).abs().max()) <= 1e-4 * float(p_x.abs().max())
    assert float((g_t - p_t).abs().max()) <= 1e-3 * float(p_t.abs().max())
    assert float(p_x.abs().max()) > 0 and bool((g_x[(x.abs() > 1.5).any(-1)] == 0).any())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("f", [1, 2, 4, 8])
def test_cuda_grid_kernels_match_plain(f, dtype):
    """levels_in_body=False on the card: the features equal to the plain
    version's (``hash_encode_reference``: the same operations in the same
    order), dG to rtol 1e-4 / atol 1e-5 of its scatter-add (atomics), on
    100,003 points at the lego_ingp levels with F features a level."""
    tenc, dev = _cuda_encoding(dict(LEGO_INGP, features_per_level=f), dtype)
    x = _cuda_points(100_003, dev)
    n0 = dict(LAUNCHES)
    feats = the.hash_encode_apply(tenc, x, levels_in_body=False)
    dout = torch.randn(feats.shape, generator=torch.Generator(device=dev).manual_seed(1),
                       device=dev)
    (g,) = torch.autograd.grad((feats * dout).sum(), tenc.tables)
    torch.cuda.synchronize()
    assert LAUNCHES["hash_grid_fwd"] == n0["hash_grid_fwd"] + 1
    assert LAUNCHES["hash_grid_bwd"] == n0["hash_grid_bwd"] + 1
    assert LAUNCHES["hash_fwd"] == n0["hash_fwd"]
    feats_p = the.hash_encode_reference(tenc, x)
    (g_p,) = torch.autograd.grad((feats_p * dout).sum(), tenc.tables)
    torch.testing.assert_close(feats, feats_p, rtol=0, atol=0)
    torch.testing.assert_close(g, g_p, rtol=1e-4, atol=1e-5)
