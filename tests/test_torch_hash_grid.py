"""The port's direction and hash-grid encodings and its hash-encode op
(encoding/spherical_harmonics.py, encoding/hash_grid.py,
kernels/hash_encode.py, csrc/hash_encode.cu).

* ``sh_encode`` against JAX's at degrees 0..4, to 1e-6.
* ``HashGridEncoding.apply`` (the plain version) against JAX's XLA apply at
  the full lego_ingp size on 3,000 points, and against JAX's
  ``hash_encode_apply`` (the Pallas ``_fwd_body_kernel`` in interpret mode)
  at the small shape the JAX package's own tests use, at atol 1e-6.
* The table gradient through the port's ``hash_encode_apply`` against
  ``jax.grad`` through JAX's (the Pallas ``_bwd_body_kernel``), at rtol 1e-5
  / atol 1e-7; the hash's wrap mod 2^32 on corners whose products exceed
  2^32; the float64 level resolutions; the tables through ``interop``.
* ``gpu``-marked: both CUDA kernels against the plain version at the
  lego_ingp size, on the card (skipped where no card is present).
"""

import numpy as np
import pytest
import torch

from nerf_meets_mlx_torch import interop
from nerf_meets_mlx_torch.config import lego_ingp as t_ingp
from nerf_meets_mlx_torch.encoding.hash_grid import (
    HashGridEncoding,
    _level_resolutions,
    corner_hash,
)
from nerf_meets_mlx_torch.encoding.spherical_harmonics import sh_encode
from nerf_meets_mlx_torch.kernels import hash_encode as the
from nerf_meets_mlx_torch.kernels.fused_train import LAUNCHES
from nerf_meets_mlx_torch.models import create_nerf as t_create
from torch_threads import one_torch_thread_per_worker  # noqa: F401  (autouse fixture)

# JAX is imported by the tests that compare with it, not at module level:
# the gpu-marked tests run on the card's machine, which has no JAX
# (python -m pytest --noconftest -m gpu tests/test_torch_hash_grid.py).


def _dirs(n=257, seed=0):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_sh_encode_matches_jax(degree):
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.encoding.spherical_harmonics import sh_encode as j_sh

    d = _dirs()
    got = sh_encode(torch.from_numpy(d), degree).numpy()
    want = np.asarray(j_sh(jnp.asarray(d), degree))
    assert got.shape == want.shape == (len(d), (degree + 1) ** 2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _pair(seed=0, noisy=True, **kw):
    """(port encoding, JAX encoding, JAX params) on the same tables: JAX's
    init (U(-1e-4, 1e-4)), plus N(0, 0.1) when ``noisy`` so that every
    corner's row shows at full scale."""
    import jax
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.encoding.hash_grid import HashGridEncoding as JHash

    jenc = JHash(**kw)
    tenc = HashGridEncoding(**kw)
    tables = np.asarray(jenc.init_params(jax.random.PRNGKey(seed))["tables"])
    if noisy:
        rng = np.random.default_rng(seed)
        tables = (tables + rng.normal(scale=0.1, size=tables.shape)).astype(np.float32)
    with torch.no_grad():
        tenc.tables.copy_(torch.from_numpy(tables))
    return tenc, jenc, {"tables": jnp.asarray(tables)}


def _points(n, seed=1, scale=1.0):
    # some points outside the box: the clip is part of the function
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1.6, 1.6, size=(n, 3)) * scale).astype(np.float32)


SMALL = dict(n_levels=4, min_res=4, max_res=64, features_per_level=2, log2_table_size=9)


def _preset_kw():
    p = t_ingp().pos_encoding
    return dict(n_levels=p.hash_n_levels, min_res=p.hash_min_res, max_res=p.hash_max_res,
                features_per_level=p.hash_features_per_level,
                log2_table_size=p.hash_log2_table_size)


def test_hash_apply_matches_jax_xla_at_preset_size():
    """L = 8, T = 2^14, F = 2, resolutions 16..256, 3,000 points."""
    import jax.numpy as jnp

    tenc, jenc, params = _pair(**_preset_kw())
    assert tuple(tenc.resolutions) == (16, 23, 35, 52, 78, 115, 172, 256)
    x = _points(3000)
    got = tenc.apply(torch.from_numpy(x)).detach().numpy()
    want = np.asarray(jenc.apply(params, jnp.asarray(x)))
    assert got.shape == (3000, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


PAPER = dict(n_levels=16, min_res=16, max_res=512, features_per_level=2, log2_table_size=19)


def test_hash_apply_matches_jax_xla_at_paper_size():
    """The Instant-NGP paper's grid (Müller et al. 2022, Table 1; the JAX
    package's default ``HashGridEncoding``): L = 16, T = 2^19, F = 2,
    resolutions 16..512, on 1,000 points. At resolution 512 the corner
    products wrap mod 2^32."""
    import jax.numpy as jnp

    tenc, jenc, params = _pair(**PAPER)
    assert tuple(tenc.tables.shape) == (16, 1 << 19, 2) and tenc.resolutions[-1] == 512
    x = _points(1000)
    got = tenc.apply(torch.from_numpy(x)).detach().numpy()
    want = np.asarray(jenc.apply(params, jnp.asarray(x)))
    assert got.shape == (1000, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_hash_table_grad_matches_jax_xla():
    """The table gradient of Σ co · feats at the preset size against
    jax.grad through the XLA apply (a scatter-add in both: sums in another
    order)."""
    import jax
    import jax.numpy as jnp

    tenc, jenc, params = _pair(**_preset_kw())
    x = _points(2000, seed=7)
    co = np.random.default_rng(8).normal(size=(2000, tenc.out_dim)).astype(np.float32)
    (g_t,) = torch.autograd.grad((tenc.apply(torch.from_numpy(x)) * torch.from_numpy(co)).sum(),
                                 tenc.tables)
    g_j = jax.grad(lambda p: jnp.sum(jenc.apply(p, jnp.asarray(x)) * jnp.asarray(co)))(params)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j["tables"]), rtol=1e-5, atol=1e-6)


def test_hash_encode_apply_matches_jax_pallas():
    """The port's op on the CPU (its plain version) against JAX's
    ``hash_encode_apply`` (the Pallas kernel in interpret mode) on JAX's
    init tables, as tests/test_hash_encode.py holds the Pallas kernel: the
    kernel normalises by multiplying with 1/(box size), which moves the
    trilinear weights by up to res·ulp; leading batch dimensions kept."""
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.kernels.hash_encode import hash_encode_apply as j_apply

    tenc, jenc, params = _pair(noisy=False, **SMALL)
    x = _points(300, seed=2, scale=0.9).reshape(3, 100, 3)
    got = the.hash_encode_apply(tenc, torch.from_numpy(x)).detach().numpy()
    want = np.asarray(j_apply(jenc, params, jnp.asarray(x), block=128))
    assert got.shape == (3, 100, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_hash_table_grad_matches_jax_pallas():
    """d(Σ feats²)/d(tables) through the port's op against jax.grad through
    JAX's hash_encode_apply, whose backward is the Pallas _bwd_body_kernel
    (a GEMM contraction; torch's autograd scatter-adds with index_put: sums
    in another order), on the shapes and init tables of
    tests/test_hash_encode.py's gradient test (2 levels, T = 2^8, [4, 24, 3]
    points)."""
    import jax
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.kernels.hash_encode import hash_encode_apply as j_apply

    kw = dict(SMALL, n_levels=2, log2_table_size=8)
    tenc, jenc, params = _pair(noisy=False, **kw)
    x = _points(96, seed=3, scale=0.9).reshape(4, 24, 3)
    feats = the.hash_encode_apply(tenc, torch.from_numpy(x))
    (g_t,) = torch.autograd.grad((feats ** 2).sum(), tenc.tables)
    g_j = jax.grad(lambda p: jnp.sum(j_apply(jenc, p, jnp.asarray(x), block=64) ** 2))(params)
    g_j = np.asarray(g_j["tables"])
    assert np.count_nonzero(g_j) > 0
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-5, atol=1e-7)


def test_hash_wraps_mod_2_32():
    """Corners whose y and z products exceed 2^32 (and 2^63 would not be
    reached): the port's int64 hash equals uint32 arithmetic."""
    rng = np.random.default_rng(5)
    ix, iy, iz = (rng.integers(0, 1 << 20, size=500, dtype=np.int64) for _ in range(3))
    iy[:3] = [2, 1 << 19, (1 << 20) - 1]
    assert (iy.astype(object) * 2654435761 >= 1 << 32).mean() > 0.99
    want = (
        (ix.astype(np.uint32) * np.uint32(1))
        ^ (iy.astype(np.uint32) * np.uint32(2654435761))
        ^ (iz.astype(np.uint32) * np.uint32(805459861))
    ) & np.uint32((1 << 14) - 1)
    got = corner_hash(*(torch.from_numpy(a) for a in (ix, iy, iz)), 1 << 14)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("n_levels,min_res,max_res", [(8, 16, 256), (16, 16, 512), (16, 16, 2048)])
def test_level_resolutions_match_jax(n_levels, min_res, max_res):
    from nerf_meets_mlx_tpu.encoding.hash_grid import _level_resolutions as j_res

    got = _level_resolutions(n_levels, min_res, max_res)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, j_res(n_levels, min_res, max_res))


def test_tables_cross_interop_and_the_checkpoint_keys():
    """The model's tables are a parameter of the model (in parameters() and
    state_dict()) and cross to and from the JAX pytree as [L, T, F]."""
    import jax

    from nerf_meets_mlx_tpu.config import lego_ingp as j_ingp
    from nerf_meets_mlx_tpu.models import create_nerf as j_create

    tm = t_create(t_ingp(), device="cpu")
    assert "pos_enc.tables" in tm.state_dict()
    assert any(p is tm.pos_enc.tables for p in tm.parameters())
    params = j_create(j_ingp()).init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    interop.params_from_numpy(tree, tm)
    back = interop.params_to_numpy(tm)
    np.testing.assert_array_equal(back["pos_enc"]["tables"], tree["pos_enc"]["tables"])
    assert back["dir_enc"] == {} and tree["dir_enc"] == {}
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    bad = dict(tree, pos_enc={"tables": tree["pos_enc"]["tables"][:, :10]})
    with pytest.raises(ValueError, match="tables"):
        interop.params_from_numpy(bad, tm)


def test_wrapper_routes_by_device():
    """CPU tensors run the plain version and launch nothing; other devices
    raise; the points get no gradient."""
    tenc = HashGridEncoding(**SMALL).init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_points(10)).requires_grad_(True)
    LAUNCHES["hash_fwd"] = LAUNCHES["hash_bwd"] = 0
    out = the.hash_encode_apply(tenc, x)
    out.sum().backward()
    assert LAUNCHES["hash_fwd"] == LAUNCHES["hash_bwd"] == 0
    assert x.grad is None and tenc.tables.grad is not None
    torch.testing.assert_close(out, tenc.apply(x.detach()), rtol=0, atol=0)
    with pytest.raises(ValueError):
        the.hash_encode_apply(tenc, x.detach().to("meta"))
    bf16 = HashGridEncoding(**SMALL, compute_dtype="bfloat16")
    the.check_hash_encoding(bf16)  # the CUDA kernels take bf16 compute
    with pytest.raises(ValueError, match="compute_dtype"):
        the.check_hash_encoding(HashGridEncoding(**SMALL, compute_dtype="float16"))


def _agreeing_points(n, seed):
    """Points (some outside the box) whose unit-cube coordinates the
    Pallas kernels' normalisation, (x − bmin)·f32(1/3), and the port's,
    (x − bmin)/3, round to the same float32 on every axis."""
    x = _points(4 * n, seed=seed)
    d = x - np.float32(-1.5)
    same = (d / np.float32(3.0) == d * np.float32(1.0 / 3.0)).all(axis=1)
    return np.ascontiguousarray(x[same][:n])


@pytest.mark.parametrize("f", [1, 2, 4])
def test_bf16_hash_encode_matches_jax_pallas(f):
    """hash_compute_dtype = bfloat16: the port's op on the CPU (its bf16
    twin) against JAX's hash_encode_apply with compute_dtype "bfloat16" (the
    Pallas body kernels in interpret mode).

    * On JAX's init tables, within tests/test_hash_encode.py's bf16 bounds
      (features atol 5e-6; dG atol 2e-2 of its largest value).
    * On noisy tables, at points where both normalisations agree, the
      rounding sites themselves: features and dG to fp32 summation order
      (rtol 1e-5 / atol 1e-7)."""
    import jax
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.kernels.hash_encode import hash_encode_apply as j_apply

    kw = dict(SMALL, features_per_level=f, compute_dtype="bfloat16")
    for noisy, x, bounds in (
        (False, _points(300, seed=4, scale=0.9), dict(rtol=0, atol=5e-6)),
        (True, _agreeing_points(300, seed=4), dict(rtol=1e-5, atol=1e-7)),
    ):
        tenc, jenc, params = _pair(noisy=noisy, **kw)
        assert tenc.compute_dtype == jenc.compute_dtype == "bfloat16"
        co = np.random.default_rng(9).normal(size=(len(x), tenc.out_dim)).astype(np.float32)
        feats = the.hash_encode_apply(tenc, torch.from_numpy(x))
        (g_t,) = torch.autograd.grad((feats * torch.from_numpy(co)).sum(), tenc.tables)
        want = np.asarray(j_apply(jenc, params, jnp.asarray(x), block=128))
        np.testing.assert_allclose(feats.detach().numpy(), want, **bounds)
        g_j = jax.grad(lambda p: jnp.sum(j_apply(jenc, p, jnp.asarray(x), block=128) * co))(
            params)
        g_j = np.asarray(g_j["tables"])
        if noisy:
            np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-5, atol=1e-6)
        else:
            scale = float(np.abs(g_j).max())
            np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0, atol=2e-2 * scale)
    # the model's plain encode reads the tables in fp32 in either mode
    f32 = HashGridEncoding(**dict(kw, compute_dtype="float32"))
    with torch.no_grad():
        f32.tables.copy_(tenc.tables)
        plain = tenc.apply(torch.from_numpy(x))
        torch.testing.assert_close(plain, f32.apply(torch.from_numpy(x)), rtol=0, atol=0)
        assert not torch.equal(plain, feats)


@pytest.mark.gpu
def test_cuda_hash_kernels_match_plain():
    """Both kernels at the lego_ingp size on 100,003 points (some outside
    the box): features equal to the plain version's (the same IEEE
    operations in the same order); dG to rtol 1e-4 / atol 1e-5 of the
    plain scatter-add (atomics add in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    tenc = HashGridEncoding(**_preset_kw(), device=dev).init(
        torch.Generator(device=dev).manual_seed(0)
    )
    with torch.no_grad():
        tenc.tables.add_(torch.randn(tenc.tables.shape, device=dev) * 0.1)
    x = torch.from_numpy(_points(100_003, seed=6)).to(dev)
    n0 = dict(LAUNCHES)
    feats = the.hash_encode_apply(tenc, x)
    dout = torch.randn(feats.shape, generator=torch.Generator(device=dev).manual_seed(1),
                       device=dev)
    (g,) = torch.autograd.grad((feats * dout).sum(), tenc.tables)
    torch.cuda.synchronize()
    assert LAUNCHES["hash_fwd"] == n0["hash_fwd"] + 1
    assert LAUNCHES["hash_bwd"] == n0["hash_bwd"] + 1
    feats_p = tenc.apply(x)
    (g_p,) = torch.autograd.grad((feats_p * dout).sum(), tenc.tables)
    torch.testing.assert_close(feats, feats_p, rtol=0, atol=0)
    torch.testing.assert_close(g, g_p, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("f", [1, 2, 4])
def test_cuda_bf16_hash_kernels_match_twin(f):
    """bf16 hash compute on the card: the forward kernel equal to the bf16
    twin (the same roundings in the same order), dG to rtol 1e-4 / atol
    1e-5 of the twin's (atomics add in another order), on 100,003 points at
    the lego_ingp levels with F features a level."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    kw = dict(_preset_kw(), features_per_level=f, compute_dtype="bfloat16")
    tenc = HashGridEncoding(**kw, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        tenc.tables.add_(torch.randn(tenc.tables.shape, device=dev) * 0.1)
    x = torch.from_numpy(_points(100_003, seed=6)).to(dev)
    feats = the.hash_encode_apply(tenc, x)
    dout = torch.randn(feats.shape, generator=torch.Generator(device=dev).manual_seed(1),
                       device=dev)
    (g,) = torch.autograd.grad((feats * dout).sum(), tenc.tables)
    feats_p = the.hash_encode_reference(tenc, x)
    (g_p,) = torch.autograd.grad((feats_p * dout).sum(), tenc.tables)
    torch.cuda.synchronize()
    torch.testing.assert_close(feats, feats_p, rtol=0, atol=0)
    torch.testing.assert_close(g, g_p, rtol=1e-4, atol=1e-5)
