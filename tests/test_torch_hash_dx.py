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
* The compute_dx backward's two kernels: the dG walk's grouping and the dX
  kernel's arithmetic emulated on the CPU against the Pallas
  ``_bwd_kernel`` on ray-ordered points, and their grids' cover of every
  point and level.
* ``gpu``-marked: the four CUDA kernels against their plain versions at the
  lego_ingp size and at the Instant-NGP paper's tables, the compute_dx
  backward also on ray-ordered points at 1, 2, 4 and 8 features a level,
  on the card (skipped where no card is present).
"""

import dataclasses

import numpy as np
import pytest
import torch

from nerf_meets_mlx_torch.encoding.hash_grid import HashGridEncoding
from nerf_meets_mlx_torch.kernels import hash_encode as the
from nerf_meets_mlx_torch.kernels.fused_train import LAUNCHES
from test_torch_hash_grid import _cells_and_terms, _dead_rows, _merged_runs_dG
from test_torch_ingp_eval import _graph_launches
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


def _compute_dx_against_pallas(tenc, jenc, params, x, co):
    """Features, dX and dG of the port's compute_dx path on points ``x``
    with cotangent ``co`` against JAX's Pallas compute_dx kernels in
    interpret mode, at tests/test_hash_encode.py's bounds."""
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.kernels.hash_encode import hash_encode_apply as j_apply

    xt = torch.from_numpy(x).requires_grad_(True)
    feats = the.hash_encode_apply(tenc, xt, compute_dx=True)
    g_x, g_t = torch.autograd.grad((feats * torch.from_numpy(co)).sum(), [xt, tenc.tables])
    want = np.asarray(j_apply(jenc, params, jnp.asarray(x), block=128, compute_dx=True))
    gx_j, gt_j = _jax_compute_dx_grads(jenc, params, x, co)
    np.testing.assert_allclose(feats.detach().numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(g_x.numpy(), gx_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), gt_j, rtol=1e-3, atol=2e-5)
    assert float(np.abs(gx_j).max()) > 1.0  # dX at full scale, not ~0


def _jax_compute_dx_grads(jenc, params, x, co):
    """(dX, dG) of Σ co · feats through JAX's compute_dx path (the Pallas
    ``_fwd_kernel`` / ``_bwd_kernel`` in interpret mode)."""
    import jax
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.kernels.hash_encode import hash_encode_apply as j_apply

    def loss(p, xx):
        return jnp.sum(j_apply(jenc, p, xx, block=128, compute_dx=True) * co)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    return np.asarray(gx), np.asarray(gp["tables"])


@pytest.mark.parametrize("f", [2, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compute_dx_matches_jax_pallas(dtype, f):
    """Features, dX and dG of the port's compute_dx path against the Pallas
    compute_dx kernels in interpret mode, at tests/test_hash_encode.py's
    bounds; with a bf16 encoding both compute in fp32."""
    tenc, jenc, params = _pair(**dict(SMALL, features_per_level=f, compute_dtype=dtype))
    co = np.random.default_rng(5).normal(size=(160, tenc.out_dim)).astype(np.float32)
    _compute_dx_against_pallas(tenc, jenc, params, _interior(160), co)


def _ray_points(n_rays, n_samples, seed):
    """Points along rays, [rays, samples] flattened as the model's routes
    give them: origins 4 from the box's centre, aimed within 0.5 of it,
    depths sorted uniform in [2, 6], so that consecutive samples share a
    coarse cell and some lie outside the box."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n_rays, 3))
    o *= 4.0 / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.uniform(-0.5, 0.5, size=(n_rays, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    z = np.sort(rng.uniform(2.0, 6.0, size=(n_rays, n_samples)), axis=1)
    return (o[:, None] + z[..., None] * d[:, None]).reshape(-1, 3).astype(np.float32)


@pytest.mark.parametrize("f", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compute_dx_forward_on_ray_points_matches_jax_pallas(dtype, f):
    """The compute_dx forward (on the CPU its plain version) against the
    Pallas ``_fwd_kernel`` in interpret mode on ray-ordered points (3 rays x
    96 samples: runs of samples in one coarse cell, some outside the box)
    and noisy tables: features at atol 1e-6, as
    ``test_compute_dx_matches_jax_pallas`` holds them; a bf16 encoding's is
    the fp32 path."""
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.kernels.hash_encode import hash_encode_apply as j_apply

    tenc, jenc, params = _pair(**dict(SMALL, features_per_level=f, compute_dtype=dtype))
    x = _ray_points(3, 96, seed=22)
    assert bool((np.abs(x) > 1.5).any())
    got = the.hash_encode_apply(tenc, torch.from_numpy(x), compute_dx=True)
    want = np.asarray(j_apply(jenc, params, jnp.asarray(x), block=128, compute_dx=True))
    assert got.shape == (len(x), tenc.out_dim)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)


def _interior_ray_points(n_rays, n_samples, seed):
    """``_ray_points`` strictly inside the box (every coordinate within
    1.45 of its centre), in their order: samples along rays, many to a
    coarse cell."""
    x = _ray_points(n_rays, n_samples, seed)
    return np.ascontiguousarray(x[(np.abs(x) < 1.45).all(1)])


def _runs(enc, x, level):
    """Runs of consecutive points in one cell at ``level``."""
    cell = _cells_and_terms(enc, x, np.ones((len(x), enc.out_dim), np.float32), dx=True)[0]
    return 1 + int((np.diff(cell[:, level], axis=0) != 0).any(1).sum())


@pytest.mark.parametrize("f", [2, 8])
def test_compute_dx_on_ray_points_matches_jax_pallas(f):
    """The compute_dx path (on the CPU ``hash_encode_dx_reference``) against
    the Pallas ``_fwd_kernel`` / ``_bwd_kernel`` in interpret mode on
    ray-ordered interior points (4 rays x 128 samples inside the box: runs
    of samples in one coarse cell, as the backward kernel's walk merges
    them) with dead rows in the cotangent: features, dX and dG at
    ``test_compute_dx_matches_jax_pallas``' bounds."""
    tenc, jenc, params = _pair(**dict(SMALL, features_per_level=f))
    x = _interior_ray_points(4, 128, seed=25)
    assert 200 < len(x) < 512
    assert _runs(tenc, x, 0) < len(x) // 8  # many samples to a coarse cell
    co = _dead_rows(np.random.default_rng(26).normal(size=(len(x), tenc.out_dim))
                    .astype(np.float32), tenc.n_levels, f)
    _compute_dx_against_pallas(tenc, jenc, params, x, co)


@pytest.mark.parametrize("f", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dx_merged_runs_grouping_matches_jax_pallas(dtype, f):
    """The compute_dx backward's dG walk (``hash_dx_dg_kernel``: the table
    gradient's run merging under the compute_dx normalisation, fp32 terms
    whatever the compute dtype), emulated on the CPU
    (``_merged_runs_dG(..., dx=True)``), against ``jax.grad`` through JAX's
    compute_dx path (the Pallas ``_bwd_kernel`` in interpret mode) on
    ray-ordered points (runs of samples in one coarse cell, some outside the
    box) with dead rows in dout: on ``bwd_plan``'s plan for 132 SMs and on a
    plan of 3 ranges of 16 threads (fewer than 4 rows added a live term); dG
    to rtol 1e-4 / atol 1e-5, and every entry no live point touches exactly
    0."""
    tenc, jenc, params = _pair(**dict(SMALL, features_per_level=f, compute_dtype=dtype))
    x = _ray_points(12, 192, seed=27)
    assert bool((np.abs(x) > 1.5).any())
    L = tenc.n_levels
    co = _dead_rows(np.random.default_rng(28).normal(size=(len(x), L * f)).astype(np.float32),
                    L, f)
    _, g_j = _jax_compute_dx_grads(jenc, params, x, co)
    _, rows, _, live = _cells_and_terms(tenc, x, co, dx=True)
    touched = np.zeros(g_j.shape[:2], bool)
    for l in range(L):
        touched[l, rows[live[:, l], l].ravel()] = True
    assert (~touched).sum() > 0
    for ranges, block_points, threads in (
        (*the.bwd_plan(L, len(x), 132), the.BWD_THREADS), (3, -(-len(x) // 3), 16),
    ):
        dG, adds, n_live = _merged_runs_dG(tenc, x, co, ranges, block_points, threads, dx=True)
        if threads == 16:
            assert adds < 4 * n_live
        np.testing.assert_allclose(dG, g_j, rtol=1e-4, atol=1e-5)
        assert not dG[~touched].any() and not g_j[~touched].any()


def _dx_kernel_emulated(enc, x, dout):
    """CPU emulation of ``hash_dx_kernel``'s arithmetic in fp32: a point's
    levels in order, a level's corners c = 0..7 in order, s = Σ_f d·v (f in
    order), g_x += (s·(±res_l))·(w_y·w_z) and likewise for y and z, a level
    whose dout is all zero skipped; then g·inv where 0 ≤ t ≤ 1, else 0."""
    L, F, T = enc.n_levels, enc.features_per_level, enc.table_size
    inv = np.float32(1.0 / (enc.bbox_max - enc.bbox_min))
    t = (x - np.float32(enc.bbox_min)) * inv
    u = np.clip(t, np.float32(0), np.float32(1))
    d = dout.reshape(len(x), L, F)
    tables = enc.tables.detach().numpy()
    g = np.zeros((len(x), 3), np.float32)
    for l, r in enumerate(enc.resolutions.astype(np.float32)):
        s = u * r
        fl = np.floor(s)
        cell, f = fl.astype(np.int64), s - fl
        live = (d[:, l] != 0).any(-1)
        for c in range(8):
            bits = np.array([c & 1, (c >> 1) & 1, (c >> 2) & 1])
            ijk = cell + bits
            h = ((ijk[:, 0] * 1) ^ (ijk[:, 1] * 2654435761) ^ (ijk[:, 2] * 805459861)) \
                & 0xFFFFFFFF & (T - 1)
            v = tables[l, h]
            sc = np.zeros(len(x), np.float32)
            for k in range(F):
                sc = sc + d[:, l, k] * v[:, k]
            w = np.where(bits == 1, f, np.float32(1) - f)
            for a, (b1, b2) in enumerate(((1, 2), (0, 2), (0, 1))):
                term = (sc * (r if bits[a] else -r)) * (w[:, b1] * w[:, b2])
                g[:, a] = np.where(live, g[:, a] + term, g[:, a])
    return np.where((t >= 0) & (t <= 1), g * inv, np.float32(0))


@pytest.mark.parametrize("f", [1, 2, 4, 8])
def test_dx_kernel_arithmetic_matches_jax_pallas(f):
    """``hash_dx_kernel``'s arithmetic, emulated on the CPU
    (``_dx_kernel_emulated``), against JAX's compute_dx dX (the Pallas
    ``_bwd_kernel`` in interpret mode) on ray-ordered interior points with
    dead rows in dout, at test_compute_dx_matches_jax_pallas' bounds (rtol
    1e-4 / atol 1e-5)."""
    tenc, jenc, params = _pair(**dict(SMALL, features_per_level=f))
    x = _interior_ray_points(4, 128, seed=29)
    co = _dead_rows(np.random.default_rng(30).normal(size=(len(x), tenc.out_dim))
                    .astype(np.float32), tenc.n_levels, f)
    g_j, _ = _jax_compute_dx_grads(jenc, params, x, co)
    got = _dx_kernel_emulated(tenc, x, co)
    np.testing.assert_allclose(got, g_j, rtol=1e-4, atol=1e-5)
    assert float(np.abs(g_j).max()) > 1.0


def _dx_constants():
    """csrc/hash_encode.cu's BWD_THREADS and DX_THREADS."""
    import re
    from pathlib import Path

    import nerf_meets_mlx_torch

    src = (Path(nerf_meets_mlx_torch.__file__).parent / "csrc" / "hash_encode.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
                 for k in ("BWD_THREADS", "DX_THREADS"))


@pytest.mark.parametrize("levels,f,n_points", [(8, 2, 196_608), (16, 2, 393_216), (1, 8, 1),
                                               (32, 4, 100_007), (5, 1, 257), (3, 2, 1000)])
def test_dx_backward_plan_covers_every_point_and_level(levels, f, n_points):
    """The compute_dx backward's grids (their indexing transcribed): the dG
    walk on ``bwd_plan``'s plan for 132 SMs (block b: level b % L over
    range b / L; a thread a stretch of it) takes every (point, level) once,
    its warps' staging rows fit a block's 232,448 bytes of shared memory,
    and the dX kernel (a thread a point over every level, ceil(N /
    DX_THREADS) blocks) takes every point once."""
    threads, dx_threads = _dx_constants()
    assert threads == the.BWD_THREADS
    ranges, block_points = the.bwd_plan(levels, n_points, 132)
    assert ranges * levels <= 132
    visits = np.zeros((levels, n_points), np.int32)
    for b in range(ranges * levels):
        l, n0 = b % levels, (b // levels) * block_points
        n1 = min(n0 + block_points, n_points)
        per = -(-(n1 - n0) // threads)
        for t in range(threads):
            s0 = n0 + t * per
            visits[l, s0:max(s0, min(s0 + per, n1))] += 1
    assert (visits == 1).all()
    P = 8 if f <= 2 else 16 // f  # stage_points
    assert threads * ((3 * P + 1) + (P * f + 1)) * 4 <= 232_448  # stage_bytes
    dx_blocks = -(-n_points // dx_threads)
    assert np.array_equal(np.bincount(np.arange(dx_blocks * dx_threads)[:n_points] // dx_threads,
                                      minlength=dx_blocks)[:-1], np.full(dx_blocks - 1, dx_threads))


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
    order), dG within 1e-3 of its largest plain value (atomics); then on
    ray-ordered points, the features equal and the backward as
    ``_check_dx_backward_on_ray_points`` holds it."""
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
    # the forward on ray-ordered points, runs of samples in one cell
    rays = torch.from_numpy(_ray_points(1031, 97, seed=23)).to(dev)
    with torch.no_grad():
        torch.testing.assert_close(the.hash_encode_apply(tenc, rays, compute_dx=True),
                                   the.hash_encode_dx_reference(tenc, rays), rtol=0, atol=0)
    # and the backward on them
    _check_dx_backward_on_ray_points(tenc, rays, seed=31)


def _check_dx_backward_on_ray_points(tenc, rays, seed):
    """The compute_dx backward on ray-ordered points ``rays`` (N = 100,007:
    a multiple of no warp's, block's or range's points, runs of samples in
    one cell crossing each, some outside the box) with dead rows in dout,
    against autograd through ``hash_encode_dx_reference``: dX within 1e-4
    and dG within 1e-3 of their largest plain values, every dG row no live
    point touches exactly 0, two calls' dX equal (no atomic adds to it),
    one count and two hash kernel launches (the dG walk, the dX kernel;
    beside them only the zeroing of dG) a call, read from the call captured
    in a CUDA graph (``_graph_launches``)."""
    dev = rays.device
    N, L, F = rays.shape[0], tenc.n_levels, tenc.features_per_level
    dout = torch.from_numpy(_dead_rows(
        np.random.default_rng(seed).normal(size=(N, L * F)).astype(np.float32), L, F)).to(dev)
    x = rays.clone().requires_grad_(True)
    n0 = LAUNCHES["hash_dx_bwd"]
    g_x, g_t = torch.autograd.grad((the.hash_encode_apply(tenc, x, compute_dx=True) * dout).sum(),
                                   [x, tenc.tables])
    torch.cuda.synchronize()
    assert LAUNCHES["hash_dx_bwd"] == n0 + 1
    p_x, p_t = torch.autograd.grad((the.hash_encode_dx_reference(tenc, x) * dout).sum(),
                                   [x, tenc.tables])
    assert float((g_x - p_x).abs().max()) <= 1e-4 * float(p_x.abs().max())
    assert float((g_t - p_t).abs().max()) <= 1e-3 * float(p_t.abs().max())
    live = dout.reshape(N, L, F).ne(0).any(-1)
    touched = torch.zeros(g_t.shape[:2], dtype=torch.bool, device=dev)
    level = torch.arange(L, device=dev)[None, :].expand(N, L)
    for h, _ in tenc.corners(rays, u=torch.clamp((rays - tenc.bbox_min) * the._inv(tenc), 0, 1)):
        touched[level[live], h[live]] = True
    assert bool((~touched).any())
    assert not bool(g_t[~touched].any()) and not bool(p_t[~touched].any())
    assert bool((g_x[(rays.abs() > 1.5).any(-1)] == 0).any())
    dX2, _ = the._dx_bwd_launch(tenc, rays, dout)
    assert torch.equal(dX2, g_x)
    launches = _graph_launches(lambda: the._dx_bwd_launch(tenc, rays, dout))
    mine = [name for kind, name in launches if kind == 0 and "hash_" in name]
    assert len(mine) == 2, launches
    assert sum("hash_dx_dg_kernel" in n for n in mine) == 1, launches
    assert sum("hash_dx_kernel" in n for n in mine) == 1, launches


@pytest.mark.gpu
@pytest.mark.parametrize("f", [1, 2, 4, 8])
def test_cuda_compute_dx_backward_on_ray_points_matches_plain(f):
    """The compute_dx backward at the lego_ingp levels with F features a
    level on 1031 rays x 97 ray-ordered samples (``_check_dx_backward_on_ray_points``)."""
    tenc, dev = _cuda_encoding(dict(LEGO_INGP, features_per_level=f))
    _check_dx_backward_on_ray_points(tenc, torch.from_numpy(_ray_points(1031, 97, seed=32)).to(dev),
                                     seed=33)


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
    # the forward on ray-ordered points, runs of samples in one cell
    rays = torch.from_numpy(_ray_points(1031, 97, seed=24)).to(dev)
    with torch.no_grad():
        torch.testing.assert_close(the.hash_encode_apply(tenc, rays, levels_in_body=False),
                                   the.hash_encode_reference(tenc, rays), rtol=0, atol=0)
