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
* The table gradient kernel's grouping (runs of points in one cell summed
  before they are added), emulated on the CPU, against the Pallas
  ``_bwd_body_kernel`` on ray-ordered points.
* ``gpu``-marked: both CUDA kernels against the plain version at the
  lego_ingp size, and the table gradient at F = 1..8, fp32 and bf16,
  through both entry points, on ray-ordered points at tables of 128 and 256
  KB a level, on the card (skipped where no card is present).
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


def _ray_points(n_rays, n_samples, seed):
    """Points along rays, [rays, samples] flattened as the training routes
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


def _dead_rows(dout, L, F):
    """dout with the rows the kernel must skip: every 5th point's whole row
    (dead samples) and every 3rd point's level-1 features."""
    dout = dout.copy()
    dout[::5] = 0.0
    dout[::3, F:2 * F] = 0.0
    return dout


def _cells_and_terms(enc, x, dout, dx=False):
    """Each point's cell [N, L, 3], corner rows [N, L, 8], terms w_c·d [N,
    L, 8, F] and liveness [N, L] at every level, with the kernel's
    arithmetic: the division by the box size, products rounded one by one,
    bf16(w)·bf16(d) in bf16 mode; ``dx``: the compute_dx kernels'
    normalisation, (x − bbox_min)·f32(1/(bbox_max − bbox_min)), and fp32
    terms whatever the compute dtype."""
    L, F, T = enc.n_levels, enc.features_per_level, enc.table_size
    if dx:
        t = (x - np.float32(enc.bbox_min)) * np.float32(1.0 / (enc.bbox_max - enc.bbox_min))
    else:
        t = (x - np.float32(enc.bbox_min)) / np.float32(enc.bbox_max - enc.bbox_min)
    u = np.clip(t, np.float32(0), np.float32(1))
    s = u[:, None, :] * enc.resolutions.astype(np.float32)[None, :, None]
    fl = np.floor(s)
    cell, f = fl.astype(np.int64), s - fl
    d = dout.reshape(len(x), L, F)
    if enc.compute_dtype == "bfloat16" and not dx:
        def rnd(a):
            return torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    else:
        def rnd(a):
            return a
    d = rnd(d)
    rows, terms = [], []
    for c in range(8):
        bits = np.array([c & 1, (c >> 1) & 1, (c >> 2) & 1])
        ijk = cell + bits
        rows.append(((ijk[..., 0] * 1) ^ (ijk[..., 1] * 2654435761) ^ (ijk[..., 2] * 805459861))
                    & 0xFFFFFFFF & (T - 1))
        w3 = np.where(bits == 1, f, np.float32(1) - f)
        w = (w3[..., 0] * w3[..., 1]) * w3[..., 2]
        terms.append(rnd(w)[..., None] * d)
    return cell, np.stack(rows, -1), np.stack(terms, 2), (d != 0).any(-1)


def _merged_runs_dG(enc, x, dout, ranges, block_points, threads=the.BWD_THREADS, dx=False):
    """CPU emulation of ``hash_bwd_kernel``'s grouping: block r of level l
    takes points [r·block_points, (r + 1)·block_points), each of its
    ``threads`` threads a stretch of them in order; a run of live points
    sums its terms at its cell's 8 corners in fp32, one after another. When
    the next live point's cell is a face neighbour, the run slides: the 4
    corners the cells share keep their sums, the other 4 are added to their
    rows; else all 8 are added; the stretch's end adds all 8 (``dx``: the
    compute_dx walk's terms, ``_cells_and_terms``). Returns (dG, corner rows
    added, live (point, level) pairs)."""
    L, F, T = enc.n_levels, enc.features_per_level, enc.table_size
    cell, rows, terms, live = _cells_and_terms(enc, x, dout, dx)
    N = len(x)
    dG = np.zeros((L, T, F), np.float32)
    adds = 0
    for l in range(L):
        for r in range(ranges):
            n0, n1 = r * block_points, min((r + 1) * block_points, N)
            if n0 >= N:
                continue
            out = dG[l]
            per = -(-(n1 - n0) // threads)
            for t in range(threads):
                cur = None  # (cell, its corner rows, sums [8, F])
                for n in range(n0 + t * per, min(n0 + (t + 1) * per, n1)):
                    if not live[n, l]:
                        continue
                    if cur is not None and (cell[n, l] != cur[0]).any():
                        step = cell[n, l] - cur[0]
                        axis = int(np.argmax(np.abs(step)))
                        if np.abs(step).sum() == 1:  # a face neighbour: slide
                            bit = 1 << axis
                            up = step[axis] > 0
                            acc = cur[2].copy()
                            for c in range(8):
                                if bool(c & bit) != up:
                                    out[cur[1][c]] += acc[c]
                                    adds += 1
                                    acc[c], acc[c ^ bit] = acc[c ^ bit], 0.0
                            cur = (cell[n, l], rows[n, l], acc)
                        else:
                            for c in range(8):
                                out[cur[1][c]] += cur[2][c]
                            adds += 8
                            cur = None
                    if cur is None:
                        cur = (cell[n, l], rows[n, l], np.zeros((8, F), np.float32))
                    cur[2][:] = cur[2] + terms[n, l]
                if cur is not None:
                    for c in range(8):
                        out[cur[1][c]] += cur[2][c]
                    adds += 8
    return dG, adds, int(live.sum())


@pytest.mark.parametrize("f", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merged_runs_grouping_matches_jax_pallas(dtype, f):
    """The CUDA table gradient's grouping, emulated on the CPU
    (``_merged_runs_dG``), against ``jax.grad`` through JAX's
    ``hash_encode_apply`` (the Pallas ``_bwd_body_kernel`` in interpret
    mode), on ray-ordered points (runs of samples in one coarse cell, some
    outside the box, where both normalisations agree) with dead rows in
    dout: on ``bwd_plan``'s plan for 132 SMs and on a plan of 3 ranges of
    16 threads, whose stretches hold long runs (fewer
    than 4 rows added a live term, where one scalar atomic a term adds 8); dG to
    rtol 1e-4 / atol 1e-5, and every entry no live point touches exactly
    0."""
    import jax
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.kernels.hash_encode import hash_encode_apply as j_apply

    kw = dict(SMALL, features_per_level=f, compute_dtype=dtype)
    tenc, jenc, params = _pair(noisy=False, **kw)
    x = _ray_points(24, 192, seed=11)
    dx = x - np.float32(-1.5)
    x = np.ascontiguousarray(x[(dx / np.float32(3.0) == dx * np.float32(1.0 / 3.0)).all(1)])
    L, F = tenc.n_levels, f
    co = _dead_rows(np.random.default_rng(12).normal(size=(len(x), L * F)).astype(np.float32),
                    L, F)
    g_j = jax.grad(lambda p: jnp.sum(j_apply(jenc, p, jnp.asarray(x), block=128) * co))(params)
    g_j = np.asarray(g_j["tables"])
    _, rows, _, live = _cells_and_terms(tenc, x, co)
    touched = np.zeros(g_j.shape[:2], bool)
    for l in range(L):
        touched[l, rows[live[:, l], l].ravel()] = True
    assert (~touched).sum() > 0
    for ranges, block_points, threads in (
        (*the.bwd_plan(L, len(x), 132), the.BWD_THREADS), (3, -(-len(x) // 3), 16),
    ):
        dG, adds, n_live = _merged_runs_dG(tenc, x, co, ranges, block_points, threads)
        if threads == 16:
            assert adds < 4 * n_live  # runs merged: fewer than 4 rows a live term
        np.testing.assert_allclose(dG, g_j, rtol=1e-4, atol=1e-5)
        assert not dG[~touched].any() and not g_j[~touched].any()


def _agreeing_ray_points(n_rays, n_samples, seed):
    """``_ray_points`` (samples along rays, many to a coarse cell, some
    outside the box) where the Pallas kernels' normalisation, (x −
    bmin)·f32(1/3), and the port's, (x − bmin)/3, round to the same float32
    on every axis."""
    x = _ray_points(n_rays, n_samples, seed)
    d = x - np.float32(-1.5)
    return np.ascontiguousarray(x[(d / np.float32(3.0) == d * np.float32(1.0 / 3.0)).all(1)])


@pytest.mark.parametrize("levels_in_body", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("f", [1, 2, 4, 8])
def test_forward_on_ray_points_matches_jax_pallas(f, dtype, levels_in_body):
    """The port's forward on the CPU (its plain version) against JAX's
    Pallas ``_fwd_body_kernel`` (levels in the body) and
    ``_fwd_grid_kernel`` (one level per grid step) in interpret mode, on
    ray-ordered points (8 rays x 96 samples, runs of samples in one coarse
    cell, some outside the box, where both normalisations agree) and noisy
    tables: features to fp32 summation order (rtol 1e-5 / atol 1e-7), as
    ``test_grid_path_matches_jax_pallas`` holds them."""
    import dataclasses

    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.kernels.hash_encode import HashEncodeSpec, hash_encode, pack_tables

    kw = dict(SMALL, features_per_level=f, compute_dtype=dtype)
    tenc, jenc, params = _pair(**kw)
    spec = dataclasses.replace(HashEncodeSpec.from_encoding(jenc, block=128),
                               levels_in_body=levels_in_body)
    x = _agreeing_ray_points(8, 96, seed=21)
    assert 150 < len(x) and bool((np.abs(x) > 1.5).any())
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (0, 5)))  # the lane padding hash_encode_apply makes
    got = the.hash_encode_apply(tenc, torch.from_numpy(x), levels_in_body=levels_in_body)
    want = np.asarray(hash_encode(spec, pack_tables(spec, params["tables"]), xp))
    assert got.shape == (len(x), tenc.out_dim)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-7)


def _fwd_constants():
    """csrc/hash_encode.cu's FWD_THREADS and FWD_CHUNK."""
    import re
    from pathlib import Path

    import nerf_meets_mlx_torch

    src = (Path(nerf_meets_mlx_torch.__file__).parent / "csrc" / "hash_encode.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
                 for k in ("FWD_THREADS", "FWD_CHUNK"))


def _fwd_chunk_writes(L, F, N):
    """How many times ``hash_fwd_kernel``'s threads write each float of
    feats [N, L·F], and how many floats they write past it (its indexing
    transcribed): chunks = ceil(L / K) with K = FWD_CHUNK / F; block b takes
    chunk b % chunks (levels from (b % chunks)·K) of the FWD_THREADS points
    from (b / chunks)·FWD_THREADS, a thread a point; it stores FWD_CHUNK
    floats where L·F is a multiple of 4 and the chunk is whole, else the
    chunk's floats one by one."""
    threads, chunk = _fwd_constants()
    K, LF = chunk // F, L * F
    chunks = -(-L // K)
    writes = np.zeros(N * LF, np.int64)
    outside = 0
    for b in range(chunks * -(-N // threads)):
        group, l0 = b // chunks, (b % chunks) * K
        for n in range(group * threads, min((group + 1) * threads, N)):
            width = chunk if LF % 4 == 0 and l0 + K <= L else min(L - l0, K) * F
            start = n * LF + l0 * F
            outside += max(0, start + width - N * LF)
            writes[start:min(start + width, N * LF)] += 1
    return writes, outside


@pytest.mark.parametrize("levels,f", [(8, 2), (16, 2), (5, 1), (3, 2), (7, 4), (1, 8), (16, 8),
                                      (32, 4), (1, 1)])
@pytest.mark.parametrize("n_points", [1, 257, 1000])
def test_forward_chunks_write_every_feature_once(levels, f, n_points):
    """The forward kernel's grid and indexing (``_fwd_chunk_writes``) write
    every feature of every point exactly once and nothing past feats, with
    whole chunks and ragged ones (L not a multiple of FWD_CHUNK / F, L·F
    not a multiple of 4) and a ragged last block."""
    writes, outside = _fwd_chunk_writes(levels, f, n_points)
    assert outside == 0
    assert (writes == 1).all()


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
    # and on ray-ordered points, runs of samples in one cell
    rays = torch.from_numpy(_ray_points(1031, 97, seed=15)).to(dev)
    with torch.no_grad():
        torch.testing.assert_close(the.hash_encode_apply(tenc, rays), tenc.apply(rays),
                                   rtol=0, atol=0)


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
    # and on ray-ordered points, runs of samples in one cell
    rays = torch.from_numpy(_ray_points(1031, 97, seed=15)).to(dev)
    with torch.no_grad():
        torch.testing.assert_close(the.hash_encode_apply(tenc, rays),
                                   the.hash_encode_reference(tenc, rays), rtol=0, atol=0)


def _forward_and_plain(tenc, x, entry):
    """(the kernel's features, the plain version's, the launch count's
    key) of one forward entry point: the levels-in-body kernel ("body"),
    the one-level-per-grid-step one ("grid") or compute_dx ("dx")."""
    with torch.no_grad():
        if entry == "dx":
            return (the.hash_encode_apply(tenc, x, compute_dx=True),
                    the.hash_encode_dx_reference(tenc, x), "hash_dx_fwd")
        return (the.hash_encode_apply(tenc, x, levels_in_body=entry == "body"),
                the.hash_encode_reference(tenc, x),
                "hash_fwd" if entry == "body" else "hash_grid_fwd")


def _noisy_cuda_encoding(kw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    tenc = HashGridEncoding(**kw, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        tenc.tables.add_(torch.randn(tenc.tables.shape, device=dev) * 0.1)
    return tenc, dev


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["body", "grid", "dx"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("f", [1, 2, 4, 8])
@pytest.mark.parametrize("level_kb", [128, 512])
def test_cuda_forward_on_ray_points_equals_plain(level_kb, f, dtype, entry):
    """The forward kernel through its three entry points on ray-ordered
    points (1031 rays x 97 samples: N = 100,007, a multiple of no warp's or
    block's points, runs of samples in one cell crossing each, some outside
    the box), at the lego_ingp levels with F features (1 to 8 levels a
    thread's chunk), fp32 and bf16 compute, at tables of 128 KB a level
    (lego_ingp's) and 512 KB (past what a block's shared memory holds):
    features equal to the plain version's."""
    log2_t = int(np.log2(level_kb * 1024 // (4 * f)))
    tenc, dev = _noisy_cuda_encoding(
        dict(_preset_kw(), features_per_level=f, log2_table_size=log2_t, compute_dtype=dtype))
    x = torch.from_numpy(_ray_points(1031, 97, seed=16)).to(dev)
    n0 = dict(LAUNCHES)
    feats, plain, key = _forward_and_plain(tenc, x, entry)
    torch.cuda.synchronize()
    assert LAUNCHES[key] == n0[key] + 1
    torch.testing.assert_close(feats, plain, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["body", "dx"])
@pytest.mark.parametrize("levels,f", [(5, 1), (3, 2), (7, 4), (1, 8), (16, 2)])
def test_cuda_forward_ragged_shapes_equal_plain(levels, f, entry):
    """Level counts that leave a thread's chunk of levels ragged (L not a
    multiple of 8 / F) or a row's length not a multiple of 4 floats (stored
    float by float), and 16 levels, on 20,011 ray-ordered points: features
    equal to the plain version's."""
    tenc, dev = _noisy_cuda_encoding(dict(n_levels=levels, min_res=16, max_res=256,
                                          features_per_level=f, log2_table_size=12))
    x = torch.from_numpy(_ray_points(211, 97, seed=17)[:20_011]).to(dev)
    feats, plain, _ = _forward_and_plain(tenc, x, entry)
    torch.testing.assert_close(feats, plain, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("entry,dtype", [("body", "float32"), ("body", "bfloat16"),
                                         ("grid", "float32"), ("dx", "float32")])
def test_cuda_forward_at_a_frame_chunk_equals_plain(entry, dtype):
    """A long-ray frame chunk's batch: 32,768 rays x 128 samples =
    4,194,304 ray-ordered points at lego_ingp's tables: features equal to
    the plain version's."""
    tenc, dev = _noisy_cuda_encoding(dict(_preset_kw(), compute_dtype=dtype))
    x = torch.from_numpy(_ray_points(32768, 128, seed=18)).to(dev)
    assert x.shape[0] == 4_194_304
    feats, plain, _ = _forward_and_plain(tenc, x, entry)
    torch.testing.assert_close(feats, plain, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("f", [1, 2, 4, 8])
@pytest.mark.parametrize("level_kb", [128, 256])
def test_cuda_table_grad_merged_runs_match_plain(level_kb, f, dtype, grid):
    """The table gradient kernel on ray-ordered points (1031 rays x 97
    samples: N = 100,007, a multiple of no thread's, warp's or block's
    range, runs crossing each) with dead rows in dout, at the lego_ingp
    levels with F features, fp32 and bf16, through both entry points
    (levels in the body; one level per grid step), at tables of 128 KB a
    level (the largest a block's shared memory holds) and 256 KB. dG to
    rtol 1e-4 / atol 1e-5 of the plain scatter-add; every entry no live
    point touches exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    log2_t = int(np.log2(level_kb * 1024 // (4 * f)))
    kw = dict(_preset_kw(), features_per_level=f, log2_table_size=log2_t, compute_dtype=dtype)
    tenc = HashGridEncoding(**kw, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    assert tenc.tables[0].numel() * 4 == level_kb * 1024
    x_np = _ray_points(1031, 97, seed=13)
    N, L = len(x_np), tenc.n_levels
    x = torch.from_numpy(x_np).to(dev)
    dout = torch.from_numpy(_dead_rows(
        np.random.default_rng(14).normal(size=(N, L * f)).astype(np.float32), L, f)).to(dev)
    key = "hash_grid_bwd" if grid else "hash_bwd"
    n0 = LAUNCHES[key]
    feats = the.hash_encode_apply(tenc, x, levels_in_body=not grid)
    (g,) = torch.autograd.grad((feats * dout).sum(), tenc.tables)
    torch.cuda.synchronize()
    assert LAUNCHES[key] == n0 + 1
    (g_p,) = torch.autograd.grad((the.hash_encode_reference(tenc, x) * dout).sum(), tenc.tables)
    torch.testing.assert_close(g, g_p, rtol=1e-4, atol=1e-5)
    live = dout.reshape(N, L, f).ne(0).any(-1)
    touched = torch.zeros(g.shape[:2], dtype=torch.bool, device=dev)
    level = torch.arange(L, device=dev)[None, :].expand(N, L)
    for h, _ in tenc.corners(x):
        touched[level[live], h[live]] = True
    assert bool((~touched).any())
    assert not bool(g[~touched].any()) and not bool(g_p[~touched].any())
