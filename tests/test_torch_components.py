"""The PyTorch port's building blocks, each held against its JAX counterpart.

Inputs are made with numpy from a seed and handed to both frameworks as
numpy arrays; random draws (jitter ``t``, importance ``u``, density noise)
are injected into both. Tolerance rtol 1e-5 / atol 1e-6 unless a case says
why it needs another.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_meets_mlx_torch import interop
from nerf_meets_mlx_torch.cameras import pose as tpose
from nerf_meets_mlx_torch.cameras import rays as trays
from nerf_meets_mlx_torch.config import lego_hierarchical as t_lego
from nerf_meets_mlx_torch.encoding import sinusoidal as tsin
from nerf_meets_mlx_torch.engine import checkpoint as tckpt
from nerf_meets_mlx_torch.models import create_nerf as t_create
from nerf_meets_mlx_torch.ops import metrics as tmetrics
from nerf_meets_mlx_torch.rendering import volume as tvol
from nerf_meets_mlx_torch.sampling import importance as timp
from nerf_meets_mlx_torch.sampling import stratified as tstrat
from nerf_meets_mlx_tpu.cameras import pose as jpose
from nerf_meets_mlx_tpu.cameras import rays as jrays
from nerf_meets_mlx_tpu.config import lego_hierarchical as j_lego
from nerf_meets_mlx_tpu.encoding import sinusoidal as jsin
from nerf_meets_mlx_tpu.models import create_nerf as j_create
from nerf_meets_mlx_tpu.ops import metrics as jmetrics
from nerf_meets_mlx_tpu.rendering import volume as jvol
from nerf_meets_mlx_tpu.sampling import importance as jimp
from nerf_meets_mlx_tpu.sampling import stratified as jstrat

RTOL, ATOL = 1e-5, 1e-6


def close(t_out, j_out, rtol=RTOL, atol=ATOL):
    t_np = t_out.detach().cpu().numpy() if isinstance(t_out, torch.Tensor) else np.asarray(t_out)
    np.testing.assert_allclose(t_np, np.asarray(j_out), rtol=rtol, atol=atol)


def T(x):
    return torch.from_numpy(np.array(x, np.float32))


def J(x):
    return jnp.asarray(np.asarray(x, np.float32))


def _camera(seed=0, H=6, W=5):
    rng = np.random.default_rng(seed)
    focal = float(rng.uniform(3.0, 8.0))
    K = np.array([[focal, 0, W / 2], [0, focal * 1.1, H / 2], [0, 0, 1]], np.float32)
    c2w = tpose.pose_spherical(float(rng.uniform(-180, 180)), -30.0, 4.0)[:3, :4]
    return H, W, K, c2w


def _rays(seed=0, B=23):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(B, 3)) * 0.5).astype(np.float32)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    return o, d


# ---------------------------------------------------------------------------
# cameras
# ---------------------------------------------------------------------------


def test_get_rays():
    H, W, K, c2w = _camera()
    to, td = trays.get_rays(H, W, K, c2w, device="cpu")
    jo, jd = jrays.get_rays(H, W, K, c2w)
    close(to, jo)
    close(td, jd)


def test_get_rays_for_pixels():
    H, W, K, c2w = _camera(1)
    rng = np.random.default_rng(1)
    px, py = rng.uniform(0, W, 17), rng.uniform(0, H, 17)
    to, td = trays.get_rays_for_pixels(K, c2w, px, py, device="cpu")
    jo, jd = jrays.get_rays_for_pixels(K, c2w, px, py)
    close(to, jo)
    close(td, jd)


def test_intersect_aabb():
    o, d = _rays(2, B=64)
    d[:4, 0] = 0.0  # axis-parallel rays take the eps guard
    box = (-0.7, -0.6, -0.5, 0.6, 0.7, 0.8)
    near, far = np.full((64, 1), 0.2, np.float32), np.full((64, 1), 5.0, np.float32)
    tn, tf = trays.intersect_aabb(T(o), T(d), box[:3], box[3:], T(near), T(far))
    jn, jf = jrays.intersect_aabb(J(o), J(d), box[:3], box[3:], J(near), J(far))
    close(tn, jn)
    close(tf, jf)


def test_ndc_rays():
    o, d = _rays(3)
    o[:, 2] = np.abs(o[:, 2]) + 0.5   # in front of the near plane
    d[:, 2] = -np.abs(d[:, 2]) - 0.2  # looking down -z
    to, td = trays.ndc_rays(6, 5, 4.5, 1.0, T(o), T(d))
    jo, jd = jrays.ndc_rays(6, 5, 4.5, 1.0, J(o), J(d))
    close(to, jo)
    close(td, jd)


def test_orbit_poses():
    np.testing.assert_array_equal(tpose.orbit_poses(12), jpose.orbit_poses(12))
    np.testing.assert_array_equal(
        tpose.pose_spherical(33.0, -21.0, 3.5), jpose.pose_spherical(33.0, -21.0, 3.5)
    )


# ---------------------------------------------------------------------------
# encoding and MLP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "band_mode,n_freqs,max_exp,include_input",
    [
        ("canonical", 10, None, True),
        ("canonical", 4, None, False),
        ("reference_squared", 10, 9.0, True),
        ("canonical", 10, 8.0, False),
    ],
)
def test_sinusoidal_encoding(band_mode, n_freqs, max_exp, include_input):
    x = np.random.default_rng(4).normal(size=(31, 3)).astype(np.float32) * 2.0
    te = tsin.SinusoidalEncoding(3, n_freqs, 0.0, max_exp, include_input, band_mode)
    je = jsin.SinusoidalEncoding(3, n_freqs, 0.0, max_exp, include_input, band_mode)
    close(te.bands(), jsin.frequency_bands(n_freqs, 0.0, max_exp, band_mode), rtol=0, atol=0)
    assert te.out_dim == je.out_dim
    # atol 2e-6: |phase| reaches ~3000 rad, where torch's and XLA's sin
    # reductions may differ by an ulp of the result
    close(te.apply(T(x)), je.apply({}, J(x)), atol=2e-6)


def _small_cfgs(compute_dtype="float32"):
    out = []
    for make in (t_lego, j_lego):
        cfg = make()
        mlp = dataclasses.replace(
            cfg.mlp, net_depth=4, net_width=64, skips=(1,), compute_dtype=compute_dtype
        )
        out.append(cfg.replace(mlp=mlp, mlp_fine=mlp))
    return out


def _small_models(compute_dtype="float32"):
    tc, jc = _small_cfgs(compute_dtype)
    jm = j_create(jc)
    params = jm.init(jax.random.PRNGKey(0))
    tm = t_create(tc, device="cpu")
    interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tm)
    return tm, jm, params


@pytest.mark.parametrize(
    "compute_dtype,rtol,atol",
    [
        ("float32", RTOL, ATOL),
        # bf16 operands round alike in both, but an f32 sum taken in another
        # order can land across a bf16 rounding boundary, moving the next
        # layer's input by 2^-8 relative; measured max abs 1.5e-3 on |out|
        # up to 0.25
        ("bfloat16", 1e-2, 5e-3),
    ],
)
def test_nerf_mlp_query_through_interop(compute_dtype, rtol, atol):
    tm, jm, params = _small_models(compute_dtype)
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(9, 7, 3)).astype(np.float32)
    vd = rng.normal(size=(9, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    for level in ("coarse", "fine"):
        close(
            tm.query(level, T(pts), T(vd)), jm.query(params, level, J(pts), J(vd)),
            rtol=rtol, atol=atol,
        )


def test_interop_round_trip():
    tm, _, params = _small_models()
    back = interop.params_to_numpy(tm)
    flat_j = jax.tree_util.tree_leaves_with_path(params)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(flat_t[path], np.asarray(leaf))


def test_checkpoint_round_trip(tmp_path):
    tm, _, _ = _small_models()
    tckpt.save_checkpoint(tmp_path / "ckpt", tm, 7)
    tckpt.save_checkpoint(tmp_path / "ckpt", tm, 12)
    assert (tmp_path / "ckpt" / "step_00000012").is_dir()
    assert tckpt.latest_step(tmp_path / "ckpt") == 12
    assert tckpt.latest_step(tmp_path / "missing") is None
    tc, _ = _small_cfgs()
    other = t_create(tc, device="cpu").init(torch.Generator().manual_seed(3))
    tckpt.restore_checkpoint(tmp_path / "ckpt", other, 12)
    for (k, a), (_, b) in zip(tm.state_dict().items(), other.state_dict().items()):
        assert torch.equal(a, b), k


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["uniform", "lindisp"])
def test_sample_z(kind):
    rng = np.random.default_rng(6)
    near = rng.uniform(0.5, 2.0, size=(11, 1)).astype(np.float32)
    far = near + rng.uniform(1.0, 4.0, size=(11, 1)).astype(np.float32)
    tf = tstrat.sample_z_uniform if kind == "uniform" else tstrat.sample_z_lindisp
    jf = jstrat.sample_z_uniform if kind == "uniform" else jstrat.sample_z_lindisp
    close(tf(T(near), T(far), 16), jf(J(near), J(far), 16))


def test_stratified_jitter_injected_t():
    z = np.sort(np.random.default_rng(7).uniform(2, 6, size=(11, 16)), -1).astype(np.float32)
    t = np.random.default_rng(8).uniform(size=z.shape).astype(np.float32)
    out_t = tstrat.stratified_jitter(T(z), 0.7, t=T(t))
    out_j = jstrat.stratified_jitter(jax.random.PRNGKey(0), J(z), 0.7, t=J(t))
    close(out_t, out_j)
    assert tstrat.stratified_jitter(T(z), 0.0) is not None


def _pdf_inputs(seed=9, B=13, n=16):
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(2, 6, size=(B, n)), -1).astype(np.float32)
    w = rng.uniform(size=(B, n)).astype(np.float32) ** 3
    w[0] = 0.0  # an all-empty ray: the eps guard and padding
    return z, w


@pytest.mark.parametrize("deterministic", [True, False])
def test_sample_pdf(deterministic):
    z, w = _pdf_inputs()
    n_imp = 24
    u = None if deterministic else np.random.default_rng(10).uniform(size=(13, n_imp)).astype(np.float32)
    out_t = timp.sample_pdf(T(z), T(w), n_imp, deterministic=deterministic,
                            u=None if u is None else T(u))
    out_j = jimp.sample_pdf(jax.random.PRNGKey(0), J(z), J(w), n_imp,
                            deterministic=deterministic, u=None if u is None else J(u))
    close(out_t, out_j)


def test_merge_z():
    z, _ = _pdf_inputs()
    zi = np.random.default_rng(11).uniform(2, 6, size=(13, 24)).astype(np.float32)
    close(timp.merge_z(T(z), T(zi)), jimp.merge_z(J(z), J(zi)), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# compositing and metrics
# ---------------------------------------------------------------------------


def _raw_inputs(seed=12, B=17, S=16):
    rng = np.random.default_rng(seed)
    raw = rng.normal(size=(B, S, 4)).astype(np.float32)
    raw[..., 3] *= 3.0
    z = np.sort(rng.uniform(2, 6, size=(B, S)), -1).astype(np.float32)
    rd = rng.normal(size=(B, 3)).astype(np.float32)
    noise = rng.normal(size=(B, S)).astype(np.float32)
    return raw, z, rd, noise


@pytest.mark.parametrize("mode", ["canonical", "reference"])
@pytest.mark.parametrize("act", ["softplus", "relu"])
@pytest.mark.parametrize("white", [True, False])
def test_raw2outputs(mode, act, white):
    raw, z, rd, _ = _raw_inputs()
    kw = dict(mode=mode, white_bkgd=white, density_activation=act)
    out_t = tvol.raw2outputs(T(raw), T(z), T(rd), **kw)
    out_j = jvol.raw2outputs(J(raw), J(z), J(rd), **kw)
    assert set(out_t) == set(out_j)
    for k in out_j:
        close(out_t[k], out_j[k])


def test_raw2outputs_injected_noise():
    raw, z, rd, noise = _raw_inputs(13)
    kw = dict(mode="canonical", white_bkgd=True, raw_noise_std=0.5)
    out_t = tvol.raw2outputs(T(raw), T(z), T(rd), noise=T(noise), **kw)
    out_j = jvol.raw2outputs(J(raw), J(z), J(rd), noise=J(noise), **kw)
    for k in out_j:
        close(out_t[k], out_j[k])


def test_maps_from_weights():
    _, z, _, _ = _raw_inputs(14)
    w = np.random.default_rng(14).uniform(size=z.shape).astype(np.float32) / 8
    w[0] = 0.0
    for a, b in zip(tvol.maps_from_weights(T(w), T(z)), jvol.maps_from_weights(J(w), J(z))):
        close(a, b)


def test_softplus_matches_jax():
    x = np.linspace(-100, 100, 2001).astype(np.float32)
    close(tvol.softplus(T(x)), jax.nn.softplus(J(x)))


def test_mse_psnr():
    rng = np.random.default_rng(15)
    a, b = rng.uniform(size=(2, 8, 8, 3)).astype(np.float32)
    close(tmetrics.mse(T(a), T(b)), jmetrics.mse(J(a), J(b)))
    close(tmetrics.psnr(T(a), T(b)), jmetrics.psnr(J(a), J(b)))
