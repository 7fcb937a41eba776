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
  Also on ray-ordered points (samples along rays, many to a coarse row,
  some outside the box).
* The Pallas semantics against the XLA ``CPGridEncoding.apply``: the
  normalisation and the dLines rounding are the only differences.
* The wrapper's routing, its bounds, and the op as a drop-in for the
  model's encode (lego_cp's query), as ``chip_smoke.py`` uses it.
* The CUDA kernels' plans (``fwd_plan``, ``bwd_plan``) take every point at
  every level once, within the shared memory a block has; the backward's
  run-merging walk, emulated in numpy, gives the plain version's dLines.
* ``gpu``-marked: both CUDA kernels against the plain versions at the
  lego_cp size and at a grid whose lines do not fit in shared memory, on
  uniform, ray-ordered and frame-chunk points; the C plans against their
  Python twins (skipped where no card is present).
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
from nerf_meets_mlx_torch.utils.tensors import round_bf16

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


def _ray_points(n_rays, samples, seed=0):
    """Points in ray order ([rays, samples] flattened), as a render samples
    them: rays aimed near the box's centre from 4 units out, sorted depths
    in [2, 6], so that each ray enters and leaves the box [-1.5, 1.5]^3
    (points outside clip to the end nodes) and many samples share a row of
    a coarse line."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n_rays, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = -4.0 * d + rng.normal(scale=0.3, size=(n_rays, 3))
    t = np.sort(rng.uniform(2.0, 6.0, (n_rays, samples)), axis=-1)
    return (o[:, None, :] + t[..., None] * d[:, None, :]).reshape(-1, 3).astype(np.float32)


@pytest.mark.parametrize("dtype,n,kind", [
    pytest.param("bfloat16", 300, "uniform", id="bfloat16-300"),
    pytest.param("float32", 257, "uniform", id="float32-257"),
    pytest.param("bfloat16", 130, "uniform", id="bfloat16-130"),
    pytest.param("bfloat16", 320, "rays", id="bfloat16-rays-320"),
    pytest.param("float32", 320, "rays", id="float32-rays-320"),
])
def test_cp_encode_matches_jax_pallas(dtype, n, kind):
    """The plain versions against the Pallas kernels in interpret mode, on
    uniform points and on ray-ordered points (10 rays of 32 samples: up to
    ~10 samples to a row of the 8-node level, some outside the box)."""
    import jax
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.kernels.cp_encode import cp_encode_apply as j_apply

    tenc, jenc, params = _pair(dtype)
    x = _points(n) if kind == "uniform" else _ray_points(n // 32, 32, seed=n)
    assert x.shape == (n, 3)
    if kind == "rays":
        assert (np.abs(x) > 1.5).any(axis=-1).mean() > 0.1  # points outside the box
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
    # no shared-memory bound on R since the backward merges in registers:
    # 4096 nodes a line are taken, 2^24 + 1 (node indices past fp32's) not
    tce.check_cp_encoding(tce.CPEncodeSpec.from_encoding(
        CPGridEncoding(n_levels=1, min_res=4096, max_res=4096, n_components=16)))
    lego = tce.CPEncodeSpec.from_encoding(CPGridEncoding())
    with pytest.raises(ValueError, match=r"2\^24 nodes"):
        tce.check_cp_encoding(dataclasses.replace(lego, resolutions=(64, 128, 256, 2**24 + 1)))


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


PLAN_SHAPES = [  # (N, levels, resolutions, C, SMs)
    (1, 4, (64, 128, 256, 512), 16, 132),
    (1000, 4, (64, 128, 256, 512), 16, 132),
    (196_608, 4, (64, 128, 256, 512), 16, 132),
    (3_145_728, 4, (64, 128, 256, 512), 16, 132),
    (10_001, 3, (8, 17, 40), 16, 7),
    (5_000, 1, (2048,), 64, 132),
    (777, 2, (4096, 8192), 4, 16),
    (999, 16, (64,) * 16, 12, 132),
]


def _plan_spec(L, res, C):
    return tce.CPEncodeSpec(n_levels=L, resolutions=res, n_components=C, bbox_min=-1.5,
                            bbox_max=1.5, compute_dtype="float32")


@pytest.mark.parametrize("N,L,res,C,n_sm", PLAN_SHAPES)
def test_kernel_plans_cover_every_point_and_level(N, L, res, C, n_sm):
    """fwd_plan's blocks and turns take every point once, its shared memory
    stays within 232,448 bytes and the lines are staged exactly where they
    fit; bwd_plan's ranges x lane groups take every point once at every
    level, as csrc/cp_encode.cu walks them."""
    spec = _plan_spec(L, res, C)
    staged, smem, blocks, bp = tce.fwd_plan(spec, N, n_sm)
    gw = tce.group_width(C)
    assert gw >= C // 4 and gw & (gw - 1) == 0 and bp * L * gw <= tce.FWD_THREADS
    assert smem <= 232_448 and staged == (4 * tce.line_floats(spec) <= 232_448)
    assert smem == (4 * tce.line_floats(spec) if staged else 0)
    seen = np.zeros(N, np.int64)
    for b in range(blocks):
        for start in range(b * bp, N, blocks * bp):
            seen[start:start + bp] += 1
    assert (seen == 1).all()
    ranges, block_points, stretch = tce.bwd_plan(N, L, C, n_sm)
    groups = tce.BWD_THREADS // (L * gw)
    assert block_points == groups * stretch
    assert (ranges - 1) * block_points < N <= ranges * block_points
    assert tce.BWD_MIN_STRETCH <= stretch <= tce.BWD_MAX_STRETCH
    seen = np.zeros(N, np.int64)
    for rg in range(ranges):
        for g in range(groups):
            s0 = rg * block_points + g * stretch
            seen[s0:max(s0, min(N, s0 + stretch))] += 1
    assert (seen == 1).all()  # at each level: every block takes every level


def _emulate_bwd(spec, lines, x, dout, n_sm):
    """csrc/cp_encode.cu's cp_bwd_kernel in numpy (fp32, each product and
    sum rounded as the kernel rounds it) on bwd_plan's grid: each lane group
    walks its stretch in order and, per axis, keeps the sums of its two open
    rows, carries one when the taps move a row on, and adds a row to dLines
    when the taps leave it, unless its sum is 0. Returns (the per-level
    dLines, the row adds at each level)."""
    N, C = x.shape[0], spec.n_components
    ranges, block_points, stretch = tce.bwd_plan(N, spec.n_levels, C, n_sm)
    groups = tce.BWD_THREADS // (spec.n_levels * tce.group_width(C))
    out, adds = [], []
    for li, r in enumerate(spec.resolutions):
        i0, w0, w1 = tce._taps(spec, x, r)
        f = tce._axis_values(spec, lines[li], i0, w0, w1)
        d = dout[:, li * C:(li + 1) * C]
        df = [d * o for o in (f[1] * f[2], f[0] * f[2], f[0] * f[1])]
        if spec.bf16:
            df = [round_bf16(v) for v in df]
        i0, w0, w1 = i0.numpy(), w0.numpy(), w1.numpy()
        df = [v.numpy() for v in df]
        dl = np.zeros((3, r, C), np.float32)
        count = 0
        for rg in range(ranges):
            for g in range(groups):
                s0 = rg * block_points + g * stretch
                s1 = min(N, s0 + stretch)
                for a in range(3):
                    if s0 >= s1:
                        continue
                    row, sums = -2, [np.zeros(C, np.float32), np.zeros(C, np.float32)]

                    def add(at, v):
                        nonlocal count
                        if (v != 0).any():
                            dl[a, at] += v
                            count += 1

                    for n in range(s0, s1):
                        mv = int(i0[n, a]) - row
                        if mv:
                            if row >= 0:
                                if mv != -1:
                                    add(row, sums[0])
                                if mv != 1:
                                    add(row + 1, sums[1])
                            zero = np.zeros(C, np.float32)
                            sums = [sums[1] if mv == 1 else zero, sums[0] if mv == -1 else zero]
                            row = int(i0[n, a])
                        sums[0] = sums[0] + w0[n, a] * df[a][n]
                        sums[1] = sums[1] + w1[n, a] * df[a][n]
                    add(row, sums[0])
                    add(row + 1, sums[1])
        out.append(dl)
        adds.append(count)
    return out, adds


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind,n_sm", [("rays", 2), ("rays", 132), ("uniform", 2)])
def test_bwd_walk_matches_plain(dtype, kind, n_sm):
    """The backward kernel's walk (``_emulate_bwd``) gives the plain
    version's dLines within 1e-5 of its largest value (the sums grouped
    otherwise), on 40 rays of 24 samples (stretches cut rays: at 2 SMs a
    group walks 16 points, at 132 too) and on uniform points. On the rays the coarse
    level's row adds are far fewer than its points' 6 a point, while on
    uniform points only chance neighbours (1 in 8 rows) share them."""
    tenc, _, _ = _pair(dtype)
    spec = tce.CPEncodeSpec.from_encoding(tenc)
    x = torch.from_numpy(_ray_points(40, 24, seed=3) if kind == "rays" else _points(960, seed=3))
    dout = torch.from_numpy(np.random.default_rng(4).normal(size=(960, 48)).astype(np.float32))
    with torch.no_grad():
        got, adds = _emulate_bwd(spec, tenc.lines, x, dout, n_sm)
        want = tce.cp_bwd_reference(spec, tenc.lines, x, dout)
    for a, b in zip(got, want):
        b = b.numpy()
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())
    if kind == "rays":
        assert adds[0] < 960 * 6 / 4, adds
    else:
        assert adds[0] > 960 * 6 / 2, adds


def _cuda_pair(dtype, dev):
    enc = CPGridEncoding(compute_dtype=dtype, device=dev)  # lego_cp's grid
    return enc.init(torch.Generator(device=dev).manual_seed(0))


def _cuda_points(kind, dev):
    """The card test's points: "random", 100,003 uniform in and around the
    box; "rays", 1,237 rays of 97 samples (119,989 points, a multiple of no
    warp, block or range) and then 60,001 copies of one point outside the
    box (one run that crosses stretches, blocks and ranges); "frame", a
    400 x 400 frame's coarse chunk, 32,768 rays of 48 samples (1,572,864
    points)."""
    g = torch.Generator(device=dev).manual_seed(1)
    if kind == "random":
        return (torch.rand((100_003, 3), generator=g, device=dev) * 3.4 - 1.7).contiguous()
    if kind == "frame":
        return torch.from_numpy(_ray_points(32_768, 48, seed=5)).to(dev)
    rays = torch.from_numpy(_ray_points(1_237, 97, seed=6))
    run = torch.tensor([[1.9, -0.3, 0.7]]).expand(60_001, 3)
    return torch.cat([rays, run]).to(dev).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,kind,grid", [
    pytest.param("bfloat16", "random", "lego_cp", id="bfloat16"),
    pytest.param("float32", "random", "lego_cp", id="float32"),
    pytest.param("bfloat16", "rays", "lego_cp", id="bfloat16-rays"),
    pytest.param("float32", "rays", "lego_cp", id="float32-rays"),
    pytest.param("bfloat16", "frame", "lego_cp", id="bfloat16-frame"),
    pytest.param("float32", "rays", "wide", id="float32-rays-wide"),
    pytest.param("bfloat16", "random", "wide", id="bfloat16-wide"),
])
def test_cuda_cp_kernels_match_twin(dtype, kind, grid):
    """Both kernels against the plain versions, at lego_cp's grid (4 levels
    of 64..512 nodes, C = 16: the forward stages the lines in shared memory)
    and at a wide grid (2 levels of 2048 and 4096 nodes, C = 32: 2.4 MB of
    lines, read through L1), on uniform points (some outside the box), on
    ray-ordered points with a long run, and on a frame chunk's 1,572,864
    points: the features within atol 1e-6 + rtol 1e-5 of the plain version
    (the same roundings; sums of two exact products; whether they are equal
    bit for bit is printed), dLines within 1e-4 of the plain version's
    largest value (sums grouped otherwise, atomics in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    if grid == "lego_cp":
        enc = _cuda_pair(dtype, dev)
    else:
        enc = CPGridEncoding(n_levels=2, min_res=2048, max_res=4096, n_components=32,
                             compute_dtype=dtype, device=dev)
        enc.init(torch.Generator(device=dev).manual_seed(0))
    spec = tce.CPEncodeSpec.from_encoding(enc)
    staged = tce.fwd_plan(spec, 1, 132)[0]
    assert staged == (grid == "lego_cp")
    x = _cuda_points(kind, dev)
    dout = torch.randn((x.shape[0], spec.out_dim), generator=torch.Generator(
        device=dev).manual_seed(2), device=dev)
    n0 = dict(LAUNCHES)
    feats = tce.cp_encode_apply(enc, x)
    grads = torch.autograd.grad((feats * dout).sum(), list(enc.lines))
    torch.cuda.synchronize()
    assert LAUNCHES["cp_fwd"] == n0["cp_fwd"] + 1 and LAUNCHES["cp_bwd"] == n0["cp_bwd"] + 1
    with torch.no_grad():
        want = tce.cp_fwd_reference(spec, enc.lines, x)
        dl = tce.cp_bwd_reference(spec, enc.lines, x, dout)
    feats = feats.detach()
    print(f"[cp] {dtype} {kind} {grid} N={x.shape[0]}: features max abs "
          f"{float((feats - want).abs().max()):.3e}, equal bit for bit: "
          f"{bool(torch.equal(feats, want))}")
    torch.testing.assert_close(feats, want, rtol=1e-5, atol=1e-6)
    for a, b in zip(grads, dl):
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        assert a.shape == b.shape and err <= 1e-4 * scale, (err, scale)


@pytest.mark.gpu
def test_cuda_plans_match_python_twins():
    """The C launchers' plans (``cp_plans``) equal fwd_plan and bwd_plan at
    PLAN_SHAPES and on this card's SM count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for N, L, res, C, sms in PLAN_SHAPES:
        spec = _plan_spec(L, res, C)
        for m in (sms, n_sm):
            assert tce.kernel_plans(spec, N, m) == (tce.fwd_plan(spec, N, m),
                                                    tce.bwd_plan(N, L, C, m))
