"""The INGP eval kernel on wgmma (csrc/ingp_eval_tc.cu, routed by
kernels/fused_ingp_train.py's ``eval_build``).

* Its arithmetic emulated in torch (``_emulate_eval_kernel``): the hash
  features in the kernels' compute type; each dense layer through
  ``tf32_products.mm_wgmma`` (both operands split into TF32 halves, the
  products lo·hi, hi·lo, hi·hi of a k-step of 8, a whole layer in one
  accumulator that rounds toward zero); the view layer's SH term once a
  ray; the heads and the biases in fp32; the compositing in the kernel's
  block ranges, tiles, ray segments and chunks of 32 samples, a ray that
  continues into the next tile carrying its sums. Held against the plain
  version and the JAX ``fused_ingp_eval_apply`` (the Pallas
  ``_ingp_eval_kernel`` in interpret mode, as
  tests/test_torch_fused_ingp.py runs it) at atol 1e-4 + rtol 1e-4, the
  card's value tolerance, at lego_ingp's and lego_ingp_occ's shapes.
* The TF32 hi and lo images each block writes (``_eval_image``, the twin
  of its put_image) against the layout csrc/fused_eval.cu's images take.
* The shared-memory plan (``_eval_smem_plan``, the twin of its
  smem_layout): which shapes stream which layers.
* ``gpu``-marked: the kernel against the plain version at its bounds, two
  launches bit for bit, the call's launches and allocations, and its
  3xTF32 products at lego_ingp's shapes: within EVAL_TIGHT of plain, where
  the same source built with one TF32 pass (``INGP_EVAL_ONE_PASS``) is not.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nerf_meets_mlx_torch.config import MLPConfig
from nerf_meets_mlx_torch.config import lego_ingp as t_ingp
from nerf_meets_mlx_torch.encoding.spherical_harmonics import sh_encode
from nerf_meets_mlx_torch.kernels import fused_ingp_train as tfi
from nerf_meets_mlx_torch.kernels import fused_train as tft
from nerf_meets_mlx_torch.kernels.fused_train import LAUNCHES, TrainSpec
from nerf_meets_mlx_torch.models import NeRFMLP
from nerf_meets_mlx_torch.models import create_nerf as t_create
from tf32_products import mm_wgmma
from torch_threads import one_torch_thread_per_worker  # noqa: F401  (autouse fixture)

# csrc/ingp_eval_tc.cu's tile, the most rays a tile meets, a block's shared
# memory in floats, the card's SMs (the grid of the emulated launches)
TILE, MAX_RAYS, SMEM_FLOATS, SMS = 192, 33, 232448 // 4, 132
# the tight tolerance (atol = rtol) of the kernel's rgb and weights at
# lego_ingp's shapes on the card, as chip_smoke.py's EVAL_TIGHT: its 3xTF32
# products meet it, one TF32 pass does not
EVAL_TIGHT = 1e-6
# lego_ingp's hash grid (lego_ingp_occ's is the same)
LEGO_ENC = dict(n_levels=8, min_res=16, max_res=256, features_per_level=2, log2_table_size=14)


def _ru(x, m):
    return -(-x // m) * m


def tile_points(S):
    """Points a tile of the kernel (its tile_points)."""
    return min(TILE, S * (MAX_RAYS - 1))


def _eval_image(w, kin):
    """The TF32 hi and lo images csrc/ingp_eval_tc.cu's put_image writes
    for a dense layer from its nn.Linear weight ``w`` [N, >= kin], its
    first ``kin`` columns on the tensor cores: per k-step s of 8 the hi
    image, then the lo one, each as core matrices [K half][N/8][8][4], K
    index q of the step holding column 8s + 2q (q < 4) or 8s + 2(q - 4) + 1,
    zero past kin; the same index arithmetic as the kernel's."""
    N, K = w.shape[0], _ru(kin, 8)
    n = torch.arange(N)[:, None].expand(N, K)
    k = torch.arange(K)[None, :].expand(N, K)
    x = torch.nn.functional.pad(w[:, :kin].float(), (0, K - kin))
    s, f = k // 8, k % 8
    q = torch.where(f % 2 == 1, 4 + f // 2, f // 2)
    o = s * 16 * N + (q // 4) * 4 * N + (n // 8) * 32 + (n % 8) * 4 + q % 4
    hi = tft._tf32(x)
    lo = tft._tf32(x - hi)
    img = torch.zeros(K // 8 * 16 * N)
    img[o.reshape(-1)] = hi.reshape(-1)
    img[(o + 8 * N).reshape(-1)] = lo.reshape(-1)
    return img


def _eval_smem_plan(W, D, E, DD):
    """(bytes, the dense layers resident in shared memory) of a block of
    csrc/ingp_eval_tc.cu (its smem_layout): the tile's buffers, then every
    dense layer's image (trunk 0..D-1, feature D, view D+1) where they all
    fit, else a stage for the streamed ones and, in the order view,
    feature, trunk 0, 1, ..., each image that still fits."""
    WH, o = W // 2, 0
    se = _ru(E, 16) + 8
    for n in (8, 2 * TILE * se, 2 * MAX_RAYS * WH, 3 * TILE, 2 * TILE, 2 * TILE, 6 * TILE, 16,
              DD * WH, D * W, W, WH, W, 3 * WH, 1, 3):
        o += _ru(n, 4)
    sizes = [2 * (_ru(E, 8) if i == 0 else W) * (WH if i == D + 1 else W) for i in range(D + 2)]
    if o + sum(sizes) <= SMEM_FLOATS:
        return 4 * (o + sum(sizes)), list(range(D + 2))
    o += max(sizes)
    resident = []
    for i in [D + 1, D] + list(range(D)):
        if o + sizes[i] <= SMEM_FLOATS:
            o += sizes[i]
            resident.append(i)
    return 4 * o, sorted(resident)


def _composite_tiles(tspec, q, alpha, c, blocks=SMS):
    """The kernel's compositing of [R, S] q, alpha and colours c [R, S, 3]:
    block b walks rays R·b/grid .. R·(b+1)/grid in tiles of tile_points(S)
    consecutive points; each ray a tile meets is a segment walked in chunks
    of 32 samples (the exclusive sum as the running sum before the chunk
    plus the chunk's inclusive sums before the sample), its weights and
    colour sums added to those it carried in."""
    R, S = q.shape
    grid, tile = min(blocks, R), tile_points(S)
    qf, af, cf = q.reshape(-1), alpha.reshape(-1), c.reshape(-1, 3)
    weights = torch.empty(R * S)
    rgb = torch.empty((R, 3))
    zero = torch.zeros(1)
    for b in range(grid):
        p0, p1 = R * b // grid * S, R * (b + 1) // grid * S
        carried = {}
        for g0 in range(p0, p1, tile):
            n = min(tile, p1 - g0)
            for ray in range(g0 // S, (g0 + n - 1) // S + 1):
                ps, pe = max(g0, ray * S), min(g0 + n, (ray + 1) * S)
                run, tot = carried.pop(ray, (torch.zeros(()), torch.zeros(4)))
                part = torch.zeros(4)
                for c0 in range(ps, pe, 32):
                    span = slice(c0, min(c0 + 32, pe))
                    incl = torch.cumsum(qf[span], 0)
                    excl = run + torch.cat([zero, incl[:-1]])
                    run = run + incl[-1]
                    w = af[span] * torch.exp(-excl)
                    weights[span] = w
                    part[:3] += (w[:, None] * cf[span]).sum(0)
                    part[3] += w.sum()
                tot = tot + part
                if (ray + 1) * S > g0 + n:
                    carried[ray] = (run, tot)
                else:
                    rgb[ray] = tot[:3] + ((1.0 - tot[3]) if tspec.white_bkgd else 0.0)
    return rgb, weights.reshape(R, S)


def _emulate_eval_kernel(mlp, enc, sh, tspec, ro, rd, z, dl, passes=3, blocks=SMS):
    """csrc/ingp_eval_tc.cu's arithmetic in torch (see the module note):
    (rgb [R, 3], weights [R, S])."""
    from nerf_meets_mlx_torch.kernels.hash_encode import hash_encode_reference

    R, S = z.shape
    W = mlp.cfg.net_width
    la, lf, lv, lr = mlp.alpha_linear, mlp.feature_linear, mlp.dir_linear, mlp.rgb_linear
    with torch.no_grad():
        pts = (ro[:, None] + z[..., None] * rd[:, None]).reshape(-1, 3)
        h = hash_encode_reference(enc, pts)
        for lin in mlp.pos_linears:
            h = torch.relu(mm_wgmma(h, lin.weight.t(), passes) + lin.bias)
        sigma = h @ la.weight.t() + la.bias
        feat = mm_wgmma(h, lf.weight.t(), passes) + lf.bias
        vsh = (lv.bias + sh @ lv.weight[:, W:].t()).repeat_interleave(S, 0)
        hd = torch.relu(mm_wgmma(feat, lv.weight[:, :W].t(), passes) + vsh)
        raw = hd @ lr.weight.t() + lr.bias
        q, alpha = tft._alpha_terms(tspec, sigma.reshape(R, S), dl)
        c = raw.reshape(R, S, 3)
        if tspec.mode == "canonical":
            c = torch.sigmoid(c)
        return _composite_tiles(tspec, q, alpha, c, blocks)


def _over_tight(got, want):
    """The largest |got - want| / (EVAL_TIGHT + EVAL_TIGHT·|want|) over
    rgb and weights: at most 1 within the tight tolerance."""
    return max(float(((g - w).abs() / (EVAL_TIGHT * (1.0 + w.abs()))).max())
               for g, w in zip(got, want))


def test_eval_image_puts_every_weight_in_its_place():
    """``_eval_image`` (the kernel's index arithmetic) writes, for every
    dense layer of lego_ingp's fine MLP and of a width-32 MLP on 12 hash
    channels, exactly the images csrc/fused_eval.cu's descriptors read
    (``fused_train._wgmma_image``, read back through the descriptor layout
    in tests/test_torch_fused_eval.py): each (k, n) where the kernel reads
    it, hi and lo TF32 (low 13 bits clear), |hi + lo - w| <= 2^-22 |w|, zero
    past the layer's inputs (layer 0's K is L·F rounded up to 8; the view
    layer's SH columns are not in its image)."""
    from test_torch_fused_eval import _unpack_image

    fine = t_create(t_ingp(), device="cpu").init(torch.Generator().manual_seed(5)).fine
    narrow = NeRFMLP(MLPConfig(net_depth=3, net_width=32, skips=(), use_viewdirs=True), 12, 25)
    narrow.init(torch.Generator().manual_seed(6))
    for mlp in (fine, narrow):
        W = mlp.cfg.net_width
        layers = [lin for lin in mlp.pos_linears] + [mlp.feature_linear, mlp.dir_linear]
        for i, lin in enumerate(layers):
            w = lin.weight.detach()
            kin = W if lin is mlp.dir_linear else w.shape[1]
            img = _eval_image(w, kin)
            assert torch.equal(img, tft._wgmma_image(w[:, :kin], [kin])), i
            hi, lo = _unpack_image(img, w.shape[0], _ru(kin, 8))
            wt = torch.nn.functional.pad(w[:, :kin].t(), (0, 0, 0, _ru(kin, 8) - kin))
            for half in (hi, lo):
                assert bool(((half.view(torch.int32) & 0x1FFF) == 0).all()), i
            assert bool(((hi + lo - wt).abs() <= 2.0**-22 * wt.abs()).all()), i
            assert not bool(hi[kin:].any()) and not bool(lo[kin:].any())


@pytest.mark.parametrize("W,D,L,F,DD,resident", [
    (64, 2, 8, 2, 25, [0, 1, 2, 3]),     # lego_ingp and lego_ingp_occ: all on chip
    (32, 2, 8, 2, 25, [0, 1, 2, 3]),
    (64, 4, 8, 2, 25, [0, 1, 2, 3, 4, 5]),
    (64, 2, 16, 4, 25, [2, 3]),          # 64 channels: the trunk streams
    (64, 8, 8, 2, 25, [0, 1, 2, 8, 9]),  # depth 8: trunk layers 3..7 stream
    (32, 8, 16, 4, 64, list(range(10))),
    (64, 8, 16, 4, 64, [8, 9]),          # the widest shape: only feature and view stay
])
def test_eval_smem_plan(W, D, L, F, DD, resident):
    """The kernel's shared-memory plan: every shape eval_build sends to it
    fits a block (at most 232,448 bytes), with the layers that do not fit
    streamed through one stage; lego_ingp's keeps every image on chip."""
    assert tfi.eval_build(W, D, L, F, DD) == (tfi.EVAL_SOURCE, {})
    nbytes, got = _eval_smem_plan(W, D, L * F, DD)
    assert got == resident
    assert nbytes <= 4 * SMEM_FLOATS


def test_eval_tiles_meet_at_most_max_rays():
    """A tile of tile_points(S) points meets at most MAX_RAYS rays at every
    S (the kernel sizes its per-ray buffers by it): S >= 6 takes the 192
    points of three 64-row warpgroups, whole rays at every preset's S; a
    shorter ray takes 32 rays a tile."""
    for S in range(1, 400):
        tile = tile_points(S)
        assert tile == (TILE if S >= 6 else 32 * S)
        worst = max(((g0 + tile - 1) // S - g0 // S + 1) for g0 in range(0, 4 * S * tile, tile))
        assert worst <= MAX_RAYS, S
    for S in (48, 96, 32, 64):
        assert TILE % S == 0


def _lego_case(S, R, dtype="float32", noisy=True, seed=1):
    """JAX and port models at lego_ingp's width, depth and hash grid (the
    tables' noise and the bf16 init as tests/test_torch_fused_ingp.py's
    shape cases), R rays of S samples from numpy."""
    from test_torch_fused_ingp import _inputs, _models

    models = _models(seed=seed, enc=LEGO_ENC, width=64, dtype=dtype, noisy=noisy)
    ro, rd, vd, z, deltas, _, _ = _inputs(R, S, seed=seed)
    return models, (ro, rd, vd, z, deltas)


# lego_ingp's levels (48, 96), lego_ingp_occ's (32, 64); bf16 hash compute
EMU_CASES = [
    pytest.param(S, mode, "float32", id=f"S{S}-{mode}")
    for S in (48, 96, 32, 64) for mode in ("canonical", "reference")
] + [
    pytest.param(48, "canonical", "bfloat16", id="S48-canonical-bf16"),
    pytest.param(96, "reference", "bfloat16", id="S96-reference-bf16"),
]


@pytest.mark.parametrize("S,mode,dtype", EMU_CASES)
def test_eval_arithmetic_holds_the_card_tolerance(S, mode, dtype):
    """The kernel's arithmetic (``_emulate_eval_kernel``) at lego_ingp's
    shapes on 4 rays against the plain version and the JAX op (Pallas in
    interpret mode) at atol 1e-4 + rtol 1e-4, the tolerance chip_smoke.py
    and the gpu tests hold the kernel to, and the plain version also at
    EVAL_TIGHT; one TF32 pass lands further off (printed: its worst error
    over either tolerance, beside 3xTF32's)."""
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.kernels.fused_feat_train import pack_feat_params
    from nerf_meets_mlx_tpu.kernels.fused_ingp_train import fused_ingp_eval_apply as j_apply
    from nerf_meets_mlx_tpu.kernels.hash_encode import HashEncodeSpec, pack_tables
    from test_torch_fused_ingp import _tspecs

    R = 4
    bf16 = dtype == "bfloat16"
    ((jenc, fspec, params, tables), (tenc, tmlp)), (ro, rd, vd, z, deltas) = _lego_case(
        S, R, dtype, noisy=not bf16)
    sh = sh_encode(torch.from_numpy(vd), 4)
    jspec, tspec = _tspecs(R, S, mode, True, 2)
    hspec = HashEncodeSpec.from_encoding(jenc)
    rgb_j, w_j = j_apply(fspec, hspec, jspec, pack_feat_params(fspec, params),
                         pack_tables(hspec, tables),
                         *(jnp.asarray(a) for a in (ro, rd, sh.numpy(), z, deltas)))
    args = (tmlp, tenc, sh, tspec, *(torch.from_numpy(a) for a in (ro, rd, z, deltas)))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            want = tfi.fused_ingp_eval_reference(*args)
        got = {p: _emulate_eval_kernel(*args, passes=p) for p in (3, 1)}
    finally:
        torch.set_num_threads(threads)
    for g, w, j in zip(got[3], want, (rgb_j, w_j)):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(g, torch.from_numpy(np.asarray(j)), rtol=1e-4, atol=1e-4)
    worst = {p: max(float(((g - w).abs() / (1e-4 + 1e-4 * w.abs())).max())
                    for g, w in zip(got[p], want)) for p in got}
    tight = {p: _over_tight(got[p], want) for p in got}
    print(f"[tf32] S={S} {mode} {dtype}: worst error over the tolerance, 3xTF32 "
          f"{worst[3]:.3f}, one pass {worst[1]:.3f}; over EVAL_TIGHT, 3xTF32 "
          f"{tight[3]:.3f}, one pass {tight[1]:.3f}")
    assert worst[1] > worst[3], worst
    assert tight[3] <= 1.0, tight


@pytest.mark.parametrize("S,R,blocks", [(256, 3, 2), (100, 7, 2), (5, 70, 3), (48, 9, 2)])
def test_eval_segments_composite_as_plain(S, R, blocks):
    """Rays longer than a tile (S = 256: two segments), rays that straddle
    tiles (S = 100), short rays (S = 5: 32 rays a tile) and a block's
    last, partial tile (9 rays of 48 over 2 blocks): the kernel's
    compositing with carried sums (``_composite_tiles``) gives the plain
    version's rgb and weights at atol 1e-5 + rtol 1e-5."""
    rng = np.random.default_rng(S)
    q = torch.from_numpy(rng.uniform(0.0, 0.2, (R, S)).astype(np.float32))
    alpha = 1.0 - torch.exp(-q)
    c = torch.from_numpy(rng.uniform(size=(R, S, 3)).astype(np.float32))
    spec = TrainSpec(n_samples=S, rays_block=1, mode="canonical", density_activation="softplus",
                     white_bkgd=True)
    rgb, w = _composite_tiles(spec, q, alpha, c, blocks)
    w_p = alpha * torch.exp(-tft.exclusive_cumsum(q))
    rgb_p = (w_p[..., None] * c).sum(1) + (1.0 - w_p.sum(1, keepdim=True))
    torch.testing.assert_close(w, w_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rgb, rgb_p, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _cuda_case(width, depth, enc, dtype, R, S, seed=2):
    """lego_ingp at ``width``, ``depth`` and hash ``enc`` on the card (seeded
    init, tables + N(0, 0.1) from a generator of its own) and R rays of S
    samples."""
    from nerf_meets_mlx_torch.config import EncodingConfig

    dev = torch.device("cuda")
    pcfg = dataclasses.replace(EncodingConfig(kind="hash_grid", in_dim=3), **enc,
                               hash_compute_dtype=dtype)
    cfg = t_ingp()
    mlp = dataclasses.replace(cfg.mlp, net_width=width, net_depth=depth)
    cfg = cfg.replace(pos_encoding=pcfg, mlp=mlp, mlp_fine=mlp)
    tm = t_create(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        tm.pos_enc.tables.add_(torch.randn(tm.pos_enc.tables.shape, device=dev,
                                           generator=torch.Generator(device=dev).manual_seed(1))
                               * 0.1)
    g = torch.Generator(device=dev).manual_seed(seed)
    ro = torch.randn((R, 3), generator=g, device=dev) * 0.2 + torch.tensor([0.0, 0.0, 3.0], device=dev)
    rd = torch.randn((R, 3), generator=g, device=dev) * 0.2 + torch.tensor([0.0, 0.0, -1.0], device=dev)
    sh = sh_encode(rd / rd.norm(dim=-1, keepdim=True), 4)
    z = torch.sort(torch.rand((R, S), generator=g, device=dev) * 4.0 + 1.0, dim=-1).values
    dl = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1) * rd.norm(
        dim=-1, keepdim=True)
    return tm, (sh, ro, rd, z, dl)


def _spec(S, mode="canonical", white=True, act="softplus"):
    rb = tfi.ingp_rays_block(S)
    return TrainSpec(n_samples=S, rays_block=rb, mode=mode, density_activation=act,
                     white_bkgd=white, group=tfi.ingp_group(S, rb))


L8F2 = dict(hash_n_levels=8, hash_features_per_level=2)
L16F4 = dict(hash_n_levels=16, hash_features_per_level=4)
BOUND_CASES = [
    pytest.param(64, 8, L8F2, "float32", 1001, 48, id="depth8"),
    pytest.param(64, 2, L16F4, "float32", 501, 48, id="L16F4"),
    pytest.param(32, 8, L16F4, "bfloat16", 501, 32, id="w32-depth8-L16F4-bf16"),
    pytest.param(64, 2, L8F2, "float32", 301, 256, id="S256"),
    pytest.param(64, 2, L8F2, "float32", 1001, 100, id="S100-partial-tiles"),
    pytest.param(64, 2, L8F2, "float32", 137, 5, id="S5"),
    pytest.param(64, 2, L8F2, "float32", 7, 48, id="R7-fewer-rays-than-SMs"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("width,depth,enc,dtype,R,S", BOUND_CASES)
def test_cuda_eval_kernel_at_its_bounds(width, depth, enc, dtype, R, S):
    """csrc/ingp_eval_tc.cu (eval_build routes the shape to it) against the
    plain version (bf16: its rounding twin) at depth 8, 16 levels of 4
    features (layers streamed through the stage), a ray longer than a tile
    (S = 256: two segments), rays straddling tiles and blocks' partial
    tiles (S = 100, 1,001 rays), short rays (S = 5), fewer rays than SMs;
    both compositing modes, relu and softplus density, the white background
    on and off: rgb and weights within atol 1e-4 + rtol 1e-4, and within
    EVAL_TIGHT."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    tm, (sh, ro, rd, z, dl) = _cuda_case(width, depth, enc, dtype, R, S)
    L, F = tm.pos_enc.n_levels, tm.pos_enc.features_per_level
    assert tfi.eval_build(width, depth, L, F, tm.fine.in_dim_views) == (tfi.EVAL_SOURCE, {})
    for mode, white, act in (("canonical", True, "softplus"), ("reference", False, "softplus"),
                             ("canonical", False, "relu")):
        spec = _spec(S, mode, white, act)
        n0 = LAUNCHES["ingp_eval"]
        with torch.no_grad():
            rgb, w = tfi.fused_ingp_eval_apply(tm.fine, tm.pos_enc, sh, spec, ro, rd, z, dl)
            torch.cuda.synchronize()
            rgb_p, w_p = tfi.fused_ingp_eval_reference(tm.fine, tm.pos_enc, sh, spec, ro, rd, z, dl)
        assert LAUNCHES["ingp_eval"] == n0 + 1
        print(f"[bounds] {width} x {depth} L{L}F{F} {dtype} R={R} S={S} {mode} {act}: max abs "
              f"rgb {float((rgb - rgb_p).abs().max()):.3e}, "
              f"weights {float((w - w_p).abs().max()):.3e}")
        torch.testing.assert_close(rgb, rgb_p, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(w, w_p, rtol=1e-4, atol=1e-4)
        assert _over_tight((rgb, w), (rgb_p, w_p)) <= 1.0


@pytest.mark.gpu
def test_cuda_eval_kernel_is_deterministic():
    """Two launches on the same inputs give bit-identical rgb and weights
    (no atomics; every sum in a fixed order), at lego_ingp's fine level on
    4,096 rays and at S = 256 (carried sums)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    for R, S in ((4096, 96), (301, 256)):
        tm, (sh, ro, rd, z, dl) = _cuda_case(64, 2, L8F2, "float32", R, S)
        with torch.no_grad():
            runs = [tfi.fused_ingp_eval_apply(tm.fine, tm.pos_enc, sh, _spec(S), ro, rd, z, dl)
                    for _ in range(2)]
        for a, b in zip(*runs):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_eval_smem_matches_its_python_twin():
    """The kernel's own shared-memory count and streamed layers equal
    ``_eval_smem_plan``'s at the shapes of test_eval_smem_plan."""
    import ctypes

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    lib = tfi._eval_lib()
    for W, D, L, F, DD in ((64, 2, 8, 2, 25), (32, 2, 8, 2, 25), (64, 4, 8, 2, 25),
                           (64, 2, 16, 4, 25), (64, 8, 8, 2, 25), (32, 8, 16, 4, 64),
                           (64, 8, 16, 4, 64)):
        streamed = ctypes.c_int(-1)
        nbytes = lib.ingp_eval_tc_smem_bytes(W, D, L, F, DD, ctypes.byref(streamed))
        want, resident = _eval_smem_plan(W, D, L * F, DD)
        assert (nbytes, streamed.value) == (want, D + 2 - len(resident))


def _graph_launches(fn):
    """The device work of one call of ``fn()``, without the profiler: the
    call captured in a CUDA graph (kept, not run) and its nodes read through
    libcuda's graph functions. Returns [(node type, kernel name or None)];
    type 0 is a kernel (CU_GRAPH_NODE_TYPE_KERNEL), 1 a copy, 2 a memset."""
    import ctypes

    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(raw, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    assert cu.cuGraphGetNodes(raw, nodes, ctypes.byref(count)) == 0
    get_params = getattr(cu, "cuGraphKernelNodeGetParams_v2", cu.cuGraphKernelNodeGetParams)
    out = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0
        name = None
        if kind.value == 0:
            # CUDA_KERNEL_NODE_PARAMS: the CUfunction first; in its v2 form
            # the CUkernel at byte 56
            params = (ctypes.c_void_p * 16)()
            assert get_params(ctypes.c_void_p(node), params) == 0
            text = ctypes.c_char_p()
            if params[0]:
                assert cu.cuFuncGetName(ctypes.byref(text), ctypes.c_void_p(params[0])) == 0
            else:
                assert cu.cuKernelGetName(ctypes.byref(text), ctypes.c_void_p(params[7])) == 0
            name = text.value.decode()
        out.append((kind.value, name))
    del graph
    return out


@pytest.mark.gpu
def test_cuda_eval_call_launches_only_its_kernel():
    """At lego_ingp's shape a call of fused_ingp_eval_apply makes one
    device launch, csrc/ingp_eval_tc.cu's kernel, and two allocations, its
    outputs: no weight pack, no copy. The launches are read from the call
    captured in a CUDA graph (``_graph_launches``), not from torch.profiler,
    whose device events from CUPTI came back empty once for this call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    tm, (sh, ro, rd, z, dl) = _cuda_case(64, 2, L8F2, "float32", 4096, 48)
    args = (tm.coarse, tm.pos_enc, sh, _spec(48), ro, rd, z, dl)
    tfi.fused_ingp_eval_apply(*args)
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    out = tfi.fused_ingp_eval_apply(*args)
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == before + 2
    assert [tuple(t.shape) for t in out] == [(4096, 3), (4096, 48)]
    launches = _graph_launches(lambda: tfi.fused_ingp_eval_apply(*args))
    assert len(launches) == 1 and launches[0][0] == 0, launches
    assert "ingp_eval_tc_kernel" in launches[0][1], launches


@pytest.mark.gpu
@pytest.mark.parametrize("S,dtype,R", [(48, "float32", 4096), (96, "float32", 4096),
                                       (32, "float32", 4096), (64, "float32", 4096),
                                       (96, "bfloat16", 4096), (48, "float32", 32768),
                                       (96, "float32", 32768)])
def test_cuda_eval_kernel_runs_three_tf32_passes(S, dtype, R):
    """At lego_ingp's widths on 4,096 rays (and on a serving chunk's 32,768
    at lego_ingp's levels), at lego_ingp's and lego_ingp_occ's sample
    counts, in both compositing modes, bf16 hash compute at 96: the
    kernel's rgb and weights lie within EVAL_TIGHT (atol = rtol) of plain,
    and the same source built with one TF32 product in place of three
    (``INGP_EVAL_ONE_PASS``) lies outside it in each mode, so the tight
    tolerance tells the 3xTF32 kernel from a one-pass one. (In canonical
    mode a one-pass kernel meets atol 1e-4 + rtol 1e-4; in reference mode,
    where the transmittance may exceed 1, it can miss even that.) Both
    builds' errors are printed."""
    from nerf_meets_mlx_torch.kernels import _build

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    one_pass = tfi.type_eval_lib(_build.load_library(tfi.EVAL_SOURCE, {"INGP_EVAL_ONE_PASS": 1}))
    tm, (sh, ro, rd, z, dl) = _cuda_case(64, 2, L8F2, dtype, R, S)
    args = [t.contiguous() for t in (ro, rd, sh, z, dl)]
    for mode in ("canonical", "reference"):
        spec = _spec(S, mode)
        with torch.no_grad():
            three = tfi.fused_ingp_eval_apply(tm.fine, tm.pos_enc, sh, spec, ro, rd, z, dl)
            one = tfi._eval_tc_launch(tm.fine, tm.pos_enc, spec, args, one_pass)
            torch.cuda.synchronize()
            want = tfi.fused_ingp_eval_reference(tm.fine, tm.pos_enc, sh, spec, ro, rd, z, dl)
        over = {"3xTF32": _over_tight(three, want), "one pass": _over_tight(one, want)}
        print(f"[tf32] R={R} S={S} {dtype} {mode}: " + ", ".join(
            f"{k} max abs rgb {float((o[0] - want[0]).abs().max()):.3e} weights "
            f"{float((o[1] - want[1]).abs().max()):.3e} ({over[k]:.3f} of the tight tolerance)"
            for k, o in (("3xTF32", three), ("one pass", one))))
        assert over["3xTF32"] <= 1.0, over
        assert over["one pass"] > 1.0, over
