"""The port's 2-D image task: ``datasets/image.py``,
``kernels/fused_image.py`` (csrc/image_train_tc.cu, csrc/image_fwd_tc.cu),
``make_image_train_step``, ``entrypoints/image_learning.py`` and the
``image`` command.

* The procedural image and its pixel dataset equal the JAX package's.
* The plain image ops against the JAX ``fused_image_train`` /
  ``fused_image_apply``, which run the Pallas ``_train_kernel`` /
  ``_fwd_kernel`` in interpret mode here, on the same weights (via
  ``interop``) and coordinates made with numpy: at a small depth (with the
  raw input and a skip) and at image2d's full 8×256 with its skip. The
  output at rtol 1e-5 / atol 1e-5 and sse at rtol 1e-5 (the JAX package's
  own bounds, tests/test_fused_image.py), every dW and db at rtol 3e-4 /
  atol 5e-6.
* Three train steps of both packages from the same weights, with JAX's
  pixel indices passed in, on the fused route (JAX: the Pallas train kernel
  in interpret mode) and the standard route: losses at rtol 5e-4, the
  parameters after the last step at rtol 5e-3 / atol 1e-4 where the two
  gradients agree within 25% at every step, the rest within one Adam step
  each way per step.
* The forward kernel's arithmetic (``_emulate_forward``: every dense
  layer in 3xTF32 with one truncating accumulator a layer, ``mm_wgmma``)
  against the JAX ``fused_image_apply`` at atol 1e-4 + rtol 1e-4 and
  against the fp32 plain version at ``IMAGE_TIGHT``, which one TF32 pass
  misses, at image2d, widths 32 / 48 / 96, depth 20 and two skips with the
  raw input. Its weight images (``_pack_rendering``: the pack kernel's
  index arithmetic in torch) against ``fused_train._wgmma_image`` and
  against each ``nn.Linear`` weight, its segment table, image offsets and
  shared-memory plan.
* ``image_learning(device="cpu")`` and the ``image`` command.
* ``gpu``-marked: both CUDA kernels against the plain version on the card,
  the train call in the build ``fused_image.train_build`` names
  (csrc/image_train_tc.cu), at image2d's shape, at narrow widths, at depth
  20 and with two skips and the raw input; two train launches give
  bit-identical sse and gradients; the forward kernel within
  ``IMAGE_TIGHT`` of plain where its one-pass build
  (``IMAGE_FWD_ONE_PASS``) is not, one launch a call allocating only its
  output, two calls bit-identical, the images its pack wrote equal to
  ``_pack_rendering`` (skipped where no card is present).
"""

import dataclasses

import numpy as np
import pytest
import torch

from nerf_meets_mlx_torch import interop
from nerf_meets_mlx_torch.config import image2d as t_image2d
from nerf_meets_mlx_torch.datasets import image as timg
from nerf_meets_mlx_torch.kernels import fused_image as tfi
from nerf_meets_mlx_torch.kernels import fused_train as tft
from nerf_meets_mlx_torch.kernels.fused_train import LAUNCHES
from nerf_meets_mlx_torch.models import create_nerf as t_create
from tf32_products import _mm_1xtf32, _tf32, mm_wgmma
from torch_threads import one_torch_thread_per_worker  # noqa: F401  (autouse fixture)

# The tight tolerance (atol = rtol) of the forward kernel's output against
# the fp32 plain version, as chip_smoke.py's IMAGE_TIGHT: its 3xTF32
# products meet it, one TF32 pass does not (which meets atol 1e-4 + rtol
# 1e-4). On an H100 at test_cuda_image_fwd_runs_three_tf32_passes' cases
# the kernel's worst error read 3.9e-7 (max |d| / (1 + |plain|)) and the
# one-pass build's least 1.27e-5: IMAGE_TIGHT lies between, ~5x from each.
IMAGE_TIGHT = 2e-6

# JAX is imported by the tests that compare with it, not at module level:
# the gpu-marked tests run on the card's machine, which has no JAX
# (python -m pytest --noconftest -m gpu tests/test_torch_image.py).


def _cfg(make, depth=8, width=256, skips=(4,), include_input=False, n_rand=4096, fused=False):
    cfg = make()
    return cfg.replace(
        mlp=dataclasses.replace(cfg.mlp, net_depth=depth, net_width=width, skips=skips),
        pos_encoding=dataclasses.replace(cfg.pos_encoding, include_input=include_input),
        train=dataclasses.replace(cfg.train, n_rand=n_rand),
        use_fused_kernel=fused,
    )


def _pair(seed=0, **kw):
    """(JAX cfg, JAX model, JAX params, port model) on the same weights."""
    import jax

    from nerf_meets_mlx_tpu.config import image2d as j_image2d
    from nerf_meets_mlx_tpu.models import create_nerf as j_create

    jc, tc = _cfg(j_image2d, **kw), _cfg(t_image2d, **kw)
    jm = j_create(jc)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = t_create(tc, device="cpu")
    interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tm)
    return jc, jm, params, tm


def _data(n, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, size=(n, 2)).astype(np.float32)
    y = rng.uniform(size=(n, 3)).astype(np.float32)
    return x, y


def _grads(mlp):
    return [g for _, lin in mlp.linears() for g in (lin.weight.grad.t(), lin.bias.grad)]


def _jax_grads(g):
    out = []
    for name in [f"pos_linears.{i}" for i in range(len(g["pos_linears"]))] + ["output_linear"]:
        leaf = g["pos_linears"][int(name.split(".")[1])] if "." in name else g[name]
        out += [np.asarray(leaf["w"]), np.asarray(leaf["b"])]
    return out


def test_image_dataset_matches_jax():
    from nerf_meets_mlx_tpu.datasets import image as jimg

    a, b = timg.make_test_image(32, seed=3), jimg.make_test_image(32, seed=3)
    np.testing.assert_array_equal(a, b)
    for got, want in zip(timg.pixel_dataset(a), jimg.pixel_dataset(b)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(timg.load_image_2d(size=8), jimg.load_image_2d(size=8))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        timg.load_image_2d("some.png")


@pytest.mark.parametrize(
    "kw,n",
    [
        (dict(depth=3, width=64, skips=(1,), include_input=True), 300),
        (dict(), 130),
        (dict(depth=4, width=32, skips=(2,)), 200),
        (dict(depth=3, width=96, skips=(1,)), 150),
        (dict(depth=2, width=48), 150),
    ],
    ids=["small", "image2d", "width32", "width96", "width48"],
)
def test_image_ops_match_jax(kw, n):
    import jax
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.kernels.fused_image import (
        FusedImageSpec,
        fused_image_apply as j_apply,
        fused_image_train as j_train,
        pack_image_inputs,
        pack_image_params,
    )

    jc, jm, params, tm = _pair(**kw)
    x, y = _data(n)
    spec = FusedImageSpec.from_configs(jc.mlp, jc.pos_encoding, block=128)
    xj = pack_image_inputs(jnp.asarray(x))
    out_j = j_apply(spec, pack_image_params(spec, params["coarse"]), xj)[:, :3]
    sse_j, g_j = jax.value_and_grad(
        lambda p: j_train(spec, pack_image_params(spec, p), xj, jnp.asarray(y))
    )(params["coarse"])

    LAUNCHES["image_fwd"] = LAUNCHES["image_train"] = 0
    out = tfi.fused_image_apply(tm.coarse, tm.pos_enc, torch.from_numpy(x))
    assert not out.requires_grad and tuple(out.shape) == (n, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)
    sse = tfi.fused_image_train(tm.coarse, tm.pos_enc, torch.from_numpy(x), torch.from_numpy(y))
    sse.backward()
    assert LAUNCHES["image_fwd"] == LAUNCHES["image_train"] == 0  # the plain version
    np.testing.assert_allclose(float(sse.detach()), float(sse_j), rtol=1e-5)
    got, want = _grads(tm.coarse), _jax_grads(g_j)
    assert len(got) == len(want) == 2 * (tm.cfg.mlp.net_depth + 1)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=3e-4, atol=5e-6)


def _pad8(x):
    return torch.nn.functional.pad(x, (0, -x.shape[1] % 8))


def _emulate_forward(mlp, pos_enc, x, mm=mm_wgmma):
    """csrc/image_fwd_tc.cu's arithmetic in torch: the encoding as the plain
    version's; each trunk layer with its input segments zero-padded to
    whole k-steps of 8 as the kernel's B images are, multiplied by ``mm``
    (``mm_wgmma``: 3xTF32 with one truncating accumulator a layer, the
    kernel's form), plus the bias, relu; the output head in fp32."""
    cfg = mlp.cfg
    xe, h = pos_enc.apply(x), None
    for j, lin in enumerate(mlp.pos_linears):
        segs = [xe] if j == 0 else ([xe, h] if (j - 1) in cfg.skips else [h])
        a, b, at = [], [], 0
        for seg in segs:
            a.append(_pad8(seg))
            b.append(_pad8(lin.weight[:, at : at + seg.shape[1]]).t())
            at += seg.shape[1]
        h = torch.relu(mm(torch.cat(a, 1), torch.cat(b, 0)) + lin.bias)
    return mlp.output_linear(h)


def _over(got, want, tol):
    """max |got - want| / (tol + tol·|want|): at most 1 within atol = rtol = tol."""
    return float(((got - want).abs() / (tol * (1.0 + want.abs()))).max())


@pytest.mark.parametrize(
    "kw,n",
    [
        (dict(), 130),
        (dict(depth=4, width=32, skips=(2,)), 200),
        (dict(depth=2, width=48), 150),
        (dict(depth=3, width=96, skips=(1,)), 150),
        (dict(depth=20, width=64, skips=(4,)), 130),
        (dict(depth=8, width=64, skips=(2, 5), include_input=True), 300),
    ],
    ids=["image2d", "width32", "width48", "width96", "depth20", "two_skips_raw_input"],
)
def test_forward_kernel_arithmetic_matches_jax_kernel(kw, n):
    """The forward kernel's 3xTF32 arithmetic (``_emulate_forward``) on the
    JAX weights: within atol 1e-4 + rtol 1e-4 of the Pallas
    ``fused_image_apply`` in interpret mode, and within IMAGE_TIGHT of the
    fp32 plain version, where one TF32 pass (the kernel's one-pass build,
    ``mm_wgmma(passes=1)``, and ``_mm_1xtf32``) is not; the readings are
    printed."""
    import jax.numpy as jnp

    from nerf_meets_mlx_tpu.kernels.fused_image import (
        FusedImageSpec,
        fused_image_apply as j_apply,
        pack_image_inputs,
        pack_image_params,
    )

    jc, jm, params, tm = _pair(**kw)
    x, _ = _data(n, seed=5)
    spec = FusedImageSpec.from_configs(jc.mlp, jc.pos_encoding, block=128)
    want = np.asarray(j_apply(spec, pack_image_params(spec, params["coarse"]),
                              pack_image_inputs(jnp.asarray(x))))[:, :3]
    args = (tm.coarse, tm.pos_enc, torch.from_numpy(x))
    with torch.no_grad():
        three = _emulate_forward(*args)
        one = _emulate_forward(*args, mm=lambda a, b: mm_wgmma(a, b, passes=1))
        one_x = _emulate_forward(*args, mm=_mm_1xtf32)
        plain = tfi.fused_image_reference(*args)
    np.testing.assert_allclose(three.numpy(), want, rtol=1e-4, atol=1e-4)
    over = {"3xTF32": _over(three, plain, IMAGE_TIGHT), "one pass": _over(one, plain, IMAGE_TIGHT),
            "_mm_1xtf32": _over(one_x, plain, IMAGE_TIGHT)}
    print(f"[tf32] {kw}: over IMAGE_TIGHT {over}")
    assert over["3xTF32"] <= 1.0, over
    assert over["one pass"] > 1.0 and over["_mm_1xtf32"] > 1.0, over


def _pack_rendering(mlp, pos_enc):
    """csrc/image_fwd_tc.cu's image_fwd_pack_kernel in torch, element by
    element on the weights' device: element i of the images lies in the
    segment of ``fwd_segments`` whose ``fwd_image_offsets`` range holds it;
    within it, k-step i // (16 W), then the hi image (8 W floats) and the lo
    image, each [K half][W / 8][8 rows of N][4 of K], K index 4 · half + kk
    holding row 2 · kk + half of the step; the value is weight[n][first + k]
    (zero for k past the segment's columns), TF32-rounded (hi) or its
    remainder TF32-rounded (lo)."""
    W = mlp.cfg.net_width
    segs = tfi.fwd_segments(mlp, pos_enc)
    w = [lin.weight.detach() for _, lin in mlp.linears()]
    dev = w[0].device
    offs = torch.tensor(tfi.fwd_image_offsets(segs, W), device=dev)
    i = torch.arange(int(offs[-1]), device=dev)
    q = torch.searchsorted(offs, i, right=True) - 1
    e = i - offs[q]
    step, r = e // (16 * W), e % (16 * W)
    half_lo = r >= 8 * W
    r = r - 8 * W * half_lo.long()
    kh = r // (4 * W)
    r = r - kh * 4 * W
    n = 8 * (r // 32) + (r // 4) % 8
    k = 8 * step + 2 * (r % 4) + kh
    v = torch.zeros(i.shape, device=dev)
    for s, (lin, first, ld, cols) in enumerate(segs):
        assert ld == w[lin].shape[1]
        m = (q == s) & (k < cols)
        v[m] = w[lin].reshape(-1)[n[m] * ld + first + k[m]]
    hi = _tf32(v)
    return torch.where(half_lo, _tf32(v - hi), hi)


# the wgmma K order of a k-step (fused_train.WGMMA_K_ORDER) inverted: row f
# of the step sits at position _K_INV[f]
_K_INV = [tft.WGMMA_K_ORDER.index(f) for f in range(8)]


def _image_model(depth=8, width=256, skips=(4,), include_input=False, in_dim=2, n_freqs=10,
                 device="cpu", seed=0):
    cfg = t_image2d()
    cfg = cfg.replace(
        mlp=dataclasses.replace(cfg.mlp, net_depth=depth, net_width=width, skips=skips),
        pos_encoding=dataclasses.replace(cfg.pos_encoding, include_input=include_input,
                                         in_dim=in_dim, n_freqs=n_freqs),
    )
    dev = torch.device(device)
    return t_create(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(seed))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(depth=20, width=32, skips=(4, 9, 15), include_input=True),
    dict(depth=3, width=48, skips=(0, 1), include_input=True, in_dim=3, n_freqs=21),
    dict(depth=1, width=96, skips=(), in_dim=1, n_freqs=4),
    dict(depth=4, width=160, skips=(1,), in_dim=3, n_freqs=3),
], ids=["image2d", "depth20_three_skips", "two_skips_128_features", "depth1_in_dim1", "width160"])
def test_forward_images_and_smem_plan_match_the_pack(kw):
    """The forward call's weight images, as the pack kernel's index
    arithmetic writes them (``_pack_rendering``), are
    ``fused_train._wgmma_image`` of every trunk layer in order (a skip
    layer's encoding and h columns padded apart); read back through
    WGMMA_K_ORDER, each segment's hi and lo halves are the TF32 split of
    its ``nn.Linear`` weight columns transposed, zero past them. The
    segment table walks layer 0's encoding, then per layer the encoding at
    a skip and its h; the offsets advance 16·W floats a k-step; the
    shared-memory plan (4 stages of 16·W floats, the 128 x (W + 8)
    activation tile, 8 mbarriers, 2 x 128 x 4 floats of coordinates and
    output staging) fits a block at every width."""
    tm = _image_model(**kw)
    mlp, enc = tm.coarse, tm.pos_enc
    cfg = mlp.cfg
    W, P = cfg.net_width, enc.out_dim
    segs = tfi.fwd_segments(mlp, enc)
    want_segs = [(0, 0, P, P)]
    for j in range(1, cfg.net_depth):
        want_segs += ([(j, 0, P + W, P), (j, P, P + W, W)] if (j - 1) in cfg.skips
                      else [(j, 0, W, W)])
    assert segs == want_segs
    offs = tfi.fwd_image_offsets(segs, W)
    assert offs == [0] + list(np.cumsum([16 * W * -(-k // 8) for *_, k in segs]))
    img = _pack_rendering(mlp, enc)
    assert img.numel() == offs[-1]
    layers = [tft._wgmma_image(lin.weight.detach(), [P] if j == 0 else
                               ([P, W] if (j - 1) in cfg.skips else [W]))
              for j, lin in enumerate(mlp.pos_linears)]
    torch.testing.assert_close(img, torch.cat(layers), rtol=0, atol=0)
    w = [lin.weight.detach() for _, lin in mlp.linears()]
    for (lin, first, _, cols), a, b in zip(segs, offs, offs[1:]):
        steps = (b - a) // (16 * W)
        x = img[a:b].reshape(steps, 2, 2, W // 8, 8, 4)
        # [step][hi/lo][K half][N/8][8 of N][4 of K] -> [hi/lo][step][K position][N]
        x = x.permute(1, 0, 2, 5, 3, 4).reshape(2, steps, 8, W)[:, :, _K_INV].reshape(2, -1, W)
        bt = w[lin][:, first : first + cols].t()
        bt = torch.nn.functional.pad(bt, (0, 0, 0, 8 * steps - cols))
        hi = _tf32(bt)
        torch.testing.assert_close(x[0], hi, rtol=0, atol=0)
        torch.testing.assert_close(x[1], _tf32(bt - hi), rtol=0, atol=0)
        assert float((x[0] + x[1] - bt).abs().max()) <= 2.0**-21 * float(bt.abs().max())
    for width in range(32, 257, 16):
        smem = tfi.fwd_smem_bytes(width)
        assert smem == 4 * 4 * 16 * width + 4 * 128 * (width + 8) + 8 * 8 + 2 * 4 * 128 * 4
        assert smem <= 232448, (width, smem)


@pytest.mark.parametrize("fused", [True, False], ids=["fused_route", "standard_route"])
def test_image_train_steps_match_jax(fused):
    """Three steps of ``make_image_train_step`` in both packages (a 4-layer
    64-wide MLP with its skip, 64 pixels a step of a 16 x 16 image, lr 1e-3,
    b2 0.99), JAX's pixel indices injected into the port."""
    import jax
    import jax.numpy as jnp

    from nerf_meets_mlx_torch.engine import TrainState, make_image_train_step as t_step
    from nerf_meets_mlx_tpu.engine.train_state import create_train_state
    from nerf_meets_mlx_tpu.engine.trainer import make_image_train_step as j_step

    jc, jm, params, tm = _pair(seed=2, depth=4, width=64, skips=(2,), n_rand=64, fused=fused)
    img = timg.make_test_image(16)
    coords, colors = timg.pixel_dataset(img)
    jstep = j_step(jm)
    jstate = create_train_state(params, jc.train)
    tstate = TrainState(tm, tm.cfg.train)
    tstep = t_step(tm)
    key = jax.random.PRNGKey(4)
    grads = []
    apply = tstate.apply_gradients

    def record_then_apply():
        grads.append([p.grad.detach().clone() for p in tm.coarse.parameters()])
        apply()

    tstate.apply_gradients = record_then_apply
    mu_prev, j_grads = None, []
    for k in range(3):
        idx = jax.random.randint(jax.random.fold_in(key, k), (64,), 0, coords.shape[0])
        jstate, aux_j = jstep(jstate, jnp.asarray(coords), jnp.asarray(colors), key)
        aux_t = tstep(tstate, torch.from_numpy(coords), torch.from_numpy(colors), None,
                      {"idx": torch.from_numpy(np.asarray(idx).astype(np.int64))})
        for name in ("loss", "psnr"):
            np.testing.assert_allclose(float(aux_t[name]), float(aux_j[name]), rtol=5e-4,
                                       err_msg=name)
        # this step's gradient from Adam's first moment (b1 = 0.9)
        mu = _jax_grads(_adam_mu(jstate.opt_state)["coarse"])
        prev = mu_prev if mu_prev is not None else [np.zeros_like(m) for m in mu]
        j_grads.append([(m - 0.9 * p) / 0.1 for m, p in zip(mu, prev)])
        mu_prev = mu
    assert tstate.step == 3 == int(jstate.step)
    lr = jc.train.lrate
    want_p = _jax_grads(jstate.params["coarse"])
    got_p = [p.detach() for _, lin in tm.coarse.linears() for p in (lin.weight.t(), lin.bias)]
    for i in range(len(got_p)):
        a, b = got_p[i].numpy(), want_p[i]
        settled = np.ones(b.shape, bool)
        for gt, gj in zip(grads, j_grads):
            g_t = gt[i].t().numpy() if gt[i].ndim == 2 else gt[i].numpy()
            settled &= np.abs(g_t - gj[i]) <= 0.25 * np.abs(gj[i])
        np.testing.assert_allclose(a[settled], b[settled], rtol=5e-3, atol=1e-4)
        assert np.all(np.abs(a - b)[~settled] <= 2.0 * 3 * lr + 1e-4)


def _adam_mu(opt_state):
    """Adam's first moment in an optax state (plain adam, or a chain)."""
    if hasattr(opt_state, "mu"):
        return opt_state.mu
    for sub in opt_state:
        if isinstance(sub, tuple) or hasattr(sub, "mu"):
            mu = _adam_mu(sub)
            if mu is not None:
                return mu
    return None


def test_image_learning_on_cpu(tmp_path):
    from nerf_meets_mlx_torch.entrypoints import image_learning

    out = image_learning(size=16, max_iters=12, log_dir=str(tmp_path), frame_every=5,
                         device="cpu")
    assert out["steps"] == 12 and np.isfinite(out["final_psnr"])
    frames = np.load(tmp_path / "progress_frames.npy")
    assert frames.shape == (3, 16, 16, 3) and frames.dtype == np.uint8
    assert np.load(tmp_path / "final.npy").shape == (16, 16, 3)
    with pytest.raises(NotImplementedError, match="viewer"):
        image_learning(size=8, max_iters=1, viewer_port=8080, device="cpu")


def test_image_cli_on_cpu(tmp_path, capsys):
    from nerf_meets_mlx_torch.__main__ import main

    main(["image", "--size", "8", "--max-iters", "3", "--log-dir", str(tmp_path),
          "--device", "cpu"])
    assert "'steps': 3" in capsys.readouterr().out
    assert (tmp_path / "final.npy").exists() and (tmp_path / "metrics.jsonl").exists()


def test_image_wrappers_route_by_device():
    tm = t_create(t_image2d(), device="cpu").init(torch.Generator().manual_seed(0))
    x, y = (torch.from_numpy(a) for a in _data(8))
    with pytest.raises(ValueError):
        tfi.fused_image_apply(tm.coarse, tm.pos_enc, x.to("meta"))
    with pytest.raises(ValueError):
        tfi.fused_image_train(tm.coarse, tm.pos_enc, x.to("meta"), y.to("meta"))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4096, 4001, 160_000])
def test_cuda_image_kernels_match_plain(n):
    """Both kernels at image2d's width and depth on the card: the forward at
    rtol 1e-4 / atol 1e-4 (fp32 sums in another order than cuBLAS's), sse
    at rtol 1e-4, every dW and db within 1e-3 of its array's largest plain
    value; a pixel count that is not a multiple of the train kernel's
    32-point tile or the forward's 128 (4001), and a 400 x 400 frame
    (160,000, the forward alone)."""
    _check_cuda_image_kernels(n, None)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [64, 32, 96, 48])
def test_cuda_image_kernels_match_plain_at_narrow_widths(width):
    """As test_cuda_image_kernels_match_plain at widths 64, 32, 96 and 48
    (builds of their own), 4001 pixels."""
    _check_cuda_image_kernels(4001, width)


@pytest.mark.gpu
@pytest.mark.parametrize("depth,width,skips,include_input", [
    (20, 64, (4,), False), (8, 256, (2, 5), True),
], ids=["depth20", "two_skips_raw_input"])
def test_cuda_image_kernels_match_plain_past_image2d(depth, width, skips, include_input):
    """Shapes past image2d's: depth 20 (the kernels' deepest), and two
    skips with the raw input in the encoding (42 features, which the train
    kernel copies in 4-byte pieces), 4001 pixels."""
    _check_cuda_image_kernels(4001, width, depth, skips, include_input)


@pytest.mark.gpu
def test_cuda_image_train_is_deterministic():
    """Two train launches on the same inputs give bit-identical sse and
    gradients: no atomics, every sum in a fixed order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    tm = t_create(t_image2d(), device=dev).init(torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.rand((4096, 2), generator=g, device=dev)
    y = torch.rand((4096, 3), generator=g, device=dev)
    params = [p for _, lin in tm.coarse.linears() for p in (lin.weight, lin.bias)]
    runs = []
    for _ in range(2):
        sse = tfi.fused_image_train(tm.coarse, tm.pos_enc, x, y)
        runs.append((sse.detach(), torch.autograd.grad(sse, params)))
    torch.cuda.synchronize()
    (sse_a, g_a), (sse_b, g_b) = runs
    assert torch.equal(sse_a, sse_b)
    assert all(torch.equal(a, b) for a, b in zip(g_a, g_b))


# the forward kernel's cases on the card: image2d at a whole number of its
# 128-pixel tiles, a ragged count and a 400 x 400 frame; the narrow widths
# (builds of their own); depth 20; two skips with the raw input
FWD_CASES = [
    (4096, {}), (4001, {}), (160_000, {}), (4001, dict(width=64)), (4001, dict(width=32)),
    (4001, dict(width=96)), (4001, dict(width=48)), (4001, dict(depth=20, width=64)),
    (4001, dict(skips=(2, 5), include_input=True)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("n,kw", FWD_CASES, ids=[
    "4096", "4001", "160000", "width64", "width32", "width96", "width48", "depth20",
    "two_skips_raw_input"])
def test_cuda_image_fwd_runs_three_tf32_passes(n, kw):
    """The forward kernel (csrc/image_fwd_tc.cu) lies within IMAGE_TIGHT
    (atol = rtol) of the fp32 plain version, and the same source built with
    one TF32 product in place of three (``IMAGE_FWD_ONE_PASS``: hi·hi alone)
    lies outside it; both errors are printed. A call after the first of its
    shape counts one launch and allocates only its output; two calls give
    bit-identical output; the weight images the pack launch wrote are
    ``_pack_rendering``'s bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    from nerf_meets_mlx_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    tm = _image_model(device="cuda", **kw)
    mlp, enc = tm.coarse, tm.pos_enc
    x = torch.rand((n, 2), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    one_pass = tfi.type_fwd_lib(_build.load_library(
        tfi.FWD_SOURCE, {**(tft.width_defines(mlp.cfg.net_width) or {}), "IMAGE_FWD_ONE_PASS": 1}))
    with torch.no_grad():
        tfi.fused_image_apply(mlp, enc, x)  # the shape's first call makes its plan
        torch.cuda.synchronize()
        n0 = LAUNCHES["image_fwd"]
        allocs0 = torch.cuda.memory_stats()["allocation.all.allocated"]
        three = tfi.fused_image_apply(mlp, enc, x)
        allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - allocs0
        again = tfi.fused_image_apply(mlp, enc, x)
        torch.cuda.synchronize()
        launches = LAUNCHES["image_fwd"] - n0
        one = tfi._fwd_launch(mlp, enc, x, lib=one_pass)
        torch.cuda.synchronize()
        want = tfi.fused_image_reference(mlp, enc, x)
    over = {"3xTF32": _over(three, want, IMAGE_TIGHT), "one pass": _over(one, want, IMAGE_TIGHT)}
    print(f"[tf32] image_fwd N={n} {kw}: " + ", ".join(
        f"{k} max abs {float((o - want).abs().max()):.3e} ({over[k]:.3f} of IMAGE_TIGHT)"
        for k, o in (("3xTF32", three), ("one pass", one))))
    assert launches == 2 and allocs == 1, (launches, allocs)
    assert torch.equal(three, again)
    torch.testing.assert_close(three, want, rtol=1e-4, atol=1e-4)
    assert over["3xTF32"] <= 1.0, over
    assert over["one pass"] > 1.0, over
    plan = tfi._fwd_plan(mlp, enc, x.device, torch.cuda.current_stream(dev).cuda_stream)
    assert torch.equal(plan.img, _pack_rendering(mlp, enc))

def _check_cuda_image_kernels(n, width, depth=None, skips=None, include_input=False):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    from nerf_meets_mlx_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = t_image2d()
    mlp = dataclasses.replace(cfg.mlp, net_width=width or cfg.mlp.net_width,
                              net_depth=depth or cfg.mlp.net_depth,
                              skips=cfg.mlp.skips if skips is None else skips)
    cfg = cfg.replace(mlp=mlp, pos_encoding=dataclasses.replace(
        cfg.pos_encoding, include_input=include_input))
    tm = t_create(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.rand((n, 2), generator=g, device=dev)
    y = torch.rand((n, 3), generator=g, device=dev)
    n0 = dict(LAUNCHES)
    out = tfi.fused_image_apply(tm.coarse, tm.pos_enc, x)
    torch.cuda.synchronize()
    with torch.no_grad():
        ref = tfi.fused_image_reference(tm.coarse, tm.pos_enc, x)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    assert LAUNCHES["image_fwd"] == n0["image_fwd"] + 1
    if n > 10_000:
        return
    params = [p for _, lin in tm.coarse.linears() for p in (lin.weight, lin.bias)]
    sse = tfi.fused_image_train(tm.coarse, tm.pos_enc, x, y)
    grads = torch.autograd.grad(sse, params)
    torch.cuda.synchronize()
    assert LAUNCHES["image_train"] == n0["image_train"] + 1
    # the train call ran csrc/image_train_tc.cu's build of the width
    source, defines = tfi.train_build(mlp.net_width)
    assert source == "image_train_tc"
    assert tfi._train_lib(mlp.net_width)._name == str(_build.library_path(source, defines))
    sse_p = torch.sum((tfi.fused_image_reference(tm.coarse, tm.pos_enc, x) - y) ** 2)
    grads_p = torch.autograd.grad(sse_p, params)
    torch.testing.assert_close(sse.detach(), sse_p.detach(), rtol=1e-4, atol=1e-4)
    for i, (a, b) in enumerate(zip(grads, grads_p)):
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        assert bool(torch.isfinite(a).all()) and err <= 1e-3 * scale, (i, err, scale)
