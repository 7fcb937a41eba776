"""The port's 2-D image task: ``datasets/image.py``,
``kernels/fused_image.py`` (csrc/image_train_tc.cu, csrc/fused_image.cu),
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
* ``image_learning(device="cpu")`` and the ``image`` command.
* ``gpu``-marked: both CUDA kernels against the plain version on the card,
  the train call in the build ``fused_image.train_build`` names
  (csrc/image_train_tc.cu), at image2d's shape, at narrow widths, at depth
  20 and with two skips and the raw input; two train launches give
  bit-identical sse and gradients (skipped where no card is present).
"""

import dataclasses

import numpy as np
import pytest
import torch

from nerf_meets_mlx_torch import interop
from nerf_meets_mlx_torch.config import image2d as t_image2d
from nerf_meets_mlx_torch.datasets import image as timg
from nerf_meets_mlx_torch.kernels import fused_image as tfi
from nerf_meets_mlx_torch.kernels.fused_train import LAUNCHES
from nerf_meets_mlx_torch.models import create_nerf as t_create
from torch_threads import one_torch_thread_per_worker  # noqa: F401  (autouse fixture)

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


def test_pack_image_weights_layout():
    """The forward kernel's pieces: every weight as [fan_in, fan_out] and
    its bias, then the bands at 2·D + 2 (the train kernel reads the
    parameters where the modules hold them, and packs nothing)."""
    tm = t_create(t_image2d(), device="cpu").init(torch.Generator().manual_seed(0))
    mlp, enc = tm.coarse, tm.pos_enc
    wbuf, offs = tfi.pack_image_weights(mlp, enc)
    D = mlp.cfg.net_depth
    assert len(offs) == 2 * D + 3 and all(o % 4 == 0 for o in offs)
    for i, (_, lin) in enumerate(mlp.linears()):
        fi, fo = lin.in_features, lin.out_features
        torch.testing.assert_close(wbuf[offs[2 * i] : offs[2 * i] + fi * fo].view(fi, fo),
                                   lin.weight.detach().t(), rtol=0, atol=0)
        torch.testing.assert_close(wbuf[offs[2 * i + 1] : offs[2 * i + 1] + fo],
                                   lin.bias.detach(), rtol=0, atol=0)
    torch.testing.assert_close(wbuf[offs[2 * D + 2] : offs[2 * D + 2] + enc.n_freqs],
                               enc.bands(), rtol=0, atol=0)
    assert wbuf.numel() >= offs[2 * D + 2] + enc.n_freqs


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
    32-point tile or the forward's 64 (4001), and a 400 x 400 frame
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
