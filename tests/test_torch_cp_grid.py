"""The port's CP-grid encoding (encoding/cp_grid.py) and the lego_cp slice.

* ``CPGridEncoding.apply`` against JAX's XLA ``apply`` on the same lines
  (via ``interop``), in fp32 and bf16 compute: features at rtol 1e-5 /
  atol 1e-6; line gradients at rtol 1e-3 / atol 2e-5 in fp32 (as
  tests/test_cp_encode.py:59) and, in bf16, within one bf16 ulp (rtol
  8e-3, atol 2e-5), since both packages round the summed dLines to bf16
  once and sum in another order before.
* The numpy gather reference and the grid-node and continuity cases of
  tests/test_cp_grid.py; ``make_encoding``'s branch; the init's scale.
* The lines through ``interop``, the checkpoint (with the Adam moments)
  and the encoding weight decay, with levels of different lengths.
* One lego_cp train step (cut to 2 levels, C = 8, 8 + 8 samples) against
  JAX's ``make_nerf_train_step`` with JAX's draws injected; ``train_nerf``
  + resume + ``render_only``; the ``train`` CLI.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import _steps_match_jax

from nerf_meets_mlx_torch import interop
from nerf_meets_mlx_torch.__main__ import main as t_main
from nerf_meets_mlx_torch.config import EncodingConfig
from nerf_meets_mlx_torch.config import lego_cp as t_cp
from nerf_meets_mlx_torch.encoding import make_encoding
from nerf_meets_mlx_torch.encoding.cp_grid import CPGridEncoding
from nerf_meets_mlx_torch.engine import checkpoint as tckpt
from nerf_meets_mlx_torch.engine import train_state as tts
from nerf_meets_mlx_torch.entrypoints import render_only, train_nerf
from nerf_meets_mlx_torch.models import create_nerf as t_create
from nerf_meets_mlx_tpu.config import lego_cp as j_cp
from nerf_meets_mlx_tpu.encoding.cp_grid import CPGridEncoding as JCP
from nerf_meets_mlx_tpu.models import create_nerf as j_create
from torch_threads import one_torch_thread_per_worker  # noqa: F401  (autouse fixture)

SMALL = dict(n_levels=3, min_res=8, max_res=40, n_components=16)


def _pair(dtype="bfloat16", seed=0, **kw):
    """(port encoding, JAX encoding, JAX params) on JAX's init lines."""
    kw = dict(SMALL, compute_dtype=dtype, **kw)
    jenc, tenc = JCP(**kw), CPGridEncoding(**kw)
    params = jenc.init_params(jax.random.PRNGKey(seed))
    with torch.no_grad():
        for dst, src in zip(tenc.lines, params["lines"]):
            dst.copy_(torch.from_numpy(np.asarray(src)))
    return tenc, jenc, params


def _points(n, seed=1, lim=1.6):
    # some points outside the box: the clip is part of the function
    return np.random.default_rng(seed).uniform(-lim, lim, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cp_apply_matches_jax_xla(dtype):
    tenc, jenc, params = _pair(dtype)
    assert tuple(tenc.resolutions) == tuple(jenc.resolutions) == (8, 17, 40)
    x = _points(300).reshape(3, 100, 3)
    co = np.random.default_rng(2).normal(size=(3, 100, tenc.out_dim)).astype(np.float32)
    feats = tenc.apply(torch.from_numpy(x))
    assert feats.shape == (3, 100, 48)
    want = np.asarray(jenc.apply(params, jnp.asarray(x)))
    np.testing.assert_allclose(feats.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    grads = torch.autograd.grad((feats * torch.from_numpy(co)).sum(), list(tenc.lines))
    g_j = jax.grad(lambda p: jnp.sum(jenc.apply(p, jnp.asarray(x)) * co))(params)["lines"]
    bounds = dict(rtol=1e-3, atol=2e-5) if dtype == "float32" else dict(rtol=8e-3, atol=2e-5)
    for a, b in zip(grads, g_j):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **bounds)


def _numpy_reference(enc, x):
    """Direct gather + lerp transcription of the CP feature definition
    (tests/test_cp_grid.py)."""
    u = np.clip((x - enc.bbox_min) / (enc.bbox_max - enc.bbox_min), 0, 1)
    outs = []
    for r, lines in zip(enc.resolutions, enc.lines):
        r = int(r)
        lines = lines.detach().numpy()
        t = u * (r - 1)
        i0 = np.clip(np.floor(t).astype(int), 0, r - 2)
        f = t - i0
        level = np.ones((x.shape[0], enc.n_components), np.float32)
        for a in range(3):
            v = lines[a][i0[:, a]] * (1 - f[:, a:a + 1]) + lines[a][i0[:, a] + 1] * f[:, a:a + 1]
            level = level * v
        outs.append(level)
    return np.concatenate(outs, axis=-1)


def _small_fp32(**kw):
    enc = CPGridEncoding(**dict(dict(n_levels=2, min_res=8, max_res=16, n_components=4,
                                     bbox_min=-1.0, bbox_max=1.0, compute_dtype="float32"), **kw))
    return enc.init(torch.Generator().manual_seed(0))


def test_cp_apply_matches_gather_reference():
    enc = _small_fp32()
    x = np.random.default_rng(1).uniform(-1.0, 1.0, (64, 3)).astype(np.float32)
    got = enc.apply(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, _numpy_reference(enc, x), rtol=1e-5, atol=1e-6)


def test_cp_exact_at_grid_nodes():
    """At a grid node the hat weight is 1 there and 0 elsewhere."""
    enc = _small_fp32(n_levels=1, min_res=8, max_res=8)
    lines = enc.lines[0].detach()
    w = -1.0 + 2.0 * 3.0 / 7.0  # node 3 of 8 along each axis
    got = enc.apply(torch.tensor([[w, w, w]])).detach()[0]
    torch.testing.assert_close(got, lines[0, 3] * lines[1, 3] * lines[2, 3], rtol=1e-4,
                               atol=1e-6)


def test_cp_continuity_across_cells():
    enc = _small_fp32(n_levels=1, min_res=16, max_res=16)
    a = enc.apply(torch.tensor([[-1e-4, 0.1, 0.2]]))
    b = enc.apply(torch.tensor([[1e-4, 0.1, 0.2]]))
    torch.testing.assert_close(a, b, rtol=0, atol=1e-2)


def test_cp_out_dim_dispatch_and_init():
    """make_encoding's cp_grid branch (bf16 compute, as JAX's, which does not
    pass compute_dtype), leading dimensions, and init_scale · N(0, 1)."""
    cfg = EncodingConfig(kind="cp_grid", cp_n_levels=3, cp_n_components=8)
    enc = make_encoding(cfg)
    assert cfg.out_dim == enc.out_dim == 24 and enc.compute_dtype == "bfloat16"
    assert [tuple(p.shape) for p in enc.lines] == [(3, 64, 8), (3, 181, 8), (3, 512, 8)]
    enc.init(torch.Generator().manual_seed(0))
    flat = torch.cat([p.detach().reshape(-1) for p in enc.lines])
    assert abs(float(flat.std()) - 0.2) < 0.01 and abs(float(flat.mean())) < 0.01
    assert enc.apply(torch.zeros((5, 2, 3))).shape == (5, 2, 24)
    with pytest.raises(ValueError):
        CPGridEncoding(n_levels=2, min_res=1, max_res=1)


def test_cp_lines_cross_interop_checkpoint_and_decay(tmp_path):
    """The per-level lines (64, 128, 256, 512 nodes: ragged) are separate
    parameters: in parameters(), state_dict() and the encoding weight decay's
    mask; they cross to and from the JAX pytree as {"lines": [...]}, and the
    checkpoint keeps them with their Adam moments."""
    tm = t_create(t_cp(), device="cpu")
    assert [tuple(p.shape) for p in tm.pos_enc.lines] == [
        (3, 64, 16), (3, 128, 16), (3, 256, 16), (3, 512, 16)]
    sd = tm.state_dict()
    assert all(f"pos_enc.lines.{i}" in sd for i in range(4))
    params = j_create(j_cp()).init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    interop.params_from_numpy(tree, tm)
    back = interop.params_to_numpy(tm)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    bad = dict(tree, pos_enc={"lines": [tree["pos_enc"]["lines"][0]] * 4})
    with pytest.raises(ValueError, match="CP level 1"):
        interop.params_from_numpy(bad, tm)
    with pytest.raises(ValueError, match="CP levels"):
        interop.params_from_numpy(dict(tree, pos_enc={"lines": tree["pos_enc"]["lines"][:2]}),
                                  tm)

    cfg = dataclasses.replace(t_cp().train, encoding_weight_decay=1e-3)
    state = tts.TrainState(tm, cfg)
    assert len(state.decayed) == 4
    before = [p.detach().clone() for p in tm.pos_enc.lines]
    for p in tm.parameters():
        p.grad = torch.zeros_like(p)
    state.apply_gradients()  # a zero gradient: Adam moves nothing, the decay does
    for p, b in zip(tm.pos_enc.lines, before):
        torch.testing.assert_close(p.detach(), b - 1e-3 * b, rtol=0, atol=0)
    tckpt.save_checkpoint(tmp_path, tm, 1, optimizer=state.optimizer)
    tm2 = t_create(t_cp(), device="cpu")
    st2 = tts.TrainState(tm2, cfg)
    assert tckpt.restore_checkpoint(tmp_path, tm2, 1, optimizer=st2.optimizer) == 1
    for a, b in zip(tm2.pos_enc.lines, tm.pos_enc.lines):
        assert torch.equal(a, b)
    shapes = sorted(tuple(s["exp_avg"].shape) for s in st2.optimizer.state_dict()["state"].values())
    assert shapes.count((3, 512, 16)) == 1 and shapes.count((3, 64, 16)) == 1


def _tiny(make):
    """lego_cp at its MLPs, lr, Adam b2 and bf16 CP compute, the grid cut to
    2 levels of 8..32 nodes and 8 components, 32 rays of 16 x 16 images, 8
    + 8 samples, density noise on."""
    cfg = make()
    return cfg.replace(
        pos_encoding=dataclasses.replace(cfg.pos_encoding, cp_n_levels=2, cp_min_res=8,
                                         cp_max_res=32, cp_n_components=8),
        train=dataclasses.replace(cfg.train, n_rand=32, precrop_iters=1),
        render=dataclasses.replace(cfg.render, n_samples=8, n_importance=8, raw_noise_std=0.5),
    )


@pytest.mark.parametrize("fused", [False, True], ids=["standard", "use_fused_kernel"])
def test_lego_cp_train_step_matches_jax(fused):
    """One lego_cp step from the same weights, lines and draws, with the
    fused kernels off and on: lego_cp takes the standard route in both
    packages either way (no fused mode, the XLA / plain CP encode).
    Losses, gradients and the parameters and lines after Adam, as
    test_torch_train's ``_steps_match_jax`` holds them."""
    jc = _tiny(j_cp).replace(use_fused_kernel=fused)
    tc = _tiny(t_cp).replace(use_fused_kernel=fused)
    tm, _ = _steps_match_jax(jc, tc, 1, key=5)
    assert tm._fused_train_mode is None and not tm._use_hash_kernel()


def _overlay(tmp_path):
    p = tmp_path / "tiny_cp.txt"
    p.write_text(
        "N_samples = 8\nN_importance = 8\nN_rand = 32\ni_print = 1\nsynth_n_train = 2\n"
        "i_testset = 2\n"
    )
    return str(p)


def test_train_nerf_lego_cp_resume_then_render_only(tmp_path):
    """train_nerf(preset="lego_cp") on the CPU: the checkpoint holds the four
    levels' lines and their Adam moments, a second call resumes from them,
    and render_only serves the result."""
    log_dir = tmp_path / "run"
    kw = dict(preset="lego_cp", config_txt=_overlay(tmp_path), synth_resolution=12,
              precrop_iters=0, render_video=False, device="cpu", log_dir=str(log_dir))
    res = train_nerf(max_iters=2, **kw)
    assert res["step"] == 2 and np.isfinite(res["loss"]) and np.isfinite(res["test_psnr_mean"])
    state = torch.load(log_dir / "ckpt" / "step_00000002" / "state.pt", weights_only=True)
    assert tuple(state["params"]["pos_enc.lines.3"].shape) == (3, 512, 16)
    moments = [s for s in state["optimizer"]["state"].values()
               if tuple(s["exp_avg"].shape) == (3, 512, 16)]
    assert len(moments) == 1 and int(moments[0]["step"]) == 2
    res = train_nerf(max_iters=3, **kw)
    assert res["step"] == 3
    later = torch.load(log_dir / "ckpt" / "step_00000003" / "state.pt", weights_only=True)
    assert not torch.equal(later["params"]["pos_enc.lines.0"], state["params"]["pos_enc.lines.0"])
    served = render_only(preset="lego_cp", log_dir=str(log_dir), device="cpu",
                         synth_resolution=12, n_orbit=1)
    assert served["step"] == 3
    frames = np.load(served["frames"])
    assert frames.shape == (1, 12, 12, 3) and frames.dtype == np.uint8


def test_train_cli_lego_cp(tmp_path, capsys):
    log_dir = tmp_path / "cli"
    t_main([
        "train", "--preset", "lego_cp", "--device", "cpu", "--config-txt", _overlay(tmp_path),
        "--max-iters", "2", "--synth-resolution", "12", "--precrop-iters", "0",
        "--log-dir", str(log_dir), "--no-video",
    ])
    assert "test_ssim_mean" in capsys.readouterr().out
    assert tckpt.latest_step(log_dir / "ckpt") == 2
