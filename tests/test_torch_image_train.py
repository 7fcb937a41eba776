"""The image train kernel's algorithm (csrc/image_train_tc.cu) on the CPU.

* Its arithmetic replayed in torch: the forward and cotangent products in
  3xTF32 with each k-step of 8 summed from zero and added in fp32 (the
  encoding's columns padded to 8 first at a skip layer, as the kernel walks
  them), the output head and its cotangent in fp32, dW = dZ^T X as the dW
  GEMM sums it (the points in splits, a 32-point slice's products in one
  accumulator, the slices and then the splits added in fp32 in order), the
  gradients written into the flat buffer the kernel writes and read back
  through the wrapper's views. Held against autograd through the plain
  version at the card's tolerances (sse atol 1e-4 + rtol 1e-4, every dW
  and db within 1e-3 of its array's largest plain value), at image2d's
  8 x 256 with its skip and at narrow widths; one TF32 pass misses them.
* The flat gradient buffer's layout against ``mlp.linears()``, and the
  build every width trains in.
"""

import dataclasses
import math

import pytest
import torch

from nerf_meets_mlx_torch.config import image2d
from nerf_meets_mlx_torch.kernels import fused_image as tfi
from nerf_meets_mlx_torch.kernels.fused_train import width_defines
from nerf_meets_mlx_torch.models import create_nerf
from tf32_products import _mm_3xtf32, _tf32, mm_ksteps
from torch_threads import one_torch_thread_per_worker  # noqa: F401  (autouse fixture)

TILE_POINTS = 32  # the tile kernel's points a block; the dW GEMM's slice
DW_BLOCKS = 4 * 132  # the dW GEMM's block count aimed at (csrc/image_train_tc.cu)


def _model(width=256, depth=8, skips=(4,), include_input=False, seed=3):
    cfg = image2d()
    cfg = cfg.replace(
        mlp=dataclasses.replace(cfg.mlp, net_width=width, net_depth=depth, skips=skips),
        pos_encoding=dataclasses.replace(cfg.pos_encoding, include_input=include_input),
    )
    return create_nerf(cfg, device="cpu").init(torch.Generator().manual_seed(seed))


def _data(n, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, 2), generator=g), torch.rand((n, 3), generator=g)


def _dw_splits(n, tiles):
    """(points a split) of the dW GEMM, as csrc/image_train_tc.cu's plan_of
    chooses it: about DW_BLOCKS blocks of (tile, split), a split a whole
    number of 32-point slices."""
    s = max(1, min(DW_BLOCKS // tiles, -(-n // TILE_POINTS)))
    return -(-(-(-n // s)) // TILE_POINTS) * TILE_POINTS


def _dw(dz, x, pts, passes):
    """dZ^T X as the dW GEMM sums it: splits of ``pts`` points in order,
    each a sum of 32-point slices, a slice's products in one accumulator."""
    out = torch.zeros((dz.shape[1], x.shape[1]))
    for p0 in range(0, dz.shape[0], pts):
        part = torch.zeros_like(out)
        for q0 in range(p0, min(p0 + pts, dz.shape[0]), TILE_POINTS):
            a, b = dz[q0:q0 + TILE_POINTS].t(), x[q0:q0 + TILE_POINTS]
            part = part + (_mm_3xtf32(a, b) if passes == 3 else _tf32(a) @ _tf32(b))
        out = out + part
    return out


def _emulate(mlp, enc, x, y, passes=3):
    """(sse, the flat gradient buffer) as the kernels compute them."""
    cfg = mlp.cfg
    D, W = cfg.net_depth, cfg.net_width
    lins = [lin for _, lin in mlp.linears()]
    with torch.no_grad():
        e = enc.apply(x)
        E = e.shape[1]
        e8 = torch.nn.functional.pad(e, (0, -E % 8))  # the encoding's columns padded to 8
        xs, hs, h = [], [], None
        for j in range(D):
            lin = lins[j]
            if j == 0:
                X, Wt = e8, torch.nn.functional.pad(lin.weight, (0, -E % 8))
                xs.append(e8)
            elif (j - 1) in cfg.skips:
                X = torch.cat([e8, h], -1)
                Wt = torch.cat([torch.nn.functional.pad(lin.weight[:, :E], (0, -E % 8)),
                                lin.weight[:, E:]], -1)
                xs.append(X)
            else:
                X, Wt = h, lin.weight
                xs.append(h)
            h = torch.relu(mm_ksteps(X, Wt.t(), passes) + lin.bias)
            hs.append(h)
        head = lins[D]
        out = h @ head.weight.t() + head.bias
        dout = 2.0 * (out - y)
        sse = torch.sum((0.5 * dout) ** 2)
        dzs = [None] * D
        dzs[D - 1] = (dout @ head.weight) * (hs[D - 1] > 0)
        for j in range(D - 1, 0, -1):
            wh = lins[j].weight[:, E:] if (j - 1) in cfg.skips else lins[j].weight
            dzs[j - 1] = mm_ksteps(dzs[j], wh, passes) * (hs[j - 1] > 0)

        # the dW GEMM, into the flat buffer at the kernel's offsets: every
        # weight [fan_out][fan_in] then its bias, in mlp.linears() order
        tiles = 0
        for j, lin in enumerate(lins):
            rows = -(-lin.out_features // 128)
            if j == D:
                tiles += -(-W // 128)
            elif j > 0 and (j - 1) in cfg.skips:
                tiles += rows * (-(-E // 128) + -(-W // 128))
            else:
                tiles += rows * -(-lin.in_features // 128)
        pts = _dw_splits(x.shape[0], tiles)
        flat = []
        for j, lin in enumerate(lins):
            if j == D:
                dw, db = dout.t() @ hs[D - 1], dout.sum(0)
            else:
                dw = _dw(dzs[j], xs[j], pts, passes)
                if j == 0:
                    dw = dw[:, :E]
                elif (j - 1) in cfg.skips:
                    dw = torch.cat([dw[:, :E], dw[:, -(-E // 8) * 8:]], -1)
                db = dzs[j].sum(0)
            flat += [dw.reshape(-1), db]
        return sse, torch.cat(flat)


def _plain(mlp, enc, x, y):
    params = [p for _, lin in mlp.linears() for p in (lin.weight, lin.bias)]
    sse = torch.sum((tfi.fused_image_reference(mlp, enc, x) - y) ** 2)
    return sse.detach(), torch.autograd.grad(sse, params)


def _errors(mlp, enc, x, y, passes):
    """(sse error over its tolerance, worst dW error over its array's
    largest plain value) of the emulation, its gradients read back through
    the wrapper's views of the flat buffer."""
    sse_p, g_p = _plain(mlp, enc, x, y)
    sse_e, flat = _emulate(mlp, enc, x, y, passes)
    layout = tfi.grad_layout(mlp)
    assert flat.numel() == layout[-1][0] + math.prod(layout[-1][1])
    g_e = [flat[o:o + math.prod(shape)].view(shape) for o, shape in layout]
    val = float((sse_e - sse_p).abs() / (1e-4 + 1e-4 * sse_p.abs()))
    ratios = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(g_e, g_p)]
    return val, max(ratios)


@pytest.mark.parametrize("kw,n", [
    (dict(), 130),
    (dict(width=48, depth=3, skips=(1,), include_input=True), 150),
    (dict(width=32, depth=4, skips=(0, 2)), 100),
], ids=["image2d", "width48_raw_input", "width32_two_skips"])
def test_kernel_algorithm_holds_the_card_tolerances(kw, n):
    """The kernels' 3xTF32 arithmetic and dW split order against autograd
    at the card's tolerances; one TF32 pass misses them."""
    m = _model(**kw)
    x, y = _data(n)
    val3, grad3 = _errors(m.coarse, m.pos_enc, x, y, passes=3)
    assert val3 <= 1.0 and grad3 <= 1e-3, (val3, grad3)
    val1, grad1 = _errors(m.coarse, m.pos_enc, x, y, passes=1)
    assert val1 > 1.0 or grad1 > 1e-3, (val1, grad1)
    assert val1 > val3 and grad1 > grad3


def test_grad_layout_is_linears_in_order():
    """The flat gradient buffer: each parameter of ``mlp.linears()`` in
    order, the weights as ``nn.Linear`` holds them ([fan_out, fan_in]),
    back to back, so that the autograd gradients concatenated in that order
    read back through the layout's views as themselves."""
    m = _model()
    x, y = _data(64)
    _, grads = _plain(m.coarse, m.pos_enc, x, y)
    params = [p for _, lin in m.coarse.linears() for p in (lin.weight, lin.bias)]
    layout = tfi.grad_layout(m.coarse)
    assert [shape for _, shape in layout] == [tuple(p.shape) for p in params]
    assert [o for o, _ in layout] == [sum(p.numel() for p in params[:i])
                                      for i in range(len(params))]
    flat = torch.cat([g.reshape(-1) for g in grads])
    for (o, shape), g in zip(layout, grads):
        assert torch.equal(flat[o:o + math.prod(shape)].view(shape), g)


def test_every_width_trains_in_the_tensor_core_build():
    """No router: every width the image kernels take trains in
    csrc/image_train_tc.cu, the default widths in one build, the others in
    a -DKW build each."""
    for width in range(32, 257, 16):
        assert tfi.train_build(width) == ("image_train_tc", width_defines(width))
