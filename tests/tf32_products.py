"""The tensor-core products of the port's 3xTF32 kernels, emulated in
torch on the CPU for the tests: TF32 rounding as ``split_tf32`` rounds
(``nerf_meets_mlx_torch.kernels.fused_train._tf32``), a 3xTF32 product
summed in one fp32 accumulator, the same with each k-step of 8 summed from
zero and added in fp32 (the order csrc/fused_train.cu and
csrc/image_train_tc.cu use), a whole layer in one accumulator that rounds
toward zero as the tensor cores add (the wgmma kernels' form,
csrc/fused_eval.cu and csrc/ingp_eval_tc.cu), the same restarted every few
k-steps and added in fp32 (csrc/mlp_bwd_tc.cu), and one TF32 pass, the
lower-precision control."""

import torch

from nerf_meets_mlx_torch.kernels.fused_train import _tf32

__all__ = ["_tf32", "_trunc32", "_split", "_mm_3xtf32", "_mm_1xtf32", "mm_ksteps", "mm_wgmma",
           "mm_wgmma_runs"]


def _trunc32(x64):
    """float64 values to float32, rounded toward zero, as the tensor cores
    round their adds: the nearest float32, one step back toward zero where
    it lies past the value (a step of its magnitude bits, either sign)."""
    y = x64.to(torch.float32)
    over = (y.double().abs() > x64.abs()).to(torch.int32)
    return (y.view(torch.int32) - over).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm_3xtf32(a, b):
    """The kernel's 3xTF32 product: a = ah + al, b = bh + bl, each half
    TF32, and al·bh + ah·bl + ah·bh summed in one fp32 accumulator (one
    product over the three terms stacked along k)."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return torch.cat([al, ah, ah], -1) @ torch.cat([bh, bl, bh], 0)


def _mm_1xtf32(a, b):
    """One TF32 pass: both operands rounded to TF32, fp32 accumulator."""
    return _tf32(a) @ _tf32(b)


def mm_ksteps(a, b, passes=3):
    """a [M, K] @ b [K, N] as the kernels' forward and cotangent products
    run on mma.sync m16n8k8: K in steps of 8 (zero-padded), each step's
    products (3xTF32: lo·hi, hi·lo, then hi·hi; ``passes=1``: hi·hi alone)
    summed from zero, then added to the sum in fp32, step after step."""
    K = a.shape[1]
    a = torch.nn.functional.pad(a, (0, -K % 8))
    b = torch.nn.functional.pad(b, (0, 0, 0, -K % 8))
    ah, al = _split(a)
    bh, bl = _split(b)
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        if passes == 3:
            t = al[:, s] @ bh[s]
            t = t + ah[:, s] @ bl[s]
            t = t + ah[:, s] @ bh[s]
        else:
            t = ah[:, s] @ bh[s]
        out = out + t
    return out


def mm_wgmma(a, b, passes=3):
    """a [M, K] @ b [K, N] as the wgmma kernels sum a layer: both operands
    split into TF32 halves, K in steps of 8 (zero-padded), each step's
    lo·hi, hi·lo and hi·hi (``passes=1``: hi·hi alone) summed exactly over
    its 8 products and added, in that order, to one accumulator that
    starts from zero and rounds each add toward zero."""
    K = a.shape[1]
    a = torch.nn.functional.pad(a, (0, -K % 8))
    b = torch.nn.functional.pad(b, (0, 0, 0, -K % 8))
    ah, al = _split(a)
    bh, bl = _split(b)
    pairs = ((al, bh), (ah, bl), (ah, bh)) if passes == 3 else ((ah, bh),)
    steps = a.shape[1] // 8
    # every k-step's exact sums at once ([step, row, column], float64), then
    # the accumulator's truncating adds in the kernels' order
    sums = [torch.einsum("psk,skn->spn", x.double().reshape(-1, steps, 8),
                         y.double().reshape(steps, 8, -1)) for x, y in pairs]
    acc = torch.zeros(sums[0].shape[1:], dtype=torch.float64)
    for s in range(steps):
        for part in sums:
            acc = _trunc32(acc + part[s]).double()
    return acc.float()


def mm_wgmma_runs(a, bh, bl, group=1, passes=3):
    """a [M, K] @ b [K, N] as csrc/mlp_bwd_tc.cu runs it on wgmma: a split
    into TF32 halves, b given as its halves bh, bl [K', N] (K' >= K rows,
    the rows past K zero: a weight image, or dZ split as the dW kernel
    splits it), K in steps of 8; each run of ``group`` k-steps (1: the tile
    kernel's products, 4: dW's slices of 32 points) summed in one
    accumulator that starts from zero and rounds each add toward zero (per
    k-step lo·hi, hi·lo, hi·hi, each exact over its 8 products; ``passes=1``:
    hi·hi alone), then added to an fp32 sum, run after run."""
    steps = -(-bh.shape[0] // 8)
    a = torch.nn.functional.pad(a, (0, 8 * steps - a.shape[1]))
    bh = torch.nn.functional.pad(bh, (0, 0, 0, 8 * steps - bh.shape[0]))
    bl = torch.nn.functional.pad(bl, (0, 0, 0, 8 * steps - bl.shape[0]))
    ah, al = _split(a)
    pairs = ((al, bh), (ah, bl), (ah, bh)) if passes == 3 else ((ah, bh),)
    runs = -(-steps // group)
    pad = runs * group - steps  # zero k-steps: adding 0 is exact

    def step_sums(x, y):  # [run, k-step of the run, row, column], float64
        s = torch.einsum("psk,skn->spn", x.double().reshape(-1, steps, 8),
                         y.double().reshape(steps, 8, -1))
        return torch.nn.functional.pad(s, (0, 0, 0, 0, 0, pad)).reshape(runs, group, *s.shape[1:])

    sums = [step_sums(x, y) for x, y in pairs]
    acc = torch.zeros((runs,) + sums[0].shape[2:], dtype=torch.float64)
    for s in range(group):
        for part in sums:
            acc = _trunc32(acc + part[:, s]).double()
    out = torch.zeros(acc.shape[1:], dtype=torch.float32)
    for r in range(runs):
        out = out + acc[r].float()
    return out
