"""Device selection and small tensor helpers shared by the port's modules."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when CUDA is asked for (explicitly or by default) and no
    CUDA device is present — the port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


def linspace(
    start: float,
    stop: float,
    num: int,
    device: DeviceLike = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``jnp.linspace`` bit for bit: ``start·(1−t) + stop·t`` with
    ``t = i / (num−1)`` and the endpoint set exactly. ``torch.linspace``
    rounds some interior points differently (by up to one ulp), which moves
    sample depths and frequency bands off the reference's values."""
    if num == 1:
        return torch.full((1,), start, dtype=dtype, device=device)
    div = num - 1
    t = torch.arange(div, dtype=dtype, device=device) / div
    out = start * (1 - t) + stop * t
    return torch.cat([out, torch.full((1,), stop, dtype=dtype, device=device)])


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to bf16 (nearest even) and back, differentiable
    (the gradient is rounded to bf16 on its way back): a bf16 operand of the
    JAX package's Pallas kernels and XLA dots."""
    return t.to(torch.bfloat16).float()
