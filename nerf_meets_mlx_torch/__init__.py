"""nerf_meets_mlx_torch — the PyTorch/CUDA port of nerf_meets_mlx_tpu.

A second package beside the JAX one, written for one NVIDIA H100. It
mirrors the JAX package's module paths and names; the JAX package stays the
reference every part of the port is tested against. Each Pallas TPU kernel
on a ported path becomes a hand-written Hopper kernel (``csrc/``) with a
plain PyTorch version beside it (``kernels/``).

The port serves and trains the sinusoidal presets (``lego_hierarchical``,
``lego_occ``) and the hash-grid presets (``lego_ingp``, ``lego_ingp_occ``,
and through the "feats" route the larger hash grids), and fits the 2-D
image task (``python -m nerf_meets_mlx_torch train``, ``render``,
``image``). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

from nerf_meets_mlx_torch.version import __version__

__all__ = ["__version__"]
