"""Synthetic camera-pose generation.

Equivalent of mlx_nerf/ops/pose.py:7-58 (spherical-coordinate
camera-to-world composition) implemented as vectorized numpy — poses are tiny
host-side constants, so there is no reason to build them on-device.
"""

from __future__ import annotations

import numpy as np


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """Camera-to-world from spherical coordinates (degrees).

    Composition matches pose.py:43-58: translate z by `radius`, pitch by
    `phi`, yaw by `theta` (inverted-sin convention), then the world-axis
    fixup (invert X, swap Y<->Z).
    """
    trans = np.eye(4, dtype=np.float32)
    trans[2, 3] = radius

    phi_r = np.deg2rad(phi)
    rot_phi = np.eye(4, dtype=np.float32)
    rot_phi[1, 1] = np.cos(phi_r)
    rot_phi[1, 2] = -np.sin(phi_r)
    rot_phi[2, 1] = np.sin(phi_r)
    rot_phi[2, 2] = np.cos(phi_r)

    th_r = np.deg2rad(theta)
    rot_theta = np.eye(4, dtype=np.float32)
    rot_theta[0, 0] = np.cos(th_r)
    rot_theta[0, 2] = -np.sin(th_r)
    rot_theta[2, 0] = np.sin(th_r)
    rot_theta[2, 2] = np.cos(th_r)

    fixup = np.array(
        [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
        dtype=np.float32,
    )
    return fixup @ rot_theta @ rot_phi @ trans


def orbit_poses(n: int = 160, phi: float = -30.0, radius: float = 4.0) -> np.ndarray:
    """The reference's render-pose orbit: n poses over theta in [-180, 180)
    at fixed pitch/radius (dataloader.py:68-74).

    Returns [n, 4, 4] float32.
    """
    thetas = np.linspace(-180.0, 180.0, n + 1)[:-1]
    return np.stack([pose_spherical(t, phi, radius) for t in thetas], axis=0)
