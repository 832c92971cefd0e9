"""The camera path of the orbit traffic.

The poses of ``bench.py:79-86``: the camera starts at theta 0.6, phi 1.2
and moves by (d_theta, d_phi) every frame. bench.py timed ~120 frames; a
window of thousands would clamp phi at the pole and spin the camera there,
so phi is reflected between ``phi_lo`` and ``phi_hi`` (a triangle wave with
the same step), and every sweep axis keeps coming round.

``basis`` is a frozen copy of ``render/camera.OrbitalCamera.get_basis``
(target at the origin, world up +y), so the benchmark makes its poses
itself and hands the same numbers to the program and the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

WORLD_UP = np.array([0.0, 1.0, 0.0], np.float32)


def pose(orbit: Dict, i: int) -> Tuple[float, float]:
    """(theta, phi) of frame ``i`` of the path."""
    theta = orbit["theta0"] + i * orbit["d_theta"]
    lo, hi = orbit["phi_lo"], orbit["phi_hi"]
    span = hi - lo
    r = (orbit["phi0"] - lo + i * orbit["d_phi"]) % (2.0 * span)
    return theta, lo + (r if r <= span else 2.0 * span - r)


def _base_frame():
    wu = WORLD_UP
    ref = np.array([0.0, 0.0, 1.0], np.float32)
    r = np.cross(ref, wu)
    r = r / float(np.linalg.norm(r))
    f = np.cross(wu, r)
    f = f / float(np.linalg.norm(f))
    return r.astype(np.float32), f.astype(np.float32), wu


def basis(theta: float, phi: float, radius: float, fov_y: float):
    """(eye, right, up, forward) float32 (3,) arrays and fov_y."""
    r, f, u = _base_frame()
    s, c = math.sin(phi), math.cos(phi)
    d = (s * math.cos(theta)) * r + (s * math.sin(theta)) * f + c * u
    eye = (np.zeros(3, np.float32) + radius * d).astype(np.float32)
    fwd = -eye
    n = float(np.linalg.norm(fwd))
    fwd = fwd / n if n >= 1e-6 else np.array([0.0, 0.0, -1.0], np.float32)
    right = np.cross(fwd, WORLD_UP)
    n = float(np.linalg.norm(right))
    if n < 1e-6:
        right, _, _ = _base_frame()
        n = float(np.linalg.norm(right))
    right = right / n
    up = np.cross(right, fwd)
    if float(np.dot(up, WORLD_UP)) < 0.0:
        up, right = -up, -right
    return (eye.astype(np.float32), right.astype(np.float32),
            up.astype(np.float32), fwd.astype(np.float32), float(fov_y))


def camera_radius(voxel: np.ndarray, dims) -> float:
    """``render/params.default_camera_radius``: 0.8 |voxel * dims|."""
    return float(np.linalg.norm(np.asarray(voxel, np.float32)
                                * np.asarray(dims, np.float32)) * 0.8)


def frame_basis(orbit: Dict, i: int, radius: float):
    theta, phi = pose(orbit, i)
    return basis(theta, phi, radius, math.radians(orbit["fov_deg"]))
