"""Orbital camera + primary-ray generation (port of ``render/camera.py``).

The camera itself is host-side state (pure numpy, mutated by UI events);
``OrbitalCamera.basis`` hands its basis out as a ``CameraBasis`` of tensors
on the device asked for, and ``camera_rays`` turns a basis into per-pixel
ray directions on the basis' device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch


class CameraBasis(NamedTuple):
    """Ray-generation inputs, float32 tensors on one device."""

    eye: torch.Tensor  # (3,)
    right: torch.Tensor  # (3,) "U"
    up: torch.Tensor  # (3,) "V"
    forward: torch.Tensor  # (3,) "W"
    fov_y: torch.Tensor  # () radians

    def pack(self) -> torch.Tensor:
        """Flatten to one (13,) vector on the basis' device."""
        return torch.cat([self.eye.reshape(3), self.right.reshape(3),
                          self.up.reshape(3), self.forward.reshape(3),
                          self.fov_y.reshape(1)]).to(torch.float32)

    def to(self, device: Union[str, torch.device]) -> "CameraBasis":
        return CameraBasis(*(t.to(device) for t in self))


def unpack_basis(vec: torch.Tensor) -> CameraBasis:
    """Inverse of ``CameraBasis.pack``."""
    return CameraBasis(vec[0:3], vec[3:6], vec[6:9], vec[9:12], vec[12])


class OrbitalCamera:
    """Spherical orbit / pan / zoom camera with arbitrary ``world_up``."""

    def __init__(
        self,
        target: Optional[np.ndarray] = None,
        radius: float = 2.0,
        phi: float = math.pi * 0.5,
        theta: float = 0.0,
        min_radius: float = 0.1,
        max_radius: float = 100.0,
        min_phi: float = 0.01,
        max_phi: float = math.pi - 0.01,
        fov_y: float = math.radians(55.0),
        near: float = 0.1,
        far: float = 1000.0,
        world_up: Optional[np.ndarray] = None,
    ):
        self._init_state = dict(
            target=np.zeros(3, np.float32) if target is None else np.asarray(target, np.float32),
            radius=float(radius), phi=float(phi), theta=float(theta),
            min_radius=float(min_radius), max_radius=float(max_radius),
            min_phi=float(min_phi), max_phi=float(max_phi),
        )
        self.fov_y = float(fov_y)
        self.near = float(near)
        self.far = float(far)
        self.world_up = (np.asarray(world_up, np.float32) if world_up is not None
                         else np.array([0.0, 1.0, 0.0], np.float32))
        self.reset()

    def reset(self) -> None:
        s = self._init_state
        self.target = s["target"].copy()
        self.radius, self.phi, self.theta = s["radius"], s["phi"], s["theta"]
        self.min_radius, self.max_radius = s["min_radius"], s["max_radius"]
        self.min_phi, self.max_phi = s["min_phi"], s["max_phi"]

    # -------------------------------------------------------------- geometry
    def _base_frame(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Orthonormal (right, forward, up) frame around ``world_up``."""
        wu = self.world_up
        ref = np.array([0.0, 0.0, 1.0], np.float32)
        if abs(float(np.dot(wu, ref))) > 0.999:
            ref = np.array([1.0, 0.0, 0.0], np.float32)
        r = np.cross(ref, wu)
        n = float(np.linalg.norm(r))
        r = r / n if n >= 1e-6 else np.array([1.0, 0.0, 0.0], np.float32)
        f = np.cross(wu, r)
        n = float(np.linalg.norm(f))
        if n > 0:
            f = f / n
        return r.astype(np.float32), f.astype(np.float32), wu

    def eye_position(self) -> np.ndarray:
        r, f, u = self._base_frame()
        s, c = math.sin(self.phi), math.cos(self.phi)
        d = (s * math.cos(self.theta)) * r + (s * math.sin(self.theta)) * f + c * u
        return (self.target + self.radius * d).astype(np.float32)

    def get_basis(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(eye, right, up, forward) — the U/V/W consumed by the marchers."""
        eye = self.eye_position()
        fwd = self.target - eye
        n = float(np.linalg.norm(fwd))
        fwd = fwd / n if n >= 1e-6 else np.array([0.0, 0.0, -1.0], np.float32)
        right = np.cross(fwd, self.world_up)
        n = float(np.linalg.norm(right))
        if n < 1e-6:
            right, _, _ = self._base_frame()
            n = float(np.linalg.norm(right))
        if n > 0:
            right = right / n
        up = np.cross(right, fwd)
        # Keep up aligned with world_up hemisphere to avoid flips at the poles.
        if float(np.dot(up, self.world_up)) < 0.0:
            up, right = -up, -right
        return (eye.astype(np.float32), right.astype(np.float32),
                up.astype(np.float32), fwd.astype(np.float32))

    def basis(self, device: Union[str, torch.device] = "cpu") -> CameraBasis:
        """The basis as tensors on ``device``. The renderer reads the sweep
        axis from it on the host, so the CPU default costs no device sync."""
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        eye, right, up, fwd = self.get_basis()
        return CameraBasis(t(eye), t(right), t(up), t(fwd), t(self.fov_y))

    # ------------------------------------------------------------ interaction
    def orbit(self, d_theta: float, d_phi: float) -> None:
        self.theta += float(d_theta)
        self.phi = min(self.max_phi, max(self.min_phi, self.phi + float(d_phi)))

    def pan(self, dx: float, dy: float, viewport_height: Optional[float] = None) -> None:
        _, right, up, _ = self.get_basis()
        px = float(viewport_height) if viewport_height and viewport_height > 0 else 720.0
        view_h = 2.0 * self.radius * math.tan(max(1e-3, self.fov_y * 0.5))
        scale = view_h / max(1.0, px)
        self.target = (self.target - right * (float(dx) * scale)
                       + up * (float(dy) * scale)).astype(np.float32)

    def zoom(self, factor: float) -> None:
        self.radius = min(self.max_radius, max(self.min_radius, self.radius * float(factor)))

    def set_fov_degrees(self, deg: float) -> None:
        self.fov_y = math.radians(float(deg))


def camera_rays(basis: CameraBasis, width: int, height: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Primary rays for every pixel, (H, W, 3) origins and unit directions.

    Pixel centers -> NDC in [-1,1], ``f = 1/tan(fov_y/2)``, camera dir
    ``(u*aspect/f, -v/f, 1)`` normalized, then rotated into the world basis
    (``inr/viewer/brats_rt.slang:36-46``)."""
    dev = basis.eye.device
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width
    ys = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) / height
    return _rays_from_ndc(basis, xs, ys, width, height)


def camera_rays_window(basis: CameraBasis, width: int, height: int,
                       x0, y0, win_w: int, win_h: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Primary rays for the pixel window [y0:y0+win_h, x0:x0+win_w] of a
    ``width x height`` image, with the per-pixel math of ``camera_rays``:
    a window ray equals the full-frame ray of the same pixel bit for bit,
    so a foveated inset composites seamlessly. ``x0``/``y0`` are numbers
    or float32 0-d tensors (on the basis' device, so no host sync); the
    window's size is a number."""
    dev = basis.eye.device
    xs = (x0 + torch.arange(win_w, dtype=torch.float32, device=dev) + 0.5) \
        / width
    ys = (y0 + torch.arange(win_h, dtype=torch.float32, device=dev) + 0.5) \
        / height
    return _rays_from_ndc(basis, xs, ys, width, height)


def _rays_from_ndc(basis: CameraBasis, xs: torch.Tensor, ys: torch.Tensor,
                   width: int, height: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    h, w = ys.shape[0], xs.shape[0]
    u = xs * 2.0 - 1.0  # (w,)
    v = ys * 2.0 - 1.0  # (h,)
    f = 1.0 / torch.tan(0.5 * basis.fov_y)
    aspect = width / max(1.0, float(height))
    cx = (u * aspect / f)[None, :].expand(h, w)
    cy = (-v / f)[:, None].expand(h, w)
    cz = torch.ones((h, w), dtype=torch.float32, device=xs.device)
    cam = torch.stack([cx, cy, cz], dim=-1)
    cam = cam / torch.linalg.vector_norm(cam, dim=-1, keepdim=True)
    d = (cam[..., 0:1] * basis.right + cam[..., 1:2] * basis.up
         + cam[..., 2:3] * basis.forward)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    o = basis.eye.expand(h, w, 3)
    return o, d
