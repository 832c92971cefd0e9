"""Cooperative hybrid renderer (port of ``render/hybrid.py``): volumetric
primary rays + explicit-mesh secondary (visibility) rays through the packed
BVH.

Reference parity: ``docs/Approach.md:48`` and :172-205 (hybrid step =
batched ray-mesh intersection queries on an explicit mesh extracted from
the implicit field, via general compute, no RT hardware):

  - primary rays: fixed-step emission-absorption march of the MRI volume
    (a static step count), which also produces a deferred surface estimate
    per pixel (opacity-weighted expected depth + central-difference
    gradient normal);
  - secondary rays: one batched lockstep traversal of the structure mesh's
    BVH (``render.mesh.trace_bvh``) for every pixel's shadow query;
  - cooperative skip: the same BVH answers primary-ray entry queries, so
    the march starts at the mesh hit (minus a small margin) instead of the
    volume AABB.

The mesh is extracted once on the host (boundary faces of a label mask —
exact, watertight; NumPy, bit-equal to the JAX package's) and the BVH is
the packed array form the traversal consumes. The march is plain PyTorch
on the volume's device; the JAX package computes it in XLA, with no
kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mri_raytracer_tpu_torch.env import device_floats, resolve_device
from mri_raytracer_tpu_torch.ops.raymarch import _safe_dir, aabb_hit
from mri_raytracer_tpu_torch.ops.trilinear import trilinear_sample_base
from mri_raytracer_tpu_torch.render.camera import CameraBasis, camera_rays
from mri_raytracer_tpu_torch.render.mesh import build_bvh, trace_bvh


# ------------------------------------------------------------ mesh extraction
def _pool_any(mask: np.ndarray, f: int) -> np.ndarray:
    """Any-pooling downsample by factor f (pads with empty)."""
    if f <= 1:
        return mask
    X, Y, Z = mask.shape
    pad = [(-d) % f for d in (X, Y, Z)]
    m = np.pad(mask, [(0, p) for p in pad])
    return m.reshape(m.shape[0] // f, f, m.shape[1] // f, f,
                     m.shape[2] // f, f).any(axis=(1, 3, 5))


def extract_boundary_mesh(mask: np.ndarray, vol_min=None,
                          voxel_size: Optional[Tuple[float, float, float]]
                          = None, downsample: int = 1,
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Watertight boundary-face surface of a binary voxel mask.

    Emits two triangles per exposed voxel face (occupied voxel next to an
    empty voxel / the border), with OUTWARD winding. Exact for visibility
    queries — unlike a marching-cubes isosurface it cannot leak rays through
    the structure it bounds. ``downsample`` any-pools the mask first to cap
    the triangle count (a conservative DILATION of the occluder).

    Returns ``(verts (V,3) float32 world coords, tris (T,3) uint32)``.
    World mapping matches the BraTS box convention: voxel corner ``i`` sits
    at ``vol_min + voxel_size * i`` (``ops/raymarch_xla.render_brats``).
    """
    mask = np.asarray(mask).astype(bool)
    full_dims = np.array(mask.shape, np.float32)
    if voxel_size is None:
        # Default BraTS params box: the volume spans [-1, 1] on the largest
        # axis (render/params.default_render_params convention).
        voxel_size = tuple(2.0 / float(full_dims.max()) for _ in range(3))
    if vol_min is None:
        # CENTERED box, matching render_hybrid's bmin = -(dims*vs)/2: for a
        # non-cubic volume the shorter axes span less than [-1, 1], so a
        # fixed (-1,-1,-1) origin would displace the occluder mesh from the
        # volume it bounds along every non-longest axis.
        vol_min = -(full_dims * np.asarray(voxel_size, np.float32)) / 2.0
    vol_min = np.asarray(vol_min, np.float32)
    vs = np.asarray(voxel_size, np.float32) * downsample
    m = _pool_any(mask, downsample)

    padded = np.pad(m, 1)
    verts_l = []
    tris_l = []
    n_v = 0
    # Face quads per axis: (axis, neighbor offset, the 4 corner offsets in
    # outward-winding order for the +side, reversed for the -side).
    corners = {
        0: [(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1)],   # +x face
        1: [(0, 1, 0), (0, 1, 1), (1, 1, 1), (1, 1, 0)],   # +y face
        2: [(0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)],   # +z face
    }
    for axis in range(3):
        for sign in (+1, -1):
            nb = np.roll(padded, -sign, axis=axis)
            exposed = np.argwhere(padded & ~nb)[:, :] - 1  # voxel indices
            if exposed.size == 0:
                continue
            cs = np.array(corners[axis], np.float32)
            if sign < 0:
                cs = cs[::-1].copy()
                cs[:, axis] -= 1.0  # -side face sits at the voxel's lower wall
            quad = exposed[:, None, :].astype(np.float32) + cs[None]  # (N,4,3)
            v = vol_min[None, None] + vs[None, None] * quad
            n = v.shape[0]
            idx = n_v + np.arange(n * 4, dtype=np.uint32).reshape(n, 4)
            verts_l.append(v.reshape(-1, 3))
            tris_l.append(np.concatenate(
                [idx[:, [0, 1, 2]], idx[:, [0, 2, 3]]], axis=0))
            n_v += n * 4
    if not verts_l:
        return (np.zeros((3, 3), np.float32),
                np.zeros((1, 3), np.uint32))  # degenerate far-away tri
    verts = np.concatenate(verts_l, axis=0).astype(np.float32)
    tris = np.concatenate(tris_l, axis=0).astype(np.uint32)
    # Weld shared corners so the BVH AABBs stay tight and memory stays low.
    uniq, inv = np.unique(verts.round(6), axis=0, return_inverse=True)
    return uniq.astype(np.float32), inv[tris.astype(np.int64)].astype(
        np.uint32)


# ------------------------------------------------------------------ rendering
def _norm(x: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm(x, axis=-1, keepdims=True)``."""
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def render_hybrid(vol, basis: CameraBasis, nodes: torch.Tensor,
                  tris: torch.Tensor, verts: torch.Tensor,
                  light_dir, width: int = 256, height: int = 256,
                  max_steps: int = 192, sigma: float = 6.0,
                  ambient: float = 0.35, shadow_strength: float = 0.75,
                  mesh_skip: bool = True, shadows: bool = True,
                  bg: float = 0.0, stats: Optional[dict] = None
                  ) -> torch.Tensor:
    """One hybrid frame -> (H, W, 3) on the volume's device.

    ``vol``: (X, Y, Z) display-normalized intensities in the [-1,1]-box
    convention (largest axis spans [-1, 1]), a tensor on the frame's
    device. ``nodes/tris/verts``: packed BVH of the occluder mesh
    (``build_bvh`` over ``extract_boundary_mesh``) on the same device.
    ``mesh_skip``: primary rays start at their BVH entry hit (cooperative
    empty-space skip); rays that miss the mesh still march the full AABB
    span (the mesh bounds the structure, not the whole volume).
    ``stats``, when given, gains each BVH pass's traversal counts under
    ``skip`` and ``shadow`` (with the shadow rays' (H, W) hit mask under
    ``hit``).
    """
    dev = vol.device
    X, Y, Z = vol.shape
    dims_np = np.array([X, Y, Z], np.float32)
    vs_np = np.float32(2.0) / dims_np.max()
    dims = device_floats(dims_np, dev)
    vs = float(vs_np)
    bmin = -(dims * vs) / 2.0
    bmax = (dims * vs) / 2.0

    ro, rd = camera_rays(basis.to(dev), width, height)
    rcp = 1.0 / _safe_dir(rd)
    hit, t0, t1 = aabb_hit(ro, rcp, bmin, bmax)
    t0 = torch.clamp(t0, min=0.0)
    valid = hit & (t1 > t0)

    if mesh_skip:
        st = {}
        t_mesh, _, mesh_hit = trace_bvh(ro, rd, nodes, tris, verts, stats=st)
        if stats is not None:
            stats["skip"] = st
        # Start a small margin before the structure so its boundary shading
        # (gradient support) is sampled; misses keep the AABB entry.
        t0 = torch.where(mesh_hit,
                         torch.maximum(t0, t_mesh - float(8.0 * vs_np)), t0)

    dt = (t1 - t0) / max_steps

    def to_grid(pw):
        # world -> continuous voxel coords for trilinear_sample_base
        return (pw - bmin) / vs - 0.5

    C = torch.zeros((height, width), dtype=torch.float32, device=dev)
    T = torch.ones((height, width), dtype=torch.float32, device=dev)
    wsum = torch.zeros_like(C)
    tbar = torch.zeros_like(C)
    for i in range(max_steps):
        t = t0 + (i + 0.5) * dt
        pw = ro + rd * t[..., None]
        s = trilinear_sample_base(vol, to_grid(pw))
        a = 1.0 - torch.exp(-sigma * torch.clamp(s, min=0.0) * dt)
        a = torch.where(valid, a, 0.0)
        w = T * a
        C = C + w * s
        wsum = wsum + w
        tbar = tbar + w * t
        T = T * (1.0 - a)

    # Deferred surface estimate: expected depth + gradient normal there.
    t_surf = tbar / torch.clamp(wsum, min=1e-8)
    p_surf = ro + rd * t_surf[..., None]
    g = to_grid(p_surf)
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)  # eps = 1 voxel
    grad = torch.stack([trilinear_sample_base(vol, g + eye3[a])
                        - trilinear_sample_base(vol, g - eye3[a])
                        for a in range(3)], dim=-1)
    n = -grad / torch.clamp(_norm(grad), min=1e-8)
    ld = torch.as_tensor(light_dir, dtype=torch.float32, device=dev)
    ld = ld / _norm(ld)
    lambert = torch.clamp((n * ld).sum(-1), min=0.0)

    occ = torch.zeros((height, width), dtype=torch.float32, device=dev)
    if shadows:
        # One batched lockstep BVH pass answers every pixel's visibility
        # query (the Approach.md "hybrid step").
        o_sh = p_surf + n * float(2.0 * vs_np)  # epsilon along the normal
        d_sh = ld.expand(o_sh.shape)
        st = {}
        _, _, hit_sh = trace_bvh(o_sh.reshape(1, -1, 3),
                                 d_sh.reshape(1, -1, 3), nodes, tris, verts,
                                 stats=st)
        if stats is not None:
            stats["shadow"] = dict(st, hit=hit_sh.reshape(height, width))
        occ = torch.where(hit_sh, 1.0, 0.0).reshape(height, width)

    shade = ambient + (1.0 - ambient) * lambert \
        * (1.0 - shadow_strength * occ)
    # C is opacity-premultiplied by construction (sum of T*a*s), so the
    # background composites with the remaining transmittance only.
    img = torch.where(wsum > 1e-6, C * shade, 0.0) + bg * T
    return torch.clamp(img[..., None].repeat(1, 1, 3), 0.0, 1.0)


class HybridRenderer:
    """Front-end: extract the structure mesh once, build the BVH, render
    hybrid frames on ``device`` (``cuda`` unless given). ``mask`` is the
    occluding structure (e.g. the tumor labels); ``vol`` supplies
    appearance. ``last_stats`` holds the last frame's BVH traversal
    counts."""

    def __init__(self, vol: np.ndarray, mask: np.ndarray, width: int = 256,
                 height: int = 256, light_dir=(0.5, 0.8, 0.6),
                 max_steps: int = 192, downsample: int = 1, device=None):
        self.device = resolve_device(device)
        self.vol = torch.as_tensor(np.asarray(vol, np.float32),
                                   device=self.device)
        verts, tris = extract_boundary_mesh(mask, downsample=downsample)
        bvh = build_bvh(verts, tris)
        self.nodes = torch.as_tensor(bvh.nodes, device=self.device)
        self.tris = torch.as_tensor(bvh.tris.astype(np.int32),
                                    device=self.device)
        self.verts = torch.as_tensor(bvh.verts, device=self.device)
        self.n_tris = int(tris.shape[0])
        self.n_nodes = int(bvh.nodes.shape[0])
        self.width, self.height = int(width), int(height)
        self.light = np.asarray(light_dir, np.float32)
        self.max_steps = int(max_steps)
        self.last_stats: dict = {}

    def render(self, basis: CameraBasis, shadows: bool = True,
               mesh_skip: bool = True, **kw) -> torch.Tensor:
        self.last_stats = {}
        return render_hybrid(self.vol, basis, self.nodes, self.tris,
                             self.verts, self.light, width=self.width,
                             height=self.height, max_steps=self.max_steps,
                             shadows=shadows, mesh_skip=mesh_skip,
                             stats=self.last_stats, **kw)

    def render_numpy(self, basis, **kw) -> np.ndarray:
        return self.render(basis, **kw).cpu().numpy()
