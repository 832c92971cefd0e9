"""Triangle-mesh ray tracing (port of ``render/mesh.py``; reference R3 +
H3/H4/H5).

Host side, NumPy copies bit-equal to the JAX package's: a minimal ASCII PLY
loader (``scripts/mesh_rt/ply_loader.py`` parity), unit-box normalization,
and a median-split BVH builder with the reference's exact node encoding (8
floats per node; inner nodes mark the right child as ``-(right+1)`` in the
count slot — ``scripts/mesh_rt/bvh.py``).

Device side, two tracers, plain PyTorch (the JAX package computes both in
XLA; no kernel of the port's):
  * ``trace_brute`` — every ray against every triangle, triangle chunk by
    chunk (vectorized Moller-Trumbore, zero gathers). The chunk only bounds
    the temporaries: ties go to the lowest triangle index within a chunk
    (``argmin``) and across chunks (strict ``<``), so it does not move the
    result.
  * ``trace_bvh`` — near-first traversal with a per-ray stack of depth 64
    (``mesh_rt.slang:84``), all rays in lockstep. JAX loops while any
    stack is non-empty, a condition on the device; here the host checks it
    every ``SYNC_EVERY`` steps, and the steps between checks run only the
    rays that were still live (a finished ray changes nothing in a further
    step, so neither changes the result).

Shading matches ``mesh_rt.slang:147-162``: two-sided N.L + distance AO on
hit, vertical sky gradient on miss.
"""

from __future__ import annotations

import pathlib
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from mri_raytracer_tpu_torch.env import device_floats, resolve_device
from mri_raytracer_tpu_torch.render.camera import CameraBasis, camera_rays


# ------------------------------------------------------------------ PLY (H5)
def load_ply_ascii(path, max_faces: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """ASCII PLY -> (verts (V,3) f32, tris (T,3) u32). Faces with >3 verts
    are fan-triangulated; ``max_faces`` caps the triangle count."""
    lines = pathlib.Path(path).read_text().splitlines()
    if not lines or lines[0].strip() != "ply":
        raise ValueError(f"{path}: not a PLY file")
    n_vert = n_face = 0
    header_end = 0
    fmt_ok = False
    for i, ln in enumerate(lines):
        t = ln.split()
        if not t:
            continue
        if t[0] == "format":
            fmt_ok = t[1] == "ascii"
        elif t[0] == "element" and t[1] == "vertex":
            n_vert = int(t[2])
        elif t[0] == "element" and t[1] == "face":
            n_face = int(t[2])
        elif t[0] == "end_header":
            header_end = i + 1
            break
    if not fmt_ok:
        raise ValueError(f"{path}: only ascii PLY supported")
    verts = np.array([[float(x) for x in lines[header_end + i].split()[:3]]
                      for i in range(n_vert)], np.float32)
    tris = []
    for i in range(n_face):
        t = lines[header_end + n_vert + i].split()
        cnt = int(t[0])
        idx = [int(x) for x in t[1:1 + cnt]]
        for k in range(1, cnt - 1):  # fan triangulation
            tris.append([idx[0], idx[k], idx[k + 1]])
        if max_faces is not None and len(tris) >= max_faces:
            break
    return verts, np.asarray(tris, np.uint32)


def normalize_to_unit_box(verts: np.ndarray) -> np.ndarray:
    """Center at origin, scale so the largest extent spans [-1, 1]
    (reference ``scripts/mesh_rt/app.py`` load path)."""
    lo, hi = verts.min(0), verts.max(0)
    center = 0.5 * (lo + hi)
    scale = 2.0 / max(float((hi - lo).max()), 1e-9)
    return ((verts - center) * scale).astype(np.float32)


# ------------------------------------------------------------------ BVH (H4)
@dataclass
class BVH:
    nodes: np.ndarray  # (N, 8): bmin(3), bmax(3), leftFirst, countOrNegRight
    tris: np.ndarray  # (M, 3) uint32, leaf-compacted order
    verts: np.ndarray  # (V, 3) float32


def build_bvh(verts: np.ndarray, tris: np.ndarray, max_leaf_tris: int = 4) -> BVH:
    """SAH-less median split on the largest centroid axis; leaf-compacted
    triangle list; inner nodes encode right child as -(right+1)."""
    V = verts.astype(np.float32, copy=False)
    T = tris.astype(np.uint32, copy=False)
    cent = V[T].mean(axis=1)
    bmin_t = V[T].min(axis=1)
    bmax_t = V[T].max(axis=1)

    nodes = []  # [bmin, bmax, leftFirst, count]
    leaf_order = []

    def rec(ids: np.ndarray) -> int:
        bmin = bmin_t[ids].min(0)
        bmax = bmax_t[ids].max(0)
        me = len(nodes)
        nodes.append([bmin, bmax, 0, 0])
        if len(ids) <= max_leaf_tris:
            nodes[me][2] = len(leaf_order)
            nodes[me][3] = len(ids)
            leaf_order.extend(int(t) for t in ids)
            return me
        cmin = cent[ids].min(0)
        cmax = cent[ids].max(0)
        axis = int(np.argmax(cmax - cmin))
        order = np.argsort(cent[ids, axis], kind="stable")
        mid = len(ids) // 2
        left = rec(ids[order[:mid]])
        right = rec(ids[order[mid:]])
        nodes[me][2] = left
        nodes[me][3] = -(right + 1)
        return me

    rec(np.arange(len(T), dtype=np.int64))
    packed = np.zeros((len(nodes), 8), np.float32)
    for i, (bmin, bmax, lf, cnt) in enumerate(nodes):
        packed[i, 0:3] = bmin
        packed[i, 3:6] = bmax
        packed[i, 6] = lf
        packed[i, 7] = cnt
    return BVH(nodes=packed, tris=T[np.asarray(leaf_order, np.int64)], verts=V)


# ----------------------------------------------------------------- intersect
def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.cross`` over the last axis, broadcasting ``a`` and ``b``."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _moller_trumbore(ro, rd, a, b, c, eps: float = 1e-8):
    """Vectorized ray-triangle test. ro/rd (..., 3); a/b/c (T, 3).
    Returns (t (..., T), valid (..., T), n (T, 3))."""
    ab = b - a
    ac = c - a
    n = _cross(ab, ac)
    rdt = rd[..., None, :]
    p = _cross(rdt, ac)  # (..., T, 3)
    det = _dot(ab, p)
    inv = 1.0 / torch.where(torch.abs(det) < eps, eps, det)
    s = ro[..., None, :] - a
    u = _dot(s, p) * inv
    q = _cross(s, ab)
    v = _dot(rdt, q) * inv
    t = _dot(ac, q) * inv
    valid = (torch.abs(det) >= eps) & (u >= 0) & (u <= 1) & (v >= 0) \
        & (u + v <= 1) & (t > 1e-5)
    return t, valid, n


def brute_chunk(n_rays: int, device) -> int:
    """Triangles a ``trace_brute`` chunk tests: 512 (the JAX default) up to
    a budget of ray-triangle pairs, fewer beyond: 2^25 on a card, so one
    (rays, chunk, 3) float32 temporary stays under 384 MiB; 2^21 on the
    CPU, whose eager passes run twice as fast on temporaries that stay
    in its caches."""
    budget = 1 << (25 if torch.device(device).type == "cuda" else 21)
    return max(1, min(512, budget // max(1, n_rays)))


def trace_brute(ro: torch.Tensor, rd: torch.Tensor, verts: torch.Tensor,
                tris: torch.Tensor, chunk: Optional[int] = None):
    """Closest hit over all triangles, scanning triangle chunks (``chunk``
    triangles each, ``brute_chunk`` of the ray count and device unless
    given).
    Returns (t (...), normal (..., 3), hit (...)) on the rays' device."""
    shp = ro.shape[:-1]
    ro = ro.reshape(-1, 3)
    rd = rd.reshape(-1, 3)
    tl = torch.as_tensor(tris, device=ro.device).long()
    chunk = (brute_chunk(ro.shape[0], ro.device) if chunk is None
             else int(chunk))
    t_best = torch.full(ro.shape[:-1], float("inf"), device=ro.device)
    n_best = torch.zeros(ro.shape, device=ro.device)
    for c0 in range(0, tl.shape[0], chunk):
        tri = tl[c0:c0 + chunk]
        t, valid, n = _moller_trumbore(ro, rd, verts[tri[:, 0]],
                                       verts[tri[:, 1]], verts[tri[:, 2]])
        t = torch.where(valid, t, float("inf"))
        # argmin returns the first minimum, as jnp.argmin does.
        t_min, idx = torch.min(t, dim=-1)
        better = t_min < t_best
        t_best = torch.where(better, t_min, t_best)
        n_best = torch.where(better[..., None], n[idx], n_best)
    return (t_best.reshape(shp), n_best.reshape(shp + (3,)),
            torch.isfinite(t_best).reshape(shp))


def _aabb_t(ro, rcp, bmin, bmax):
    t0 = (bmin - ro) * rcp
    t1 = (bmax - ro) * rcp
    tn = torch.amax(torch.minimum(t0, t1), dim=-1)
    tf = torch.amin(torch.maximum(t0, t1), dim=-1)
    return tn, (tf >= torch.clamp(tn, min=0.0))


def _bvh_step(state, ro, rd, rcp, nodes, va, vb, vc, max_leaf_tris: int,
              stack_depth: int):
    """One lockstep traversal step of every ray in ``state`` (sp, stack,
    t_best, n_best); the stack is updated in place. Every index the step
    reads is clipped into range, as JAX's gathers clamp silently."""
    sp, stack, t_best, n_best = state
    n_nodes, n_tris = nodes.shape[0], va.shape[0]
    active = sp > 0
    top = torch.clamp(sp - 1, min=0).long()
    ni = stack.gather(1, top[:, None])[:, 0].long().clamp_(0, n_nodes - 1)
    sp = torch.where(active, sp - 1, sp)

    node = nodes[ni]  # (n, 8) gather
    tn, hit_box = _aabb_t(ro, rcp, node[:, 0:3], node[:, 3:6])
    visit = active & hit_box & (tn <= t_best)
    # Node indices are stored as float32: left_first truncates, the count
    # rounds half to even (astype(int32) and jnp.round in JAX).
    left_first = node[:, 6].to(torch.int32)
    cnt = torch.round(node[:, 7]).to(torch.int32)
    is_leaf = cnt > 0

    # Leaf: test up to max_leaf_tris triangles.
    for k in range(max_leaf_tris):
        ti = torch.clamp(left_first + k, 0, n_tris - 1).long()
        do = visit & is_leaf & (k < cnt)
        a, b, c = va[ti], vb[ti], vc[ti]
        ab = b - a
        ac = c - a
        n = _cross(ab, ac)
        p = _cross(rd, ac)
        det = _dot(ab, p)
        inv = 1.0 / torch.where(torch.abs(det) < 1e-8, 1e-8, det)
        s = ro - a
        u = _dot(s, p) * inv
        q = _cross(s, ab)
        v = _dot(rd, q) * inv
        t = _dot(ac, q) * inv
        ok = do & (torch.abs(det) >= 1e-8) & (u >= 0) & (u <= 1) \
            & (v >= 0) & (u + v <= 1) & (t > 1e-5) & (t < t_best)
        t_best = torch.where(ok, t, t_best)
        n_best = torch.where(ok[:, None], n, n_best)

    # Inner: push children near-first.
    right = -cnt - 1
    inner = visit & ~is_leaf
    ln = nodes[torch.clamp(left_first, 0, n_nodes - 1).long()]
    rn = nodes[torch.clamp(right, 0, n_nodes - 1).long()]
    tl, hl = _aabb_t(ro, rcp, ln[:, 0:3], ln[:, 3:6])
    tr, hr = _aabb_t(ro, rcp, rn[:, 0:3], rn[:, 3:6])
    hl = hl & inner & (tl <= t_best)
    hr = hr & inner & (tr <= t_best)
    near_is_left = tl < tr
    first = torch.where(near_is_left, left_first, right)
    second = torch.where(near_is_left, right, left_first)
    first_ok = torch.where(near_is_left, hl, hr)
    second_ok = torch.where(near_is_left, hr, hl)

    def push(sp, idx, ok):
        # One scatter at the slot, where JAX rewrites every slot with a
        # where: the same stack.
        pos = torch.clamp(sp, max=stack_depth - 1).long()[:, None]
        old = stack.gather(1, pos)[:, 0]
        stack.scatter_(1, pos, torch.where(ok, idx, old)[:, None])
        return torch.where(ok, torch.clamp(sp + 1, max=stack_depth), sp)

    # Far child first so the near child pops first.
    sp = push(sp, second, second_ok)
    sp = push(sp, first, first_ok)
    return sp, stack, t_best, n_best


# Traversal steps between the host's checks for finished rays.
SYNC_EVERY = 8


def trace_bvh(ro: torch.Tensor, rd: torch.Tensor, nodes: torch.Tensor,
              tris: torch.Tensor, verts: torch.Tensor,
              max_leaf_tris: int = 4, stack_depth: int = 64,
              stats: Optional[dict] = None):
    """Near-first BVH traversal with a per-ray masked stack (all rays advance
    in lockstep through their own stacks; finished rays idle). Returns
    (t (...), normal (..., 3), hit (...)).

    Every ``SYNC_EVERY`` steps the host reads which rays still hold a stack
    entry (one device sync), stops when none does, and runs the next steps
    on those rays only. ``stats``, when given, gains ``steps`` (traversal
    steps run), ``syncs`` (host syncs) and ``ray_steps`` (rays times steps
    run)."""
    shp = ro.shape[:-1]
    dev = ro.device
    ro = ro.reshape(-1, 3)
    rd = rd.reshape(-1, 3)
    tiny = torch.where(rd >= 0, 1e-8, -1e-8)
    rcp = 1.0 / torch.where(torch.abs(rd) < 1e-8, tiny, rd)
    tl = tris.long()
    va, vb, vc = verts[tl[:, 0]], verts[tl[:, 1]], verts[tl[:, 2]]

    nr = ro.shape[0]
    sp = torch.ones(nr, dtype=torch.int32, device=dev)  # root pushed
    stack = torch.zeros((nr, stack_depth), dtype=torch.int32, device=dev)
    t_best = torch.full((nr,), float("inf"), device=dev)
    n_best = torch.zeros((nr, 3), device=dev)
    steps = syncs = ray_steps = 0
    live = None  # None: every ray (before the first check, or none done)
    while True:
        if steps:
            syncs += 1
            live = torch.nonzero(sp > 0).squeeze(1)
            if live.numel() == 0:
                break
            if live.numel() == nr:
                live = None
        if live is None:
            state, rays = (sp, stack, t_best, n_best), (ro, rd, rcp)
        else:
            state = (sp[live], stack[live], t_best[live], n_best[live])
            rays = (ro[live], rd[live], rcp[live])
        for _ in range(SYNC_EVERY):
            state = _bvh_step(state, *rays, nodes, va, vb, vc,
                              max_leaf_tris, stack_depth)
        steps += SYNC_EVERY
        ray_steps += SYNC_EVERY * (nr if live is None else live.numel())
        if live is None:
            sp, stack, t_best, n_best = state
        else:
            for whole, part in zip((sp, stack, t_best, n_best), state):
                whole.index_copy_(0, live, part)
    if stats is not None:
        stats.update(steps=steps, syncs=syncs, ray_steps=ray_steps)
    return (t_best.reshape(shp), n_best.reshape(shp + (3,)),
            torch.isfinite(t_best).reshape(shp))


# ------------------------------------------------------------------ renderer
def shade(ro, rd, t, n, hit) -> torch.Tensor:
    """Reference shading (mesh_rt.slang:147-162)."""
    dev = rd.device
    nn = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                         min=1e-12)
    # two-sided
    flip = _dot(nn, rd) > 0.0
    nn = torch.where(flip[..., None], -nn, nn)
    l = device_floats([0.3, 0.8, 0.5], dev)
    l = l / torch.linalg.vector_norm(l)
    ndotl = torch.clamp(_dot(nn, l), min=0.0)
    t_safe = torch.where(hit, t, 0.0)
    ao = 0.3 + 0.7 * torch.clamp(1.0 - 0.05 * t_safe, 0.0, 1.0)
    color = ((0.15 + ndotl) * ao)[..., None] \
        * device_floats([0.8, 0.7, 0.6], dev)
    tbg = 0.5 * (rd[..., 1] + 1.0)
    sky = ((1.0 - tbg[..., None]) * device_floats([0.05, 0.06, 0.08], dev)
           + tbg[..., None] * device_floats([0.2, 0.25, 0.3], dev))
    return torch.where(hit[..., None], color, sky)


class MeshRenderer:
    """Reference H3 equivalent: PLY -> normalize -> BVH -> per-frame trace,
    on ``device`` (``cuda`` unless given). ``last_stats`` holds the last
    BVH frame's traversal counts (``trace_bvh``'s ``stats``)."""

    def __init__(self, verts: np.ndarray, tris: np.ndarray, width: int = 512,
                 height: int = 512, mode: str = "auto",
                 brute_threshold: int = 20000, device=None):
        self.device = resolve_device(device)
        unit = normalize_to_unit_box(verts)
        self.verts = torch.as_tensor(unit, device=self.device)
        self.tris = torch.as_tensor(tris.astype(np.int32), device=self.device)
        self.width, self.height = width, height
        if mode == "auto":
            mode = "brute" if tris.shape[0] <= brute_threshold else "bvh"
        self.mode = mode
        self.last_stats: dict = {}
        if mode == "bvh":
            bvh = build_bvh(unit, tris)
            self.nodes = torch.as_tensor(bvh.nodes, device=self.device)
            self.bvh_tris = torch.as_tensor(bvh.tris.astype(np.int32),
                                            device=self.device)

    @classmethod
    def from_ply(cls, path, **kw) -> "MeshRenderer":
        verts, tris = load_ply_ascii(path)
        return cls(verts, tris, **kw)

    def render(self, basis: CameraBasis) -> torch.Tensor:
        ro, rd = camera_rays(basis.to(self.device), self.width, self.height)
        if self.mode == "brute":
            t, n, hit = trace_brute(ro, rd, self.verts, self.tris)
        else:
            self.last_stats = {}
            t, n, hit = trace_bvh(ro, rd, self.nodes, self.bvh_tris,
                                  self.verts, stats=self.last_stats)
        return shade(ro, rd, t, n, hit)
