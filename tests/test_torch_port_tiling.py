"""K1's per-tile plane culling (``csrc/composite.cu``), through its plain
PyTorch mirror ``composite.tile_planes_plain``, held against the plain
compositor ``composite_planes_plain`` on the CPU.

The kernel composites a tile only over the planes the rule lets through,
and stages each plane's a-row window in shared memory when it fits. So:
no plane a tile culls holds a pixel of that tile that the plain version
composites; the plain version run with the culled planes' ``own`` set to
0, tile by tile, gives the same C, T and executed-plane map bit for bit;
and every a-row a running tile's taps and nearest label rows read lies in
its window. Scenes of 40 x 36 x 32 voxels, O <= 128: several poses (all
three sweep axes), a crop whose clamp bounds lie outside [0, N), the clip
path, both row overlays, ragged tiles (O not a multiple of the tile) and
a small O whose windows exceed the stage's capacity (the kernel's
direct-load path). No JAX: both sides are the port's."""

import numpy as np
import pytest
import torch

from mri_raytracer_tpu_torch.data.brats import percentile_normalize
from mri_raytracer_tpu_torch.data.synthetic import synthetic_case
from mri_raytracer_tpu_torch.ops import composite
from mri_raytracer_tpu_torch.ops import shearwarp as sw
from mri_raytracer_tpu_torch.render import params as rp
from mri_raytracer_tpu_torch.render.camera import OrbitalCamera

torch.set_num_threads(2)
SHAPE = (40, 36, 32)
TI, TJ = composite.TILE_I, composite.TILE_J

# id: theta, phi, O, crop, near, far, gamma, pred rows (the 'rebake' case)
CASES = {
    "axis0": (0.7, 1.1, 128, False, 0.0, 0.0, 1.0, False),
    "axis2-rebake-ragged120": (4.2, 2.2, 120, False, 0.0, 0.0, 1.3, True),
    "axis1-crop-near": (1.9, 0.4, 128, True, 0.5, 0.0, 1.0, False),
    "crop-near-far-ragged96": (2.1, 0.7, 96, True, 0.3, 3.2, 1.0, True),
    "axis1-ragged112": (0.3, 0.12, 112, False, 0.0, 0.0, 1.0, False),
    "direct-O32": (0.7, 1.1, 32, False, 0.0, 0.0, 1.0, False),
}


@pytest.fixture(scope="module")
def scene():
    mods, seg = synthetic_case(SHAPE, seed=3)
    disp = np.stack([percentile_normalize(m) for m in mods])
    seg = seg.astype(np.int32)
    # A prediction that differs from the seg: the rebake case's second row
    # overlay.
    pred = np.roll(seg, 3, axis=0)
    return disp, seg, pred


def _inputs(scene, case):
    theta, phi, O, crop, near, far, gamma, pred = CASES[case]
    disp, seg, pred_vol = scene
    p = rp.default_render_params(SHAPE, show_seg=True, show_pred=pred,
                                 gamma=gamma, near=near, far=far)
    basis = OrbitalCamera(radius=rp.default_camera_radius(p, SHAPE),
                          theta=theta, phi=phi).basis()
    axis = sw.dominant_axis(basis)
    mixed, seg_s, pred_s = sw.prepare_sweep_volumes(
        torch.from_numpy(disp), torch.from_numpy(seg),
        torch.from_numpy(pred_vol) if pred else None, p, axis)
    kw = {}
    if crop:  # k slab + in-plane crop: local clamp bounds outside [0, N)
        nk, na, nb = mixed.shape
        cut = (slice(3, nk - 5), slice(4, na - 2), slice(2, nb - 6))
        mixed, seg_s = mixed[cut].contiguous(), seg_s[cut].contiguous()
        pred_s = None if pred_s is None else pred_s[cut].contiguous()
        kw = dict(z_offset=3, nk_global=nk, ab_offset=(4, 2),
                  inplane_global=(na, nb))
    geom = sw.content_geometry(basis, p, tuple(mixed.shape), axis, O, 96, 80,
                               **kw)
    k1 = composite.stage1(mixed, seg_s, pred_s, geom, p, axis, O,
                          kw.get("z_offset"), kw.get("nk_global"))
    use_gamma, use_clip = sw.static_flags(p)
    Na = k1.t1b.shape[1]
    tiles = composite.tile_planes_plain(k1.pp, k1.scalars, Na, O, use_clip,
                                        has_rows=True)
    return k1, (use_gamma, use_clip), tiles, O


def _tile(t, ti, tj):
    """The (rows, columns) of tile (ti, tj) of an (..., O, O) tensor."""
    return t[..., ti * TI:(ti + 1) * TI, tj * TJ:(tj + 1) * TJ]


@pytest.mark.parametrize("case", list(CASES))
def test_culled_planes_hold_no_composited_pixel(scene, case):
    """No (tile, plane) pair the rule culls holds a pixel the plain
    compositor composites, and every tap of a running tile lies in its
    a-row window."""
    k1, flags, tiles, O = _inputs(scene, case)
    acts = {}
    plain = composite.composite_planes_plain(
        *k1, *flags, on_plane=lambda m, act: acts.__setitem__(m, act.clone()))
    K, Na = k1.t1b.shape[:2]
    act = torch.stack([acts[m] for m in range(K)])  # (K, O, O)
    nI, nJ = tiles.run.shape[:2]
    assert (nI, nJ) == (-(-O // TI), -(-O // TJ))
    for ti in range(nI):
        for tj in range(nJ):
            hit = _tile(act, ti, tj).flatten(1).any(1)  # (K,)
            assert not bool((hit & ~tiles.run[ti, tj]).any()), (ti, tj)
    assert int(plain.n_active) > 0
    # The rule culls something and lets through every plane that composites.
    assert not bool(tiles.run.all())

    (_, _, _, _, _, _, _, _, _, _, acl, ach, acn, _, _, _) = k1.scalars
    off_a, sc_a = k1.pp[:, 0], k1.pp[:, 1]
    i = torch.arange(O, dtype=torch.float32)[:, None]
    pos_a = off_a + i * sc_a  # (O, K), rounded as the plain version's
    a0 = torch.floor(torch.clamp(pos_a, acl, ach)).long()
    an = torch.round(torch.clamp(pos_a, acl, acn)).long()
    band = torch.arange(O) // TI
    lo, hi = tiles.a_lo[band], tiles.a_hi[band]  # (O, K)
    runs = tiles.run.any(1)[band]  # the band's row runs plane m somewhere
    for tap in (a0, a0 + 1, an):
        inside = (tap >= 0) & (tap < Na) & runs
        assert bool(((tap >= lo) & (tap <= hi))[inside].all())


@pytest.mark.parametrize("case", list(CASES))
def test_culled_planes_change_nothing(scene, case):
    """The plain compositor with each tile's culled planes switched off
    (own = 0) gives that tile's C, T and executed-plane map bit for bit."""
    k1, flags, tiles, O = _inputs(scene, case)
    ref = composite.composite_planes_plain(*k1, *flags)
    nI, nJ = tiles.run.shape[:2]
    culled = 0
    for ti in range(nI):
        for tj in range(nJ):
            off = ~tiles.run[ti, tj]
            culled += int(off.sum())
            pp = k1.pp.clone()
            pp[off, 5] = 0.0
            out = composite.composite_planes_plain(
                *k1._replace(pp=pp), *flags)
            for a, b in ((out.C, ref.C), (out.T, ref.T),
                         (out.planes, ref.planes)):
                assert torch.equal(_tile(a.movedim(-1, 0) if a.dim() == 3
                                         else a, ti, tj),
                                   _tile(b.movedim(-1, 0) if b.dim() == 3
                                         else b, ti, tj)), (ti, tj)
    assert culled > 0


@pytest.mark.parametrize("case,over", [("axis0", "some"),
                                       ("axis1-crop-near", "none"),
                                       ("direct-O32", "most")])
def test_windows_over_capacity_take_the_direct_path(scene, case, over):
    """Which running (tile, plane) windows exceed the WIN_ROWS a stage holds
    (|sc_a| > 1; the kernel loads those planes directly): some at O = 128
    on a near pose, none on another, most at O = 32 (a band's window
    clipped to [0, Na) may still fit)."""
    _, _, tiles, _ = _inputs(scene, case)
    runs = tiles.run.any(1)  # (nI, K)
    tall = (tiles.a_hi - tiles.a_lo + 1 > composite.WIN_ROWS)[runs]
    assert tall.numel() > 0
    assert {"none": not bool(tall.any()),
            "some": bool(tall.any()) and not bool(tall.all()),
            "most": float(tall.float().mean()) > 0.5}[over]
