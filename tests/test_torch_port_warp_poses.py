"""K2's plain version, the function the CUDA kernel is held to, against the
JAX package's gather warp (``shearwarp.warp_to_screen``) at poses where the
warp's maps are hard, on the CPU.

The port's side goes through the wrapper ``warp.warp_screen``, which runs
``warp_screen_plain`` for CPU tensors. Random poses (seed 0): eyes outside
and inside the volume, wide fields of view whose rays graze the base plane
(the ray's sweep component near 0) or meet it behind the eye, all three
sweep axes (the dominant one and forced others), base planes mirrored
about the eye (every hit behind it), O in {2, 17, 128}, screens that are no multiple of K2's 32 x 16 tile. Tolerance atol 1e-5,
that of ``tests/test_torch_port_shearwarp.py``'s warp test: the same gather
over the same intermediate in float32."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_raytracer_tpu.ops import shearwarp as jsw
from mri_raytracer_tpu.render import params as jrp
from mri_raytracer_tpu.render.camera import OrbitalCamera as JCam
from mri_raytracer_tpu_torch.ops import shearwarp as tsw
from mri_raytracer_tpu_torch.ops import warp
from mri_raytracer_tpu_torch.render import params as trp
from mri_raytracer_tpu_torch.render.camera import OrbitalCamera as TCam

torch.set_num_threads(2)
SHAPE = (40, 36, 32)
N_POSES = 25
SCREENS = ((97, 61), (130, 47), (64, 50), (33, 100))
KINDS = ("outside", "inside", "wide", "forced-axis", "mirrored")
BG = (0.1, 0.0, 0.3)


def _pose(n: int):
    """Pose n of the random set: (kind, O, width, height, axis, and the JAX
    and the port's params, camera basis and sweep geometry)."""
    rng = np.random.default_rng([0, n])
    kind = KINDS[n % len(KINDS)]
    pj = jrp.default_render_params(SHAPE, bg_color=BG)
    pt = trp.default_render_params(SHAPE, bg_color=BG)
    radius = jrp.default_camera_radius(pj, SHAPE) * (
        rng.uniform(0.05, 0.5) if kind == "inside" else rng.uniform(0.8, 3.0))
    fov = rng.uniform(100.0, 160.0) if kind == "wide" else 55.0
    cam = dict(radius=radius, theta=rng.uniform(0.0, 2 * math.pi),
               phi=rng.uniform(0.05, math.pi - 0.05),
               fov_y=math.radians(fov), min_radius=0.01)
    bj, bt = JCam(**cam).basis(), TCam(**cam).basis()
    axis = jsw.dominant_axis(bj)
    if kind == "forced-axis":
        axis = (axis + 1 + n // 5 % 2) % 3
    O = (2, 17, 128)[n % 3]
    width, height = SCREENS[n % len(SCREENS)]
    dims = tuple(SHAPE[o] for o in tsw._ORDER[axis])
    gj = jsw.content_geometry(bj, pj, dims, axis, O, width, height)
    gt = tsw.content_geometry(bt, pt, dims, axis, O, width, height)
    if kind == "mirrored":  # w_base - e_k -> -(w_base - e_k)
        gj = gj._replace(w_base=2 * gj.e[0] - gj.w_base)
        gt = gt._replace(w_base=2 * gt.e[0] - gt.w_base)
    return kind, O, width, height, axis, (pj, bj, gj), (pt, bt, gt)


@pytest.mark.parametrize("n", range(N_POSES),
                         ids=[f"{KINDS[n % len(KINDS)]}-{n}"
                              for n in range(N_POSES)])
def test_k2_plain_matches_jax_gather_at_hard_poses(n):
    _, O, width, height, axis, (pj, bj, gj), (pt, bt, gt) = _pose(n)
    C = np.random.default_rng([1, n]).random((O, O, 3)).astype(np.float32)
    img_j = np.asarray(jsw.warp_to_screen(jnp.asarray(C), gj, bj, axis,
                                          width, height,
                                          jnp.asarray(pj.bg_color)))
    s = tsw.warp_scalars(gt, bt.to("cpu"), pt.bg_color)
    before = warp.warp_screen.launches
    img_t = warp.warp_screen(torch.from_numpy(C), s, axis, width, height)
    assert warp.warp_screen.launches == before  # the plain version ran
    assert img_t.shape == (height, width, 3)
    np.testing.assert_allclose(img_t.numpy(), img_j, atol=1e-5)
    # Off the intermediate the frame is the background, exactly.
    _, _, valid = warp.screen_maps(s, axis, O, width, height)
    np.testing.assert_array_equal(img_t[~valid].numpy(),
                                  np.broadcast_to(np.float32(BG),
                                                  (int((~valid).sum()), 3)))


def test_hard_poses_reach_the_hard_cases():
    """The random set reaches rays that graze the base plane, rays that
    meet it behind the eye, eyes inside the volume, all three axes, every
    O, and screens both partly and wholly off the intermediate."""
    seen = {"graze": 0, "behind": 0, "inside": 0, "some valid": 0,
            "none valid": 0}
    axes, sizes = set(), set()
    for n in range(N_POSES):
        kind, O, width, height, axis, _, (pt, bt, gt) = _pose(n)
        s = tsw.warp_scalars(gt, bt.to("cpu"), pt.bg_color)
        f = 1.0 / torch.tan(0.5 * s[12])
        xs = (torch.arange(width) + 0.5) / width * 2.0 - 1.0
        ys = (torch.arange(height) + 0.5) / height * 2.0 - 1.0
        dk = (xs * (width / height) / f)[None, :] * s[3 + axis] \
            + (-ys / f)[:, None] * s[6 + axis] + s[9 + axis]
        seen["graze"] += bool((dk.abs() < 1e-2).any())
        seen["behind"] += bool(((s[13] - s[14]) * dk <= 0).any())
        seen["inside"] += kind == "inside"
        _, _, valid = warp.screen_maps(s, axis, O, width, height)
        seen["some valid"] += bool(valid.any())
        seen["none valid"] += not bool(valid.any())
        axes.add(axis)
        sizes.add(O)
    assert min(seen.values()) >= 1, seen
    assert axes == {0, 1, 2} and sizes == {2, 17, 128}


def test_stream_handle_falls_back_to_the_public_call(monkeypatch):
    """Where a torch build lacks the private raw-stream call, K2's launch
    takes the handle from ``torch.cuda.current_stream``; where it has it,
    from the private call, for the device asked."""

    class Stream:
        cuda_stream = 1234

    asked = []
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda index: asked.append(index) or Stream())
    monkeypatch.delattr(torch._C, "_cuda_getCurrentRawStream", raising=False)
    assert warp.current_stream_handle(1) == 1234 and asked == [1]
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 5678 + index, raising=False)
    assert warp.current_stream_handle(2) == 5680 and asked == [1]
