#!/usr/bin/env python3
"""The two PyTorch operations that set the ROI policy renderer's pace on
the card, each against the form ``ops/trilinear._rows`` and
``ops/diffrender.cumprod_last`` use, at a 1920 x 1080 fine block (32
samples a ray) of the ``[roi]`` phase's tumor-a scene:

  * the 8-channel row gather of ``trilinear_sample_packed``
    (``index_select`` on (N, 8) float32 rows against one ``take`` of
    complex128 elements, 2 a row);
  * the compositor's transmittance scan (``torch.cumprod`` along the
    innermost axis of 32 samples against the scan with that axis moved
    first).

    python3 tools/roi_ops_bench.py      # needs one CUDA card, ~1 min

Prints CUDA-event means over 5 calls (after one warm call) and whether each
pair agrees bit for bit, with the card's name and power limit.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from mri_raytracer_tpu_torch.env import power_limit
    from mri_raytracer_tpu_torch.eval import roi_protocol as rpt
    from mri_raytracer_tpu_torch.ops import roi_policy, trilinear
    from mri_raytracer_tpu_torch.ops.diffrender import cumprod_last
    from mri_raytracer_tpu_torch.render.camera import unpack_basis

    dev = torch.device("cuda")
    sc = rpt.build_scenes((96, 96, 80), device=dev)[0]
    p = sc["params"]
    bv = torch.as_tensor(rpt.make_orbit_views(sc["radius"], 1)[0]).to(dev)

    def ms(fn, n=5):
        out = fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n, out

    with torch.no_grad():
        ro, rd, t0, t1, valid, bmin = roi_policy._ray_setup(
            unpack_basis(bv), p, trilinear._dims((96, 96, 80), dev), 1920,
            1080)
        k = torch.arange(32, dtype=torch.float32, device=dev) + 0.5
        tk = t0[..., None] + (k / 64) * (t1 - t0)[..., None]
        pidx = (ro[..., None, :] + tk[..., None] * rd[..., None, :] - bmin) \
            / p.voxel_size
        q = torch.minimum(torch.maximum(pidx, pidx.new_zeros(())),
                          trilinear._dims((96, 96, 80), dev) - 1.001)
        i = torch.floor(q).to(torch.int32)
        idx = ((i[..., 0] * 96 + i[..., 1]) * 80 + i[..., 2]).reshape(-1)
        flat = sc["mixed_p"].reshape(-1, 8)
        t_sel, a = ms(lambda: flat.index_select(0, idx))
        t_take, b = ms(lambda: trilinear._rows(flat, idx))
        print(f"row gather of {idx.numel()} rows of 8 float32: index_select "
              f"{t_sel:.3f} ms, complex128 take {t_take:.3f} ms, bit-equal "
              f"{torch.equal(a, b)}")
        x = 1.0 - torch.rand(tk.shape, device=dev,
                             generator=torch.Generator(dev).manual_seed(0))
        t_in, a = ms(lambda: torch.cumprod(x, -1))
        t_out, b = ms(lambda: cumprod_last(x))
        print(f"cumprod over {tuple(x.shape)}: innermost axis {t_in:.3f} ms, "
              f"moved first {t_out:.3f} ms, max|diff| "
              f"{float((a - b).abs().max()):.3e}")
    print(f"on {torch.cuda.get_device_name(0)} ({power_limit()})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
