"""Rank processes of the port's parallel tests (``tests/test_torch_port_
parallel*.py``), and the parent's handle on them.

Each test module spawns ``WORLD`` ranks once (``Ranks``): every rank runs
one suite of cases on the CPU over a gloo process group and writes its
outputs to ``out_<rank>.npz``; the tests then compare. A rank imports
torch and the port only, never JAX. Rendezvous goes through a file under
the test's temporary directory (no TCP port for parallel test workers to
race for), and every wait has a limit: the process group's timeout, and
the parent's deadline, on which it kills the ranks.

    python tests/torch_parallel_worker.py SUITE RANK WORLD DIR
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
PG_TIMEOUT = 120.0  # seconds, every collective and the rendezvous
DEADLINE = 600.0  # seconds, the whole spawn


def obj(x) -> np.ndarray:
    """``x`` (any picklable value) as a 0-d object array for an ``.npz``;
    ``[()]`` gives it back."""
    a = np.empty((), dtype=object)
    a[()] = x
    return a


class Ranks:
    """``WORLD`` rank processes running ``suite`` on ``inputs`` (saved to
    ``tmp / "in.npz"``); ``result()`` waits for them and returns each
    rank's outputs."""

    def __init__(self, suite: str, tmp: pathlib.Path, inputs: dict):
        self.tmp = pathlib.Path(tmp)
        np.savez(self.tmp / "in.npz", **inputs)
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("XLA_", "JAX_"))}
        env["PYTHONPATH"] = os.pathsep.join(
            [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        env["OMP_NUM_THREADS"] = "1"
        self.logs = [self.tmp / f"rank{r}.log" for r in range(WORLD)]
        self.procs = []
        for r in range(WORLD):
            with open(self.logs[r], "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, __file__, suite, str(r), str(WORLD),
                     str(self.tmp)], cwd=REPO, env=env, stdout=log,
                    stderr=subprocess.STDOUT))
        self.started = time.monotonic()
        self._out = None

    def result(self):
        if self._out is None:
            try:
                for p in self.procs:
                    left = DEADLINE - (time.monotonic() - self.started)
                    p.communicate(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired:
                self.close()
                raise AssertionError(f"ranks still running after "
                                     f"{DEADLINE} s:\n" + self._tails())
            bad = [r for r, p in enumerate(self.procs) if p.returncode]
            if bad:
                raise AssertionError(f"ranks {bad} failed:\n" + self._tails())
            self._out = []
            for r in range(WORLD):
                with np.load(self.tmp / f"out_{r}.npz",
                             allow_pickle=True) as z:
                    self._out.append({k: z[k] for k in z.files})
        return self._out

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)

    def _tails(self) -> str:
        return "\n".join(f"--- rank {r}\n" + log.read_text()[-3000:]
                         for r, log in enumerate(self.logs))


# ----------------------------------------------------------------- the ranks
def _join(tmp: pathlib.Path, store: str, world: int, rank: int) -> None:
    from mri_raytracer_tpu_torch.parallel import mesh

    mesh.initialize_distributed(str(tmp / store), world, rank,
                                device="cpu", timeout=PG_TIMEOUT)


def _mesh_record(out: dict, tag: str, m) -> None:
    import torch

    for name in ("data", "space"):
        ax = m.axis(name)
        out[f"{tag}/{name}"] = np.array([ax.index, ax.size])
        rank = torch.tensor([float(m.rank)])
        out[f"{tag}/{name}_sum"] = ax.all_reduce_sum(rank).numpy()
        out[f"{tag}/{name}_gather"] = torch.cat(
            ax.all_gather(torch.tensor([m.rank]))).numpy()


def _dp_steps(inp, m, out: dict, prefix: str) -> None:
    """``steps`` DP steps of ``accum`` micro-batches on mesh ``m``: rank
    (d, s) takes batch (step, d, micro) of the table."""
    import torch

    from mri_raytracer_tpu_torch import convert
    from mri_raytracer_tpu_torch.config import (LossConfig, ModelConfig,
                                                OptimConfig)
    from mri_raytracer_tpu_torch.data.sampling import SampleBatch
    from mri_raytracer_tpu_torch.io import checkpoint as ckpt
    from mri_raytracer_tpu_torch.parallel import training
    from mri_raytracer_tpu_torch.train import optimizers

    steps_n, dp, accum = (int(v) for v in inp["dp_shape"])
    d = m.axis("data").index
    model, tp = convert.inr_params_from_numpy(
        inp["dp_tree"][()], ModelConfig(**inp["dp_model"][()]))
    table = [inp[f"dp_{k}"] for k in ("coords", "intens", "labels",
                                      "weights")]
    drawn = iter([(s, a) for s in range(steps_n) for a in range(accum)])

    def sampler(g, mods, segs, params=None, boundary=None):
        s, a = next(drawn)
        i = (s * dp + d) * accum + a
        return SampleBatch(*(torch.from_numpy(t[i]) for t in table))

    opt = optimizers.build_optimizer(OptimConfig(**inp["dp_optim"][()]),
                                     steps_n, tp)
    step = training.build_dp_train_step(model, LossConfig(), opt, sampler,
                                        accum, dp, mesh=m)
    key = torch.Generator().manual_seed(0)
    pool = torch.zeros((1, 4, 2, 2, 2))
    segs = torch.zeros((1, 2, 2, 2), dtype=torch.int32)
    for s in range(steps_n):
        mt = step(tp, opt, key, pool, segs, s + 1)
        for f in mt._fields:
            out[f"{prefix}/{s}/{f}"] = getattr(mt, f).numpy()
    out[f"{prefix}/params"] = obj(ckpt.params_to_numpy(tp))


def _stripe(inp, m, case: str):
    from mri_raytracer_tpu_torch.parallel import render
    from mri_raytracer_tpu_torch.render import params as rp
    from mri_raytracer_tpu_torch.render.camera import OrbitalCamera

    mods, seg = inp[f"{case}/mods"], inp[f"{case}/seg"]
    theta, phi, size, out_res = inp[f"{case}/pose"]
    shape = mods.shape[1:]
    p = rp.default_render_params(shape, show_seg=True)
    cam = OrbitalCamera(radius=rp.default_camera_radius(p, shape),
                        theta=float(theta), phi=float(phi))
    r = render.build_sharded_renderer(m, shape, int(size), int(size),
                                      out_res=int(out_res), has_seg=True,
                                      device="cpu")
    return r(mods, seg, None, cam.basis(), p).numpy()


def suite_train(rank: int, world: int, tmp: pathlib.Path, inp) -> dict:
    import torch
    import torch.distributed as dist

    from mri_raytracer_tpu_torch.config import TrainConfig
    from mri_raytracer_tpu_torch.parallel import mesh
    from mri_raytracer_tpu_torch.train import engine

    out = {}
    _join(tmp, "store", world, rank)
    m22 = mesh.make_mesh(2, 2)
    m14 = mesh.make_mesh(1, 4)
    _mesh_record(out, "m22", m22)
    _mesh_record(out, "m14", m14)
    try:
        mesh.make_mesh(4, 2)
    except ValueError as e:
        out["too_big"] = np.array(str(e))
    x = torch.arange(32).reshape(4, 8)
    out["local/data0"] = mesh.data_sharded(m22, 0).local(x).numpy()
    out["local/space1"] = mesh.space_sharded(m14, 1).local(x).numpy()
    out["local/replicated"] = mesh.replicated(m22).local(x).numpy()

    # The DP step over 'data' and a stripe render over 'space' of one mesh.
    _dp_steps(inp, m22, out, "dp")
    out["combined/img"] = _stripe(inp, m22, "combined")

    # train_inr: data_parallel must be the group's size, then a 2-rank run.
    cfg = TrainConfig.from_dict(inp["tr_config"][()])
    try:
        engine.train_inr(cfg, device="cpu")
    except ValueError as e:
        out["tr/refused"] = np.array(str(e))
    dist.destroy_process_group()
    if rank < cfg.data_parallel:
        _join(tmp, "store_dp", cfg.data_parallel, rank)
        state = engine.train_inr(cfg, device="cpu")
        out["tr/loss"] = np.array([h["loss"] for h in state["history"]])
        out["tr/params"] = obj([p.detach().numpy()
                                for p in state["params"].parameters()])
        dist.destroy_process_group()
    return out


def suite_render(rank: int, world: int, tmp: pathlib.Path, inp) -> dict:
    import torch
    import torch.distributed as dist

    from mri_raytracer_tpu_torch.ops import shearwarp as sw
    from mri_raytracer_tpu_torch.parallel import mesh, render
    from mri_raytracer_tpu_torch.render import params as rp
    from mri_raytracer_tpu_torch.render.camera import OrbitalCamera

    out = {}
    _join(tmp, "store", world, rank)
    m = mesh.make_mesh(1, 4)
    for case in ("s64", "s70", "s128"):
        out[f"{case}/img"] = _stripe(inp, m, case)
    mods, seg = inp["slab/mods"], inp["slab/seg"]
    shape = mods.shape[1:]
    p = rp.default_render_params(shape, show_seg=True)
    use_gamma, use_clip = sw.static_flags(p)
    for theta in inp["slab/thetas"]:
        cam = OrbitalCamera(radius=rp.default_camera_radius(p, shape),
                            theta=float(theta), phi=1.1)
        basis = cam.basis()
        axis = sw.dominant_axis(basis)
        mixed_s, seg_s, _ = sw.prepare_sweep_volumes(
            torch.from_numpy(mods), torch.from_numpy(seg), None, p, axis)
        r = render.build_volume_sharded_renderer(m, shape, 64, 64, axis,
                                                 out_res=64, has_seg=True,
                                                 device="cpu")
        place = mesh.space_sharded(m, 0)
        out[f"slab/{theta}/img"] = r(place.local(mixed_s),
                                     place.local(seg_s), basis.pack(),
                                     p).numpy()
        if rank == 0:
            geom = sw.sweep_geometry(basis, p, tuple(mixed_s.shape), axis,
                                     64, frustum_wh=(64, 64))
            C, _ = sw.sweep_composite(mixed_s, seg_s, None, geom, p, axis,
                                      64, 1, use_gamma, use_clip,
                                      term_gate=False)
            out[f"slab/{theta}/single"] = sw.warp_to_screen(
                C, geom, basis, axis, 64, 64, p.bg_color).numpy()
            out[f"slab/{theta}/axis"] = np.array(axis)
    dist.destroy_process_group()
    return out


def main(argv) -> int:
    suite, rank, world, tmp = argv[1], int(argv[2]), int(argv[3]), \
        pathlib.Path(argv[4])
    import torch

    torch.set_num_threads(1)
    with np.load(tmp / "in.npz", allow_pickle=True) as z:
        inp = {k: z[k] for k in z.files}
    out = {"suite_train": suite_train,
           "suite_render": suite_render}[f"suite_{suite}"](rank, world, tmp,
                                                             inp)
    np.savez(tmp / f"out_{rank}.npz", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
