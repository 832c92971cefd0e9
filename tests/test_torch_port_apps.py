"""The port's BraTS front ends and the small modules behind them, against
the JAX package, on the CPU: presets, the NIfTI codec and case loader, the
checkpoint writer, the PNG encoder, the FPS meter and timer, the viewer CLI
(``apps/brats_app.py``) and the HTTP frame server (``apps/serve.py``).

Tolerances: bit-equality for host numpy code (presets, NIfTI, load_case,
PNG, FPSMeter/Timer); rtol/atol 1e-5 for logits of a port-written
checkpoint in the JAX model (float32 matmuls summed in another order); 1
level of 255 for the apps' PNGs: the frames agree to the 3e-3 bar of
tests/test_torch_port_renderer.py, which can move a pixel across one
8-bit rounding step and no further."""

import dataclasses
import io
import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mri_raytracer_tpu.apps import brats_app as japp, serve as jserve
from mri_raytracer_tpu.config import ModelConfig as JCfg
from mri_raytracer_tpu.data import brats as jbrats, nifti as jnifti
from mri_raytracer_tpu.data import synthetic as jsyn
from mri_raytracer_tpu.io import checkpoint as jckpt
from mri_raytracer_tpu.models.api import build_model as jbuild
from mri_raytracer_tpu.render import params as jrp, presets as jpresets
from mri_raytracer_tpu.render.brats import BratsRenderer as JRenderer
from mri_raytracer_tpu.utils import profiling as jprof
from mri_raytracer_tpu_torch.apps import brats_app as tapp, serve as tserve
from mri_raytracer_tpu_torch.config import ModelConfig as TCfg
from mri_raytracer_tpu_torch.data import brats as tbrats, nifti as tnifti
from mri_raytracer_tpu_torch.data import synthetic as tsyn
from mri_raytracer_tpu_torch.io import checkpoint as tckpt, png
from mri_raytracer_tpu_torch.models.api import build_model as tbuild
from mri_raytracer_tpu_torch.render import params as trp, presets as tpresets
from mri_raytracer_tpu_torch.utils import profiling as tprof

torch.set_num_threads(2)
SHAPE = (24, 24, 20)
APP_FLAGS = ["--width", "64", "--height", "64", "--frames", "2", "--backend",
             "sweep"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """One JAX-written BraTS-layout case at SHAPE (label 4 on disk)."""
    root = tmp_path_factory.mktemp("brats")
    jsyn.write_synthetic_dataset(root, num_cases=1, shape=SHAPE, seed=0)
    return root


def _read_png(data) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def test_presets_match_jax():
    assert tpresets.preset_names() == jpresets.preset_names()
    pj = jrp.default_render_params(SHAPE)
    pt = trp.default_render_params(SHAPE)
    for name in jpresets.preset_names():
        aj = jpresets.apply_preset(pj, name)
        at = tpresets.apply_preset(pt, name)
        for f in at._fields:
            np.testing.assert_array_equal(getattr(at, f).numpy(),
                                          np.asarray(getattr(aj, f)),
                                          err_msg=f"{name}.{f}")
    with pytest.raises(KeyError):
        tpresets.apply_preset(pt, "nosuch")


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
def test_nifti_round_trips(tmp_path, suffix):
    rng = np.random.default_rng(0)
    aff = np.diag([1.0, 1.2, 0.9, 1.0])
    aff[:3, 3] = (-10.0, 4.0, 2.5)
    for dt in (np.uint8, np.int16, np.int32, np.float32, np.float64,
               np.int8, np.uint16):
        data = (rng.normal(0, 50, (5, 4, 3)) + 60).astype(dt)
        for i, (save, load) in enumerate([
                (tnifti.save, tnifti.load), (jnifti.save, tnifti.load),
                (tnifti.save, jnifti.load)]):
            path = tmp_path / f"v{i}_{np.dtype(dt).name}{suffix}"
            save(path, data, aff)
            img = load(path)
            assert img.data.dtype == data.dtype
            np.testing.assert_array_equal(img.data, data)
            np.testing.assert_array_equal(img.affine, jnifti.load(path).affine)
            assert img.pixdim == pytest.approx((1.0, 1.2, 0.9))


def test_load_case_matches_jax(dataset, tmp_path):
    tcases, jcases = tbrats.find_cases(dataset), jbrats.find_cases(dataset)
    assert tcases == jcases and len(tcases) == 1
    case = tcases[0]
    for norm in ("none", "zscore_nonzero", "percentile"):
        mt, st = tbrats.load_case(case, normalization=norm)
        mj, sj = jbrats.load_case(case, normalization=norm)
        np.testing.assert_array_equal(mt, mj)
        np.testing.assert_array_equal(st, sj)
        assert st.dtype == sj.dtype == np.int16
    assert st.max() == 3  # label 4 on disk, remapped
    raw = tnifti.load(case / f"{case.name}-seg.nii.gz").data
    assert raw.max() == 4
    assert tbrats.load_case_dict(case)["name"] == case.name
    seg_path = case / f"{case.name}-seg.nii.gz"
    np.testing.assert_array_equal(tbrats.load_seg_volume(seg_path),
                                  jbrats.load_seg_volume(seg_path))
    for a, b in zip(tbrats.load_display_volume(case / f"{case.name}-t1n.nii.gz"),
                    jbrats.load_display_volume(case / f"{case.name}-t1n.nii.gz")):
        np.testing.assert_array_equal(a, b)
    # The port's writer, read by JAX.
    tsyn.write_synthetic_dataset(tmp_path, num_cases=1, shape=(9, 8, 7),
                                 seed=4)
    c = jbrats.find_cases(tmp_path)[0]
    for x, y in zip(jbrats.load_case(c), tbrats.load_case(c)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(tsyn.synthetic_u8_volume((9, 8, 7), 2),
                                  jsyn.synthetic_u8_volume((9, 8, 7), 2))


def test_checkpoint_written_by_port_loads_in_jax(tmp_path):
    cfg = dict(hidden_dims=(16, 16), fourier_freqs=4)
    tm = tbuild(TCfg(**cfg), num_modalities=4)
    tp = tm.init(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(1)
    coords = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    intens = rng.normal(0, 1, (300, 4)).astype(np.float32)
    with torch.no_grad():
        want = tm.apply(tp, torch.from_numpy(coords),
                        torch.from_numpy(intens)).numpy()
    jm = jbuild(JCfg(**cfg), num_modalities=4)

    path = tmp_path / "inr.npz"
    tckpt.save_object(tp, path, info={"model": dataclasses.asdict(TCfg(**cfg))})
    jp, info = jckpt.model_load(path)
    assert JCfg(**{k: tuple(v) if isinstance(v, list) else v
                   for k, v in info["model"].items()}) == JCfg(**cfg)
    got = np.asarray(jm.apply(jp, jnp.asarray(coords), jnp.asarray(intens)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    flat = tmp_path / "flat.npz"
    tckpt.save_flat(tp, flat)
    jp2 = jckpt.load_params(flat)
    got2 = np.asarray(jm.apply(jp2, jnp.asarray(coords), jnp.asarray(intens)))
    np.testing.assert_allclose(got2, want, rtol=1e-5, atol=1e-5)
    # The same pytree either way, and the port reads both back.
    ref = tckpt.params_to_numpy(tp)
    for tree in (jp, jp2, tckpt.load_params(path), tckpt.load_params(flat)):
        assert jax.tree_util.tree_structure(tree) == \
            jax.tree_util.tree_structure(ref)
        for a, b in zip(jax.tree_util.tree_leaves(tree),
                        jax.tree_util.tree_leaves(ref)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("h,w", [(1, 1), (7, 13), (64, 48)])
def test_png_decodes_with_pil(h, w):
    rgb = np.random.default_rng(h).integers(0, 256, (h, w, 3), np.uint8)
    np.testing.assert_array_equal(_read_png(png.encode_png(rgb)), rgb)
    with pytest.raises(ValueError):
        png.encode_png(rgb.astype(np.float32))
    img = np.linspace(-0.2, 1.2, 3 * 4 * 5, dtype=np.float32).reshape(3, 4, 5)
    np.testing.assert_array_equal(
        png.to_rgb8(img[..., :3]),
        (np.clip(img[..., :3], 0, 1) * 255).astype(np.uint8))


def test_fps_meter_and_timer_match_jax(monkeypatch):
    clock = iter([0.0, 0.1, 0.15, 0.4, 0.41] * 2)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    rates = []
    for mod in (tprof, jprof):
        m = mod.FPSMeter(alpha=0.2)
        rates.append([m.tick() for _ in range(5)])
    assert rates[0] == rates[1] and rates[0][-1] > 0


def _frames(out_dir):
    files = sorted(out_dir.glob("frame_*.png"))
    return [np.asarray(Image.open(f)).astype(np.int16) for f in files]


@pytest.mark.parametrize("variant", ["synthetic", "case-dir+preset"])
def test_viewer_matches_jax_app(dataset, tmp_path, variant):
    """The port's viewer CLI and the JAX one, same flags: two 64^2 PNGs
    each, within one 8-bit level. The second variant reads the NIfTI case
    and applies a preset (gamma 1, so the JAX side reuses its compiled
    frames)."""
    if variant == "synthetic":
        flags = ["--synthetic", "--synthetic-shape", "24,24,20"]
    else:
        case = jbrats.find_cases(dataset)[0]
        flags = ["--case-dir", str(case), "--preset", "t1-anatomy"]
    assert japp.main(flags + APP_FLAGS + ["--out", str(tmp_path / "j")]) == 0
    assert tapp.main(flags + APP_FLAGS + ["--out", str(tmp_path / "t"),
                                          "--device", "cpu"]) == 0
    fj, ft = _frames(tmp_path / "j"), _frames(tmp_path / "t")
    assert len(fj) == len(ft) == 2
    for a, b in zip(fj, ft):
        assert a.shape == b.shape == (64, 64, 3)
        assert int(np.abs(a - b).max()) <= 1
        assert a.max() > 0


def test_viewer_flags():
    with pytest.raises(SystemExit):  # a JAX backend name is refused
        tapp.main(["--backend", "sweep_pallas"])
    with pytest.raises(SystemExit):  # mode 2 needs a checkpoint
        tapp.main(["--neural-march", "--device", "cpu"])


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.headers, r.read()


def test_server_matches_jax(dataset):
    case = jbrats.find_cases(dataset)[0]
    service = tserve.build_service(str(case), size=64, device="cpu")
    srv = tserve.make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        status, hdr, body = _get(base + "/")
        assert status == 200 and hdr["Content-Type"].startswith("text/html")
        assert b"<option>t1-anatomy</option>" in body
        status, _, body = _get(base + "/info")
        info = json.loads(body)
        assert status == 200 and info["backend"] == "cpu"
        assert (info["renderer"], info["width"], info["height"]) == \
            ("sweep", 64, 64)
        assert info["has_seg"] and not info["has_pred"]
        query = "theta=0.9&phi=1.1&preset=t1-anatomy&alpha=0.5"
        status, hdr, body = _get(base + "/frame?" + query)
        assert status == 200 and hdr["Content-Type"] == "image/png"
        assert hdr["Server-Timing"].startswith("render;dur=")
        got = _read_png(body).astype(np.int16)
        for path, code in (("/nope", 404), ("/frame?preset=nosuch", 500)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(base + path)
            assert e.value.code == code
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    # The JAX service on the same case, as its main builds it.
    mods, seg = jbrats.load_case(case, normalization="none")
    disp = np.stack([jbrats.percentile_normalize(m) for m in mods])
    p = jrp.default_render_params(SHAPE, show_seg=True, show_pred=False)
    rj = JRenderer(jnp.asarray(disp), jnp.asarray(seg.astype(np.int32)),
                   None, width=64, height=64)
    js = jserve.RenderService(rj, p, jrp.default_camera_radius(p, SHAPE))
    want = _read_png(js.frame_png(urllib.parse.parse_qs(query)))
    assert got.shape == want.shape == (64, 64, 3)
    assert int(np.abs(got - want.astype(np.int16)).max()) <= 1
    assert want.max() > 0
