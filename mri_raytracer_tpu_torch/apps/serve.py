"""HTTP render service: the deployment-shaped front end (port of
``apps/serve.py``).

The reference's interactive surface is a desktop window loop
(``inr/viewer/brats_viewer.py:369-466``); a host with the card is typically
remote, so this app serves the same renderer over HTTP instead:
camera/transfer parameters arrive as query arguments, frames leave as PNG.
The renderer keeps volumes and params on the device, and a lock serializes
device access across server threads.

Endpoints:
  GET /                              -> interactive HTML viewer (drag to
      orbit, wheel to zoom, window/level/alpha sliders, overlay toggles)
  GET /info                          -> JSON (torch device, card, backend,
      size)
  GET /frame?theta=&phi=&radius=...  -> image/png
      optional: preset, ww, wl, alpha, seg=0|1, pred=0|1, gamma; the
      response's ``Server-Timing`` header splits its time into render
      (ending in the copy to the host) and PNG encode

    python -m mri_raytracer_tpu_torch.apps.serve --size 512 --port 8042

Runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np
import torch

from mri_raytracer_tpu_torch.io.png import encode_png, to_rgb8
from mri_raytracer_tpu_torch.render.presets import apply_preset, preset_names


class RenderService:
    """Holds the renderer + params; thread-safe frame production."""

    def __init__(self, renderer, params, radius: float):
        self.renderer = renderer
        self.base_params = params
        self.radius = float(radius)
        self._lock = threading.Lock()

    def info(self) -> dict:
        dev = self.renderer.device
        return {"backend": dev.type,
                "device": torch.cuda.get_device_name(dev)
                if dev.type == "cuda" else "cpu",
                "renderer": self.renderer.backend,
                "width": self.renderer.width,
                "height": self.renderer.height,
                "radius": self.radius,
                "has_seg": self.renderer.seg is not None,
                "has_pred": self.renderer.pred is not None}

    def render_frame(self, q: dict) -> Tuple[bytes, float, float]:
        """(PNG bytes, render ms, encode ms) for a parsed query."""
        from mri_raytracer_tpu_torch.render.camera import OrbitalCamera

        def f(name, default):
            return float(q.get(name, [default])[0])

        p = self.base_params
        if "preset" in q:
            p = apply_preset(p, q["preset"][0])
        upd = {}
        for key, field, default in (("ww", "ww", 1.0), ("wl", "wl", 0.5),
                                    ("alpha", "intensity_alpha", 40.0),
                                    ("gamma", "gamma", 1.0),
                                    ("seg", "show_seg", 1.0),
                                    ("pred", "show_pred", 0.0)):
            if key in q:
                upd[field] = torch.tensor(f(key, default),
                                          dtype=torch.float32)
        if upd:
            p = p._replace(**upd)
        cam = OrbitalCamera(radius=f("radius", self.radius),
                            theta=f("theta", 0.6), phi=f("phi", 1.2))
        with self._lock:
            t0 = time.perf_counter()
            img = self.renderer.render_numpy(cam.basis(), p)
            t1 = time.perf_counter()
        png = encode_png(to_rgb8(img))
        t2 = time.perf_counter()
        return png, (t1 - t0) * 1e3, (t2 - t1) * 1e3


# Browser viewer: one self-contained page, no dependencies. Drag = orbit,
# wheel = zoom, sliders = window/level/alpha, checkboxes = overlays. Frames
# are plain /frame requests, serialized client-side (at most one in flight,
# latest camera wins) to match the server's device lock.
_VIEWER_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>mri_raytracer_tpu</title><style>
body{margin:0;background:#111;color:#ccc;font:13px sans-serif;display:flex}
#side{padding:14px;width:230px}#side label{display:block;margin:10px 0 2px}
#side input[type=range]{width:100%}#img{flex:1;min-height:100vh;
object-fit:contain;cursor:grab;background:#000}#stat{margin-top:14px;
color:#777;white-space:pre-line}</style></head><body>
<div id="side"><b>mri_raytracer_tpu</b>
<label>preset</label><select id="preset"><option value="">custom</option>
__PRESET_OPTIONS__
</select>
<label>window width <span id="wwv"></span></label>
<input type="range" id="ww" min="0.05" max="2" step="0.01" value="1">
<label>window level <span id="wlv"></span></label>
<input type="range" id="wl" min="0" max="1.5" step="0.01" value="0.5">
<label>alpha <span id="alv"></span></label>
<input type="range" id="alpha" min="0.05" max="1.5" step="0.01" value="0.4">
<label><input type="checkbox" id="seg" checked> GT segmentation</label>
<label><input type="checkbox" id="pred"> INR prediction</label>
<div id="stat"></div></div>
<img id="img" draggable="false">
<script>
const img=document.getElementById('img'),stat=document.getElementById('stat');
let th=0.6,ph=1.2,rad=null,busy=false,queued=false,t0=0;
const q=id=>document.getElementById(id);
function url(){const pre=q('preset').value;
 const p=new URLSearchParams({theta:th,phi:ph,
  seg:q('seg').checked?1:0,pred:q('pred').checked?1:0});
 if(pre){p.set('preset',pre)}else{p.set('ww',q('ww').value);
  p.set('wl',q('wl').value);p.set('alpha',q('alpha').value)}
 if(rad!==null)p.set('radius',rad);return '/frame?'+p;}
function refresh(){if(busy){queued=true;return}busy=true;t0=performance.now();
 const u=url();const pre=new Image();
 pre.onload=()=>{img.src=pre.src;busy=false;
  stat.textContent=`theta ${th.toFixed(2)} phi ${ph.toFixed(2)}\\n`+
   `${(performance.now()-t0).toFixed(0)} ms/frame`;
  q('wwv').textContent=q('ww').value;q('wlv').textContent=q('wl').value;
  q('alv').textContent=q('alpha').value;
  if(queued){queued=false;refresh()}};
 pre.onerror=()=>{busy=false};pre.src=u;}
let drag=null;
img.onpointerdown=e=>{drag=[e.clientX,e.clientY];img.setPointerCapture(e.pointerId)};
img.onpointermove=e=>{if(!drag)return;th+=(e.clientX-drag[0])*.008;
 ph=Math.min(Math.PI-.05,Math.max(.05,ph-(e.clientY-drag[1])*.008));
 drag=[e.clientX,e.clientY];refresh()};
img.onpointerup=()=>{drag=null};
img.onwheel=e=>{e.preventDefault();if(rad===null)rad=2.6;
 rad=Math.min(8,Math.max(.8,rad*(e.deltaY>0?1.08:0.93)));refresh()};
for(const id of['ww','wl','alpha','seg','pred','preset'])q(id).oninput=refresh;
for(const id of['ww','wl','alpha'])q(id).onpointerdown=()=>{q('preset').value=''};
fetch('/info').then(r=>r.json()).then(i=>{rad=i.radius||2.6;refresh()});
</script></body></html>"""


def make_server(service: RenderService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            parsed = urllib.parse.urlparse(self.path)
            headers = {}
            try:
                if parsed.path in ("/", "/index.html"):
                    opts = "".join(f"<option>{n}</option>"
                                   for n in preset_names())
                    body = _VIEWER_HTML.replace("__PRESET_OPTIONS__",
                                                opts).encode()
                    ctype = "text/html; charset=utf-8"
                elif parsed.path == "/info":
                    body = json.dumps(service.info()).encode()
                    ctype = "application/json"
                elif parsed.path == "/frame":
                    q = urllib.parse.parse_qs(parsed.query)
                    body, render_ms, encode_ms = service.render_frame(q)
                    ctype = "image/png"
                    headers["Server-Timing"] = (
                        f"render;dur={render_ms:.3f}, "
                        f"encode;dur={encode_ms:.3f}")
                else:
                    self.send_error(404)
                    return
            except Exception as e:  # surface render errors as 500s
                self.send_error(500, str(e))
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

    return ThreadingHTTPServer((host, port), Handler)


def build_service(case_dir: Optional[str] = None, size: int = 512,
                  vol: int = 128, inr_checkpoint: Optional[str] = None,
                  device="cuda") -> RenderService:
    """The service ``main`` serves: a BraTS case (a synthetic vol^3 case
    when ``case_dir`` is None) at size^2, its seg overlay, and the baked
    prediction of ``inr_checkpoint`` when given; warmed up."""
    from mri_raytracer_tpu_torch.data import brats, synthetic
    from mri_raytracer_tpu_torch.env import resolve_device
    from mri_raytracer_tpu_torch.render import params as rp
    from mri_raytracer_tpu_torch.render.brats import BratsRenderer

    dev = resolve_device(device)
    if case_dir:
        case = brats.load_case_dict(case_dir, normalization="none")
        mods_raw, seg = case["mods"], case["seg"]
    else:
        mods_raw, seg = synthetic.synthetic_case((vol,) * 3, seed=0)
    disp = np.stack([brats.percentile_normalize(m) for m in mods_raw])

    pred = None
    if inr_checkpoint:
        from mri_raytracer_tpu_torch.apps.brats_app import load_inr
        from mri_raytracer_tpu_torch.eval.inference import predict_volume

        model, params = load_inr(inr_checkpoint, dev)
        mods_z = np.stack([brats.zscore_nonzero(m.copy()) for m in mods_raw])
        pred, _ = predict_volume(model, params, {"mods": mods_z, "seg": seg},
                                 device=dev)
        pred = pred.astype(np.int32)

    shape = disp.shape[1:]
    p = rp.default_render_params(shape, show_seg=True,
                                 show_pred=pred is not None)
    renderer = BratsRenderer(disp, np.asarray(seg, np.int32), pred,
                             width=size, height=size, device=dev)
    renderer.warmup(p)
    return RenderService(renderer, p, rp.default_camera_radius(p, shape))


def main(argv: Optional[list] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--case-dir", default=None,
                    help="BraTS case dir; synthetic volume when omitted")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--vol", type=int, default=128)
    ap.add_argument("--port", type=int, default=8042)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--inr-checkpoint", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    service = build_service(args.case_dir, args.size, args.vol,
                            args.inr_checkpoint, args.device)
    srv = make_server(service, args.host, args.port)
    shape = tuple(service.renderer.mods.shape[1:])
    print(f"[serve] http://{args.host}:{srv.server_address[1]}/frame "
          f"(backend {service.renderer.backend} on "
          f"{service.renderer.device}, {shape})")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
