"""Fused neural-field march: the INR evaluated inside the renderer (port of
``ops/neural_march.py``).

Mode 2 of the BraTS renderer (``docs/Goals.md:33-34``): per sweep plane
the z-scored modality volumes are resampled at a stride-S grid of the
intermediate image by the same separable hat products as the intensity,
the normalized coordinates come from the plane geometry, and the INR runs
as one batch per block of planes (``predict_field``). The predicted class
per sample feeds the same LUT compositing as the baked ``pred`` overlay
(1.5x opacity), so mode 1 (``bake_labels`` + ``BratsRenderer``) and mode 2
agree wherever the prediction field is locally constant.

Compositors: 'fused' runs stage 1 and kernel K1 with the field (K1b,
``ops/composite.py``), then K2; 'scan' runs the plain scan
(``shearwarp.sweep_composite`` with the field overlay) and is the
reference the fused frame is held against.

Numerics follow the JAX package: the resample products and the MLP layers
take bf16 operands with float32 accumulation (``shearwarp._bf16_dot``'s
form: operands rounded to bf16, product in float32), and hidden states are
rounded to bf16. Near-tie logits can flip their argmax between two
implementations, so labels are compared by their mismatch fraction.

The separable MLP (``separable_mlp``) is kernel K3 on a card,
``csrc/inr_mlp.cu``: first layer, hidden layers, head and argmax in one
launch a block of planes, the hidden states in registers, the products on
the bf16 tensor cores. ``separable_logits_plain`` is its plain version,
which runs for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mri_raytracer_tpu_torch.env import resolve_device
from mri_raytracer_tpu_torch.models.api import ModelBundle
from mri_raytracer_tpu_torch.ops import composite, kernels, warp
from mri_raytracer_tpu_torch.ops import shearwarp as sw
from mri_raytracer_tpu_torch.render import brats as brats_render
from mri_raytracer_tpu_torch.render.brats import BratsRenderer
from mri_raytracer_tpu_torch.render.camera import CameraBasis
from mri_raytracer_tpu_torch.render.params import BratsRenderParams
from mri_raytracer_tpu_torch.utils import profiling

_F32 = torch.float32
# Sweep axis -> for each of (x, y, z), its position among (k, a, b).
_INV_ORDER = {0: (0, 1, 2), 1: (1, 0, 2), 2: (1, 2, 0)}
_BACKENDS = ("auto", "fused", "scan", "rebake")


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 and held in float32: a product of two such
    operands is exact in float32, so a float32 matmul of them is JAX's
    bf16 dot with ``preferred_element_type=f32``."""
    return x.to(torch.bfloat16).to(_F32)


def _axis_feat(t: torch.Tensor, K: int) -> torch.Tensor:
    """(..., L) normalized coordinate -> (..., L, 1+2K) [t | sin | cos]."""
    if K == 0:
        return t[..., None]
    freqs = torch.arange(1, K + 1, dtype=t.dtype, device=t.device) * math.pi
    ang = t[..., None] * freqs
    return torch.cat([t[..., None], torch.sin(ang), torch.cos(ang)], dim=-1)


def _axis_slice(W1: torch.Tensor, c: int, K: int) -> torch.Tensor:
    """W1 rows of coordinate c and its Fourier block, (1+2K, H)."""
    rows = [W1[c:c + 1]]
    if K > 0:
        rows.append(W1[3 + c * 2 * K: 3 + (c + 1) * 2 * K])
    return torch.cat(rows, dim=0)


def _separable_first_layer_batched(layers, K: int, M: int, pos_an, pos_bn,
                                   z_n, inv_order):
    """First MLP layer over B sweep planes as rank-1 broadcasts.

    Per plane each normalized coordinate is constant along one in-plane
    axis (k: constant, a: rows, b: columns) and the deterministic Fourier
    features are per-axis blocks of the input, so ``[coords | ff] @ W1``
    splits into a row term + a column term + a constant, each computed on
    O values instead of O^2 samples. pos_an (B, Oa), pos_bn (B, Ob), z_n
    (B,) normalized coordinates. Returns (row (B,Oa,H), col (B,Ob,H),
    const (B,H), W1_int (M,H))."""
    W1 = layers[0].W
    b1 = layers[0].b
    H = W1.shape[1]
    B = pos_an.shape[0]
    row = torch.zeros((B, pos_an.shape[1], H), dtype=W1.dtype,
                      device=W1.device)
    col = torch.zeros((B, pos_bn.shape[1], H), dtype=W1.dtype,
                      device=W1.device)
    const = b1.expand(B, H)
    for c in range(3):
        src = inv_order[c]
        contrib = {0: z_n[:, None], 1: pos_an, 2: pos_bn}[src]
        g = _axis_feat(contrib, K) @ _axis_slice(W1, c, K)  # (B, O|1, H)
        if src == 0:
            const = const + g[:, 0]
        elif src == 1:
            row = row + g
        else:
            col = col + g
    W1_int = W1[3 + (3 * 2 * K if K > 0 else 0):]  # (M, H)
    if W1_int.shape[0] != M:
        raise ValueError(f"first layer has {W1_int.shape[0]} intensity "
                         f"rows, the volumes {M} modalities")
    return row, col, const, W1_int


def _separable_first_layer(layers, K: int, M: int, pos_an, pos_bn, z_n,
                           inv_order, out_res: int):
    """One plane of ``_separable_first_layer_batched``: pos_an, pos_bn
    (O,), z_n (). Returns (row (O,H), col (O,H), const (H,), W1_int (M,H))."""
    row, col, const, W1_int = _separable_first_layer_batched(
        layers, K, M, pos_an[None], pos_bn[None],
        torch.as_tensor(z_n, dtype=_F32, device=pos_an.device).reshape(1),
        inv_order)
    return row[0], col[0], const[0], W1_int


def _first_hidden(row, col, const, intens, W1_int) -> torch.Tensor:
    """relu(row_i + col_j + const + intens @ W1_int) over (B, Oa, Ob),
    rounded to bf16 (the JAX package's order of additions)."""
    h = row[:, :, None, :] + col[:, None, :, :]
    h += const[:, None, None, :]
    h += _bf16(intens) @ _bf16(W1_int)
    return torch.relu_(h).to(torch.bfloat16)


def _mlp_tail(layers, h: torch.Tensor) -> torch.Tensor:
    """Hidden layers 2..n + head, bf16 operands with float32 accumulation."""
    for layer in layers[1:-1]:
        h = torch.relu_(torch.addmm(layer.b, _bf16(h), _bf16(layer.W)))
    last = layers[-1]
    return torch.addmm(last.b, _bf16(h), _bf16(last.W))


def separable_logits_plain(params, K: int, intens: torch.Tensor,
                           a_n: torch.Tensor, b_n: torch.Tensor,
                           k_n: torch.Tensor, inv_order) -> torch.Tensor:
    """Plain PyTorch version of K3 up to its argmax: (B, Oa, Ob, C) float32
    logits of the separable MLP over intensities ``intens`` (B, Oa, Ob, M)
    and normalized coordinates ``a_n`` (B, Oa), ``b_n`` (B, Ob), ``k_n``
    (B,) (``inv_order``: for each of x, y, z its position among k, a,
    b)."""
    B, Oa = a_n.shape
    Ob = b_n.shape[1]
    row, col, const, W1_int = _separable_first_layer_batched(
        params, K, intens.shape[-1], a_n, b_n, k_n, inv_order)
    h = _first_hidden(row, col, const, intens, W1_int)
    return _mlp_tail(params, h.reshape(-1, h.shape[-1])).reshape(
        B, Oa, Ob, -1)


# K3's limits (csrc/inr_mlp.cu): hidden widths, classes, intensities and
# dense layers it takes.
MLP_MAX_WIDTH, MLP_MAX_CLASSES, MLP_MAX_M, MLP_MAX_LAYERS = 256, 8, 4, 16
_MLP_ARGTYPES = ((ctypes.c_void_p,) + (ctypes.c_longlong,) * 4
                 + (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 8
                 + (ctypes.c_void_p,) * 2 + (ctypes.c_int, ctypes.c_void_p))


def _kernel_widths(weights, K: int, M: int) -> Tuple[int, ...]:
    """The widths K3 is launched with (the first layer's fan-in, then each
    layer's fan-out) after checking that it takes the MLP whose weights are
    ``weights`` (W0, b0, W1, b1, ...): float32 contiguous, hidden widths
    multiples of 16 up to ``MLP_MAX_WIDTH``, at most ``MLP_MAX_CLASSES``
    classes, ``MLP_MAX_M`` intensities and ``MLP_MAX_LAYERS`` layers.
    Raises ValueError (TypeError for a dtype) on anything else."""
    n_layers = len(weights) // 2
    if not 2 <= n_layers <= MLP_MAX_LAYERS:
        raise ValueError(f"K3 takes 2 to {MLP_MAX_LAYERS} dense layers, "
                         f"got {n_layers}")
    if not 1 <= M <= MLP_MAX_M:
        raise ValueError(f"K3 takes 1 to {MLP_MAX_M} intensities, got {M}")
    widths = [int(weights[0].shape[0])]
    for n in range(n_layers):
        W, b = weights[2 * n], weights[2 * n + 1]
        if W.dtype != _F32 or b.dtype != _F32:
            raise TypeError(f"layer {n}: K3 takes float32 weights, got "
                            f"{W.dtype} / {b.dtype}")
        if W.dim() != 2 or W.shape[0] != widths[-1] \
                or tuple(b.shape) != (W.shape[1],):
            raise ValueError(f"layer {n}: W {tuple(W.shape)} and b "
                             f"{tuple(b.shape)} do not chain from width "
                             f"{widths[-1]}")
        if not (W.is_contiguous() and b.is_contiguous()):
            raise ValueError(f"layer {n}: K3 takes contiguous weights")
        widths.append(int(W.shape[1]))
    if widths[0] != 3 + 6 * K + M:
        raise ValueError(f"first layer has {widths[0]} inputs, not 3 + 6 * "
                         f"{K} + {M}")
    for w in widths[1:-1]:
        if w % 16 or not 16 <= w <= MLP_MAX_WIDTH:
            raise ValueError(f"K3 takes hidden widths that are multiples of "
                             f"16 up to {MLP_MAX_WIDTH}, got {widths[1:-1]}")
    if not 1 <= widths[-1] <= MLP_MAX_CLASSES:
        raise ValueError(f"K3 takes 1 to {MLP_MAX_CLASSES} classes, got "
                         f"{widths[-1]}")
    return tuple(widths)


def separable_mlp(params, K: int, intens: torch.Tensor, a_n: torch.Tensor,
                  b_n: torch.Tensor, k_n: torch.Tensor, inv_order,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, Oa, Ob) int32 labels of the separable MLP (``params``, ``K``
    harmonics) over ``intens`` (B, Oa, Ob, M) float32, any strides, and the
    normalized coordinates ``a_n`` (B, Oa), ``b_n`` (B, Ob), ``k_n`` (B,)
    (``inv_order``: for each of x, y, z its position among k, a, b);
    written into ``out`` when given. Launches K3 for CUDA tensors (adding
    the points to the counter ``field.kernel_points``), runs the plain
    version for CPU tensors. K3 has no backward: on the card it refuses
    weights that require grad while grad is enabled."""
    if intens.dim() != 4 or a_n.dim() != 2 or b_n.dim() != 2 \
            or k_n.dim() != 1:
        raise ValueError("intens must be (B, Oa, Ob, M), a_n (B, Oa), b_n "
                         f"(B, Ob), k_n (B,), got {tuple(intens.shape)}, "
                         f"{tuple(a_n.shape)}, {tuple(b_n.shape)}, "
                         f"{tuple(k_n.shape)}")
    B, Oa, Ob, M = intens.shape
    if tuple(a_n.shape) != (B, Oa) or tuple(b_n.shape) != (B, Ob) \
            or tuple(k_n.shape) != (B,):
        raise ValueError(f"coordinates {tuple(a_n.shape)}, "
                         f"{tuple(b_n.shape)}, {tuple(k_n.shape)} do not "
                         f"fit intens {tuple(intens.shape)}")
    if sorted(inv_order) != [0, 1, 2]:
        raise ValueError(f"inv_order must order (0, 1, 2), got {inv_order}")
    dev = intens.device
    weights = [t for layer in params for t in (layer.W, layer.b)]
    tensors = [("a_n", a_n), ("b_n", b_n), ("k_n", k_n)]
    for name, t in tensors + [("weights", w) for w in weights]:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, intens on {dev}")
    for name, t in [("intens", intens)] + tensors:
        if t.dtype != _F32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if out is not None:
        if out.device != dev or out.dtype != torch.int32 \
                or tuple(out.shape) != (B, Oa, Ob):
            raise ValueError(f"out must be ({B}, {Oa}, {Ob}) int32 on {dev}, "
                             f"got {tuple(out.shape)} {out.dtype} on "
                             f"{out.device}")
    if dev.type == "cpu":
        labels = torch.argmax(separable_logits_plain(
            params, K, intens, a_n, b_n, k_n, inv_order), dim=-1)
        if out is None:
            return labels.to(torch.int32)
        return out.copy_(labels)
    widths = _kernel_widths(weights, K, M)
    if dev.type != "cuda":
        raise RuntimeError(f"no MLP kernel for device {dev}")
    kernels.refuse_grad("separable_mlp (kernel K3)", *weights)
    if not all(t.is_contiguous() for _, t in tensors):
        raise ValueError("a_n, b_n and k_n must be contiguous")
    if out is None:
        out = torch.empty((B, Oa, Ob), dtype=torch.int32, device=dev)
    elif not out.is_contiguous():
        raise ValueError("out must be contiguous")
    if out.numel() == 0:
        return out
    index = dev.index
    if index == torch.cuda.current_device():
        _launch_mlp(intens, a_n, b_n, k_n, out, K, inv_order, weights,
                    widths, index)
    else:
        with torch.cuda.device(index):
            _launch_mlp(intens, a_n, b_n, k_n, out, K, inv_order, weights,
                        widths, index)
    separable_mlp.launches += 1
    profiling.count("field.kernel_points", out.numel())
    return out


def _launch_mlp(intens, a_n, b_n, k_n, out, K, inv_order, weights, widths,
                index):
    fn = kernels.function("inr_mlp", "mrt_inr_mlp", _MLP_ARGTYPES)
    B, Oa, Ob, M = intens.shape
    ptrs = (ctypes.c_void_p * len(weights))(*(w.data_ptr() for w in weights))
    ws = (ctypes.c_int * len(widths))(*widths)
    err = fn(intens.data_ptr(), *intens.stride(), a_n.data_ptr(),
             b_n.data_ptr(), k_n.data_ptr(), out.data_ptr(), B, Oa, Ob, M, K,
             inv_order.index(0), inv_order.index(1), inv_order.index(2),
             ptrs, ws, len(widths) - 1, warp.current_stream_handle(index))
    if err != 0:
        raise RuntimeError(f"INR MLP kernel launch failed: cudaError {err}")


separable_mlp.launches = 0


def model_is_separable(model: ModelBundle) -> bool:
    """True when the first layer decomposes per axis (plain MLP over
    [coords | deterministic Fourier features | modalities])."""
    return (model.cfg.kind == "mlp" and not model.cfg.aniso_features
            and model.cfg.rff_dim == 0 and model.cfg.use_modalities)


def _norm_index(n: int, device) -> torch.Tensor:
    """Voxel index -> [-1, 1], the INR's training convention."""
    return (torch.arange(n, dtype=_F32, device=device) / (n - 1.0)) * 2.0 \
        - 1.0


@torch.no_grad()
def bake_labels(model: ModelBundle, params, modsz: torch.Tensor,
                block: int = 16) -> torch.Tensor:
    """Voxel-grid bake: (M, X, Y, Z) z-scored modalities -> (X, Y, Z) int32
    argmax labels, same convention as ``eval.inference._predict_labels``.

    At voxel positions the intensity features are the voxels (no resample)
    and the coordinate features are separable per axis, so the bake is
    ``separable_mlp`` (K3 on a card) over blocks of X slices: rows Y,
    columns Z, planes X. Non-separable models take the generic float32
    path."""
    if not model_is_separable(model):
        from mri_raytracer_tpu_torch.eval.inference import _predict_labels

        return _predict_labels(model, params, modsz).to(torch.int32)
    _, X, Y, Z = modsz.shape
    K = model.cfg.fourier_freqs
    ys, zs, xs = (_norm_index(n, modsz.device) for n in (Y, Z, X))
    ys = ys.expand(block, Y).contiguous()
    zs = zs.expand(block, Z).contiguous()
    out = torch.empty((X, Y, Z), dtype=torch.int32, device=modsz.device)
    for x0 in range(0, X, block):
        x1 = min(x0 + block, X)
        B = x1 - x0
        separable_mlp(params, K, modsz[:, x0:x1].permute(1, 2, 3, 0),
                      ys[:B], zs[:B], xs[x0:x1], (0, 1, 2), out[x0:x1])
    return out


def resample_block(modsz_s: torch.Tensor, zi: torch.Tensor, oa, sa, ob, sb,
                   stride: int, Op: int, a_bounds, b_bounds) -> torch.Tensor:
    """(B, Op, Op, M) z-scored intensities of B sweep planes (``zi``: their
    slices of ``modsz_s``, (M, K, Na, Nb)) at the stride-``stride`` grid of
    the intermediate image: the separable hat matrices of the planes'
    affines (``oa``, ``sa``, ``ob``, ``sb``, (B,) each) under the geometry's
    clamps (``a_bounds``, ``b_bounds``), applied as two bf16 products."""
    with profiling.span("predict_field.resample"):
        _, _, Na, Nb = modsz_s.shape
        Wa, _ = sw._batched_hat(oa, sa * stride, Na, Op, *a_bounds)
        Wb, _ = sw._batched_hat(ob, sb * stride, Nb, Op, *b_bounds)
        sl = modsz_s.index_select(1, zi)  # (M, B, Na, Nb)
        t1 = _bf16(Wa)[None] @ _bf16(sl)  # (M, B, Op, Nb)
        v = _bf16(t1) @ _bf16(Wb).transpose(1, 2)[None]  # (M, B, Op, Op)
        return v.permute(1, 2, 3, 0)


def mlp_block(model: ModelBundle, params, intens: torch.Tensor,
              a_n: torch.Tensor, b_n: torch.Tensor, k_n: torch.Tensor,
              inv_order, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, Oa, Ob) int32 INR labels of B sweep planes' strided samples: the
    argmax of the MLP over their intensities ``intens`` (B, Oa, Ob, M) and
    normalized global coordinates, ``a_n`` (B, Oa) along the rows, ``b_n``
    (B, Ob) along the columns and ``k_n`` (B,) along the sweep
    (``inv_order``: for each of x, y, z its position among k, a, b);
    written into ``out`` when given. A separable model runs
    ``separable_mlp`` (K3 on a card); the others, whose first layer does
    not split by axis, ``model.apply`` on every sample."""
    with profiling.span("predict_field.mlp"):
        if model_is_separable(model):
            return separable_mlp(params, model.cfg.fourier_freqs, intens,
                                 a_n, b_n, k_n, inv_order, out)
        B, Oa, Ob, M = intens.shape
        per_axis = (k_n[:, None, None].expand(B, Oa, Ob),
                    a_n[:, :, None].expand(B, Oa, Ob),
                    b_n[:, None, :].expand(B, Oa, Ob))
        coords = torch.stack([per_axis[o] for o in inv_order], dim=-1)
        logits = model.apply(params, coords.reshape(-1, 3),
                             intens.reshape(-1, M))
        labels = torch.argmax(logits, dim=-1).reshape(B, Oa, Ob)
        if out is None:
            return labels.to(torch.int32)
        return out.copy_(labels)


@torch.no_grad()
def predict_field(model: ModelBundle, params, modsz_s: torch.Tensor,
                  geom: sw.SweepGeom, p: BratsRenderParams, axis: int,
                  out_res: int, stride: int, z_offset=None,
                  nk_global: Optional[int] = None, block: int = 16,
                  kstride: int = 1) -> torch.Tensor:
    """INR labels at strided intermediate positions of the sweep planes.

    Returns (ceil(n_planes / kstride), Op, Op) int32 labels,
    Op = out_res // stride, in SWEEP order (plane m * kstride, flip
    applied): the field K1b composites (plane m reads row m // kstride).
    Per block of planes, the z-scored modalities are resampled by the
    separable hat products at the strided grid (``resample_block``) and
    the MLP labels the block's B*Op*Op samples into its rows of the field
    (``mlp_block``); each block adds them to the counter ``field.points``.

    ``modsz_s``: (M, K, Na, Nb) permuted (and possibly content-cropped)
    z-scored modalities; the crop contract matches
    ``shearwarp.render_prepared`` (``z_offset``/``nk_global`` + geom's
    in-plane offsets). Coordinates are normalized GLOBAL indices.
    """
    with profiling.span("predict_field"):
        M, Nk, Na, Nb = modsz_s.shape
        Op = out_res // stride
        if Op * stride != out_res:
            raise ValueError(f"stride {stride} must divide out_res "
                             f"{out_res}")
        dev = modsz_s.device
        nk_g = nk_global if nk_global is not None else Nk
        n_all = Nk + 1

        # The compositor's plane affines, in sweep order.
        z, z_glob, _, off_a, sc_a, off_b, sc_b = sw.sweep_plane_affines(
            geom, p, axis, n_all, z_offset=z_offset)
        n_planes = -(-n_all // kstride)
        if kstride > 1:
            ms = torch.clamp(torch.arange(n_planes, device=dev) * kstride,
                             max=n_all - 1)
            z, z_glob, off_a, sc_a, off_b, sc_b = (
                t[ms] for t in (z, z_glob, off_a, sc_a, off_b, sc_b))
        zi = torch.clamp(z, 0.0, Nk - 1).long()

        acl, ach, _, aml, amh = sw._geom_bounds(geom, 0, Na)
        bcl, bch, _, bml, bmh = sw._geom_bounds(geom, 1, Nb)

        # Global dims along (k, a, b); na_g < 0 means uncropped.
        inv_order = _INV_ORDER[axis]
        na_gf = sw._where(geom.na_g < 0, float(Na), geom.na_g)
        nb_gf = sw._where(geom.nb_g < 0, float(Nb), geom.nb_g)
        dims_g = (torch.tensor(float(nk_g), device=dev), na_gf, nb_gf)

        def norm(t, d):
            return (t / (d - 1.0)) * 2.0 - 1.0

        # The normalized coordinates of every plane's samples, once a frame:
        # the same elementwise operations as per block, launched once.
        iis = torch.arange(Op, dtype=_F32, device=dev) * stride
        a_n = norm(off_a[:, None] + iis[None, :] * sc_a[:, None]
                   + geom.a_off, dims_g[1])
        b_n = norm(off_b[:, None] + iis[None, :] * sc_b[:, None]
                   + geom.b_off, dims_g[2])
        k_n = norm(z_glob, dims_g[0])
        field = torch.empty((n_planes, Op, Op), dtype=torch.int32,
                            device=dev)
        for m0 in range(0, n_planes, block):
            m1 = min(m0 + block, n_planes)
            intens = resample_block(modsz_s, zi[m0:m1], off_a[m0:m1],
                                    sc_a[m0:m1], off_b[m0:m1], sc_b[m0:m1],
                                    stride, Op, (acl, ach, aml, amh),
                                    (bcl, bch, bml, bmh))
            mlp_block(model, params, intens, a_n[m0:m1], b_n[m0:m1],
                      k_n[m0:m1], inv_order, out=field[m0:m1])
            profiling.count("field.points", (m1 - m0) * Op * Op)
        return field


class NeuralFrame(NamedTuple):
    """Per-frame inputs of the mode-2 compositors: the prepared (permuted,
    possibly cropped) volumes, the crop contract of
    ``shearwarp.render_prepared``, and the frame's sweep geometry."""

    mixed_s: torch.Tensor  # (K, Na, Nb) blended display volume
    modsz_s: torch.Tensor  # (M, K, Na, Nb) z-scored modalities
    seg_s: Optional[torch.Tensor]  # (K, Na, Nb) int32
    basis: CameraBasis
    p: BratsRenderParams
    axis: int
    out_res: int
    use_gamma: bool
    use_clip: bool
    z_offset: Optional[int]
    nk_global: Optional[int]
    ab_offset: Optional[Tuple[int, int]]
    inplane_global: Optional[Tuple[int, int]]
    geom: sw.SweepGeom


def frame_field(model: ModelBundle, params, fr: NeuralFrame, stride: int,
                kstride: int = 1, block: int = 16) -> torch.Tensor:
    """``predict_field`` for one frame."""
    return predict_field(model, params, fr.modsz_s, fr.geom, fr.p, fr.axis,
                         fr.out_res, stride, fr.z_offset, fr.nk_global,
                         block, kstride)


def _render_neural_axis(fr: NeuralFrame, model: ModelBundle, params,
                        width: int, height: int, pred_stride: int = 1,
                        pred_kstride: int = 1,
                        field: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mode-2 frame by the plain scan -> (H, W, 3): the field (computed
    here unless injected) composited by ``shearwarp.sweep_composite``."""
    if field is None:
        field = frame_field(model, params, fr, pred_stride, pred_kstride)
    C, _ = sw.sweep_composite(
        fr.mixed_s, fr.seg_s, None, fr.geom, fr.p, fr.axis, fr.out_res, 1,
        fr.use_gamma, fr.use_clip, z_offset=fr.z_offset,
        nk_global=fr.nk_global, pred_field=field, field_stride=pred_stride,
        field_kstride=pred_kstride)
    return sw.warp_to_screen(C, fr.geom, fr.basis, fr.axis, width, height,
                             fr.p.bg_color)


def _render_neural_fused(fr: NeuralFrame, model: ModelBundle, params,
                         stride: int, kstride: int = 1, block: int = 16,
                         field: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Mode-2 fast path -> the intermediate (O, O, 3) image: the strided
    field (computed here unless injected), then stage 1 and K1 with the
    field (K1b). The caller warps it (K2)."""
    if field is None:
        field = frame_field(model, params, fr, stride, kstride, block)
    C, _ = composite.sweep_composite_fused(
        fr.mixed_s, fr.seg_s, None, fr.geom, fr.p, fr.axis, fr.out_res,
        fr.use_gamma, fr.use_clip, fr.z_offset, fr.nk_global,
        pred_field=field, field_stride=stride, field_kstride=kstride)
    return C


def render_brats_neural(mods_disp, mods_zscore, seg, model: ModelBundle,
                        params, basis: CameraBasis, p: BratsRenderParams,
                        width: int = 512, height: int = 512,
                        out_res: Optional[int] = None, pred_stride: int = 1,
                        pred_kstride: int = 1,
                        geom: Optional[sw.SweepGeom] = None,
                        field=None, device=None) -> torch.Tensor:
    """Mode-2 render by the plain scan: intensity + GT seg + LIVE INR
    prediction overlay -> (H, W, 3) on ``device`` (``cuda`` unless given;
    ``params`` is moved there).

    mods_disp: display-normalized volumes (percentile) for the emission;
    mods_zscore: z-scored volumes matching the INR's training
    normalization. ``pred_stride``: evaluate the INR on a strided in-plane
    grid (nearest-sampled overlay); ``pred_kstride``: on every K-th sweep
    plane (nearest along the sweep), as the fused path does. ``geom`` and
    ``field`` (``predict_field``'s output) may be injected, so that two
    compositors can be compared on the same inputs: geometry computed
    twice differs in the last bits, enough to flip near-tie labels.
    """
    dev = resolve_device(device)
    out_res = out_res or max(width, height)
    axis = sw.dominant_axis(basis)
    mods = torch.as_tensor(mods_disp, dtype=_F32, device=dev)
    modsz = torch.as_tensor(mods_zscore, dtype=_F32, device=dev)
    seg = None if seg is None else \
        torch.as_tensor(seg, device=dev).to(torch.int32)
    p = p.to(dev)
    basis = basis.to(dev)
    mixed_s, seg_s, _ = sw.prepare_sweep_volumes(mods, seg, None, p, axis)
    modsz_s = torch.stack([sw._perm_volume(m, axis) for m in modsz])
    if geom is None:
        geom = sw.sweep_geometry(basis, p, tuple(mixed_s.shape), axis,
                                 out_res, frustum_wh=(width, height))
    fr = NeuralFrame(mixed_s, modsz_s, seg_s, basis, p, axis, out_res,
                     True, True, None, None, None, None, geom)
    if field is not None:
        field = torch.as_tensor(field, device=dev)
    return _render_neural_axis(fr, model, params.to(dev), width, height,
                               pred_stride, pred_kstride, field)


class NeuralBratsRenderer:
    """Interactive mode-2 renderer: LIVE INR prediction overlay evaluated
    inside the sweep (``docs/Goals.md:33-34``).

    Backends: 'fused' (``predict_field``, stage 1 + K1 with the field,
    K2), 'scan' (the plain scan, ``render_brats_neural``), 'rebake'
    (``bake_labels`` re-run lazily after every ``set_params`` and rendered
    as the baked pred overlay: on a card K1 reads the baked-pred rows),
    'auto' ('fused' on a card, 'scan' on the CPU). One ``BratsRenderer``
    (``self.brats``) holds the volumes, the content crop and the
    prepared-volume cache for every backend; 'fused' takes its frames with
    the z-scored modalities cropped alongside, so INR predictions outside
    the mods|seg box are not rendered. Runs on ``device`` (``cuda`` unless
    given); ``params`` is moved there.
    """

    def __init__(self, mods_disp, mods_zscore, seg, model: ModelBundle,
                 params, width: int = 1024, height: int = 1024,
                 pred_stride: int = 4, backend: str = "auto",
                 sweep_res: Optional[int] = None, pred_kstride: int = 1,
                 device=None):
        self.device = resolve_device(device)
        if backend not in _BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; choose from "
                             f"{_BACKENDS}")
        if backend == "auto":
            backend = "fused" if self.device.type == "cuda" else "scan"
        self.backend = backend
        self.model = model
        self.params = params.to(self.device)
        self.width = int(width)
        self.height = int(height)
        self.stride = int(pred_stride)
        self.kstride = int(pred_kstride)
        self.sweep_res = sweep_res
        base_res = int(sweep_res or max(width, height))
        if backend != "rebake" and (base_res % self.stride
                                    or 128 % self.stride):
            # In-plane crops shrink out_res to 128-multiples, so the stride
            # must divide both the base resolution and 128.
            raise ValueError(
                f"pred_stride={pred_stride} must divide sweep resolution "
                f"{base_res} and 128 (use 1, 2, 4 or 8)")
        self.modsz = torch.as_tensor(mods_zscore, dtype=_F32,
                                     device=self.device)
        self.brats = BratsRenderer(
            mods_disp, seg, None, width=width, height=height,
            sweep_res=sweep_res,
            extra=self.modsz if backend == "fused" else None,
            device=self.device)
        self.mods, self.seg = self.brats.mods, self.brats.seg
        self._dirty = True

    def set_params(self, params) -> None:
        """Swap INR weights (e.g. every few training steps); the field is
        recomputed per frame, the 'rebake' backend re-bakes at the next
        render."""
        self.params = params.to(self.device)
        self._dirty = True

    def sweep_frame(self, basis: CameraBasis, p: BratsRenderParams
                    ) -> NeuralFrame:
        """The fused path's per-frame inputs: ``BratsRenderer.sweep_frame``
        (cached content-cropped volumes, device params, sweep axis, crop
        contract) with the cropped z-scored modalities, and the geometry."""
        fr = self.brats.sweep_frame(basis, p)
        geom = sw.content_geometry(fr.basis, fr.p, tuple(fr.mixed_s.shape),
                                   fr.axis, fr.out_res, self.width,
                                   self.height, fr.z_offset, fr.nk_global,
                                   fr.ab_offset, fr.inplane_global)
        return NeuralFrame(fr.mixed_s, fr.extra_s, fr.seg_s, fr.basis, fr.p,
                           fr.axis, fr.out_res, fr.use_gamma, fr.use_clip,
                           fr.z_offset, fr.nk_global, fr.ab_offset,
                           fr.inplane_global, geom)

    def render(self, basis: CameraBasis, p: BratsRenderParams
               ) -> torch.Tensor:
        """(H, W, 3) float32 frame on the renderer's device."""
        with profiling.frame():
            if self.backend == "rebake":
                if self._dirty:
                    self.brats.set_prediction(
                        bake_labels(self.model, self.params, self.modsz))
                    self._dirty = False
                return self.brats.render(basis, p)
            if self.backend == "scan":
                return render_brats_neural(
                    self.mods, self.modsz, self.seg, self.model, self.params,
                    basis, p, self.width, self.height,
                    out_res=self.sweep_res, pred_stride=self.stride,
                    pred_kstride=self.kstride, device=self.device)
            fr = self.sweep_frame(basis, p)
            C = _render_neural_fused(fr, self.model, self.params,
                                     self.stride, self.kstride)
            return sw.warp_to_screen(C, fr.geom, fr.basis, fr.axis,
                                     self.width, self.height, fr.p.bg_color)

    def render_numpy(self, basis: CameraBasis, p: BratsRenderParams
                     ) -> np.ndarray:
        with profiling.frame():
            return brats_render.present(self.render(basis, p))
