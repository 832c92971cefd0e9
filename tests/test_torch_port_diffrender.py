"""The port's differentiable-rendering ops (``ops/trilinear``'s
``trilinear_sample``, ``ops/diffrender``, ``ops/importance``,
``ops/isosurface``) against the JAX package on the CPU, same inputs from
numpy seeds.

Tolerances: values and gradients atol 1e-5 (rtol 1e-5 where the values
reach ~10): float32 on both sides, the same arithmetic, summed in another
order (cumprod, cumsum, scatter-add). ``torch.autograd.gradcheck`` in
float64 holds each ``autograd.Function``'s backward against finite
differences of its own forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_raytracer_tpu.ops import diffrender as jdr
from mri_raytracer_tpu.ops import importance as jimp
from mri_raytracer_tpu.ops import isosurface as jiso
from mri_raytracer_tpu.ops import trilinear as jtri
from mri_raytracer_tpu_torch.ops import diffrender as tdr
from mri_raytracer_tpu_torch.ops import importance as timp
from mri_raytracer_tpu_torch.ops import isosurface as tiso
from mri_raytracer_tpu_torch.ops import trilinear as ttri

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), **(kw or TOL))


@pytest.fixture(scope="module")
def grid_case():
    """A (7, 6, 5) grid and points inside, clamped outside and on the
    clamp's edges (0 and dims - 1.001)."""
    rng = np.random.default_rng(0)
    vol = rng.normal(size=(7, 6, 5)).astype(np.float32)
    pts = rng.uniform(-1.5, 7.5, (40, 3)).astype(np.float32)
    pts[:4] = [[0, 0, 0], [5.999, 4.999, 3.999], [-0.5, 2.2, 9.0],
               [3.3, 1.7, 2.4]]
    g = rng.normal(size=(40,)).astype(np.float32)
    return vol, pts, g


def test_trilinear_sample_values_and_grads(grid_case):
    vol, pts, g = grid_case

    def jloss(v, p):
        return jnp.sum(jtri.trilinear_sample(v, p) * g)

    jv, (jgv, jgp) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(vol), jnp.asarray(pts))
    tv, tp = _t(vol, True), _t(pts, True)
    out = ttri.trilinear_sample(tv, tp)
    _close(out, jtri.trilinear_sample(jnp.asarray(vol), jnp.asarray(pts)))
    (out * torch.from_numpy(g)).sum().backward()
    _close(tv.grad, jgv)
    _close(tp.grad, jgp)
    # Clamped coordinates (outside, or on the clamp's bound) get no
    # positional gradient; the ones inside do.
    assert (tp.grad[0] == 0).all() and (tp.grad[2, [0, 2]] == 0).all()
    assert tp.grad[2, 1] != 0
    assert (tp.grad[3] != 0).all()


def test_trilinear_sample_multi(grid_case):
    vol, pts, _ = grid_case
    vols = np.stack([vol, 2 * vol - 1])
    _close(ttri.trilinear_sample_multi(_t(vols), _t(pts)),
           jtri.trilinear_sample_multi(jnp.asarray(vols), jnp.asarray(pts)))


@pytest.fixture(scope="module")
def comp_case():
    rng = np.random.default_rng(1)
    colors = rng.uniform(size=(3, 12, 3)).astype(np.float32)
    alphas = (rng.uniform(size=(3, 12)) * 0.7).astype(np.float32)
    alphas[0, 5] = 1.0  # an opaque sample: the 1e-20 clamp's branch
    return colors, alphas


def test_composite_forward_and_adjoint(comp_case):
    """C and T_final, and the gradients of a loss of both (the G_T term)."""
    colors, alphas = comp_case

    def jloss(c, a):
        C, T = jdr.composite_fronttoback(c, a)
        return jnp.sum(C ** 2) + jnp.sum(T ** 3) + jnp.sum(T)

    jgc, jga = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(colors),
                                               jnp.asarray(alphas))
    tc, ta = _t(colors, True), _t(alphas, True)
    C, T = tdr.composite_fronttoback(tc, ta)
    jC, jT = jdr.composite_fronttoback(jnp.asarray(colors),
                                       jnp.asarray(alphas))
    _close(C, jC)
    _close(T, jT)
    (torch.sum(C ** 2) + torch.sum(T ** 3) + torch.sum(T)).backward()
    _close(tc.grad, jgc)
    _close(ta.grad, jga)


def test_alpha_from_sigma_both_branches():
    sigma = np.array([1e-8, 1e-3, 0.5, 1.0, 40.0], np.float32)
    dt = np.float32(0.01)  # tau 1e-10 and 1e-5: series; the rest: exp
    jf = lambda s: jnp.sum(jdr.alpha_from_sigma(s, dt) ** 2)
    ts = _t(sigma, True)
    a = tdr.alpha_from_sigma(ts, dt)
    _close(a, jdr.alpha_from_sigma(jnp.asarray(sigma), dt), rtol=1e-6,
           atol=1e-9)
    (a ** 2).sum().backward()
    _close(ts.grad, jax.grad(jf)(jnp.asarray(sigma)), rtol=1e-5, atol=1e-12)


@pytest.fixture(scope="module")
def render_case():
    rng = np.random.default_rng(2)
    sigma_grid = (rng.normal(size=(8, 8, 8)) * 0.3).astype(np.float32)
    color_grid = rng.normal(size=(3, 8, 8, 8)).astype(np.float32)
    o = np.tile(np.array([-2.0, 0.1, 0.2], np.float32), (6, 1))
    o[:, 1:] += rng.uniform(-0.3, 0.3, (6, 2)).astype(np.float32)
    d = rng.normal(size=(6, 3)).astype(np.float32) * 0.1
    d[:, 0] = 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return sigma_grid, color_grid, o, d


_VMIN, _VOX = [-1.0, -1.0, -1.0], [2 / 7] * 3


def test_render_field_and_checkpoint_chunks(render_case):
    """render_field's colour and its gradients to both grids, origins and
    directions against JAX; checkpoint_chunks 4 equals 0."""
    sg, cg, o, d = render_case

    def jloss(sg_, cg_, o_, d_):
        f = jdr.make_grid_field(sg_, cg_, jnp.asarray(_VMIN),
                                jnp.asarray(_VOX))
        out = jdr.render_field(f, o_, d_, 0.5, 3.5, n_samples=32)
        return jnp.sum(out.rgb ** 2) + jnp.sum(out.transmittance)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(
        *map(jnp.asarray, (sg, cg, o, d)))
    grads = []
    for chunks in (0, 4):
        args = [_t(a, True) for a in (sg, cg, o, d)]
        f = tdr.make_grid_field(args[0], args[1], _VMIN, _VOX)
        out = tdr.render_field(f, args[2], args[3], 0.5, 3.5, n_samples=32,
                               checkpoint_chunks=chunks)
        (torch.sum(out.rgb ** 2) + torch.sum(out.transmittance)).backward()
        grads.append([a.grad for a in args])
        for got, w in zip(grads[-1], want):
            _close(got, w)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_render_views_matches_jax(render_case):
    from mri_raytracer_tpu.render.camera import OrbitalCamera as JCam
    from mri_raytracer_tpu_torch.render.camera import OrbitalCamera as TCam

    sg, cg, _, _ = render_case
    poses = [dict(radius=3.0, theta=t, phi=1.2) for t in (0.0, 1.6)]
    jf = jdr.make_grid_field(jnp.asarray(sg), jnp.asarray(cg),
                             jnp.asarray(_VMIN), jnp.asarray(_VOX))
    want = jax.jit(lambda: jdr.render_views(
        jf, [JCam(**k).basis() for k in poses], 12, 10, 0.8, 5.2,
        n_samples=24))()
    tf = tdr.make_grid_field(_t(sg), _t(cg), _VMIN, _VOX)
    got = tdr.render_views(tf, [TCam(**k).basis() for k in poses], 12, 10,
                           0.8, 5.2, n_samples=24)
    assert got.shape == (2, 10, 12, 3)
    _close(got, want)


def test_poi_influence_and_smooth_step():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 3)).astype(np.float32)
    pos = rng.normal(size=(2, 3)).astype(np.float32)
    amp = np.array([1.0, 0.5], np.float32)
    rad = np.array([0.5, 0.3], np.float32)
    jg = jax.grad(lambda p, a, r: jnp.sum(jdr.poi_influence(x, p, a, r)),
                  argnums=(0, 1, 2))(*map(jnp.asarray, (pos, amp, rad)))
    args = [_t(a, True) for a in (pos, amp, rad)]
    tdr.poi_influence(_t(x), *args).sum().backward()
    for a, w in zip(args, jg):
        _close(a.grad, w)
    s = np.linspace(-1, 1, 7).astype(np.float32)
    _close(tdr.smooth_step(_t(s), 0.1, beta=30.0),
           jdr.smooth_step(jnp.asarray(s), 0.1, beta=30.0))


# ---------------------------------------------------------------- importance
def _icdf_cases():
    """(t_bins, weights, u) of tests/test_diffrender.py:135-252: uniform
    mass, mass in two middle bins, near-zero bins, random positive mass."""
    K, n = 8, 16
    t_bins = np.linspace(0.0, 2.0, K + 1, dtype=np.float32)[None]
    u = ((np.arange(n) + 0.5) / n).astype(np.float32)
    w_sp = np.zeros((1, K), np.float32)
    w_sp[0, 2:4] = 1.0
    w_eps = np.full((1, K), 1e-7, np.float32)
    w_eps[0, 0] = 1.0
    w_rnd = (np.abs(np.random.default_rng(4).normal(size=(3, K))) + 0.2
             ).astype(np.float32)
    return [(t_bins, np.ones((1, K), np.float32), u), (t_bins, w_sp, u),
            (t_bins, w_eps, u),
            (np.broadcast_to(t_bins, (3, K + 1)).copy(), w_rnd,
             np.array([0.3, 0.6, 0.9], np.float32))]


@pytest.mark.parametrize("case", range(4))
@pytest.mark.parametrize("fn", ["inverse_cdf_sample", "inverse_cdf_sample_mm",
                                "mm_bin_dt", "mm_bin_dt_n_total"])
def test_inverse_cdf_values_and_grads(case, fn):
    t_bins, w, u = _icdf_cases()[case]
    kw = {"inverse_cdf_sample": {}, "inverse_cdf_sample_mm": {},
          "mm_bin_dt": dict(return_bin_dt=True),
          "mm_bin_dt_n_total": dict(return_bin_dt=True, n_total=64)}[fn]
    name = "inverse_cdf_sample" if fn == "inverse_cdf_sample" \
        else "inverse_cdf_sample_mm"
    probe = np.random.default_rng(5).normal(size=(w.shape[0], len(u))) \
        .astype(np.float32)

    def scalar(out, xp):
        outs = out if isinstance(out, tuple) else (out,)
        pr = xp.asarray(probe) if xp is jnp else torch.from_numpy(probe)
        return sum(xp.sum(o * pr) for o in outs)

    jfn = getattr(jimp, name)
    jout = jfn(jnp.asarray(t_bins), jnp.asarray(w), jnp.asarray(u), **kw)
    jg = jax.grad(lambda tb, ww: scalar(jfn(tb, ww, jnp.asarray(u), **kw),
                                        jnp), argnums=(0, 1))(
        jnp.asarray(t_bins), jnp.asarray(w))
    tb, tw = _t(t_bins, True), _t(w, True)
    tout = getattr(timp, name)(tb, tw, _t(u), **kw)
    for a, b in zip(tout if isinstance(tout, tuple) else (tout,),
                    jout if isinstance(jout, tuple) else (jout,)):
        _close(a, b)
    scalar(tout, torch).backward()
    _close(tb.grad, jg[0], rtol=1e-4, atol=1e-5)
    _close(tw.grad, jg[1], rtol=1e-4, atol=1e-5)


def test_inverse_cdf_frac_clip_tie_gradient():
    """Samples whose in-bin fraction hits the clip's bound exactly get
    jnp.clip's half gradient: u on a CDF knot gives frac exactly 0."""
    t_bins = np.linspace(0.0, 1.0, 5, dtype=np.float32)[None]
    w = np.array([[1.0, 1.0, 1.0, 1.0]], np.float32)
    u = np.array([0.0, 0.5, 0.3], np.float32)
    jg = jax.grad(lambda ww: jnp.sum(jimp.inverse_cdf_sample(
        jnp.asarray(t_bins), ww, jnp.asarray(u))))(jnp.asarray(w))
    tw = _t(w, True)
    timp.inverse_cdf_sample(_t(t_bins), tw, _t(u)).sum().backward()
    _close(tw.grad, jg, rtol=1e-5, atol=1e-7)


def test_coarse_to_fine_render_matches_jax(render_case):
    sg, cg, o, d = render_case

    def run(mod, dr, xp, sg_, cg_, o_, d_):
        f = dr.make_grid_field(sg_, cg_, xp.asarray(_VMIN) if xp is jnp
                               else _VMIN, xp.asarray(_VOX) if xp is jnp
                               else _VOX)
        return mod.coarse_to_fine_render(f, lambda x: f(x)[0] + 1e-3, o_, d_,
                                         0.5, 3.5, 16, 32)

    jC, jT, jt = jax.jit(lambda *a: run(jimp, jdr, jnp, *a))(
        *map(jnp.asarray, (sg, cg, o, d)))
    jg = jax.jit(jax.grad(lambda a, b: jnp.sum(run(
        jimp, jdr, jnp, a, b, jnp.asarray(o), jnp.asarray(d))[0] ** 2),
        argnums=(0, 1)))(jnp.asarray(sg), jnp.asarray(cg))
    tsg, tcg = _t(sg, True), _t(cg, True)
    C, T, t_f = run(timp, tdr, torch, tsg, tcg, _t(o), _t(d))
    _close(C, jC)
    _close(T, jT)
    _close(t_f, jt)
    (C ** 2).sum().backward()
    _close(tsg.grad, jg[0])
    _close(tcg.grad, jg[1])


# ---------------------------------------------------------------- isosurface
def _sphere(c, x, xp):
    return -(xp.linalg.norm(x - c, axis=-1) if xp is jnp
             else torch.linalg.vector_norm(x - c, dim=-1)) + 0.5


def test_isosurface_matches_jax():
    """t*, hit and the gradients to params, origins and directions (rays
    through a sphere of radius 0.5 at c; one ray misses)."""
    rng = np.random.default_rng(6)
    c = np.array([0.2, 0.05, -0.1], np.float32)
    o = np.tile(np.array([-2.0, 0.0, 0.0], np.float32), (5, 1))
    o[:, 1:] += rng.uniform(-0.2, 0.2, (5, 2)).astype(np.float32)
    d = np.tile(np.array([1.0, 0.0, 0.0], np.float32), (5, 1))
    d[:, 1:] += rng.uniform(-0.05, 0.05, (5, 2)).astype(np.float32)
    d[4] = [0.0, 1.0, 0.0]  # misses
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    probe = rng.normal(size=(5,)).astype(np.float32)

    def jf(cc, oo, dd):
        t, hit = jiso.intersect(lambda p, x: _sphere(p, x, jnp), cc, oo, dd,
                                s0=0.0, t0=0.1, t1=4.0)
        return jnp.sum(t * probe), (t, hit)

    (_, (jt, jhit)), jg = jax.value_and_grad(jf, argnums=(0, 1, 2),
                                             has_aux=True)(
        *map(jnp.asarray, (c, o, d)))
    tc, to, td = (_t(a, True) for a in (c, o, d))
    t, hit = tiso.intersect(lambda p, x: _sphere(p, x, torch), tc, to, td,
                            s0=0.0, t0=0.1, t1=4.0)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    assert hit[:4].all() and not hit[4]
    _close(t, jt)
    (t * torch.from_numpy(probe)).sum().backward()
    for got, want in zip((tc.grad, to.grad, td.grad), jg):
        _close(got, want, rtol=1e-4, atol=1e-5)


def test_isosurface_tuple_params():
    """Params as a tuple of tensors: each gets its own implicit gradient
    (dt*/dc = 1 along the ray for a sphere moved along it, as
    tests/test_diffrender.py's test_isosurface_implicit_gradient)."""
    c = torch.tensor(0.2, requires_grad=True)
    r = torch.tensor(0.5, requires_grad=True)
    o = torch.tensor([[-2.0, 0.0, 0.0]])
    d = torch.tensor([[1.0, 0.0, 0.0]])

    def field(p, x):
        cx, rad = p
        return rad - torch.linalg.vector_norm(
            x - torch.stack([cx, cx * 0, cx * 0]), dim=-1)

    t, hit = tiso.intersect(field, (c, r), o, d, t0=0.1, t1=4.0)
    assert bool(hit[0]) and abs(float(t[0].detach()) - 1.7) < 0.01
    t.sum().backward()
    assert abs(float(c.grad) - 1.0) < 0.05
    assert abs(float(r.grad) + 1.0) < 0.05  # a larger sphere is hit sooner


# ------------------------------------------------------------------ gradcheck
def test_gradcheck_trilinear_sample():
    rng = np.random.default_rng(7)
    vol = torch.tensor(rng.normal(size=(4, 5, 3)), requires_grad=True)
    # Away from cell faces and the clamp, where the function is smooth.
    base = rng.integers(0, [3, 4, 2], (6, 3))
    pts = torch.tensor(base + rng.uniform(0.2, 0.8, (6, 3)),
                       requires_grad=True)
    assert torch.autograd.gradcheck(ttri.trilinear_sample, (vol, pts))


def test_gradcheck_composite_fronttoback():
    rng = np.random.default_rng(8)
    colors = torch.tensor(rng.uniform(size=(2, 7, 3)), requires_grad=True)
    alphas = torch.tensor(rng.uniform(0.05, 0.9, (2, 7)), requires_grad=True)
    assert torch.autograd.gradcheck(tdr.composite_fronttoback,
                                    (colors, alphas))


def test_gradcheck_isosurface_intersect():
    o = torch.tensor([[-2.0, 0.05, 0.0], [-2.0, -0.1, 0.1]],
                     dtype=torch.float64, requires_grad=True)
    d = torch.tensor([[1.0, 0.02, 0.0], [1.0, 0.0, -0.03]],
                     dtype=torch.float64, requires_grad=True)
    c = torch.tensor([0.2, 0.0, 0.05], dtype=torch.float64,
                     requires_grad=True)
    t_lo = torch.full((2,), 0.1, dtype=torch.float64)
    t_hi = torch.full((2,), 4.0, dtype=torch.float64)

    def fn(c_, o_, d_):
        # 60 bisection steps: float64's t* is exact to its finite
        # differences (the default 24 steps stop at ~2e-7).
        return tiso._IsosurfaceIntersect.apply(
            lambda p, x: _sphere(p, x, torch), 0.0, 64, False, o_, d_, t_lo,
            t_hi, c_)[0]

    orig = tiso._bisect_root
    tiso._bisect_root = lambda f, lo, hi, iters=24: orig(f, lo, hi, 60)
    try:
        assert torch.autograd.gradcheck(fn, (c, o, d))
    finally:
        tiso._bisect_root = orig
