"""The port's classic-tracker helpers (multi_modal_tracking_torch/classic:
dcf.py, optimization.py, augmentation.py, common.py and eco.py's
default_features / fourier_shift) on the CPU against the JAX package's
classic/ on the same inputs, made by numpy from a seed.

Torch runs f32 on one intra-op thread (tests/torch_port_threads.py), JAX at
"highest" matmul precision (tests/conftest.py). Tolerances:
  * windows, labels, FFTs, pad_rfft2, reg_window, the sub-pixel peak and
    localize_advanced's displacement: 1e-5 absolute (1e-4 relative) on
    values of order 1 (a few f32 operations, other FFT libraries);
  * integer peaks and flags: equal;
  * solvers: 1e-4 of the JAX solution's largest magnitude after the same
    iterations (sums of the same terms in other orders), and each within
    1e-3 of the closed-form answer as the JAX tests hold them;
  * augmentation: shifts, flips and dropout copies bit for bit; blur and
    rotation 1e-4 on 0..255 values (a different convolution / gather
    order); scale_about_center 1e-3 upscaling and 1e-2 on 0..255 values
    downscaling (both antialiased triangle filters, computed by other
    algorithms);
  * protected_ring_insert: bit for bit;
  * ATOM's filter solve on the JAX package's init state: 1e-3 of the
    filter's size, where the JAX package's own solve moves by less than
    1e-4 under a reordering of its memory; at the default two Gauss-Newton
    passes it moves by more than 1e-3 in JAX alone (the reason
    tests/test_torch_port_classic_trackers.py holds ATOM's trajectories
    at one pass).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_tracking_tpu.classic import augmentation as jaug
from multi_modal_tracking_tpu.classic import common as jcommon
from multi_modal_tracking_tpu.classic import dcf as jdcf
from multi_modal_tracking_tpu.classic import eco as jeco
from multi_modal_tracking_tpu.classic import optimization as jopt

from multi_modal_tracking_torch.classic import augmentation as aug
from multi_modal_tracking_torch.classic import common
from multi_modal_tracking_torch.classic import dcf
from multi_modal_tracking_torch.classic import eco
from multi_modal_tracking_torch.classic import optimization as opt
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = dict(atol=1e-5, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------------- dcf
@pytest.mark.parametrize("n", [8, 9, 16, 17])
def test_hann_windows(n):
    for centered in (True, False):
        np.testing.assert_allclose(_np(dcf.hann1d(n, centered)),
                                   np.asarray(jdcf.hann1d(n, centered)), **TOL)
    np.testing.assert_allclose(_np(dcf.hann2d(n, n + 3)), np.asarray(jdcf.hann2d(n, n + 3)),
                               **TOL)


def test_gauss_label_and_ffts():
    c = np.asarray([5.3, 7.8], np.float32)
    y = dcf.gauss_label_2d(13, 16, 2.2, _t(c))
    np.testing.assert_allclose(_np(y), np.asarray(jdcf.gauss_label_2d(13, 16, 2.2,
                                                                      jnp.asarray(c))), **TOL)
    x = np.random.default_rng(0).standard_normal((3, 10, 13)).astype(np.float32)
    xf = dcf.fft2(_t(x))
    np.testing.assert_allclose(_np(xf), np.asarray(jdcf.fft2(jnp.asarray(x))), atol=1e-4)
    np.testing.assert_allclose(_np(dcf.ifft2(xf, (10, 13))), x, **TOL)


@pytest.mark.parametrize("h,w,H,W", [(6, 6, 24, 24), (8, 12, 16, 24), (7, 7, 21, 21),
                                     (6, 9, 24, 27), (5, 8, 10, 16), (6, 6, 6, 6)])
def test_pad_rfft2_even_and_odd_sizes(h, w, H, W):
    """Exact Fourier upsampling: the spectrum equals JAX's, and the
    upsampled map passes through the samples."""
    x = np.random.default_rng(h * 100 + w).standard_normal((2, h, w)).astype(np.float32)
    got = dcf.pad_rfft2(dcf.fft2(_t(x)), (H, W), (h, w))
    want = jdcf.pad_rfft2(jdcf.fft2(jnp.asarray(x)), (H, W), (h, w))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4, rtol=1e-4)
    big = _np(dcf.ifft2(got, (H, W)))
    np.testing.assert_allclose(big[:, ::H // h, ::W // w], x, atol=1e-5)


def test_max2d_and_subpixel_peak():
    rng = np.random.default_rng(1)
    for trial in range(6):
        s = rng.standard_normal((17, 19)).astype(np.float32)
        if trial == 5:                      # the peak on the border: the clipped neighbourhood
            s[0, 18] = 9.0
        v, p = dcf.max2d(_t(s))
        jv, jp = jdcf.max2d(jnp.asarray(s))
        assert float(v) == float(jv) and _np(p).tolist() == np.asarray(jp).tolist()
        np.testing.assert_allclose(_np(dcf.subpixel_peak(_t(s), p)),
                                   np.asarray(jdcf.subpixel_peak(jnp.asarray(s), jp)), **TOL)


def _blob(h, w, cy, cx, amp, sig=1.5):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig * sig))


LOCALISE_CASES = {
    # name: (peaks [(cy, cx, amp)], prev_disp, expected flag)
    "normal": ([(9.2, 8.7, 1.0)], None, dcf.FLAG_NORMAL),
    "not_found": ([(9.0, 9.0, 0.2)], None, dcf.FLAG_NOT_FOUND),
    "hard_negative": ([(9.0, 9.0, 1.0), (2.0, 15.0, 0.6)], None, dcf.FLAG_HARD_NEGATIVE),
    "uncertain": ([(9.0, 9.0, 1.0), (3.0, 13.0, 0.9)], (0.0, 0.0), dcf.FLAG_UNCERTAIN),
    "hn_keep": ([(9.0, 9.0, 1.0), (1.0, 17.0, 0.9)], (-1.0, 0.5), dcf.FLAG_HARD_NEGATIVE),
    "hn_switch": ([(9.0, 9.0, 1.0), (1.0, 17.0, 0.9)], (-8.0, 8.0), dcf.FLAG_HARD_NEGATIVE),
}


@pytest.mark.parametrize("case", sorted(LOCALISE_CASES))
def test_localize_advanced_flag_tree(case):
    """Every branch of the decision tree, with and without a previous
    displacement: the same flag, displacement and peak as JAX."""
    peaks, prev, flag = LOCALISE_CASES[case]
    h = w = 19
    s = sum(_blob(h, w, cy, cx, a) for cy, cx, a in peaks)
    s = s + 0.01 * np.random.default_rng(2).standard_normal((h, w)).astype(np.float32)
    tsz = np.asarray([3.0, 2.5], np.float32)
    prev_t = None if prev is None else _t(np.asarray(prev, np.float32))
    prev_j = None if prev is None else jnp.asarray(prev, jnp.float32)
    d, f, s1 = dcf.localize_advanced(_t(s), _t(tsz), prev_t)
    jd, jf, js1 = jdcf.localize_advanced(jnp.asarray(s), jnp.asarray(tsz), prev_j)
    assert int(f) == int(jf) == flag
    np.testing.assert_allclose(_np(d), np.asarray(jd), **TOL)
    assert float(s1) == float(js1)


@pytest.mark.parametrize("hw", [(63, 63), (56, 56), (31, 47)])
@pytest.mark.parametrize("bank", ["shallow", "deep"])
def test_reg_window_sizes(hw, bank):
    """The sizes of tests/test_eco_reg_window.py, both parameter sets, and
    the square variant on one."""
    wmin, wedge, thr = (1e-4, 10e-3, 0.05) if bank == "shallow" else (10e-4, 50e-3, 0.1)
    target = np.asarray([12.0, 9.0], np.float32)
    for square in (False, True):
        got = dcf.reg_window(*hw, _t(target), window_min=wmin, window_edge=wedge,
                             sparsity_threshold=thr, square=square)
        want = jdcf.reg_window(*hw, jnp.asarray(target), window_min=wmin, window_edge=wedge,
                               sparsity_threshold=thr, square=square)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6, rtol=1e-4)


def test_eco_default_features_and_fourier_shift():
    rng = np.random.default_rng(3)
    patch = rng.uniform(0, 1, (2, 32, 40, 3)).astype(np.float32)
    got = eco.default_features(_t(patch))
    for i in range(2):
        np.testing.assert_allclose(_np(got[i]), np.asarray(jeco.default_features(
            jnp.asarray(patch[i]))), **TOL)
    xf = np.fft.rfft2(rng.standard_normal((3, 12, 15))).astype(np.complex64)
    shift = np.asarray([1.7, -2.4], np.float32)
    np.testing.assert_allclose(_np(eco.fourier_shift(_t(xf), _t(shift), 12, 15)),
                               np.asarray(jeco.fourier_shift(jnp.asarray(xf),
                                                             jnp.asarray(shift), 12, 15)),
                               atol=1e-4, rtol=1e-4)
    # a batch of shifts, one per sample, as ECO's init recentres them
    shifts = rng.uniform(-3, 3, (3, 2)).astype(np.float32)
    got = eco.fourier_shift(_t(xf), _t(shifts), 12, 15)
    for i in range(3):
        np.testing.assert_allclose(_np(got[i]), np.asarray(jeco.fourier_shift(
            jnp.asarray(xf[i]), jnp.asarray(shifts[i]), 12, 15)), atol=1e-4, rtol=1e-4)


# -------------------------------------------------------------------- solvers
def _spd(n, seed):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    return (M @ M.T + n * np.eye(n)).astype(np.float32)


def _close(got, want, closed=None):
    got, want = _np(got), np.asarray(want)
    np.testing.assert_allclose(got, want, atol=1e-4 * max(np.abs(want).max(), 1e-6))
    if closed is not None:
        np.testing.assert_allclose(got, closed, rtol=1e-3, atol=1e-3)


def test_cg_real_and_tree_and_forgetting():
    A = _spd(12, 0)
    b = np.random.default_rng(1).standard_normal(12).astype(np.float32)
    res = opt.conjugate_gradient(lambda x: _t(A) @ x, _t(b), num_iter=12)
    jres = jopt.conjugate_gradient(lambda x: jnp.asarray(A) @ x, jnp.asarray(b), num_iter=12)
    _close(res.x, jres.x, np.linalg.solve(A, b))
    np.testing.assert_allclose(_np(res.residual_norms), np.asarray(jres.residual_norms),
                               rtol=1e-2, atol=1e-6)
    A1, A2 = _spd(5, 2), _spd(7, 3)
    tree = lambda T, x: {"a": T(A1) @ x["a"], "b": T(A2) @ x["b"]}  # noqa: E731
    b2 = {"a": np.ones(5, np.float32), "b": 2 * np.ones(7, np.float32)}
    x0 = {"a": 0.1 * np.ones(5, np.float32), "b": np.zeros(7, np.float32)}
    res = opt.conjugate_gradient(lambda x: tree(_t, x), {k: _t(v) for k, v in b2.items()},
                                 x0={k: _t(v) for k, v in x0.items()}, num_iter=4,
                                 forgetting_rate=0.9)
    jres = jopt.conjugate_gradient(lambda x: tree(jnp.asarray, x),
                                   {k: jnp.asarray(v) for k, v in b2.items()},
                                   x0={k: jnp.asarray(v) for k, v in x0.items()}, num_iter=4,
                                   forgetting_rate=0.9)
    for k in b2:
        _close(res.x[k], jres.x[k])


def test_normal_equations_real_least_squares():
    rng = np.random.default_rng(4)
    J = rng.standard_normal((20, 6)).astype(np.float32)
    y = rng.standard_normal(20).astype(np.float32)
    x = opt.solve_normal_equations(lambda x: _t(J) @ x - _t(y), torch.zeros(6), num_iter=12,
                                   reg=0.0)
    jx = jopt.solve_normal_equations(lambda x: jnp.asarray(J) @ x - jnp.asarray(y),
                                     jnp.zeros(6), num_iter=12, reg=0.0)
    _close(x, jx, np.linalg.lstsq(J, y, rcond=None)[0])


def _complex_problem(seed, m=12, n=5):
    rng = np.random.default_rng(seed)
    Z = (rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))).astype(np.complex64)
    y = (rng.standard_normal(m) + 1j * rng.standard_normal(m)).astype(np.complex64)
    return Z, y


def _conj_wrapped_solve(residual_fn, x, num_iter):
    """solve_normal_equations with the JAX package's conj wrap around the
    adjoint (classic/optimization.py:361-366) copied into PyTorch."""
    from torch.func import jvp, vjp
    r0, vjp_fn = vjp(residual_fn, x)

    def JH(w):
        return torch.conj(vjp_fn(torch.conj(w))[0])

    def A(dx):
        return JH(jvp(residual_fn, (x,), (dx,))[1])

    return x + opt.conjugate_gradient(A, JH(-r0), num_iter=num_iter).x


def test_normal_equations_complex_least_squares():
    """The complex normal equations converge in the port: PyTorch's vjp is
    already the Hermitian adjoint. With the JAX package's conj wrap copied,
    the system is complex symmetric (Z^T Z), not Hermitian, and CG misses
    the solution by orders of magnitude more: this test fails if the wrap
    is copied into the port."""
    Z, y = _complex_problem(5)
    want = np.linalg.lstsq(Z, y, rcond=None)[0]
    x = opt.solve_normal_equations(lambda x: _t(Z) @ x - _t(y),
                                   torch.zeros(5, dtype=torch.complex64), num_iter=20)
    jx = jopt.solve_normal_equations(lambda x: jnp.asarray(Z) @ x - jnp.asarray(y),
                                     jnp.zeros(5, jnp.complex64), num_iter=20)
    _close(x, jx, want)
    wrapped = _conj_wrapped_solve(lambda x: _t(Z) @ x - _t(y),
                                  torch.zeros(5, dtype=torch.complex64), 20)
    assert np.abs(_np(wrapped) - want).max() > 100 * np.abs(_np(x) - want).max() + 1e-2


def test_normal_equations_mixed_real_complex_tree():
    """A complex filter and a real matrix in one tree (ECO's joint problem's
    shape): the port's joint solve reaches both least-squares answers."""
    rng = np.random.default_rng(6)
    Z, y = _complex_problem(6, 30, 4)
    M = rng.standard_normal((30, 3)).astype(np.float32)
    t = rng.standard_normal(30).astype(np.float32)

    def res(v, T):
        return {"c": T(Z) @ v["f"] - T(y), "r": T(M) @ v["p"] - T(t)}

    v = opt.solve_normal_equations(lambda v: res(v, _t),
                                   {"f": torch.zeros(4, dtype=torch.complex64),
                                    "p": torch.zeros(3)}, num_iter=30)
    jv = jopt.solve_normal_equations(lambda v: res(v, jnp.asarray),
                                     {"f": jnp.zeros(4, jnp.complex64), "p": jnp.zeros(3)},
                                     num_iter=30)
    _close(v["f"], jv["f"], np.linalg.lstsq(Z, y, rcond=None)[0])
    _close(v["p"], jv["p"], np.linalg.lstsq(M, t, rcond=None)[0])
    assert v["p"].dtype == torch.float32 and v["f"].dtype == torch.complex64


def test_gauss_newton_real_and_complex():
    t = np.linspace(0, 1, 16).astype(np.float32)
    y = np.exp(0.7 * t).astype(np.float32)
    x = opt.gauss_newton_cg(lambda a: torch.exp(a * _t(t)) - _t(y), torch.tensor(0.2),
                            num_gn_iter=6, num_cg_iter=4)
    jx = jopt.gauss_newton_cg(lambda a: jnp.exp(a * jnp.asarray(t)) - jnp.asarray(y),
                              jnp.asarray(0.2), num_gn_iter=6, num_cg_iter=4)
    assert abs(float(x) - float(jx)) < 1e-5 and abs(float(x) - 0.7) < 1e-3
    # a complex scale fitted by GN with damping
    Z, yc = _complex_problem(7, 16, 1)
    a_true = np.complex64(0.8 - 0.3j)
    target = (a_true * Z[:, 0]).astype(np.complex64)
    x = opt.gauss_newton_cg(lambda a: a * _t(Z[:, 0]) - _t(target),
                            torch.zeros((), dtype=torch.complex64), num_gn_iter=2,
                            num_cg_iter=3, reg=1e-3)
    jx = jopt.gauss_newton_cg(lambda a: a * jnp.asarray(Z[:, 0]) - jnp.asarray(target),
                              jnp.zeros((), jnp.complex64), num_gn_iter=2, num_cg_iter=3,
                              reg=1e-3)
    assert abs(complex(x) - complex(jx)) < 1e-5 and abs(complex(x) - a_true) < 1e-3


def test_explicit_jacobian_products_equal_torch_func(monkeypatch):
    """The trackers write J dx out (`jvp_fn`): their solves equal the
    torch.func.jvp path, on a mixed bilinear tree and on ECO's joint init
    and ATOM's filter solve; the one reverse pass that gives J^H w equals
    torch.func.vjp's adjoint."""
    rng = np.random.default_rng(13)
    Z, y = _complex_problem(14, 20, 3)
    M = _t(rng.standard_normal((3, 2)).astype(np.float32))

    def res(v):
        return {"data": _t(Z) @ (v["f"] * (M @ v["p"]).to(torch.complex64)) - _t(y),
                "reg": 0.1 * v["p"]}

    def jvp_fn(v, d):
        Mp, Md = (M @ v["p"]).to(torch.complex64), (M @ d["p"]).to(torch.complex64)
        return {"data": _t(Z) @ (d["f"] * Mp + v["f"] * Md), "reg": 0.1 * d["p"]}

    v0 = {"f": _t((rng.standard_normal(3) + 1j).astype(np.complex64)),
          "p": _t(rng.standard_normal(2).astype(np.float32))}
    a = opt.solve_normal_equations(res, v0, num_iter=6)
    b = opt.solve_normal_equations(res, v0, num_iter=6, jvp_fn=jvp_fn)
    for k in a:
        _close(b[k], _np(a[k]))
    from torch.func import vjp
    w = {"data": _t((rng.standard_normal(20) - 1j).astype(np.complex64)),
         "reg": _t(rng.standard_normal(2).astype(np.float32))}
    got, want = opt._adjoint(res, v0)[1](w), vjp(res, v0)[1](w)[0]
    for k in got:
        _close(got[k], _np(want[k]))

    from multi_modal_tracking_torch.classic import atom, build_classic_tracker
    generic = opt.solve_normal_equations

    def without_jvp(*args, jvp_fn=None, **kw):
        return generic(*args, **kw)

    frame = np.random.default_rng(15).integers(0, 255, (96, 120, 3), np.uint8)
    info = {"init_bbox": [40.0, 30.0, 32.0, 28.0]}
    for mod, name, kw in ((eco, "eco", dict(crop_size=64, init_gn_iter=2, init_cg_per_gn=3)),
                          (atom, "atom", dict(crop_size=64, num_gn_iter=1, num_cg_iter=6))):
        filters = []
        for patch in (False, True):
            if patch:
                monkeypatch.setattr(mod, "solve_normal_equations", without_jvp)
            t = build_classic_tracker(name, device="cpu", **kw)
            t.initialize(frame, info)
            filters.append(t._state.filter_f[0] if name == "eco" else t._state.filt)
        _close(filters[0], _np(filters[1]))


def test_gradient_descent_and_steepest_descent():
    A = _spd(6, 5)
    b = np.random.default_rng(6).standard_normal(6).astype(np.float32)
    lr = float(1.0 / np.linalg.eigvalsh(A).max())
    x = opt.gradient_descent_l2(lambda x: 0.5 * x @ _t(A) @ x - _t(b) @ x, torch.zeros(6),
                                num_iter=400, step_length=lr, momentum=0.9)
    jx = jopt.gradient_descent_l2(lambda x: 0.5 * x @ jnp.asarray(A) @ x - jnp.asarray(b) @ x,
                                  jnp.zeros(6), num_iter=400, step_length=lr, momentum=0.9)
    np.testing.assert_allclose(_np(x), np.asarray(jx), atol=1e-4)
    np.testing.assert_allclose(_np(x), np.linalg.solve(A, b), rtol=1e-2, atol=1e-2)
    A = _spd(8, 7)
    b = np.random.default_rng(8).standard_normal(8).astype(np.float32)
    x = opt.steepest_descent_quadratic(lambda x: _t(A) @ x, _t(b), torch.zeros(8), num_iter=60)
    jx = jopt.steepest_descent_quadratic(lambda x: jnp.asarray(A) @ x, jnp.asarray(b),
                                         jnp.zeros(8), num_iter=60)
    np.testing.assert_allclose(_np(x), np.asarray(jx), atol=1e-4)
    np.testing.assert_allclose(_np(x), np.linalg.solve(A, b), rtol=1e-2, atol=1e-2)


# ATOM's classifier solve, on the JAX package's own init state
def test_atom_filter_solve_sensitivity():
    """Why ATOM's trajectories are held at one Gauss-Newton pass: the
    classifier's normal equations (4096 unknowns, about 1600 weighted rows,
    Tikhonov 0.1) are ill-conditioned, and at the default two passes of 5 CG
    steps the JAX package's own f32 filter moves by more than 1e-3 of its
    size when its memory is merely listed in another order (the same sums,
    rounded in another order); with one pass of 6 steps it moves by less
    than 1e-4, and the port's filter lies within 1e-3 of JAX's."""
    from multi_modal_tracking_tpu.classic.atom import ATOMTracker as JATOM
    from multi_modal_tracking_torch.classic import build_classic_tracker
    from multi_modal_tracking_torch.classic.atom import ATOMState
    from tests.test_classic_atom import _frame
    jt = JATOM(crop_size=160, search_factor=4.0, refine=False)
    pt = build_classic_tracker("atom", device="cpu", crop_size=160, search_factor=4.0,
                               refine=False)
    st = jax.jit(jt._init_fn)(jt._bb_vars, jnp.asarray(_frame(70.0, 80.0), jnp.float32),
                              jnp.asarray([54.0, 64.0, 32.0, 32.0], jnp.float32))
    st = st._replace(filt=jnp.zeros_like(st.filt))
    perm = np.random.default_rng(0).permutation(st.samples.shape[0])
    st_perm = st._replace(samples=st.samples[perm], labels=st.labels[perm],
                          weights=st.weights[perm])
    pst = ATOMState(filt=torch.zeros(256, 4, 4), samples=_t(st.samples).permute(0, 3, 1, 2),
                    labels=_t(st.labels), weights=_t(st.weights), mem_ptr=_t(st.mem_ptr),
                    center=_t(st.center), target_sz=_t(st.target_sz))

    def dist(a, b):
        return float(np.abs(_np(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())

    for (gn, cg), jax_bound in (((2, 5), None), ((1, 6), 1e-4)):
        solve = jax.jit(lambda s: jt._optimize_filter(s, gn, cg).filt)
        want = solve(st)
        self_dist = dist(solve(st_perm), want)
        if jax_bound is None:
            assert self_dist > 1e-3, self_dist
        else:
            assert self_dist < jax_bound, self_dist
            got = pt._optimize_filter(pst, gn, cg).filt.permute(1, 2, 0)
            assert dist(got, want) < 1e-3


# --------------------------------------------------------------- augmentation
@pytest.fixture(scope="module")
def crop():
    return np.random.default_rng(9).uniform(0, 255, (33, 40, 3)).astype(np.float32)


@pytest.mark.parametrize("shift", [(0, 0), (5, -3), (-7, 11), (2, 2)])
def test_translate_and_flips(crop, shift):
    np.testing.assert_array_equal(_np(aug.translate(_t(crop), *shift)),
                                  np.asarray(jaug.translate(jnp.asarray(crop), *shift)))
    np.testing.assert_array_equal(_np(aug.fliplr(_t(crop))), np.asarray(jaug.fliplr(crop)))
    np.testing.assert_array_equal(_np(aug.flipud(_t(crop))), np.asarray(jaug.flipud(crop)))


@pytest.mark.parametrize("sigma", [(3, 1), (1, 3), (2, 2), (2, 0.2), 1.5])
def test_blur(crop, sigma):
    np.testing.assert_allclose(_np(aug.blur(_t(crop), sigma)),
                               np.asarray(jaug.blur(jnp.asarray(crop), sigma)), atol=1e-4)
    np.testing.assert_allclose(_np(aug.blur(_t(crop[..., 0]), sigma)),
                               np.asarray(jaug.blur(jnp.asarray(crop[..., 0]), sigma)), atol=1e-4)


@pytest.mark.parametrize("angle", [5, -10, 45, -60, 90])
def test_rotate(crop, angle):
    """map_coordinates(order=1, cval=0): on an odd x even crop, and on a
    single channel."""
    np.testing.assert_allclose(_np(aug.rotate(_t(crop), angle)),
                               np.asarray(jaug.rotate(jnp.asarray(crop), angle)), atol=1e-4)
    np.testing.assert_allclose(_np(aug.rotate(_t(crop[..., 1]), angle)),
                               np.asarray(jaug.rotate(jnp.asarray(crop[..., 1]), angle)),
                               atol=1e-4)


@pytest.mark.parametrize("factor,atol", [(1.25, 1e-3), (0.8, 1e-2)])
def test_scale_about_center(crop, factor, atol):
    """jax.image.resize(bilinear) antialiases when it shrinks, as
    F.interpolate(antialias=True) does; the two libraries compute the
    triangle filter's weights differently, so a shrink agrees within 1e-2
    on 0..255 values (measured 1e-4 or less), a zoom within 1e-3."""
    np.testing.assert_allclose(_np(aug.scale_about_center(_t(crop), factor)),
                               np.asarray(jaug.scale_about_center(jnp.asarray(crop), factor)),
                               atol=atol)


def test_feature_dropout_with_the_jax_draw():
    """The JAX package's bernoulli mask is uniform(key, shape) < 1 - prob:
    the port given the same uniform bits makes the same copies."""
    feat = np.random.default_rng(10).standard_normal((5, 6, 12)).astype(np.float32)  # (h, w, C)
    key = jax.random.PRNGKey(7)
    want = jaug.feature_dropout2d(jnp.asarray(feat), 4, 0.2, key)          # (4, h, w, C)
    u = _t(jax.random.uniform(key, (4, 1, 1, 12)))
    got = aug.feature_dropout2d(_t(feat.transpose(2, 0, 1)), 4, 0.2, u)    # (4, C, h, w)
    np.testing.assert_array_equal(_np(got).transpose(0, 2, 3, 1), np.asarray(want))
    assert 0 < float((got == 0).float().mean()) < 1


@pytest.mark.parametrize("spec", ["default", "eco", "scale"])
def test_init_augmenter(spec):
    """The transform list, the numpy random shifts and the batch: equal
    to JAX's (rotations and blurs within 1e-4)."""
    s = {"default": None, "eco": jaug.ECO_AUGMENTATION,
         "scale": {"scale": [1.2, 0.9], "fliplr": True, "dropout": (2, 0.5)}}[spec]
    jt = jaug.InitAugmenter(48, spec=s, seed=3)
    pt = aug.InitAugmenter(48, spec=s, seed=3)
    assert pt.ops == jt.ops and pt.num_samples == jt.num_samples
    np.testing.assert_array_equal(pt.shifts, jt.shifts)
    img = np.random.default_rng(11).uniform(0, 255, (48, 48, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(pt(_t(img))), np.asarray(jt(jnp.asarray(img))), atol=1e-2)


def test_torch_draws_depend_on_site_and_frame_only():
    d = aug.TorchDraws(4, "cpu", {"a": 1, "b": 2})
    assert torch.equal(d("a", (3, 4), 5), d("a", (3, 4), 5))
    assert not torch.equal(d("a", (3, 4), 5), d("a", (3, 4), 6))
    assert not torch.equal(d("a", (3, 4), 5), d("b", (3, 4), 5))


# --------------------------------------------------------------------- common
def test_protected_ring_insert_across_the_wrap():
    """Eleven inserts into a memory of 6 with 3 protected slots: the ring
    wraps twice over slots 3..5, skipped inserts change nothing, a hard
    negative boosts the rate; bit for bit against JAX at every step."""
    rng = np.random.default_rng(12)
    M, A = 6, 3
    kw = dict(memory_size=M, n_protected=A, learning_rate=0.05, hard_negative_learning_rate=0.2)
    stored = rng.standard_normal((M, 2, 3)).astype(np.float32)
    boxes = rng.standard_normal((M, 4)).astype(np.float32)
    w = np.asarray([1 / 3] * 3 + [0] * 3, np.float32)
    p_state = (_t(stored), _t(boxes), _t(w), torch.tensor(A, dtype=torch.int32))
    j_state = (jnp.asarray(stored), jnp.asarray(boxes), jnp.asarray(w), jnp.int32(A))
    for step in range(11):
        new = rng.standard_normal((2, 3)).astype(np.float32)
        nb = rng.standard_normal(4).astype(np.float32)
        ok = step not in (2, 7)
        flag = dcf.FLAG_HARD_NEGATIVE if step in (4, 9) else dcf.FLAG_NORMAL
        (s, b), pw, pp = common.protected_ring_insert(
            p_state[3], torch.tensor(ok), torch.tensor(flag, dtype=torch.int32),
            [(p_state[0], _t(new)), (p_state[1], _t(nb))], p_state[2], **kw)
        (js, jb), jw, jp = jcommon.protected_ring_insert(
            j_state[3], jnp.asarray(ok), jnp.int32(flag),
            [(j_state[0], jnp.asarray(new)), (j_state[1], jnp.asarray(nb))], j_state[2], **kw)
        for got, want in ((s, js), (b, jb), (pw, jw)):
            np.testing.assert_array_equal(_np(got), np.asarray(want))
        assert int(pp) == int(jp)
        p_state, j_state = (s, b, pw, pp), (js, jb, jw, jp)
    assert int(p_state[3]) == A + 9                  # 11 inserts, 2 skipped
    assert common.FLAG_NAMES == jcommon.FLAG_NAMES
