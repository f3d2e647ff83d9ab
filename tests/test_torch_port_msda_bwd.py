"""Kernel K4's plain version (`ms_deform_attn_bwd_ref`) and the CPU path of
the `ms_deform_attn` autograd Function against the JAX package's Pallas
backward in interpret mode (`_msda_pallas_bwd`, which also chains the tap
gradients to dLoc and dAttw) and against `jax.vjp` of its XLA composition,
on the same numpy inputs: locations in [-0.2, 1.2], locations exactly on
pixel centres (where floor() switches corner), mixed level sizes.

Tolerance: each gradient to 1e-5 of its own largest magnitude, plus 1e-4
rel. dLoc carries a factor W or H (up to 18 here) times sums of up to
D products of unit-normal values, so its entries reach ~1e2 and their f32
rounding ~1e-5 abs; measured differences are below 2e-7 of the largest
entry. A wrong corner, a missing zero-padding test or a lost W/H factor
gives errors of the order of the gradient itself.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_tracking_tpu.ops import msda as jax_msda

from multi_modal_tracking_torch.ops.msda import (ms_deform_attn, ms_deform_attn_bwd,
                                                 ms_deform_attn_bwd_ref, ms_deform_attn_ref)
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

# (B, M, D, P, spatial_shapes, Lq, loc range, share of locations on pixel centres)
CASES = [
    (1, 8, 16, 4, ((18, 18), (18, 18)), 40, (-0.2, 1.2), 0.0),   # the recipe's levels
    (2, 4, 8, 4, ((6, 6), (6, 6)), 24, (-0.2, 1.2), 0.5),        # equal levels, centres
    (1, 2, 4, 3, ((9, 12), (5, 7)), 17, (0.0, 1.0), 0.3),        # mixed level sizes
    (2, 4, 16, 4, ((6, 7), (5, 4), (3, 3)), 9, (-0.2, 1.2), 0.3),  # three mixed levels
    (1, 2, 8, 2, ((4, 4),), 5, (-0.5, 1.5), 1.0),                # one level, all centres
]
IDS = ["recipe_levels", "equal_centres", "mixed", "three_levels", "one_level_centres"]


def _inputs(B, M, D, P, shapes, Lq, lo_hi, centres, seed):
    rng = np.random.default_rng(seed)
    S, L = sum(h * w for h, w in shapes), len(shapes)
    value = rng.standard_normal((B, S, M, D)).astype(np.float32)
    loc = rng.uniform(*lo_hi, size=(B, Lq, M, L, P, 2)).astype(np.float32)
    for lid, (H, W) in enumerate(shapes):
        for ax, n in ((0, W), (1, H)):
            pick = rng.random((B, Lq, M, P)) < centres
            on = ((rng.integers(-1, n + 1, (B, Lq, M, P)) + 0.5) / n).astype(np.float32)
            loc[:, :, :, lid, :, ax] = np.where(pick, on, loc[:, :, :, lid, :, ax])
    w = rng.random((B, Lq, M, L, P)).astype(np.float32)
    g = rng.standard_normal((B, Lq, M * D)).astype(np.float32)
    return value, loc, w / w.sum(axis=(3, 4), keepdims=True), g


def _close(got, want):
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_allclose(a, b, atol=1e-5 * max(1.0, np.abs(b).max()), rtol=1e-4)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bwd_ref_matches_pallas_interpret_and_vjp(case):
    B, M, D, P, shapes, Lq, lo_hi, centres = case
    value, loc, w, g = _inputs(*case, seed=Lq)
    before = ms_deform_attn_bwd.launches
    got = [t.numpy() for t in ms_deform_attn_bwd_ref(
        torch.from_numpy(value), shapes, torch.from_numpy(loc), torch.from_numpy(w),
        torch.from_numpy(g))]
    assert ms_deform_attn_bwd.launches == before
    jv, jl, jw, jg = (jnp.asarray(x) for x in (value, loc, w, g))
    _close(got, jax_msda._msda_pallas_bwd(jv, tuple(shapes), jl, jw, jg, interpret=True))
    _, vjp = jax.vjp(lambda a, b, c: jax_msda._ms_deform_attn_xla(a, shapes, b, c), jv, jl, jw)
    _close(got, vjp(jg))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_function_cpu_grads_match_autograd_of_plain_forward(case):
    """The CPU path of the autograd Function (plain backward through
    backward()) gives the gradients autograd takes through the plain
    gather forward, for a non-contiguous incoming gradient too."""
    B, M, D, P, shapes, Lq, lo_hi, centres = case
    value, loc, w, g = _inputs(*case, seed=Lq + 1)
    grads = []
    for fn in (ms_deform_attn, ms_deform_attn_ref):
        ts = [torch.from_numpy(x).requires_grad_() for x in (value, loc, w)]
        out = fn(ts[0], shapes, ts[1], ts[2])
        gt = torch.from_numpy(np.ascontiguousarray(g.transpose(0, 2, 1))).transpose(1, 2)
        assert not gt.is_contiguous()
        out.backward(gt)
        grads.append([t.grad.numpy() for t in ts])
    _close(*grads)


def test_dead_corners_take_no_gradient():
    """A sample wholly outside its map reads zeros: its value rows get no
    gradient and its location and weight gradients are exactly 0."""
    value = torch.randn(1, 16, 1, 4)
    loc = torch.full((1, 3, 1, 1, 2, 2), -0.5)           # far left/top of a 4x4 map
    attw = torch.rand(1, 3, 1, 1, 2)
    dv, dl, dw = ms_deform_attn_bwd_ref(value, ((4, 4),), loc, attw, torch.randn(1, 3, 4))
    assert torch.count_nonzero(dv) == 0
    assert torch.count_nonzero(dl) == 0 and torch.count_nonzero(dw) == 0
