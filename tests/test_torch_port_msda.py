"""Kernel K3's plain version (multi_modal_tracking_torch.ops.msda on CPU
tensors) against the JAX package's Pallas kernel in interpret mode and its
XLA composition, on the same numpy inputs.

Tolerance 2e-5 abs / 1e-4 rel, the one tests/test_msda.py holds the JAX
op to the grid_sample oracle with: f32 bilinear weights times unit-normal
values, up to L*P*4 = 32 terms per output, summed in other orders.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multi_modal_tracking_tpu.ops import msda as jax_msda

from multi_modal_tracking_torch.ops.msda import ms_deform_attn

# (B, M, D, P, spatial_shapes, Lq, loc range)
CASES = [
    (1, 8, 64, 4, ((18, 18), (18, 18)), 648, (-0.1, 1.1)),   # the recipe's shapes
    (2, 4, 8, 4, ((6, 6), (6, 6)), 72, (-0.1, 1.1)),         # equal levels
    (1, 2, 4, 3, ((9, 12), (5, 7)), 17, (0.0, 1.0)),         # mixed level sizes
    (2, 4, 16, 4, ((6, 7), (5, 4)), 9, (-0.15, 1.15)),       # mixed + out of range
    (1, 2, 8, 2, ((4, 4),), 5, (-0.5, 1.5)),                 # one level, far outside
]


def _inputs(B, M, D, P, shapes, Lq, lo_hi, seed):
    rng = np.random.default_rng(seed)
    S, L = sum(h * w for h, w in shapes), len(shapes)
    value = rng.standard_normal((B, S, M, D)).astype(np.float32)
    loc = rng.uniform(*lo_hi, size=(B, Lq, M, L, P, 2)).astype(np.float32)
    w = np.array(jax.nn.softmax(jnp.asarray(
        rng.standard_normal((B, Lq, M, L * P)).astype(np.float32)), -1)).reshape(B, Lq, M, L, P)
    return value, loc, w


@pytest.mark.parametrize("case", CASES, ids=["recipe", "equal", "mixed", "mixed_oob", "one_level"])
def test_matches_pallas_interpret_and_xla(case):
    B, M, D, P, shapes, Lq, lo_hi = case
    value, loc, w = _inputs(B, M, D, P, shapes, Lq, lo_hi, seed=len(shapes) + Lq)
    before = ms_deform_attn.launches
    got = ms_deform_attn(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                         torch.from_numpy(w)).numpy()
    assert ms_deform_attn.launches == before            # CPU: plain version, no launch
    args = (jnp.asarray(value), tuple(shapes), jnp.asarray(loc), jnp.asarray(w))
    xla = jax_msda._ms_deform_attn_xla(*args)
    np.testing.assert_allclose(got, np.asarray(xla), atol=2e-5, rtol=1e-4)
    if Lq <= 100:   # interpret mode is slow at the recipe's 648 queries
        pallas = jax_msda.ms_deform_attn_fused(*args, True)
        np.testing.assert_allclose(got, np.asarray(pallas), atol=2e-5, rtol=1e-4)


def test_sample_on_pixel_centres_is_exact():
    """loc at pixel centres ((i + 0.5) / W) samples the value exactly: the
    -0.5 half-pixel offset is where grid_sample(align_corners=False) puts it."""
    H, W, M, D = 3, 5, 1, 2
    value = torch.arange(H * W * M * D, dtype=torch.float32).reshape(1, H * W, M, D)
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    loc = torch.stack([(xs.flatten() + 0.5) / W, (ys.flatten() + 0.5) / H], -1)
    loc = loc.reshape(1, H * W, 1, 1, 1, 2)
    out = ms_deform_attn(value, ((H, W),), loc, torch.ones(1, H * W, 1, 1, 1))
    torch.testing.assert_close(out, value.reshape(1, H * W, D), atol=1e-6, rtol=0)


def test_meta_tensors_raise():
    value = torch.empty(1, 16, 2, 8, device="meta")
    loc = torch.empty(1, 5, 2, 1, 4, 2, device="meta")
    w = torch.empty(1, 5, 2, 1, 4, device="meta")
    with pytest.raises(ValueError, match="on meta"):
        ms_deform_attn(value, ((4, 4),), loc, w)
