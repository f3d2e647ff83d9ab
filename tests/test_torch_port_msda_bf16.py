"""Kernel K3-bf16's plain version (multi_modal_tracking_torch.ops.msda on
bf16 CPU tensors) against the JAX package's Pallas kernel at bf16 in
interpret mode (`_msda_pallas_fwd(interpret=True)` with a bf16 value, so
acc_dtype bf16), on the same numpy inputs: value and attention weights
rounded to bf16, f32 locations. The shapes of tests/test_torch_port_msda.py,
the recipe's with 40 queries instead of 648 (interpret mode is slow).

Tolerance: one bf16 unit of the output (rtol 2^-7; atol 1e-5), with at most
1% of the outputs not bit-equal. Both sides round the tap weights, their
per-pixel sums and the output at the same points and differ only in the
order of f32 sums; measured, every output is bit-equal.

Also `msda_plan` at bf16 (itemsize 2) and the bf16 guards.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multi_modal_tracking_tpu.ops import msda as jax_msda

from multi_modal_tracking_torch.ops.msda import (SMEM_MAX, FWD_TABLE_BYTES, ms_deform_attn,
                                                 ms_deform_attn_bf16, ms_deform_attn_ref,
                                                 msda_plan)

from tests.test_torch_port_msda import _inputs

RTOL, ATOL, MAX_DIFFERING = 2.0 ** -7, 1e-5, 0.01

# (B, M, D, P, spatial_shapes, Lq, loc range)
CASES = [
    (1, 8, 64, 4, ((18, 18), (18, 18)), 40, (-0.1, 1.1)),    # the recipe's maps and heads
    (2, 4, 8, 4, ((6, 6), (6, 6)), 72, (-0.1, 1.1)),         # equal levels
    (1, 2, 4, 3, ((9, 12), (5, 7)), 17, (0.0, 1.0)),         # mixed level sizes
    (2, 4, 16, 4, ((6, 7), (5, 4)), 9, (-0.15, 1.15)),       # mixed + out of range
    (1, 2, 8, 2, ((4, 4),), 5, (-0.5, 1.5)),                 # one level, far outside
]


def _bf16_case(case, seed):
    B, M, D, P, shapes, Lq, lo_hi = case
    value, loc, w = _inputs(B, M, D, P, shapes, Lq, lo_hi, seed)
    jv, jw = jnp.asarray(value, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    tv, tw = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
              for x in (jv, jw))
    return (jv, jnp.asarray(loc), jw), (tv, torch.from_numpy(loc), tw), shapes


@pytest.mark.parametrize("case", CASES, ids=["recipe", "equal", "mixed", "mixed_oob", "one_level"])
def test_matches_pallas_interpret_bf16(case):
    (jv, jl, jw), (value, loc, w), shapes = _bf16_case(case, seed=len(case[4]) + case[5])
    before = ms_deform_attn_bf16.launches
    got = ms_deform_attn(value, shapes, loc, w)
    assert ms_deform_attn_bf16.launches == before        # CPU: plain version, no launch
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax_msda._msda_pallas_fwd(jv, tuple(shapes), jl, jw, interpret=True)
                      .astype(jnp.float32))
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.mean(got != want) <= MAX_DIFFERING, np.mean(got != want)


def test_bf16_within_rounding_of_f32():
    """Against the f32 answer on the same (bf16-exact) inputs: the tap
    weights and their sums carry 2^-9 relative rounding each and the output
    one more, so within 2^-7 of the output's scale."""
    _, (value, loc, w), shapes = _bf16_case(CASES[1], seed=3)
    got = ms_deform_attn(value, shapes, loc, w).float()
    want = ms_deform_attn_ref(value.float(), shapes, loc, w.float())
    assert float((got - want).abs().max()) <= 2.0 ** -7 * float(want.abs().max())


def test_plan_bf16():
    """At bf16 the staged slice takes half the shared memory of f32; the
    kernel is chosen by shape as at f32 (B 1 and 4 gather, B 12 and 16
    stage at the recipe's shapes on 132 SMs), and a slice too large for f32
    shared memory still stages at bf16."""
    shapes = ((18, 18), (18, 18))
    for B, want in ((1, "gather"), (4, "gather"), (12, "staged"), (16, "staged")):
        plan = msda_plan(B, 8, 64, shapes, 132, itemsize=2)
        assert plan.fwd == want, (B, plan)
        assert plan.fwd_smem == (2 * 648 * 64 + FWD_TABLE_BYTES if want == "staged" else 0)
    big = ((25, 40),)                     # S 1000: 264,192 B at f32, 136,192 at bf16
    assert msda_plan(16, 8, 64, big, 132).fwd == "gather"
    assert msda_plan(16, 8, 64, big, 132, itemsize=2).fwd == "staged"
    assert msda_plan(16, 8, 64, big, 132, itemsize=2).fwd_smem == 2 * 1000 * 64 + 8192
    assert 2 * 1000 * 64 + 8192 <= SMEM_MAX < 4 * 1000 * 64 + 8192


def test_bf16_with_gradient_raises():
    _, (value, loc, w), shapes = _bf16_case(CASES[4], seed=1)
    with pytest.raises(NotImplementedError, match="bf16 training.*4b"):
        ms_deform_attn(value.requires_grad_(), shapes, loc, w)


def test_bf16_dtypes_checked():
    """bf16 value and attention weights with f32 locations, nothing else."""
    _, (value, loc, w), shapes = _bf16_case(CASES[4], seed=1)
    with pytest.raises(TypeError, match="attention_weights"):
        ms_deform_attn(value, shapes, loc, w.float())
    with pytest.raises(TypeError, match="sampling_locations"):
        ms_deform_attn(value, shapes, loc.to(torch.bfloat16), w)


def test_bf16_non_cpu_tensors_raise_without_fallback():
    value = torch.empty(1, 16, 2, 8, dtype=torch.bfloat16, device="meta")
    loc = torch.empty(1, 5, 2, 1, 4, 2, device="meta")
    attw = torch.empty(1, 5, 2, 1, 4, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CPU or all CUDA"):
        ms_deform_attn(value, ((4, 4),), loc, attw)
