"""Kernel K4-bf16's plain version (`ms_deform_attn_bwd_bf16_ref`) and the CPU
path of the bf16 `ms_deform_attn` autograd Function against the JAX
package's Pallas backward at bf16 in interpret mode (`_msda_pallas_bwd`
with a bf16 value, so acc_dtype bf16, and its chain to dLoc and dAttw), on
the same numpy inputs: value, attention weights and incoming gradient
rounded to bf16, f32 locations; the cases of
tests/test_torch_port_msda_bwd.py (locations outside the maps, on pixel
centres, mixed level sizes, three levels).

The plain version follows the Pallas kernel's rounding points exactly,
taps that share a source pixel included: per level the dense row A of the
rounded tap weights, summed per pixel in tap order and rounded again
(`_bf16_tap_rows`, the forward's too). So no location needs a looser
bound here; the kernel, whose tap kernel builds the same A
(tests/test_torch_port_msda_bf16_hopper.py models it), is held to this
plain version on the card (chip_smoke.py, kernels phase).

Tolerances:
  * dValue and dAttw (bf16): one bf16 unit of each value (rtol 2^-7) plus
    half a unit of the tensor's largest value (atol 2^-9 x max|ref|), at
    most 1% of the values not bit-equal. Both sides form the same bf16
    operands and differ in the order of f32 sums (over queries for
    dValue, over channels for dw), which can move a result across a bf16
    rounding boundary; where dAttw's four corner terms cancel, that is more
    than one unit of the small result.
  * dLoc (f32): 1e-5 of its largest magnitude plus 1e-4 rel, the f32
    test's bound: sums of D exact products of bf16 values in f32, in
    another order, times W or H.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_tracking_tpu.ops import msda as jax_msda

from multi_modal_tracking_torch.ops.msda import (SMEM_MAX, TAP_BWD_SMEM, ms_deform_attn,
                                                 ms_deform_attn_bwd_bf16,
                                                 ms_deform_attn_bwd_bf16_ref,
                                                 ms_deform_attn_bwd_ref, msda_plan)

from tests.test_torch_port_msda_bwd import CASES, IDS, _inputs
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

RTOL, ATOL_OF_MAX, MAX_DIFFERING = 2.0 ** -7, 2.0 ** -9, 0.01


def _bf16_case(case, seed):
    value, loc, w, g = _inputs(*case, seed=seed)
    jv, jw, jg = (jnp.asarray(x, jnp.bfloat16) for x in (value, w, g))
    tv, tw, tg = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
                  for x in (jv, jw, jg))
    return (jv, jnp.asarray(loc), jw, jg), (tv, torch.from_numpy(loc), tw, tg)


def _close_bf16(got, want, name):
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_OF_MAX * np.abs(want).max(),
                               err_msg=name)
    assert np.mean(got != want) <= MAX_DIFFERING, (name, np.mean(got != want))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bwd_ref_matches_pallas_interpret_bf16(case):
    shapes = case[4]
    (jv, jl, jw, jg), (value, loc, w, g) = _bf16_case(case, seed=case[5])
    want = jax_msda._msda_pallas_bwd(jv, tuple(shapes), jl, jw, jg, interpret=True)
    before = ms_deform_attn_bwd_bf16.launches
    got = ms_deform_attn_bwd_bf16_ref(value, shapes, loc, w, g)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32, torch.bfloat16]
    assert [w_.dtype for w_ in want] == [jnp.bfloat16, jnp.float32, jnp.bfloat16]
    _close_bf16(got[0], want[0], "dValue")
    _close_bf16(got[2], want[2], "dAttw")
    dloc = np.asarray(want[1])
    np.testing.assert_allclose(got[1].numpy(), dloc, atol=1e-5 * max(1.0, np.abs(dloc).max()),
                               rtol=1e-4, err_msg="dLoc")

    # the autograd Function on CPU tensors: the plain bf16 forward and
    # backward, no kernel launch, the gradients of the plain backward in
    # the primal dtypes
    leaves = [t.clone().requires_grad_() for t in (value, loc, w)]
    out = ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2])
    assert out.dtype == torch.bfloat16
    out.backward(g)
    assert ms_deform_attn_bwd_bf16.launches == before
    for name, leaf, ref in zip(("dValue", "dLoc", "dAttw"), leaves, got):
        assert leaf.grad.dtype == ref.dtype and torch.equal(leaf.grad, ref), name


def test_bf16_path_calls_no_f32_function(monkeypatch):
    """The bf16 autograd path reaches the bf16 plain versions only."""
    import multi_modal_tracking_torch.ops.msda as port_msda
    for name in ("ms_deform_attn_ref", "ms_deform_attn_bwd_ref", "ms_deform_attn_fwd",
                 "ms_deform_attn_bwd"):
        monkeypatch.setattr(port_msda, name, lambda *a, _n=name, **k: pytest.fail(f"{_n} called"))
    _, (value, loc, w, g) = _bf16_case(CASES[1], seed=5)
    leaves = [t.requires_grad_() for t in (value, loc, w)]
    port_msda.ms_deform_attn(leaves[0], CASES[1][4], leaves[1], leaves[2]).backward(g)
    assert [t.grad.dtype for t in leaves] == [torch.bfloat16, torch.float32, torch.bfloat16]


def test_bf16_backward_within_rounding_of_f32():
    """Against the f32 backward on the same (bf16-exact) inputs: dValue
    carries the roundings of the tap weights, of their per-pixel sums and
    of the output, within 2^-7 of its scale; dLoc is f32 from the same
    products (1e-5 of its scale); dAttw one rounding (2^-8)."""
    case = CASES[2]
    _, (value, loc, w, g) = _bf16_case(case, seed=7)
    got = ms_deform_attn_bwd_bf16_ref(value, case[4], loc, w, g)
    want = ms_deform_attn_bwd_ref(value.float(), case[4], loc, w.float(), g.float())
    for x, y, rel in zip(got, want, (2.0 ** -7, 1e-5, 2.0 ** -8)):
        assert float((x.float() - y).abs().max()) <= rel * float(y.abs().max())


def test_plan_bf16_plans_the_backward():
    """At bf16 K4-bf16 takes its tap kernel (csrc/msda_bwd.cu) for each level
    of at most 6 blocks of 64 pixels, the blocks whose dV its two
    warpgroups hold in registers, in a fixed shared memory (value rows and
    the tap tile in those blocks, two g tiles and the f32 dWf rows,
    TAP_BWD_SMEM). The recipe's 18x18 levels take it; a level of 500
    pixels (8 blocks) goes direct, as do widths other than 64."""
    shapes = ((18, 18), (18, 18))
    plan = msda_plan(16, 8, 64, shapes, 132, itemsize=2, Lq=648, P=4)
    assert plan.bwd == ("tap", "tap")
    assert plan.bwd_smem == TAP_BWD_SMEM == 2 * 6 * 8192 + 2 * 8192 + 4 * 64 * 392 + 1024 + 1024
    assert TAP_BWD_SMEM <= SMEM_MAX
    big = ((20, 25),)
    assert msda_plan(16, 8, 64, big, 132).bwd == ("direct",)
    assert msda_plan(16, 8, 64, big, 132, itemsize=2, Lq=648, P=4).bwd == ("direct",)
    assert msda_plan(16, 8, 64, ((16, 24),), 132, itemsize=2, Lq=648, P=4).bwd == ("tap",)
    assert msda_plan(16, 8, 16, shapes, 132, itemsize=2, Lq=648, P=4).bwd == ("direct", "direct")


def test_bf16_backward_checks_without_fallback():
    """bf16 tensors that are not on the CPU reach the kernel's checks and
    raise there (meta tensors stand in for a device without the kernel);
    the dtypes are checked."""
    value = torch.empty(1, 16, 2, 8, dtype=torch.bfloat16, device="meta")
    loc = torch.empty(1, 5, 2, 1, 4, 2, device="meta")
    attw = torch.empty(1, 5, 2, 1, 4, dtype=torch.bfloat16, device="meta")
    g = torch.empty(1, 5, 16, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CPU or all CUDA"):
        ms_deform_attn_bwd_bf16(value, ((4, 4),), loc, attw, g)
    with pytest.raises(TypeError, match="grad_out"):
        ms_deform_attn_bwd_bf16(value, ((4, 4),), loc, attw, g.float())
