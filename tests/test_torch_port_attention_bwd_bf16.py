"""Kernel K2-bf16's plain version (`mixed_attention_bwd_bf16_ref`) and the
CPU path of the bf16 `mixed_attention` autograd Function against the JAX
package's Pallas backward kernel at bf16 in interpret mode
(`_mixed_attention_bwd_pallas` with bf16 q, k, v and g), on the same numpy
inputs rounded to bf16, over the shape grid of
tests/test_torch_port_attention_bwd.py (n_mt 0, inside a tile and = Nq;
Nq != Nk; ragged lengths; D 16 and 32).

Tolerance: one bf16 unit of each gradient (rtol 2^-7, the largest spacing
of bf16 values relative to their size), plus half a unit of the largest
gradient of the tensor (atol 2^-9 x max|ref|), with at most 1% of the
values not bit-equal. Both sides round at the same points (f32 P, f32
dP, dS and P rounded to bf16, f32 products, bf16 outputs) and differ in
the order of f32 sums, which can move an intermediate dS or P across a
bf16 rounding boundary: that flip moves every gradient summed over it by
one unit of the flipped term, which, where the sum cancels, exceeds one
unit of the small result. Measured: 8 of 9 cases bit-equal; in the n_mt 0
case 0.13% of dq and 0.07% of dk differ, at most 4.2e-4 x max|ref|, three
of them more than one unit of their own value (6.1e-5 on -2.2e-3). A
wrong mask, rounding point or scale gives errors of order 1e-2 x max.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multi_modal_tracking_tpu.ops.attention as A

from multi_modal_tracking_torch.ops.attention import (mixed_attention, mixed_attention_bf16,
                                                      mixed_attention_bf16_lse_ref,
                                                      mixed_attention_bwd_bf16,
                                                      mixed_attention_bwd_bf16_ref,
                                                      mixed_attention_bwd_ref,
                                                      mixed_attention_lse_ref)

from tests.test_torch_port_attention_bwd import CASES, _inputs
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

RTOL, ATOL_OF_MAX, MAX_DIFFERING = 2.0 ** -7, 2.0 ** -9, 0.01


def _bf16(B, H, Nq, Nk, D, seed=0):
    """numpy f32 q, k, v, g rounded to bf16: (jax bf16 arrays, torch bf16)."""
    jx = tuple(jnp.asarray(x, jnp.bfloat16) for x in _inputs(B, H, Nq, Nk, D, seed))
    tx = tuple(torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16) for x in jx)
    return jx, tx


def _close(got, want, name):
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_OF_MAX * np.abs(want).max(),
                               err_msg=name)
    assert np.mean(got != want) <= MAX_DIFFERING, (name, np.mean(got != want))


@pytest.mark.parametrize("B,H,Nq,Nk,D,n_mt", CASES)
def test_matches_pallas_interpret_bf16(B, H, Nq, Nk, D, n_mt):
    (jq, jk, jv, jg), (q, k, v, g) = _bf16(B, H, Nq, Nk, D)
    scale = D ** -0.5
    want = A._mixed_attention_bwd_pallas(jq, jk, jv, jg, n_mt, scale, interpret=True)
    before = mixed_attention_bwd_bf16.launches
    got = mixed_attention_bwd_bf16_ref(q, k, v, g, n_mt, scale)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, name
        _close(x, w, name)

    # the autograd Function on CPU tensors: the plain bf16 forward and
    # backward, no kernel launch, gradients equal to the plain backward's
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = mixed_attention(*leaves, n_mt, scale)
    assert out.dtype == torch.bfloat16
    out.backward(g)
    assert mixed_attention_bwd_bf16.launches == before
    for name, leaf, ref in zip(("dq", "dk", "dv"), leaves, got):
        assert leaf.grad.dtype == torch.bfloat16 and torch.equal(leaf.grad, ref), name


def test_bf16_path_calls_no_f32_function(monkeypatch):
    """The bf16 autograd path reaches the bf16 plain versions only: the f32
    forward, backward and logsumexp are never called."""
    import multi_modal_tracking_torch.ops.attention as port_attention
    for name in ("mixed_attention_ref", "mixed_attention_bwd_ref", "mixed_attention_lse_ref",
                 "mixed_attention_fwd", "mixed_attention_bwd"):
        monkeypatch.setattr(port_attention, name,
                            lambda *a, _n=name, **k: pytest.fail(f"{_n} called"))
    _, (q, k, v, g) = _bf16(1, 2, 24, 40, 16, seed=3)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    port_attention.mixed_attention(*leaves, 8, 0.25).backward(g)
    assert all(t.grad.dtype == torch.bfloat16 for t in leaves)


def test_bf16_lse_is_the_f32_logsumexp():
    """`mixed_attention_bf16(..., return_lse=True)` returns the bf16 output
    unchanged and the f32 row logsumexp of the f32 scores, which equals the
    f32 logsumexp of the same (bf16-exact) inputs."""
    _, (q, k, v, _) = _bf16(2, 2, 37, 53, 32, seed=4)
    out, lse = mixed_attention_bf16(q, k, v, 8, 32 ** -0.5, return_lse=True)
    assert torch.equal(out, mixed_attention_bf16(q, k, v, 8, 32 ** -0.5))
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    assert torch.equal(lse, mixed_attention_bf16_lse_ref(q, k, 8, 32 ** -0.5))
    want = mixed_attention_lse_ref(q.float(), k.float(), 8, 32 ** -0.5)
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-5)


def test_bf16_backward_within_rounding_of_f32():
    """Against the f32 backward on the same (bf16-exact) inputs: dS and P
    carry one bf16 rounding each and the outputs one more, so every
    gradient is within 2^-6 of its own scale."""
    _, (q, k, v, g) = _bf16(2, 3, 40, 64, 16, seed=2)
    got = mixed_attention_bwd_bf16_ref(q, k, v, g, 16, 0.25)
    want = mixed_attention_bwd_ref(*(t.float() for t in (q, k, v, g)), 16, 0.25)
    for x, w in zip(got, want):
        assert float((x.float() - w).abs().max()) <= 2.0 ** -6 * float(w.abs().max())


def test_bf16_backward_non_cpu_tensors_raise_without_fallback():
    """bf16 tensors that are not on the CPU reach the kernel's checks and
    raise there (meta tensors stand in for a device without the kernel);
    mixed dtypes raise."""
    q = torch.empty(1, 2, 8, 16, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CPU or all CUDA"):
        mixed_attention_bwd_bf16(q, q, q, q, 0, 0.25)
    with pytest.raises(TypeError, match="bfloat16"):
        mixed_attention_bwd_bf16(q, q, q, q.float(), 0, 0.25)
