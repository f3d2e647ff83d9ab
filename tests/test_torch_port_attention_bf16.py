"""Kernel K1-bf16's plain version (multi_modal_tracking_torch.ops.attention
on bf16 CPU tensors) against the JAX package's Pallas kernel at bf16 in
interpret mode, on the same numpy inputs rounded to bf16, over the shape
grid of tests/test_torch_port_attention.py (n_mt 0 and Nq != Nk included).

Tolerance: one bf16 unit of the output (rtol 2^-7, the largest spacing of
bf16 values relative to their size; atol 1e-5 for outputs at 0), with at
most 1% of the outputs not bit-equal. Both sides round at the same points
(f32 scores, f32 softmax, P rounded to bf16, f32 P V, bf16 output) and
differ only in the order of f32 sums, which can move an output across a
bf16 rounding boundary: measured, 2 of 3,840 outputs of one case differ,
by one unit.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import multi_modal_tracking_tpu.ops.attention as A

from multi_modal_tracking_torch.ops.attention import (mixed_attention, mixed_attention_bf16,
                                                      mixed_attention_ref)

from tests.test_torch_port_attention import CASES, _qkv
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

RTOL, ATOL, MAX_DIFFERING = 2.0 ** -7, 1e-5, 0.01


def _bf16_inputs(B, H, Nq, Nk, D, seed=0):
    """numpy f32 inputs rounded to bf16: (jax bf16 arrays, torch bf16 tensors)."""
    jx = tuple(jnp.asarray(x, jnp.bfloat16) for x in _qkv(B, H, Nq, Nk, D, seed))
    tx = tuple(torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16) for x in jx)
    return jx, tx


@pytest.mark.parametrize("B,H,Nq,Nk,D,n_mt", CASES)
def test_matches_pallas_interpret_bf16(B, H, Nq, Nk, D, n_mt):
    (jq, jk, jv), (q, k, v) = _bf16_inputs(B, H, Nq, Nk, D)
    scale = D ** -0.5
    before = mixed_attention_bf16.launches
    got = mixed_attention(q, k, v, n_mt, scale)
    assert mixed_attention_bf16.launches == before        # CPU: plain version, no launch
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = np.asarray(A._mixed_attention_fwd_pallas(jq, jk, jv, n_mt, scale, interpret=True)
                      .astype(jnp.float32))
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.mean(got != want) <= MAX_DIFFERING, np.mean(got != want)


def test_bf16_within_rounding_of_f32():
    """The bf16 output against the f32 answer on the same (bf16-exact)
    inputs: within the bf16 roundings of P and of the output, 2^-7 of the
    output's scale."""
    _, (q, k, v) = _bf16_inputs(2, 3, 40, 64, 16, seed=2)
    got = mixed_attention(q, k, v, 16, 0.25).float()
    want = mixed_attention_ref(q.float(), k.float(), v.float(), 16, 0.25)
    assert float((got - want).abs().max()) <= 2.0 ** -7 * float(want.abs().max())


def test_bf16_template_rows_ignore_search_keys():
    """The asymmetric mask at bf16: template outputs do not depend on the
    search keys and values, bit for bit."""
    _, (q, k, v) = _bf16_inputs(2, 3, 40, 40, 16, seed=1)
    n_mt = 16
    out1 = mixed_attention(q, k, v, n_mt, 0.25)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, n_mt:] = torch.flip(k[:, :, n_mt:], dims=[2]) + 3.0
    v2[:, :, n_mt:] = 0.0
    out2 = mixed_attention(q, k2, v2, n_mt, 0.25)
    assert torch.equal(out1[:, :, :n_mt], out2[:, :, :n_mt])


def test_bf16_with_gradient_raises():
    """bf16 under autograd: CPU tensors take the bf16 autograd Function
    (the plain bf16 forward and backward, bf16 gradients; nothing goes to
    the f32 versions); tensors elsewhere reach the kernels' checks and
    raise there (meta tensors stand in for a device without the kernels),
    with no fallback to a plain version."""
    _, (q, k, v) = _bf16_inputs(1, 2, 8, 8, 16)
    out = mixed_attention(q.requires_grad_(), k, v, 0, 0.25)
    out.float().sum().backward()
    assert out.dtype == torch.bfloat16 and q.grad.dtype == torch.bfloat16
    with torch.no_grad():
        assert mixed_attention(q, k, v, 0, 0.25).dtype == torch.bfloat16
    m = torch.empty(1, 2, 8, 16, dtype=torch.bfloat16, device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="CPU or all CUDA"):
        mixed_attention(m, m, m, 0, 0.25)


def test_mixed_dtypes_raise():
    _, (q, k, v) = _bf16_inputs(1, 2, 8, 8, 16)
    with pytest.raises(TypeError, match="bfloat16"):
        mixed_attention(q, k.float(), v, 0, 0.25)


def test_bf16_non_cpu_tensors_raise_without_fallback():
    """bf16 tensors that are not on the CPU reach the kernel's checks and
    raise there (meta tensors stand in for a device without the kernel);
    nothing falls back to the plain version."""
    q = torch.empty(1, 2, 8, 16, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CPU or all CUDA"):
        mixed_attention(q, q, q, 0, 0.25)
