"""Kernel K2's plain version (`mixed_attention_bwd_ref`) and the CPU path of
the `mixed_attention` autograd Function against the JAX package's Pallas
backward kernel in interpret mode (`_mixed_attention_bwd_pallas`) and
against `jax.vjp` of its two-call XLA reference, on the same numpy inputs.

Tolerance 1e-5 abs / 1e-5 rel, that of tests/test_torch_port_attention.py:
f32 gradients of softmax attention over <= 70 keys of unit-normal data
(magnitudes up to ~5), summed in other orders on the two sides; measured
differences are ~1e-6. A wrong mask, a missing softmax term or an
unscaled dS gives errors of order 1e-1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multi_modal_tracking_tpu.ops.attention as A

from multi_modal_tracking_torch.ops.attention import (mixed_attention, mixed_attention_bwd,
                                                      mixed_attention_bwd_ref,
                                                      mixed_attention_ref)
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

# (B, H, Nq, Nk, D, n_mt): the cases of tests/test_torch_port_attention.py:
# n_mt 0, inside a tile, = Nq; Nq != Nk; D 16 and 32
CASES = [
    (2, 3, 40, 40, 16, 8), (2, 3, 40, 40, 16, 16), (2, 3, 40, 40, 16, 32),
    (2, 3, 40, 64, 16, 16), (2, 3, 40, 64, 16, 0), (2, 3, 40, 64, 16, 40),
    (2, 2, 37, 53, 32, 8), (1, 2, 24, 24, 32, 24), (1, 2, 30, 70, 32, 0),
]
TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(B, H, Nq, Nk, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Nq, D)).astype(np.float32),
            rng.standard_normal((B, H, Nk, D)).astype(np.float32),
            rng.standard_normal((B, H, Nk, D)).astype(np.float32),
            rng.standard_normal((B, H, Nq, D)).astype(np.float32))


def _close(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


@pytest.mark.parametrize("B,H,Nq,Nk,D,n_mt", CASES)
def test_bwd_ref_matches_pallas_interpret_and_vjp(B, H, Nq, Nk, D, n_mt):
    q, k, v, g = _inputs(B, H, Nq, Nk, D)
    scale = D ** -0.5
    before = mixed_attention_bwd.launches
    got = [t.numpy() for t in mixed_attention_bwd_ref(
        *(torch.from_numpy(x) for x in (q, k, v, g)), n_mt, scale)]
    assert mixed_attention_bwd.launches == before
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    _close(got, A._mixed_attention_bwd_pallas(jq, jk, jv, jg, n_mt, scale, interpret=True))
    _, vjp = jax.vjp(lambda a, b, c: A.mixed_attention_xla(a, b, c, n_mt, scale), jq, jk, jv)
    _close(got, vjp(jg))


@pytest.mark.parametrize("B,H,Nq,Nk,D,n_mt", CASES)
def test_function_cpu_grads_match_autograd_of_plain_forward(B, H, Nq, Nk, D, n_mt):
    """The CPU path of the autograd Function (plain backward, wired through
    backward()) gives the gradients autograd takes through the plain
    forward, including for a non-contiguous incoming gradient."""
    q, k, v, g = _inputs(B, H, Nq, Nk, D, seed=1)
    scale = D ** -0.5
    grads = []
    for fn in (mixed_attention, mixed_attention_ref):
        ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = fn(*ts, n_mt, scale)
        # a transposed view of g: the head merge hands over such strides
        gt = torch.from_numpy(np.ascontiguousarray(g.transpose(0, 2, 1, 3))).transpose(1, 2)
        assert not gt.is_contiguous()
        out.backward(gt)
        grads.append([t.grad.numpy() for t in ts])
    _close(*grads)
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    _, vjp = jax.vjp(lambda a, b, c: A.mixed_attention_xla(a, b, c, n_mt, scale), jq, jk, jv)
    _close(grads[0], vjp(jg))


def test_masked_template_rows_get_no_search_gradient():
    """Template queries never see search keys: dK and dV of the search keys
    come from search queries only, exactly."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 2, 40, 40, 16, seed=2))
    n_mt = 16
    g_t = g.clone()
    g_t[:, :, n_mt:] = 0.0                       # only template rows carry gradient
    dq, dk, dv = mixed_attention_bwd_ref(q, k, v, g_t, n_mt, 0.25)
    assert torch.count_nonzero(dk[:, :, n_mt:]) == 0
    assert torch.count_nonzero(dv[:, :, n_mt:]) == 0
    assert torch.count_nonzero(dq[:, :, n_mt:]) == 0


def test_bwd_wrapper_rejects_non_cpu_non_cuda():
    q = torch.empty(1, 2, 8, 16, device="meta")
    before = mixed_attention_bwd.launches
    with pytest.raises(ValueError, match="on meta"):
        mixed_attention_bwd(q, q, q, q, q, 0, 0.25)
    assert mixed_attention_bwd.launches == before
