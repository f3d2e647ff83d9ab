"""The row logsumexp that kernel K1 saves for K2, and the numerics of both.

* `mixed_attention_lse_ref` (what K1's lse output is held to on the card)
  against the logsumexp of the JAX package's masked scores
  (`multi_modal_tracking_tpu.ops.attention._mask`), on the same numpy
  inputs; tolerance 1e-5 abs / 1e-5 rel as in test_torch_port_attention.py.
* The CPU path of the `mixed_attention` autograd Function, which saves the
  lse only on CUDA tensors (for K2), against `jax.vjp` of
  `mixed_attention_xla`.
* On non-CPU tensors, `mixed_attention_bwd` needs the lse and raises
  without it (fake CUDA tensors: no card, no launch).
* Why K1 and K2 issue three TF32 MMAs per product: an emulation of TF32
  rounding (cvt.rna: round to nearest, ties away, 10 mantissa bits) at K2's
  largest per-head shape (Nq 452, Nk 580, D 64, n_mt 128) shows that one
  TF32 pass misses chip_smoke.py's KERNEL_TOL (2e-5 abs + 1e-4 rel) and
  three passes (big*big + big*small + small*big) meet it. Products of the
  rounded operands are summed in float64 here, so the test isolates what
  the rounding of the operands costs.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import multi_modal_tracking_tpu.ops.attention as A

from multi_modal_tracking_torch.ops.attention import (NEG_INF, mixed_attention,
                                                      mixed_attention_bwd, mixed_attention_fwd,
                                                      mixed_attention_lse_ref, mixed_attention_ref,
                                                      query_warps)

# the cases of tests/test_torch_port_attention.py
CASES = [
    (2, 3, 40, 40, 16, 8), (2, 3, 40, 40, 16, 16), (2, 3, 40, 40, 16, 32),
    (2, 3, 40, 64, 16, 16), (2, 3, 40, 64, 16, 0), (2, 3, 40, 64, 16, 40),
    (2, 2, 37, 53, 32, 8), (1, 2, 24, 24, 32, 24), (1, 2, 30, 70, 32, 0),
]
TOL = dict(atol=1e-5, rtol=1e-5)
KERNEL_TOL = dict(atol=2e-5, rtol=1e-4)       # chip_smoke.py's


def _inputs(B, H, Nq, Nk, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Nq, D)).astype(np.float32),
            rng.standard_normal((B, H, Nk, D)).astype(np.float32),
            rng.standard_normal((B, H, Nk, D)).astype(np.float32),
            rng.standard_normal((B, H, Nq, D)).astype(np.float32))


def _jax_lse(q, k, n_mt, scale):
    s = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), jnp.asarray(k),
                   precision=jax.lax.Precision.HIGHEST) * scale
    s = jnp.where(A._mask(n_mt, q.shape[2], k.shape[2]), s, A.NEG_INF)
    return np.asarray(jax.nn.logsumexp(s, axis=-1))


@pytest.mark.parametrize("B,H,Nq,Nk,D,n_mt", CASES)
def test_lse_ref_matches_jax_masked_logsumexp(B, H, Nq, Nk, D, n_mt):
    q, k, v, _ = _inputs(B, H, Nq, Nk, D)
    scale = D ** -0.5
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    lse = mixed_attention_lse_ref(tq, tk, n_mt, scale)
    assert lse.shape == (B, H, Nq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, n_mt, scale), **TOL)
    # the wrapper's CPU path returns the same lse beside the plain output
    out, lse2 = mixed_attention_fwd(tq, tk, tv, n_mt, scale, return_lse=True)
    torch.testing.assert_close(lse2, lse, atol=0, rtol=0)
    torch.testing.assert_close(out, mixed_attention_ref(tq, tk, tv, n_mt, scale),
                               atol=0, rtol=0)


@pytest.mark.parametrize("B,H,Nq,Nk,D,n_mt", CASES)
def test_function_matches_vjp(B, H, Nq, Nk, D, n_mt):
    """The autograd Function saves (q, k, v, out, lse), lse only for K2: on
    CPU tensors it is None, since the plain backward recomputes P. Its CPU
    gradients still equal jax.vjp of the two-call XLA reference."""
    q, k, v, g = _inputs(B, H, Nq, Nk, D, seed=1)
    scale = D ** -0.5
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = mixed_attention(*ts, n_mt, scale)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5 and saved[4] is None
    torch.testing.assert_close(saved[3], out, atol=0, rtol=0)
    out.backward(torch.from_numpy(g))
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    _, vjp = jax.vjp(lambda a, b, c: A.mixed_attention_xla(a, b, c, n_mt, scale), jq, jk, jv)
    for got, want in zip((t.grad.numpy() for t in ts), vjp(jg)):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_inference_path_saves_nothing():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 2, 24, 40, 16))
    out = mixed_attention(q, k, v, 8, 0.25)
    assert out.grad_fn is None


@pytest.mark.parametrize("lse_shape", [None, (1, 2, 7), (2, 8)])
def test_bwd_on_cuda_tensors_needs_lse(lse_shape):
    """CUDA tensors (faked: no card here) reach K2's checks; without a
    (B, H, Nq) lse the wrapper raises before any build or launch."""
    before = mixed_attention_bwd.launches
    with FakeTensorMode():
        q = torch.empty(1, 2, 8, 16, device="cuda")
        lse = None if lse_shape is None else torch.empty(*lse_shape, device="cuda")
        with warnings.catch_warnings(), pytest.raises(ValueError, match="lse"):
            warnings.simplefilter("ignore")      # FakeTensor.data_ptr() is deprecated
            mixed_attention_bwd(q, q, q, q, q, 0, 0.25, lse)
    assert mixed_attention_bwd.launches == before


@pytest.mark.parametrize("BH,Nq,rows", [(384, 452, 64), (384, 260, 64), (24, 324, 32),
                                        (24, 227, 16), (24, 112, 16), (24, 128, 16)])
def test_query_tile_fills_the_card(BH, Nq, rows):
    """K1's query rows per block on a 132-SM H100: 64 at the training
    shapes (B*H 384), 16 or 32 at the tracking shapes (B*H 24)."""
    assert 16 * query_warps(BH, Nq, 132) == rows


# ----------------------------------------------------------- TF32 emulation
def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to nearest, ties away from zero, keeping 10
    of f32's 23 mantissa bits (the low 13 bits cleared); the integer form
    that csrc/tf32_mma.cuh's to_tf32 uses."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b of f32 operands as the tensor cores form it: one TF32 pass, or
    three (the small*small term dropped); float64 sums."""
    ab, bb = _tf32(a), _tf32(b)
    if passes == 1:
        return ab.double() @ bb.double()
    a_s, b_s = _tf32(a - ab), _tf32(b - bb)
    return a_s.double() @ bb.double() + ab.double() @ b_s.double() + ab.double() @ bb.double()


def _attention_fwd_bwd(q, k, v, g, n_mt, scale, prod):
    """O, dQ, dK, dV of one head with every matrix product through prod;
    elementwise work in float64 on f32-rounded operands, as in K1/K2."""
    allowed = (torch.arange(q.shape[0])[:, None] >= n_mt) | (torch.arange(k.shape[0])[None] < n_mt)
    s = prod(q, k.T) * scale
    p = torch.softmax(s.masked_fill(~allowed, NEG_INF), dim=-1).float()
    out = prod(p, v).float()
    delta = (g.double() * out.double()).sum(-1, keepdim=True)
    ds = (p.double() * (prod(g, v.T) - delta)).masked_fill(~allowed, 0.0) * scale
    ds = ds.float()
    return out, prod(ds, k).float(), prod(ds.T, q).float(), prod(p.T, g).float()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("passes", [1, 3])
def test_three_tf32_passes_meet_kernel_tol(passes, seed):
    Nq, Nk, D, n_mt = 452, 580, 64, 128
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32))
                  for n in (Nq, Nk, Nk, Nq))
    scale = D ** -0.5
    exact = _attention_fwd_bwd(q, k, v, g, n_mt, scale, lambda a, b: a.double() @ b.double())
    emul = _attention_fwd_bwd(q, k, v, g, n_mt, scale, lambda a, b: _product(a, b, passes))
    within = [bool(((e - w).abs() <= KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * w.abs()).all())
              for e, w in zip(emul, exact)]
    worst = max(float((e - w).abs().max()) for e, w in zip(emul, exact))
    if passes == 3:
        assert all(within) and worst < 1e-6, worst
    else:
        assert not all(within) and worst > 1e-4, worst
