"""Kernel K1's plain version (multi_modal_tracking_torch.ops.attention on CPU
tensors) against the JAX package's Pallas kernel in interpret mode and its
two-call XLA reference, on the same numpy inputs.

Tolerance 1e-5 abs / 1e-5 rel, as tests/test_pallas_attention.py holds the
Pallas kernel to the XLA reference: f32 softmax attention over <= 100 keys
of unit-normal data, summed in other orders on the two sides.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import multi_modal_tracking_tpu.ops.attention as A

from multi_modal_tracking_torch.ops import _build
from multi_modal_tracking_torch.ops.attention import mixed_attention
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

# (B, H, Nq, Nk, D, n_mt): the cases of tests/test_pallas_attention.py
# (N 40, D 16, n_mt 8/16/32, Nk = Nq + 24), plus D 32, n_mt 0 and Nq.
CASES = [
    (2, 3, 40, 40, 16, 8), (2, 3, 40, 40, 16, 16), (2, 3, 40, 40, 16, 32),
    (2, 3, 40, 64, 16, 16), (2, 3, 40, 64, 16, 0), (2, 3, 40, 64, 16, 40),
    (2, 2, 37, 53, 32, 8), (1, 2, 24, 24, 32, 24), (1, 2, 30, 70, 32, 0),
]


def _qkv(B, H, Nq, Nk, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Nq, D)).astype(np.float32),
            rng.standard_normal((B, H, Nk, D)).astype(np.float32),
            rng.standard_normal((B, H, Nk, D)).astype(np.float32))


@pytest.mark.parametrize("B,H,Nq,Nk,D,n_mt", CASES)
def test_matches_pallas_interpret_and_xla(B, H, Nq, Nk, D, n_mt):
    q, k, v = _qkv(B, H, Nq, Nk, D)
    scale = D ** -0.5
    before = mixed_attention.launches
    got = mixed_attention(*(torch.from_numpy(x) for x in (q, k, v)), n_mt, scale).numpy()
    assert mixed_attention.launches == before          # CPU: plain version, no launch
    pallas = A.mixed_attention_fused(*(jnp.asarray(x) for x in (q, k, v)), n_mt, scale, True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-5, rtol=1e-5)
    xla = A.mixed_attention_xla(*(jnp.asarray(x) for x in (q, k, v)), n_mt, scale)
    np.testing.assert_allclose(got, np.asarray(xla), atol=1e-5, rtol=1e-5)


def test_template_rows_ignore_search_keys():
    """Template outputs are invariant to the search keys and values (the
    property that makes the template k/v cache exact)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 3, 40, 40, 16, seed=1))
    n_mt = 16
    out1 = mixed_attention(q, k, v, n_mt, 0.25)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, n_mt:] = torch.flip(k[:, :, n_mt:], dims=[2]) + 3.0
    v2[:, :, n_mt:] = 0.0
    out2 = mixed_attention(q, k2, v2, n_mt, 0.25)
    torch.testing.assert_close(out1[:, :, :n_mt], out2[:, :, :n_mt], atol=1e-6, rtol=0)
    assert not torch.allclose(out1[:, :, n_mt:], out2[:, :, n_mt:])


def test_non_cpu_non_cuda_tensors_raise():
    """Only CPU tensors take the plain version; anything else must reach the
    kernel checks and raise, never fall back."""
    q = torch.empty(1, 2, 8, 16, device="meta")
    before = mixed_attention.launches
    with pytest.raises(ValueError, match="on meta"):
        mixed_attention(q, q, q, 0, 0.25)
    with pytest.raises(ValueError):
        mixed_attention(torch.zeros(1, 2, 8, 16), q, q, 0, 0.25)
    assert mixed_attention.launches == before


def test_build_needs_nvcc(monkeypatch):
    """Building happens only on first kernel use and needs nvcc; without it
    the build raises instead of falling back."""
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
