"""The Hopper design of the bf16 attention kernels, checked on the CPU (the
kernels themselves run only on the card, in chip_smoke.py):

* K1-bf16's arithmetic modelled in plain PyTorch: 64-row tiles, the key
  tiles cut into contiguous shares, an online softmax per share that
  rounds exp(s - running max) to bf16 for P V, and the merge of the
  shares' (m, l, O) rescaled in f32 to the common max before the one
  rounding of the output. Held against the JAX package's Pallas kernel at
  bf16 in interpret mode over tests/test_torch_port_attention_bwd.py's
  CASES, for 1 to 4 shares at the kernel's 64-key tiles and at 16-key
  tiles (so the small cases get ragged shares with n_mt inside one), at
  the tolerance chip_smoke.py holds K1-bf16 to (`bf16_tol`: 2^-8 of
  max|V| plus 2^-7 of the output), and against the f32 answer: at most
  1.25x the error of the plain version, which rounds as the Pallas kernel
  does. The plain version's own tolerance against the Pallas kernel
  (tests/test_torch_port_attention_bf16.py: 2^-7 rel, 1e-5 abs, at most
  1% of outputs not bit-equal) does not hold for any flash-order kernel:
  rounding exp(s - m) before the division by the row sum moves 14% of the
  outputs of the first case by up to 5.9e-3 already with one share.
* `attention_bf16_plan`: the key shares it gives at the tracking, lockstep
  and training shapes, never more than the key tiles.
* The ctypes bindings: every `SIGNATURES` entry of ops/_build.py has as
  many argtypes as its `extern "C"` function in csrc/ has parameters
  (ctypes passes a short list without complaint), and both bf16 attention
  sources include the shared Hopper header, which the build hashes.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multi_modal_tracking_tpu.ops.attention as A

from multi_modal_tracking_torch.ops import _build
from multi_modal_tracking_torch.ops.attention import (BF16_MAX_SPLITS, BF16_TILE, NEG_INF,
                                                      attention_bf16_plan,
                                                      mixed_attention_bf16_lse_ref,
                                                      mixed_attention_bf16_ref,
                                                      mixed_attention_ref)

from tests.test_torch_port_attention_bwd import CASES, _inputs
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _shares(n_tiles: int, splits: int):
    """Key tiles [t0, t1) of each share, as the kernel cuts them."""
    return [(n_tiles * s // splits, n_tiles * (s + 1) // splits) for s in range(splits)]


def _split_model(q, k, v, n_mt, scale, splits, tile=BF16_TILE):
    """K1-bf16's arithmetic on bf16 (B, H, Nq, D) q and (B, H, Nk, D) k, v:
    returns the bf16 output and the f32 row logsumexp."""
    q, k, v = q.float(), k.float(), v.float()
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    out = torch.empty(B, H, Nq, D)
    lse = torch.empty(B, H, Nq)
    kend_t = min(n_mt, Nk)
    for q0 in range(0, Nq, tile):
        rows = torch.arange(q0, min(q0 + tile, Nq))
        kend = kend_t if rows[-1] < n_mt else Nk            # template-only row tile
        kend_row = torch.where(rows < n_mt, kend_t, Nk)[:, None]
        parts = []
        for t0, t1 in _shares(-(-kend // tile), splits):
            m = torch.full((B, H, len(rows), 1), NEG_INF)
            l = torch.zeros(B, H, len(rows), 1)
            acc = torch.zeros(B, H, len(rows), D)
            for t in range(t0, t1):
                cols = torch.arange(t * tile, min((t + 1) * tile, Nk))
                x = q[:, :, rows] @ k[:, :, cols].transpose(-1, -2) * scale
                x = x.masked_fill(cols[None, :] >= kend_row, NEG_INF)
                m_new = torch.maximum(m, x.amax(-1, keepdim=True))
                c = torch.exp(m - m_new)
                m = m_new
                p = torch.exp(x - torch.where(m == NEG_INF, 0.0, m))
                l = l * c + p.sum(-1, keepdim=True)
                acc = acc * c + p.to(torch.bfloat16).float() @ v[:, :, cols]
            parts.append((m, l, acc))
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        L = sum(l * torch.exp(m - M) for m, l, _ in parts)
        O = sum(a * torch.exp(m - M) for m, _, a in parts)
        out[:, :, rows] = O * (1.0 / L)
        lse[:, :, rows] = (M + torch.log(L))[..., 0]
    return out.to(torch.bfloat16), lse


def _bf16_inputs(B, H, Nq, Nk, D):
    q, k, v, _ = _inputs(B, H, Nq, Nk, D)
    jx = tuple(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    tx = tuple(torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16) for x in jx)
    return jx, tx


@pytest.mark.parametrize("tile", [BF16_TILE, 16])
@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("B,H,Nq,Nk,D,n_mt", CASES)
def test_split_softmax_model_matches_pallas_interpret(B, H, Nq, Nk, D, n_mt, splits, tile):
    (jq, jk, jv), (q, k, v) = _bf16_inputs(B, H, Nq, Nk, D)
    scale = D ** -0.5
    got, lse = _split_model(q, k, v, n_mt, scale, splits, tile)
    want = np.asarray(A._mixed_attention_fwd_pallas(jq, jk, jv, n_mt, scale, interpret=True)
                      .astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                               atol=2.0 ** -8 * float(v.float().abs().max()))
    f32 = mixed_attention_ref(q.float(), k.float(), v.float(), n_mt, scale)
    plain = mixed_attention_bf16_ref(q, k, v, n_mt, scale)
    assert (float((got.float() - f32).abs().max())
            <= 1.25 * float((plain.float() - f32).abs().max()))
    # the lse K2-bf16 reads: the merged (m, l) give the row logsumexp
    torch.testing.assert_close(lse, mixed_attention_bf16_lse_ref(q, k, n_mt, scale),
                               atol=2e-5, rtol=1e-4)


def test_split_model_shares_are_ragged_around_n_mt():
    """The 16-key tiles give the model's cases what the kernel meets at the
    main path's scale: several shares of unequal length, n_mt inside one."""
    B, H, Nq, Nk, D, n_mt = 2, 2, 37, 53, 32, 8
    tiles = -(-Nk // 16)
    shares = _shares(tiles, 3)
    assert [t1 - t0 for t0, t1 in shares] == [1, 1, 2]
    inside = [(t0 * 16 < n_mt < t1 * 16) for t0, t1 in shares]
    assert inside == [True, False, False]
    assert (B, H, Nq, Nk, D, n_mt) in CASES


@pytest.mark.parametrize("n_tiles", range(1, 12))
@pytest.mark.parametrize("splits", range(1, BF16_MAX_SPLITS + 2))
def test_shares_cover_the_key_tiles_once(n_tiles, splits):
    shares = _shares(n_tiles, splits)
    assert [t for t0, t1 in shares for t in range(t0, t1)] == list(range(n_tiles))
    if splits <= n_tiles:
        assert all(t1 > t0 for t0, t1 in shares)


@pytest.mark.parametrize("L,splits", [(112, 3), (159, 3), (227, 3), (324, 2)])
def test_plan_splits_the_keys_at_the_tracking_shapes(L, splits):
    """B*H 24 (two modalities x 12 heads), Nq the CE lengths, Nk = Nq + 256
    (the other modality's templates): 48 to 144 blocks of 64 rows on a
    132-SM H100, so 2 or 3 key shares per block."""
    assert attention_bf16_plan(24, L, L + 256, 132) == splits


@pytest.mark.parametrize("BH,Nq", [(288, 112), (288, 159), (288, 227), (288, 324),
                                   (384, 260), (384, 306), (384, 368), (384, 452)])
def test_plan_keeps_one_share_where_blocks_fill_the_card(BH, Nq):
    """Lockstep N = 12 (B*H 288) and training (B*H 384): enough blocks."""
    Nk = Nq + (256 if BH == 288 else 128)
    assert attention_bf16_plan(BH, Nq, Nk, 132) == 1


@pytest.mark.parametrize("BH", [1, 2, 6, 24, 96, 288, 384])
@pytest.mark.parametrize("Nq,Nk", [(1, 9), (5, 7), (40, 64), (128, 128), (131, 197),
                                   (17, 200), (452, 580)])
def test_plan_never_exceeds_the_key_tiles(BH, Nq, Nk):
    splits = attention_bf16_plan(BH, Nq, Nk, 132)
    assert 1 <= splits <= min(BF16_MAX_SPLITS, -(-Nk // BF16_TILE))
    # fewer blocks never get fewer shares
    assert attention_bf16_plan(BH, Nq, Nk, 2 * 132) >= splits


def _c_params(name: str) -> int:
    """Parameter count of `extern "C" int name(...)` in csrc/."""
    for fname in sorted(os.listdir(_build.CSRC_DIR)):
        if not fname.endswith(".cu"):
            continue
        with open(os.path.join(_build.CSRC_DIR, fname)) as f:
            m = re.search(r'extern "C" int ' + name + r"\s*\(([^)]*)\)", f.read())
        if m:
            return len([p for p in m.group(1).split(",") if p.strip()])
    raise AssertionError(f"no extern \"C\" {name} in csrc/")


@pytest.mark.parametrize("lib,fn", [(lib, fn) for lib, fns in _build.SIGNATURES.items()
                                    for fn in fns])
def test_signatures_match_the_c_entry_points(lib, fn):
    argtypes, _ = _build.SIGNATURES[lib][fn]
    assert len(argtypes) == _c_params(fn)


def test_bf16_attention_sources_share_the_hopper_header():
    """Both bf16 attention sources take their products and loads from the
    hashed Hopper header (wgmma, TMA) and issue no mma.sync of their own."""
    assert "wgmma_bf16.cuh" in _build._headers()
    for name in ("mixed_attention_bf16", "mixed_attention_bwd_bf16"):
        with open(os.path.join(_build.CSRC_DIR, f"{name}.cu")) as f:
            src = f.read()
        assert '#include "wgmma_bf16.cuh"' in src
        assert "hopper::wgmma_" in src and "hopper::tma_load_" in src
        assert "mma.sync.aligned" not in src
