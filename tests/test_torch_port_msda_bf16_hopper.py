"""The Hopper design of the bf16 MSDA kernels K3-bf16 and K4-bf16, checked on
the CPU (the kernels themselves run only on the card, in chip_smoke.py):

* Their tiled schedule modelled in plain PyTorch: query tiles of 64 rows;
  per query row and level its 4P taps in tap order, the first live tap on
  a pixel summing the rounded tap weights of the taps on that pixel in tap
  order and rounding the sum to bf16 (the register merge of
  csrc/msda_tap.cuh `merge_taps`); the forward's levels
  each in f32, summed in level order and rounded once; the backward's dV summed
  over the query tiles in f32 and rounded once, dw picked from the tile's
  f32 g V^T, and dAttw and dLoc summed over a point's four corners in
  corner order. Held against the JAX package's Pallas kernels at bf16 in
  interpret mode (`_msda_pallas_fwd`, `_msda_pallas_bwd`) on
  tests/test_torch_port_msda_bf16.py's CASES (the recipe's maps and heads
  at 40 queries, equal and mixed levels, locations outside the maps, one
  level): bit-equal, or at most 1% of the bf16 outputs one bf16 unit off
  (both sides round at the same points; only the order of f32 sums
  differs). dLoc (f32) within the f32 tolerance of
  tests/test_torch_port_msda_bwd_bf16.py.
* Taps of one query that share a pixel: the merged rounding equals the
  Pallas kernel bit for bit, where rounding each tap weight on its own
  does not.
* `msda_plan` at bf16: the tap kernels at the recipe's B 1/4/12/16 with the
  forward's query split, and the fit limits of both tap kernels.
* The CUDA side: the constants the plan mirrors, the C entry points'
  parameters against ops/_build.py's signatures, the shared headers.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_tracking_tpu.ops import msda as jax_msda

from multi_modal_tracking_torch.ops import _build
from multi_modal_tracking_torch.ops.msda import (SMEM_MAX, TAP_BWD_MAX_BLOCKS, TAP_BWD_SMEM,
                                                 TAP_FWD_MAX_LEVELS, TAP_POINTS, TAP_ROWS,
                                                 _corners, ms_deform_attn_bf16_ref, msda_plan,
                                                 tap_fwd_smem)

from tests.test_torch_port_msda_bf16 import CASES, _bf16_case
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

MAX_DIFFERING = 0.01
IDS = ["recipe", "equal", "mixed", "mixed_oob", "one_level"]
H100_SMS = 132
RECIPE = ((18, 18), (18, 18))


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _taps(loc_l, aw_l, H, W):
    """Per tap, in tap order (point-major, then corner): pixel (-1 dead),
    rounded weight, and the f32 bilinear weight and (fx, fy) for the chain.
    loc_l (B, Lq, M, P, 2), aw_l (B, Lq, M, P) -> tensors (..., 4P)."""
    fx, fy, corners = _corners(loc_l, H, W)
    pix, w, bw = [], [], []
    for p in range(aw_l.shape[-1]):
        for xi, yi, b in corners:
            xi, yi = xi[..., p], yi[..., p]
            live = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            pix.append(torch.where(live, yi * W + xi, -1))
            w.append(_bf16(b[..., p] * aw_l[..., p]))
            bw.append(b[..., p])
    return torch.stack(pix, -1), torch.stack(w, -1), torch.stack(bw, -1), fx, fy


def _tap_tile(pix, w, S_l):
    """The kernel's tap tile of some query rows: pix, w (rows, 4P). The
    first tap of a row on a pixel sums the weights of the taps on it in tap
    order (adding an exact 0 for the others) and writes the rounded sum;
    (rows, S_l) f32 holding bf16 values."""
    rows, T = pix.shape
    A = torch.zeros(rows, S_l)
    for t in range(T):
        live = pix[:, t] >= 0
        first = live.clone()
        for u in range(t):
            first &= pix[:, u] != pix[:, t]
        s = w[:, t].clone()
        for u in range(t + 1, T):
            s = s + torch.where(pix[:, u] == pix[:, t], w[:, u], torch.zeros(()))
        r = torch.nonzero(first)[:, 0]
        A[r, pix[r, t]] = _bf16(s[r])
    return A


def _levels(shapes):
    start = 0
    for lid, (H, W) in enumerate(shapes):
        yield lid, H, W, start
        start += H * W


def tiled_fwd(value, shapes, loc, attw):
    """K3-bf16's schedule: per (b, m) and query tile, the tap tile of each
    level, its product A_l V_l in f32, the levels' products summed in level
    order (0 + level 0 + level 1) and rounded once."""
    B, S, M, D = value.shape
    Lq = loc.shape[1]
    out = torch.empty(B, Lq, M, D)
    v, aw = value.float(), attw.float()
    for q0 in range(0, Lq, TAP_ROWS):
        q1 = min(q0 + TAP_ROWS, Lq)
        acc = torch.zeros(B, M, q1 - q0, D)
        for lid, H, W, start in _levels(shapes):
            pix, w, _, _, _ = _taps(loc[:, q0:q1, :, lid], aw[:, q0:q1, :, lid], H, W)
            for b in range(B):
                for m in range(M):
                    A = _tap_tile(pix[b, :, m], w[b, :, m], H * W)
                    acc[b, m] += A @ v[b, start:start + H * W, m]
        out[:, q0:q1] = acc.permute(0, 2, 1, 3)
    return out.to(torch.bfloat16).reshape(B, Lq, M * D)


def tiled_bwd(value, shapes, loc, attw, grad):
    """K4-bf16's schedule: per (b, m, level) and query tile, the tap tile,
    dV += A^T g in f32 (rounded once after the last tile), dWf = g V^T in
    f32 picked per tap, the chain summed over corners in corner order."""
    B, S, M, D = value.shape
    Lq, P = loc.shape[1], loc.shape[4]
    v, aw, g = value.float(), attw.float(), grad.float().reshape(B, Lq, M, D)
    dvalue = torch.empty(B, S, M, D)
    dloc = torch.empty_like(loc)
    dattw = torch.empty(attw.shape)
    for lid, H, W, start in _levels(shapes):
        S_l = H * W
        dv = torch.zeros(B, M, S_l, D)
        for q0 in range(0, Lq, TAP_ROWS):
            q1 = min(q0 + TAP_ROWS, Lq)
            pix, w, bw, fx, fy = _taps(loc[:, q0:q1, :, lid], aw[:, q0:q1, :, lid], H, W)
            dw = torch.zeros(pix.shape)
            for b in range(B):
                for m in range(M):
                    A = _tap_tile(pix[b, :, m], w[b, :, m], S_l)
                    gt, vl = g[b, q0:q1, m], v[b, start:start + S_l, m]
                    dv[b, m] += A.t() @ gt
                    dwf = gt @ vl.t()                                    # (rows, S_l)
                    picked = torch.gather(dwf, 1, pix[b, :, m].clamp(min=0))
                    dw[b, :, m] = torch.where(pix[b, :, m] >= 0, picked, torch.zeros(()))
            dw = dw.reshape(*dw.shape[:-1], P, 4)
            bw = bw.reshape(*bw.shape[:-1], P, 4)
            d = aw[:, q0:q1, :, lid, :, None] * dw
            tx = [-(1 - fy) * d[..., 0], (1 - fy) * d[..., 1], -(fy * d[..., 2]), fy * d[..., 3]]
            ty = [-(1 - fx) * d[..., 0], -(fx * d[..., 1]), (1 - fx) * d[..., 2], fx * d[..., 3]]
            ta = [bw[..., c] * dw[..., c] for c in range(4)]
            dattw[:, q0:q1, :, lid] = ((ta[0] + ta[1]) + ta[2]) + ta[3]
            dloc[:, q0:q1, :, lid, :, 0] = (((tx[0] + tx[1]) + tx[2]) + tx[3]) * W
            dloc[:, q0:q1, :, lid, :, 1] = (((ty[0] + ty[1]) + ty[2]) + ty[3]) * H
        dvalue[:, start:start + S_l] = dv.permute(0, 2, 1, 3)
    return dvalue.to(torch.bfloat16), dloc, dattw.to(torch.bfloat16)


def _bit_close(got, want, name):
    """Bit-equal, or at most 1% of the values one bf16 unit (2^-7 rel, and
    2^-9 of the largest |value| where a small result is a cancellation)."""
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=2.0 ** -9 * np.abs(want).max(),
                               err_msg=name)
    assert np.mean(got != want) <= MAX_DIFFERING, (name, np.mean(got != want))


def _grad(case, seed):
    B, M, D, _, _, Lq, _ = case
    g = np.random.default_rng(seed).standard_normal((B, Lq, M * D)).astype(np.float32)
    return jnp.asarray(g, jnp.bfloat16), torch.from_numpy(
        np.array(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tiled_forward_matches_pallas_interpret(case):
    (jv, jl, jw), (value, loc, w), shapes = _bf16_case(case, seed=len(case[4]) + case[5])
    got = tiled_fwd(value, shapes, loc, w)
    want = jax_msda._msda_pallas_fwd(jv, tuple(shapes), jl, jw, interpret=True)
    _bit_close(got, want, "out")
    # the plain version (the card's reference) rounds at the same points
    plain = ms_deform_attn_bf16_ref(value, shapes, loc, w)
    assert float((got != plain).float().mean()) <= MAX_DIFFERING


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tiled_backward_matches_pallas_interpret(case):
    (jv, jl, jw), (value, loc, w), shapes = _bf16_case(case, seed=len(case[4]) + case[5])
    jg, g = _grad(case, seed=case[5])
    got = tiled_bwd(value, shapes, loc, w, g)
    want = jax_msda._msda_pallas_bwd(jv, tuple(shapes), jl, jw, jg, interpret=True)
    _bit_close(got[0], want[0], "dValue")
    _bit_close(got[2], want[2], "dAttw")
    dloc = np.asarray(want[1])
    np.testing.assert_allclose(got[1].numpy(), dloc, atol=1e-5 * max(1.0, np.abs(dloc).max()),
                               rtol=1e-4, err_msg="dLoc")


def _shared_pixel_case():
    """One 6x6 level, P 4: points 0 and 2 at the same location (all four
    corners shared), point 3 a tenth of a pixel from point 1 (its corners
    on point 1's pixels), over 70 queries (two tiles) and 2 heads."""
    rng = np.random.default_rng(11)
    B, Lq, M, D, H, W = 1, 70, 2, 8, 6, 6
    value = rng.standard_normal((B, H * W, M, D)).astype(np.float32)
    loc = rng.uniform(0.1, 0.9, size=(B, Lq, M, 1, 4, 2)).astype(np.float32)
    loc[..., 2, :] = loc[..., 0, :]
    loc[..., 3, :] = loc[..., 1, :] + np.float32(0.1 / W)
    w = rng.uniform(0.05, 0.5, size=(B, Lq, M, 1, 4)).astype(np.float32)
    g = rng.standard_normal((B, Lq, M * D)).astype(np.float32)
    j = [jnp.asarray(x, jnp.bfloat16) for x in (value, w, g)]
    t = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16) for x in j]
    return ((H, W),), (j[0], jnp.asarray(loc), j[1], j[2]), (t[0], torch.from_numpy(loc), t[1],
                                                              t[2])


def test_shared_pixels_merge_as_the_pallas_kernel_rounds():
    shapes, (jv, jl, jw, jg), (value, loc, w, g) = _shared_pixel_case()
    pix, _, _, _, _ = _taps(loc[:, :, :, 0], w.float()[:, :, :, 0], 6, 6)
    shared = (pix[..., :, None] == pix[..., None, :]) & (pix[..., :, None] >= 0)
    assert int(shared.sum()) > 2 * pix.numel()          # many taps share a pixel
    got = tiled_fwd(value, shapes, loc, w)
    want = np.asarray(jax_msda._msda_pallas_fwd(jv, tuple(shapes), jl, jw, interpret=True)
                      .astype(jnp.float32))
    assert np.mean(got.float().numpy() != want) <= MAX_DIFFERING
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7, atol=1e-6)
    # each rounded tap weight applied on its own rounds once fewer: many
    # outputs move
    wr = _taps(loc[:, :, :, 0], w.float()[:, :, :, 0], 6, 6)[1]
    per_tap = torch.zeros_like(got, dtype=torch.float32).reshape(1, 70, 2, 8)
    vf = value.float()
    for t in range(pix.shape[-1]):
        p = pix[..., t]
        rows = vf[0, p.clamp(min=0)[0], torch.arange(2)[None, :]]          # (70, 2, 8)
        per_tap[0] += torch.where(p[0, ..., None] >= 0, wr[0, ..., t, None] * rows,
                                  torch.zeros(()))
    per_tap = per_tap.reshape(1, 70, 16).to(torch.bfloat16).float().numpy()
    assert np.mean(per_tap != want) > 0.05
    dv = tiled_bwd(value, shapes, loc, w, g)
    dwant = jax_msda._msda_pallas_bwd(jv, tuple(shapes), jl, jw, jg, interpret=True)
    _bit_close(dv[0], dwant[0], "dValue")
    _bit_close(dv[2], dwant[2], "dAttw")


@pytest.mark.parametrize("B,tiles", [(1, 1), (4, 3), (12, 11), (16, 11)])
def test_plan_takes_the_tap_kernels_at_the_recipe(B, tiles):
    """B 1 (the tracker) splits the 11 query tiles over 11 blocks per (b, m)
    (88 blocks), B 4 three tiles a block (128 blocks); B 12 and 16 fill half
    the card with their B*M pairs and walk all tiles in one block each."""
    plan = msda_plan(B, 8, 64, RECIPE, H100_SMS, itemsize=2, Lq=648, P=4)
    assert plan.fwd == "tap" and plan.fwd_tiles == tiles
    assert plan.fwd_smem == tap_fwd_smem(RECIPE) == 128 * 704 + 2 * 6 * 8192 + 8192 + 16384 + 1024 + 1024
    assert plan.bwd == ("tap", "tap") and plan.bwd_smem == TAP_BWD_SMEM == 217_088
    blocks = B * 8 * -(-11 // tiles)
    assert blocks <= H100_SMS or 2 * B * 8 >= H100_SMS


def test_plan_fit_limits():
    """The forward's value rows and tap tiles fit up to two 384-pixel levels
    (and 4 levels); the backward's dV registers up to 384 pixels a level;
    D other than 64 and point counts other than 2 and 4 take the gather and
    direct kernels."""
    fits, over = ((384, 1), (384, 1)), ((385, 1), (385, 1))
    assert tap_fwd_smem(fits) <= SMEM_MAX < tap_fwd_smem(over)
    assert msda_plan(16, 8, 64, fits, H100_SMS, itemsize=2, Lq=64, P=4).fwd == "tap"
    assert msda_plan(16, 8, 64, over, H100_SMS, itemsize=2, Lq=64, P=4).fwd == "gather"
    assert msda_plan(16, 8, 64, over, H100_SMS, itemsize=2, Lq=64, P=4).fwd_smem == 0
    plan = msda_plan(16, 8, 64, ((16, 24), (5, 77)), H100_SMS, itemsize=2, Lq=64, P=4)
    assert plan.bwd == ("tap", "direct")                       # 384 and 385 pixels
    assert plan.bwd_smem == TAP_BWD_SMEM <= SMEM_MAX
    assert -(-385 // 64) > TAP_BWD_MAX_BLOCKS
    five = ((3, 3),) * (TAP_FWD_MAX_LEVELS + 1)
    assert msda_plan(16, 8, 64, five[:-1], H100_SMS, itemsize=2, Lq=64, P=4).fwd == "tap"
    assert msda_plan(16, 8, 64, five, H100_SMS, itemsize=2, Lq=64, P=4).fwd == "gather"
    for D in (8, 16, 32, 128):
        plan = msda_plan(16, 8, D, RECIPE, H100_SMS, itemsize=2, Lq=648, P=4)
        assert (plan.fwd, plan.bwd, plan.fwd_tiles) == ("gather", ("direct", "direct"), 0)
    for P in range(1, 9):
        plan = msda_plan(1, 8, 64, RECIPE, H100_SMS, itemsize=2, Lq=648, P=P)
        assert (plan.fwd, plan.bwd[0]) == (("tap", "tap") if P in TAP_POINTS else
                                           ("gather", "direct")), P
    with pytest.raises(TypeError, match="Lq and P"):
        msda_plan(16, 8, 64, RECIPE, H100_SMS, itemsize=2)


@pytest.mark.parametrize("B", [1, 2, 3, 4, 8, 9, 12, 16, 64])
@pytest.mark.parametrize("Lq", [1, 40, 64, 65, 648])
def test_forward_split_covers_every_tile_once(B, Lq):
    """The kernel's chunks of `fwd_tiles` tiles cover the ceil(Lq / 64)
    tiles of each (b, m) once, and no block is left without a tile."""
    plan = msda_plan(B, 8, 64, RECIPE, H100_SMS, itemsize=2, Lq=Lq, P=4)
    n_tiles = -(-Lq // TAP_ROWS)
    chunks = -(-n_tiles // plan.fwd_tiles)
    covered = [t for c in range(chunks)
               for t in range(c * plan.fwd_tiles, min(n_tiles, (c + 1) * plan.fwd_tiles))]
    assert covered == list(range(n_tiles))
    assert (chunks - 1) * plan.fwd_tiles < n_tiles
    if 2 * B * 8 >= H100_SMS:
        assert chunks == 1                         # the pairs fill the card
    else:
        assert B * 8 * chunks < H100_SMS + B * 8   # about one block an SM


def _source(name):
    with open(os.path.join(_build.CSRC_DIR, name)) as f:
        return f.read()


def _c_params(src, name):
    m = re.search(r'extern "C" int ' + name + r"\s*\(([^)]*)\)", src)
    return [p.split()[-1].lstrip("*") for p in m.group(1).split(",")]


def test_cuda_constants_match_the_plan():
    tap = _source("msda_tap.cuh")
    assert re.search(r"constexpr int D = (\d+);", tap).group(1) == "64"
    assert re.search(r"constexpr int ROWS = (\d+);", tap).group(1) == str(TAP_ROWS)
    assert all(f"P != {p}" in src for p in TAP_POINTS for src in (_source("msda.cu"),
                                                                    _source("msda_bwd.cu")))
    fwd, bwd = _source("msda.cu"), _source("msda_bwd.cu")
    assert f"L > {TAP_FWD_MAX_LEVELS}" in fwd
    wg = int(re.search(r"constexpr int TAP_WG = (\d+);", bwd).group(1))
    mt = int(re.search(r"constexpr int TAP_MT = (\d+);", bwd).group(1))
    assert wg * mt == TAP_BWD_MAX_BLOCKS
    for src in (fwd, bwd):
        assert '#include "msda_tap.cuh"' in src and "hopper::wgmma_ss_n64" in src
        assert "msda_tap::merge_" in src
    # the tap kernels' names keep the profiler filters of chip_smoke.py
    assert "msda_fwd_kernel_tap_bf16" in fwd and "msda_bwd_kernel_tap_bf16" in bwd
    # no atomic in the backward tap kernel
    body = bwd[bwd.index("msda_bwd_kernel_tap_bf16("):bwd.index("int launch_tap_p")]
    assert "atomic" not in body


def test_entry_points_take_the_plan():
    """msda_fwd_bf16 takes the plan's query tiles (0: gather), msda_bwd_bf16
    the mask of tap levels; ops/_build.py binds each with as many argtypes
    as the C function has parameters."""
    fwd = _c_params(_source("msda.cu"), "msda_fwd_bf16")
    bwd = _c_params(_source("msda_bwd.cu"), "msda_bwd_bf16")
    assert fwd[-2:] == ["tap_tiles", "stream"] and bwd[-2:] == ["tap_mask", "stream"]
    assert len(_build.SIGNATURES["msda"]["msda_fwd_bf16"][0]) == len(fwd)
    assert len(_build.SIGNATURES["msda_bwd"]["msda_bwd_bf16"][0]) == len(bwd)
    assert "msda_tap.cuh" in _build._headers()
