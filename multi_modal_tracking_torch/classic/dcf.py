"""Discriminative-correlation-filter building blocks of the classic
trackers (ECO, ATOM, DiMP): the port's counterpart of the JAX package's
`classic/dcf.py`.

Hann windows, Gaussian labels, rfft2-domain correlation with exact Fourier
upsampling, the integer and sub-pixel peak, the advanced localisation's
decision tree and ECO's spatial regularisation window. Every function is a
plain tensor function on the input's device; nothing reads a value back to
the host, so a tracker step built on them dispatches without a sync. FFTs
are `torch.fft` (cuFFT on the card), in float32 / complex64.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import torch


@functools.lru_cache(maxsize=None)
def _const(values: Tuple[float, ...], dtype: torch.dtype, device: str) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def const(values: Sequence[float], device, dtype=torch.float32) -> torch.Tensor:
    """A small constant tensor, made on `device` once and then reused: a
    tensor made from host values at every step would be a copy from the
    host in the step (on the card, from pageable memory: a wait for the
    stream), and could not be captured in a CUDA graph. Read it only."""
    return _const(tuple(values), dtype, str(torch.device(device)))


def hann1d(n: int, centered: bool = True, device=None) -> torch.Tensor:
    """Centred or half-shifted 1-D Hann window (pytracking dcf.hann1d)."""
    if centered:
        k = torch.arange(1, n + 1, dtype=torch.float32, device=device)
        return 0.5 * (1.0 - torch.cos(2.0 * math.pi * k / (n + 1)))
    k = torch.arange(0, n // 2 + 1, dtype=torch.float32, device=device)
    w = 0.5 * (1.0 + torch.cos(2.0 * math.pi * k / (n + 2)))
    return torch.cat([w, torch.flip(w[1: n - n // 2], (0,))])


def hann2d(h: int, w: int, device=None) -> torch.Tensor:
    """Outer product of centred 1-D Hann windows, (h, w)."""
    return hann1d(h, device=device)[:, None] * hann1d(w, device=device)[None, :]


def gauss_label_2d(h: int, w: int, sigma, center: torch.Tensor) -> torch.Tensor:
    """Gaussian regression target centred at `center` = (cy, cx), pixel
    coordinates of an (h, w) map; `sigma` a float or a 0-d tensor."""
    dev = center.device
    ky = torch.arange(h, dtype=torch.float32, device=dev) - center[0]
    kx = torch.arange(w, dtype=torch.float32, device=dev) - center[1]
    gy = torch.exp(-0.5 * (ky / sigma) ** 2)
    gx = torch.exp(-0.5 * (kx / sigma) ** 2)
    return gy[:, None] * gx[None, :]


def fft2(x: torch.Tensor) -> torch.Tensor:
    """rfft2 over the trailing two dims."""
    return torch.fft.rfft2(x, dim=(-2, -1))


def ifft2(xf: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    return torch.fft.irfft2(xf, s=tuple(shape), dim=(-2, -1))


def pad_rfft2(sf: torch.Tensor, out_hw: Tuple[int, int],
              in_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Zero-pad the rfft2 spectrum (..., h, w//2+1) of an (h, w) real signal
    into the spectrum of an (H, W) grid: exact Fourier (sinc) upsampling
    with the spatial amplitude kept. An odd input width cannot be told from
    the half spectrum: pass in_hw (the default assumes an even width). An
    even size's Nyquist bins are split half and half between the +N/2 and
    -N/2 rows (and halved at the w/2 column); odd sizes have none."""
    h, wf = sf.shape[-2], sf.shape[-1]
    w = 2 * (wf - 1) if in_hw is None else in_hw[1]
    if in_hw is not None:
        assert in_hw[0] == h and w // 2 + 1 == wf, (in_hw, tuple(sf.shape))
    H, W = out_hw
    if (h, w) == (H, W):
        return sf
    Wf = W // 2 + 1
    out = sf.new_zeros(sf.shape[:-2] + (H, Wf))
    top = h // 2 + 1                      # rows 0..h/2 (the Nyquist row if h is even)
    bot = h - top                         # negative-frequency rows
    body = sf
    if w % 2 == 0 and w < W:              # halve the even width's Nyquist column
        scale = torch.ones(wf, dtype=torch.float32, device=sf.device)
        scale[wf - 1] = 0.5
        body = body * scale
    rows_top = body[..., :top, :]
    if h % 2 == 0 and h < H:
        # the Nyquist row split between +h/2 and -h/2 (Hermitian in kx by
        # itself, so the signal stays real)
        scale = torch.ones(top, 1, dtype=torch.float32, device=sf.device)
        scale[top - 1] = 0.5
        rows_top = rows_top * scale
        out[..., H - h // 2, :wf] = rows_top[..., top - 1, :]
    out[..., :top, :wf] = rows_top
    if bot:
        out[..., H - bot:, :wf] = body[..., top:, :]
    return out * (float(H * W) / float(h * w))


def max2d(score: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """argmax of an (H, W) map -> (max value, (row, col) int64), on the
    device."""
    w = score.shape[-1]
    flat = score.reshape(-1)
    idx = torch.argmax(flat)
    return flat.gather(0, idx.reshape(1))[0], torch.stack([idx // w, idx % w])


def _at(score: torch.Tensor, r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """score[r, c] for 0-d index tensors, without a read to the host."""
    return score.reshape(-1).gather(0, (r * score.shape[-1] + c).reshape(1))[0]


def subpixel_peak(score: torch.Tensor, peak: torch.Tensor) -> torch.Tensor:
    """Quadratic sub-pixel refinement of the integer peak (row, col) of a
    2-D map: a parabola through the peak and its two neighbours along each
    axis, its offset clipped to [-1, 1]. The flat case is guarded on the
    negative side (a maximum's curvature is <= 0)."""
    h, w = score.shape
    r = torch.clamp(peak[0], 1, h - 2)
    c = torch.clamp(peak[1], 1, w - 2)
    f0 = _at(score, r, c)
    fr1, fr2 = _at(score, r - 1, c), _at(score, r + 1, c)
    fc1, fc2 = _at(score, r, c - 1), _at(score, r, c + 1)
    dr = 0.5 * (fr1 - fr2) / torch.clamp(fr1 - 2 * f0 + fr2, max=-1e-12)
    dc = 0.5 * (fc1 - fc2) / torch.clamp(fc1 - 2 * f0 + fc2, max=-1e-12)
    dr = torch.clamp(dr, -1.0, 1.0)
    dc = torch.clamp(dc, -1.0, 1.0)
    return torch.stack([r + dr, c + dc]).to(torch.float32)


# localisation flags (pytracking's string flags as int codes, so that the
# whole decision runs on the device)
FLAG_NORMAL = 0
FLAG_NOT_FOUND = 1
FLAG_UNCERTAIN = 2
FLAG_HARD_NEGATIVE = 3


def localize_advanced(score: torch.Tensor, target_sz_score: torch.Tensor,
                      prev_disp: Optional[torch.Tensor] = None, *,
                      not_found_threshold: float = 0.25,
                      distractor_threshold: float = 0.8,
                      hard_negative_threshold: float = 0.5,
                      target_neighborhood_scale: float = 2.2,
                      displacement_scale: float = 0.8):
    """Target localisation with distractor, hard-negative and lost
    detection (ATOM's and DiMP's localize_advanced), on the device.

    score (H, W) response map; target_sz_score (2,) target (h, w) in map
    pixels; prev_disp (2,) the previous displacement from the map centre
    (zeros for a centred crop). Returns (disp (2,), flag int32 0-d, peak
    value). The decision tree, in the reference's order:
      peak1 < not_found_threshold                     -> NOT_FOUND
      peak2 > distractor_threshold * peak1:
        peak2 near and peak1 far from prev_disp       -> HARD_NEGATIVE at peak2
        peak1 near and peak2 far                      -> HARD_NEGATIVE at peak1
        otherwise                                     -> UNCERTAIN
      peak2 > hard_negative_threshold * peak1
        and peak2 > not_found_threshold               -> HARD_NEGATIVE
      otherwise                                       -> NORMAL
    """
    h, w = score.shape
    dev = score.device
    center = const([(h - 1) / 2.0, (w - 1) / 2.0], dev)
    if prev_disp is None:
        prev_disp = torch.zeros(2, dtype=torch.float32, device=dev)

    s1, p1 = max2d(score)
    d1 = subpixel_peak(score, p1) - center

    # the primary target's neighbourhood zeroed: the rounded, clipped window
    # [top, bottom) x [left, right)
    half = target_neighborhood_scale * target_sz_score / 2.0
    p1f = p1.to(torch.float32)
    top = torch.round(p1f[0] - half[0])
    bottom = torch.round(p1f[0] + half[0] + 1)
    left = torch.round(p1f[1] - half[1])
    right = torch.round(p1f[1] + half[1] + 1)
    rows = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    cols = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    inside = (rows >= top) & (rows < bottom) & (cols >= left) & (cols < right)
    masked = torch.where(inside, torch.zeros_like(score), score)

    s2, p2 = max2d(masked)
    d2 = subpixel_peak(masked, p2) - center

    disp_threshold = displacement_scale * math.sqrt(float(h * w)) / 2.0
    n1 = torch.linalg.vector_norm(d1 - prev_disp)
    n2 = torch.linalg.vector_norm(d2 - prev_disp)

    c_nf = s1 < not_found_threshold
    c_distr = s2 > distractor_threshold * s1
    c_hn_keep = c_distr & (n2 > disp_threshold) & (n1 < disp_threshold)
    c_hn_switch = c_distr & (n2 < disp_threshold) & (n1 > disp_threshold)
    c_unc = c_distr & ~c_hn_keep & ~c_hn_switch
    c_hn = ~c_distr & (s2 > hard_negative_threshold * s1) & (s2 > not_found_threshold)

    # jnp.select: the first true condition wins
    flag = torch.full((), FLAG_NORMAL, dtype=torch.int32, device=dev)
    for cond, val in reversed(((c_nf, FLAG_NOT_FOUND), (c_hn_keep, FLAG_HARD_NEGATIVE),
                               (c_hn_switch, FLAG_HARD_NEGATIVE), (c_unc, FLAG_UNCERTAIN),
                               (c_hn, FLAG_HARD_NEGATIVE))):
        flag = torch.where(cond, torch.full_like(flag, val), flag)
    disp = torch.where(c_hn_switch & ~c_nf, d2, d1)
    return disp, flag, s1


def reg_window(h: int, w: int, target_sz, *, window_min: float, window_edge: float,
               window_power: float = 2.0, sparsity_threshold: float = 0.05,
               square: bool = False) -> torch.Tensor:
    """ECO's spatial regularisation window (pytracking dcf.get_reg_filter)
    as a spatial penalty weight on the (h, w) feature grid, target_sz (th,
    tw) in feature cells (a tensor; its device is the result's).

    The polynomial bowl's DFT loses every coefficient under
    `sparsity_threshold` of the largest, the DC tap restores the minimum
    to `window_min`, and the window is laid out with the target at the
    origin. Convolving the filter spectrum with the full sparsified taps is
    multiplying the spatial filter by this window, so the penalty residual
    is fft2(W * ifft2(f)). The reference keeps real(dft) of the centred
    window, so the effective window is the mean of the window and its copy
    shifted diagonally by (n - 2c) cells."""
    target_sz = torch.as_tensor(target_sz, dtype=torch.float32)
    dev = target_sz.device
    if square:
        side = torch.sqrt(target_sz.prod())
        target_sz = torch.stack([side, side])
    reg_scale = 0.5 * target_sz
    wrg = (torch.arange(h, dtype=torch.float32, device=dev) - (h - 1) // 2)[:, None]
    wcg = (torch.arange(w, dtype=torch.float32, device=dev) - (w - 1) // 2)[None, :]
    win = (window_edge - window_min) * (
        torch.abs(wrg / reg_scale[0]) ** window_power +
        torch.abs(wcg / reg_scale[1]) ** window_power) + window_min
    dft = torch.fft.rfft2(win) / (h * w)
    mag = torch.abs(dft)
    keep = mag >= sparsity_threshold * mag.max()
    sparse = torch.fft.irfft2(torch.where(keep, dft, torch.zeros_like(dft)), s=(h, w)) * (h * w)
    sparse = sparse - sparse.min() + window_min
    cy, cx = (h - 1) // 2, (w - 1) // 2
    sparse = torch.roll(sparse, (-cy, -cx), dims=(0, 1))
    return 0.5 * (sparse + torch.roll(sparse, (h - 2 * cy, w - 2 * cx), dims=(0, 1)))
