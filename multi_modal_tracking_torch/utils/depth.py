"""Depth maps as replicated greyscale frames, without cv2.

The JAX package reads a DepthTrack depth map with `cv2.imread(path, -1)`,
clips it at min(3 x its median, 10000) and stretches it with
`cv2.normalize(..., 0, 255, NORM_MINMAX)`, then casts to uint8 and merges
three copies (`eval/running.py _read_depth_as_rgb`,
`train/data/datasets/rgbt.py normalized_depth_pair`). `depth_rgb3d` does
the same in numpy, bit for bit:

  * the clip runs `np.minimum` against the float64 median, which makes the
    map float64 (NumPy 2's promotion); above 10000 the bound is the int
    10000 and the map stays uint16;
  * cv2 scales a float64 map as one fused multiply-add per pixel, x *
    scale + shift rounded once (its AVX2 kernels), and the uint8 cast then
    truncates: a pixel whose exact value is an integer lands on it or
    just below, by that one rounding. `fma` computes the fused operation
    exactly (Boldo and Melquiond's emulation: an exact product, an exact
    sum, the low parts rounded to odd);
  * an integer map is scaled in float32 with float32 scale and shift, fused
    again, and rounded half to even into its own type.
"""
from __future__ import annotations

import numpy as np


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    c = 134217729.0 * a               # 2 ** 27 + 1: Veltkamp's split
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _sum_to_odd(a, b):
    """a + b rounded to odd: the exact sum, or else its neighbour whose last
    significand bit is 1."""
    s, e = _two_sum(a, b)
    even = (np.asarray(s).view(np.int64) & 1) == 0
    toward = np.where(e > 0, np.inf, -np.inf)
    return np.where((e != 0) & even, np.nextafter(s, toward), s)


def fma(a, b, c) -> np.ndarray:
    """a * b + c rounded once to float64 (finite, normal operands)."""
    a, b, c = (np.asarray(v, np.float64) for v in (a, b, c))
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    return th + _sum_to_odd(tl, ul)


def normalize_minmax(x: np.ndarray) -> np.ndarray:
    """`cv2.normalize(x, None, alpha=0, beta=255, norm_type=cv2.NORM_MINMAX)`
    of a float64, uint8 or uint16 array, in its dtype."""
    smin, smax = float(x.min()), float(x.max())
    scale = 255.0 * (1.0 / (smax - smin) if smax - smin > np.finfo(np.float64).eps else 0.0)
    shift = 0.0 - smin * scale
    if x.dtype == np.float64:
        return fma(x, scale, shift)
    if x.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"normalize_minmax: {x.dtype} maps are not taken (float64, uint8, uint16)")
    # float32 operands, the product exact in float64, the sum rounded to odd
    # there and then to float32: one rounding of the exact value
    prod = x.astype(np.float64) * np.float64(np.float32(scale))
    y = _sum_to_odd(prod, np.float64(np.float32(shift))).astype(np.float32)
    info = np.iinfo(x.dtype)
    return np.clip(np.rint(y), info.min, info.max).astype(x.dtype)


def depth_rgb3d(dp: np.ndarray, depth_clip: bool = True) -> np.ndarray:
    """A depth map (uint16 or uint8 (H, W), as stored) -> the replicated
    greyscale uint8 (H, W, 3) frame of the JAX package's depth readers."""
    if depth_clip:
        max_depth = min(np.median(dp) * 3, 10000)
        dp = np.minimum(dp, max_depth)
    dp = np.asarray(normalize_minmax(dp), dtype=np.uint8)
    return np.stack([dp, dp, dp], axis=-1)
