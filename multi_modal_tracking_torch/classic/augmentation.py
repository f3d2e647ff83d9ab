"""Init-time augmentation of the classic trackers: the port's counterpart
of the JAX package's `classic/augmentation.py` (pytracking's
generate_init_samples transforms).

The first frame's sample memory is filled from one crop and its
transformed copies (shifts, a horizontal flip, separable Gaussian blurs,
rotations, scalings), plus channel-dropout copies of the identity
sample's features. Crops are (H, W, C) float tensors; every transform's
constants (blur taps, rotation sample grids) are made on the host once
per augmenter and kept on the crop's device, and the whole batch is
built by a fixed set of operations, no read back to the host.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# pytracking's default DiMP/ATOM augmentation (params.augmentation)
DEFAULT_AUGMENTATION = {
    "fliplr": True,
    "rotate": [10, -10, 45, -45],
    "blur": [(3, 1), (1, 3), (2, 2)],
    "relativeshift": [(0.6, 0.6), (-0.6, 0.6), (0.6, -0.6), (-0.6, -0.6)],
    "dropout": (2, 0.2),
}

# ECO's own augmentation (parameter/eco/default.py): 4 absolute shifts, a
# flip, 12 rotations, 5 blurs, 7 dropout copies of the features
ECO_AUGMENTATION = {
    "fliplr": True,
    "rotate": [5, -5, 10, -10, 20, -20, 30, -30, 45, -45, -60, 60],
    "blur": [(2, 0.2), (0.2, 2), (3, 1), (1, 3), (2, 2)],
    "shift": [(6, 6), (-6, 6), (6, -6), (-6, -6)],
    "dropout": (7, 0.2),
}


def translate(img: torch.Tensor, ty: int, tx: int) -> torch.Tensor:
    """Shift the content by (+ty, +tx) pixels with zero fill."""
    H, W = img.shape[0], img.shape[1]
    py0, py1 = max(ty, 0), max(-ty, 0)
    px0, px1 = max(tx, 0), max(-tx, 0)
    pad = [0, 0] * (img.dim() - 2) + [px0, px1, py0, py1]
    out = F.pad(img, pad)
    return out[py1:py1 + H, px1:px1 + W]


def fliplr(img: torch.Tensor) -> torch.Tensor:
    return torch.flip(img, (1,))


def flipud(img: torch.Tensor) -> torch.Tensor:
    return torch.flip(img, (0,))


def gauss_kernel(sigma: float) -> np.ndarray:
    """Normalised 1-D Gaussian taps of radius ceil(2 sigma), float32."""
    sigma = max(float(sigma), 1e-3)
    r = int(np.ceil(2 * sigma))
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-x * x / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def blur(img: torch.Tensor, sigma) -> torch.Tensor:
    """Separable Gaussian blur with zero 'same' padding: a vertical then a
    horizontal 1-D correlation. sigma = (sigma_y, sigma_x) or a scalar."""
    sy, sx = (sigma, sigma) if np.isscalar(sigma) else sigma
    ky = torch.from_numpy(gauss_kernel(sy)).to(img.device)
    kx = torch.from_numpy(gauss_kernel(sx)).to(img.device)
    x = img.float()
    squeeze = x.dim() == 2
    if squeeze:
        x = x[..., None]
    x = x.permute(2, 0, 1)[:, None]                      # (C, 1, H, W)
    x = F.conv2d(x, ky.view(1, 1, -1, 1), padding=(ky.numel() // 2, 0))
    x = F.conv2d(x, kx.view(1, 1, 1, -1), padding=(0, kx.numel() // 2))
    x = x[:, 0].permute(1, 2, 0)
    return x[..., 0] if squeeze else x


def rotation_coords(H: int, W: int, angle_deg: float) -> Tuple[np.ndarray, np.ndarray]:
    """Source coordinates (float32 (H, W) rows and columns) of a rotation
    about the crop centre, computed in numpy as the JAX package does."""
    a = np.deg2rad(float(angle_deg))
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    ys, xs = yy - cy, xx - cx
    src_y = np.cos(a) * ys - np.sin(a) * xs + cy
    src_x = np.sin(a) * ys + np.cos(a) * xs + cx
    return src_y.astype(np.float32), src_x.astype(np.float32)


def _linear_taps(coord: torch.Tensor, size: int):
    """[(index, weight, valid)] of order-1 interpolation along one axis:
    the floor and the next index (map_coordinates' order=1 taps)."""
    lower = torch.floor(coord)
    upper_w = coord - lower
    idx = lower.to(torch.int64)
    out = []
    for i, wt in ((idx, 1.0 - upper_w), (idx + 1, upper_w)):
        out.append((i.clamp(0, size - 1), wt, (i >= 0) & (i < size)))
    return out


def bilinear_sample(img: torch.Tensor, src_y: torch.Tensor, src_x: torch.Tensor) -> torch.Tensor:
    """Order-1 interpolation of (H, W[, C]) at (src_y, src_x) with zero
    outside (scipy/jax map_coordinates(order=1, mode='constant', cval=0):
    each of the four taps contributes its pixel if inside, else zero,
    summed in the order (y0, x0), (y0, x1), (y1, x0), (y1, x1))."""
    H, W = img.shape[0], img.shape[1]
    flat = img.reshape(H * W, -1).float()
    out = None
    for iy, wy, vy in _linear_taps(src_y, H):
        for ix, wx, vx in _linear_taps(src_x, W):
            v = flat.index_select(0, (iy * W + ix).reshape(-1)).reshape(src_y.shape + (-1,))
            term = torch.where((vy & vx)[..., None], v, torch.zeros_like(v)) * (wy * wx)[..., None]
            out = term if out is None else out + term
    return out.reshape(src_y.shape + img.shape[2:])


def rotate(img: torch.Tensor, angle_deg: float) -> torch.Tensor:
    """Bilinear rotation about the crop centre, zero fill."""
    sy, sx = rotation_coords(img.shape[0], img.shape[1], angle_deg)
    return bilinear_sample(img, torch.from_numpy(sy).to(img.device),
                           torch.from_numpy(sx).to(img.device))


def scale_about_center(img: torch.Tensor, factor: float) -> torch.Tensor:
    """Zoom about the centre keeping the size: a bilinear resize by
    `factor` (antialiased when it shrinks, as jax.image.resize), then a
    centre crop or zero pad back to (H, W)."""
    H, W = img.shape[0], img.shape[1]
    nh, nw = max(int(round(H * factor)), 1), max(int(round(W * factor)), 1)
    x = img.float()
    squeeze = x.dim() == 2
    if squeeze:
        x = x[..., None]
    z = F.interpolate(x.permute(2, 0, 1)[None], size=(nh, nw), mode="bilinear",
                      align_corners=False, antialias=nh < H or nw < W)[0].permute(1, 2, 0)
    if nh >= H:
        y0, x0 = (nh - H) // 2, (nw - W) // 2
        z = z[y0:y0 + H, x0:x0 + W]
    else:
        py, px = (H - nh) // 2, (W - nw) // 2
        z = F.pad(z, [0, 0, px, W - nw - px, py, H - nh - py])
    return z[..., 0] if squeeze else z


def feature_dropout2d(feat: torch.Tensor, num: int, prob: float,
                      uniform: torch.Tensor) -> torch.Tensor:
    """Channel-dropout copies of one feature map (F.dropout2d in training
    mode on the identity sample): channel c of copy i is zeroed where
    uniform[i, c] >= 1 - prob (jax.random.bernoulli's rule), the survivors
    scaled by 1 / (1 - prob). feat (C, h, w) -> (num, C, h, w); uniform in
    [0, 1), (num, 1, 1, C) as the JAX package draws it (or (num, C))."""
    keep = (uniform.reshape(num, -1) < 1.0 - prob).to(feat.dtype)
    return feat[None] * keep[:, :, None, None] / (1.0 - prob)


#: uniform(site, shape, frame) -> float32 tensor in [0, 1): the trackers'
#: draw hook (`TorchDraws` by default; a test injects the JAX package's bits)
Draw = Callable[[str, Tuple[int, ...], int], torch.Tensor]


class TorchDraws:
    """The trackers' default random draws: one torch.Generator on the
    device, reseeded from (seed, site, frame) at each draw, so that a draw
    depends on those three alone (the JAX package folds the frame into a
    per-site key). `offsets` maps a site to its seed offset."""

    def __init__(self, seed: int, device, offsets: Dict[str, int]):
        self.seed, self.device, self.offsets = int(seed), torch.device(device), dict(offsets)
        self.gen = torch.Generator(device=self.device)

    def __call__(self, site: str, shape: Tuple[int, ...], frame: int = 0) -> torch.Tensor:
        self.gen.manual_seed((self.seed + self.offsets[site]) * 1_000_003 + int(frame))
        return torch.rand(tuple(shape), generator=self.gen, device=self.device)


class InitAugmenter:
    """A static list of transforms -> one batched augmented crop tensor.

    Identity first, then shift / relativeshift / fliplr / blur / scale /
    rotate, each but the explicit shifts offset by a random shift drawn
    once here from numpy's default_rng(seed) (random_shift_factor; the JAX
    package's draws, copied). `shifts[i]` is sample i's target-centre
    displacement in crop pixels (dy, dx), which moves its label."""

    def __init__(self, crop_size: int, spec: Optional[dict] = None,
                 random_shift_factor: float = 1.0 / 3.0, seed: int = 0):
        spec = DEFAULT_AUGMENTATION if spec is None else spec
        self.crop_size = int(crop_size)
        rng = np.random.default_rng(seed)
        sz = float(crop_size)

        def rand_shift():
            if random_shift_factor <= 0:
                return (0, 0)
            s = (rng.random(2) - 0.5) * sz * random_shift_factor
            return (int(s[0]), int(s[1]))

        ops: List[Tuple] = [("identity", None, (0, 0))]
        for sh in spec.get("shift", []):
            ops.append(("shift", None, (int(sh[0]), int(sh[1]))))
        for sh in spec.get("relativeshift", []):
            ops.append(("shift", None, (int(sh[0] * sz / 2), int(sh[1] * sz / 2))))
        if spec.get("fliplr", False):
            ops.append(("fliplr", None, rand_shift()))
        for sigma in spec.get("blur", []):
            ops.append(("blur", sigma, rand_shift()))
        for factor in spec.get("scale", []):
            ops.append(("scale", float(factor), rand_shift()))
        for angle in spec.get("rotate", []):
            ops.append(("rotate", float(angle), rand_shift()))
        self.ops = ops
        self.dropout = spec.get("dropout", None)        # (num, prob) on the features
        self._coords: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    @property
    def num_image_samples(self) -> int:
        return len(self.ops)

    @property
    def num_samples(self) -> int:
        return len(self.ops) + (self.dropout[0] if self.dropout else 0)

    @property
    def shifts(self) -> np.ndarray:
        """(A, 2) label-centre displacement (dy, dx) per sample, crop px."""
        base = np.asarray([op[2] for op in self.ops], np.float32)
        if self.dropout:
            base = np.concatenate([base, np.zeros((self.dropout[0], 2), np.float32)])
        return base

    def _rotation(self, H: int, W: int, angle: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
        key = (H, W, angle, str(device))
        if key not in self._coords:
            sy, sx = rotation_coords(H, W, angle)
            self._coords[key] = (torch.from_numpy(sy).to(device), torch.from_numpy(sx).to(device))
        return self._coords[key]

    def __call__(self, crop: torch.Tensor) -> torch.Tensor:
        """crop (H, W, C) -> (num_image_samples, H, W, C) float32."""
        out = []
        H, W = crop.shape[0], crop.shape[1]
        for kind, arg, shift in self.ops:
            x = crop
            if kind == "fliplr":
                x = fliplr(x)
            elif kind == "blur":
                x = blur(x, arg)
            elif kind == "scale":
                x = scale_about_center(x, arg)
            elif kind == "rotate":
                x = bilinear_sample(x, *self._rotation(H, W, arg, crop.device))
            if shift != (0, 0):
                x = translate(x, shift[0], shift[1])
            out.append(x.float())
        return torch.stack(out)

    def augment_features(self, feats: torch.Tensor, uniform: Optional[torch.Tensor]) -> torch.Tensor:
        """Append dropout copies of the identity sample: feats (A_img, C, h,
        w) -> (num_samples, C, h, w); uniform (num, 1, 1, C) in [0, 1)."""
        if not self.dropout:
            return feats
        num, prob = self.dropout
        extra = feature_dropout2d(feats[0], int(num), float(prob), uniform)
        return torch.cat([feats, extra.to(feats.dtype)], dim=0)
