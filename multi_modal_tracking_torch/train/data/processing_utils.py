"""Host-side (numpy) crop utilities for the training data pipeline: the
port's own copy of the JAX package's `train/data/processing_utils.py`,
without cv2.

`sample_target` keeps the reference's geometry: a square crop of side
ceil(sqrt(w*h) * factor) centred with half-to-even rounding, zero padding
outside the image (cv2.copyMakeBorder BORDER_CONSTANT = `np.pad`), and the
quirk that drops the last image row/column whenever the window reaches it.

`resize_linear` is cv2.resize INTER_LINEAR written out: sample positions
(d + 0.5) * src/dst - 0.5 in float32; columns clamped to the edge (weight
0 on the missing tap), rows not (an edge row blends a row with itself);
for uint8 the 11-bit fixed-point coefficients and the shift-and-round
sequence of cv2's vectorised 8-bit path. On this repository's crop sizes
it reproduces cv2 bit for bit (tests/test_torch_port_train_data.py).
"""
from __future__ import annotations

import math

import numpy as np


def _linear_taps(src: int, dst: int, clamp: bool):
    """cv2 INTER_LINEAR taps along one axis: (i0, i1, frac float32)."""
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * (1.0 / (dst / src)) - 0.5).astype(np.float32)
    i0 = np.floor(f)
    frac = (f - i0).astype(np.float32)
    i0 = i0.astype(np.int64)
    if clamp:
        frac[(i0 < 0) | (i0 >= src - 1)] = 0.0
    return np.clip(i0, 0, src - 1), np.clip(i0 + 1, 0, src - 1), frac


def _fixed_coefs(frac: np.ndarray):
    one = np.float32(1.0)
    scale = np.float32(2048.0)
    return (np.rint((one - frac) * scale).astype(np.int64),
            np.rint(frac * scale).astype(np.int64))


def resize_linear(img: np.ndarray, out_sz: int) -> np.ndarray:
    """(H, W[, C]) -> (out_sz, out_sz[, C]) as cv2.resize INTER_LINEAR.
    uint8 in -> uint8 out, float in -> float64 out."""
    H, W = img.shape[:2]
    x0, x1, fx = _linear_taps(W, out_sz, clamp=True)
    y0, y1, fy = _linear_taps(H, out_sz, clamp=False)
    ex = (slice(None), slice(None)) + (None,) * (img.ndim - 2)
    ey = (slice(None),) + (None,) * (img.ndim - 1)
    if img.dtype == np.uint8:
        a0, a1 = _fixed_coefs(fx)
        b0, b1 = _fixed_coefs(fy)
        src = img.astype(np.int64)
        rows = src[:, x0] * a0[ex[1:]] + src[:, x1] * a1[ex[1:]]     # x 2048
        r = ((rows[y0] >> 4) * b0[ey] >> 16) + ((rows[y1] >> 4) * b1[ey] >> 16)
        return np.clip((r + 2) >> 2, 0, 255).astype(np.uint8)
    fx, fy = fx.astype(np.float64), fy.astype(np.float64)
    src = img.astype(np.float64)
    rows = src[:, x0] * (1.0 - fx)[ex[1:]] + src[:, x1] * fx[ex[1:]]
    return rows[y0] * (1.0 - fy)[ey] + rows[y1] * fy[ey]


def resize_nearest(img: np.ndarray, out_sz: int) -> np.ndarray:
    """(H, W) -> (out_sz, out_sz) nearest neighbour, cv2 INTER_NEAREST
    (source index floor(d * src/dst))."""
    H, W = img.shape[:2]
    ys = np.minimum(np.floor(np.arange(out_sz) * (1.0 / (out_sz / H))).astype(np.int64), H - 1)
    xs = np.minimum(np.floor(np.arange(out_sz) * (1.0 / (out_sz / W))).astype(np.int64), W - 1)
    return img[ys[:, None], xs[None, :]]


def sample_target(im: np.ndarray, target_bb, search_area_factor: float,
                  output_sz=None):
    """Square crop of area search_area_factor^2 * box area around the box.

    Returns (crop, resize_factor, att_mask) with att_mask True on padded
    pixels (resized to output_sz).
    """
    x, y, w, h = [float(v) for v in target_bb]
    crop_sz = math.ceil(math.sqrt(w * h) * search_area_factor)
    if crop_sz < 1:
        raise ValueError("Too small bounding box.")

    x1 = int(round(x + 0.5 * w - crop_sz * 0.5))
    x2 = int(x1 + crop_sz)
    y1 = int(round(y + 0.5 * h - crop_sz * 0.5))
    y2 = int(y1 + crop_sz)

    x1_pad = int(max(0, -x1))
    x2_pad = int(max(x2 - im.shape[1] + 1, 0))
    y1_pad = int(max(0, -y1))
    y2_pad = int(max(y2 - im.shape[0] + 1, 0))

    im_crop = im[y1 + y1_pad:y2 - y2_pad, x1 + x1_pad:x2 - x2_pad, :]
    if im_crop.size == 0:
        raise ValueError("The crop window lies outside the image.")
    im_crop_padded = np.pad(im_crop, ((y1_pad, y2_pad), (x1_pad, x2_pad), (0, 0)))
    H, W = im_crop_padded.shape[:2]
    att_mask = np.ones((H, W))
    end_x = -x2_pad if x2_pad else None
    end_y = -y2_pad if y2_pad else None
    att_mask[y1_pad:end_y, x1_pad:end_x] = 0

    if output_sz is not None:
        resize_factor = output_sz / crop_sz
        return (resize_linear(im_crop_padded, output_sz), resize_factor,
                resize_linear(att_mask, output_sz).astype(np.bool_))
    return im_crop_padded, 1.0, att_mask.astype(np.bool_)


def transform_image_to_crop(box_in: np.ndarray, box_extract: np.ndarray,
                            resize_factor: float, crop_sz: int,
                            normalize: bool = False) -> np.ndarray:
    """Map a box from image coords into the crop's coordinate frame."""
    box_in = np.asarray(box_in, dtype=np.float32)
    box_extract = np.asarray(box_extract, dtype=np.float32)
    box_extract_center = box_extract[0:2] + 0.5 * box_extract[2:4]
    box_in_center = box_in[0:2] + 0.5 * box_in[2:4]
    box_out_center = (crop_sz - 1) / 2 + (box_in_center - box_extract_center) * resize_factor
    box_out_wh = box_in[2:4] * resize_factor
    box_out = np.concatenate([box_out_center - 0.5 * box_out_wh, box_out_wh])
    return box_out / crop_sz if normalize else box_out
