"""Target-region cropping for the tracking loop, on the device.

A square crop of side ceil(sqrt(w*h) * factor) centred (with half-to-even
rounding) on the box, zero-padded outside the image, then bilinearly resized
(half-pixel centres) to output_sz x output_sz — the numerics of the
reference's cv2 `sample_target`, including its quirk that drops the last
image row/column whenever the window touches it.

The crop + pad + resize is two small matrix products per image,

    out = A_y @ img @ A_x^T,

with A_y (out_sz, H) and A_x (out_sz, W) 2-tap bilinear resampling matrices
built on the device from the crop window, so the box never leaves the
device and padding is implicit (taps in the padded region have no column).
"""
from __future__ import annotations

import torch

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _resample_matrix(full_extent: int, out_sz: int, lo: torch.Tensor,
                     crop_sz: torch.Tensor) -> torch.Tensor:
    """(out_sz, full_extent) 1-D resampling matrix.

    Output row j holds the bilinear weights of crop coordinate
    c_j = (j + 0.5) * crop_sz / out_sz - 0.5, clamped to the crop, over image
    pixels, masked to the valid image range [max(lo, 0), min(lo + crop_sz,
    full_extent - 1)).
    lo, crop_sz: int32 scalar tensors (crop start, may be < 0; crop size).
    """
    dev = lo.device
    crop_f = crop_sz.float()
    j = torch.arange(out_sz, dtype=torch.float32, device=dev)
    c = (j + 0.5) * (crop_f / out_sz) - 0.5
    c = torch.minimum(torch.clamp(c, min=0.0), crop_f - 1.0)
    c0 = torch.floor(c)
    frac = c - c0
    t0 = lo + c0.to(torch.int32)
    t1 = t0 + 1

    valid_lo = torch.clamp(lo, min=0)
    valid_hi = torch.clamp(lo + crop_sz, max=full_extent - 1)   # exclusive
    cols = torch.arange(full_extent, dtype=torch.int32, device=dev)[None, :]
    in_valid = (cols >= valid_lo) & (cols < valid_hi)
    m0 = (cols == t0[:, None]) & in_valid
    m1 = (cols == t1[:, None]) & in_valid
    return m0 * (1.0 - frac)[:, None] + m1 * frac[:, None]


def crop_resize(img: torch.Tensor, box_xywh: torch.Tensor,
                search_area_factor: float, output_sz: int):
    """Square crop around `box_xywh` resized to (output_sz, output_sz).

    img      : (H, W, C) or (H, W) image, uint8 or float, on any device
    box_xywh : (4,) float32 [x, y, w, h] in image coordinates, same device
    returns  : (crop, resize_factor): crop (output_sz, output_sz[, C])
               float32, resize_factor = output_sz / crop_sz (0-d float32).
    """
    if img.dim() == 2:
        crop, rf = crop_resize(img[..., None], box_xywh, search_area_factor,
                               output_sz)
        return crop[..., 0], rf
    H, W, C = img.shape
    x, y, w, h = box_xywh.unbind(-1)
    crop_sz = torch.clamp(torch.ceil(torch.sqrt(w * h) * search_area_factor), min=1.0)
    # torch.round rounds half to even, like the reference's python round()
    x1 = torch.round(x + 0.5 * w - crop_sz * 0.5).to(torch.int32)
    y1 = torch.round(y + 0.5 * h - crop_sz * 0.5).to(torch.int32)
    crop_i = crop_sz.to(torch.int32)

    A_y = _resample_matrix(H, output_sz, y1, crop_i)     # (out, H)
    A_x = _resample_matrix(W, output_sz, x1, crop_i)     # (out, W)
    tmp = (A_y @ img.float().reshape(H, W * C)).reshape(output_sz, W, C)
    out = torch.einsum("pw,owc->opc", A_x, tmp)
    return out, output_sz / crop_sz


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """0..255-scale (..., 3) image -> ImageNet-normalised float32."""
    mean = torch.tensor(_IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(_IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x.float() / 255.0 - mean) / std
