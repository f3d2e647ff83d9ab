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
`crop_resize_batch` crops N images at N boxes at once (the lockstep
tracker), `crop_resize_window` a frame of which only a window was uploaded.
"""
from __future__ import annotations

import torch

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _resample_matrix(full_extent: int, out_sz: int, lo: torch.Tensor,
                     crop_sz: torch.Tensor) -> torch.Tensor:
    """(..., out_sz, full_extent) 1-D resampling matrices.

    Output row j holds the bilinear weights of crop coordinate
    c_j = (j + 0.5) * crop_sz / out_sz - 0.5, clamped to the crop, over image
    pixels, masked to the valid image range [max(lo, 0), min(lo + crop_sz,
    full_extent - 1)).
    lo, crop_sz: int32 tensors of one shape (...) (crop start, may be < 0;
    crop size); a batch of crops gives a batch of matrices.
    """
    dev = lo.device
    crop_f = crop_sz.float()[..., None]
    j = torch.arange(out_sz, dtype=torch.float32, device=dev)
    c = (j + 0.5) * (crop_f / out_sz) - 0.5
    c = torch.minimum(torch.clamp(c, min=0.0), crop_f - 1.0)
    c0 = torch.floor(c)
    frac = c - c0
    t0 = lo[..., None] + c0.to(torch.int32)
    t1 = t0 + 1

    valid_lo = torch.clamp(lo, min=0)[..., None, None]
    valid_hi = torch.clamp(lo + crop_sz, max=full_extent - 1)[..., None, None]   # exclusive
    cols = torch.arange(full_extent, dtype=torch.int32, device=dev)
    in_valid = (cols >= valid_lo) & (cols < valid_hi)
    m0 = (cols == t0[..., None]) & in_valid
    m1 = (cols == t1[..., None]) & in_valid
    return m0 * (1.0 - frac)[..., None] + m1 * frac[..., None]


def _crop_window(box_xywh: torch.Tensor, search_area_factor: float):
    """(x1, y1, crop size) int32 and the float crop size of the square crop
    around xywh boxes (..., 4); torch.round rounds half to even, like the
    reference's python round()."""
    x, y, w, h = box_xywh.unbind(-1)
    crop_sz = torch.clamp(torch.ceil(torch.sqrt(w * h) * search_area_factor), min=1.0)
    x1 = torch.round(x + 0.5 * w - crop_sz * 0.5).to(torch.int32)
    y1 = torch.round(y + 0.5 * h - crop_sz * 0.5).to(torch.int32)
    return x1, y1, crop_sz.to(torch.int32), crop_sz


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
    x1, y1, crop_i, crop_sz = _crop_window(box_xywh, search_area_factor)
    A_y = _resample_matrix(H, output_sz, y1, crop_i)     # (out, H)
    A_x = _resample_matrix(W, output_sz, x1, crop_i)     # (out, W)
    tmp = (A_y @ img.float().reshape(H, W * C)).reshape(output_sz, W, C)
    out = torch.einsum("pw,owc->opc", A_x, tmp)
    return out, output_sz / crop_sz


def crop_resize_batch(imgs: torch.Tensor, boxes_xywh: torch.Tensor,
                      search_area_factor: float, output_sz: int):
    """crop_resize of N images at N boxes as one batched product pair.

    imgs       : (N, H, W, C) images of one size, uint8 or float
    boxes_xywh : (N, 4) float32
    returns    : (crops (N, output_sz, output_sz, C) float32, resize
                 factors (N,)). The same function of each image as
                 crop_resize; a batched product may sum in another order, so
                 results can differ from it in the last bit.
    """
    N, H, W, C = imgs.shape
    x1, y1, crop_i, crop_sz = _crop_window(boxes_xywh, search_area_factor)
    A_y = _resample_matrix(H, output_sz, y1, crop_i)     # (N, out, H)
    A_x = _resample_matrix(W, output_sz, x1, crop_i)     # (N, out, W)
    tmp = torch.bmm(A_y, imgs.float().reshape(N, H, W * C)).reshape(N, output_sz, W, C)
    out = torch.einsum("npw,nowc->nopc", A_x, tmp)
    return out, output_sz / crop_sz


def crop_resize_window(window: torch.Tensor, box_xywh: torch.Tensor, offset_xy, frame_hw,
                       search_area_factor: float, output_sz: int):
    """crop_resize of a frame of which only a sub-window was uploaded (the
    ROI upload mode of the eval runner).

    window    : (Hw, Ww, C) or (Hw, Ww) sub-image whose [0, 0] lies at frame
                pixel (oy, ox); it must lie inside the frame
    box_xywh  : (4,) float32 box in frame coordinates
    offset_xy : (ox, oy) python ints
    frame_hw  : (H, W) of the full frame
    returns   : (crop, resize_factor, ok) with ok a bool 0-d tensor: True iff
                every frame pixel the full-frame crop reads lies inside the
                window (the JAX package's `crop_resize_window` rule), and then
                crop equals crop_resize(frame, box)[0] bit for bit.

    The window is placed in a zero frame of the full size and cropped by
    crop_resize itself: a product over another extent may sum in another
    order (BLAS blocking, the GEMM kernel the library picks for the shape),
    and bit equality would then hang on the library. Here the products are
    the same ones; they differ only at pixels the crop weighs by zero. The
    upload is what the window saves.
    """
    H, W = int(frame_hw[0]), int(frame_hw[1])
    ox, oy = int(offset_xy[0]), int(offset_xy[1])
    Hw, Ww = window.shape[0], window.shape[1]
    canvas = window.new_zeros((H, W) + tuple(window.shape[2:]))
    canvas[oy:oy + Hw, ox:ox + Ww] = window
    crop, rf = crop_resize(canvas, box_xywh, search_area_factor, output_sz)
    x1, y1, crop_i, _ = _crop_window(box_xywh, search_area_factor)

    def covered(lo, ext, o, wext):
        read_lo = torch.clamp(lo, min=0)
        read_hi = torch.clamp(lo + crop_i, max=ext - 1)            # exclusive
        return (read_hi <= read_lo) | ((read_lo >= o) & (read_hi <= o + wext))

    return crop, rf, covered(x1, W, ox, Ww) & covered(y1, H, oy, Hw)


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """0..255-scale (..., 3) image -> ImageNet-normalised float32."""
    mean = torch.tensor(_IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(_IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x.float() / 255.0 - mean) / std
