"""ctypes bindings of the port's host data library (`csrc/host/data.cpp`):
the training data pipeline's pixel work in C++, named after the JAX
package's `native` module, without its JPEG part.

  sample_target         the crop, resize and padding mask of
                        `train/data/processing_utils.py sample_target`,
                        read through the joint augmentation's grey and
                        mirror flags, and the validity check of
                        `train/data/processing.py _att_mask_valid`;
                        `sample_target_pair` crops an RGB-T pair at one
                        window in one call;
  jitter_jet_normalise  `train/data/transforms.py tensor_and_jitter_rgbt`
                        with the factors drawn by the caller, and the
                        pixel half of `flip_norm`; `jitter_normalise` the
                        unimodal `tensor_and_jitter` in the same call;
  apply_jet             `ops/colormap.py apply_jet_np`.

Each computes what the numpy version computes, bit for bit
(tests/test_torch_port_native_data.py). The library is compiled with g++
at first use into `multi_modal_tracking_torch/_build/` (`ops/_build.py
build_host`) and loaded with ctypes, which releases the interpreter lock
for the whole of each call, so the loader's threads run it in parallel.
There is no fallback: a failed build or load raises.
"""
from __future__ import annotations

import ctypes
import math
import os
import threading
from typing import Optional, Tuple

import numpy as np

from multi_modal_tracking_torch.ops import _build

SOURCE = os.path.join(_build.HOST_DIR, "data.cpp")

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    "mmt_sample_target": ([_P, _P, _I, _I, _I, _I, _I, _D, _D, _D, _D, _D, _I, _P, _P, _P,
                           ctypes.POINTER(_I)], _I),
    "mmt_jitter_jet_normalise": ([_P, _P, _I, _I, _D, _D, _I, _P, _P], None),
    "mmt_apply_jet": ([_P, _I, _I, _I, _P, _I], None),
}
_ERRORS = {1: "Too small bounding box.", 2: "The crop window lies outside the image.",
           3: "sample_target: bad arguments"}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The loaded library, built on first use. Raises RuntimeError with the
    compiler's output if g++ fails, OSError if the library does not load."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build.build_host(SOURCE))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _lib = lib
        return _lib


def _frame(img: np.ndarray, what: str) -> np.ndarray:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"{what}: expected a uint8 (H, W, C) array, got {img.dtype} {img.shape}")
    return img


def _sample(img, img_i, box, factor, out_sz, gray, flip):
    H, W, C = img.shape
    crop = np.empty((out_sz, out_sz, C), np.uint8)
    crop_i = None if img_i is None else np.empty_like(crop)
    mask = np.empty((out_sz, out_sz), np.uint8)
    valid = _I(0)
    x, y, w, h = (float(v) for v in box)
    rc = library().mmt_sample_target(
        img.ctypes.data, None if img_i is None else img_i.ctypes.data, H, W, C, int(gray),
        int(flip), x, y, w, h, float(factor), out_sz, crop.ctypes.data,
        None if crop_i is None else crop_i.ctypes.data, mask.ctypes.data, ctypes.byref(valid))
    if rc:
        raise ValueError(_ERRORS.get(rc, f"sample_target: error {rc}"))
    rf = out_sz / math.ceil(math.sqrt(w * h) * factor)
    return crop, crop_i, rf, mask.view(np.bool_), bool(valid.value)


def sample_target(img: np.ndarray, box, factor: float, out_sz: int, gray: bool = False,
                  flip: bool = False) -> Tuple[np.ndarray, float, np.ndarray, bool]:
    """`processing_utils.sample_target(img', box, factor, out_sz)` of the
    frame img' that the joint augmentation makes of `img` (cv2's RGB2GRAY
    on every channel if `gray`, then mirrored if `flip`), without making
    it. Returns (crop (out_sz, out_sz, C) uint8, resize factor, padding
    mask (out_sz, out_sz) bool, `_att_mask_valid` of the mask). Raises
    ValueError where sample_target does."""
    crop, _, rf, mask, valid = _sample(_frame(img, "sample_target"), None, box, factor, out_sz,
                                       gray, flip)
    return crop, rf, mask, valid


def sample_target_pair(img_v: np.ndarray, img_i: np.ndarray, box, factor: float, out_sz: int,
                       gray: bool = False, flip: bool = False
                       ) -> Tuple[np.ndarray, np.ndarray, float, bool]:
    """`sample_target` of an RGB frame and a TIR frame of the same shape at
    the same window in one call (`gray` reads the RGB frame only; their
    padding masks are the same). Returns (crop_v, crop_i, resize factor,
    `_att_mask_valid` of the mask)."""
    img_v, img_i = _frame(img_v, "sample_target_pair"), _frame(img_i, "sample_target_pair")
    if img_v.shape != img_i.shape:
        raise ValueError(f"sample_target_pair: frames of shapes {img_v.shape} and "
                         f"{img_i.shape}")
    crop_v, crop_i, rf, _, valid = _sample(img_v, img_i, box, factor, out_sz, gray, flip)
    return crop_v, crop_i, rf, valid


def jitter_jet_normalise(crop_v: np.ndarray, crop_i: np.ndarray, bf: float, tir_f: float,
                         flip: bool = False, out_v: Optional[np.ndarray] = None,
                         out_i: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """`tensor_and_jitter_rgbt` of two (h, w, 3) uint8 crops with the
    brightness factors `bf` (RGB) and `tir_f` (TIR) given, then, if
    `flip`, the pixel half of `flip_norm` on both. Writes float32 (h, w, 3)
    into `out_v` / `out_i` (C-contiguous float32, allocated if None) and
    returns them."""
    crop_v = np.ascontiguousarray(crop_v)
    crop_i = np.ascontiguousarray(crop_i)
    if (crop_v.dtype != np.uint8 or crop_v.ndim != 3 or crop_v.shape[2] != 3
            or crop_i.shape != crop_v.shape or crop_i.dtype != np.uint8):
        raise ValueError(f"jitter_jet_normalise: expected two uint8 (h, w, 3) crops, got "
                         f"{crop_v.dtype} {crop_v.shape} and {crop_i.dtype} {crop_i.shape}")
    outs = [_float_out(out, crop_v.shape, "jitter_jet_normalise") for out in (out_v, out_i)]
    h, w = crop_v.shape[:2]
    library().mmt_jitter_jet_normalise(crop_v.ctypes.data, crop_i.ctypes.data, h, w, float(bf),
                                       float(tir_f), int(flip), outs[0].ctypes.data,
                                       outs[1].ctypes.data)
    return outs[0], outs[1]


def jitter_normalise(crop: np.ndarray, bf: float, flip: bool = False,
                     out: Optional[np.ndarray] = None) -> np.ndarray:
    """`tensor_and_jitter` of one (h, w, 3) uint8 crop with the brightness
    factor `bf` given, then, if `flip`, the pixel half of `flip_norm`:
    float32 (h, w, 3) written into `out` (allocated if None)."""
    crop = np.ascontiguousarray(crop)
    if crop.dtype != np.uint8 or crop.ndim != 3 or crop.shape[2] != 3:
        raise ValueError(f"jitter_normalise: expected a uint8 (h, w, 3) crop, got "
                         f"{crop.dtype} {crop.shape}")
    out = _float_out(out, crop.shape, "jitter_normalise")
    library().mmt_jitter_jet_normalise(crop.ctypes.data, None, crop.shape[0], crop.shape[1],
                                       float(bf), 1.0, int(flip), out.ctypes.data, None)
    return out


def _float_out(out: Optional[np.ndarray], shape: tuple, what: str) -> np.ndarray:
    if out is None:
        return np.empty(shape, np.float32)
    if (out.dtype != np.float32 or out.shape != shape or not out.flags.c_contiguous
            or not out.flags.writeable):
        raise ValueError(f"{what}: out must be a writeable C-contiguous float32 {shape} array, "
                         f"got {out.dtype} {out.shape}")
    return out


def apply_jet(img: np.ndarray, out_bgr: bool = True) -> np.ndarray:
    """uint8 (H, W) or (H, W, 3) -> (H, W, 3) JET map as `apply_jet_np`
    (cv2's BGR order), or in RGB order with out_bgr=False."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or img.ndim == 3 and img.shape[2] == 3):
        raise ValueError(f"apply_jet: expected a uint8 (H, W) or (H, W, 3) array, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else 3
    dst = np.empty((h, w, 3), np.uint8)
    library().mmt_apply_jet(img.ctypes.data, h, w, c, dst.ctypes.data, int(out_bgr))
    return dst
