"""ctypes bindings of the port's host libraries, named after the JAX
package's `native` module: the training data pipeline's pixel work
(`csrc/host/data.cpp`) and the image decoder (`csrc/host/image.cpp`).

Pixel work (`library()`):

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
  apply_jet             `ops/colormap.py apply_jet_np`;
  sample_target_se      Alpha-Refine's anisotropic crop
                        (`models/alpha_refine.py sample_target_se`, cv2's
                        copyMakeBorder and INTER_LINEAR resize);
  resize_linear         cv2.resize INTER_LINEAR to any size.
The training functions compute what the numpy version computes, bit for bit
(tests/test_torch_port_native_data.py).

Image decoding (`image_library()`), the counterpart of the JAX package's
libjpeg decoder and of cv2.imread, bit for bit
(tests/test_torch_port_image_decode.py):
  decode_jpeg           a JPEG file or its bytes -> RGB uint8 (H, W, 3):
                        baseline, extended sequential and progressive
                        Huffman, 8-bit, greyscale or 3 components;
  decode_jpeg_batch     n files into one (n, cap_h, cap_w, 3) buffer on C++
                        threads;
  decode_png            a PNG -> RGB uint8 as cv2.imread(IMREAD_COLOR), or
                        a grey PNG unchanged (uint8 or uint16) as
                        cv2.imread(path, -1): colour types 0, 2, 3, 4, 6 at
                        8 bits and 0 at 16, not interlaced;
  imread / imdecode     either format, told by its signature -> RGB uint8;
  imread_unchanged      a grey PNG as stored (the depth maps).
A file the decoder does not take (arithmetic coding, lossless or
hierarchical JPEG, 12-bit samples, CMYK/YCCK, Adam7 interlace, other bit
depths, another format) or cannot read raises ValueError naming the file
and the reason; nothing falls back to another reader.

The libraries are compiled with g++ at first use into
`multi_modal_tracking_torch/_build/` (`ops/_build.py build_host`) and
loaded with ctypes, which releases the interpreter lock for the whole of
each call, so the loader's threads run them in parallel. There is no
fallback: a failed build or load raises.
"""
from __future__ import annotations

import ctypes
import math
import os
import struct
import threading
import zlib
from typing import List, Optional, Tuple, Union

import numpy as np

from multi_modal_tracking_torch.ops import _build

SOURCE = os.path.join(_build.HOST_DIR, "data.cpp")
IMAGE_SOURCE = os.path.join(_build.HOST_DIR, "image.cpp")

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    "mmt_sample_target": ([_P, _P, _I, _I, _I, _I, _I, _D, _D, _D, _D, _D, _I, _P, _P, _P,
                           ctypes.POINTER(_I)], _I),
    "mmt_jitter_jet_normalise": ([_P, _P, _I, _I, _D, _D, _I, _P, _P], None),
    "mmt_apply_jet": ([_P, _I, _I, _I, _P, _I], None),
    "mmt_sample_target_se": ([_P, _I, _I, _I, _I, _D, _D, _D, _D, _D, _I, _I, _P], _I),
    "mmt_resize_linear": ([_P, _I, _I, _I, _I, _I, _I, _P], _I),
}
#: the element types of sample_target_se and resize_linear, by their codes
_DTYPE_CODES = {np.dtype(np.uint8): 0, np.dtype(np.float32): 1, np.dtype(np.float64): 2}
_ERRORS = {1: "Too small bounding box.", 2: "The crop window lies outside the image.",
           3: "sample_target: bad arguments"}

_IMAGE_SIGNATURES = {
    "mmt_jpeg_size": ([_P, ctypes.c_size_t, ctypes.POINTER(_I), ctypes.POINTER(_I), _P, _I], _I),
    "mmt_decode_jpeg": ([_P, ctypes.c_size_t, _P, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I),
                         _P, _I], _I),
    "mmt_decode_jpeg_batch": ([ctypes.POINTER(ctypes.c_char_p), _I, _P, _I, _I, _P, _P, _P, _P,
                               _I, _I], None),
    "mmt_png_expand": ([_P, ctypes.c_size_t, _I, _I, _I, _I, _P, _I, _I, _P, _P, _I], _I),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_image_lib: Optional[ctypes.CDLL] = None


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


def image_library() -> ctypes.CDLL:
    """The loaded image decoder library, built on first use (raises as
    `library()` does)."""
    global _image_lib
    with _lock:
        if _image_lib is None:
            lib = ctypes.CDLL(_build.build_host(IMAGE_SOURCE))
            for name, (argtypes, restype) in _IMAGE_SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _image_lib = lib
        return _image_lib


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


# ------------------------------------------------------------------ images

_ERRLEN = 256
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
Source = Union[str, os.PathLike, bytes, bytearray, memoryview]


def _read(src: Source) -> Tuple[bytes, str]:
    """(the bytes, a name for messages) of a path or of bytes."""
    if isinstance(src, (bytes, bytearray, memoryview)):
        return bytes(src), "<bytes>"
    path = os.fspath(src)
    try:
        with open(path, "rb") as f:
            return f.read(), path
    except OSError as e:
        raise ValueError(f"{path}: cannot read the file: {e.strerror or e}") from e


def _jpeg(data: bytes, name: str) -> np.ndarray:
    lib = image_library()
    h, w = _I(0), _I(0)
    err = ctypes.create_string_buffer(_ERRLEN)
    if lib.mmt_jpeg_size(data, len(data), ctypes.byref(h), ctypes.byref(w), err, _ERRLEN):
        raise ValueError(f"{name}: JPEG not decoded: {err.value.decode()}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.mmt_decode_jpeg(data, len(data), out.ctypes.data, h.value, w.value, ctypes.byref(h),
                           ctypes.byref(w), err, _ERRLEN):
        raise ValueError(f"{name}: JPEG not decoded: {err.value.decode()}")
    return out


def decode_jpeg(src: Source) -> np.ndarray:
    """A JPEG file (a path) or its bytes -> RGB uint8 (H, W, 3), as the
    JAX package's `native.decode_jpeg` (libjpeg-turbo, JCS_RGB) gives it.
    Raises ValueError with the path and the reason."""
    data, name = _read(src)
    return _jpeg(data, name)


def decode_jpeg_batch(paths: List[str], cap_h: int, cap_w: int,
                      num_threads: int = 4) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode n JPEG files into one (n, cap_h, cap_w, 3) buffer on
    `num_threads` C++ threads. Returns (buffer, heights, widths); pixels
    outside each image's extent are 0. Raises ValueError naming the first
    file that failed and why."""
    lib = image_library()
    n = len(paths)
    buf = np.zeros((n, cap_h, cap_w, 3), np.uint8)
    hs, ws, rc = (np.zeros(n, np.int32) for _ in range(3))
    errs = ctypes.create_string_buffer(_ERRLEN * max(n, 1))
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.mmt_decode_jpeg_batch(arr, n, buf.ctypes.data, cap_h, cap_w, hs.ctypes.data,
                              ws.ctypes.data, rc.ctypes.data, errs, _ERRLEN, num_threads)
    for i in np.flatnonzero(rc):
        msg = errs.raw[i * _ERRLEN:(i + 1) * _ERRLEN].split(b"\0", 1)[0].decode()
        raise ValueError(f"{os.fspath(paths[i])}: JPEG not decoded: {msg}")
    return buf, hs, ws


def _png(data: bytes, name: str, unchanged: bool) -> np.ndarray:
    def bad(why):
        return ValueError(f"{name}: PNG not decoded: {why}")

    if not data.startswith(_PNG_SIGNATURE):
        raise bad("no PNG signature")
    pos, header, palette, idat = len(_PNG_SIGNATURE), None, b"", []
    while True:
        if pos + 8 > len(data):
            raise bad("truncated file (no IEND chunk)")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise bad(f"truncated {kind!r} chunk")
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise bad(f"CRC error in the {kind.decode('latin-1')} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise bad("no IHDR chunk")
    w, h, depth, ctype, compression, filtering, interlace = header
    if interlace:
        raise bad("Adam7 interlace is not decoded")
    if compression or filtering:
        raise bad("unknown compression or filter method")
    if depth != 8 and not (depth == 16 and ctype == 0):
        raise bad(f"colour type {ctype} at {depth} bits is not decoded (8-bit types 0, 2, 3, "
                  f"4, 6 and 16-bit grey are)")
    if ctype not in (0, 2, 3, 4, 6):
        raise bad(f"bad colour type {ctype}")
    if ctype == 3 and (not palette or len(palette) % 3):
        raise bad("a palette image without a valid PLTE chunk")
    if unchanged and ctype != 0:
        raise bad(f"unchanged reading takes grey images only (colour type {ctype})")
    try:
        raw = bytearray(zlib.decompress(b"".join(idat)))
    except zlib.error as e:
        raise bad(f"the image data does not inflate: {e}") from e
    shape = (h, w) if unchanged else (h, w, 3)
    out = np.empty(shape, np.uint16 if unchanged and depth == 16 else np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    pal = np.frombuffer(palette or b"\0", np.uint8)
    raw_buf = (ctypes.c_uint8 * len(raw)).from_buffer(raw) if raw else None
    if image_library().mmt_png_expand(raw_buf, len(raw), h, w, ctype, depth, pal.ctypes.data,
                                      len(palette) // 3, int(unchanged), out.ctypes.data, err,
                                      _ERRLEN):
        raise bad(err.value.decode())
    return out


def decode_png(src: Source, unchanged: bool = False) -> np.ndarray:
    """A PNG file (a path) or its bytes -> RGB uint8 (H, W, 3) as
    cv2.imread(IMREAD_COLOR) reads it (alpha dropped, 16-bit samples cut
    to their high byte), or with `unchanged` a grey PNG as stored, uint8 or
    uint16 (H, W), as cv2.imread(path, -1). Raises ValueError with the path
    and the reason."""
    data, name = _read(src)
    return _png(data, name, unchanged)


def imdecode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG or PNG bytes, told by their signature -> RGB uint8 (H, W, 3)."""
    if data[:2] == b"\xff\xd8":
        return _jpeg(data, name)
    if data.startswith(_PNG_SIGNATURE):
        return _png(data, name, False)
    raise ValueError(f"{name}: not a JPEG or PNG file (other formats are not decoded)")


def imread(path: Source) -> np.ndarray:
    """An image file -> RGB uint8 (H, W, 3), what the JAX package's
    readers give (its libjpeg decoder, or cv2.imread(IMREAD_COLOR) then
    BGR->RGB); JPEG or PNG, told by the signature."""
    data, name = _read(path)
    return imdecode(data, name)


def imread_unchanged(path: Source) -> np.ndarray:
    """A grey PNG as stored, uint8 or uint16 (H, W): cv2.imread(path, -1)
    of a depth map."""
    return decode_png(path, unchanged=True)


def _image(img: np.ndarray, what: str) -> Tuple[np.ndarray, int]:
    """`img` as a C-contiguous (H, W, C) array of a type the resize takes,
    and its type code."""
    img = np.ascontiguousarray(img)
    code = _DTYPE_CODES.get(img.dtype)
    if code is None or img.ndim not in (2, 3) or img.size == 0:
        raise ValueError(f"{what}: expected a non-empty uint8, float32 or float64 (H, W[, C]) "
                         f"array, got {img.dtype} {img.shape}")
    return (img[..., None] if img.ndim == 2 else img), code


def sample_target_se(img: np.ndarray, box, factor: float, out_sz: int,
                     pad_mode: str = "constant") -> Tuple[np.ndarray, float, float]:
    """Alpha-Refine's anisotropic crop (`models/alpha_refine.py
    sample_target_se`): the window ceil(factor w) x ceil(factor h) around
    `box` (x, y, w, h), bordered with zeros (pad_mode "constant") or the
    crop's edge pixels ("replicate"), resized to out_sz x out_sz as cv2's
    INTER_LINEAR. `img` (H, W[, C]) uint8, float32 or float64 gives a crop
    of its type, (out_sz, out_sz, C) (C = 1 for a 2-D image). Returns
    (crop, out_sz / hs, out_sz / ws). Raises ValueError for a window side
    below 1 and for a window that holds no pixel of the frame."""
    if pad_mode not in ("constant", "replicate"):
        raise ValueError(f"sample_target_se: pad_mode {pad_mode!r} (constant or replicate)")
    img, code = _image(img, "sample_target_se")
    H, W, C = img.shape
    x, y, w, h = (float(v) for v in box)
    out = np.empty((out_sz, out_sz, C), img.dtype)
    rc = library().mmt_sample_target_se(img.ctypes.data, code, H, W, C, x, y, w, h,
                                        float(factor), int(out_sz), int(pad_mode == "replicate"),
                                        out.ctypes.data)
    if rc:
        raise ValueError(_ERRORS.get(rc, f"sample_target_se: error {rc}"))
    return out, out_sz / math.ceil(factor * h), out_sz / math.ceil(factor * w)


def resize_linear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2.resize(img, (out_w, out_h)) with INTER_LINEAR: (H, W[, C])
    uint8, float32 or float64 -> (out_h, out_w[, C]) of the same type."""
    flat = np.ndim(img) == 2
    img, code = _image(img, "resize_linear")
    H, W, C = img.shape
    if out_h < 1 or out_w < 1:
        raise ValueError(f"resize_linear: output size {out_h} x {out_w}")
    out = np.empty((out_h, out_w, C), img.dtype)
    rc = library().mmt_resize_linear(img.ctypes.data, code, H, W, C, int(out_h), int(out_w),
                                     out.ctypes.data)
    if rc:
        raise ValueError(f"resize_linear: error {rc}")
    return out[..., 0] if flat else out
