"""Visualisation: result-vs-ground-truth videos, search-feature and
attention panels, the port's counterpart of the JAX package's
`eval/visualize.py`.

The JAX module draws with cv2; the card's machine has none, so every pixel
here comes from numpy or the port's host library, byte for byte what the
JAX functions give:
  * rectangles: cv2.rectangle with LINE_8 at integer corners (`draw_rect`):
    thickness 1 is the border, thickness 2 a 3-pixel band centred on it
    with one-pixel caps past each end of each side;
  * label text: cv2.putText(FONT_HERSHEY_SIMPLEX, scale 0.5, thickness 1)
    from a glyph table made with cv2 (`_glyphs.py`, regenerated by `python
    tests/test_torch_port_visualize.py --write-glyphs`): each character's
    coverage at an integer pen position, blended into the image as
    round((colour * a + pixel * (255 - a)) / 255), the pen advancing by the
    character's whole-pixel advance;
  * JET: `ops/colormap.py apply_jet_np` (cv2's table, BGR);
  * INTER_NEAREST resize: a numpy index, floor(i * src / dst);
  * INTER_LINEAR resize: the host library's `native.resize_linear`;
  * addWeighted: cv2's float32 fused multiply-adds on uint8, a * alpha +
    (b * beta + gamma) rounded once, then half to even and saturated.
The panels are BGR, as cv2 made them in the JAX package. The dumps write
PNG (`encode_png`: zlib and struct), where the JAX package writes JPEG
through cv2.imwrite; the PNG holds the panel's pixels exactly (RGB in the
file, what cv2.imwrite of the BGR array stores). Video containers
(`render_result_video`, `write_video`) go through cv2.VideoWriter where cv2
imports and raise ImportError naming cv2 where it does not; no module of
the port imports cv2 when it is imported.
"""
from __future__ import annotations

import os
import shutil
import struct
import subprocess
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from multi_modal_tracking_torch import native
from multi_modal_tracking_torch.ops.colormap import apply_jet_np

_COLORS = [(0, 255, 0), (255, 0, 0), (0, 128, 255), (255, 0, 255),
           (0, 255, 255), (255, 255, 0)]


def import_cv2(what: str):
    """cv2, for a video container; ImportError naming cv2 without it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{what} reads or writes video containers through cv2, which is "
                          f"not installed") from e
    return cv2


# ------------------------------------------------------------------ drawing
def _fill(img: np.ndarray, y0: int, y1: int, x0: int, x1: int, color) -> None:
    """Set rows y0..y1 and columns x0..x1 (inclusive), clipped to img."""
    H, W = img.shape[:2]
    y0, x0 = max(y0, 0), max(x0, 0)
    y1, x1 = min(y1, H - 1), min(x1, W - 1)
    if y0 <= y1 and x0 <= x1:
        img[y0:y1 + 1, x0:x1 + 1] = color


def draw_rect(img: np.ndarray, p1, p2, color, thickness: int = 1) -> np.ndarray:
    """cv2.rectangle(img, p1, p2, color, thickness) with LINE_8, in place,
    for integer corners and thickness 1 or 2."""
    (xa, ya), (xb, yb) = p1, p2
    x0, x1, y0, y1 = min(xa, xb), max(xa, xb), min(ya, yb), max(ya, yb)
    if thickness == 1:
        for y in (y0, y1):
            _fill(img, y, y, x0, x1, color)
        for x in (x0, x1):
            _fill(img, y0, y1, x, x, color)
    elif thickness == 2:
        # each side a 3-pixel band over its length, and a one-pixel cap (the
        # round end of radius 1) past each end on its centre line
        for y in (y0, y1):
            _fill(img, y - 1, y + 1, x0, x1, color)
            _fill(img, y, y, x0 - 1, x1 + 1, color)
        for x in (x0, x1):
            _fill(img, y0, y1, x - 1, x + 1, color)
            _fill(img, y0 - 1, y1 + 1, x, x, color)
    else:
        raise ValueError(f"draw_rect: thickness {thickness} (1 or 2)")
    return img


def _glyph(code: int):
    from multi_modal_tracking_torch.eval._glyphs import GLYPHS
    adv, dy, dx, h, w, alpha = GLYPHS.get(code, GLYPHS[ord("?")])
    a = np.frombuffer(bytes.fromhex(alpha), np.uint8).reshape(h, w) if h else None
    return adv, dy, dx, a


def put_text(img: np.ndarray, text: str, org, color) -> np.ndarray:
    """cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, 0.5, color, 1) on a
    uint8 (H, W, 3) image, in place (module docstring)."""
    x, y = org
    H, W = img.shape[:2]
    col = np.asarray(color, np.int64)
    for ch in text:
        adv, dy, dx, a = _glyph(ord(ch))
        if a is not None:
            top, left = y + dy, x + dx
            r0, c0 = max(top, 0), max(left, 0)
            r1, c1 = min(top + a.shape[0], H), min(left + a.shape[1], W)
            if r0 < r1 and c0 < c1:
                al = a[r0 - top:r1 - top, c0 - left:c1 - left].astype(np.int64)[..., None]
                px = img[r0:r1, c0:c1].astype(np.int64)
                img[r0:r1, c0:c1] = ((col * al + px * (255 - al) + 127) // 255).astype(np.uint8)
        x += adv
    return img


def draw_boxes(frame: np.ndarray, boxes: Dict[str, Sequence[float]],
               thickness: int = 2) -> np.ndarray:
    """Draw named xywh boxes (GT first = green) onto an RGB frame copy,
    each with its name above it."""
    img = np.array(frame, dtype=np.uint8, copy=True)
    for i, (name, b) in enumerate(boxes.items()):
        if b is None or not np.all(np.isfinite(b)):
            continue
        x, y, w, h = [int(round(float(v))) for v in b]
        color = _COLORS[i % len(_COLORS)]
        draw_rect(img, (x, y), (x + w, y + h), color, thickness)
        put_text(img, name, (x, max(12, y - 4)), color)
    return img


# --------------------------------------------------------------- resampling
def resize_nearest(img: np.ndarray, size_hw) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_NEAREST): source index
    floor(i * src / dst), clamped."""
    H, W = img.shape[:2]
    h, w = size_hw
    ry = np.minimum(np.floor(np.arange(h) * (H / h)).astype(np.int64), H - 1)
    rx = np.minimum(np.floor(np.arange(w) * (W / w)).astype(np.int64), W - 1)
    return img[ry][:, rx]


def add_weighted(a: np.ndarray, alpha: float, b: np.ndarray, beta: float,
                 gamma: float = 0.0) -> np.ndarray:
    """cv2.addWeighted on uint8: t = fma(b, beta, gamma), then fma(a, alpha,
    t) in float32 (each product exact in float64, so one rounding to
    float32 emulates the fused operation), rounded half to even,
    saturated."""
    f, d = np.float32, np.float64
    t = (b.astype(d) * d(f(beta)) + d(f(gamma))).astype(f)
    s = (a.astype(d) * d(f(alpha)) + t.astype(d)).astype(f)
    return np.clip(np.rint(s), 0, 255).astype(np.uint8)


# ------------------------------------------------------------------ panels
def _unit(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float32)
    return (m - m.min()) / max(float(m.max() - m.min()), 1e-6)


def feature_panel(feat: np.ndarray, size: int = 144) -> np.ndarray:
    """(h, w, C) feature map -> JET-coloured mean-activation panel, BGR
    (size, size, 3) uint8."""
    m = _unit(np.asarray(feat, np.float32).mean(axis=-1))
    return resize_nearest(apply_jet_np((m * 255).astype(np.uint8)), (size, size))


def attention_panel(score_grid: np.ndarray, frame_crop: Optional[np.ndarray] = None,
                    size: int = 144, alpha: float = 0.5) -> np.ndarray:
    """(gs, gs) attention score grid -> JET heatmap panel (BGR), optionally
    blended over the search crop (bilinear to the panel)."""
    m = _unit(score_grid)
    heat = resize_nearest(apply_jet_np((m * 255).astype(np.uint8)), (size, size))
    if frame_crop is not None:
        base = native.resize_linear(np.ascontiguousarray(frame_crop, np.uint8), size, size)
        heat = add_weighted(base, 1 - alpha, heat, alpha, 0)
    return heat


def encode_png(bgr: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of a BGR uint8 (H, W, 3) array (what cv2.imwrite
    stores), or a grey one of an (H, W) array: unfiltered scanlines,
    zlib's deflate, the chunks' CRCs."""
    arr = np.asarray(bgr, np.uint8)
    colour = 2 if arr.ndim == 3 else 0
    rows = arr[..., ::-1] if colour == 2 else arr
    h, w = arr.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          np.ascontiguousarray(rows).reshape(h, -1)], axis=1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path: str, bgr: np.ndarray) -> str:
    with open(path, "wb") as f:
        f.write(encode_png(bgr))
    return path


# ------------------------------------------------------------------ videos
def write_video(path: str, frames, fps: int = 30, reencode: bool = False) -> str:
    """RGB uint8 frames -> an mp4v mp4 through cv2.VideoWriter (raises
    ImportError without cv2). `reencode` writes a temporary file and
    re-encodes it to h264 with ffmpeg where ffmpeg is on the PATH (the
    JAX runner's `_write_vis_video`)."""
    frames = list(frames)
    cv2 = import_cv2("write_video")
    target = os.path.join(os.path.dirname(path), "temp_" + os.path.basename(path)) \
        if reencode else path
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(target, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        vw.write(np.ascontiguousarray(f[..., ::-1]))
    vw.release()
    if reencode:
        if shutil.which("ffmpeg"):
            subprocess.run(["ffmpeg", "-nostdin", "-y", "-loglevel", "quiet", "-i", target,
                            "-vcodec", "h264", path], check=True)
            os.remove(target)
        else:
            os.replace(target, path)
    return path


def render_result_video(seq, results: Dict[str, np.ndarray], out_path: str,
                        fps: int = 30, modality: int = 0) -> str:
    """Overlay each tracker's saved boxes and the ground truth on the
    sequence's frames and write an mp4 (gen_video.py semantics; cv2 for the
    container). seq: an eval Sequence / RGBTSequence; results: name ->
    (N, 4) xywh."""
    from multi_modal_tracking_torch.eval.running import _load_frame
    import_cv2("render_result_video")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    gt = np.asarray(seq.ground_truth_rect)
    if gt.ndim == 3:          # an RGB-T pair of boxes: the chosen modality's
        gt = gt[:, modality]

    def frames():
        for k in range(len(seq.frames)):
            fr = _load_frame(seq, k)
            frame = fr[modality] if isinstance(fr, list) else fr
            boxes = {"GT": gt[k] if k < len(gt) else None}
            for name, arr in results.items():
                boxes[name] = arr[k] if k < len(arr) else None
            yield draw_boxes(frame, boxes)
    return write_video(out_path, frames(), fps)


# ----------------------------------------------------- the models' outputs
def _search_crop(tr, image) -> torch.Tensor:
    """The tracker's search crops of both modalities at its state, stacked
    (2, S, S, 3)."""
    img_v, img_i = (tr._upload(x) for x in image)
    sv, si, _, _ = tr._crop(img_v, img_i, tr._state, False)
    return torch.cat([sv, si], dim=0)


def attention_maps(tracker, image) -> Dict[int, np.ndarray]:
    """The flagship backbone's per-CE-block t->s attention maps (B, 2, gs,
    gs) float32 for the search crop of `image` at the tracker's state: the
    template, the online template (the template for cached trackers, which
    keep none) and `return_attn_maps` with the template mask on."""
    t = tracker._template
    ot = getattr(tracker, "_online", t)
    with torch.no_grad():
        out = tracker.model.backbone(t, ot, _search_crop(tracker, image), tracker.ce_keep_rate,
                                     True, return_attn_maps=True)
    return {bi: m.float().cpu().numpy() for bi, m in out[-1].items()}


def dump_attention_maps(tracker, image, out_dir: str, frame_id: int = 0,
                        size: int = 144) -> List[str]:
    """Run the flagship CE model with return_attn_maps on the tracker's
    search crop and dump, per CE block, the template->search attention
    panels of both modalities side by side as
    attn_block<bi>_<frame>.png."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for bi, maps in sorted(attention_maps(tracker, image).items()):
        row = np.concatenate([attention_panel(maps[0, mod], size=size) for mod in (0, 1)],
                             axis=1)
        paths.append(write_png(os.path.join(out_dir, f"attn_block{bi:02d}_{frame_id:04d}.png"),
                               row))
    return paths


def search_features(tr, image, info: dict) -> Dict[str, np.ndarray]:
    """Initialise `tr` on (image, info) and run its model with
    return_features on its search crop there: {"search_v", "search_i",
    "search_fused"} (gs, gs, C) float32 maps."""
    tr.initialize(image, info)
    t = tr._template
    with torch.no_grad():
        out = tr.model(t, t, _search_crop(tr, image), None, return_features=True)
    return {k: out[k][0].float().cpu().numpy() for k in ("search_v", "search_i", "search_fused")}


def dump_search_features(trackers: Dict[str, object], image, info: dict,
                         out_dir: str, frame_id: int = 0) -> List[str]:
    """Run several RGB-T models on the same frame and dump per model the
    RGB, TIR and fused search-feature panels side by side as
    <name>_<frame>.png (Multi_Trackers semantics). trackers: name -> a
    tracker whose model takes return_features (the flagship and the
    RGB-T ViT families)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name, tr in trackers.items():
        feats = search_features(tr, image, info)
        panel = np.concatenate([feature_panel(feats[k])
                                for k in ("search_v", "search_i", "search_fused")], axis=1)
        paths.append(write_png(os.path.join(out_dir, f"{name}_{frame_id:04d}.png"), panel))
    return paths
