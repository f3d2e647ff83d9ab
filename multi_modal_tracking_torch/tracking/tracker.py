"""Tracking loops of the RGB-T models (the inference hot path).

Per frame: a joint square crop of both modalities around the previous
state (crop_resize), JET on the TIR crop, ImageNet normalisation, the
network, the mean predicted box scaled by search_size / resize_factor,
mapped back to the frame and clipped with margin 10; every
`update_interval` frames the online template is re-cropped at the new
state. The box state stays on the device: a frame costs one upload of the
two uint8 frames, and `track` one 4-float download for its return value.

`RGBTCachedTracker` runs only the search tokens through the backbone
against a per-block template q/k/v cache (MixFormerRGBT.set_online /
forward_track), rebuilt at each template update.

For the eval runner: `track_chunk(fetch=False)` leaves a chunk's boxes on
the device; `track_chunk_roi` tracks windows cut around the box (ROI upload
mode, `roi_window` places them) and reports per frame whether the crops
equalled the full-frame ones; `snapshot` / `restore` take the state back
to before a chunk whose window the box left. The lockstep trackers of
several sequences are in tracking/batched.py.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from multi_modal_tracking_torch.ops.boxes import clip_box
from multi_modal_tracking_torch.ops.colormap import apply_jet
from multi_modal_tracking_torch.ops.crop import (crop_resize, crop_resize_batch,
                                                 crop_resize_window, normalize_imagenet)
from multi_modal_tracking_torch.utils.device import resolve_device, set_f32_precision


def _select_init_box(box):
    """RGB-T ground-truth pairs -> the RGB row (the bimodal trackers
    initialise from the RGB box); flat boxes pass through."""
    if isinstance(box, (list, tuple)) and isinstance(box[0], (list, tuple, np.ndarray)):
        return box[0]
    return box


def _stack(img_v: torch.Tensor, img_i: torch.Tensor) -> torch.Tensor:
    """Both modalities share the box, so they are cropped as one stacked
    float image (RGB channels, then the TIR one or three)."""
    ir = img_i[..., None] if img_i.dim() == img_v.dim() - 1 else img_i
    return torch.cat([img_v.float(), ir.float()], dim=-1)


def _post_crop(crop: torch.Tensor):
    """Each modality's own post-crop path on a stacked crop (..., S, S, C):
    normalisation of the RGB crop; JET on the rounded TIR crop, then
    normalisation."""
    cv, ci = crop[..., :3], crop[..., 3:]
    if ci.shape[-1] == 1:
        ci = ci[..., 0]
    ci = torch.clamp(torch.round(ci), 0, 255)
    return normalize_imagenet(cv), normalize_imagenet(apply_jet(ci))


def _prep_rgbt(img_v: torch.Tensor, img_i: torch.Tensor, box: torch.Tensor,
               factor: float, out_sz: int):
    """Joint bimodal crop of one frame pair. Returns (v, i, resize_factor)
    with v/i (1, out_sz, out_sz, 3) normalised. TIR frames may be (H, W) or
    replicated-gray (H, W, 3)."""
    crop, rf = crop_resize(_stack(img_v, img_i), box, factor, out_sz)
    cv, ci = _post_crop(crop)
    return cv[None], ci[None], rf


def _prep_rgbt_window(win_v: torch.Tensor, win_i: torch.Tensor, box: torch.Tensor,
                      offset_xy, frame_hw, factor: float, out_sz: int):
    """_prep_rgbt of a frame pair of which only a window at frame pixel
    offset_xy = (ox, oy) was uploaded; adds `ok`, True iff the crop is the
    full-frame one bit for bit (ops/crop.py crop_resize_window)."""
    crop, rf, ok = crop_resize_window(_stack(win_v, win_i), box, offset_xy, frame_hw,
                                      factor, out_sz)
    cv, ci = _post_crop(crop)
    return cv[None], ci[None], rf, ok


def _prep_rgbt_batch(imgs_v: torch.Tensor, imgs_i: torch.Tensor, boxes: torch.Tensor,
                     factor: float, out_sz: int):
    """_prep_rgbt of N frame pairs (N, H, W, 3) at N boxes (N, 4): (v, i,
    resize factors) with v/i (N, out_sz, out_sz, 3)."""
    crop, rf = crop_resize_batch(_stack(imgs_v, imgs_i), boxes, factor, out_sz)
    cv, ci = _post_crop(crop)
    return cv, ci, rf


def place_window(box, frame_hw, size_hw):
    """Centre an (Hw, Ww) window on `box` (host floats) and clip it inside
    the frame. Returns ((ox, oy), (Hw, Ww))."""
    H, W = int(frame_hw[0]), int(frame_hw[1])
    Hw, Ww = int(size_hw[0]), int(size_hw[1])
    x, y, w, h = [float(v) for v in box]
    cx, cy = x + 0.5 * w, y + 0.5 * h
    ox = int(np.clip(round(cx - Ww / 2), 0, W - Ww))
    oy = int(np.clip(round(cy - Hw / 2), 0, H - Hw))
    return (ox, oy), (Hw, Ww)


def roi_window(box, frame_hw, search_factor: float, margin: float = 1.5,
               align: int = 64, min_size: int = 192):
    """Host-side window placement for track_chunk_roi: side =
    search_factor * sqrt(w*h) * margin, rounded up to a multiple of `align`
    and at least `min_size`, centred on the box and clipped inside the
    frame. The margin covers the box moving and growing over a chunk; if the
    crop leaves the window anyway, the step's `ok` flag says so and the
    caller redoes the chunk on full frames. Returns ((ox, oy), (Hw, Ww)), or
    None when the window would cover the whole frame (no bytes saved)."""
    H, W = int(frame_hw[0]), int(frame_hw[1])
    x, y, w, h = [float(v) for v in box]
    side = search_factor * math.sqrt(max(w * h, 1.0)) * margin
    side = max(min_size, int(math.ceil(side / align) * align))
    Hw, Ww = min(side, H), min(side, W)
    if Hw >= H and Ww >= W:
        return None
    return place_window(box, frame_hw, (Hw, Ww))


def _map_box_back(pred_cxcywh: torch.Tensor, prev_state: torch.Tensor,
                  search_size: int, resize_factor: torch.Tensor) -> torch.Tensor:
    """Crop-relative (cx, cy, w, h) in pixels -> frame-coordinate xywh;
    boxes (..., 4), one resize factor per box."""
    px, py, pw, ph = prev_state.unbind(-1)
    cx_prev = px + 0.5 * pw
    cy_prev = py + 0.5 * ph
    half_side = 0.5 * search_size / resize_factor
    pcx, pcy, w, h = pred_cxcywh.unbind(-1)
    cx = pcx + (cx_prev - half_side)
    cy = pcy + (cy_prev - half_side)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, w, h], dim=-1)


class RGBTTracker:
    """Tracking loop of the bimodal (asymmetric-shared) models with the full
    forward every frame.

    model: a float32 MixFormerRGBT in eval mode on `device` (default the GPU;
    pass device="cpu" to run the plain versions of the kernels on the CPU).
    TF32 is turned off for matmuls and cuDNN (utils.device.set_f32_precision).
    """

    def __init__(self, model, template_factor: float = 2.0, template_size: int = 128,
                 search_factor: float = 5.0, search_size: int = 288,
                 update_interval: int = 200, ce_keep_rate: Optional[float] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        param = next(model.parameters())
        if param.device.type != self.device.type:
            raise ValueError(f"model is on {param.device}, tracker device is {self.device}")
        set_f32_precision(param.dtype)
        self.model = model
        self.template_factor = template_factor
        self.template_size = template_size
        self.search_factor = search_factor
        self.search_size = search_size
        self.update_interval = update_interval
        self.ce_keep_rate = ce_keep_rate

    def _upload(self, img) -> torch.Tensor:
        return torch.as_tensor(np.asarray(img)).to(self.device)

    def _crop(self, img_v, img_i, box, template: bool, offset=None):
        """(v, i, resize_factor, ok): ok is None for full frames, else the
        window crop's bit-equality flag."""
        factor, size = ((self.template_factor, self.template_size) if template
                        else (self.search_factor, self.search_size))
        if offset is None:
            return (*_prep_rgbt(img_v, img_i, box, factor, size), None)
        return _prep_rgbt_window(img_v, img_i, box, offset, self._shape, factor, size)

    # ------------------------------------------------------- model steps
    #: the attributes that hold the tracking state (snapshot / restore); a
    #: step rebinds them and never writes into their tensors
    _STATE = ("_state", "_frame_id", "_template", "_online")

    def _init_model(self, tv, ti):
        self._template = torch.cat([tv, ti], dim=0)
        self._online = self._template

    def _update_template(self, tv, ti):
        self._online = torch.cat([tv, ti], dim=0)

    def _predict(self, s_vi):
        return self.model(self._template, self._online, s_vi, self.ce_keep_rate,
                          use_ce_template_mask=False)

    # ------------------------------------------------------------ host API
    @torch.no_grad()
    def initialize(self, image, info: dict) -> None:
        """image: [img_v, img_i] uint8 HWC arrays; info['init_bbox'] xywh
        (or an RGB-T pair of boxes, of which the RGB one is used)."""
        img_v, img_i = (self._upload(x) for x in image)
        self._shape = tuple(img_v.shape[:2])
        self._state = torch.as_tensor(np.asarray(_select_init_box(info["init_bbox"]),
                                                 np.float32), device=self.device)
        self._frame_id = 0
        tv, ti, _, _ = self._crop(img_v, img_i, self._state, template=True)
        self._init_model(tv, ti)

    @torch.no_grad()
    def _step(self, img_v: torch.Tensor, img_i: torch.Tensor, offset=None):
        """One frame on the device, no host sync. With `offset` = (ox, oy)
        the images are windows of the frame at that pixel (ROI mode).
        Returns (state, ok): ok is None for full frames, else a bool tensor,
        True iff every crop of the step equals its full-frame crop."""
        H, W = self._shape
        self._frame_id += 1
        sv, si, rf, ok = self._crop(img_v, img_i, self._state, False, offset)
        # test-time CE pools over ALL template rows (use_ce_template_mask off)
        out = self._predict(torch.cat([sv, si], dim=0))
        pred = out["pred_boxes"].reshape(-1, 4).mean(dim=0) * (self.search_size / rf)
        self._state = clip_box(_map_box_back(pred, self._state, self.search_size, rf),
                               H, W, margin=10)
        if self._frame_id % self.update_interval == 0:
            tv, ti, _, ok_t = self._crop(img_v, img_i, self._state, True, offset)
            self._update_template(tv, ti)
            ok = ok if ok is None else ok & ok_t
        return self._state, ok

    def track(self, image, info: Optional[dict] = None) -> dict:
        """One frame: returns {"target_bbox": [x, y, w, h]}."""
        state, _ = self._step(*(self._upload(x) for x in image))
        return {"target_bbox": [float(b) for b in state.cpu()]}

    def track_chunk(self, frames_v: np.ndarray, frames_i: np.ndarray, fetch: bool = True):
        """Track (N, H, W, 3) uint8 frames (TIR (N, H, W) or (N, H, W, 3)):
        one upload per modality for the chunk, then the frames step on the
        device. Returns the (N, 4) boxes as numpy, or with fetch=False as the
        device tensor, without a host sync (the trajectory is that of
        per-frame track either way)."""
        fv, fi = self._upload(frames_v), self._upload(frames_i)
        boxes = torch.stack([self._step(fv[k], fi[k])[0] for k in range(fv.shape[0])])
        return boxes.cpu().numpy() if fetch else boxes

    def track_chunk_roi(self, win_v: np.ndarray, win_i: np.ndarray, offset_xy,
                        fetch: bool = True):
        """track_chunk over windows (N, Hw, Ww, 3) / (N, Hw, Ww[, 3]) cut from
        the frames at frame pixel offset_xy = (ox, oy), one window for the
        chunk: uploads only the windows. Returns (boxes, oks); oks[k] False
        means frame k's crops needed pixels outside the window, and the
        caller must `restore` the `snapshot` taken before the chunk and redo
        it on full frames. Where every ok is True the boxes are the
        full-frame ones bit for bit."""
        offset = (int(offset_xy[0]), int(offset_xy[1]))
        wv, wi = self._upload(win_v), self._upload(win_i)
        steps = [self._step(wv[k], wi[k], offset) for k in range(wv.shape[0])]
        boxes = torch.stack([s for s, _ in steps])
        oks = torch.stack([ok for _, ok in steps])
        return (boxes.cpu().numpy(), oks.cpu().numpy()) if fetch else (boxes, oks)

    def current_box(self) -> np.ndarray:
        """The current box, fetched to the host (4 floats)."""
        return self._state.cpu().numpy()

    def snapshot(self) -> dict:
        """The tracking state (box, frame id, templates or template cache)
        by reference; steps rebind it rather than write into it, so it stays
        valid for `restore`."""
        return {k: getattr(self, k) for k in self._STATE}

    def restore(self, snap: dict) -> None:
        for k, v in snap.items():
            setattr(self, k, v)


class RGBTCachedTracker(RGBTTracker):
    """RGBTTracker with the cached-template fast path: per frame only the
    search tokens run through the backbone (MixFormerRGBT.forward_track);
    the per-block template q/k/v come from a cache built at initialize and
    rebuilt at every template update."""

    _STATE = ("_state", "_frame_id", "_template", "_cache")

    def _init_model(self, tv, ti):
        self._template = torch.cat([tv, ti], dim=0)
        self._cache = self.model.set_online(self._template, self._template)

    def _update_template(self, tv, ti):
        self._cache = self.model.set_online(self._template, torch.cat([tv, ti], dim=0))

    def _predict(self, s_vi):
        return self.model.forward_track(self._cache, s_vi, self.ce_keep_rate,
                                        use_ce_template_mask=False)
