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
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from multi_modal_tracking_torch.ops.boxes import clip_box
from multi_modal_tracking_torch.ops.colormap import apply_jet
from multi_modal_tracking_torch.ops.crop import crop_resize, normalize_imagenet
from multi_modal_tracking_torch.utils.device import resolve_device, set_f32_precision


def _select_init_box(box):
    """RGB-T ground-truth pairs -> the RGB row (the bimodal trackers
    initialise from the RGB box); flat boxes pass through."""
    if isinstance(box, (list, tuple)) and isinstance(box[0], (list, tuple, np.ndarray)):
        return box[0]
    return box


def _prep_rgbt(img_v: torch.Tensor, img_i: torch.Tensor, box: torch.Tensor,
               factor: float, out_sz: int):
    """Joint bimodal crop: both modalities share the box, so they are
    cropped as one stacked image; then each modality's own post-crop path
    (JET on the rounded TIR crop). Returns (v, i, resize_factor) with v/i
    (1, out_sz, out_sz, 3) normalised. TIR frames may be (H, W) or
    replicated-gray (H, W, 3)."""
    ir = img_i[..., None] if img_i.dim() == 2 else img_i
    stacked = torch.cat([img_v.float(), ir.float()], dim=-1)
    crop, rf = crop_resize(stacked, box, factor, out_sz)
    cv, ci = crop[..., :3], crop[..., 3:]
    if ci.shape[-1] == 1:
        ci = ci[..., 0]
    ci = torch.clamp(torch.round(ci), 0, 255)
    return normalize_imagenet(cv)[None], normalize_imagenet(apply_jet(ci))[None], rf


def _map_box_back(pred_cxcywh: torch.Tensor, prev_state: torch.Tensor,
                  search_size: int, resize_factor: torch.Tensor) -> torch.Tensor:
    """Crop-relative (cx, cy, w, h) in pixels -> frame-coordinate xywh."""
    cx_prev = prev_state[0] + 0.5 * prev_state[2]
    cy_prev = prev_state[1] + 0.5 * prev_state[3]
    half_side = 0.5 * search_size / resize_factor
    cx = pred_cxcywh[0] + (cx_prev - half_side)
    cy = pred_cxcywh[1] + (cy_prev - half_side)
    w, h = pred_cxcywh[2], pred_cxcywh[3]
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, w, h])


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

    def _crop(self, img_v, img_i, box, template: bool):
        if template:
            return _prep_rgbt(img_v, img_i, box, self.template_factor, self.template_size)
        return _prep_rgbt(img_v, img_i, box, self.search_factor, self.search_size)

    # ------------------------------------------------------- model steps
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
        tv, ti, _ = self._crop(img_v, img_i, self._state, template=True)
        self._init_model(tv, ti)

    @torch.no_grad()
    def _step(self, img_v: torch.Tensor, img_i: torch.Tensor) -> torch.Tensor:
        H, W = self._shape
        self._frame_id += 1
        sv, si, rf = self._crop(img_v, img_i, self._state, template=False)
        # test-time CE pools over ALL template rows (use_ce_template_mask off)
        out = self._predict(torch.cat([sv, si], dim=0))
        pred = out["pred_boxes"].reshape(-1, 4).mean(dim=0) * (self.search_size / rf)
        self._state = clip_box(_map_box_back(pred, self._state, self.search_size, rf),
                               H, W, margin=10)
        if self._frame_id % self.update_interval == 0:
            tv, ti, _ = self._crop(img_v, img_i, self._state, template=True)
            self._update_template(tv, ti)
        return self._state

    def track(self, image, info: Optional[dict] = None) -> dict:
        """One frame: returns {"target_bbox": [x, y, w, h]}."""
        state = self._step(*(self._upload(x) for x in image))
        return {"target_bbox": [float(b) for b in state.cpu()]}

    def track_chunk(self, frames_v: np.ndarray, frames_i: np.ndarray) -> np.ndarray:
        """Track (N, H, W, 3) uint8 frames; the boxes are fetched once at the
        end as an (N, 4) array (trajectory identical to per-frame track)."""
        boxes = [self._step(self._upload(fv), self._upload(fi))
                 for fv, fi in zip(frames_v, frames_i)]
        return torch.stack(boxes).cpu().numpy()

    def current_box(self) -> np.ndarray:
        return self._state.cpu().numpy()


class RGBTCachedTracker(RGBTTracker):
    """RGBTTracker with the cached-template fast path: per frame only the
    search tokens run through the backbone (MixFormerRGBT.forward_track);
    the per-block template q/k/v come from a cache built at initialize and
    rebuilt at every template update."""

    def _init_model(self, tv, ti):
        self._template = torch.cat([tv, ti], dim=0)
        self._cache = self.model.set_online(self._template, self._template)

    def _update_template(self, tv, ti):
        self._cache = self.model.set_online(self._template, torch.cat([tv, ti], dim=0))

    def _predict(self, s_vi):
        return self.model.forward_track(self._cache, s_vi, self.ce_keep_rate,
                                        use_ce_template_mask=False)
