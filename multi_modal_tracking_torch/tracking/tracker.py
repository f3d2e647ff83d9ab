"""Tracking loops of the models (the inference hot path).

Per frame: a joint square crop of both modalities around the previous
state (crop_resize), JET on the TIR crop, ImageNet normalisation, the
network, the mean predicted box scaled by search_size / resize_factor,
mapped back to the frame and clipped with margin 10; every
`update_interval` frames the online template is re-cropped at the new
state. The box state stays on the device: a frame costs one upload of the
two uint8 frames, and `track` one 4-float download for its return value.
On CUDA each frame is one CUDA graph replay (tracking/graphs.py): the
frames go into the graph's static inputs, the state lives in static
buffers.

`RGBTCachedTracker` runs only the search tokens through the backbone
against a per-block template q/k/v cache (MixFormerRGBT.set_online /
forward_track), rebuilt at each template update.

`RGBTOnlineTracker` and `RGBTOnlineCachedTracker` are the score-gated
trackers of the online scripts (the SPM score branch): each frame also
gives a confidence, and the template is updated from the best-scoring
frame since the last update instead of the current one (their docstring).

`RGBTracker`, `RGBCachedTracker` and `OnlineTracker` are the unimodal
models' loops (`mixformer_vit*`): one modality in input mode RGB, TIR or
Prompt, the mode's transform on the whole frame before the crop, the same
state buffers and graphs; the online one keeps a ring of online templates.

For the eval runner: `track_chunk(fetch=False)` leaves a chunk's boxes on
the device; `track_chunk_roi` tracks windows cut around the box (ROI upload
mode, `roi_window` places them) and reports per frame whether the crops
equalled the full-frame ones; `snapshot` / `restore` take the state back
to before a chunk whose window the box left (the ROI path runs eager, on
the same state buffers). The lockstep trackers of
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
from multi_modal_tracking_torch.tracking.graphs import (StaticInputs, StepGraphs, bind_state,
                                                        clone_tree, copy_tree)
from multi_modal_tracking_torch.utils.device import resolve_device, set_precision


def _select_init_box(box, mode: str = "RGB"):
    """RGB-T ground-truth pairs -> the tracked mode's row: the TIR row in
    TIR mode, else the RGB one (the bimodal trackers and the RGB and Prompt
    modes); flat boxes pass through."""
    if isinstance(box, (list, tuple)) and isinstance(box[0], (list, tuple, np.ndarray)):
        return box[1] if mode == "TIR" else box[0]
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

    model: a MixFormerRGBT in eval mode on `device` (default the GPU; pass
    device="cpu" to run the plain versions of the kernels on the CPU), with
    float32 parameters or parameters cast to bfloat16
    (utils.checkpoint.cast_floating): the model computes in its parameters'
    dtype, while crops, boxes, the state and the map back to the frame stay
    float32. TF32 is turned off for matmuls and cuDNN
    (utils.device.set_precision).

    The step (`_advance`) reads the frames from static input tensors and
    the state from static buffers, and writes the new state into them. On
    CUDA with graphs=True (the default) it runs as CUDA graphs, one per
    frame shape and per template update or not (tracking/graphs.py);
    graphs=False, and any CPU tracker, runs the same step eager.
    """

    def __init__(self, model, template_factor: float = 2.0, template_size: int = 128,
                 search_factor: float = 5.0, search_size: int = 288,
                 update_interval: int = 200, ce_keep_rate: Optional[float] = None,
                 device="cuda", graphs: bool = True):
        self.device = resolve_device(device)
        param = next(model.parameters())
        if param.device.type != self.device.type:
            raise ValueError(f"model is on {param.device}, tracker device is {self.device}")
        set_precision(param.dtype)
        self.model = model
        self.template_factor = template_factor
        self.template_size = template_size
        self.search_factor = search_factor
        self.search_size = search_size
        self.update_interval = update_interval
        self.ce_keep_rate = ce_keep_rate
        self.graphs = StepGraphs(self.device) if graphs and self.device.type == "cuda" else None
        self._slots = {}            # state shapes -> state buffers
        self._inputs = {}           # frame shapes -> StaticInputs

    def _upload(self, img) -> torch.Tensor:
        return torch.as_tensor(np.asarray(img)).to(self.device)

    def _inputs_for(self, shape_v, shape_i, dtype=torch.uint8) -> StaticInputs:
        return self._static_inputs((shape_v, shape_i), (dtype, dtype))

    def _static_inputs(self, shapes, dtypes) -> StaticInputs:
        """The static input tensors of frames of these shapes and dtypes."""
        key = (tuple(tuple(x) for x in shapes), tuple(dtypes))
        if key not in self._inputs:
            self._inputs[key] = StaticInputs(*key, self.device)
        return self._inputs[key]

    def _crop(self, img_v, img_i, box, template: bool, offset=None):
        """(v, i, resize_factor, ok): ok is None for full frames, else the
        window crop's bit-equality flag."""
        factor, size = ((self.template_factor, self.template_size) if template
                        else (self.search_factor, self.search_size))
        if offset is None:
            return (*_prep_rgbt(img_v, img_i, box, factor, size), None)
        return _prep_rgbt_window(img_v, img_i, box, offset, self._shape, factor, size)

    # ------------------------------------------------------- model steps
    #: the state buffers (snapshot / restore; the frame id is a host int
    #: beside them); a step writes into them, never rebinds them
    _STATE = ("_state", "_template", "_online")

    def _init_model(self, tv, ti) -> dict:
        t = torch.cat([tv, ti], dim=0)
        return {"_template": t, "_online": t}

    def _update_template(self, tv, ti):
        self._online.copy_(torch.cat([tv, ti], dim=0))

    def _predict(self, s_vi):
        return self.model(self._template, self._online, s_vi, self.ce_keep_rate,
                          use_ce_template_mask=False)

    # ------------------------------------------------------------ host API
    @torch.no_grad()
    def initialize(self, image, info: dict) -> None:
        """image: [img_v, img_i] uint8 HWC arrays; info['init_bbox'] xywh
        (or an RGB-T pair of boxes, of which the RGB one is used). Runs
        eager (the JAX tracker's init is a program of its own too)."""
        img_v, img_i = (self._upload(x) for x in image)
        self._shape = tuple(img_v.shape[:2])
        state = torch.as_tensor(np.asarray(_select_init_box(info["init_bbox"]), np.float32),
                                device=self.device)
        self._frame_id = 0
        tv, ti, _, _ = self._crop(img_v, img_i, state, template=True)
        bufs = bind_state(self._slots, {"_state": state, **self._init_model(tv, ti)})
        for name in self._STATE:
            setattr(self, name, bufs[name])

    def _search(self, img_v: torch.Tensor, img_i: torch.Tensor, offset=None):
        """The search crop at the state, the network, and the new state
        (the mean predicted box mapped back to the frame and clipped)
        written into the state buffer. Returns (the network's outputs, the
        crop's ok)."""
        H, W = self._shape
        sv, si, rf, ok = self._crop(img_v, img_i, self._state, False, offset)
        # test-time CE pools over ALL template rows (use_ce_template_mask off)
        out = self._predict(torch.cat([sv, si], dim=0))
        pred = out["pred_boxes"].reshape(-1, 4).mean(dim=0) * (self.search_size / rf)
        self._state.copy_(clip_box(_map_box_back(pred, self._state, self.search_size, rf),
                                   H, W, margin=10))
        return out, ok

    @torch.no_grad()
    def _advance(self, img_v: torch.Tensor, img_i: torch.Tensor, update: bool, offset=None):
        """One frame on the device, no host sync, from the state buffers
        into them; `update` re-crops the template at the new state. With
        `offset` = (ox, oy) the images are windows of the frame at that
        pixel (ROI mode). Returns ok: None for full frames, else a bool
        tensor, True iff every crop of the step equals its full-frame
        crop."""
        _, ok = self._search(img_v, img_i, offset)
        if update:
            tv, ti, _, ok_t = self._crop(img_v, img_i, self._state, True, offset)
            self._update_template(tv, ti)
            ok = ok if ok is None else ok & ok_t
        return ok

    def _tick(self) -> bool:
        """Count a frame; True if its step updates the template."""
        self._frame_id += 1
        return self._frame_id % self.update_interval == 0

    def _step(self, inputs: StaticInputs) -> torch.Tensor:
        """One frame from the static inputs: a graph replay on CUDA (the
        host's frame id picks the graph), else the eager step. Returns the
        state buffer."""
        update = self._tick()
        step = lambda: self._advance(*inputs.tensors, update)   # noqa: E731
        if self.graphs is None:
            step()
        else:
            self.graphs.run((self._shape, inputs.key, update), step)
        return self._state

    def track(self, image, info: Optional[dict] = None) -> dict:
        """One frame: returns {"target_bbox": [x, y, w, h]}."""
        img_v, img_i = (np.asarray(x) for x in image)
        inputs = self._inputs_for(img_v.shape, img_i.shape)
        inputs.load_host((img_v, img_i))
        return {"target_bbox": [float(b) for b in self._step(inputs).cpu()]}

    def track_chunk(self, frames_v: np.ndarray, frames_i: np.ndarray, fetch: bool = True):
        """Track (N, H, W, 3) uint8 frames (TIR (N, H, W) or (N, H, W, 3)):
        one upload per modality for the chunk, then per frame a copy on the
        device into the static inputs and the step. Returns the (N, 4)
        boxes as numpy, or with fetch=False as the device tensor, without a
        host sync (the trajectory is that of per-frame track either way)."""
        fv, fi = self._upload(frames_v), self._upload(frames_i)
        inputs = self._inputs_for(fv.shape[1:], fi.shape[1:])
        boxes = torch.empty((fv.shape[0], 4), dtype=torch.float32, device=self.device)
        for k in range(fv.shape[0]):
            inputs.load_device((fv[k], fi[k]))
            boxes[k].copy_(self._step(inputs))
        return boxes.cpu().numpy() if fetch else boxes

    @torch.no_grad()
    def track_chunk_roi(self, win_v: np.ndarray, win_i: np.ndarray, offset_xy,
                        fetch: bool = True):
        """track_chunk over windows (N, Hw, Ww, 3) / (N, Hw, Ww[, 3]) cut from
        the frames at frame pixel offset_xy = (ox, oy), one window for the
        chunk: uploads only the windows, and runs eager. Returns (boxes,
        oks); oks[k] False means frame k's crops needed pixels outside the
        window, and the caller must `restore` the `snapshot` taken before
        the chunk and redo it on full frames. Where every ok is True the
        boxes are the full-frame ones bit for bit."""
        offset = (int(offset_xy[0]), int(offset_xy[1]))
        wv, wi = self._upload(win_v), self._upload(win_i)
        boxes = torch.empty((wv.shape[0], 4), dtype=torch.float32, device=self.device)
        oks = []
        for k in range(wv.shape[0]):
            oks.append(self._advance(wv[k], wi[k], self._tick(), offset))
            boxes[k].copy_(self._state)
        oks = torch.stack(oks)
        return (boxes.cpu().numpy(), oks.cpu().numpy()) if fetch else (boxes, oks)

    def current_box(self) -> np.ndarray:
        """The current box, fetched to the host (4 floats)."""
        return self._state.cpu().numpy()

    def snapshot(self) -> dict:
        """The tracking state (frame id, box, templates or template cache),
        copied: the steps write into the state buffers."""
        return {"_frame_id": self._frame_id,
                **{k: clone_tree(getattr(self, k)) for k in self._STATE}}

    def restore(self, snap: dict) -> None:
        """Put a snapshot's state back into the state buffers."""
        self._frame_id = snap["_frame_id"]
        for k in self._STATE:
            copy_tree(getattr(self, k), snap[k])


class RGBTCachedTracker(RGBTTracker):
    """RGBTTracker with the cached-template fast path: per frame only the
    search tokens run through the backbone (MixFormerRGBT.forward_track);
    the per-block template q/k/v come from a cache built at initialize and
    rebuilt at every template update."""

    _STATE = ("_state", "_template", "_cache")

    def _init_model(self, tv, ti) -> dict:
        t = torch.cat([tv, ti], dim=0)
        return {"_template": t, "_cache": self.model.set_online(t, t)}

    def _update_template(self, tv, ti):
        copy_tree(self._cache, self.model.set_online(self._template, torch.cat([tv, ti], dim=0)))

    def _predict(self, s_vi):
        return self.model.forward_track(self._cache, s_vi, self.ce_keep_rate,
                                        use_ce_template_mask=False)


class _ScoreGate:
    """The score-gated template candidate of the online trackers, on their
    state buffers `_score`, `_max_score`, `_candidate` and `_template`."""

    @torch.no_grad()
    def _gate(self, out: dict, crop: torch.Tensor, update: bool) -> None:
        """pred_score = sigmoid(logit); `crop`, the template crop at the
        new state, becomes the candidate when the score is above 0.5 and
        above the decayed best since the last commit; with `update` the
        candidate is committed (`_commit`) and the candidacy starts again
        from the base template at score -1."""
        score = torch.sigmoid(out["pred_scores"].reshape(-1)[0].float())
        self._score.copy_(score)
        max_score = self._max_score * self.max_score_decay
        better = (score > 0.5) & (score > max_score)
        candidate = torch.where(better, crop, self._candidate)
        if update:
            self._commit(candidate)
            self._candidate.copy_(self._template)
            self._max_score.fill_(-1.0)
        else:
            self._candidate.copy_(candidate)
            self._max_score.copy_(torch.where(better, score, max_score))


class RGBTOnlineTracker(_ScoreGate, RGBTTracker):
    """Score-gated online tracking of the models with the SPM score branch
    (asymmetric_shared_online): the JAX package's `RGBTOnlineTrackerJit`.

    Every frame runs the full forward with the score head; pred_score =
    sigmoid(logit). The template candidate is the template crop at the new
    state of the best frame since the last commit: a frame replaces it
    when its score is above 0.5 and above the candidate's score times
    max_score_decay (decayed once per frame). Every `update_interval`
    frames the candidate is committed as the online template, and the
    candidate goes back to the base template with score -1.

    The candidate crops and its score are state buffers, and the choice is
    a `torch.where` on the device: the host never reads a score. The
    host's frame counter picks the commit graph, as it picks the template
    update's graph of RGBTTracker. `track` returns {"target_bbox",
    "pred_score"}, `track_chunk` (boxes (N, 4), scores (N,)). The ROI
    upload mode is not ported for these trackers (ROADMAP.md queue 1
    item 1) and raises."""

    online = True
    _STATE = ("_state", "_template", "_online", "_candidate", "_max_score", "_score")

    def __init__(self, model, template_factor: float = 2.0, template_size: int = 128,
                 search_factor: float = 5.0, search_size: int = 288,
                 update_interval: int = 25, max_score_decay: float = 1.0,
                 ce_keep_rate: Optional[float] = None, device="cuda", graphs: bool = True):
        super().__init__(model, template_factor, template_size, search_factor, search_size,
                         update_interval, ce_keep_rate, device, graphs)
        self.max_score_decay = max_score_decay

    def _init_model(self, tv, ti) -> dict:
        t = torch.cat([tv, ti], dim=0)
        return {"_template": t, "_online": t, "_candidate": t,
                "_max_score": torch.full((), -1.0, device=t.device),
                "_score": torch.zeros((), device=t.device)}

    def _predict(self, s_vi):
        return self.model(self._template, self._online, s_vi, self.ce_keep_rate,
                          use_ce_template_mask=False, run_score_head=True)

    def _commit(self, candidate: torch.Tensor) -> None:
        """The candidate becomes the online template, which the full
        forward reads (the cached tracker also rebuilds its cache)."""
        self._online.copy_(candidate)

    @torch.no_grad()
    def _advance(self, img_v: torch.Tensor, img_i: torch.Tensor, update: bool, offset=None):
        """One frame on the device, from the state buffers into them;
        `update` commits the candidate (RGBTOnlineTrackerJit._step_w)."""
        if offset is not None:
            raise NotImplementedError(_ONLINE_ROI)
        out, _ = self._search(img_v, img_i)
        tv, ti, _, _ = self._crop(img_v, img_i, self._state, True)
        self._gate(out, torch.cat([tv, ti], dim=0), update)

    def track(self, image, info: Optional[dict] = None) -> dict:
        """One frame: returns {"target_bbox": [x, y, w, h], "pred_score": s}
        (one 5-float download)."""
        img_v, img_i = (np.asarray(x) for x in image)
        inputs = self._inputs_for(img_v.shape, img_i.shape)
        inputs.load_host((img_v, img_i))
        out = torch.cat([self._step(inputs), self._score[None]]).cpu()
        return {"target_bbox": [float(b) for b in out[:4]], "pred_score": float(out[4])}

    def track_chunk(self, frames_v: np.ndarray, frames_i: np.ndarray, fetch: bool = True):
        """RGBTTracker.track_chunk with the scores: returns (boxes (N, 4),
        scores (N,)), as numpy or, with fetch=False, as device tensors
        without a host sync."""
        fv, fi = self._upload(frames_v), self._upload(frames_i)
        inputs = self._inputs_for(fv.shape[1:], fi.shape[1:])
        n = fv.shape[0]
        boxes = torch.empty((n, 4), dtype=torch.float32, device=self.device)
        scores = torch.empty((n,), dtype=torch.float32, device=self.device)
        for k in range(n):
            inputs.load_device((fv[k], fi[k]))
            boxes[k].copy_(self._step(inputs))
            scores[k].copy_(self._score)
        return (boxes.cpu().numpy(), scores.cpu().numpy()) if fetch else (boxes, scores)

    def track_chunk_roi(self, win_v, win_i, offset_xy, fetch: bool = True):
        raise NotImplementedError(_ONLINE_ROI)


_ONLINE_ROI = ("ROI-window uploads (roi_margin > 0) are not ported for the online trackers; "
               "they wait on the keep-or-delete rule of the ROI path (ROADMAP.md queue 1 "
               "item 1)")


class RGBTOnlineCachedTracker(RGBTOnlineTracker):
    """RGBTOnlineTracker with the cached-template fast path (the JAX
    package's `RGBTOnlineCachedTrackerJit`): per frame only the search
    tokens run the backbone against the template cache, and the score
    branch reads the cache's template features; at a commit the cache is
    rebuilt from the base template and the committed online template."""

    _STATE = ("_state", "_template", "_online", "_cache", "_candidate", "_max_score",
              "_score")

    def _init_model(self, tv, ti) -> dict:
        out = super()._init_model(tv, ti)
        out["_cache"] = self.model.set_online(out["_template"], out["_online"])
        return out

    def _predict(self, s_vi):
        return self.model.forward_track(self._cache, s_vi, self.ce_keep_rate,
                                        use_ce_template_mask=False, run_score_head=True)

    def _commit(self, candidate: torch.Tensor) -> None:
        super()._commit(candidate)
        copy_tree(self._cache, self.model.set_online(self._template, self._online))


# ------------------------------------------------------------------ unimodal
#: the unimodal trackers' input modes
MODES = ("RGB", "TIR", "Prompt")


def mode_frames(image, mode: str) -> tuple:
    """The frames of `image` (an array, or an [RGB, TIR] pair) that `mode`
    reads: the RGB frame, the TIR frame, or both for Prompt. A bare array
    serves as either (the JAX package's trackers do the same)."""
    if isinstance(image, (list, tuple)):
        v, i = image[0], image[1] if len(image) > 1 else image[0]
    else:
        v = i = image
    return {"RGB": (v,), "TIR": (i,), "Prompt": (v, i)}[mode]


#: the Prompt mode's blend of JET(TIR) into RGB, fixed in the reference
PROMPT_LAMBDA = 0.05


def mode_frame(imgs, mode: str) -> torch.Tensor:
    """The image the unimodal trackers crop (the JAX package's `_frame`,
    tracking/tracker.py:1179-1185): the RGB frame; JET of the whole TIR
    frame; or the Prompt blend (1 - PROMPT_LAMBDA) RGB + PROMPT_LAMBDA
    JET(TIR) in float. The transform comes before the crop: on interpolated pixels
    the other order gives other values."""
    if mode == "RGB":
        return imgs[0]
    if mode == "TIR":
        return apply_jet(imgs[0])
    v, i = imgs
    return (1 - PROMPT_LAMBDA) * v.float() + PROMPT_LAMBDA * apply_jet(i)


class RGBTracker(RGBTTracker):
    """Tracking loop of the unimodal models (`mixformer_vit`; the JAX
    package's `RGBTrackerJit`) with the full forward every frame, in input
    mode RGB, TIR or Prompt (`mode_frame`, applied to the whole frame on
    the device before the crop). A frame is an array or an [RGB, TIR] pair;
    only the frames the mode reads are uploaded, and `initialize` takes the
    mode's init box (the TIR row of an RGB-T pair in TIR mode). Otherwise
    as RGBTTracker: static buffers, one CUDA graph per frame shape and per
    template update or not. The ROI upload mode is not ported for the
    unimodal trackers and raises (ROADMAP.md queue 1 item 1)."""

    online = False

    def __init__(self, model, template_factor: float = 2.0, template_size: int = 128,
                 search_factor: float = 4.5, search_size: int = 288,
                 update_interval: int = 200, mode: str = "RGB", device="cuda",
                 graphs: bool = True):
        if mode not in MODES:
            raise ValueError(f"unimodal tracker mode {mode!r} (one of {MODES})")
        super().__init__(model, template_factor, template_size, search_factor, search_size,
                         update_interval, None, device, graphs)
        self.mode = mode

    def _frame(self, imgs) -> torch.Tensor:
        return mode_frame(imgs, self.mode)

    def _cut(self, frame: torch.Tensor, box: torch.Tensor, template: bool):
        """(normalised crop (1, S, S, 3), resize factor) of `frame` at `box`."""
        factor, size = ((self.template_factor, self.template_size) if template
                        else (self.search_factor, self.search_size))
        crop, rf = crop_resize(frame, box, factor, size)
        return normalize_imagenet(crop)[None], rf

    def _uploads(self, frames) -> tuple:
        """The frames uploaded, each array once."""
        seen = {}
        return tuple(seen.setdefault(id(x), self._upload(x)) for x in frames)

    # ------------------------------------------------------- model steps
    def _init_model(self, t) -> dict:
        return {"_template": t, "_online": t}

    def _update_template(self, t) -> None:
        self._online.copy_(t)

    def _predict(self, s):
        return self.model(self._template, self._online, s)

    @torch.no_grad()
    def initialize(self, image, info: dict) -> None:
        imgs = self._uploads(mode_frames(image, self.mode))
        self._shape = tuple(imgs[0].shape[:2])
        box = _select_init_box(info["init_bbox"], self.mode)
        state = torch.as_tensor(np.asarray(box, np.float32), device=self.device)
        self._frame_id = 0
        t, _ = self._cut(self._frame(imgs), state, True)
        bufs = bind_state(self._slots, {"_state": state, **self._init_model(t)})
        for name in self._STATE:
            setattr(self, name, bufs[name])

    def _search(self, frame: torch.Tensor):
        H, W = self._shape
        s, rf = self._cut(frame, self._state, False)
        out = self._predict(s)
        pred = out["pred_boxes"].reshape(-1, 4).mean(dim=0) * (self.search_size / rf)
        self._state.copy_(clip_box(_map_box_back(pred, self._state, self.search_size, rf),
                                   H, W, margin=10))
        return out

    @torch.no_grad()
    def _advance(self, imgs, update: bool) -> None:
        """One frame from the mode's frames `imgs` (device tensors), from the
        state buffers into them; `update` re-crops the online template."""
        frame = self._frame(imgs)
        self._search(frame)
        if update:
            self._update_template(self._cut(frame, self._state, True)[0])

    def _step(self, inputs: StaticInputs) -> torch.Tensor:
        update = self._tick()
        step = lambda: self._advance(inputs.tensors, update)   # noqa: E731
        if self.graphs is None:
            step()
        else:
            self.graphs.run((self._shape, inputs.key, update), step)
        return self._state

    def track(self, image, info: Optional[dict] = None) -> dict:
        """One frame: {"target_bbox": [x, y, w, h]}, and "pred_score" from
        the online tracker (one download)."""
        frames = tuple(np.asarray(x) for x in mode_frames(image, self.mode))
        inputs = self._static_inputs([x.shape for x in frames],
                                     [torch.from_numpy(x).dtype for x in frames])
        inputs.load_host(frames)
        out = self._step(inputs)
        if self.online:
            out = torch.cat([out, self._score[None]])
        out = out.cpu()
        res = {"target_bbox": [float(b) for b in out[:4]]}
        if self.online:
            res["pred_score"] = float(out[4])
        return res

    def track_chunk(self, frames_v: np.ndarray, frames_i: Optional[np.ndarray] = None,
                    fetch: bool = True):
        """Track (N, H, W, 3) frames (`frames_i`: the TIR stack of an RGB-T
        sequence, or None): the mode's frames uploaded once for the chunk.
        Returns the (N, 4) boxes, and the online tracker (boxes, scores
        (N,)), as numpy or with fetch=False as device tensors."""
        imgs = self._uploads(mode_frames(frames_v if frames_i is None else [frames_v, frames_i],
                                         self.mode))
        inputs = self._static_inputs([x.shape[1:] for x in imgs], [x.dtype for x in imgs])
        n = imgs[0].shape[0]
        boxes = torch.empty((n, 4), dtype=torch.float32, device=self.device)
        scores = torch.empty((n,), dtype=torch.float32, device=self.device)
        for k in range(n):
            inputs.load_device([x[k] for x in imgs])
            boxes[k].copy_(self._step(inputs))
            if self.online:
                scores[k].copy_(self._score)
        outs = (boxes, scores) if self.online else (boxes,)
        if fetch:
            outs = tuple(o.cpu().numpy() for o in outs)
        return outs if self.online else outs[0]

    def track_chunk_roi(self, win_v, win_i, offset_xy, fetch: bool = True):
        raise NotImplementedError(_UNIMODAL_ROI)


_UNIMODAL_ROI = ("ROI-window uploads (roi_margin > 0) are not ported for the unimodal "
                 "trackers; they wait on the keep-or-delete rule of the ROI path (ROADMAP.md "
                 "queue 1 item 1)")


class RGBCachedTracker(RGBTracker):
    """RGBTracker over the model's template cache (the JAX package's
    `RGBCachedTrackerJit`): per frame only the search tokens run the
    backbone (`forward_test`); `set_online(template, template)` at
    initialize and `set_online(template, new online crop)` at each update."""

    _STATE = ("_state", "_template", "_cache")

    def _init_model(self, t) -> dict:
        return {"_template": t, "_cache": self.model.set_online(t, t)}

    def _update_template(self, t) -> None:
        copy_tree(self._cache, self.model.set_online(self._template, t))

    def _predict(self, s):
        return self.model.forward_test(s, self._cache)


class OnlineTracker(_ScoreGate, RGBTracker):
    """Score-gated online tracking of the unimodal models with the SPM score
    branch (`mixformer_vit_online`; the JAX package's `OnlineTrackerJit`)
    over the template cache, with a ring of `online_size` online templates.

    Each frame: the search tokens against the cache, pred_score =
    sigmoid(logit); the template crop at the new state becomes the
    candidate when its score is above 0.5 and above the best score since
    the last commit times max_score_decay. Every `update_interval` frames
    the candidate is committed: appended while the ring has fewer than
    `online_size` live slots, then written over the slot at `forget_id`
    (which moves on); the candidate goes back to the base template with
    score -1, and the cache is rebuilt over the template and the ring, the
    unfilled slots hidden by the slot mask (`n_filled`), as the reference's
    growing buffer holds only the committed ones. The ring, `n_filled`,
    `forget_id`, the candidate and the scores are state buffers on the
    device; the host's frame counter picks the commit graph."""

    online = True
    _STATE = ("_state", "_template", "_ring", "_cache", "_candidate", "_max_score", "_score",
              "_n_filled", "_forget_id")

    def __init__(self, model, template_factor: float = 2.0, template_size: int = 128,
                 search_factor: float = 4.5, search_size: int = 288,
                 update_interval: int = 200, online_size: int = 3,
                 max_score_decay: float = 1.0, mode: str = "RGB", device="cuda",
                 graphs: bool = True):
        super().__init__(model, template_factor, template_size, search_factor, search_size,
                         update_interval, mode, device, graphs)
        self.online_size, self.max_score_decay = online_size, max_score_decay

    def _slot_mask(self, n_filled: torch.Tensor) -> torch.Tensor:
        """(..., online_size) 0/1: the live slots of rings with `n_filled` (...)."""
        slots = torch.arange(self.online_size, device=n_filled.device)
        return (slots < n_filled[..., None]).float()

    def _init_model(self, t) -> dict:
        n_filled = torch.ones((), dtype=torch.long, device=t.device)
        ring = torch.cat([t] * self.online_size)
        return {"_template": t, "_ring": ring, "_candidate": t,
                "_cache": self.model.set_online(t, ring, self._slot_mask(n_filled)),
                "_max_score": torch.full((), -1.0, device=t.device),
                "_score": torch.zeros((), device=t.device), "_n_filled": n_filled,
                "_forget_id": torch.zeros((), dtype=torch.long, device=t.device)}

    def _predict(self, s):
        return self.model.forward_test(s, self._cache, run_score_head=True)

    @torch.no_grad()
    def _advance(self, imgs, update: bool) -> None:
        """One frame (OnlineTrackerJit._step_search_w and the cache refresh
        of its _step); `update` commits the candidate."""
        frame = self._frame(imgs)
        out = self._search(frame)
        self._gate(out, self._cut(frame, self._state, True)[0], update)

    def _commit(self, candidate: torch.Tensor) -> None:
        """The ring commit (tracking/tracker.py:1001-1018 there) and the
        cache rebuilt over the committed ring."""
        full = self._n_filled >= self.online_size
        self._ring.index_copy_(0, torch.where(full, self._forget_id, self._n_filled).reshape(1),
                               candidate)
        self._forget_id.copy_(torch.where(full, (self._forget_id + 1) % self.online_size,
                                          self._forget_id))
        self._n_filled.copy_(torch.clamp(self._n_filled + 1, max=self.online_size))
        copy_tree(self._cache, self.model.set_online(self._template, self._ring,
                                                     self._slot_mask(self._n_filled)))
