"""Lockstep tracking of N sequences on one card (the port's counterpart of
the JAX package's `tracking/batched.py`).

Single-stream tracking leaves the card idle most of each frame: the host
launches the same ~850 small operations whatever the batch. Here the N
sequences of one frame size step together as one batch through the model:
each frame, the N frame pairs are cropped at the N boxes in one batched
product pair (`crop_resize_batch`), and the search crops go through
`forward` / `forward_track` as one (2N, ...) stack, all RGB rows first, then
all TIR rows, as MixFormerRGBT takes its modalities. Each sequence's box is
the mean over its own rows of `pred_boxes`. State never mixes across
sequences, so each trajectory is that of the single-sequence tracker, up to
the summation order of batched products.

A per-(frame, sequence) `valid` mask freezes a finished sequence: its box,
frame count, online template and template cache keep their values. The
mask must be suffix-style per sequence (True... then False...): the
template update runs on the scalar cadence max(frame id) % interval == 0
for the live sequences, which is each live sequence's own cadence only
because lockstep sequences stop only at their end.

`run_sequences_batched` evaluates a group of same-size sequences this way
and writes the result files of eval/running.py.
"""
from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import torch

from multi_modal_tracking_torch.ops.boxes import clip_box
from multi_modal_tracking_torch.tracking.tracker import (_map_box_back, _prep_rgbt_batch,
                                                         _select_init_box)
from multi_modal_tracking_torch.utils.device import resolve_device, set_f32_precision


def _select(keep: torch.Tensor, new, old):
    """Per-sequence where(keep, new, old) over a state structure (tensors,
    dicts and lists of tensors). A leaf's leading axis is N, or 2N for the
    stacked modalities (then the mask repeats for the TIR half)."""
    if isinstance(new, dict):
        return {k: _select(keep, new[k], old[k]) for k in new}
    if isinstance(new, (list, tuple)):
        return type(new)(_select(keep, a, b) for a, b in zip(new, old))
    m = keep if new.shape[0] == keep.shape[0] else torch.cat([keep, keep])
    return torch.where(m.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


class BatchedRGBTTracker:
    """Tracks N RGB-T sequences of one frame size in lockstep with the full
    forward every frame.

    API: initialize(frames0_v/i (N, H, W, 3), boxes (N, 4)), then
    track_block(frames_v/i (T, N, H, W, 3), valid (T, N)) -> (T, N, 4)
    boxes. model: a float32 MixFormerRGBT in eval mode on `device` (default
    the GPU; device="cpu" runs the kernels' plain versions)."""

    def __init__(self, model, template_factor: float = 2.0, template_size: int = 128,
                 search_factor: float = 5.0, search_size: int = 288,
                 update_interval: int = 200, ce_keep_rate: Optional[float] = None,
                 scan_chunk: int = 16, device="cuda"):
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
        self.scan_chunk = scan_chunk

    def _upload(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x)).to(self.device)

    # ------------------------------------------------------- model steps
    def _init_model(self, tv, ti):
        self._template = torch.cat([tv, ti], dim=0)
        self._online = self._template

    def _predict(self, s_vi):
        return self.model(self._template, self._online, s_vi, self.ce_keep_rate,
                          use_ce_template_mask=False)

    def _update_template(self, tv, ti, live: Optional[torch.Tensor]):
        online = torch.cat([tv, ti], dim=0)
        self._online = online if live is None else _select(live, online, self._online)

    # ------------------------------------------------------------ host API
    @torch.no_grad()
    def initialize(self, frames_v: np.ndarray, frames_i: np.ndarray, boxes: np.ndarray) -> None:
        """frames_*: (N, H, W, 3) uint8 frame-0 stacks (TIR may be (N, H, W));
        boxes: (N, 4) xywh init boxes."""
        fv, fi = self._upload(frames_v), self._upload(frames_i)
        self._shape = tuple(fv.shape[1:3])
        self._state = torch.as_tensor(np.asarray(boxes, np.float32).reshape(-1, 4),
                                      device=self.device)
        self._frame_ids = np.zeros(fv.shape[0], np.int64)
        tv, ti, _ = _prep_rgbt_batch(fv, fi, self._state, self.template_factor,
                                     self.template_size)
        self._init_model(tv, ti)

    @torch.no_grad()
    def _step(self, fv: torch.Tensor, fi: torch.Tensor, ok: np.ndarray) -> torch.Tensor:
        """One lockstep frame: fv/fi (N, H, W, ...) on the device, ok (N,)
        host bools. Returns the (N, 4) boxes of this frame."""
        H, W = self._shape
        live = None if ok.all() else torch.as_tensor(ok, device=self.device)
        sv, si, rf = _prep_rgbt_batch(fv, fi, self._state, self.search_factor,
                                      self.search_size)
        out = self._predict(torch.cat([sv, si], dim=0))
        pred = out["pred_boxes"].reshape(sv.shape[0], -1, 4).mean(dim=1) \
            * (self.search_size / rf)[:, None]
        boxes = clip_box(_map_box_back(pred, self._state, self.search_size, rf),
                         H, W, margin=10)
        self._state = boxes if live is None else _select(live, boxes, self._state)
        self._frame_ids += ok
        if ok.any() and self._frame_ids.max() % self.update_interval == 0:
            tv, ti, _ = _prep_rgbt_batch(fv, fi, self._state, self.template_factor,
                                         self.template_size)
            self._update_template(tv, ti, live)
        return boxes

    def track_block(self, frames_v: np.ndarray, frames_i: np.ndarray,
                    valid: Optional[np.ndarray] = None, fetch: bool = True):
        """frames_*: (T, N, H, W, 3) uint8; valid: (T, N) bool, suffix-style
        per sequence (False freezes that sequence for the frame). Uploads
        `scan_chunk` frames at a time and returns the (T, N, 4) boxes, as
        numpy or, with fetch=False, as a device tensor without a host
        sync."""
        T, N = frames_v.shape[:2]
        valid = np.ones((T, N), np.bool_) if valid is None else np.asarray(valid, bool)
        if np.any(valid[1:] & ~valid[:-1]):
            raise ValueError("track_block valid mask must be suffix-style per sequence "
                             "(no True after a False): the template update runs on the "
                             "batch's frame cadence")
        out = []
        for lo in range(0, T, self.scan_chunk):
            hi = min(lo + self.scan_chunk, T)
            bv, bi = self._upload(frames_v[lo:hi]), self._upload(frames_i[lo:hi])
            out += [self._step(bv[t], bi[t], valid[lo + t]) for t in range(hi - lo)]
        boxes = torch.stack(out)
        return boxes.cpu().numpy() if fetch else boxes


class BatchedRGBTCachedTracker(BatchedRGBTTracker):
    """Lockstep tracking through the cached-template fast path: per frame
    only the search tokens of the 2N rows run the backbone
    (forward_track); the template cache of all N sequences is rebuilt at
    once on the scalar cadence, and a finished sequence keeps its old
    cache."""

    def _init_model(self, tv, ti):
        self._template = torch.cat([tv, ti], dim=0)
        self._cache = self.model.set_online(self._template, self._template)

    def _predict(self, s_vi):
        return self.model.forward_track(self._cache, s_vi, self.ce_keep_rate,
                                        use_ce_template_mask=False)

    def _update_template(self, tv, ti, live: Optional[torch.Tensor]):
        cache = self.model.set_online(self._template, torch.cat([tv, ti], dim=0))
        self._cache = cache if live is None else _select(live, cache, self._cache)


def run_sequences_batched(sequences: List, tracker: BatchedRGBTTracker, results_dir: str,
                          chunk: Optional[int] = None, skip_if_done: bool = True) -> List[dict]:
    """Evaluate a group of RGB-T sequences of one frame size in lockstep and
    write their result files (eval/running.py's layout; `_time.txt` holds
    the group's time shared out per frame).

    Sequences run padded to the longest; a finished one is frozen by the
    valid mask, and its padded frames replay its last real frame. Every
    block of `chunk` frames is dispatched without a fetch; the boxes come
    back in one copy at the end. Returns per sequence {"seq", "n_frames",
    "fps", "boxes"} as run_sequence does."""
    from multi_modal_tracking_torch.eval.running import _load_frame

    os.makedirs(results_dir, exist_ok=True)
    todo = [s for s in sequences
            if not (skip_if_done and os.path.isfile(os.path.join(results_dir, f"{s.name}.txt")))]
    if not todo:
        return []
    N = len(todo)
    lengths = [len(s.frames) for s in todo]
    T = max(lengths)
    f0 = [_load_frame(s, 0) for s in todo]
    frames0_v = np.stack([f[0] for f in f0])
    frames0_i = np.stack([f[1] for f in f0])
    boxes0 = np.stack([np.asarray(_select_init_box(s.init_info()["init_bbox"]), np.float32)
                       for s in todo])
    t_start = time.time()
    tracker.initialize(frames0_v, frames0_i, boxes0)

    K = chunk or tracker.scan_chunk
    pending = []
    for lo in range(1, T, K):
        hi = min(lo + K, T)
        blk_v = np.empty((hi - lo, N) + frames0_v.shape[1:], frames0_v.dtype)
        blk_i = np.empty((hi - lo, N) + frames0_i.shape[1:], frames0_i.dtype)
        for j, s in enumerate(todo):
            last = None             # a finished sequence replays its last frame
            for t in range(lo, hi):
                if t >= lengths[j] and last is not None:
                    fr = last
                else:
                    fr = last = _load_frame(s, min(t, lengths[j] - 1))
                blk_v[t - lo, j], blk_i[t - lo, j] = fr
        valid = np.arange(lo, hi)[:, None] < np.asarray(lengths)[None, :]
        pending.append(tracker.track_block(blk_v, blk_i, valid, fetch=False))
    all_boxes = torch.cat(pending).cpu().numpy() if pending else np.zeros((0, N, 4))
    elapsed = time.time() - t_start

    stats = []
    total_frames = sum(lengths)
    for j, s in enumerate(todo):
        n = lengths[j]
        out = np.zeros((n, 4), np.float64)
        out[0] = boxes0[j]
        out[1:] = all_boxes[: n - 1, j]
        np.savetxt(os.path.join(results_dir, f"{s.name}.txt"), out, delimiter="\t", fmt="%d")
        per = elapsed * (n / total_frames)
        np.savetxt(os.path.join(results_dir, f"{s.name}_time.txt"), np.full((n,), per / n),
                   fmt="%f")
        stats.append({"seq": s.name, "n_frames": n, "fps": n / max(per, 1e-9), "boxes": out})
    print(f"batched eval: {N} sequences x {T} frames in {elapsed:.1f}s "
          f"({total_frames / max(elapsed, 1e-9):.1f} aggregate FPS)")
    return stats
