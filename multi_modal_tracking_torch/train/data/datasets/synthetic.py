"""Procedural training sets (the port's own copies of `SyntheticRGBT`,
`SyntheticRGBTHard` and the unimodal `SyntheticVideo` from the JAX
package's `train/data/datasets/synthetic.py`): a textured square moving
over textured noise, in the hard set also scaling, among distractors and
behind an occluder; the TIR frame is the inverted grey rendition of the
RGB one. Deterministic per sequence id, no files."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from multi_modal_tracking_torch.train.data.datasets.base import BaseVideoDataset


def _render(seed: int, n_frames: int, H: int, W: int):
    rng = np.random.default_rng(seed)
    bg = rng.integers(20, 90, (H, W, 3), dtype=np.uint8)
    boxes = []
    w0, h0 = 30 + 5 * (seed % 4), 24 + 4 * (seed % 3)
    colour = np.array([160 + rng.integers(0, 96), 120 + rng.integers(0, 120),
                       60 + rng.integers(0, 160)], dtype=np.uint8)
    texture = rng.integers(-40, 40, (h0, w0, 3)).astype(np.int16)
    patch = np.clip(colour[None, None, :].astype(np.int16) + texture,
                    0, 255).astype(np.uint8)
    cx, cy = W * 0.3, H * 0.4
    vx, vy = 2.0 + 0.2 * (seed % 5), 1.5
    frames = []
    for _ in range(n_frames):
        img = bg.copy()
        cx = cx + vx
        cy = cy + vy
        if cx + w0 / 2 > W - 5 or cx - w0 / 2 < 5:
            vx = -vx
            cx += 2 * vx
        if cy + h0 / 2 > H - 5 or cy - h0 / 2 < 5:
            vy = -vy
            cy += 2 * vy
        x1, y1 = int(cx - w0 / 2), int(cy - h0 / 2)
        img[y1:y1 + h0, x1:x1 + w0] = patch
        frames.append(img)
        boxes.append([x1, y1, w0, h0])
    return frames, np.asarray(boxes, dtype=np.float32)


class SyntheticRGBT(BaseVideoDataset):
    def __init__(self, n_sequences: int = 8, n_frames: int = 60, H: int = 240, W: int = 320):
        super().__init__("SyntheticRGBT", root="")
        self.n_sequences = n_sequences
        self.n_frames = n_frames
        self.H, self.W = H, W
        self._cache = {}

    def _seq(self, seq_id: int):
        if seq_id not in self._cache:
            frames, boxes = _render(seq_id, self.n_frames, self.H, self.W)
            tir = [255 - (0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]).astype(np.uint8)
                   for f in frames]
            tir = [np.stack([t, t, t], axis=-1) for t in tir]
            self._cache[seq_id] = (frames, tir, boxes)
        return self._cache[seq_id]

    def get_num_sequences(self):
        return self.n_sequences

    def get_sequence_info(self, seq_id: int):
        _, _, boxes = self._seq(seq_id)
        bbox = np.stack([boxes, boxes], axis=1)          # (N, 2, 4)
        valid = np.ones(len(boxes), dtype=bool)
        return {"bbox": bbox, "valid": valid, "visible": valid.copy()}

    def get_frames(self, seq_id: int, frame_ids: List[int], anno: Optional[dict] = None):
        frames_v, frames_i, _ = self._seq(seq_id)
        if anno is None:
            anno = self.get_sequence_info(seq_id)
        frame_list = [[frames_v[f], frames_i[f]] for f in frame_ids]
        return frame_list, self._anno_frames(anno, frame_ids), {}


def _render_hard(seed: int, n_frames: int, H: int, W: int, absent: bool = False):
    """Hard variant of `_render`: the target square also changes scale
    smoothly (+-35%), two distractor squares in channel-permuted versions of
    the target colour roam the frame, and a textured occluder bar is drawn
    over everything, so the target passes behind it. With absent=True the
    target is drawn nowhere for a mid-sequence stretch.

    Returns (frames, boxes, visible): boxes stay defined through occlusion
    and absence (the would-be trajectory); visible[k] is False when the
    target is absent or more than half occluded."""
    rng = np.random.default_rng(10_000 + seed)
    bg = rng.integers(20, 90, (H, W, 3), dtype=np.uint8)
    w0, h0 = 28 + 4 * (seed % 5), 24 + 3 * (seed % 4)
    colour = np.array([160 + rng.integers(0, 96), 120 + rng.integers(0, 120),
                       60 + rng.integers(0, 160)], dtype=np.uint8)
    base_tex = rng.integers(-40, 40, (h0, w0, 3)).astype(np.int16)

    def _patch(c, tex, h, w):
        # nearest-neighbour rescale of the fixed texture to the frame's size
        ys = (np.arange(h) * tex.shape[0] // h)[:, None]
        xs = (np.arange(w) * tex.shape[1] // w)[None, :]
        return np.clip(c[None, None, :].astype(np.int16) + tex[ys, xs], 0, 255).astype(np.uint8)

    distractors = []
    for d in range(2):
        dc = colour[list(rng.permutation(3))]
        dtex = rng.integers(-40, 40, (h0, w0, 3)).astype(np.int16)
        distractors.append({
            "c": dc, "tex": dtex,
            "cx": float(rng.uniform(0.15, 0.85) * W),
            "cy": float(rng.uniform(0.15, 0.85) * H),
            "vx": float(rng.uniform(1.0, 3.0)) * (1 if d % 2 else -1),
            "vy": float(rng.uniform(0.8, 2.0)) * (1 if d else -1),
        })
    # narrower than the full-scale target: full occlusion only at the small
    # end of the scale cycle
    occ_w = max(12, int(w0 * 0.9))
    occ_x = int(np.clip(W * (0.55 + 0.12 * ((seed % 3) - 1)), 0, W - occ_w))
    occ_patch = rng.integers(60, 150, (H, occ_w, 3), dtype=np.uint8)
    a0 = int(n_frames * 0.5)
    a1 = min(n_frames - 4, a0 + max(5, n_frames // 6))

    cx, cy = W * 0.25, H * 0.35
    vx, vy = 2.2 + 0.2 * (seed % 5), 1.6
    frames, boxes, visible = [], [], []
    for k in range(n_frames):
        img = bg.copy()
        for ds in distractors:
            ds["cx"] += ds["vx"]
            ds["cy"] += ds["vy"]
            if not (5 < ds["cx"] < W - w0 - 5):
                ds["vx"] = -ds["vx"]
                ds["cx"] += 2 * ds["vx"]
            if not (5 < ds["cy"] < H - h0 - 5):
                ds["vy"] = -ds["vy"]
                ds["cy"] += 2 * ds["vy"]
            dx, dy = int(ds["cx"]), int(ds["cy"])
            img[dy:dy + h0, dx:dx + w0] = _patch(ds["c"], ds["tex"], h0, w0)

        scale = 1.0 + 0.35 * np.sin(2 * np.pi * k / max(n_frames, 1) + seed * 0.7)
        w = max(10, int(round(w0 * scale)))
        h = max(8, int(round(h0 * scale)))
        cx += vx
        cy += vy
        if cx + w / 2 > W - 5 or cx - w / 2 < 5:
            vx = -vx
            cx += 2 * vx
        if cy + h / 2 > H - 5 or cy - h / 2 < 5:
            vy = -vy
            cy += 2 * vy
        x1, y1 = int(cx - w / 2), int(cy - h / 2)
        is_absent = absent and a0 <= k < a1
        if not is_absent:
            img[y1:y1 + h, x1:x1 + w] = _patch(colour, base_tex, h, w)
        img[:, occ_x:occ_x + occ_w] = occ_patch        # occluder over all
        ox1, ox2 = max(x1, occ_x), min(x1 + w, occ_x + occ_w)
        occluded_frac = max(ox2 - ox1, 0) / max(w, 1)
        frames.append(img)
        boxes.append([x1, y1, w, h])
        visible.append(not is_absent and occluded_frac < 0.5)
    return frames, np.asarray(boxes, dtype=np.float32), np.asarray(visible, dtype=bool)


class SyntheticRGBTHard(SyntheticRGBT):
    """Hard set: scale change, distractors and an occluder (`_render_hard`).
    absent_every=N gives every Nth sequence a mid-sequence disappearance
    with visible=False flags; absent_every=0 disables absence (the eval
    split, where the ground truth stays meaningful every frame). seed_base
    offsets the per-sequence seeds."""

    def __init__(self, n_sequences: int = 12, n_frames: int = 60, H: int = 240,
                 W: int = 320, seed_base: int = 0, absent_every: int = 3):
        super().__init__(n_sequences, n_frames, H, W)
        self.name = "SyntheticRGBTHard"
        self.seed_base = seed_base
        self.absent_every = absent_every

    def _seq(self, seq_id: int):
        if seq_id not in self._cache:
            absent = self.absent_every > 0 and seq_id % self.absent_every == 0
            frames, boxes, visible = _render_hard(self.seed_base + seq_id, self.n_frames,
                                                  self.H, self.W, absent=absent)
            tir = [255 - (0.299 * f[..., 0] + 0.587 * f[..., 1]
                          + 0.114 * f[..., 2]).astype(np.uint8)
                   for f in frames]
            tir = [np.stack([t, t, t], axis=-1) for t in tir]
            self._cache[seq_id] = (frames, tir, boxes, visible)
        return self._cache[seq_id]

    def get_sequence_info(self, seq_id: int):
        _, _, boxes, visible = self._seq(seq_id)
        bbox = np.stack([boxes, boxes], axis=1)          # (N, 2, 4)
        valid = np.ones(len(boxes), dtype=bool)
        return {"bbox": bbox, "valid": valid, "visible": visible.copy()}

    def get_frames(self, seq_id: int, frame_ids: List[int], anno: Optional[dict] = None):
        frames_v, frames_i, _, _ = self._seq(seq_id)
        if anno is None:
            anno = self.get_sequence_info(seq_id)
        frame_list = [[frames_v[f], frames_i[f]] for f in frame_ids]
        return frame_list, self._anno_frames(anno, frame_ids), {}


class SyntheticVideo(BaseVideoDataset):
    """The unimodal set: `_render`'s RGB frames and boxes."""

    def __init__(self, n_sequences: int = 8, n_frames: int = 60, H: int = 240, W: int = 320):
        super().__init__("SyntheticVideo", root="")
        self.n_sequences = n_sequences
        self.n_frames = n_frames
        self.H, self.W = H, W
        self._cache = {}

    def _seq(self, seq_id: int):
        if seq_id not in self._cache:
            self._cache[seq_id] = _render(seq_id, self.n_frames, self.H, self.W)
        return self._cache[seq_id]

    def get_num_sequences(self):
        return self.n_sequences

    def get_sequence_info(self, seq_id: int):
        _, boxes = self._seq(seq_id)
        valid = np.ones(len(boxes), dtype=bool)
        return {"bbox": boxes, "valid": valid, "visible": valid.copy()}

    def get_frames(self, seq_id: int, frame_ids: List[int], anno: Optional[dict] = None):
        frames, _ = self._seq(seq_id)
        if anno is None:
            anno = self.get_sequence_info(seq_id)
        return [frames[f] for f in frame_ids], self._anno_frames(anno, frame_ids), {}
