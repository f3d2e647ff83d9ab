"""Procedural RGB-T training set (the port's own copy of `SyntheticRGBT`
from the JAX package's `train/data/datasets/synthetic.py`): a textured
square moving over textured noise; the TIR frame is the inverted grey
rendition of the RGB one. Deterministic per sequence id, no files."""
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
