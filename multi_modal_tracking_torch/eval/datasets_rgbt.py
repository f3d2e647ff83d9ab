"""In-memory evaluation sets (the port's own copies of
`SyntheticRGBTEvalDataset`, `SyntheticRGBTHardEvalDataset` and the unimodal
`SyntheticRGBEvalDataset` from the JAX package's `eval/datasets_rgbt.py`).
Their frames are uint8 arrays, so they need no image decoder. The
file-based sets (LasHeR, RGBT234, GTOT, VTUAV, DepthTrack) wait for one
(ROADMAP.md queue 1 item 1)."""
from __future__ import annotations

import numpy as np

from multi_modal_tracking_torch.eval.data import BaseDataset, RGBTSequence, Sequence, SequenceList


class SyntheticRGBTEvalDataset(BaseDataset):
    """The procedural `SyntheticRGBT` set as evaluation sequences
    `synthetic_00`, ...: ndarray frames, the box as both modalities' ground
    truth."""

    def __init__(self, n_sequences: int = 3, n_frames: int = 40, H: int = 240, W: int = 320):
        # in memory: no local paths to read
        self.n_sequences, self.n_frames, self.H, self.W = n_sequences, n_frames, H, W

    def get_sequence_list(self):
        from multi_modal_tracking_torch.train.data.datasets.synthetic import SyntheticRGBT
        src = SyntheticRGBT(self.n_sequences, self.n_frames, self.H, self.W)
        seqs = []
        for k in range(self.n_sequences):
            frames_v, frames_i, boxes = src._seq(k)
            gt = np.stack([boxes, boxes], axis=1).astype(np.float64)
            seqs.append(RGBTSequence(f"synthetic_{k:02d}", list(zip(frames_v, frames_i)),
                                     "SyntheticRGBT", gt))
        return SequenceList(seqs)


class SyntheticRGBEvalDataset(BaseDataset):
    """The RGB stream of the procedural `SyntheticRGBT` set as unimodal
    sequences `synthetic_00`, ... (the unimodal trackers' in-memory set)."""

    def __init__(self, n_sequences: int = 3, n_frames: int = 40, H: int = 240, W: int = 320):
        self.n_sequences, self.n_frames, self.H, self.W = n_sequences, n_frames, H, W

    def get_sequence_list(self):
        from multi_modal_tracking_torch.train.data.datasets.synthetic import SyntheticRGBT
        src = SyntheticRGBT(self.n_sequences, self.n_frames, self.H, self.W)
        seqs = []
        for k in range(self.n_sequences):
            frames_v, _, boxes = src._seq(k)
            seqs.append(Sequence(f"synthetic_{k:02d}", list(frames_v), "SyntheticRGB",
                                 boxes.astype(np.float64)))
        return SequenceList(seqs)


class SyntheticRGBTHardEvalDataset(BaseDataset):
    """The hard procedural set (scale change, distractors, an occluder;
    `SyntheticRGBTHard`) as `synthetic_hard_00`, ...: seed_base offsets the
    seeds past the training ones and absence is off, so the ground truth is
    meaningful every frame (occluded frames keep their would-be box)."""

    def __init__(self, n_sequences: int = 12, n_frames: int = 60, H: int = 240, W: int = 320,
                 seed_base: int = 100):
        self.n_sequences, self.n_frames, self.H, self.W = n_sequences, n_frames, H, W
        self.seed_base = seed_base

    def get_sequence_list(self):
        from multi_modal_tracking_torch.train.data.datasets.synthetic import SyntheticRGBTHard
        src = SyntheticRGBTHard(self.n_sequences, self.n_frames, self.H, self.W,
                                seed_base=self.seed_base, absent_every=0)
        seqs = []
        for k in range(self.n_sequences):
            frames_v, frames_i, boxes, _ = src._seq(k)
            gt = np.stack([boxes, boxes], axis=1).astype(np.float64)
            seqs.append(RGBTSequence(f"synthetic_hard_{k:02d}", list(zip(frames_v, frames_i)),
                                     "SyntheticRGBTHard", gt))
        return SequenceList(seqs)
