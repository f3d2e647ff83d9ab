"""Sequence containers for evaluation.

The port's own copy of the JAX package's `eval/data.py`: `Sequence`,
`RGBTSequence` (frames as (visible, infrared) pairs and ground truth as
(rect_v, rect_i) pairs, the shapes the RGB-T metric consumes),
`SequenceList` and the robust text loader `load_text`.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


class BaseDataset:
    """Base class of the evaluation datasets that read local paths."""

    def __init__(self):
        from multi_modal_tracking_torch.train.admin import env_settings
        self.env_settings = env_settings()

    def __len__(self):
        return len(self.get_sequence_list())

    def get_sequence_list(self):
        raise NotImplementedError


class Sequence:
    """A single unimodal test sequence."""

    def __init__(self, name: str, frames: List, dataset: str, ground_truth_rect,
                 object_class: Optional[str] = None, target_visible=None):
        self.name = name
        self.frames = frames
        self.dataset = dataset
        self.ground_truth_rect = np.asarray(ground_truth_rect, dtype=np.float64)
        self.object_class = object_class
        self.target_visible = (np.asarray(target_visible)
                               if target_visible is not None else None)
        self.multimodal = False

    def init_info(self) -> dict:
        return {"init_bbox": list(map(float, self.ground_truth_rect[0]))}

    def __repr__(self):
        return f"{self.__class__.__name__}({self.name}, {len(self.frames)} frames)"


class RGBTSequence(Sequence):
    """A paired RGB-T (or RGB-D rendered) sequence.

    frames: list of (frame_v, frame_i), paths or uint8 arrays;
    ground_truth_rect: (N, 2, 4) [RGB gt; TIR gt]. The metric takes the max
    IoU / min centre error over the pair.
    """

    def __init__(self, name: str, frames: List[tuple], dataset: str,
                 ground_truth_rect, object_class: Optional[str] = None,
                 target_visible=None, depth_input: bool = False):
        gt = np.asarray(ground_truth_rect, dtype=np.float64)
        assert gt.ndim == 3 and gt.shape[1] == 2 and gt.shape[2] == 4, gt.shape
        self.name = name
        self.frames = frames
        self.dataset = dataset
        self.ground_truth_rect = gt
        self.object_class = object_class
        self.target_visible = (np.asarray(target_visible)
                               if target_visible is not None else None)
        self.multimodal = True
        self.depth_input = depth_input   # frames_i are raw depth maps

    def init_info(self) -> dict:
        # the [RGB gt; TIR gt] pair: the tracker selects its mode's row
        # (the bimodal trackers take the RGB one)
        return {"init_bbox": [list(map(float, r)) for r in self.ground_truth_rect[0]]}


class SequenceList(list):
    """List of sequences with lookup by name."""

    def __getitem__(self, item):
        if isinstance(item, str):
            for seq in self:
                if seq.name == item:
                    return seq
            raise IndexError(f"Sequence name not in the dataset: {item}")
        if isinstance(item, (int, np.integer)):
            return super().__getitem__(item)
        return SequenceList(super().__getitem__(item))

    def __add__(self, other):
        return SequenceList(super().__add__(other))


def load_text(path: str, delimiter=(",", "\t", " ", None), dtype=np.float64) -> np.ndarray:
    """Ground-truth / result text loader: tries each delimiter until one
    parses."""
    if isinstance(delimiter, (str, type(None))):
        delimiter = (delimiter,)
    last_err = None
    for d in delimiter:
        try:
            arr = np.loadtxt(path, delimiter=d, dtype=dtype, ndmin=2)
            if arr.size:
                return arr
        except Exception as e:           # noqa: BLE001 — try the next delimiter
            last_err = e
    raise ValueError(f"could not parse {path}: {last_err}")
