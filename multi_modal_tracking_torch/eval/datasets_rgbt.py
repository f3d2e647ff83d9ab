"""RGB-T / RGB-D evaluation sets (the port's own copy of the JAX package's
`eval/datasets_rgbt.py`).

The file-based sets list their frames as paths, which the runner's
prefetch thread decodes (`eval/running.py _load_frame`):
  LasHeR       TestingSet (visible/ + infrared/, init.txt)
  RGBT234      visible.txt / infrared.txt per-modality ground truth
  GTOT         x1y1x2y2 groundTruth_{v,i}.txt -> xywh
  VTUAV        short / long / all (rgb/ + ir/, a box every 10th frame)
  DepthTrack   color/ + depth/ (uint16 PNG, rendered as replicated
               greyscale at load time)
The in-memory synthetic sets (`SyntheticRGBTEvalDataset`,
`SyntheticRGBTHardEvalDataset` and the unimodal `SyntheticRGBEvalDataset`)
hold uint8 arrays.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from multi_modal_tracking_torch.eval.data import (BaseDataset, RGBTSequence, Sequence,
                                                  SequenceList, load_text)


class LasHeRDataset(BaseDataset):
    def __init__(self):
        super().__init__()
        self.base_path = self.env_settings.lasher_dir
        if not self.base_path:
            self.sequence_path_list = []    # unconfigured: no CWD glob
            return
        self.sequence_path_list = sorted(glob.glob(
            os.path.join(self.base_path, "TestingSet", "testingset", "*")))
        if not self.sequence_path_list:    # tolerate flat layouts
            self.sequence_path_list = sorted(
                p for p in glob.glob(os.path.join(self.base_path, "*"))
                if os.path.isdir(p))

    def get_sequence_list(self):
        return SequenceList([self._construct_sequence(s) for s in self.sequence_path_list])

    def _construct_sequence(self, video_path):
        frames_v = sorted(glob.glob(os.path.join(video_path, "visible", "*")))
        frames_i = sorted(glob.glob(os.path.join(video_path, "infrared", "*")))
        gt = load_text(os.path.join(video_path, "init.txt"), delimiter=(",", None))
        return RGBTSequence(os.path.basename(video_path),
                            list(zip(frames_v, frames_i)), "LasHeR",
                            np.stack([gt, gt], axis=1))

    def __len__(self):
        return len(self.sequence_path_list)


class RGBT234Dataset(BaseDataset):
    def __init__(self):
        super().__init__()
        self.base_path = self.env_settings.rgbt234_dir
        if not self.base_path:
            self.sequence_name_list = []
            return
        self.sequence_name_list = [os.path.basename(p) for p in sorted(
            glob.glob(os.path.join(self.base_path, "*"))) if os.path.isdir(p)]

    def get_sequence_list(self):
        return SequenceList([self._construct_sequence(s) for s in self.sequence_name_list])

    def _construct_sequence(self, name):
        base = os.path.join(self.base_path, name)
        frames_v = sorted(glob.glob(os.path.join(base, "visible", "*")))
        frames_i = sorted(glob.glob(os.path.join(base, "infrared", "*")))
        gt_v = load_text(os.path.join(base, "visible.txt"), delimiter=(",", None))
        gt_i = load_text(os.path.join(base, "infrared.txt"), delimiter=(",", None))
        return RGBTSequence(name, list(zip(frames_v, frames_i)), "RGBT234",
                            np.stack([gt_v, gt_i], axis=1))

    def __len__(self):
        return len(self.sequence_name_list)


class GTOTDataset(BaseDataset):
    def __init__(self):
        super().__init__()
        self.base_path = self.env_settings.gtot_dir
        if not self.base_path:
            self.sequence_name_list = []
            return
        list_file = os.path.join(self.base_path, "gtot.txt")
        if os.path.isfile(list_file):
            with open(list_file) as f:
                self.sequence_name_list = [l.strip() for l in f if l.strip()]
        else:
            self.sequence_name_list = [os.path.basename(p) for p in sorted(
                glob.glob(os.path.join(self.base_path, "*"))) if os.path.isdir(p)]

    def get_sequence_list(self):
        return SequenceList([self._construct_sequence(s) for s in self.sequence_name_list])

    def _construct_sequence(self, name):
        base = os.path.join(self.base_path, name)
        frames_v = sorted(glob.glob(os.path.join(base, "v", "*")))
        frames_i = sorted(glob.glob(os.path.join(base, "i", "*")))
        gt_v = load_text(os.path.join(base, "groundTruth_v.txt"), delimiter=(",", " ", None))
        gt_i = load_text(os.path.join(base, "groundTruth_i.txt"), delimiter=(",", " ", None))
        for gt in (gt_v, gt_i):                      # x1y1x2y2 -> xywh
            gt[:, 2] -= gt[:, 0]
            gt[:, 3] -= gt[:, 1]
        return RGBTSequence(name, list(zip(frames_v, frames_i)), "GTOT",
                            np.stack([gt_v, gt_i], axis=1))

    def __len__(self):
        return len(self.sequence_name_list)


class VTUAVDataset(BaseDataset):
    """VTUAV test split; gt is annotated every 10th frame (sparse)."""

    def __init__(self, split: str = "all", train_split: bool = False):
        super().__init__()
        assert split in ("short", "long", "all")
        folder = {"short": "test_ST_*", "long": "test_LT_*", "all": "*"}[split]
        self.base_path = self.env_settings.vtuav_dir
        if not self.base_path:
            self.sequence_path_list = []
            return
        sub = "train_data" if train_split else "test_data"
        class_dirs = sorted(glob.glob(os.path.join(self.base_path, sub, folder)))
        self.sequence_path_list = []
        for p in class_dirs:
            self.sequence_path_list += sorted(glob.glob(os.path.join(p, "*")))

    def get_sequence_list(self):
        return SequenceList([self._construct_sequence(s) for s in self.sequence_path_list])

    def _construct_sequence(self, video_path):
        frames_v = sorted(glob.glob(os.path.join(video_path, "rgb", "*")))
        frames_i = sorted(glob.glob(os.path.join(video_path, "ir", "*")))
        gt_v = load_text(os.path.join(video_path, "rgb.txt"), delimiter=(" ", ",", None))
        gt_i = load_text(os.path.join(video_path, "ir.txt"), delimiter=(" ", ",", None))
        n = min(len(gt_v), len(gt_i))
        return RGBTSequence(os.path.basename(video_path),
                            list(zip(frames_v, frames_i)), "VTUAV",
                            np.stack([gt_v[:n], gt_i[:n]], axis=1))

    def __len__(self):
        return len(self.sequence_path_list)


class DepthTrackDataset(BaseDataset):
    """DepthTrack (VOT-RGBD) test sequences: color/ + depth/ (uint16 png).

    The depth channel is rendered to pseudo-RGB (normalised + JET) by the
    sequence runner at load time (reference: lib/test/evaluation/
    depth_utils.py:4-60, tracker_rgbt.py:217-218)."""

    def __init__(self):
        super().__init__()
        self.base_path = self.env_settings.depthtrack_dir
        if not self.base_path:
            self.sequence_path_list = []
            return
        # reference layout: <root>/test/<group>/<seq> (depthtrackdataset.py:12)
        self.sequence_path_list = sorted(
            p for p in glob.glob(os.path.join(self.base_path, "test", "*", "*"))
            if os.path.isdir(p))
        if not self.sequence_path_list:    # tolerate flat layouts
            self.sequence_path_list = sorted(
                p for p in glob.glob(os.path.join(self.base_path, "*"))
                if os.path.isdir(p))

    def get_sequence_list(self):
        return SequenceList([self._construct_sequence(s) for s in self.sequence_path_list])

    def _construct_sequence(self, video_path):
        frames_v = sorted(glob.glob(os.path.join(video_path, "color", "*")))
        frames_i = sorted(glob.glob(os.path.join(video_path, "depth", "*")))
        gt = load_text(os.path.join(video_path, "groundtruth.txt"), delimiter=(",", None))
        # occlusion frames are NaN rows in DepthTrack annotations
        # (depthtrackdataset.py:20 nan_to_num)
        gt = np.nan_to_num(gt)
        return RGBTSequence(os.path.basename(video_path),
                            list(zip(frames_v, frames_i)), "DepthTrack",
                            np.stack([gt, gt], axis=1), depth_input=True)

    def __len__(self):
        return len(self.sequence_path_list)




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
