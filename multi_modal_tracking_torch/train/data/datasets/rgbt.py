"""RGB-T / RGB-D paired training dataset adapters (the port's own copy of
the JAX package's `train/data/datasets/rgbt.py`; frames decode through the
port's decoder, depth maps stretch in numpy, `utils/depth.py`).

Parity targets (lib/train/dataset/): lasher.py:15-94 (drops the corrupt
blueboy85 sequence; init.txt boxes used for both modalities), rgbt234.py,
vtuav.py:15-123 (train-split dedup of train_ST_004 duplicates; sparse
10-frame annotations: frame index x10, visibility from the per-sequence
attribute npy), depthtrack_seq.py (+depth_utils.get_rgbd_frame: depth
normalised then stacked 3x as pseudo-frame; toy07_indoor_320 truncated to
1367 annotated frames), lasher_tir.py / rgbt234_tir.py (TIR-only unimodal
views), kaist.py, llvip_seq.py, m3fd_seq.py.

All return frames as [img_v, img_i] with bbox rows (2, 4) xywh.
"""
from __future__ import annotations

import glob
import json
import os
from typing import List, Optional

import numpy as np

from multi_modal_tracking_torch import native

from multi_modal_tracking_torch.train.admin import env_settings
from multi_modal_tracking_torch.train.data.datasets.base import BaseVideoDataset, opencv_loader


def read_boxes(path: str, delimiter: Optional[str] = ",") -> np.ndarray:
    arr = np.genfromtxt(path, delimiter=delimiter, dtype=np.float32)
    if arr.ndim == 1:
        arr = arr[None]
    return np.nan_to_num(arr)


class PairSeqDataset(BaseVideoDataset):
    """Generic <root>/<seq>/<subdir_v|subdir_i> paired-sequence dataset."""

    subdir_v = "visible"
    subdir_i = "infrared"
    anno_delim = ","

    def __init__(self, name, root, image_loader=opencv_loader):
        super().__init__(name, root, image_loader)
        self.sequence_list: List[str] = self._list_sequences()
        self.sequence_imgpath_list = []
        for seq_path in self.sequence_list:
            v = sorted(glob.glob(os.path.join(seq_path, self.subdir_v, "*")))
            i = sorted(glob.glob(os.path.join(seq_path, self.subdir_i, "*")))
            self.sequence_imgpath_list.append(list(zip(v, i)))
        self.sequence_info_list = [self._seq_info(p) for p in self.sequence_list]

    def _list_sequences(self) -> List[str]:
        return sorted(glob.glob(os.path.join(self.root, "*")))

    def _read_anno(self, seq_path) -> np.ndarray:
        raise NotImplementedError

    def _seq_info(self, seq_path) -> dict:
        bbox = self._read_anno(seq_path)                       # (N, 2, 4)
        valid = (bbox[:, 0, 2] > 0) & (bbox[:, 0, 3] > 0) & \
                (bbox[:, 1, 2] > 0) & (bbox[:, 1, 3] > 0)
        return {"bbox": bbox, "valid": valid, "visible": valid.copy()}

    def get_num_sequences(self):
        return len(self.sequence_list)

    def get_sequence_info(self, seq_id):
        return self.sequence_info_list[seq_id]

    def _get_frame(self, seq_id, frame_id):
        pv, pi = self.sequence_imgpath_list[seq_id][frame_id]
        return [self.image_loader(pv), self.image_loader(pi)]

    def get_frames(self, seq_id, frame_ids, anno=None):
        frames = [self._get_frame(seq_id, f) for f in frame_ids]
        if anno is None:
            anno = self.get_sequence_info(seq_id)
        return frames, self._anno_frames(anno, frame_ids), {}


class LasHeR(PairSeqDataset):
    def __init__(self, root=None, image_loader=opencv_loader):
        root = root or env_settings().require("lasher_dir")
        super().__init__("LasHeR", root, image_loader)

    def _list_sequences(self):
        seqs = sorted(glob.glob(os.path.join(self.root, "TrainingSet", "trainingset", "*")))
        bad = os.path.join(self.root, "TrainingSet", "trainingset", "blueboy85")
        return [s for s in seqs if s != bad]

    def _read_anno(self, seq_path):
        # Both modalities use init.txt (lasher.py:66-73).
        gt = read_boxes(os.path.join(seq_path, "init.txt"))
        return np.stack([gt, gt], axis=1)


class RGBT234(PairSeqDataset):
    def __init__(self, root=None, image_loader=opencv_loader):
        root = root or env_settings().require("rgbt234_dir")
        super().__init__("RGBT234", root, image_loader)

    def _read_anno(self, seq_path):
        gt_v = read_boxes(os.path.join(seq_path, "visible.txt"))
        gt_i = read_boxes(os.path.join(seq_path, "infrared.txt"))
        return np.stack([gt_v, gt_i], axis=1)


class VTUAV(PairSeqDataset):
    subdir_v = "rgb"
    subdir_i = "ir"

    def __init__(self, root=None, image_loader=opencv_loader, split_dirs=("train_data",)):
        self._split_dirs = split_dirs
        root = root or env_settings().require("vtuav_dir")
        super().__init__("VTUAV", root, image_loader)

    def _list_sequences(self):
        seqs = []
        for sd in self._split_dirs:
            for split in sorted(glob.glob(os.path.join(self.root, sd, "*"))):
                seqs += sorted(glob.glob(os.path.join(split, "*")))
        # Dedup duplicated train sequences (vtuav.py:17-28): keep the first
        # occurrence per video name.
        seen, out = set(), []
        for s in seqs:
            name = os.path.basename(s)
            if name not in seen:
                seen.add(name)
                out.append(s)
        return out

    def _read_anno(self, seq_path):
        gt_v = read_boxes(os.path.join(seq_path, "rgb.txt"), delimiter=None)
        gt_i = read_boxes(os.path.join(seq_path, "ir.txt"), delimiter=None)
        n = min(len(gt_v), len(gt_i))
        return np.stack([gt_v[:n], gt_i[:n]], axis=1)

    def _seq_info(self, seq_path):
        info = super()._seq_info(seq_path)
        n = len(info["valid"])
        # Sparse 10-frame annotations: visibility from the attribute npy,
        # subsampled at the annotated frames (vtuav.py:62-71, 90-100).
        video = os.path.basename(seq_path)
        attr = os.path.join(self.root, "seq_level_attr_anno", f"{video}.npy")
        if os.path.exists(attr):
            d = np.load(attr, allow_pickle=True).item()
            vis_full = ~d["FO"][:, 0].astype(bool) & ~d["OV"][:, 0].astype(bool)
        else:
            vis_full = np.ones(10 * n, dtype=bool)
        idx = np.minimum(10 * np.arange(n), len(vis_full) - 1)
        info["visible"] = vis_full[idx] & info["valid"]
        return info

    def _get_frame(self, seq_id, frame_id):
        # annotation index -> frame index x10 (vtuav.py:106)
        pv, pi = self.sequence_imgpath_list[seq_id][frame_id * 10]
        return [self.image_loader(pv), self.image_loader(pi)]


def normalized_depth_pair(color_path: str, depth_path: str, depth_clip: bool = True):
    """depth_utils.get_rgbd_frame(dtype='rgb3d') semantics: (the colour
    frame RGB, the depth map clipped, stretched and replicated as uint8
    (H, W, 3)), equal bit for bit to the JAX package's cv2 version."""
    from multi_modal_tracking_torch.utils.depth import depth_rgb3d
    return native.imread(color_path), depth_rgb3d(native.imread_unchanged(depth_path),
                                                  depth_clip)


class DepthTrack(PairSeqDataset):
    subdir_v = "color"
    subdir_i = "depth"

    def __init__(self, root=None, split="train", image_loader=opencv_loader):
        self._split = split
        root = root or env_settings().require("depthtrack_dir")
        super().__init__("DepthTrack", root, image_loader)
        for i, p in enumerate(self.sequence_list):
            if "toy07_indoor_320" in p:
                info = self.sequence_info_list[i]
                self.sequence_info_list[i] = {k: v[:1367] for k, v in info.items()}

    def _list_sequences(self):
        return sorted(glob.glob(os.path.join(self.root, self._split, "*", "*")))

    def _read_anno(self, seq_path):
        gt = read_boxes(os.path.join(seq_path, "groundtruth.txt"))
        return np.stack([gt, gt], axis=1)

    def _get_frame(self, seq_id, frame_id):
        pv, pi = self.sequence_imgpath_list[seq_id][frame_id]
        rgb, d3 = normalized_depth_pair(pv, pi, depth_clip=True)
        return [rgb, d3]


class _TIROnly(BaseVideoDataset):
    """Unimodal TIR view of a paired dataset (lasher_tir.py/rgbt234_tir.py):
    returns only the infrared frame with the infrared bbox."""

    def __init__(self, pair_ds: PairSeqDataset, name: str):
        super().__init__(name, pair_ds.root, pair_ds.image_loader)
        self._ds = pair_ds

    def get_num_sequences(self):
        return self._ds.get_num_sequences()

    def get_sequence_info(self, seq_id):
        info = self._ds.get_sequence_info(seq_id)
        return {"bbox": info["bbox"][:, 1], "valid": info["valid"],
                "visible": info["visible"]}

    def get_frames(self, seq_id, frame_ids, anno=None):
        frames, annos, meta = self._ds.get_frames(seq_id, frame_ids)
        if anno is None:
            anno = self.get_sequence_info(seq_id)
        return [f[1] for f in frames], self._anno_frames(anno, frame_ids), meta


def LasHeR_TIR(root=None, image_loader=opencv_loader):
    return _TIROnly(LasHeR(root, image_loader), "LasHeR_T")


def RGBT234_TIR(root=None, image_loader=opencv_loader):
    return _TIROnly(RGBT234(root, image_loader), "RGBT234_T")


class KAIST(PairSeqDataset):
    """KAIST multispectral pedestrian pairs as tracking sequences
    (kaist.py: images/<set>/<video>/{visible,lwir} + per-video json annos)."""
    subdir_v = "visible"
    subdir_i = "lwir"

    def __init__(self, root=None, image_loader=opencv_loader):
        root = root or env_settings().require("kaist_dir")
        super().__init__("KAIST", root, image_loader)

    def _list_sequences(self):
        out = []
        for s in sorted(glob.glob(os.path.join(self.root, "images", "*"))):
            out += sorted(glob.glob(os.path.join(s, "*")))
        return out

    def _read_anno(self, seq_path):
        rel = os.path.relpath(seq_path, os.path.join(self.root, "images"))
        anno = os.path.join(self.root, "annotations", rel + ".json")
        with open(anno) as f:
            d = json.load(f)
        boxes = np.asarray(d["bbox"] if "bbox" in d else d, dtype=np.float32)
        if boxes.ndim == 1:
            boxes = boxes[None]
        return np.stack([boxes, boxes], axis=1)


class LLVIP(PairSeqDataset):
    """LLVIP visible/infrared pairs used as a single pseudo sequence per
    directory (llvip_seq.py layout)."""
    subdir_v = "visible"
    subdir_i = "infrared"

    def __init__(self, root=None, image_loader=opencv_loader):
        root = root or env_settings().require("llvip_dir")
        super().__init__("LLVIP", root, image_loader)

    def _read_anno(self, seq_path):
        gt = read_boxes(os.path.join(seq_path, "groundtruth.txt"))
        return np.stack([gt, gt], axis=1)


class M3FD(PairSeqDataset):
    subdir_v = "vis"
    subdir_i = "ir"

    def __init__(self, root=None, image_loader=opencv_loader):
        root = root or env_settings().require("m3fd_dir")
        super().__init__("M3FD", root, image_loader)

    def _read_anno(self, seq_path):
        gt = read_boxes(os.path.join(seq_path, "groundtruth.txt"))
        return np.stack([gt, gt], axis=1)
