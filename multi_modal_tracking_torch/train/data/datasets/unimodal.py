"""Unimodal (RGB) training dataset adapters (the port's own copy of the JAX
package's `train/data/datasets/unimodal.py`).

Parity targets (lib/train/dataset/): lasot.py (class/class-id layout,
full_occlusion + out_of_view visibility), got10k.py (list.txt + optional
split file, absence/cover labels), tracking_net.py (TRAIN_k chunks),
tnl2k.py, coco_seq.py (COCO instances as single-frame sequences),
imagenetvid.py.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Optional

import numpy as np

from multi_modal_tracking_torch.train.admin import env_settings
from multi_modal_tracking_torch.train.data.datasets.base import (BaseImageDataset,
                                                               BaseVideoDataset,
                                                               opencv_loader)
from multi_modal_tracking_torch.train.data.datasets.rgbt import read_boxes


def data_spec_path(name: str) -> str:
    """Vendored pytracking data-spec file (split index/name lists the
    reference ships in lib/train/data_specs/)."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "data_specs", name)


class LaSOT(BaseVideoDataset):
    def __init__(self, root=None, split: Optional[str] = "train",
                 image_loader=opencv_loader):
        root = root or env_settings().require("lasot_dir")
        super().__init__("LaSOT", root, image_loader)
        seqs = sorted(glob.glob(os.path.join(root, "*", "*-*")))
        self.sequence_list = [s for s in seqs if os.path.isdir(s)]
        if split == "train":
            # protocol-II train split: the published 1120-name roster the
            # reference vendors (lib/train/dataset/lasot.py:57-58); on-disk
            # sequences not in it (test set) are dropped
            with open(data_spec_path("lasot_train_split.txt")) as f:
                train_names = {l.strip() for l in f if l.strip()}
            in_split = [s for s in self.sequence_list
                        if os.path.basename(s) in train_names]
            if in_split:
                self.sequence_list = in_split
            else:
                # fixture/partial layouts predating the roster: legacy rule —
                # exclude sequences named by <root>/testing_set.txt
                test_file = os.path.join(root, "testing_set.txt")
                if os.path.exists(test_file):
                    with open(test_file) as f:
                        test = {l.strip() for l in f if l.strip()}
                    self.sequence_list = [s for s in self.sequence_list
                                          if os.path.basename(s) not in test]

    def get_num_sequences(self):
        return len(self.sequence_list)

    def get_sequence_info(self, seq_id):
        seq = self.sequence_list[seq_id]
        bbox = read_boxes(os.path.join(seq, "groundtruth.txt"))
        valid = (bbox[:, 2] > 0) & (bbox[:, 3] > 0)
        occ = np.loadtxt(os.path.join(seq, "full_occlusion.txt"), delimiter=",").astype(bool)
        oov = np.loadtxt(os.path.join(seq, "out_of_view.txt"), delimiter=",").astype(bool)
        visible = ~occ & ~oov & valid
        return {"bbox": bbox, "valid": valid, "visible": visible}

    def get_frames(self, seq_id, frame_ids, anno=None):
        seq = self.sequence_list[seq_id]
        frames = [self.image_loader(os.path.join(seq, "img", f"{f + 1:08d}.jpg"))
                  for f in frame_ids]
        if anno is None:
            anno = self.get_sequence_info(seq_id)
        return frames, self._anno_frames(anno, frame_ids), {}


class GOT10k(BaseVideoDataset):
    def __init__(self, root=None, split: Optional[str] = None, seq_ids=None,
                 image_loader=opencv_loader):
        root = root or env_settings().require("got10k_dir")
        super().__init__("GOT10k", root, image_loader)
        with open(os.path.join(root, "list.txt")) as f:
            names = [l.strip() for l in f if l.strip()]
        if split in ("vottrain", "votval", "train", "val", "train_full"):
            # index files into list.txt — the published pytracking data specs
            # the reference vendors (lib/train/dataset/got10k.py:49-58);
            # a <root>/<split>_split.txt override wins when present
            sf = os.path.join(root, f"{split}_split.txt")
            if not os.path.exists(sf):
                spec = {"vottrain": "got10k_vot_train_split.txt",
                        "votval": "got10k_vot_val_split.txt",
                        "train": "got10k_train_split.txt",
                        "val": "got10k_val_split.txt",
                        "train_full": "got10k_train_full_split.txt"}[split]
                sf = data_spec_path(spec)
            if os.path.exists(sf):
                idx = np.loadtxt(sf, dtype=np.int64).reshape(-1)
                # miniature fixture roots carry fewer sequences than the
                # real 9335-entry list: keep in-range ids only
                names = [names[i] for i in idx if i < len(names)]
        if seq_ids is not None:
            names = [names[i] for i in seq_ids]
        self.sequence_list = names

    def get_num_sequences(self):
        return len(self.sequence_list)

    def _seq_path(self, seq_id):
        return os.path.join(self.root, self.sequence_list[seq_id])

    def get_sequence_info(self, seq_id):
        seq = self._seq_path(seq_id)
        bbox = read_boxes(os.path.join(seq, "groundtruth.txt"))
        valid = (bbox[:, 2] > 0) & (bbox[:, 3] > 0)
        absence = np.loadtxt(os.path.join(seq, "absence.label")).astype(bool)
        cover = np.loadtxt(os.path.join(seq, "cover.label"))
        visible = ~absence & (cover > 0) & valid
        return {"bbox": bbox, "valid": valid, "visible": visible}

    def get_frames(self, seq_id, frame_ids, anno=None):
        seq = self._seq_path(seq_id)
        frames = [self.image_loader(os.path.join(seq, f"{f + 1:08d}.jpg"))
                  for f in frame_ids]
        if anno is None:
            anno = self.get_sequence_info(seq_id)
        return frames, self._anno_frames(anno, frame_ids), {}


class TrackingNet(BaseVideoDataset):
    def __init__(self, root=None, set_ids=None, image_loader=opencv_loader):
        root = root or env_settings().require("trackingnet_dir")
        super().__init__("TrackingNet", root, image_loader)
        set_ids = set_ids if set_ids is not None else list(range(12))
        self.sequence_list = []
        for s in set_ids:
            anno_dir = os.path.join(root, f"TRAIN_{s}", "anno")
            if not os.path.isdir(anno_dir):
                continue
            for a in sorted(glob.glob(os.path.join(anno_dir, "*.txt"))):
                self.sequence_list.append((s, os.path.splitext(os.path.basename(a))[0]))
        # vendored seq->object-class map (lib/train/dataset/tracking_net.py:77-84)
        self._class_map = None

    def get_class_name(self, seq_id):
        if self._class_map is None:
            self._class_map = {}
            with open(data_spec_path("trackingnet_classmap.txt")) as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) == 2:
                        self._class_map[parts[0]] = parts[1]
        return self._class_map.get(self.sequence_list[seq_id][1])

    def get_num_sequences(self):
        return len(self.sequence_list)

    def get_sequence_info(self, seq_id):
        s, name = self.sequence_list[seq_id]
        bbox = read_boxes(os.path.join(self.root, f"TRAIN_{s}", "anno", name + ".txt"))
        valid = (bbox[:, 2] > 0) & (bbox[:, 3] > 0)
        return {"bbox": bbox, "valid": valid, "visible": valid.copy()}

    def get_frames(self, seq_id, frame_ids, anno=None):
        s, name = self.sequence_list[seq_id]
        frames = [self.image_loader(os.path.join(self.root, f"TRAIN_{s}", "frames",
                                                 name, f"{f}.jpg")) for f in frame_ids]
        if anno is None:
            anno = self.get_sequence_info(seq_id)
        return frames, self._anno_frames(anno, frame_ids), {}


class TNL2k(BaseVideoDataset):
    def __init__(self, root=None, image_loader=opencv_loader):
        root = root or env_settings().require("tnl2k_dir")
        super().__init__("TNL2k", root, image_loader)
        self.sequence_list = sorted(
            s for s in glob.glob(os.path.join(root, "*")) if os.path.isdir(s))
        self._frame_cache = {}

    def get_num_sequences(self):
        return len(self.sequence_list)

    def get_sequence_info(self, seq_id):
        seq = self.sequence_list[seq_id]
        bbox = read_boxes(os.path.join(seq, "groundtruth.txt"))
        valid = (bbox[:, 2] > 0) & (bbox[:, 3] > 0)
        return {"bbox": bbox, "valid": valid, "visible": valid.copy()}

    def get_frames(self, seq_id, frame_ids, anno=None):
        seq = self.sequence_list[seq_id]
        # frame lists cached per sequence: TNL2k names frames irregularly so
        # a sorted listing is needed, but once is enough (get_frames runs on
        # the data-worker hot path twice per sample)
        imgs = self._frame_cache.get(seq)
        if imgs is None:
            imgs = sorted(glob.glob(os.path.join(seq, "imgs", "*")))
            self._frame_cache[seq] = imgs
        frames = [self.image_loader(imgs[f]) for f in frame_ids]
        if anno is None:
            anno = self.get_sequence_info(seq_id)
        return frames, self._anno_frames(anno, frame_ids), {}


class COCOSeq(BaseImageDataset):
    """COCO instances as single-frame pseudo-sequences (coco_seq.py)."""

    def __init__(self, root=None, split="train", version="2017",
                 image_loader=opencv_loader):
        root = root or env_settings().require("coco_dir")
        super().__init__("COCO17", root, image_loader)
        anno_path = os.path.join(root, "annotations", f"instances_{split}{version}.json")
        with open(anno_path) as f:
            d = json.load(f)
        self.img_dir = os.path.join(root, "images", f"{split}{version}")
        imgs = {im["id"]: im for im in d["images"]}
        self.anns = [a for a in d["annotations"]
                     if not a.get("iscrowd", 0) and a["bbox"][2] > 0 and a["bbox"][3] > 0]
        self.imgs = imgs

    def get_num_sequences(self):
        return len(self.anns)

    def get_sequence_info(self, seq_id):
        a = self.anns[seq_id]
        bbox = np.asarray([a["bbox"]], dtype=np.float32)
        valid = np.asarray([True])
        return {"bbox": bbox, "valid": valid, "visible": valid.copy()}

    def get_frames(self, seq_id, frame_ids, anno=None):
        a = self.anns[seq_id]
        im_info = self.imgs[a["image_id"]]
        img = self.image_loader(os.path.join(self.img_dir, im_info["file_name"]))
        if anno is None:
            anno = self.get_sequence_info(seq_id)
        frames = [img for _ in frame_ids]
        return frames, self._anno_frames(anno, [0] * len(frame_ids)), {}


class ImagenetVID(BaseVideoDataset):
    """ILSVRC VID via a preprocessed cache json (imagenetvid.py caches a
    per-track list with frame paths, boxes and visibility)."""

    def __init__(self, root=None, cache_file="imagenet_vid_cache.json",
                 image_loader=opencv_loader):
        root = root or env_settings().require("imagenet_dir")
        super().__init__("imagenetvid", root, image_loader)
        with open(os.path.join(root, cache_file)) as f:
            self.tracks = json.load(f)

    def get_num_sequences(self):
        return len(self.tracks)

    def get_sequence_info(self, seq_id):
        t = self.tracks[seq_id]
        bbox = np.asarray(t["bbox"], dtype=np.float32)
        valid = (bbox[:, 2] > 0) & (bbox[:, 3] > 0)
        visible = np.asarray(t.get("visible", valid), dtype=bool) & valid
        return {"bbox": bbox, "valid": valid, "visible": visible}

    def get_frames(self, seq_id, frame_ids, anno=None):
        t = self.tracks[seq_id]
        frames = [self.image_loader(os.path.join(self.root, t["frames"][f]))
                  for f in frame_ids]
        if anno is None:
            anno = self.get_sequence_info(seq_id)
        return frames, self._anno_frames(anno, frame_ids), {}
