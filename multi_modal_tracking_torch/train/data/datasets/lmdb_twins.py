"""LMDB-backed twins of the unimodal training dataset adapters (the port's
own copy of the JAX package's `train/data/datasets/lmdb_twins.py`).

Parity targets (lib/train/dataset/): lasot_lmdb.py (groundtruth/occlusion
decoded via decode_str :94-107, frames at '<seq>/img/%08d.jpg' :131-134),
got10k_lmdb.py (sequence list + 'train/<seq>/...' keys), tracking_net_lmdb.py
(per-chunk 'TRAIN_%d_lmdb' sub-databases :101-117), coco_seq_lmdb.py
(instances json via decode_json :56, images :137), imagenetvid_lmdb.py
('cache.json' track cache :42, frames :67).

All record decoding goes through utils/lmdb_utils (handle cache +
jpg/str/json decode). The `lmdb` package is optional: tests inject fake
environments into the lmdb_utils handle cache.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from multi_modal_tracking_torch.train.admin import env_settings
from multi_modal_tracking_torch.train.data.datasets.base import (BaseImageDataset,
                                                               BaseVideoDataset)
from multi_modal_tracking_torch.utils.lmdb_utils import (decode_img, decode_json,
                                                       decode_str)


def _boxes_from_str(s: str) -> np.ndarray:
    rows = [r for r in s.replace("\t", ",").replace(" ", ",").split("\n") if r.strip()]
    return np.asarray([[float(v) for v in r.split(",") if v != ""] for r in rows],
                      dtype=np.float32)


class LaSOTLmdb(BaseVideoDataset):
    """LaSOT packed into one lmdb (lasot_lmdb.py). Keys:
    '<class>/<class>-<k>/groundtruth.txt', '.../full_occlusion.txt',
    '.../out_of_view.txt' (comma ints), frames '<seq>/img/%08d.jpg'."""

    def __init__(self, root=None, sequence_list: Optional[List[str]] = None,
                 image_loader=None):
        root = root or env_settings().require("lasot_lmdb_dir")
        super().__init__("LaSOT_lmdb", root, image_loader)
        if sequence_list is None:
            sequence_list = [l for l in decode_str(root, "list.txt").split("\n")
                             if l.strip()]
        self.sequence_list = sequence_list

    def get_num_sequences(self):
        return len(self.sequence_list)

    def get_sequence_info(self, seq_id):
        seq = self.sequence_list[seq_id]
        bbox = _boxes_from_str(decode_str(self.root, f"{seq}/groundtruth.txt"))
        valid = (bbox[:, 2] > 0) & (bbox[:, 3] > 0)
        occ = np.asarray(list(map(int, decode_str(
            self.root, f"{seq}/full_occlusion.txt").split(","))), dtype=bool)
        oov = np.asarray(list(map(int, decode_str(
            self.root, f"{seq}/out_of_view.txt").split(","))), dtype=bool)
        visible = ~occ & ~oov & valid
        return {"bbox": bbox, "valid": valid, "visible": visible}

    def get_frames(self, seq_id, frame_ids, anno=None):
        seq = self.sequence_list[seq_id]
        frames = [decode_img(self.root, f"{seq}/img/{f + 1:08d}.jpg")
                  for f in frame_ids]
        if anno is None:
            anno = self.get_sequence_info(seq_id)
        return frames, self._anno_frames(anno, frame_ids), {}


class GOT10kLmdb(BaseVideoDataset):
    """GOT-10k packed into one lmdb (got10k_lmdb.py). Keys under 'train/'."""

    def __init__(self, root=None, split: Optional[str] = None, seq_ids=None,
                 image_loader=None):
        root = root or env_settings().require("got10k_lmdb_dir")
        super().__init__("GOT10k_lmdb", root, image_loader)
        names = [l for l in decode_str(root, "train/list.txt").split("\n")
                 if l.strip()]
        if split is not None:
            # in-lmdb split entry wins; else the vendored data-spec index
            # files (got10k_lmdb.py:44-51 reads data_specs/ on the filesystem)
            split_txt = decode_str(root, f"train/{split}_split.txt")
            if split_txt is not None:
                idx = [int(v) for v in split_txt.split() if v.strip()]
            else:
                from multi_modal_tracking_torch.train.data.datasets.unimodal import (
                    data_spec_path)
                spec = {"vottrain": "got10k_vot_train_split.txt",
                        "votval": "got10k_vot_val_split.txt",
                        "train": "got10k_train_split.txt",
                        "val": "got10k_val_split.txt",
                        "train_full": "got10k_train_full_split.txt"}[split]
                idx = np.loadtxt(data_spec_path(spec), dtype=np.int64).reshape(-1)
            names = [names[i] for i in idx if i < len(names)]
        if seq_ids is not None:
            names = [names[i] for i in seq_ids]
        self.sequence_list = names

    def get_num_sequences(self):
        return len(self.sequence_list)

    def get_sequence_info(self, seq_id):
        seq = self.sequence_list[seq_id]
        bbox = _boxes_from_str(decode_str(self.root, f"train/{seq}/groundtruth.txt"))
        valid = (bbox[:, 2] > 0) & (bbox[:, 3] > 0)
        absence = np.asarray([int(v) for v in decode_str(
            self.root, f"train/{seq}/absence.label").split()], dtype=bool)
        cover = np.asarray([float(v) for v in decode_str(
            self.root, f"train/{seq}/cover.label").split()])
        visible = ~absence & (cover > 0) & valid
        return {"bbox": bbox, "valid": valid, "visible": visible}

    def get_frames(self, seq_id, frame_ids, anno=None):
        seq = self.sequence_list[seq_id]
        frames = [decode_img(self.root, f"train/{seq}/{f + 1:08d}.jpg")
                  for f in frame_ids]
        if anno is None:
            anno = self.get_sequence_info(seq_id)
        return frames, self._anno_frames(anno, frame_ids), {}


class TrackingNetLmdb(BaseVideoDataset):
    """TrackingNet as per-chunk sub-databases '<root>/TRAIN_<k>_lmdb'
    (tracking_net_lmdb.py:101-117)."""

    def __init__(self, root=None, set_ids=None, image_loader=None):
        root = root or env_settings().require("trackingnet_lmdb_dir")
        super().__init__("TrackingNet_lmdb", root, image_loader)
        set_ids = set_ids if set_ids is not None else list(range(12))
        self.sequence_list = []
        for s in set_ids:
            lst = decode_str(self._db(s), "list.txt")
            if lst is None:
                continue
            self.sequence_list += [(s, n) for n in lst.split("\n") if n.strip()]

    def _db(self, set_id):
        return os.path.join(self.root, f"TRAIN_{set_id}_lmdb")

    def get_num_sequences(self):
        return len(self.sequence_list)

    def get_sequence_info(self, seq_id):
        s, name = self.sequence_list[seq_id]
        bbox = _boxes_from_str(decode_str(self._db(s), f"anno/{name}.txt"))
        valid = (bbox[:, 2] > 0) & (bbox[:, 3] > 0)
        return {"bbox": bbox, "valid": valid, "visible": valid.copy()}

    def get_frames(self, seq_id, frame_ids, anno=None):
        s, name = self.sequence_list[seq_id]
        frames = [decode_img(self._db(s), f"frames/{name}/{f}.jpg")
                  for f in frame_ids]
        if anno is None:
            anno = self.get_sequence_info(seq_id)
        return frames, self._anno_frames(anno, frame_ids), {}


class COCOSeqLmdb(BaseImageDataset):
    """COCO instances json + jpegs in one lmdb (coco_seq_lmdb.py:56,137)."""

    def __init__(self, root=None, split="train", version="2017",
                 image_loader=None):
        root = root or env_settings().require("coco_lmdb_dir")
        super().__init__("COCO17_lmdb", root, image_loader)
        d = decode_json(root, f"annotations/instances_{split}{version}.json")
        self.img_key = f"images/{split}{version}"
        self.imgs = {im["id"]: im for im in d["images"]}
        self.anns = [a for a in d["annotations"]
                     if not a.get("iscrowd", 0) and a["bbox"][2] > 0 and a["bbox"][3] > 0]

    def get_num_sequences(self):
        return len(self.anns)

    def get_sequence_info(self, seq_id):
        a = self.anns[seq_id]
        bbox = np.asarray([a["bbox"]], dtype=np.float32)
        valid = np.asarray([True])
        return {"bbox": bbox, "valid": valid, "visible": valid.copy()}

    def get_frames(self, seq_id, frame_ids, anno=None):
        a = self.anns[seq_id]
        img = decode_img(self.root,
                         f"{self.img_key}/{self.imgs[a['image_id']]['file_name']}")
        if anno is None:
            anno = self.get_sequence_info(seq_id)
        return [img for _ in frame_ids], self._anno_frames(anno, [0] * len(frame_ids)), {}


class ImagenetVIDLmdb(BaseVideoDataset):
    """ILSVRC VID track cache + jpegs in one lmdb (imagenetvid_lmdb.py:42,67)."""

    def __init__(self, root=None, cache_file="cache.json", image_loader=None):
        root = root or env_settings().require("imagenet_lmdb_dir")
        super().__init__("imagenetvid_lmdb", root, image_loader)
        self.tracks = decode_json(root, cache_file)

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
        frames = [decode_img(self.root, t["frames"][f]) for f in frame_ids]
        if anno is None:
            anno = self.get_sequence_info(seq_id)
        return frames, self._anno_frames(anno, frame_ids), {}
