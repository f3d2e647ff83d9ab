"""Unimodal evaluation dataset adapters (the port's own copy of the JAX
package's `eval/datasets_rgb.py`).

Parity targets (lib/test/evaluation/): lasotdataset.py, got10kdataset.py,
trackingnetdataset.py, otbdataset.py, uavdataset.py, nfsdataset.py,
tc128dataset.py. Layouts follow the public distributions; OTB/UAV/NFS use
the standard <seq>/(img|.)/frames + groundtruth file convention rather than
the reference's hard-coded per-sequence tables (functionally equivalent for
the standard releases).
"""
from __future__ import annotations

import glob
import os

import numpy as np

from multi_modal_tracking_torch.eval.data import (BaseDataset, Sequence,
                                                SequenceList, load_text)


class LaSOTDataset(BaseDataset):
    """LaSOT test split: <class>/<class-N>/img/*.jpg + groundtruth.txt,
    visibility from full_occlusion.txt & out_of_view.txt."""

    def __init__(self):
        super().__init__()
        from multi_modal_tracking_torch.eval._benchmark_tables import (
            LASOT_TEST_SEQUENCES)
        self.base_path = self.env_settings.lasot_dir
        if not self.base_path:
            self.sequence_path_list = []     # unconfigured: empty, no CWD glob
            return                           # (guard BEFORE joins: a
            # present-but-empty local.yaml key parses to None, and
            # os.path.join(None, ...) would raise)
        # Protocol-II: the FIXED 280-sequence test roster (lasotdataset.py:44)
        # — a full LaSOT download also holds the 1120 train sequences, which
        # globbing would sweep into the evaluation
        roster = [os.path.join(self.base_path, n.split("-")[0], n)
                  for n in LASOT_TEST_SEQUENCES]
        if os.path.isdir(roster[0]):
            self.sequence_path_list = roster
            return
        self.sequence_path_list = sorted(glob.glob(
            os.path.join(self.base_path, "*", "*-*")))
        if not self.sequence_path_list:
            self.sequence_path_list = sorted(
                p for p in glob.glob(os.path.join(self.base_path, "*"))
                if os.path.isdir(os.path.join(p, "img")))

    def get_sequence_list(self):
        return SequenceList([self._construct_sequence(p) for p in self.sequence_path_list])

    def _construct_sequence(self, seq_path):
        name = os.path.basename(seq_path)
        gt = load_text(os.path.join(seq_path, "groundtruth.txt"), delimiter=(",", None))
        occ = np.loadtxt(os.path.join(seq_path, "full_occlusion.txt"),
                         delimiter=",", dtype=np.int64).reshape(-1)
        oov = np.loadtxt(os.path.join(seq_path, "out_of_view.txt"),
                         delimiter=",", dtype=np.int64).reshape(-1)
        visible = ((occ == 0) & (oov == 0)).astype(np.uint8)
        frames = [os.path.join(seq_path, "img", f"{i:08d}.jpg")
                  for i in range(1, gt.shape[0] + 1)]
        return Sequence(name, frames, "lasot", gt,
                        object_class=name.rsplit("-", 1)[0], target_visible=visible)


class LaSOTLmdbDataset(BaseDataset):
    """LaSOT test split packed into one lmdb
    (lib/test/evaluation/lasot_lmdbdataset.py): frame entries are
    (db_path, key) pairs decoded by the runner's frame loader; annotations
    decoded from '<class>/<seq>/{groundtruth,full_occlusion,out_of_view}.txt'
    keys, sequence names from 'list.txt' (falls back to the directory-less
    env path)."""

    def __init__(self, root=None, sequence_list=None):
        super().__init__()
        from multi_modal_tracking_torch.utils.lmdb_utils import decode_str
        self._decode_str = decode_str
        self.base_path = root or self.env_settings.require("lasot_lmdb_dir")
        if sequence_list is None:
            sequence_list = [l for l in decode_str(self.base_path, "list.txt").split("\n")
                             if l.strip()]
        self.sequence_list = sequence_list

    def get_sequence_list(self):
        return SequenceList([self._construct_sequence(s) for s in self.sequence_list])

    def _construct_sequence(self, seq):
        name = seq.split("/")[-1]
        rows = [r for r in self._decode_str(
            self.base_path, f"{seq}/groundtruth.txt").split("\n") if r.strip()]
        gt = np.asarray([[float(v) for v in r.split(",")] for r in rows], np.float64)
        occ = np.asarray(list(map(int, self._decode_str(
            self.base_path, f"{seq}/full_occlusion.txt").split(","))))
        oov = np.asarray(list(map(int, self._decode_str(
            self.base_path, f"{seq}/out_of_view.txt").split(","))))
        visible = ((occ == 0) & (oov == 0)).astype(np.uint8)
        frames = [(self.base_path, f"{seq}/img/{i:08d}.jpg")
                  for i in range(1, gt.shape[0] + 1)]
        return Sequence(name, frames, "lasot", gt,
                        object_class=name.rsplit("-", 1)[0], target_visible=visible)


class GOT10kDataset(BaseDataset):
    """GOT-10k test/val/ltrval: GOT-10k_<Split>_NNNNNN/*.jpg + groundtruth.txt."""

    def __init__(self, split: str = "test"):
        super().__init__()
        self.split = split
        base = self.env_settings.got10k_dir
        sub = {"test": "test", "val": "val", "ltrval": "train"}[split]
        self.base_path = os.path.join(base, sub) if base else ""
        if not self.base_path:
            self.sequence_name_list = []     # unconfigured: no CWD glob
            return
        list_file = os.path.join(self.base_path, "list.txt")
        if os.path.isfile(list_file):
            with open(list_file) as f:
                names = [l.strip() for l in f if l.strip()]
        else:
            names = [os.path.basename(p) for p in sorted(
                glob.glob(os.path.join(self.base_path, "GOT-10k_*")))]
        if split == "ltrval":
            # pytracking's held-out-from-train validation ids
            # (got10kdataset.py:38-41 reads got10k_val_split.txt)
            from multi_modal_tracking_torch.train.data.datasets.unimodal import (
                data_spec_path)
            idx = np.loadtxt(data_spec_path("got10k_val_split.txt"),
                             dtype=np.int64).reshape(-1)
            names = [names[i] for i in idx if i < len(names)]
        self.sequence_name_list = names

    def get_sequence_list(self):
        return SequenceList([self._construct_sequence(n) for n in self.sequence_name_list])

    def _construct_sequence(self, name):
        base = os.path.join(self.base_path, name)
        gt = load_text(os.path.join(base, "groundtruth.txt"), delimiter=(",", None))
        frames = sorted(glob.glob(os.path.join(base, "*.jpg")))
        return Sequence(name, frames, "got10k_" + self.split, gt)


class TrackingNetDataset(BaseDataset):
    """TrackingNet TEST: frames/<seq>/<i>.jpg + anno/<seq>.txt."""

    def __init__(self):
        super().__init__()
        root = self.env_settings.trackingnet_dir
        self.base_path = os.path.join(root, "TEST") if root else ""
        anno_dir = os.path.join(self.base_path, "anno")
        self.sequence_name_list = sorted(
            os.path.splitext(os.path.basename(p))[0]
            for p in glob.glob(os.path.join(anno_dir, "*.txt"))) \
            if self.base_path else []

    def get_sequence_list(self):
        return SequenceList([self._construct_sequence(n) for n in self.sequence_name_list])

    def _construct_sequence(self, name):
        gt = load_text(os.path.join(self.base_path, "anno", name + ".txt"),
                       delimiter=(",", None))
        frame_dir = os.path.join(self.base_path, "frames", name)
        frames = [os.path.join(frame_dir, f"{i}.jpg") for i in range(gt.shape[0])]
        return Sequence(name, frames, "trackingnet", gt)


def _glob_frames(seq_path):
    for sub in ("img", "imgs", "."):
        fr = sorted(glob.glob(os.path.join(seq_path, sub, "*.jpg"))) or \
             sorted(glob.glob(os.path.join(seq_path, sub, "*.png")))
        if fr:
            return fr
    return []


def _table_sequence(base_path, row, dataset_name, delimiter):
    """Sequence from a benchmark-metadata row (otbdataset.py:23-36 logic:
    %0{nz}d frame paths over [start+initOmit, end], gt rows from initOmit)."""
    name, path, start, end, nz, ext, anno, cls, omit = row
    frames = [os.path.join(base_path, path, f"{i:0{nz}d}.{ext}")
              for i in range(start + omit, end + 1)]
    gt = load_text(os.path.join(base_path, anno), delimiter=delimiter)
    return Sequence(name, frames, dataset_name, gt[omit:],
                    object_class=cls or None)


def _table_mode(base_path, table):
    """Use the benchmark table iff the layout matches it (first anno file
    present); otherwise the adapter falls back to the generic glob layout."""
    return bool(base_path) and os.path.isfile(
        os.path.join(base_path, table[0][6]))


class _SimpleSeqDataset(BaseDataset):
    """Shared layout: <base>/<seq>/(img/)frames + a groundtruth txt."""
    dataset_name = ""
    gt_names = ("groundtruth_rect.txt", "groundtruth.txt")

    def __init__(self, base_path):
        super().__init__()
        self.base_path = base_path
        # an unconfigured ('') path must yield an empty dataset, not a CWD glob
        self.sequence_name_list = [os.path.basename(p) for p in sorted(
            glob.glob(os.path.join(self.base_path, "*"))) if os.path.isdir(p)] \
            if base_path else []

    def get_sequence_list(self):
        return SequenceList([self._construct_sequence(n) for n in self.sequence_name_list])

    def _construct_sequence(self, name):
        base = os.path.join(self.base_path, name)
        gt_path = next((os.path.join(base, g) for g in self.gt_names
                        if os.path.isfile(os.path.join(base, g))), None)
        gt = load_text(gt_path, delimiter=(",", "\t", " ", None))
        frames = _glob_frames(base)
        n = min(len(frames), gt.shape[0])
        return Sequence(name, frames[:n], self.dataset_name, gt[:n])


class _TableOrGlobDataset(_SimpleSeqDataset):
    """OTB/UAV123/NFS: the real benchmarks are defined by per-sequence
    metadata tables (frame ranges, initOmit offsets, per-sequence annotation
    files — several UAV123 'sequences' are SLICES of a shared image dir,
    e.g. person4_1/person4_2, and OTB has multi-object gt like Jogging-1/-2,
    which directory globbing cannot express). Table mode engages when the
    layout matches (_benchmark_tables.py); otherwise the generic
    <seq>/(img/)frames + groundtruth layout is used."""
    table = ()
    delimiter = (",", None)

    def __init__(self, base_path):
        self._table_mode = _table_mode(base_path, self.table)
        if self._table_mode:
            # BaseDataset.__init__ still applies (env_settings is an
            # invariant every eval dataset object carries)
            BaseDataset.__init__(self)
            self.base_path = base_path
            self.sequence_name_list = [r[0] for r in self.table]
        else:
            super().__init__(base_path)

    def _construct_sequence(self, name):
        if not self._table_mode:
            return super()._construct_sequence(name)
        row = next(r for r in self.table if r[0] == name)
        return _table_sequence(self.base_path, row, self.dataset_name,
                               self.delimiter)


class OTBDataset(_TableOrGlobDataset):
    dataset_name = "otb"

    def __init__(self):
        from multi_modal_tracking_torch.eval._benchmark_tables import OTB_SEQUENCES
        from multi_modal_tracking_torch.train.admin import env_settings
        self.table = OTB_SEQUENCES
        super().__init__(env_settings().otb_dir)


class UAVDataset(_TableOrGlobDataset):
    dataset_name = "uav"
    delimiter = (",",)

    def __init__(self):
        from multi_modal_tracking_torch.eval._benchmark_tables import UAV123_SEQUENCES
        from multi_modal_tracking_torch.train.admin import env_settings
        self.table = UAV123_SEQUENCES
        super().__init__(env_settings().uav_dir)


class NFSDataset(_TableOrGlobDataset):
    """NFS 30fps split (the reference table indexes the 30fps annotations)."""
    dataset_name = "nfs"
    delimiter = ("\t",)

    def __init__(self):
        from multi_modal_tracking_torch.eval._benchmark_tables import NFS_SEQUENCES
        from multi_modal_tracking_torch.train.admin import env_settings
        self.table = NFS_SEQUENCES
        super().__init__(env_settings().nfs_dir)


class TC128Dataset(_SimpleSeqDataset):
    """TC-128: <seq>/<seq>_gt.txt + <seq>_frames.txt (start,end) with
    img/%04d.jpg frame paths (tc128dataset.py:14-31); falls back to the
    generic layout when no *_gt.txt files are present. ce_only reproduces
    TC128CEDataset's '_ce in annotation filename' filter."""
    dataset_name = "tc128"

    def __init__(self, ce_only: bool = False):
        from multi_modal_tracking_torch.train.admin import env_settings
        base = env_settings().tc128_dir
        anno_files = sorted(glob.glob(os.path.join(base, "*", "*_gt.txt"))) \
            if base else []
        if ce_only:
            # the reference filters '_ce in full path' (tc128cedataset.py:17);
            # scope it to the sequence dir so base-path names can't match
            anno_files = [f for f in anno_files
                          if "_ce" in os.path.basename(os.path.dirname(f))]
        self._anno_files = anno_files
        if anno_files:
            BaseDataset.__init__(self)   # env_settings invariant
            self.base_path = base
            self.sequence_name_list = [os.path.basename(os.path.dirname(f))
                                       for f in anno_files]
        else:
            super().__init__(base)
            if ce_only:
                self.sequence_name_list = [n for n in self.sequence_name_list
                                           if "_ce" in n.lower() or
                                           n.lower().endswith("ce")]

    def _construct_sequence(self, name):
        if not self._anno_files:
            return super()._construct_sequence(name)
        anno = next(f for f in self._anno_files
                    if os.path.basename(os.path.dirname(f)) == name)
        seq_dir = os.path.dirname(anno)
        rng_files = glob.glob(os.path.join(seq_dir, "*_frames.txt"))
        if rng_files:
            start, end = np.loadtxt(rng_files[0], dtype=int,
                                    delimiter=",").reshape(-1)[:2]
            frames = [os.path.join(seq_dir, "img", f"{i:04d}.jpg")
                      for i in range(int(start), int(end) + 1)]
        else:
            # gt file present but no frames-range file: enumerate img/ directly
            img_dir = os.path.join(seq_dir, "img")
            if not os.path.isdir(img_dir):
                img_dir = seq_dir
            frames = sorted(
                glob.glob(os.path.join(img_dir, "*.jpg"))
                + glob.glob(os.path.join(img_dir, "*.png")))
        gt = load_text(anno, delimiter=(",", None)).reshape(-1, 4)
        return Sequence(name, frames, "tc128", gt)


class TNL2kDataset(_SimpleSeqDataset):
    dataset_name = "tnl2k"
    gt_names = ("groundtruth.txt", "groundtruth_rect.txt")

    def __init__(self):
        from multi_modal_tracking_torch.train.admin import env_settings
        root = env_settings().tnl2k_dir
        # unconfigured root must stay '' — os.path.join('', 'test') would be
        # the CWD-relative 'test' and could glob arbitrary local files
        sub = os.path.join(root, "test") if root else ""
        super().__init__(sub if sub and os.path.isdir(sub) else root)
