"""Evaluation dataset registry (the port's own copy of the JAX package's
`eval/datasets.py`): name -> (module, class, kwargs), resolved lazily.

Every name of the JAX registry is here: the file-based sets, RGB-T and
unimodal, whose frames the port's own decoder reads, and the in-memory
synthetic ones. A set whose path is not configured (`train/admin.py`) has
no sequences.
"""
from __future__ import annotations

import importlib
from collections import namedtuple

from multi_modal_tracking_torch.eval.data import SequenceList

DatasetInfo = namedtuple("DatasetInfo", ["module", "class_name", "kwargs"])

_BASE = "multi_modal_tracking_torch.eval."

dataset_dict = dict(
    # RGB-T / RGB-D
    lasher=DatasetInfo(_BASE + "datasets_rgbt", "LasHeRDataset", dict()),
    rgbt234=DatasetInfo(_BASE + "datasets_rgbt", "RGBT234Dataset", dict()),
    gtot=DatasetInfo(_BASE + "datasets_rgbt", "GTOTDataset", dict()),
    vtuav=DatasetInfo(_BASE + "datasets_rgbt", "VTUAVDataset", dict(split="all")),
    vtuav_short=DatasetInfo(_BASE + "datasets_rgbt", "VTUAVDataset", dict(split="short")),
    vtuav_long=DatasetInfo(_BASE + "datasets_rgbt", "VTUAVDataset", dict(split="long")),
    vtuav_train=DatasetInfo(_BASE + "datasets_rgbt", "VTUAVDataset",
                            dict(split="all", train_split=True)),
    depthtrack=DatasetInfo(_BASE + "datasets_rgbt", "DepthTrackDataset", dict()),
    synthetic_rgbt=DatasetInfo(_BASE + "datasets_rgbt", "SyntheticRGBTEvalDataset", dict()),
    synthetic_rgbt_hard=DatasetInfo(_BASE + "datasets_rgbt", "SyntheticRGBTHardEvalDataset",
                                    dict()),
    synthetic_rgb=DatasetInfo(_BASE + "datasets_rgbt", "SyntheticRGBEvalDataset", dict()),
    # unimodal
    lasot=DatasetInfo(_BASE + "datasets_rgb", "LaSOTDataset", dict()),
    lasot_lmdb=DatasetInfo(_BASE + "datasets_rgb", "LaSOTLmdbDataset", dict()),
    got10k_test=DatasetInfo(_BASE + "datasets_rgb", "GOT10kDataset", dict(split="test")),
    got10k_val=DatasetInfo(_BASE + "datasets_rgb", "GOT10kDataset", dict(split="val")),
    got10k_ltrval=DatasetInfo(_BASE + "datasets_rgb", "GOT10kDataset", dict(split="ltrval")),
    trackingnet=DatasetInfo(_BASE + "datasets_rgb", "TrackingNetDataset", dict()),
    otb=DatasetInfo(_BASE + "datasets_rgb", "OTBDataset", dict()),
    uav=DatasetInfo(_BASE + "datasets_rgb", "UAVDataset", dict()),
    nfs=DatasetInfo(_BASE + "datasets_rgb", "NFSDataset", dict()),
    tc128=DatasetInfo(_BASE + "datasets_rgb", "TC128Dataset", dict()),
    tc128ce=DatasetInfo(_BASE + "datasets_rgb", "TC128Dataset", dict(ce_only=True)),
    tnl2k=DatasetInfo(_BASE + "datasets_rgb", "TNL2kDataset", dict()),
)


def load_dataset(name: str, **overrides) -> SequenceList:
    name = name.lower()
    if name not in dataset_dict:
        raise ValueError(f"Unknown dataset '{name}'. Known: {sorted(dataset_dict)}")
    info = dataset_dict[name]
    mod = importlib.import_module(info.module)
    kwargs = dict(info.kwargs, **overrides)
    return getattr(mod, info.class_name)(**kwargs).get_sequence_list()


def get_dataset(*names: str, **overrides) -> SequenceList:
    """Concatenate one or more datasets by registry name."""
    out = SequenceList()
    for n in names:
        out.extend(load_dataset(n, **overrides))
    return out
