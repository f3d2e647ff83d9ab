"""Evaluation dataset registry (the port's own copy of the JAX package's
`eval/datasets.py`): name -> (module, class, kwargs), resolved lazily.

Every name of the JAX registry is here. The in-memory synthetic sets load
(RGB-T, and the unimodal `synthetic_rgb`); the file-based sets, RGB-T and
unimodal, need an image decoder (ROADMAP.md queue 1 item 1), so loading
one of those raises NotImplementedError instead of returning an empty set.
"""
from __future__ import annotations

import importlib
from collections import namedtuple

from multi_modal_tracking_torch.eval.data import SequenceList

DatasetInfo = namedtuple("DatasetInfo", ["module", "class_name", "kwargs"])

_BASE = "multi_modal_tracking_torch.eval."
_FILES = "file-based: it needs an image decoder (ROADMAP.md queue 1 item 1)"

dataset_dict = dict(
    synthetic_rgbt=DatasetInfo(_BASE + "datasets_rgbt", "SyntheticRGBTEvalDataset", dict()),
    synthetic_rgbt_hard=DatasetInfo(_BASE + "datasets_rgbt", "SyntheticRGBTHardEvalDataset",
                                    dict()),
    synthetic_rgb=DatasetInfo(_BASE + "datasets_rgbt", "SyntheticRGBEvalDataset", dict()),
)

#: registry names of the JAX package that the port does not load yet, with why
pending = {name: _FILES for name in (
    "lasher", "rgbt234", "gtot", "vtuav", "vtuav_short", "vtuav_long", "vtuav_train",
    "depthtrack", "lasot", "lasot_lmdb", "got10k_test", "got10k_val", "got10k_ltrval",
    "trackingnet", "otb", "uav", "nfs", "tc128", "tc128ce", "tnl2k")}


def load_dataset(name: str, **overrides) -> SequenceList:
    name = name.lower()
    if name in pending:
        raise NotImplementedError(f"dataset '{name}' is not ported: {pending[name]}")
    if name not in dataset_dict:
        raise ValueError(f"Unknown dataset '{name}'. Known: "
                         f"{sorted(set(dataset_dict) | set(pending))}")
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
