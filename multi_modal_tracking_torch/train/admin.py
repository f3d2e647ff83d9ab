"""Local paths of datasets and outputs.

The port's own copy of the JAX package's `train/admin.py`: one JSON file
(default `<repo>/local_paths.json`, or the path in MMT_LOCAL_PATHS) holds
the train and eval paths; `create_default_local_file()` writes a stub, and
`EnvSettings.require` raises with instructions when a path is missing.
"""
from __future__ import annotations

import json
import os
from typing import Optional

_DEFAULT_KEYS = [
    "workspace_dir", "save_dir", "tensorboard_dir", "checkpoints_dir",
    "results_path",
    "lasher_dir", "rgbt234_dir", "vtuav_dir", "gtot_dir", "kaist_dir",
    "llvip_dir", "m3fd_dir", "depthtrack_dir",
    "lasot_dir", "got10k_dir", "trackingnet_dir", "coco_dir", "imagenet_dir",
    "tnl2k_dir", "otb_dir", "nfs_dir", "uav_dir", "tc128_dir",
    "lasot_lmdb_dir", "got10k_lmdb_dir", "trackingnet_lmdb_dir",
    "coco_lmdb_dir", "imagenet_lmdb_dir",
]


def _settings_file() -> str:
    return os.environ.get(
        "MMT_LOCAL_PATHS",
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "local_paths.json"))


def create_default_local_file(workspace_dir: str = ".", data_dir: str = "./data",
                              save_dir: str = "./output", path: Optional[str] = None) -> str:
    out = {k: "" for k in _DEFAULT_KEYS}
    out["workspace_dir"] = workspace_dir
    out["save_dir"] = save_dir          # where get_parameters(model=...) looks
    out["tensorboard_dir"] = os.path.join(save_dir, "tensorboard")
    out["checkpoints_dir"] = os.path.join(save_dir, "checkpoints")
    out["results_path"] = os.path.join(save_dir, "test/tracking_results")
    for k in _DEFAULT_KEYS:
        if k.endswith("_dir") and not out[k]:
            out[k] = os.path.join(data_dir, k[:-4])
    p = path or _settings_file()
    with open(p, "w") as f:
        json.dump(out, f, indent=2)
    return p


class EnvSettings:
    def __init__(self, d: dict):
        for k in _DEFAULT_KEYS:
            # `or ""` also turns an explicit null into "" (os.path.join of
            # None would raise a TypeError far from the cause)
            setattr(self, k, d.get(k, "") or "")

    def require(self, key: str) -> str:
        v = getattr(self, key, "")
        if not v or not os.path.exists(v):
            raise RuntimeError(
                f"Dataset path '{key}' not configured or missing ({v!r}). Run "
                f"multi_modal_tracking_torch.train.admin.create_default_local_file() "
                f"and edit {_settings_file()}.")
        return v


def env_settings() -> EnvSettings:
    p = _settings_file()
    if not os.path.exists(p):
        return EnvSettings({})
    with open(p) as f:
        return EnvSettings(json.load(f))
