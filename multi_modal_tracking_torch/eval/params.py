"""Tracking-time parameter resolution for the RGB-T scripts.

The port's own copy of the JAX package's `eval/params.py`: load the
script's default config, overlay the training experiment YAML, then the
tracking YAML (`experiments/tracking.yaml`: search factor, per-dataset
update intervals).
"""
from __future__ import annotations

import os
from typing import Optional

from multi_modal_tracking_torch.config import get_default_config


class TrackerParams:
    """Attribute bag of tracking parameters."""

    def get(self, name: str, *default):
        if len(default) > 1:
            raise ValueError("Can only give one default value.")
        if not default:
            return getattr(self, name)
        return getattr(self, name, default[0])


def _experiments_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "experiments")


def get_parameters(script: str, training_yaml: Optional[str] = None,
                   tracking_yaml: Optional[str] = "tracking",
                   checkpoint: Optional[str] = None,
                   search_area_scale: Optional[float] = None) -> TrackerParams:
    params = TrackerParams()
    cfg = get_default_config(script)
    exp = _experiments_dir()
    if training_yaml:
        cfg.update_from_file(os.path.join(exp, script, f"{training_yaml}.yaml"))
    if tracking_yaml:
        path = os.path.join(exp, f"{tracking_yaml}.yaml")
        if os.path.isfile(path):
            cfg.update_from_file(path)
    params.cfg = cfg
    params.script = script
    params.template_factor = cfg.TEST.TEMPLATE_FACTOR
    params.template_size = cfg.TEST.TEMPLATE_SIZE
    params.search_factor = (search_area_scale if search_area_scale is not None
                            else cfg.TEST.SEARCH_FACTOR)
    params.search_size = cfg.TEST.SEARCH_SIZE
    params.checkpoint = checkpoint
    return params


def update_interval_for(cfg, dataset_name: str, default: int = 200) -> int:
    """Per-dataset template update interval (experiments/tracking.yaml).

    Falls back to cfg.DATA.MAX_SAMPLE_INTERVAL when the dataset has no
    entry. tracking.yaml sets that to 10**18, meaning "never update"; the
    value is clamped to the int32 maximum like the JAX package does, so both
    packages update on the same frames.
    """
    iv = cfg.TEST.UPDATE_INTERVALS.get(dataset_name.upper())
    if iv is None:
        iv = cfg.DATA.get("MAX_SAMPLE_INTERVAL")
    if iv is None:
        return default
    iv = int(iv[0]) if isinstance(iv, (list, tuple)) else int(iv)
    return min(iv, 2**31 - 1)
