"""Tracker construction: script parameters -> model -> tracking loop."""
from __future__ import annotations

import torch

from multi_modal_tracking_torch.eval.params import TrackerParams, update_interval_for
from multi_modal_tracking_torch.models.build import build_model
from multi_modal_tracking_torch.tracking.tracker import RGBTCachedTracker


def create_tracker(params: TrackerParams, dataset_name: str = "", device="cuda",
                   dtype=torch.float32, seed: int = 0) -> RGBTCachedTracker:
    """The cached-template tracker of an RGB-T `asymmetric_shared*` script.

    Runs on the GPU unless device="cpu" (raises without one). With no
    checkpoint the weights are random from `seed`; loading a checkpoint is
    not ported yet. ce_keep_rate stays None, so each CE block uses its own
    configured keep ratio, as the reference tracker does.
    """
    if params.checkpoint:
        raise NotImplementedError("checkpoint loading is not ported yet "
                                  "(ROADMAP.md queue 1, item 10)")
    cfg = params.cfg
    model = build_model(params.script, cfg, device=device, dtype=dtype, seed=seed)
    return RGBTCachedTracker(model, template_factor=params.template_factor,
                             template_size=params.template_size,
                             search_factor=params.search_factor,
                             search_size=params.search_size,
                             update_interval=update_interval_for(cfg, dataset_name),
                             ce_keep_rate=None, device=device)
