"""Tracker construction: script parameters -> model -> tracking loop."""
from __future__ import annotations

import torch

from multi_modal_tracking_torch.eval.params import TrackerParams, update_interval_for
from multi_modal_tracking_torch.models.build import build_model
from multi_modal_tracking_torch.tracking.tracker import RGBTCachedTracker
from multi_modal_tracking_torch.utils.checkpoint import cast_floating, load_variables


def create_tracker(params: TrackerParams, dataset_name: str = "", device="cuda",
                   dtype=torch.bfloat16, seed: int = 0) -> RGBTCachedTracker:
    """The cached-template tracker of an RGB-T `asymmetric_shared*` script.

    Runs on the GPU unless device="cpu" (raises without one). With
    `params.checkpoint` set, its weights are loaded strictly (a `.pth.tar`
    of the port or the reference, or a JAX `.msgpack`): a checkpoint that
    does not cover the model raises. Without one the weights are random
    from `seed`. ce_keep_rate stays None, so each CE block uses its own
    configured keep ratio, as the reference tracker does.

    dtype=torch.bfloat16, the default as in the JAX package
    (eval/evaltracker.py:30), runs the model in bf16 in its order
    (eval/evaltracker.py:48-64): the float32 model is built and loaded
    first, then its parameters are cast (`cast_floating`; BatchNorm
    statistics stay float32). dtype=torch.float32 is the parity path.
    """
    cfg = params.cfg
    model = build_model(params.script, cfg, device=device, dtype=dtype, seed=seed)
    if params.checkpoint:
        load_variables(params.checkpoint, model, strict=True)
    if dtype != torch.float32:
        cast_floating(model, dtype)
    return RGBTCachedTracker(model, template_factor=params.template_factor,
                             template_size=params.template_size,
                             search_factor=params.search_factor,
                             search_size=params.search_size,
                             update_interval=update_interval_for(cfg, dataset_name),
                             ce_keep_rate=None, device=device)
