"""Tracker construction: script parameters -> model -> tracking loop."""
from __future__ import annotations

import torch

from multi_modal_tracking_torch.eval.params import TrackerParams, update_interval_for
from multi_modal_tracking_torch.models.build import build_model
from multi_modal_tracking_torch.tracking.tracker import (RGBTCachedTracker,
                                                         RGBTOnlineCachedTracker, RGBTTracker)
from multi_modal_tracking_torch.utils.checkpoint import cast_floating, load_variables


def create_tracker(params: TrackerParams, dataset_name: str = "", device="cuda",
                   dtype=torch.bfloat16, seed: int = 0, graphs: bool = True) -> RGBTTracker:
    """The cached-template tracker of an RGB-T `asymmetric_shared*` script:
    for an online one (`*_online`, with the SPM score branch) the
    score-gated `RGBTOnlineCachedTracker`, its max_score_decay from
    `online_size_decay`.

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

    On the GPU the tracker runs each frame as a CUDA graph replay;
    graphs=False runs the same step eager (tracking/graphs.py).
    """
    cfg = params.cfg
    model = build_model(params.script, cfg, device=device, dtype=dtype, seed=seed)
    if params.checkpoint:
        load_variables(params.checkpoint, model, strict=True)
    if dtype != torch.float32:
        cast_floating(model, dtype)
    common = dict(template_factor=params.template_factor, template_size=params.template_size,
                  search_factor=params.search_factor, search_size=params.search_size,
                  update_interval=update_interval_for(cfg, dataset_name), ce_keep_rate=None,
                  device=device, graphs=graphs)
    if params.script.endswith("_online"):
        return RGBTOnlineCachedTracker(model, max_score_decay=online_size_decay(cfg)[1],
                                       **common)
    return RGBTCachedTracker(model, **common)


def online_size_decay(cfg, dataset_name: str = "") -> tuple:
    """(online template memory size, max-score decay) of a dataset: a
    dataset listed in TEST.ONLINE_SIZES takes its first entry, others 3, as
    the reference trackers do; the decay is TEST.MAX_SCORE_DECAY, else 1.0.
    The RGB-T online trackers keep one online template and use the decay
    alone."""
    size = 3
    sizes = cfg.TEST.get("ONLINE_SIZES", None)
    if sizes is not None:
        v = sizes.get(dataset_name.upper()) if hasattr(sizes, "get") else None
        if v is not None:
            size = v[0] if isinstance(v, (list, tuple)) else int(v)
    return size, float(cfg.TEST.get("MAX_SCORE_DECAY", 1.0))
