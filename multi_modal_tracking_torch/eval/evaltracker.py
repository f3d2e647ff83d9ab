"""Tracker construction: script parameters -> model -> tracking loop."""
from __future__ import annotations

import torch

from multi_modal_tracking_torch.eval.params import TrackerParams, update_interval_for
from multi_modal_tracking_torch.models.build import build_model, is_rgbt_script
from multi_modal_tracking_torch.tracking.tracker import (OnlineTracker, RGBCachedTracker,
                                                         RGBTCachedTracker,
                                                         RGBTOnlineCachedTracker,
                                                         RGBTOnlineTracker, RGBTracker,
                                                         RGBTTracker)
from multi_modal_tracking_torch.utils.checkpoint import cast_floating, load_variables


def create_tracker(params: TrackerParams, dataset_name: str = "", device="cuda",
                   dtype=torch.bfloat16, seed: int = 0, graphs: bool = True,
                   mode: str = "RGBT") -> RGBTTracker:
    """The tracker of a script, chosen as the JAX package chooses
    (eval/evaltracker.py:89-112).

    An RGB-T script: the cached-template trackers for a model with
    `set_online` and `forward_track` (the `asymmetric_shared*` family),
    else the full-forward ones (the `mixformer_vit_rgbt*` family); for an
    online script (`*_online`, with the SPM score branch) the score-gated
    one (`RGBTOnlineCachedTracker` or `RGBTOnlineTracker`), its
    max_score_decay from `online_size_decay`. `mode` is ignored.

    A unimodal script (`mixformer_vit*`): `mode` is RGB, TIR or Prompt (the
    bimodal default "RGBT" means RGB); an online script gets
    `OnlineTracker` with the dataset's online size and the decay
    (`online_size_decay`), a model with `set_online` and `forward_test`
    `RGBCachedTracker`, any other `RGBTracker`.

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
                  update_interval=update_interval_for(cfg, dataset_name), device=device,
                  graphs=graphs)
    online = params.script.endswith("_online")
    if is_rgbt_script(params.script):
        cached = hasattr(type(model), "set_online") and hasattr(type(model), "forward_track")
        if online:
            cls = RGBTOnlineCachedTracker if cached else RGBTOnlineTracker
            return cls(model, max_score_decay=online_size_decay(cfg)[1], ce_keep_rate=None,
                       **common)
        return (RGBTCachedTracker if cached else RGBTTracker)(model, ce_keep_rate=None, **common)
    mode = "RGB" if mode == "RGBT" else mode
    if online:
        size, decay = online_size_decay(cfg, dataset_name)
        return OnlineTracker(model, online_size=size, max_score_decay=decay, mode=mode, **common)
    cached = hasattr(type(model), "set_online") and hasattr(type(model), "forward_test")
    return (RGBCachedTracker if cached else RGBTracker)(model, mode=mode, **common)


def online_size_decay(cfg, dataset_name: str = "") -> tuple:
    """(online template memory size, max-score decay) of a dataset: a
    dataset listed in TEST.ONLINE_SIZES takes its first entry, others 3, as
    the reference trackers do; the decay is TEST.MAX_SCORE_DECAY, else 1.0.
    The RGB-T online trackers keep one online template and use the decay
    alone; the unimodal online tracker keeps `size` of them."""
    size = 3
    sizes = cfg.TEST.get("ONLINE_SIZES", None)
    if sizes is not None:
        v = sizes.get(dataset_name.upper()) if hasattr(sizes, "get") else None
        if v is not None:
            size = v[0] if isinstance(v, (list, tuple)) else int(v)
    return size, float(cfg.TEST.get("MAX_SCORE_DECAY", 1.0))
