"""Model registry: script name -> model, with seeded random weights."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from multi_modal_tracking_torch.models.asymmetric_shared import build_mixformer_rgbt
from multi_modal_tracking_torch.models.fusion import (DeformableAttentionFusion,
                                                      MSDeformAttnBimodal)
from multi_modal_tracking_torch.models.layers import set_compute_dtype
from multi_modal_tracking_torch.models.score_decoder import ScoreDecoder
from multi_modal_tracking_torch.utils.device import resolve_device, set_precision

_RGBT_SHARED = {
    "asymmetric_shared": dict(with_score=False),
    "asymmetric_shared_ce": dict(with_score=False),
    "asymmetric_shared_online": dict(with_score=True),
}


@torch.no_grad()
def init_random(model: nn.Module, seed: int) -> nn.Module:
    """Initialise every weight from one torch.Generator: xavier-uniform
    Linear weights, PyTorch's default fan-in uniform for convolutions, zero
    biases, unit/zero norms, the MSDA layers' own reference init and a
    unit-normal fusion level embed; the score branch's token from a normal
    of deviation 0.02 truncated at two deviations."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            nn.init.xavier_uniform_(m.weight, generator=g)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Conv2d):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            nn.init.uniform_(m.weight, -bound, bound, generator=g)
            if m.bias is not None:
                nn.init.uniform_(m.bias, -bound, bound, generator=g)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    for m in model.modules():
        if isinstance(m, MSDeformAttnBimodal):
            m.reset_parameters(g)
        elif isinstance(m, DeformableAttentionFusion):
            nn.init.normal_(m.level_embed, generator=g)
        elif isinstance(m, ScoreDecoder):
            nn.init.trunc_normal_(m.score_token, std=0.02, a=-0.04, b=0.04, generator=g)
    return model


def build_model(script: str, cfg, device="cuda", dtype=torch.float32,
                seed: int = 0, spec_overrides: Optional[dict] = None) -> nn.Module:
    """Build the model of an RGB-T `asymmetric_shared*` script with random
    float32 weights from `seed`, in eval mode on `device` (default: the
    GPU; raises if there is none), computing in `dtype` (float32 or
    bfloat16; others raise; `models.layers.set_compute_dtype`), with the
    precision flags of `utils.device.set_precision`. The parameters are
    float32 either way, as the JAX package's flax modules' are (param_dtype
    float32): a bfloat16 model trains on float32 master weights, and
    `eval.evaltracker.create_tracker` loads a checkpoint into them before
    it casts them for serving (`utils.checkpoint.cast_floating`).
    `spec_overrides` replace fields of the model spec read from `cfg`."""
    if script not in _RGBT_SHARED:
        raise NotImplementedError(f"script {script!r} is not ported to "
                                  f"multi_modal_tracking_torch (ROADMAP.md queue 1)")
    dev = resolve_device(device)
    set_precision(dtype)
    model = init_random(build_mixformer_rgbt(cfg, **_RGBT_SHARED[script],
                                             **(spec_overrides or {})), seed)
    return set_compute_dtype(model, dtype).to(dev).eval()
