"""Model registry: script name -> model, with seeded random weights."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from multi_modal_tracking_torch.models.asymmetric_shared import build_mixformer_rgbt
from multi_modal_tracking_torch.models.convmae import build_mixformer_convmae
from multi_modal_tracking_torch.models.cvt import build_mixformer_cvt
from multi_modal_tracking_torch.models.fusion import (DeformableAttentionFusion,
                                                      DeformConvFusion, ModulatedDeformConv2d,
                                                      MSDeformAttnBimodal)
from multi_modal_tracking_torch.models.layers import set_compute_dtype, skip_default_init
from multi_modal_tracking_torch.models.mixformer import build_mixformer_vit
from multi_modal_tracking_torch.models.score_decoder import ScoreDecoder
from multi_modal_tracking_torch.models.vit_rgbt import build_vit_rgbt
from multi_modal_tracking_torch.utils.device import resolve_device, set_precision

_RGBT_SHARED = {
    "asymmetric_shared": dict(with_score=False),
    "asymmetric_shared_ce": dict(with_score=False),
    "asymmetric_shared_online": dict(with_score=True),
}
#: the RGB-T MixFormer-ViT scripts: backbone variant and score branch
_VIT_RGBT = {
    "mixformer_vit_rgbt": dict(variant="two_stream", with_score=False),
    "mixformer_vit_rgbt_online": dict(variant="two_stream", with_score=True),
    "mixformer_vit_rgbt_shared": dict(variant="shared", with_score=False),
    "mixformer_vit_rgbt_unibackbone": dict(variant="unibackbone", with_score=False),
}
#: the unimodal scripts and the function that builds each; `_online` means with
#: the score branch
_UNIMODAL = {
    "mixformer_vit": build_mixformer_vit,
    "mixformer_vit_online": build_mixformer_vit,
    "mixformer_cvt": build_mixformer_cvt,
    "mixformer_cvt_online": build_mixformer_cvt,
    "mixformer_convmae": build_mixformer_convmae,
    "mixformer_convmae_online": build_mixformer_convmae,
}
#: the RGB-T scripts build_model builds, then every one
RGBT_SCRIPTS = tuple(_RGBT_SHARED) + tuple(_VIT_RGBT)
SCRIPTS = RGBT_SCRIPTS + tuple(_UNIMODAL)


def is_rgbt_script(script: str) -> bool:
    """Whether `script` tracks RGB-T pairs (else one modality)."""
    return script in RGBT_SCRIPTS


def _he_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's he_normal: a normal of deviation sqrt(2 / fan_in) truncated at
    two deviations (variance scaling 2.0, fan_in, truncated_normal: the
    deviation divided by 0.8796..., that of the unit normal truncated at
    +-2); fan_in = Cin * kh * kw."""
    std = math.sqrt(2.0 / w[0].numel()) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


@torch.no_grad()
def init_random(model: nn.Module, seed: int) -> nn.Module:
    """Initialise every weight from one torch.Generator: xavier-uniform
    Linear weights, PyTorch's default fan-in uniform for convolutions, zero
    biases, unit/zero norms, the MSDA layers' own reference init and a
    unit-normal fusion level embed; the score branch's token from a normal
    of deviation 0.02 truncated at two deviations; the deform fusions'
    offset convolution zero and their deformable kernel he-normal (the
    JAX package's init, models/fusion.py:320-333)."""
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
        elif isinstance(m, ModulatedDeformConv2d):
            _he_normal_(m.weight, g)
        elif isinstance(m, DeformConvFusion):
            nn.init.zeros_(m.offset_conv.weight)
            nn.init.zeros_(m.offset_conv.bias)
    return model


def build_model(script: str, cfg, device="cuda", dtype=torch.float32,
                seed: int = 0, spec_overrides: Optional[dict] = None) -> nn.Module:
    """Build the model of a script (`SCRIPTS`: the `asymmetric_shared*`
    flagship family, the `mixformer_vit_rgbt*` family and the unimodal
    `mixformer_vit*`, `mixformer_cvt*` and `mixformer_convmae*`) with random
    float32 weights from `seed`, in eval mode on `device` (default: the
    GPU; raises if there is none), computing in `dtype` (float32 or
    bfloat16; others raise; `models.layers.set_compute_dtype`), with the
    precision flags of `utils.device.set_precision`. The parameters are
    float32 either way, as the JAX package's flax modules' are (param_dtype
    float32): a bfloat16 model trains on float32 master weights, and
    `eval.evaltracker.create_tracker` loads a checkpoint into them before
    it casts them for serving (`utils.checkpoint.cast_floating`).
    `spec_overrides` replace fields of the model spec read from `cfg`."""
    if script not in SCRIPTS:
        raise KeyError(f"unknown script {script}")
    dev = resolve_device(device)
    set_precision(dtype)
    with skip_default_init():                   # init_random sets every Linear and Conv2d
        if script in _RGBT_SHARED:
            model = build_mixformer_rgbt(cfg, **_RGBT_SHARED[script], **(spec_overrides or {}))
        elif script in _UNIMODAL:
            model = _UNIMODAL[script](cfg, with_score=script.endswith("_online"),
                                      **(spec_overrides or {}))
        else:
            model = build_vit_rgbt(cfg, **_VIT_RGBT[script], **(spec_overrides or {}))
    return set_compute_dtype(init_random(model, seed), dtype).to(dev).eval()
