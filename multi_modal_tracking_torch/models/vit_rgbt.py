"""The RGB-T MixFormer-ViT variants: two-stream, shared-LN and
unibackbone (the JAX package's models/vit_rgbt.py).

Every variant takes the bimodal stacks of the flagship, (2B, H, W, 3) with
[:B] RGB and [B:] TIR, and returns its outputs:
  * two_stream (`mixformer_vit_rgbt`, `_online`): two ViTs, `backbone_v`
    on [:B] and `backbone_i` on [B:], each with plain mixed attention;
  * shared (`mixformer_vit_rgbt_shared`): one ViT over the whole stack
    whose blocks keep a LayerNorm pair per modality (`norm1_v`/`norm1_i`,
    `norm2_v`/`norm2_i`, the stack split by halves for them) and share the
    attention and MLP weights; no attention crosses the modalities;
  * unibackbone (`mixformer_vit_rgbt_unibackbone`): one plain ViT over the
    stack.
Then the fusion of the two search maps (any FUSION_CLASS), the corner head
on the fused map, and with the score branch (`_online`) the SPM reading the
fused map, the modalities' template maps side by side on the WIDTH axis
(models/vit_rgbt.py:195 there) and the box.

These models have no CE and no template cache: `ce_keep_rate` and
`use_ce_template_mask` are accepted and ignored, and the trackers run the
full forward every frame (`eval.evaltracker.create_tracker`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from multi_modal_tracking_torch.models.asymmetric_shared import RGBTSpec, _build_head
from multi_modal_tracking_torch.models.fusion import build_fusion
from multi_modal_tracking_torch.models.layers import DropPath, LayerNorm, Mlp
from multi_modal_tracking_torch.models.score_decoder import ScoreDecoder
from multi_modal_tracking_torch.models.vit import MixedAttention, MixFormerViT
from multi_modal_tracking_torch.ops.boxes import box_xyxy_to_cxcywh

VARIANTS = ("two_stream", "shared", "unibackbone")


class SharedLNBlock(nn.Module):
    """Block with modality-specific LayerNorms and modality-independent
    attention and MLP: the stack is split by halves for the norms and goes
    through the shared weights whole."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path: float = 0.0):
        super().__init__()
        self.dp1, self.dp2 = DropPath(drop_path), DropPath(drop_path)
        self.norm1_v = LayerNorm(dim, eps=1e-6)
        self.norm1_i = LayerNorm(dim, eps=1e-6)
        self.norm2_v = LayerNorm(dim, eps=1e-6)
        self.norm2_i = LayerNorm(dim, eps=1e-6)
        self.attn = MixedAttention(dim, num_heads, qkv_bias)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor, n_mt: int) -> torch.Tensor:
        """x: (2B, N, C), [:B] RGB, [B:] TIR."""
        B = x.shape[0] // 2
        n1 = torch.cat([self.norm1_v(x[:B]), self.norm1_i(x[B:])], dim=0)
        x = x + self.dp1(self.attn(n1, n_mt))
        n2 = torch.cat([self.norm2_v(x[:B]), self.norm2_i(x[B:])], dim=0)
        return x + self.dp2(self.mlp(n2))


class MixFormerViTRGBT(nn.Module):
    """Backbone of `variant` + fusion + corner head (+ the SPM score branch
    with `with_score`)."""

    def __init__(self, spec: RGBTSpec, variant: str = "two_stream", with_score: bool = False):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"variant {variant!r} (one of {VARIANTS})")
        sp = self.spec = spec
        self.variant, self.with_score = variant, with_score
        kw = dict(img_size_s=sp.search_size, img_size_t=sp.template_size,
                  embed_dim=sp.embed_dim, depth=sp.depth, num_heads=sp.num_heads,
                  drop_path_rate=sp.drop_path_rate)
        if variant == "two_stream":
            self.backbone_v = MixFormerViT(**kw)
            self.backbone_i = MixFormerViT(**kw)
        elif variant == "shared":
            self.backbone = MixFormerViT(block=SharedLNBlock, **kw)
        else:
            self.backbone = MixFormerViT(**kw)
        # the fusion's d_model is fixed at 512 for every recipe
        self.fusion_vi = build_fusion(sp.fusion_class, sp.embed_dim, 512, sp.fusion_layers,
                                      sp.fusion_dropout)
        self.box_head = _build_head(sp)
        if with_score:
            self.score_branch = ScoreDecoder(sp.num_heads, sp.embed_dim, sp.nlayer_head)

    def _backbone(self, t_vi, ot_vi, s_vi):
        if self.variant != "two_stream":
            return self.backbone(t_vi, ot_vi, s_vi)
        B = t_vi.shape[0] // 2
        v = self.backbone_v(t_vi[:B], ot_vi[:B], s_vi[:B])
        i = self.backbone_i(t_vi[B:], ot_vi[B:], s_vi[B:])
        return tuple(torch.cat([a, b], dim=0) for a, b in zip(v, i))

    def forward(self, t_vi, ot_vi, s_vi, ce_keep_rate: Optional[float] = None,
                use_ce_template_mask: bool = True, run_score_head: bool = False,
                gt_bboxes: Optional[torch.Tensor] = None, return_features: bool = False):
        """t_vi/ot_vi/s_vi: (2B, H, W, 3) bimodal stacks ([:B] RGB, [B:] TIR).
        Returns {'pred_boxes': (B, 1, 4) cxcywh in [0, 1]}, and with
        run_score_head (a model with the score branch) 'pred_scores' (B, 1,
        1) logits; gt_bboxes (B, 4) normalised xyxy replaces the predicted
        box the score branch pools. ce_keep_rate and use_ce_template_mask
        are ignored (no CE). return_features adds 'search_v', 'search_i'
        and 'search_fused', as the flagship's."""
        del ce_keep_rate, use_ce_template_mask
        t, _, s = self._backbone(t_vi, ot_vi, s_vi)
        B = s.shape[0] // 2
        fused = self.fusion_vi(s[:B], s[B:])
        box_xyxy = self.box_head(fused)
        out = {"pred_boxes": box_xyxy_to_cxcywh(box_xyxy).reshape(B, 1, 4)}
        if run_score_head and self.with_score:
            box = gt_bboxes if gt_bboxes is not None else box_xyxy.detach()
            out["pred_scores"] = self.score_branch(fused, torch.cat([t[:B], t[B:]], dim=2),
                                                   box.reshape(B, 4))
        if return_features:
            out["search_v"], out["search_i"], out["search_fused"] = s[:B], s[B:], fused
        return out


def build_vit_rgbt(cfg, variant: str = "two_stream", with_score: bool = False,
                   **spec_overrides) -> MixFormerViTRGBT:
    """The model of a config for a backbone variant, with the SPM score
    branch if `with_score`; `spec_overrides` replace fields of the spec read
    from it."""
    return MixFormerViTRGBT(dataclasses.replace(RGBTSpec.from_cfg(cfg), **spec_overrides),
                            variant, with_score)
