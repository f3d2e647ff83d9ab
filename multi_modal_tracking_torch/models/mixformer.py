"""The unimodal MixFormer (the JAX package's models/mixformer.py): the ViT
backbone of models/vit.py, the corner head on its search map, and with
`with_score` the SPM score branch (`mixformer_vit_online`).

`forward` runs the backbone over [template; online template; search]
(kernel K1 in each block, K2 in training); `set_online` builds the
template cache and `forward_test` tracks the search tokens against it
(plain PyTorch attention, models/vit.py `_attend`). The cache is a dict
{"mem": [(k, v)] per block, "template": the template map, "key_mask": the
live cached keys}, the contract every family's cached trackers read.

The forward accepts `ce_keep_rate` and `use_ce_template_mask` and ignores
them (no CE), so the training step and the trackers call it as they call
the RGB-T models. Inputs are NHWC.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from multi_modal_tracking_torch.models.asymmetric_shared import RGBTSpec, _build_head
from multi_modal_tracking_torch.models.score_decoder import ScoreDecoder
from multi_modal_tracking_torch.models.vit import MixFormerViT
from multi_modal_tracking_torch.ops.boxes import box_xyxy_to_cxcywh


@dataclasses.dataclass(frozen=True)
class ViTSpec:
    """Model spec extracted from a CfgNode (models/mixformer.py:23-49 there)."""
    search_size: int = 288
    template_size: int = 128
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    head_type: str = "CORNER"
    head_dim: int = 384
    head_freeze_bn: bool = False
    drop_path_rate: float = 0.1
    nlayer_head: int = 3

    @staticmethod
    def from_cfg(cfg) -> "ViTSpec":
        dims = dict(base_patch16=(768, 12, 12), large_patch16=(1024, 24, 16))[cfg.MODEL.VIT_TYPE]
        return ViTSpec(
            search_size=cfg.DATA.SEARCH.SIZE, template_size=cfg.DATA.TEMPLATE.SIZE,
            embed_dim=dims[0], depth=dims[1], num_heads=dims[2],
            head_type=cfg.MODEL.HEAD_TYPE, head_dim=cfg.MODEL.get("HEAD_DIM", 384),
            head_freeze_bn=cfg.MODEL.get("HEAD_FREEZE_BN", False),
            nlayer_head=cfg.MODEL.get("NLAYER_HEAD", 3))

    def as_rgbt(self) -> RGBTSpec:
        """The fields the corner head reads, as the RGB-T spec it builds from."""
        return RGBTSpec(search_size=self.search_size, template_size=self.template_size,
                        embed_dim=self.embed_dim, head_type=self.head_type,
                        head_dim=self.head_dim, head_freeze_bn=self.head_freeze_bn)


class MixFormer(nn.Module):
    """Unimodal tracker model: (template, online template, search) NHWC
    images -> boxes (+ score logits)."""

    def __init__(self, spec: ViTSpec, with_score: bool = False):
        super().__init__()
        sp = self.spec = spec
        self.with_score = with_score
        self.backbone = MixFormerViT(img_size_s=sp.search_size, img_size_t=sp.template_size,
                                     embed_dim=sp.embed_dim, depth=sp.depth,
                                     num_heads=sp.num_heads, drop_path_rate=sp.drop_path_rate)
        self.box_head = _build_head(sp.as_rgbt())
        if with_score:
            self.score_branch = ScoreDecoder(sp.num_heads, sp.embed_dim, sp.nlayer_head)

    def _head(self, s: torch.Tensor, t: torch.Tensor, run_score_head: bool,
              gt_bboxes: Optional[torch.Tensor] = None) -> dict:
        B = s.shape[0]
        box_xyxy = self.box_head(s)
        out = {"pred_boxes": box_xyxy_to_cxcywh(box_xyxy).reshape(B, 1, 4)}
        if run_score_head and self.with_score:
            box = gt_bboxes if gt_bboxes is not None else box_xyxy.detach()
            out["pred_scores"] = self.score_branch(s, t, box.reshape(B, 4))
        return out

    def forward(self, template, online_template, search, ce_keep_rate: Optional[float] = None,
                use_ce_template_mask: bool = True, run_score_head: bool = False,
                gt_bboxes: Optional[torch.Tensor] = None) -> dict:
        """(B, H, W, 3) images -> {'pred_boxes': (B, 1, 4) cxcywh in [0, 1]},
        and with run_score_head (a model with the score branch)
        'pred_scores' (B, 1, 1) logits; gt_bboxes (B, 4) normalised xyxy
        replaces the predicted box the score branch pools."""
        del ce_keep_rate, use_ce_template_mask
        t, _, s = self.backbone(template, online_template, search)
        return self._head(s, t, run_score_head, gt_bboxes)

    def set_online(self, template, online_template, slot_mask: Optional[torch.Tensor] = None):
        """The template cache of `template` (B, Ht, Wt, 3) and its online
        templates (B * n_ot, ...; `MixFormerViT.set_online`): {"mem",
        "template", "key_mask"}; without `slot_mask` the key mask is all
        ones over the cached tokens."""
        t, mem, key_mask = self.backbone.set_online(template, online_template, slot_mask)
        if key_mask is None:
            n = online_template.shape[0] // template.shape[0]
            key_mask = t.new_ones((t.shape[1] * t.shape[2] * (1 + n),), dtype=torch.float32)
        return {"mem": mem, "template": t, "key_mask": key_mask}

    def forward_test(self, search, cache: dict, run_score_head: bool = False) -> dict:
        """The search images against a `set_online` cache: the outputs of
        `forward`; the score branch reads the cache's template map."""
        s = self.backbone.forward_test(search, cache["mem"], cache["key_mask"])
        return self._head(s, cache["template"], run_score_head)


def build_mixformer_vit(cfg, with_score: bool = False, **spec_overrides) -> MixFormer:
    """The unimodal model of a config, with the SPM score branch if
    `with_score`; `spec_overrides` replace fields of the spec read from it."""
    return MixFormer(dataclasses.replace(ViTSpec.from_cfg(cfg), **spec_overrides), with_score)
