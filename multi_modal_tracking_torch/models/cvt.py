"""MixFormer-CvT (the JAX package's models/cvt.py): three convolutional
vision-transformer stages of Mixed Attention Modules (MAM), the CORNER head
on the last search map, and with `with_score` the SPM score branch
(`mixformer_cvt_online`).

A stage embeds its input maps with a strided convolution and a token
LayerNorm (eps 1e-5), then runs MAM blocks over [templates; search]
tokens. A MAM projects q through a depthwise 3x3 convolution at stride 1
and k and v at stride 2 (padding 1: ceil(h / 2) per side), each followed
by a BatchNorm and a Linear, on each crop's own map, so that no convolution
reads across a border. The BatchNorm is frozen (`FREEZE_BN`, as every recipe
sets) or, with `FREEZE_BN` false, flax's trainable `nn.BatchNorm` (momentum
0.9, eps 1e-5, the biased batch variance; `models/layers.py BatchNorm2d`):
in training each crop's map is normalised by its own batch statistics and
updates the running ones, template, online template, then search, as the
JAX model calls it on each map in turn. Template
queries attend to the strided template keys only, search queries to [the
template keys; the search keys]. The attention scales by the full width
(`dim ** -0.5`), not the head width, and runs through the plain `_attend`
of models/vit.py (an XLA einsum in the JAX package, no Pallas kernel, so
no hand-written kernel here: queries and keys have different lengths).
The MLP is QuickGELU's; drop path rates rise linearly within each stage.

Templates travel as one batch of maps (B * n, h, w, C), each stream's n
templates in turn: n = 2 (template, online template) in the forward, 1 +
the ring's size in `set_online`. Their tokens are one sequence per stream.
The convolutions run channels-last: a (B, h, w, C) token map permuted to
NCHW is that layout, and the projections' outputs flatten back to tokens
without a copy.

The cached path of the trackers: `set_online(template, ring, slot_mask)`
attends over the template and the ring and keeps each block's k and v
(per stage, per block), `forward_test` runs the search tokens against
them. The slot mask ((n,) or (N, n) for N streams, 0/1) hides the unfilled
ring slots; each stage derives its own key mask from it, because its
strided template length differs (256, 64 and 16 keys a template at 128).
The cache is {"mem": [stage][block] (k, v), "template": the last template
map, "slot_mask"}. Inputs are NHWC.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from multi_modal_tracking_torch.models.heads import CornerPredictor
from multi_modal_tracking_torch.models.layers import (BatchNorm2d, Conv2d, DropPath,
                                                      FrozenBatchNorm2d, LayerNorm, Linear,
                                                      _heads, _merge)
from multi_modal_tracking_torch.models.score_decoder import ScoreDecoder
from multi_modal_tracking_torch.models.vit import _attend
from multi_modal_tracking_torch.ops.boxes import box_cxcywh_to_xyxy, box_xyxy_to_cxcywh


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """(B, h, w, C) -> its NCHW view (channels-last)."""
    return x.permute(0, 3, 1, 2)


def _slot_key_mask(slot_mask: torch.Tensor, length: int) -> torch.Tensor:
    """[the template's `length` keys live; each slot's `length` keys gated
    by slot_mask] ((n,) -> (length * (1 + n),); (N, n) -> (N, ...))."""
    slots = slot_mask.float().repeat_interleave(length, dim=-1)
    return torch.cat([slots.new_ones(slots.shape[:-1] + (length,)), slots], dim=-1)


class ConvProj(nn.Module):
    """Depthwise conv + BatchNorm ('dw_bn'): NCHW maps -> (B, h'w', C)
    tokens. The BN is frozen, or trainable with `freeze_bn` False."""

    def __init__(self, dim: int, kernel: int = 3, stride: int = 1, padding: int = 1,
                 freeze_bn: bool = True):
        super().__init__()
        self.conv = Conv2d(dim, dim, kernel, stride, padding, groups=dim, bias=False)
        self.bn = FrozenBatchNorm2d(dim) if freeze_bn else BatchNorm2d(dim, eps=1e-5)

    def forward(self, x: torch.Tensor, n: int = 1) -> torch.Tensor:
        """x: (B * n, C, h, w), each stream's n maps in turn. A trainable BN
        in training normalises the n kinds of map apart (the JAX model's
        one call per crop), in their order."""
        x = self.conv(x)
        if n > 1 and self.bn.training and isinstance(self.bn, BatchNorm2d):
            maps = x.unflatten(0, (-1, n))
            x = torch.stack([self.bn(maps[:, j]) for j in range(n)], dim=1).flatten(0, 1)
        else:
            x = self.bn(x)
        return x.flatten(2).transpose(1, 2)


class ConvEmbed(nn.Module):
    """Strided conv patch embedding + token LayerNorm: NHWC -> NHWC."""

    def __init__(self, in_chans: int, embed_dim: int, patch_size: int, stride: int,
                 padding: int):
        super().__init__()
        self.proj = Conv2d(in_chans, embed_dim, patch_size, stride, padding)
        self.norm = LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.proj(_nchw(x)).permute(0, 2, 3, 1))


class MAMAttention(nn.Module):
    """Mixed Attention Module (models/cvt.py:128-223 there)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True, kernel: int = 3,
                 stride_kv: int = 2, freeze_bn: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.conv_proj_q = ConvProj(dim, kernel, 1, 1, freeze_bn)
        self.conv_proj_k = ConvProj(dim, kernel, stride_kv, 1, freeze_bn)
        self.conv_proj_v = ConvProj(dim, kernel, stride_kv, 1, freeze_bn)
        self.proj_q = Linear(dim, dim, bias=qkv_bias)
        self.proj_k = Linear(dim, dim, bias=qkv_bias)
        self.proj_v = Linear(dim, dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)
        # the full width, not the head width (mixformer_cvt/mixformer.py:80)
        self.scale = dim ** -0.5

    def _qkv(self, maps: torch.Tensor, n: int) -> Tuple[torch.Tensor, ...]:
        """(B * n, C, h, w) maps -> q, k, v (B, H, n * L, D), each stream's n
        maps' tokens in turn."""
        out = []
        for conv, lin in ((self.conv_proj_q, self.proj_q), (self.conv_proj_k, self.proj_k),
                          (self.conv_proj_v, self.proj_v)):
            x = lin(conv(maps, n))
            out.append(_heads(x.reshape(-1, n * x.shape[1], x.shape[2]), self.num_heads))
        return tuple(out)

    def forward(self, mt: torch.Tensor, s: torch.Tensor, n: int):
        """mt: (B * n, C, h, w) template maps, s: (B, C, hs, ws). Returns
        (templates' tokens (B, n*h*w, C), search tokens (B, hs*ws, C))."""
        q_mt, k_mt, v_mt = self._qkv(mt, n)
        q_s, k_s, v_s = self._qkv(s, 1)
        x_mt = _attend(q_mt, k_mt, v_mt, self.scale)
        x_s = _attend(q_s, torch.cat([k_mt, k_s], dim=2), torch.cat([v_mt, v_s], dim=2),
                      self.scale)
        return self.proj(_merge(x_mt)), self.proj(_merge(x_s))

    def set_online(self, mt: torch.Tensor, n: int, slot_mask: torch.Tensor):
        """Self-attention over a stream's n = 1 + ring maps, the ring's
        masked slots invisible: (out (B, n*h*w, C), (k, v))."""
        q, k, v = self._qkv(mt, n)
        mask = _slot_key_mask(slot_mask, k.shape[2] // n)
        return self.proj(_merge(_attend(q, k, v, self.scale, mask))), (k, v)

    def forward_test(self, s: torch.Tensor, mem, slot_mask: torch.Tensor) -> torch.Tensor:
        """Search maps (B, C, hs, ws) against the cached k and v."""
        q, k_s, v_s = self._qkv(s, 1)
        k_mem, v_mem = mem
        k = torch.cat([k_mem.to(k_s.dtype), k_s], dim=2)
        v = torch.cat([v_mem.to(v_s.dtype), v_s], dim=2)
        mask = _slot_key_mask(slot_mask, k_mem.shape[2] // (1 + slot_mask.shape[-1]))
        mask = torch.cat([mask, mask.new_ones(mask.shape[:-1] + (k_s.shape[2],))], dim=-1)
        return self.proj(_merge(_attend(q, k, v, self.scale, mask)))


class CvTMlp(nn.Module):
    """Linear -> QuickGELU -> Linear."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


def _maps(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, n*h*w, C) tokens -> (B * n, C, h, w) channels-last maps."""
    return _nchw(x.reshape(-1, h, w, x.shape[-1]))


class MAMBlock(nn.Module):
    """Pre-LN block around MAM attention (eps 1e-5)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path: float = 0.0, stride_kv: int = 2, freeze_bn: bool = True):
        super().__init__()
        self.dp1, self.dp2 = DropPath(drop_path), DropPath(drop_path)
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = MAMAttention(dim, num_heads, qkv_bias, stride_kv=stride_kv,
                                 freeze_bn=freeze_bn)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = CvTMlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, n: int, t_hw: tuple, s_hw: tuple) -> torch.Tensor:
        """x: (B, n*t_h*t_w + s_h*s_w, C)."""
        m = n * t_hw[0] * t_hw[1]
        xn = self.norm1(x)
        out_mt, out_s = self.attn(_maps(xn[:, :m], *t_hw), _maps(xn[:, m:], *s_hw), n)
        x = x + self.dp1(torch.cat([out_mt, out_s], dim=1))
        return x + self.dp2(self.mlp(self.norm2(x)))

    def set_online(self, x: torch.Tensor, n: int, t_hw: tuple, slot_mask: torch.Tensor):
        out, mem = self.attn.set_online(_maps(self.norm1(x), *t_hw), n, slot_mask)
        x = x + out
        return x + self.mlp(self.norm2(x)), mem

    def forward_test(self, x: torch.Tensor, s_hw: tuple, mem, slot_mask: torch.Tensor):
        x = x + self.attn.forward_test(_maps(self.norm1(x), *s_hw), mem, slot_mask)
        return x + self.mlp(self.norm2(x))


class CvTStage(nn.Module):
    """One conv-ViT stage: ConvEmbed, then MAM blocks with drop path rates
    linspace(0, drop_path_rate, depth)."""

    def __init__(self, in_chans: int, embed_dim: int, depth: int, num_heads: int,
                 patch_size: int, patch_stride: int, patch_padding: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path_rate: float = 0.0, stride_kv: int = 2,
                 freeze_bn: bool = True):
        super().__init__()
        self.patch_embed = ConvEmbed(in_chans, embed_dim, patch_size, patch_stride,
                                     patch_padding)
        dpr = [float(r) for r in np.linspace(0, drop_path_rate, depth)]
        self.blocks = nn.ModuleList(
            MAMBlock(embed_dim, num_heads, mlp_ratio, qkv_bias, dpr[j], stride_kv, freeze_bn)
            for j in range(depth))

    def forward(self, mt: torch.Tensor, s: torch.Tensor, n: int):
        """mt: (B * n, H, W, Cin) template maps, s: (B, Hs, Ws, Cin), NHWC ->
        the same at this stage's width and size."""
        mt, s = self.patch_embed(mt), self.patch_embed(s)
        _, h, w, C = mt.shape
        B, hs, ws, _ = s.shape
        m = n * h * w
        x = torch.cat([mt.reshape(B, m, C), s.reshape(B, hs * ws, C)], dim=1)
        for blk in self.blocks:
            x = blk(x, n, (h, w), (hs, ws))
        return x[:, :m].reshape(B * n, h, w, C), x[:, m:].reshape(B, hs, ws, C)

    def set_online(self, mt: torch.Tensor, n: int, slot_mask: torch.Tensor):
        mt = self.patch_embed(mt)
        Bn, h, w, C = mt.shape
        x = mt.reshape(Bn // n, n * h * w, C)
        mem = []
        for blk in self.blocks:
            x, m = blk.set_online(x, n, (h, w), slot_mask)
            mem.append(m)
        return x.reshape(Bn, h, w, C), mem

    def forward_test(self, s: torch.Tensor, mem, slot_mask: torch.Tensor) -> torch.Tensor:
        s = self.patch_embed(s)
        B, hs, ws, C = s.shape
        x = s.reshape(B, hs * ws, C)
        for blk, m in zip(self.blocks, mem):
            x = blk.forward_test(x, (hs, ws), m, slot_mask)
        return x.reshape(B, hs, ws, C)


@dataclasses.dataclass(frozen=True)
class CvTSpec:
    """Model spec extracted from a CfgNode (models/cvt.py:338-395 there)."""
    search_size: int = 320
    template_size: int = 128
    num_stages: int = 3
    patch_size: Tuple[int, ...] = (7, 3, 3)
    patch_stride: Tuple[int, ...] = (4, 2, 2)
    patch_padding: Tuple[int, ...] = (2, 1, 1)
    dim_embed: Tuple[int, ...] = (64, 192, 384)
    num_heads: Tuple[int, ...] = (1, 3, 6)
    depth: Tuple[int, ...] = (1, 4, 16)
    mlp_ratio: Tuple[float, ...] = (4.0, 4.0, 4.0)
    qkv_bias: Tuple[bool, ...] = (True, True, True)
    drop_path_rate: Tuple[float, ...] = (0.0, 0.0, 0.1)
    stride_kv: Tuple[int, ...] = (2, 2, 2)
    freeze_bn: bool = True
    head_type: str = "CORNER"
    head_dim: int = 384
    head_freeze_bn: bool = False
    nlayer_head: int = 3

    @staticmethod
    def from_cfg(cfg) -> "CvTSpec":
        bb = cfg.MODEL.BACKBONE
        return CvTSpec(
            search_size=cfg.DATA.SEARCH.SIZE, template_size=cfg.DATA.TEMPLATE.SIZE,
            num_stages=bb.NUM_STAGES, patch_size=tuple(bb.PATCH_SIZE),
            patch_stride=tuple(bb.PATCH_STRIDE), patch_padding=tuple(bb.PATCH_PADDING),
            dim_embed=tuple(bb.DIM_EMBED), num_heads=tuple(bb.NUM_HEADS),
            depth=tuple(bb.DEPTH), mlp_ratio=tuple(float(r) for r in bb.MLP_RATIO),
            qkv_bias=tuple(bb.QKV_BIAS),
            drop_path_rate=tuple(float(r) for r in bb.DROP_PATH_RATE),
            stride_kv=tuple(bb.STRIDE_KV), freeze_bn=bb.FREEZE_BN,
            head_type=cfg.MODEL.HEAD_TYPE, head_dim=cfg.MODEL.HEAD_DIM,
            head_freeze_bn=cfg.MODEL.get("HEAD_FREEZE_BN", False),
            nlayer_head=cfg.MODEL.get("NLAYER_HEAD", 3))


class CvTBackbone(nn.Module):
    """The stages (`stage{i}`, the reference's `backbone.stage{i}` keys)."""

    def __init__(self, sp: CvTSpec):
        super().__init__()
        dims = (3,) + tuple(sp.dim_embed)
        for i in range(sp.num_stages):
            self.add_module(f"stage{i}", CvTStage(
                dims[i], sp.dim_embed[i], sp.depth[i], sp.num_heads[i], sp.patch_size[i],
                sp.patch_stride[i], sp.patch_padding[i], sp.mlp_ratio[i], sp.qkv_bias[i],
                sp.drop_path_rate[i], sp.stride_kv[i], sp.freeze_bn))
        self.num_stages = sp.num_stages

    def stages(self) -> List[CvTStage]:
        return [getattr(self, f"stage{i}") for i in range(self.num_stages)]


class MixFormerCvT(nn.Module):
    """CvT tracker model: (template, online template, search) NHWC images ->
    boxes (+ score logits). The forward accepts `ce_keep_rate` and
    `use_ce_template_mask` and ignores them (no CE), as models/mixformer.py
    does."""

    def __init__(self, spec: CvTSpec, with_score: bool = False):
        super().__init__()
        sp = self.spec = spec
        self.with_score = with_score
        self.backbone = CvTBackbone(sp)
        feat_sz = sp.search_size // int(np.prod(sp.patch_stride))
        if sp.head_type != "CORNER":
            raise NotImplementedError(f"HEAD_TYPE {sp.head_type!r} for CvT (CORNER is its "
                                      f"head, models/cvt.py:479 there)")
        self.box_head = CornerPredictor(sp.dim_embed[-1], sp.head_dim, feat_sz, 16,
                                        sp.head_freeze_bn)
        if with_score:
            dim = sp.dim_embed[-1]
            self.score_branch = ScoreDecoder(max(1, dim // 64), dim, sp.nlayer_head, 4)

    @staticmethod
    def regime_name(name: str) -> str:
        """A parameter's name as the JAX package's optimizer labels it: its
        flax MixFormerCvT holds `stage{i}` at the top level, so its paths
        carry no `backbone` (ROADMAP.md §3)."""
        return name[len("backbone."):] if name.startswith("backbone.") else name

    def _head(self, s: torch.Tensor, t: torch.Tensor, run_score_head: bool,
              gt_bboxes: Optional[torch.Tensor] = None) -> dict:
        B = s.shape[0]
        out = {"pred_boxes": box_xyxy_to_cxcywh(self.box_head(s)).reshape(B, 1, 4)}
        if run_score_head and self.with_score:
            box = gt_bboxes if gt_bboxes is not None else \
                box_cxcywh_to_xyxy(out["pred_boxes"].reshape(-1, 4)).detach()
            out["pred_scores"] = self.score_branch(s, t, box.reshape(B, 4))
        return out

    def forward(self, template, online_template, search, ce_keep_rate: Optional[float] = None,
                use_ce_template_mask: bool = True, run_score_head: bool = False,
                gt_bboxes: Optional[torch.Tensor] = None) -> dict:
        """(B, H, W, 3) images -> {'pred_boxes': (B, 1, 4) cxcywh in [0, 1]},
        and with run_score_head 'pred_scores' (B, 1, 1) logits; gt_bboxes
        (B, 4) normalised xyxy replaces the predicted box the score branch
        pools."""
        del ce_keep_rate, use_ce_template_mask
        mt = torch.stack([template, online_template], dim=1).flatten(0, 1)
        s = search
        for stage in self.backbone.stages():
            mt, s = stage(mt, s, 2)
        return self._head(s, mt[0::2], run_score_head, gt_bboxes)

    def set_online(self, template, online_template, slot_mask: Optional[torch.Tensor] = None):
        """The template cache of `template` (B, Ht, Wt, 3) and its ring of
        online templates (B * n, ...; each stream's n in turn): {"mem":
        [stage][block] (k, v), "template": (B, h, w, C), "slot_mask"}; the
        slot mask ((n,) or (B, n), 0/1) defaults to all ones."""
        B = template.shape[0]
        n = online_template.shape[0] // B
        if slot_mask is None:
            slot_mask = template.new_ones((n,), dtype=torch.float32)
        mt = torch.cat([template[:, None], online_template.unflatten(0, (B, n))], dim=1)
        mt = mt.flatten(0, 1)
        mems = []
        for stage in self.backbone.stages():
            mt, mem = stage.set_online(mt, 1 + n, slot_mask)
            mems.append(mem)
        return {"mem": mems, "template": mt[0::1 + n], "slot_mask": slot_mask}

    def forward_test(self, search, cache: dict, run_score_head: bool = False) -> dict:
        """Search images against a `set_online` cache: the outputs of
        `forward`; the score branch reads the cache's template map."""
        s = search
        for stage, mem in zip(self.backbone.stages(), cache["mem"]):
            s = stage.forward_test(s, mem, cache["slot_mask"])
        return self._head(s, cache["template"], run_score_head)


def build_mixformer_cvt(cfg, with_score: bool = False, **spec_overrides) -> MixFormerCvT:
    """The CvT model of a config, with the SPM score branch if
    `with_score`; `spec_overrides` replace fields of the spec read from it."""
    return MixFormerCvT(dataclasses.replace(CvTSpec.from_cfg(cfg), **spec_overrides), with_score)
