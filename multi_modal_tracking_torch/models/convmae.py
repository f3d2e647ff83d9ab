"""MixFormer-ConvMAE (the JAX package's models/convmae.py): two convolutional
stages, a ViT stage with asymmetric mixed attention, the corner head and,
with `with_score`, the SPM score branch (`mixformer_convmae_online`).

Each image runs the conv stages on its own: a patch embedding (a VALID
strided conv, LayerNorm eps 1e-5, exact GELU) at patch sizes 4, 2 and 2,
with `CBlock`s after the first two (LayerNorm eps 1e-5, a 1x1 conv, a 5x5
depthwise conv, a 1x1 conv, residual; LayerNorm and an FFN of 1x1 convs,
residual), then `patch_embed4`, a Linear on the flattened tokens, and the
fixed sin-cos position embedding in the compute dtype. The third stage is
models/vit.py's `Block` (eps 1e-6) over [template; online template;
search] tokens: kernel K1 in each block of the forward, K2 in training.
Drop path rates rise linearly over all the stages' blocks together.
Tensors are NHWC; the convolutions see channels-last NCHW views.

The model is `models.mixformer.MixFormer` with this backbone: its
`set_online` / `forward_test` cache ({"mem", "template", "key_mask"},
plain `_attend` attention) and its head and score branch. The head is
CORNER_UP (stride 4) or CORNER (stride 16), by the recipe.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import nn

from multi_modal_tracking_torch.models.asymmetric_shared import RGBTSpec, _build_head
from multi_modal_tracking_torch.models.layers import Conv2d, DropPath, LayerNorm, Linear
from multi_modal_tracking_torch.models.mixformer import MixFormer
from multi_modal_tracking_torch.models.score_decoder import ScoreDecoder
from multi_modal_tracking_torch.models.vit import Block, MixFormerViT
from multi_modal_tracking_torch.ops.pos_embed import get_2d_sincos_pos_embed


def _conv(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A conv of an NHWC tensor through its channels-last NCHW view."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ConvMAEPatchEmbed(nn.Module):
    """Strided conv patchify + LayerNorm + GELU: (B, H, W, Cin) -> (B, H/p,
    W/p, C)."""

    def __init__(self, in_chans: int, embed_dim: int, patch_size: int):
        super().__init__()
        self.proj = Conv2d(in_chans, embed_dim, patch_size, patch_size)
        self.norm = LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.gelu(self.norm(_conv(self.proj, x)))


class CMlp(nn.Module):
    """The conv FFN: 1x1 conv -> GELU -> 1x1 conv."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Conv2d(dim, hidden, 1)
        self.fc2 = Conv2d(hidden, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv(self.fc2, nn.functional.gelu(_conv(self.fc1, x)))


class CBlock(nn.Module):
    """Convolutional block of the early stages, NHWC."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0, drop_path: float = 0.0):
        super().__init__()
        self.dp1, self.dp2 = DropPath(drop_path), DropPath(drop_path)
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.conv1 = Conv2d(dim, dim, 1)
        self.attn = Conv2d(dim, dim, 5, padding=2, groups=dim)
        self.conv2 = Conv2d(dim, dim, 1)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = CMlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x).permute(0, 3, 1, 2)
        h = self.conv2(self.attn(self.conv1(h))).permute(0, 2, 3, 1)
        x = x + self.dp1(h)
        return x + self.dp2(self.mlp(self.norm2(x)))


class ConvMAEViT(MixFormerViT):
    """The 3-stage hybrid backbone: base (256, 384, 768) x (2, 2, 11), 12
    heads, or large (384, 768, 1024) x (2, 2, 20), 16 heads. MixFormerViT's
    forward, set_online and forward_test with these embeddings and
    `blocks3`."""

    def __init__(self, img_size_s: int = 288, img_size_t: int = 128,
                 patch_size: Tuple[int, ...] = (4, 2, 2),
                 embed_dim: Tuple[int, ...] = (256, 384, 768), depth: Tuple[int, ...] = (2, 2, 11),
                 num_heads: int = 12, mlp_ratio: Tuple[float, ...] = (4.0, 4.0, 4.0),
                 qkv_bias: bool = True, drop_path_rate: float = 0.0):
        nn.Module.__init__(self)
        dims = (3,) + tuple(embed_dim)
        for i in range(3):
            self.add_module(f"patch_embed{i + 1}",
                            ConvMAEPatchEmbed(dims[i], dims[i + 1], patch_size[i]))
        self.patch_embed4 = Linear(embed_dim[2], embed_dim[2])
        dpr = [float(r) for r in np.linspace(0, drop_path_rate, sum(depth))]
        d0, d1, d2 = depth
        self.blocks1 = nn.ModuleList(CBlock(embed_dim[0], mlp_ratio[0], dpr[i])
                                     for i in range(d0))
        self.blocks2 = nn.ModuleList(CBlock(embed_dim[1], mlp_ratio[1], dpr[d0 + i])
                                     for i in range(d1))
        self.blocks3 = nn.ModuleList(Block(embed_dim[2], num_heads, mlp_ratio[2], qkv_bias,
                                           dpr[d0 + d1 + i]) for i in range(d2))
        total_stride = int(np.prod(patch_size))
        self.grid_size_s = img_size_s // total_stride
        self.grid_size_t = img_size_t // total_stride
        # fixed sin-cos embeddings: buffers, not part of the state dict
        self.register_buffer("pos_embed_s", torch.from_numpy(
            get_2d_sincos_pos_embed(embed_dim[2], self.grid_size_s))[None], persistent=False)
        self.register_buffer("pos_embed_t", torch.from_numpy(
            get_2d_sincos_pos_embed(embed_dim[2], self.grid_size_t))[None], persistent=False)

    def _stage_blocks(self) -> nn.ModuleList:
        return self.blocks3

    def _embed(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """NHWC images -> stage-3 tokens (B, N, C) plus the position
        embedding in their dtype."""
        x = self.patch_embed1(x)
        for blk in self.blocks1:
            x = blk(x)
        x = self.patch_embed2(x)
        for blk in self.blocks2:
            x = blk(x)
        x = self.patch_embed4(self.patch_embed3(x).flatten(1, 2))
        return x + pos.to(x.dtype)


@dataclasses.dataclass(frozen=True)
class ConvMAESpec:
    """Model spec extracted from a CfgNode (models/convmae.py:192-215 there)."""
    search_size: int = 288
    template_size: int = 128
    embed_dim: Tuple[int, ...] = (256, 384, 768)
    depth: Tuple[int, ...] = (2, 2, 11)
    num_heads: int = 12
    head_type: str = "CORNER_UP"
    head_dim: int = 384
    head_freeze_bn: bool = False
    drop_path_rate: float = 0.1
    nlayer_head: int = 3

    @staticmethod
    def from_cfg(cfg) -> "ConvMAESpec":
        dims = {"convmae_base": ((256, 384, 768), (2, 2, 11), 12),
                "convmae_large": ((384, 768, 1024), (2, 2, 20), 16)}[cfg.MODEL.VIT_TYPE]
        return ConvMAESpec(
            search_size=cfg.DATA.SEARCH.SIZE, template_size=cfg.DATA.TEMPLATE.SIZE,
            embed_dim=dims[0], depth=dims[1], num_heads=dims[2],
            head_type=cfg.MODEL.HEAD_TYPE, head_dim=cfg.MODEL.get("HEAD_DIM", 384),
            head_freeze_bn=cfg.MODEL.get("HEAD_FREEZE_BN", False),
            nlayer_head=cfg.MODEL.get("NLAYER_HEAD", 3))

    def as_rgbt(self) -> RGBTSpec:
        """The fields the corner head reads, as the RGB-T spec it builds from."""
        return RGBTSpec(search_size=self.search_size, template_size=self.template_size,
                        embed_dim=self.embed_dim[2], head_type=self.head_type,
                        head_dim=self.head_dim, head_freeze_bn=self.head_freeze_bn)


class MixFormerConvMAE(MixFormer):
    """ConvMAE tracker model: `MixFormer` (forward, set_online, forward_test,
    head) on the ConvMAE backbone."""

    def __init__(self, spec: ConvMAESpec, with_score: bool = False):
        nn.Module.__init__(self)
        sp = self.spec = spec
        self.with_score = with_score
        self.backbone = ConvMAEViT(img_size_s=sp.search_size, img_size_t=sp.template_size,
                                   embed_dim=sp.embed_dim, depth=sp.depth,
                                   num_heads=sp.num_heads, drop_path_rate=sp.drop_path_rate)
        self.box_head = _build_head(sp.as_rgbt())
        if with_score:
            self.score_branch = ScoreDecoder(sp.num_heads, sp.embed_dim[2], sp.nlayer_head)


def build_mixformer_convmae(cfg, with_score: bool = False,
                            **spec_overrides) -> MixFormerConvMAE:
    """The ConvMAE model of a config, with the SPM score branch if
    `with_score`; `spec_overrides` replace fields of the spec read from it."""
    return MixFormerConvMAE(dataclasses.replace(ConvMAESpec.from_cfg(cfg), **spec_overrides),
                            with_score)
