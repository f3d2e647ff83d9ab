"""MixFormer-ViT: the plain ViT backbone with asymmetric mixed attention
(the JAX package's models/vit.py `MixedAttention`, `Block`, `MixFormerViT`).

Tokens are [template; online template; search]: template rows attend only
to the 2 * n_t template keys, search rows to every key. Each block's
attention is one call of kernel K1 (`ops/attention.py mixed_attention`:
n_mt = 2 * n_t), and its gradient kernel K2; a bf16 model runs K1-bf16 and
K2-bf16.

Training (`model.train()`): stochastic depth with per-block rates
linspace(0, drop_path_rate, depth) on both residual branches (a per-sample
mask over the leading axis, from the generator of
`models.layers.set_generator`).

The unimodal trackers' cached path (`set_online` / `forward_test`) is not
ported yet (ROADMAP.md queue 1 item 9). Inputs are NHWC, as in the JAX
package.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from multi_modal_tracking_torch.models.layers import (DropPath, LayerNorm, Linear, Mlp,
                                                      PatchEmbed, _heads, _merge)
from multi_modal_tracking_torch.ops.attention import mixed_attention
from multi_modal_tracking_torch.ops.pos_embed import get_2d_sincos_pos_embed


class MixedAttention(nn.Module):
    """Asymmetric mixed attention over [t; ot; s] tokens."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = Linear(dim, dim)
        self.scale = (dim // num_heads) ** -0.5

    def forward(self, x: torch.Tensor, n_mt: int) -> torch.Tensor:
        """x: (B, n_mt + n_s, C); the first n_mt rows attend among themselves."""
        q, k, v = (_heads(t, self.num_heads) for t in self.qkv(x).chunk(3, dim=-1))
        return self.proj(_merge(mixed_attention(q, k, v, n_mt, self.scale)))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path: float = 0.0):
        super().__init__()
        self.dp1, self.dp2 = DropPath(drop_path), DropPath(drop_path)
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = MixedAttention(dim, num_heads, qkv_bias)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor, n_mt: int) -> torch.Tensor:
        x = x + self.dp1(self.attn(self.norm1(x), n_mt))
        return x + self.dp2(self.mlp(self.norm2(x)))


class MixFormerViT(nn.Module):
    """ViT backbone over [template; online template; search] tokens: base
    (768 / 12 / 12) or large (1024 / 24 / 16). `block` builds each block
    (`Block`; the RGB-T shared-LN backbone passes its own)."""

    def __init__(self, img_size_s: int = 288, img_size_t: int = 128, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, drop_path_rate: float = 0.0,
                 block=Block):
        super().__init__()
        self.patch_embed = PatchEmbed(patch_size, 3, embed_dim)
        dpr = [float(r) for r in torch.linspace(0, drop_path_rate, depth, dtype=torch.float64)]
        self.blocks = nn.ModuleList([block(embed_dim, num_heads, mlp_ratio, qkv_bias, dpr[i])
                                     for i in range(depth)])
        self.grid_size_s = img_size_s // patch_size
        self.grid_size_t = img_size_t // patch_size
        # fixed sin-cos embeddings: buffers, not part of the state dict
        self.register_buffer("pos_embed_s", torch.from_numpy(
            get_2d_sincos_pos_embed(embed_dim, self.grid_size_s))[None], persistent=False)
        self.register_buffer("pos_embed_t", torch.from_numpy(
            get_2d_sincos_pos_embed(embed_dim, self.grid_size_t))[None], persistent=False)

    def _embed(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """Patch tokens plus the fixed position embedding in the model's
        dtype (models/vit.py:168-172 there)."""
        x = self.patch_embed(x)
        return x + pos.to(x.dtype)

    def forward(self, x_t, x_ot, x_s) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """NHWC images (B, H, W, 3) -> (t, ot, s) feature maps (B, h, w, C)."""
        t, ot = self._embed(x_t, self.pos_embed_t), self._embed(x_ot, self.pos_embed_t)
        s = self._embed(x_s, self.pos_embed_s)
        n_t = t.shape[1]
        x = torch.cat([t, ot, s], dim=1)
        for blk in self.blocks:
            x = blk(x, 2 * n_t)
        B = x.shape[0]
        gt, gs = self.grid_size_t, self.grid_size_s
        return (x[:, :n_t].reshape(B, gt, gt, -1), x[:, n_t:2 * n_t].reshape(B, gt, gt, -1),
                x[:, 2 * n_t:].reshape(B, gs, gs, -1))
