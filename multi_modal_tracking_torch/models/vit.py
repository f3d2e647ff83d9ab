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

The cached path of the unimodal trackers (`set_online` / `forward_test`):
`set_online` runs full self-attention over the template and the online
templates and keeps each block's k and v; `forward_test` runs the search
tokens alone against them. Both attend through `_attend`, plain PyTorch
with a key mask, as the JAX package's XLA einsum is (no Pallas kernel
there, so no hand-written kernel here). The key mask hides the unfilled
slots of the online trackers' static ring of templates.

Inputs are NHWC, as in the JAX package.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from multi_modal_tracking_torch.models.layers import (DropPath, LayerNorm, Linear, Mlp,
                                                      PatchEmbed, _heads, _merge)
from multi_modal_tracking_torch.ops.attention import mixed_attention
from multi_modal_tracking_torch.ops.pos_embed import get_2d_sincos_pos_embed


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
            key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention of (B, H, N, D) tensors in the JAX package's order
    (models/vit.py:42-57 there): the logits in the compute dtype, scaled in
    it, then raised to f32; keys where `key_mask` ((K,) or (B, K) of 0/1)
    is 0 get -1e30; the softmax in f32, cast back, times v."""
    attn = torch.matmul(q, k.transpose(-2, -1)) * scale
    attn = attn.float()
    if key_mask is not None:
        m = key_mask.reshape((key_mask.shape[0] if key_mask.dim() > 1 else 1, 1, 1, -1))
        attn = attn.masked_fill(m <= 0, -1e30)
    return torch.matmul(torch.softmax(attn, dim=-1).to(q.dtype), v)


class MixedAttention(nn.Module):
    """Asymmetric mixed attention over [t; ot; s] tokens.

    Under tensor parallelism (parallel/tensor.py, `set_model_group`) `qkv`
    holds this rank's heads' rows of q, of k and of v and `proj` the
    matching input columns (row-parallel): `num_heads` is then the rank's
    head count, and K1 / K2 (or K1-bf16 / K2-bf16) and the cached path's
    `_attend` run on its heads with no collective inside."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = self.total_heads = num_heads
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = Linear(dim, dim)
        self.scale = (dim // num_heads) ** -0.5
        #: the model group of tensor parallelism (parallel/mesh.py), or None
        self.model_group = None

    def set_model_group(self, group) -> None:
        """Run on this rank's heads of `group`'s (its qkv and proj already
        cut: parallel/tensor.py shard_tensor_parallel_)."""
        self.model_group = group
        self.num_heads = self.total_heads // group.world

    def _qkv(self, x: torch.Tensor):
        return tuple(_heads(t, self.num_heads) for t in self.qkv(x).chunk(3, dim=-1))

    def forward(self, x: torch.Tensor, n_mt: int) -> torch.Tensor:
        """x: (B, n_mt + n_s, C); the first n_mt rows attend among themselves."""
        q, k, v = self._qkv(x)
        return self.proj(_merge(mixed_attention(q, k, v, n_mt, self.scale)))

    def set_online(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None):
        """Full self-attention over template tokens: (out, (k, v))."""
        q, k, v = self._qkv(x)
        return self.proj(_merge(_attend(q, k, v, self.scale, key_mask))), (k, v)

    def forward_test(self, x: torch.Tensor, mem, key_mask: Optional[torch.Tensor] = None):
        """Search tokens against the cached template k and v; `key_mask`
        covers the cached keys, the search keys are always live."""
        q, k_s, v_s = self._qkv(x)
        k_mem, v_mem = mem
        k = torch.cat([k_mem.to(k_s.dtype), k_s], dim=2)
        v = torch.cat([v_mem.to(v_s.dtype), v_s], dim=2)
        if key_mask is not None:
            ones = key_mask.new_ones(key_mask.shape[:-1] + (k_s.shape[2],))
            key_mask = torch.cat([key_mask, ones], dim=-1)
        return self.proj(_merge(_attend(q, k, v, self.scale, key_mask)))


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

    def set_online(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None):
        out, mem = self.attn.set_online(self.norm1(x), key_mask)
        x = x + out
        return x + self.mlp(self.norm2(x)), mem

    def forward_test(self, x: torch.Tensor, mem, key_mask: Optional[torch.Tensor] = None):
        x = x + self.attn.forward_test(self.norm1(x), mem, key_mask)
        return x + self.mlp(self.norm2(x))


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
        dpr = [float(r) for r in np.linspace(0, drop_path_rate, depth)]
        self.blocks = nn.ModuleList([block(embed_dim, num_heads, mlp_ratio, qkv_bias, dpr[i])
                                     for i in range(depth)])
        self.grid_size_s = img_size_s // patch_size
        self.grid_size_t = img_size_t // patch_size
        # fixed sin-cos embeddings: buffers, not part of the state dict
        self.register_buffer("pos_embed_s", torch.from_numpy(
            get_2d_sincos_pos_embed(embed_dim, self.grid_size_s))[None], persistent=False)
        self.register_buffer("pos_embed_t", torch.from_numpy(
            get_2d_sincos_pos_embed(embed_dim, self.grid_size_t))[None], persistent=False)

    def _stage_blocks(self) -> nn.ModuleList:
        """The attention blocks over the tokens (`blocks`; the ConvMAE
        backbone's third stage, `blocks3`)."""
        return self.blocks

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
        for blk in self._stage_blocks():
            x = blk(x, 2 * n_t)
        B = x.shape[0]
        gt, gs = self.grid_size_t, self.grid_size_s
        return (x[:, :n_t].reshape(B, gt, gt, -1), x[:, n_t:2 * n_t].reshape(B, gt, gt, -1),
                x[:, 2 * n_t:].reshape(B, gs, gs, -1))

    def set_online(self, x_t: torch.Tensor, x_ot: torch.Tensor,
                   slot_mask: Optional[torch.Tensor] = None):
        """x_t: (B, Ht, Wt, 3) templates; x_ot: (B * n_ot, Ht, Wt, 3), each
        template's n_ot online templates in turn (B = 1: the JAX package's
        one template and its ring). Each ring is flattened into one token
        sequence after its template. slot_mask ((n_ot,) or (B, n_ot), 0/1)
        marks the live slots: a masked slot's tokens are keys of no
        attention.

        Returns (template map (B, gt, gt, C), [(k, v)] per block, the key
        mask over the cached tokens: n_t ones, then each slot's mask n_t
        times; None without slot_mask)."""
        t, ot = self._embed(x_t, self.pos_embed_t), self._embed(x_ot, self.pos_embed_t)
        B, n_t, C = t.shape
        x = torch.cat([t, ot.reshape(B, -1, C)], dim=1)
        key_mask = None
        if slot_mask is not None:
            slots = slot_mask.float().repeat_interleave(n_t, dim=-1)
            key_mask = torch.cat([slots.new_ones(slots.shape[:-1] + (n_t,)), slots], dim=-1)
        mem: List[tuple] = []
        for blk in self._stage_blocks():
            x, m = blk.set_online(x, key_mask)
            mem.append(m)
        gt = self.grid_size_t
        return x[:, :n_t].reshape(B, gt, gt, -1), mem, key_mask

    def forward_test(self, x_s: torch.Tensor, mem, key_mask: Optional[torch.Tensor] = None):
        """NHWC search images against the cache of `set_online` -> the search
        map (B, gs, gs, C)."""
        s = self._embed(x_s, self.pos_embed_s)
        for blk, m in zip(self._stage_blocks(), mem):
            s = blk.forward_test(s, m, key_mask)
        gs = self.grid_size_s
        return s.reshape(s.shape[0], gs, gs, -1)
