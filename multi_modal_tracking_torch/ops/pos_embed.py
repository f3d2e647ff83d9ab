"""Fixed positional embeddings (numpy, computed once per geometry).

The port's own copy of the JAX package's `ops/pos_embed.py`:
1) MAE-style 2D sin-cos token embeddings for the ViT template/search grids;
2) DETR-style sine encoding of an un-padded 2D map for the deformable
   fusion encoder.
"""
from __future__ import annotations

import math

import numpy as np


def _sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """[grid_size**2, embed_dim] sin-cos embedding, w-half THEN h-half (the
    channel order pretrained MAE weights were trained against)."""
    grid = np.arange(grid_size, dtype=np.float32)
    gw, gh = np.meshgrid(grid, grid)  # w varies fastest
    emb = np.concatenate([_sincos_1d(embed_dim // 2, gw),
                          _sincos_1d(embed_dim // 2, gh)], axis=1)
    return emb.astype(np.float32)


def sine_position_encoding(h: int, w: int, num_pos_feats: int,
                           temperature: float = 10000.0) -> np.ndarray:
    """Normalised DETR sine encoding of an un-padded (h, w) map ->
    [h*w, 2*num_pos_feats], channels [y-half, x-half], each half
    interleaving sin/cos."""
    scale = 2 * math.pi
    eps = 1e-6
    y_embed = np.arange(1, h + 1, dtype=np.float64)[:, None] * np.ones((1, w))
    x_embed = np.arange(1, w + 1, dtype=np.float64)[None, :] * np.ones((h, 1))
    y_embed = (y_embed - 0.5) / (y_embed[-1:, :] + eps) * scale
    x_embed = (x_embed - 0.5) / (x_embed[:, -1:] + eps) * scale

    dim_t = np.arange(num_pos_feats, dtype=np.float64)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)

    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])], axis=3).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])], axis=3).reshape(h, w, -1)
    pos = np.concatenate([pos_y, pos_x], axis=2).astype(np.float32)
    return pos.reshape(h * w, -1)
