"""Building blocks shared by the port's models.

Conventions, as in the JAX package: images are NHWC at the public model
functions, token sequences (B, N, C); the backbone's LayerNorm eps is 1e-6.
Module attribute names give the reference's torch state-dict keys.
"""
from __future__ import annotations

import torch
from torch import nn


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, C) -> (B, H, N, C/H), contiguous."""
    B, N, C = x.shape
    return x.reshape(B, N, num_heads, C // num_heads).permute(0, 2, 1, 3).contiguous()


def _merge(x: torch.Tensor) -> torch.Tensor:
    """(B, H, N, D) -> (B, N, H*D)."""
    B, H, N, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B, N, H * D)


class Mlp(nn.Module):
    """Transformer FFN: Linear -> exact GELU -> Linear."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(nn.functional.gelu(self.fc1(x)))


class PatchEmbed(nn.Module):
    """Conv patchify of an NHWC image: (B, H, W, 3) -> (B, H/p * W/p, C)."""

    def __init__(self, patch_size: int = 16, in_chans: int = 3, embed_dim: int = 768):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, kernel_size=patch_size,
                              stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(x.permute(0, 3, 1, 2))
        return x.flatten(2).transpose(1, 2)


def ConvBNRelu(in_planes: int, out_planes: int, kernel_size: int = 3) -> nn.Sequential:
    """Conv2d + BatchNorm2d + ReLU stage of the corner heads; the Sequential
    gives the reference's `.0` (conv) / `.1` (BN) key names."""
    return nn.Sequential(
        nn.Conv2d(in_planes, out_planes, kernel_size=kernel_size,
                  padding=kernel_size // 2, bias=True),
        nn.BatchNorm2d(out_planes, eps=1e-5),
        nn.ReLU(inplace=True))
