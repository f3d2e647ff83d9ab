"""Building blocks shared by the port's models.

Conventions, as in the JAX package: images are NHWC at the public model
functions, token sequences (B, N, C); the backbone's LayerNorm eps is 1e-6.
Module attribute names give the reference's torch state-dict keys.

Random layers (`DropPath`, `Dropout`) draw their masks from an explicit
`torch.Generator` that the caller owns (`set_generator`), on the device of
the tensor, so a seeded generator gives the same masks run after run.
"""
from __future__ import annotations

from typing import Optional

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


class _RandomMask(nn.Module):
    """Base of the layers that zero part of their input in training mode and
    scale the rest by 1 / keep; the identity in eval mode or at rate 0."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None

    def _mask_shape(self, x: torch.Tensor):
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError(f"{type(self).__name__}(rate={self.rate}) in training mode "
                               f"needs a generator: call set_generator(model, g)")
        keep = 1.0 - self.rate
        u = torch.rand(self._mask_shape(x), generator=self.generator, device=x.device)
        return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class DropPath(_RandomMask):
    """Per-sample stochastic depth: a whole sample (leading axis) is zeroed
    with probability `rate` (the JAX package's `DropPath`)."""

    def _mask_shape(self, x):
        return (x.shape[0],) + (1,) * (x.dim() - 1)


class Dropout(_RandomMask):
    """Element-wise dropout (flax `nn.Dropout`), with an explicit generator
    (`torch.nn.functional.dropout` takes none)."""

    def _mask_shape(self, x):
        return x.shape


def set_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Give every DropPath / Dropout of `model` the generator its training-mode
    masks are drawn from (it must live on the model's device)."""
    for m in model.modules():
        if isinstance(m, _RandomMask):
            m.generator = generator


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with the JAX package's training semantics (flax
    `nn.BatchNorm`, momentum 0.9 = torch momentum 0.1, eps 1e-5): in training
    mode it normalises with the batch statistics and updates running_var with
    the BIASED batch variance, where torch's BatchNorm2d uses the unbiased
    one (8 values 0..7 from running_var 1: flax 1.425, torch 1.5). Eval mode
    is torch's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y = nn.functional.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        return y


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with constant statistics and affine (the reference's
    FrozenBatchNorm2d, `HEAD_FREEZE_BN`): all four are buffers, so they take
    no gradient and no weight decay, and train mode changes nothing. The JAX
    package keeps them in `batch_stats` as bn_scale, bn_bias, bn_mean,
    bn_var (models/layers.py:86-98)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * inv
        return x * inv[None, :, None, None] + shift[None, :, None, None]


def ConvBNRelu(in_planes: int, out_planes: int, kernel_size: int = 3,
               frozen: bool = False) -> nn.Sequential:
    """Conv2d + BatchNorm + ReLU stage of the corner heads; the Sequential
    gives the reference's `.0` (conv) / `.1` (BN) key names. `frozen` makes
    the BN a FrozenBatchNorm2d."""
    bn = FrozenBatchNorm2d(out_planes) if frozen else BatchNorm2d(out_planes, eps=1e-5)
    return nn.Sequential(
        nn.Conv2d(in_planes, out_planes, kernel_size=kernel_size,
                  padding=kernel_size // 2, bias=True),
        bn,
        nn.ReLU(inplace=True))
