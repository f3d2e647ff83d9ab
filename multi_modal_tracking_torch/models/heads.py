"""Corner box heads: CORNER (stride 16) and CORNER_UP (pyramid, stride 4),
and the MLP of the score branch (`MLPHead`).

Both decode top-left / bottom-right score maps by soft-argmax over a
stride-spaced coordinate mesh and return an xyxy box normalised by
feat_sz * stride. Inputs are NHWC (B, F, F, C) at the public functions.
Attribute names are the reference's (`conv1_tl.0.weight`,
`adjust3_tl.1.0.weight`, ...), so a reference state dict loads as it is.
`model.train()` reaches every BatchNorm of the towers (batch statistics,
running-statistic updates); with `freeze_bn` (the recipe's HEAD_FREEZE_BN)
they are FrozenBatchNorm2d and train mode changes nothing.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from multi_modal_tracking_torch.models.layers import Conv2d, ConvBNRelu, Linear


def soft_argmax(score_map: torch.Tensor, stride: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, F, F) score map -> expected (x, y) in image-pixel units and the
    (B, F*F) probabilities. Flattening is row-major, so idx % F is x."""
    B, F, _ = score_map.shape
    prob = torch.softmax(score_map.reshape(B, F * F).float(), dim=1)
    idx = torch.arange(F * F, device=score_map.device)
    coord_x = ((idx % F) * stride).float()
    coord_y = ((idx // F) * stride).float()
    return (prob * coord_x).sum(dim=1), (prob * coord_y).sum(dim=1), prob


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample of NCHW (F.interpolate's default mode)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def _upsample4x(x: torch.Tensor) -> torch.Tensor:
    return _upsample2x(_upsample2x(x))


def _decode(map_tl: torch.Tensor, map_br: torch.Tensor, feat_sz: int, stride: int):
    x_tl, y_tl, _ = soft_argmax(map_tl, stride)
    x_br, y_br, _ = soft_argmax(map_br, stride)
    return torch.stack([x_tl, y_tl, x_br, y_br], dim=1) / (feat_sz * stride)


class CornerPredictor(nn.Module):
    """CORNER head: per corner conv1..conv4 (Conv-BN-ReLU) + conv5 (1x1)."""

    def __init__(self, inplanes: int = 768, channel: int = 384, feat_sz: int = 18,
                 stride: int = 16, freeze_bn: bool = False):
        super().__init__()
        self.feat_sz, self.stride = feat_sz, stride
        c = channel
        cbr = lambda i, o: ConvBNRelu(i, o, frozen=freeze_bn)   # noqa: E731
        for corner in ("tl", "br"):
            setattr(self, f"conv1_{corner}", cbr(inplanes, c))
            setattr(self, f"conv2_{corner}", cbr(c, c // 2))
            setattr(self, f"conv3_{corner}", cbr(c // 2, c // 4))
            setattr(self, f"conv4_{corner}", cbr(c // 4, c // 8))
            setattr(self, f"conv5_{corner}", Conv2d(c // 8, 1, kernel_size=1))

    def _tower(self, x: torch.Tensor, corner: str) -> torch.Tensor:
        for i in range(1, 6):
            x = getattr(self, f"conv{i}_{corner}")(x)
        return x[:, 0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, h, w, C) fused search feature -> (B, 4) xyxy normalised to 1
        (h = w = feat_sz for CORNER, feat_sz / 4 for CORNER_UP)."""
        x = x.permute(0, 3, 1, 2)
        return _decode(self._tower(x, "tl"), self._tower(x, "br"),
                       self.feat_sz, self.stride)


class PyramidCornerPredictor(CornerPredictor):
    """CORNER_UP head: each corner runs a pyramid tower (two nearest 2x
    upsampling stages with lateral adjust convs and multi-scale score
    fusion), so the score maps are at stride 4."""

    def __init__(self, inplanes: int = 768, channel: int = 384, feat_sz: int = 72,
                 stride: int = 4, freeze_bn: bool = False):
        super().__init__(inplanes, channel, feat_sz, stride, freeze_bn)
        c = channel
        cbr = lambda i, o: ConvBNRelu(i, o, frozen=freeze_bn)   # noqa: E731
        for corner in ("tl", "br"):
            setattr(self, f"adjust1_{corner}", cbr(inplanes, c // 2))
            setattr(self, f"adjust2_{corner}", cbr(inplanes, c // 4))
            setattr(self, f"adjust3_{corner}", nn.Sequential(
                cbr(c // 2, c // 4), cbr(c // 4, c // 8), cbr(c // 8, 1)))
            setattr(self, f"adjust4_{corner}", nn.Sequential(
                cbr(c // 4, c // 8), cbr(c // 8, 1)))

    def _tower(self, x: torch.Tensor, corner: str) -> torch.Tensor:
        """One corner's pyramid branch: NCHW (B, C, F/4, F/4) -> (B, F, F)
        score map."""
        m = lambda name: getattr(self, f"{name}_{corner}")   # noqa: E731
        x1 = m("conv1")(x)
        x2 = m("conv2")(x1)
        up1 = _upsample2x(m("adjust1")(x)) + _upsample2x(x2)
        x3 = m("conv3")(up1)
        up2 = _upsample4x(m("adjust2")(x)) + _upsample2x(x3)
        x4 = m("conv4")(up2)
        score = m("conv5")(x4)
        a3 = m("adjust3")(x2)
        a4 = m("adjust4")(x3)
        return (score + _upsample4x(a3) + _upsample2x(a4))[:, 0]


class MLPHead(nn.Module):
    """`num_layers` Linear layers with a ReLU between them (the JAX package's
    `models/heads.py MLPHead`); the reference's keys `layers.{j}`."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, num_layers: int = 3):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.layers = nn.ModuleList(Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x
