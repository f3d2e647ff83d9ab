"""Torchvision-layout ResNet feature extractors with frozen BatchNorm: the
port's counterpart of the JAX package's `models/resnet.py`.

The blocks, strides (conv1 /2, max pool /2, layer2-4 /2 each, the stride
on the 3x3 conv of a Bottleneck: torchvision "v1.5") and paddings are
torchvision's, and so are the parameter names (`conv1`, `bn1`,
`layerN.M.convK`, `layerN.M.bnK`, `layerN.M.downsample.0/1`), so a
torchvision or reference (`resnet_seg`) state dict loads as it is. Every
BatchNorm is a `FrozenBatchNorm2d` (eps 1e-5): the networks run from
trained weights, and a frozen BN is a constant per-channel affine, as the
JAX package's `FrozenBatchNorm` leaves in `batch_stats`.

Inputs and features are NCHW here; `ResNet.forward` returns the
torch-named features, `seg_features` renames them deep to shallow as
Alpha-Refine's `resnet_seg` does.
"""
from __future__ import annotations

from typing import Dict, Sequence, Type

import torch
from torch import nn

from multi_modal_tracking_torch.models.layers import Conv2d, FrozenBatchNorm2d


def _conv(cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0) -> Conv2d:
    return Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(_conv(cin, cout, 1, stride), FrozenBatchNorm2d(cout))


class BasicBlock(nn.Module):
    """3x3 -> 3x3, expansion 1."""
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, 1)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, 1, 1)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.downsample = _downsample(inplanes, planes, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        r = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + r)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (x4), expansion 4."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride, 1)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = _downsample(inplanes, planes * 4, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        r = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + r)


class ResNet(nn.Module):
    """Feature-pyramid ResNet. `forward` returns the torch-named features:
      conv1  -- after conv1, BN, ReLU and the max pool, /4, 64 channels
      layer1 -- /4;  layer2 -- /8;  layer3 -- /16;  layer4 -- /32."""

    def __init__(self, block: Type[nn.Module] = Bottleneck,
                 layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.block = block
        self.conv1 = _conv(3, 64, 7, 2, 3)
        self.bn1 = FrozenBatchNorm2d(64)
        # MaxPool2d(3, 2, 1): -inf padding and floored sizes, as flax's max_pool
        # with padding ((1, 1), (1, 1))
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = 64
        for i, (planes, nblocks, stride) in enumerate(zip((64, 128, 256, 512), layers,
                                                          (1, 2, 2, 2))):
            blocks = []
            for j in range(nblocks):
                s = stride if j == 0 else 1
                down = j == 0 and (s != 1 or inplanes != planes * block.expansion)
                blocks.append(block(inplanes, planes, s, down))
                inplanes = planes * block.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor, last: str = "layer4") -> Dict[str, torch.Tensor]:
        """The features up to `last` (a layer name; the classic trackers
        stop at layer3)."""
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        feats = {"conv1": x}
        for i in range(1, int(last[-1]) + 1):
            x = getattr(self, f"layer{i}")(x)
            feats[f"layer{i}"] = x
        return feats


def resnet18() -> ResNet:
    return ResNet(BasicBlock, (2, 2, 2, 2))


def resnet34() -> ResNet:
    return ResNet(BasicBlock, (3, 4, 6, 3))


def resnet50() -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3))


RESNET_OUT_CHANNELS = {
    BasicBlock: {"conv1": 64, "layer1": 64, "layer2": 128, "layer3": 256, "layer4": 512},
    Bottleneck: {"conv1": 64, "layer1": 256, "layer2": 512, "layer3": 1024, "layer4": 2048},
}


def seg_features(feats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The torch layer names renamed to resnet_seg's deep-to-shallow scheme:
    layer1 = the stem, layer2..layer5 = torch layer1..layer4."""
    return {"layer1": feats["conv1"], "layer2": feats["layer1"], "layer3": feats["layer2"],
            "layer4": feats["layer3"], "layer5": feats["layer4"]}
