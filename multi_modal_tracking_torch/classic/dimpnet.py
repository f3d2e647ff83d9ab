"""The learned DiMP / ATOM modules: the port's counterpart of the JAX
package's `classic/dimpnet.py` (pytracking's ltr target_classifier
features / initializer / optimizer, layers filter and distance, and the
AtomIoUNet box regressor).

Modules are NCHW `nn.Module`s whose parameter names are the reference's
torch keys: `DiMPNet` and `ATOMNet` hold `feature_extractor` (the
torchvision-layout ResNet up to layer3), `classifier`
(`feature_extractor.{i}`, `filter_initializer.filter_conv`,
`filter_optimizer.{log_step_length, filter_reg, label_map_predictor,
target_mask_predictor.0, spatial_weight_predictor}`) and `bb_regressor`
(`conv3_1r.0/1`, ..., `fc3_rt.linear/bn`, `iou_predictor`), so a DiMPnet /
ATOMnet state dict loads with `load_network` as it is. The three 1x1
predictors keep the reference's conv layout (1, bins, 1, 1). BatchNorms
are FrozenBatchNorm2d (eval-mode affines), as in the JAX package. A
classifier filter is (C, fh, fw) for one sequence.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multi_modal_tracking_torch.classic.dcf import const
from multi_modal_tracking_torch.models.layers import Conv2d, FrozenBatchNorm2d
from multi_modal_tracking_torch.models.resnet import BasicBlock, ResNet, resnet18, resnet50
from multi_modal_tracking_torch.ops.prroi import prroi_pool


def instance_l2norm(x: torch.Tensor, scale: float, eps: float = 1e-5) -> torch.Tensor:
    """InstanceL2Norm (size_average): each sample of (N, C, H, W) scaled to
    RMS 1, then by `scale`."""
    n = x.shape[1] * x.shape[2] * x.shape[3]
    ss = torch.sum(x * x, dim=(1, 2, 3), keepdim=True)
    return x * (scale * torch.sqrt(n / (ss + eps)))


class InstanceL2Norm(nn.Module):
    def __init__(self, scale: float, eps: float = 1e-5):
        super().__init__()
        self.scale, self.eps = scale, eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_l2norm(x, self.scale, self.eps)


class ClfFeatures(nn.Sequential):
    """The classification feature extractor (features.py
    residual_basic_block / residual_bottleneck): num_blocks BasicBlocks of
    feature_dim, a bias-free 3x3 conv to out_dim and InstanceL2Norm; child
    i is the reference's Sequential index i. dimp18: one block on layer3's
    256 channels; dimp50: no block, the conv from layer3's 1024."""

    def __init__(self, input_dim: int, feature_dim: int = 256, out_dim: int = 512,
                 num_blocks: int = 0, filter_size: int = 4):
        layers = [BasicBlock(feature_dim, feature_dim) for _ in range(num_blocks)]
        cin = feature_dim if num_blocks else input_dim
        layers.append(Conv2d(cin, out_dim, 3, padding=1, bias=False))
        layers.append(InstanceL2Norm(math.sqrt(1.0 / (out_dim * filter_size ** 2))))
        super().__init__(*layers)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _rois(boxes_xywh: torch.Tensor, batch_index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, 5) [batch index, x0, y0, x1, y1] from xywh boxes."""
    n = boxes_xywh.shape[0]
    idx = (torch.arange(n, dtype=torch.float32, device=boxes_xywh.device)
           if batch_index is None else batch_index.to(torch.float32))
    return torch.cat([idx[:, None], boxes_xywh[:, :2], boxes_xywh[:, :2] + boxes_xywh[:, 2:]],
                     dim=1)


def filter_pool(feat: torch.Tensor, bb_xywh: torch.Tensor, filter_size: int,
                feat_stride: int) -> torch.Tensor:
    """FilterPool: PrRoI-pool each sample's target box to (filter_size,
    filter_size). feat (N, C, H, W); bb (N, 4) xywh image px -> (N, C, fs, fs)."""
    return _nchw(prroi_pool(_nhwc(feat), _rois(bb_xywh), filter_size, filter_size,
                            1.0 / feat_stride))


class FilterInitializerLinear(nn.Module):
    """A 3x3 conv, the target region pooled, averaged over the samples:
    -> (C, fs, fs)."""

    def __init__(self, feature_dim: int = 512, filter_size: int = 4, feat_stride: int = 16,
                 filter_norm: bool = False):
        super().__init__()
        self.filter_size, self.feat_stride, self.filter_norm = filter_size, feat_stride, filter_norm
        self.feature_dim = feature_dim
        self.filter_conv = Conv2d(feature_dim, feature_dim, 3, padding=1, bias=True)

    def forward(self, feat: torch.Tensor, bb_xywh: torch.Tensor) -> torch.Tensor:
        weights = filter_pool(self.filter_conv(feat), bb_xywh, self.filter_size,
                              self.feat_stride).mean(dim=0)
        if self.filter_norm:
            weights = weights / (self.filter_size ** 2 * self.feature_dim)
        return weights


def apply_filter(feat: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Correlate a (C, fh, fw) filter over (N, C, H, W) features with the
    reference's padding ksz // 2 on both sides (an even filter gives
    (H + 1, W + 1) scores) -> (N, H', W')."""
    fh, fw = weights.shape[-2], weights.shape[-1]
    return F.conv2d(feat, weights[None], padding=(fh // 2, fw // 2))[:, 0]


def apply_feat_transpose(feat: torch.Tensor, residuals: torch.Tensor,
                         filter_shape: Tuple[int, int, int]) -> torch.Tensor:
    """The exact transpose of apply_filter with respect to the filter: the
    gradient of the correlation's weight at `residuals` (N, H', W')."""
    C, fh, fw = filter_shape
    return torch.nn.grad.conv2d_weight(feat, (1, C, fh, fw), residuals[:, None],
                                       padding=(fh // 2, fw // 2))[0]


def distance_map(center_yx: torch.Tensor, output_sz: Tuple[int, int], num_bins: int,
                 bin_displacement: float = 1.0) -> torch.Tensor:
    """DistanceMap: soft-binned radial distance from each centre (N, 2)
    (y, x) -> (N, bins, H, W)."""
    dev = center_yx.device
    bins = torch.arange(num_bins, dtype=torch.float32, device=dev)
    k0 = torch.arange(output_sz[0], dtype=torch.float32, device=dev)
    k1 = torch.arange(output_sz[1], dtype=torch.float32, device=dev)
    d0 = k0[None, :, None] - center_yx[:, 0][:, None, None]
    d1 = k1[None, None, :] - center_yx[:, 1][:, None, None]
    dist = torch.sqrt(d0 * d0 + d1 * d1)                     # (N, H, W)
    diff = dist[:, None] / bin_displacement - bins[None, :, None, None]
    last = torch.clamp(1.0 + diff[:, -1:], 0.0, 1.0)
    rest = torch.relu(1.0 - torch.abs(diff[:, :-1]))
    return torch.cat([rest, last], dim=1)


class DiMPSteepestDescentGN(nn.Module):
    """The learned optimizer (optimizer.py DiMPSteepestDescentGN) for one
    sequence: unrolled steepest descent with the Gauss-Newton step length
    on the hinged discriminative loss, with the label map, target mask and
    spatial weight predicted from the distance bins (1x1 convs), a learned
    step length and filter regularisation. Initialised as the reference
    documents it.

    forward(weights (C, fh, fw), feat (N, C, H, W), bb (N, 4) xywh image
    px, sample_weight None | (N,), num_iter) -> optimised weights."""

    def __init__(self, num_iter: int = 5, feat_stride: int = 16, init_step_length: float = 1.0,
                 init_filter_reg: float = 1e-2, init_gauss_sigma: float = 1.0,
                 num_dist_bins: int = 5, bin_displacement: float = 1.0,
                 mask_init_factor: float = 4.0, min_filter_reg: float = 1e-3,
                 alpha_eps: float = 0.0):
        super().__init__()
        self.num_iter, self.feat_stride = num_iter, feat_stride
        self.num_dist_bins, self.bin_displacement = num_dist_bins, bin_displacement
        self.min_filter_reg, self.alpha_eps = min_filter_reg, alpha_eps
        self.log_step_length = nn.Parameter(math.log(init_step_length) * torch.ones(1))
        self.filter_reg = nn.Parameter(init_filter_reg * torch.ones(1))
        self.label_map_predictor = Conv2d(num_dist_bins, 1, 1, bias=False)
        self.target_mask_predictor = nn.Sequential(Conv2d(num_dist_bins, 1, 1, bias=False),
                                                   nn.Sigmoid())
        self.spatial_weight_predictor = Conv2d(num_dist_bins, 1, 1, bias=False)
        d = torch.arange(num_dist_bins, dtype=torch.float32) * bin_displacement
        if init_gauss_sigma == 0:
            g = torch.zeros(num_dist_bins)
            g[0] = 1.0
        else:
            g = torch.exp(-0.5 * (d / init_gauss_sigma) ** 2)
        with torch.no_grad():
            self.label_map_predictor.weight.copy_((g - g.min()).view(1, -1, 1, 1))
            self.target_mask_predictor[0].weight.copy_(
                (mask_init_factor * torch.tanh(2.0 - d)).view(1, -1, 1, 1))
            self.spatial_weight_predictor.weight.fill_(1.0)

    def forward(self, weights: torch.Tensor, feat: torch.Tensor, bb: torch.Tensor,
                sample_weight: Optional[torch.Tensor] = None,
                num_iter: Optional[int] = None) -> torch.Tensor:
        num_iter = self.num_iter if num_iter is None else num_iter
        n = feat.shape[0]
        fh, fw = weights.shape[-2], weights.shape[-1]
        out_sz = (feat.shape[2] + (fh + 1) % 2, feat.shape[3] + (fw + 1) % 2)
        step_length = torch.exp(self.log_step_length)
        reg = torch.clamp(self.filter_reg * self.filter_reg, min=self.min_filter_reg ** 2)
        offset = const([fh % 2 / 2.0, fw % 2 / 2.0], feat.device, bb.dtype)
        center = torch.flip((bb[:, :2] + bb[:, 2:] / 2.0) / self.feat_stride, (1,)) - offset
        dmap = distance_map(center, out_sz, self.num_dist_bins, self.bin_displacement)
        label = self.label_map_predictor(dmap)[:, 0]
        mask = self.target_mask_predictor(dmap)[:, 0]
        spatial_w = self.spatial_weight_predictor(dmap)[:, 0]
        if sample_weight is None:
            sw = math.sqrt(1.0 / n) * spatial_w
        else:
            sw = torch.sqrt(sample_weight)[:, None, None] * spatial_w
        shape = tuple(weights.shape)
        for _ in range(num_iter):
            scores = apply_filter(feat, weights)
            # the LeakyReluPar activation and its derivative in the scores
            s_act = (1.0 - mask) / 2.0 * torch.abs(scores) + (1.0 + mask) / 2.0 * scores
            s_grad_mask = (1.0 - mask) / 2.0 * torch.sign(scores) + (1.0 + mask) / 2.0
            residuals = sw * (s_act - label)
            mapped = s_grad_mask * (sw * residuals)
            w_grad = apply_feat_transpose(feat, mapped, shape) + reg * weights
            s_grad = sw * (s_grad_mask * apply_filter(feat, w_grad))
            a_num = torch.sum(w_grad * w_grad)
            a_den = torch.clamp(torch.sum(s_grad * s_grad) + (reg + self.alpha_eps) * a_num,
                                min=1e-8)
            weights = weights - (step_length * a_num / a_den) * w_grad
        return weights


class DiMPClassifier(nn.Module):
    """LinearFilter: feature extractor + initializer + optimizer, one
    sequence."""

    def __init__(self, input_dim: int, feature_dim: int = 256, out_dim: int = 512,
                 num_blocks: int = 0, filter_size: int = 4, feat_stride: int = 16,
                 optim_iter: int = 5, init_step_length: float = 1.0,
                 init_filter_reg: float = 1e-2):
        super().__init__()
        self.feature_extractor = ClfFeatures(input_dim, feature_dim, out_dim, num_blocks,
                                             filter_size)
        self.filter_initializer = FilterInitializerLinear(out_dim, filter_size, feat_stride)
        self.filter_optimizer = DiMPSteepestDescentGN(optim_iter, feat_stride, init_step_length,
                                                      init_filter_reg)

    def extract_classification_feat(self, backbone_feat: torch.Tensor) -> torch.Tensor:
        return self.feature_extractor(backbone_feat)

    def get_filter(self, clf_feat, bb_xywh, sample_weight=None, num_iter=None):
        weights = self.filter_initializer(clf_feat, bb_xywh)
        return self.filter_optimizer(weights, clf_feat, bb_xywh, sample_weight, num_iter)

    def optimize_filter(self, weights, clf_feat, bb_xywh, sample_weight=None, num_iter=None):
        return self.filter_optimizer(weights, clf_feat, bb_xywh, sample_weight, num_iter)

    def classify(self, weights, clf_feat):
        return apply_filter(clf_feat, weights)

    def forward(self, backbone_feat, bb_xywh):
        f = self.feature_extractor(backbone_feat)
        return self.classify(self.get_filter(f, bb_xywh), f)


def conv_bn_relu(cin: int, cout: int, kernel: int = 3, padding: int = 1) -> nn.Sequential:
    """atom_iou_net conv(): Conv2d with bias, BatchNorm (frozen), ReLU, as
    `.0` / `.1` / `.2`."""
    return nn.Sequential(Conv2d(cin, cout, kernel, padding=padding, bias=True),
                         FrozenBatchNorm2d(cout), nn.ReLU(inplace=True))


class LinearBlock(nn.Module):
    """blocks.py LinearBlock: flatten (C, H, W) -> Linear -> BatchNorm2d on
    (N, C, 1, 1) (frozen) -> ReLU."""

    def __init__(self, in_planes: int, out_planes: int, input_sz: int):
        super().__init__()
        self.linear = nn.Linear(in_planes * input_sz * input_sz, out_planes)
        self.bn = FrozenBatchNorm2d(out_planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.linear(x.reshape(x.shape[0], -1))
        return torch.relu(self.bn(x[:, :, None, None]))[:, :, 0, 0]


class AtomIoUNet(nn.Module):
    """atom_iou_net.py AtomIoUNet over two backbone scales (layer2 at /8,
    layer3 at /16): the reference branch gives per-target modulation
    vectors, the test branch scores candidate boxes. input_dim: the two
    layers' channels, (128, 256) for ResNet-18, (512, 1024) for ResNet-50."""

    def __init__(self, input_dim: Tuple[int, int] = (128, 256),
                 pred_input_dim: Tuple[int, int] = (256, 256),
                 pred_inter_dim: Tuple[int, int] = (256, 256)):
        super().__init__()
        self.conv3_1r = conv_bn_relu(input_dim[0], 128)
        self.conv3_1t = conv_bn_relu(input_dim[0], 256)
        self.conv3_2t = conv_bn_relu(256, pred_input_dim[0])
        self.fc3_1r = conv_bn_relu(128, 256, kernel=3, padding=0)
        self.conv4_1r = conv_bn_relu(input_dim[1], 256)
        self.conv4_1t = conv_bn_relu(input_dim[1], 256)
        self.conv4_2t = conv_bn_relu(256, pred_input_dim[1])
        self.fc34_3r = conv_bn_relu(256 + 256, pred_input_dim[0], kernel=1, padding=0)
        self.fc34_4r = conv_bn_relu(256 + 256, pred_input_dim[1], kernel=1, padding=0)
        self.fc3_rt = LinearBlock(pred_input_dim[0], pred_inter_dim[0], 5)
        self.fc4_rt = LinearBlock(pred_input_dim[1], pred_inter_dim[1], 3)
        self.iou_predictor = nn.Linear(pred_inter_dim[0] + pred_inter_dim[1], 1, bias=True)

    def get_modulation(self, feat3: torch.Tensor, feat4: torch.Tensor,
                       bb_xywh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """feat3 (B, C2, H, W) at /8, feat4 (B, C3, H', W') at /16, bb (B, 4)
        xywh crop px -> two (B, pred_input_dim) vectors."""
        roi = _rois(bb_xywh)
        roi3r = _nchw(prroi_pool(_nhwc(self.conv3_1r(feat3)), roi, 3, 3, 1.0 / 8))
        roi4r = _nchw(prroi_pool(_nhwc(self.conv4_1r(feat4)), roi, 1, 1, 1.0 / 16))
        fc34_r = torch.cat([self.fc3_1r(roi3r), roi4r], dim=1)
        return self.fc34_3r(fc34_r)[:, :, 0, 0], self.fc34_4r(fc34_r)[:, :, 0, 0]

    def get_iou_feat(self, feat3: torch.Tensor, feat4: torch.Tensor):
        return self.conv3_2t(self.conv3_1t(feat3)), self.conv4_2t(self.conv4_1t(feat4))

    def predict_iou(self, modulation, feat, proposals_xywh: torch.Tensor) -> torch.Tensor:
        """IoU of proposals (B, P, 4) xywh crop px -> (B, P)."""
        mod3, mod4 = modulation
        c3_t, c4_t = feat
        B, P = proposals_xywh.shape[:2]
        c3_att = c3_t * mod3[:, :, None, None]
        c4_att = c4_t * mod4[:, :, None, None]
        bidx = torch.arange(B, dtype=torch.float32, device=proposals_xywh.device)
        roi = _rois(proposals_xywh.reshape(B * P, 4), bidx.repeat_interleave(P))
        roi3t = _nchw(prroi_pool(_nhwc(c3_att), roi, 5, 5, 1.0 / 8))
        roi4t = _nchw(prroi_pool(_nhwc(c4_att), roi, 3, 3, 1.0 / 16))
        x = torch.cat([self.fc3_rt(roi3t), self.fc4_rt(roi4t)], dim=1)
        return self.iou_predictor(x).reshape(B, P)

    def forward(self, feat3_r, feat4_r, feat3_t, feat4_t, bb_xywh, proposals_xywh):
        modulation = self.get_modulation(feat3_r, feat4_r, bb_xywh)
        return self.predict_iou(modulation, self.get_iou_feat(feat3_t, feat4_t), proposals_xywh)


def classic_backbone(arch: str) -> ResNet:
    """The trackers' ResNet up to layer3 (layer4 is not built: no tracker
    reads it, and a checkpoint's layer4 and fc keys are ignored on load)."""
    net = {"resnet18": resnet18, "resnet50": resnet50}[arch]()
    del net.layer4
    return net


#: keys of a reference checkpoint that a classic network does not hold
IGNORED_KEYS = (r"(^|\.)num_batches_tracked$", r"^feature_extractor\.(fc|layer4)\.")


def load_resnet(net: ResNet, state_dict) -> None:
    """A torchvision / pytracking ResNet state dict into a classic backbone;
    keys the backbone lacks (layer4, fc, a step counter) are skipped, as
    the JAX package's non-strict conversion skips them."""
    own = net.state_dict()
    net.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items() if k in own},
                        strict=False)


class _ClassicNet(nn.Module):
    def load_network(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """A reference-keyed checkpoint, strict both ways but for
        IGNORED_KEYS (BatchNorm step counters, the unused layer4 and the
        classification head)."""
        sd = {k: torch.as_tensor(v) for k, v in state_dict.items()
              if not any(re.search(p, k) for p in IGNORED_KEYS)}
        missing, unexpected = self.load_state_dict(sd, strict=False)
        if missing or unexpected:
            raise ValueError(f"{type(self).__name__}.load_network (strict): missing "
                             f"{sorted(missing)[:8]} ({len(missing)}), unexpected "
                             f"{sorted(unexpected)[:8]} ({len(unexpected)})")


class ATOMNet(_ClassicNet):
    """ltr ATOMnet: ResNet-18 `feature_extractor` + `bb_regressor`."""

    def __init__(self):
        super().__init__()
        self.feature_extractor = classic_backbone("resnet18")
        self.bb_regressor = AtomIoUNet(input_dim=(128, 256))


#: per DiMPnet assembly (dimpnet18 / dimpnet50): layer3 channels, layer2
#: channels, classifier feature_dim, out_dim, residual blocks
ARCH = {
    "resnet18": (256, 128, 256, 256, 1),
    "resnet50": (1024, 512, 256, 512, 0),
}


class DiMPNet(_ClassicNet):
    """ltr DiMPnet: `feature_extractor`, `classifier`, `bb_regressor`."""

    def __init__(self, arch: str = "resnet18", filter_size: int = 4, optim_iter: int = 5):
        super().__init__()
        l3c, l2c, fdim, odim, nblocks = ARCH[arch]
        self.feature_extractor = classic_backbone(arch)
        self.classifier = DiMPClassifier(l3c, fdim, odim, nblocks, filter_size, 16, optim_iter)
        self.bb_regressor = AtomIoUNet(input_dim=(l2c, l3c))


def init_like_flax(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights as flax's defaults draw them: every Conv2d and Linear
    weight truncated normal (two deviations) of variance 1 / fan_in
    (lecun_normal), biases zero; FrozenBatchNorm2d and the learned
    optimizer keep their initial values."""
    skip = {id(x) for opt in module.modules() if isinstance(opt, DiMPSteepestDescentGN)
            for x in opt.modules()}
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)) and id(m) not in skip:
            std = math.sqrt(1.0 / m.weight[0].numel()) / 0.87962566103423978
            with torch.no_grad():
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
