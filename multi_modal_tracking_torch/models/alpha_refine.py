"""Alpha-Refine: the box-to-mask refinement network and its host wrapper,
the port's counterpart of the JAX package's `models/alpha_refine.py`.

The network (`AlphaRefineNet`, the reference's ARnet_seg_mask): a
ResNet-50 backbone whose features are renamed deep to shallow
(`resnet.seg_features`), a correlation neck (`CorrNL`) on the /16
features, and a decoder (`SegNetwork`) over layer5..layer2 with the
bicubic 2x upsampler. Its parameter names are the reference's
(`feature_extractor.*`, `neck.*`, `refiner.*`), so a reference `.pth`
loads as it is (`utils.convert.load_torch_state_dict`), and a flax
variables tree through `utils.convert.from_jax_variables`. Every
BatchNorm is a `FrozenBatchNorm2d`.

The JAX package runs this network in XLA with no Pallas kernel; here it
is plain PyTorch and cuDNN: the PrRoI pool of the reference kernel
(`ops/prroi.py`), one batched product for the pixel correlation,
convolutions. Maps are NCHW inside; the public methods take and give
NHWC, as the JAX ones do.

Compute dtype (`build_alpha_refine(dtype=)`, `ARcmSeg(dtype=)`): float32,
or bfloat16 on float32 parameters, as the JAX modules' flax `dtype=`: the
convolutions cast input and weights to it (`models/layers.py
set_compute_dtype`), so every map after the first convolution is bf16;
FrozenBatchNorm forms its scale and shift in f32 and applies them in the
map's dtype, the PrRoI pool runs on the f32 features and its kernel is
cast to the compute dtype (the JAX `get_ref_kernel`), the non-local
softmax is f32. The VOT entries run f32.

The host side (`sample_target_se`, `transform_box_to_crop_se`,
`map_mask_back`, `ARcmSeg`) has no cv2: the crops and resizes run in the
port's host library (`native.sample_target_se`, `native.resize_linear`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multi_modal_tracking_torch import native
from multi_modal_tracking_torch.models.layers import (Conv2d, FrozenBatchNorm2d,
                                                      set_compute_dtype)
from multi_modal_tracking_torch.models.resnet import resnet50, seg_features
from multi_modal_tracking_torch.ops.prroi import prroi_pool
from multi_modal_tracking_torch.utils.device import DTYPES, resolve_device, set_precision


def _interp(t: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an NCHW map with half-pixel sampling and no
    antialias (the JAX package's `jax.image.resize(..., "bilinear",
    antialias=False)`, the reference's F.interpolate)."""
    if tuple(t.shape[-2:]) == tuple(hw):
        return t
    return F.interpolate(t, size=tuple(hw), mode="bilinear", align_corners=False)


def _mean_hw(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(2, 3), keepdim=True)


class SEModule(nn.Module):
    """Squeeze-and-excitation over the global average (1x1 convs with
    bias, the reference's neck_utils SEModule)."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        self.fc1 = Conv2d(channels, channels // reduction, 1)
        self.fc2 = Conv2d(channels // reduction, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.sigmoid(self.fc2(torch.relu(self.fc1(_mean_hw(x)))))
        return x * s


class NonLocalBlock2D(nn.Module):
    """Non-local block (sub-sampled phi and g by a 2x2 max pool, a
    BatchNorm'd output projection, residual); the softmax runs in f32."""

    def __init__(self, channels: int):
        super().__init__()
        self.inter = max(channels // 2, 1)
        self.theta = Conv2d(channels, self.inter, 1)
        self.phi = nn.Sequential(Conv2d(channels, self.inter, 1), nn.MaxPool2d(2))
        self.g = nn.Sequential(Conv2d(channels, self.inter, 1), nn.MaxPool2d(2))
        self.W = nn.Sequential(Conv2d(self.inter, channels, 1), FrozenBatchNorm2d(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, _, H, W = x.shape
        theta = self.theta(x).flatten(2).transpose(1, 2)          # (B, HW, inter)
        phi = self.phi(x).flatten(2)                                # (B, inter, hw2)
        g = self.g(x).flatten(2).transpose(1, 2)                    # (B, hw2, inter)
        attn = torch.softmax(torch.bmm(theta, phi).float(), dim=-1).to(x.dtype)
        y = torch.bmm(attn, g).transpose(1, 2).reshape(B, self.inter, H, W)
        return x + self.W(y)


class CorrNL(nn.Module):
    """Pixel-correlation neck: the reference kernel, PrRoI-pooled from the
    reference frame's /16 features at the box, is dotted with every test
    feature (pool^2 channels, no scaling), then SE and non-local attention."""

    def __init__(self, pool_size: int = 8, feat_stride: int = 16):
        super().__init__()
        self.pool_size, self.feat_stride = pool_size, feat_stride
        self.channel_attention = SEModule(pool_size * pool_size)
        self.spatial_attention = NonLocalBlock2D(pool_size * pool_size)

    def get_ref_kernel(self, feat_ref: torch.Tensor, box_xywh: torch.Tensor) -> torch.Tensor:
        """feat_ref (B, C, H, W) /16 features, box (B, 4) xywh in crop
        pixels -> kernel (B, p, p, C) (NHWC, as the JAX package's)."""
        B = feat_ref.shape[0]
        b = box_xywh.reshape(B, 4).float()
        rois = torch.cat([torch.arange(B, dtype=torch.float32, device=b.device)[:, None],
                          b[:, :2], b[:, :2] + b[:, 2:]], dim=1)
        kernel = prroi_pool(feat_ref.float().permute(0, 2, 3, 1), rois, self.pool_size,
                            self.pool_size, 1.0 / self.feat_stride)
        return kernel.to(feat_ref.dtype)

    def forward(self, kernel: torch.Tensor, feat_test: torch.Tensor) -> torch.Tensor:
        """kernel (B, p, p, C), feat_test (B, C, H, W) -> (B, p*p, H, W)."""
        B, p, q, C = kernel.shape
        H, W = feat_test.shape[-2:]
        corr = torch.bmm(kernel.reshape(B, p * q, C).to(feat_test.dtype),
                         feat_test.reshape(B, C, H * W)).reshape(B, p * q, H, W)
        return self.spatial_attention(self.channel_attention(corr))


def _conv(cin: int, cout: int, k: int, bias: bool = True) -> Conv2d:
    return Conv2d(cin, cout, k, padding=k // 2, bias=bias)


class TSE(nn.Module):
    """Target-specific encoder: reduce the backbone feature, concatenate
    the resized score map, transform."""

    def __init__(self, feat_channels: int, score_channels: int, oc: int):
        super().__init__()
        nc = oc + score_channels
        self.reduce = nn.Sequential(_conv(feat_channels, oc, 1), nn.ReLU(), _conv(oc, oc, 1))
        self.transform = nn.Sequential(_conv(nc, nc, 3), nn.ReLU(), _conv(nc, nc, 3), nn.ReLU(),
                                       _conv(nc, oc, 3), nn.ReLU())

    def forward(self, ft, score, x: Optional[torch.Tensor]):
        h = self.reduce(ft)
        hpool = _mean_hw(h) if x is None else x
        h = torch.cat([h, _interp(score, h.shape[-2:])], dim=1)
        return self.transform(h), hpool


class RRB(nn.Module):
    """Residual refinement block: 1x1, then [3x3, BN, ReLU, 3x3 without
    bias] as a residual."""

    def __init__(self, oc: int):
        super().__init__()
        self.conv1x1 = _conv(oc, oc, 1)
        self.bblock = nn.Sequential(_conv(oc, oc, 3), FrozenBatchNorm2d(oc), nn.ReLU(),
                                    _conv(oc, oc, 3, bias=False))

    def forward(self, x):
        h = self.conv1x1(x)
        return torch.relu(h + self.bblock(h))


class CAB(nn.Module):
    """Channel-attention fusion: gate the shallower map from the pooled
    deeper and shallower context, add the deeper one upsampled."""

    def __init__(self, oc: int, deepest: bool = False):
        super().__init__()
        self.deepest = deepest
        self.convreluconv = nn.Sequential(_conv(2 * oc, oc, 1), nn.ReLU(), _conv(oc, oc, 1))

    def forward(self, deeper, shallower):
        deeper_pool = deeper if self.deepest else _mean_hw(deeper)
        g = self.convreluconv(torch.cat([_mean_hw(shallower), deeper_pool], dim=1))
        out = shallower * torch.sigmoid(g)
        return out + _interp(deeper, out.shape[-2:])


def _bicubic_taps(d: float) -> np.ndarray:
    """The 4-tap Keys cubic (a = -0.75) at offset d (PyrUpBicubic2d.kernel)."""
    x = np.abs(d + np.arange(-1, 3, dtype=np.float64))
    a = -0.75
    f = ((x < 1) * ((a + 2) * x**3 - (a + 3) * x**2 + 1)
         + ((x >= 1) & (x < 2)) * (a * x**3 - 5 * a * x**2 + 8 * a * x - 4 * a))
    return f.astype(np.float32)


_W_EVEN = _bicubic_taps(-0.25)
_W_ODD = _bicubic_taps(-0.75)
#: the four 4x4 phase filters, (row phase, column phase) = ee, eo, oe, oo
_PHASES = np.stack([np.outer(r, c) for r in (_W_EVEN, _W_ODD) for c in (_W_EVEN, _W_ODD)])


def pyr_up_bicubic(x: torch.Tensor) -> torch.Tensor:
    """Exact 2x bicubic upsampling of an NCHW map (PyrUpBicubic2d): an edge
    pad of 2, the four phase filters as one depthwise convolution, the
    phases interleaved, a crop of 1."""
    B, C, H, W = x.shape
    a = F.pad(x, (2, 2, 2, 2), mode="replicate")
    w = torch.as_tensor(_PHASES, dtype=x.dtype, device=x.device)[:, None].repeat(C, 1, 1, 1)
    y = F.conv2d(a, w, groups=C)                                  # (B, 4C, H+1, W+1)
    h1, w1 = H + 1, W + 1
    y = y.reshape(B, C, 2, 2, h1, w1).permute(0, 1, 4, 2, 5, 3).reshape(B, C, 2 * h1, 2 * w1)
    return y[:, :, 1:-1, 1:-1]


class Upsampler(nn.Module):
    """BackwardCompatibleUpsampler: bicubic 2x, conv + ReLU, bicubic 2x,
    bilinear to the mask size, conv to one channel."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.conv1 = _conv(in_channels, in_channels // 2, 3)
        self.conv2 = _conv(in_channels // 2, 1, 3)

    def forward(self, x, image_size: Tuple[int, int]):
        x = torch.relu(self.conv1(pyr_up_bicubic(x)))
        return self.conv2(_interp(pyr_up_bicubic(x), image_size))


SEG_LAYERS = ("layer5", "layer4", "layer3", "layer2")
#: ResNet-50's channels of the decoder's features, by their seg names
SEG_CHANNELS = {"layer5": 2048, "layer4": 1024, "layer3": 512, "layer2": 256}


class SegNetwork(nn.Module):
    """The decoder: TSE, RRB, CAB, RRB from layer5 down to layer2, then the
    upsampler's projection to the mask logits."""

    def __init__(self, in_channels: int = 64, out_channels: int = 64):
        super().__init__()
        self.TSE = nn.ModuleDict({L: TSE(SEG_CHANNELS[L], in_channels, out_channels)
                                  for L in SEG_LAYERS})
        self.RRB1 = nn.ModuleDict({L: RRB(out_channels) for L in SEG_LAYERS})
        self.CAB = nn.ModuleDict({L: CAB(out_channels, L == "layer5") for L in SEG_LAYERS})
        self.RRB2 = nn.ModuleDict({L: RRB(out_channels) for L in SEG_LAYERS})
        self.project = Upsampler(out_channels)

    def forward(self, scores, features: Dict[str, torch.Tensor], image_size: Tuple[int, int]):
        x = None
        for L in SEG_LAYERS:
            ft = features[L]
            h, hpool = self.TSE[L](ft, _interp(scores, ft.shape[-2:]), x)
            h = self.CAB[L](hpool, self.RRB1[L](h))
            x = self.RRB2[L](h)
        return self.project(x, image_size)


@dataclasses.dataclass(frozen=True)
class RefineSpec:
    input_sz: int = 256
    pool_size: int = 8
    out_channels: int = 64            # the decoder's channels
    output_sz: Optional[int] = None   # None: pool_size * 2 * 16

    @property
    def mask_sz(self) -> int:
        return self.output_sz or self.pool_size * 2 * 16


class AlphaRefineNet(nn.Module):
    """ARnet_seg_mask: ResNet-50 seg backbone, CorrNL, SegNetwork. Inputs
    are NHWC normalised crops; `init_ref` gives the reference kernel
    (B, p, p, 1024), `forward` the mask logits (B, S, S, 1) at
    `spec.mask_sz` (the sigmoid is applied outside, as in the reference)."""

    def __init__(self, spec: RefineSpec = RefineSpec()):
        super().__init__()
        self.spec = spec
        self.feature_extractor = resnet50()
        self.neck = CorrNL(pool_size=spec.pool_size)
        self.refiner = SegNetwork(spec.pool_size ** 2, spec.out_channels)

    def _features(self, patch: torch.Tensor) -> Dict[str, torch.Tensor]:
        return seg_features(self.feature_extractor(patch.permute(0, 3, 1, 2)))

    def init_ref(self, patch_ref: torch.Tensor, box_xywh: torch.Tensor) -> torch.Tensor:
        """Reference branch: normalised crop (B, S, S, 3) and the box in crop
        pixels (B, 4) -> kernel (B, p, p, C)."""
        return self.neck.get_ref_kernel(self._features(patch_ref)["layer4"], box_xywh)

    def forward(self, patch_test: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
        """Test branch (mode 'mask'): -> (B, S, S, 1) mask logits."""
        feats = self._features(patch_test)
        score = self.neck(kernel, feats["layer4"])
        out = self.refiner(score, feats, (self.spec.mask_sz,) * 2)
        return out.permute(0, 2, 3, 1)

    def forward_train(self, patch_ref, box_ref, patch_test) -> torch.Tensor:
        """Both branches in one call."""
        return self(patch_test, self.init_ref(patch_ref, box_ref))


def set_refine_dtype(net: AlphaRefineNet, dtype: torch.dtype) -> AlphaRefineNet:
    """Make `net` compute in `dtype` (float32 or bfloat16; anything else
    raises), its parameters unchanged, with the precision flags of
    `utils.device.set_precision`."""
    if dtype not in DTYPES.values():
        raise ValueError(f"Alpha-Refine computes in float32 or bfloat16, not {dtype}")
    set_precision(dtype)
    return set_compute_dtype(net, dtype)


def build_alpha_refine(input_sz: int = 256, pool_size: int = 8, output_sz: Optional[int] = None,
                       device="cuda", seed: int = 0, dtype: torch.dtype = torch.float32
                       ) -> Tuple[AlphaRefineNet, RefineSpec]:
    """An AlphaRefineNet with random float32 weights from `seed` (PyTorch's
    default initialisation under a seeded generator), on `device` (CUDA
    unless "cpu"; raises without a card), in eval mode, computing in
    `dtype` (float32, the default and the VOT entries' dtype, with TF32
    off; or bfloat16; others raise). Trained weights load with
    `utils.checkpoint.load_variables`."""
    dev = resolve_device(device)
    spec = RefineSpec(input_sz=input_sz, pool_size=pool_size, output_sz=output_sz)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = AlphaRefineNet(spec)
    return set_refine_dtype(net, dtype).to(dev).eval(), spec


# ---------------------------------------------------------------------------
# Host-side SE crops (the reference's processing_utils_SE.py)
# ---------------------------------------------------------------------------

def sample_target_se(im: np.ndarray, box, search_area_factor: float, output_sz: int,
                     pad_mode: str = "constant") -> Tuple[np.ndarray, float, float]:
    """sample_target_SE: the anisotropic window ws = ceil(f w), hs =
    ceil(f h) centred on the box (with the reference's x2 - W + 1 padding
    quirk), bordered (constant or replicate), resized to a square.
    Returns (crop (S, S, C), h_rsz_f, w_rsz_f); uint8 crops are cv2's bit
    for bit, float ones within 1e-7 of cv2's (native.sample_target_se)."""
    return native.sample_target_se(im, box, search_area_factor, output_sz, pad_mode)


def transform_box_to_crop_se(box, rf_h: float, rf_w: float, crop_sz: int) -> np.ndarray:
    """transform_image_to_crop_SE with box_extract == box_in: centre at
    (crop_sz - 1) / 2, scale by the anisotropic resize factors, clamp to
    [0, crop_sz]."""
    x, y, w, h = [float(v) for v in box]
    cx = cy = (crop_sz - 1) / 2.0
    bw, bh = w * rf_w, h * rf_h
    x1 = np.clip(cx - 0.5 * bw, 0, crop_sz)
    y1 = np.clip(cy - 0.5 * bh, 0, crop_sz)
    x2 = np.clip(cx + 0.5 * bw, 0, crop_sz)
    y2 = np.clip(cy + 0.5 * bh, 0, crop_sz)
    return np.asarray([x1, y1, x2 - x1, y2 - y1], np.float32)


def map_mask_back(frame_hw: Tuple[int, int], box, search_area_factor: float,
                  mask: np.ndarray) -> np.ndarray:
    """map_mask_back: the crop's mask resized to the anisotropic window
    (cv2 INTER_LINEAR on float32) and pasted into a zero frame-sized
    canvas; float32 (H, W)."""
    H, W = frame_hw
    x, y, w, h = [float(v) for v in box]
    ws, hs = math.ceil(search_area_factor * w), math.ceil(search_area_factor * h)
    x1 = round(x + 0.5 * w - ws * 0.5)
    y1 = round(y + 0.5 * h - hs * 0.5)
    x2, y2 = x1 + ws, y1 + hs
    x1_pad, x2_pad = max(0, -x1), max(x2 - W + 1, 0)
    y1_pad, y2_pad = max(0, -y1), max(y2 - H + 1, 0)
    base = np.zeros((H + y1_pad + y2_pad, W + x1_pad + x2_pad), np.float32)
    base[y1 + y1_pad:y2 + y1_pad, x1 + x1_pad:x2 + x1_pad] = native.resize_linear(
        np.asarray(mask, np.float32), hs, ws)
    return base[y1_pad:y1_pad + H, x1_pad:x1_pad + W]


IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalise(patch: np.ndarray) -> np.ndarray:
    """ARcm_seg.img_preprocess: /255, then ImageNet mean and deviation, in
    float32 (the JAX package's numpy order)."""
    return (patch.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


class ARcmSeg:
    """Runtime wrapper (ARcm_seg): `initialize` caches the reference
    kernel of the first frame's box; `get_mask` refines a tracker box into
    the sigmoid mask in full-frame coordinates, float32 in [0, 1] (the
    caller thresholds; the VOT2020 entry uses 0.6).

    `net`: an AlphaRefineNet (its device is the wrapper's), or None to
    build one with random weights from `seed` at `spec` on `device`
    (CUDA unless "cpu"; raises without a card). `dtype` (float32 or
    bfloat16) sets the network's compute dtype; None keeps a given net's
    (float32 for a built one)."""

    def __init__(self, net: Optional[AlphaRefineNet] = None, spec: Optional[RefineSpec] = None,
                 search_factor: float = 2.0, device="cuda", seed: int = 0,
                 dtype: Optional[torch.dtype] = None):
        if net is None:
            spec = spec or RefineSpec()
            net, spec = build_alpha_refine(spec.input_sz, spec.pool_size, spec.output_sz,
                                           device=device, seed=seed,
                                           dtype=dtype or torch.float32)
        elif dtype is not None:
            set_refine_dtype(net, dtype)
        self.net = net.eval()
        self.spec = net.spec
        self.device = next(net.parameters()).device
        self.search_factor = search_factor
        self.kernel: Optional[torch.Tensor] = None

    def _upload(self, patch: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(normalise(patch)[None]).to(self.device)

    @torch.no_grad()
    def initialize(self, frame: np.ndarray, box) -> None:
        crop, h_f, w_f = sample_target_se(frame, box, self.search_factor, self.spec.input_sz)
        bic = transform_box_to_crop_se(box, h_f, w_f, self.spec.input_sz)
        self.kernel = self.net.init_ref(self._upload(crop),
                                        torch.from_numpy(bic[None]).to(self.device))

    @torch.no_grad()
    def mask_crop(self, frame: np.ndarray, box) -> torch.Tensor:
        """The sigmoid mask of the crop around `box`, (S, S) float32 on the
        device."""
        if self.kernel is None:
            raise RuntimeError("ARcmSeg.get_mask before initialize")
        crop, _, _ = sample_target_se(frame, box, self.search_factor, self.spec.input_sz)
        # the sigmoid in the compute dtype, as the JAX wrapper's
        return torch.sigmoid(self.net(self._upload(crop), self.kernel))[0, :, :, 0].float()

    def get_mask(self, frame: np.ndarray, box) -> np.ndarray:
        mask_crop = self.mask_crop(frame, box).cpu().numpy()
        return map_mask_back(frame.shape[:2], box, self.search_factor, mask_crop)
