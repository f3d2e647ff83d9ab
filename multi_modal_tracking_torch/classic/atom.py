"""ATOM: an online discriminative classifier with IoUNet box refinement,
the port's counterpart of the JAX package's `classic/atom.py`.

A classifier filter (Gauss-Newton CG over a protected-ring memory of
augmented target crops) finds the target on layer3 of a ResNet-18; the
AtomIoUNet (`dimpnet.AtomIoUNet`) refines the box by gradient ascent of
the predicted IoU over jittered proposals (the gradient reaches the box
through `ops/prroi.py`'s closed form); a hard negative re-solves at once.

Each frame is one eager dispatch of device operations with no read back
but one: the flag, score, centre and size in a single copy at the end,
after which the host decides the filter update. Random proposal jitter
comes from the draw hook (`augmentation.TorchDraws` by default).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from multi_modal_tracking_torch.classic.augmentation import Draw, InitAugmenter, TorchDraws
from multi_modal_tracking_torch.classic.common import (FLAG_NAMES, box_xywh, center_box, down2,
                                                       fetch, init_state,
                                                       protected_ring_insert, take,
                                                       upload_image)
from multi_modal_tracking_torch.classic.dcf import (FLAG_HARD_NEGATIVE, FLAG_NORMAL,
                                                    FLAG_NOT_FOUND, FLAG_UNCERTAIN, const, hann2d,
                                                    localize_advanced, max2d, subpixel_peak)
from multi_modal_tracking_torch.classic.dimpnet import (ATOMNet, AtomIoUNet, init_like_flax,
                                                        load_resnet)
from multi_modal_tracking_torch.classic.optimization import solve_normal_equations
from multi_modal_tracking_torch.ops.crop import crop_resize, normalize_imagenet
from multi_modal_tracking_torch.utils.device import resolve_device, set_precision


def refine_box_iounet(iou_net: AtomIoUNet, iou_feat, modulation, box_xywh: torch.Tensor,
                      uniform: torch.Tensor, *, jitter_pos: float = 0.1,
                      jitter_sz: float = 0.5, steps: int = 5, step_length: float = 1.0,
                      step_decay: float = 1.0, topk: int = 3,
                      max_aspect_ratio: float = 6.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """pytracking refine_target_box: num_random proposals jittered about
    the box (uniform (num_random, 4) in [0, 1): centre and size noise
    scaled by sqrt(area), sizes held at min_edge / 3 or more), the
    predicted IoU ascended on all of them (steps x step_length, coordinate
    steps scaled by the box size), boxes of aspect ratio outside (1 /
    max_ar, max_ar) dropped, the top-k survivors by IoU averaged. Shapes
    stay static: a dropped box's IoU is -inf, and with none left the input
    box comes back. box in crop px; returns (box xywh, mean top-k IoU)."""
    sq = torch.sqrt(torch.clamp(box_xywh[2] * box_xywh[3], min=1.0))
    factor = torch.stack([jitter_pos * sq, jitter_pos * sq, jitter_sz * sq, jitter_sz * sq])
    noise = (uniform - 0.5) * factor
    min_edge = torch.minimum(box_xywh[2], box_xywh[3]) / 3.0
    new_sz = torch.maximum(box_xywh[2:] + noise[:, 2:], min_edge)
    new_c = box_xywh[:2] + box_xywh[2:] / 2.0 + noise[:, :2]
    jittered = torch.cat([new_c - new_sz / 2.0, new_sz], dim=1)
    props = torch.cat([box_xywh[None], jittered], dim=0)            # (P, 4)

    def iou_of(p):
        return iou_net.predict_iou(modulation, iou_feat, p[None])[0]

    step = step_length
    for _ in range(steps):
        p = props.detach().requires_grad_(True)
        with torch.enable_grad():
            (grad,) = torch.autograd.grad(iou_of(p).sum(), p)
        scale = torch.cat([props[:, 2:], props[:, 2:]], dim=1)
        props = props + step * grad * scale
        step = step * step_decay
    props = torch.cat([props[:, :2], torch.clamp(props[:, 2:], min=1.0)], dim=1)
    ar = props[:, 2] / props[:, 3]
    valid = (ar < max_aspect_ratio) & (ar > 1.0 / max_aspect_ratio)
    ious = torch.where(valid, iou_of(props), torch.full_like(ar, -float("inf")))
    k = min(topk, props.shape[0])
    top_iou, top_idx = torch.topk(ious, k)
    sel = valid[top_idx].to(props.dtype)
    denom = torch.clamp(sel.sum(), min=1.0)
    best = torch.sum(props[top_idx] * sel[:, None], dim=0) / denom
    mean_iou = torch.sum(torch.where(sel > 0, top_iou, torch.zeros_like(top_iou))) / denom
    any_valid = valid.any()
    return (torch.where(any_valid, best, box_xywh),
            torch.where(any_valid, mean_iou, torch.zeros_like(mean_iou)))


class ATOMState(NamedTuple):
    filt: torch.Tensor        # (C, fh, fw) classifier filter
    samples: torch.Tensor     # (M, C, h, w) feature memory
    labels: torch.Tensor      # (M, h, w) Gaussian targets
    weights: torch.Tensor     # (M,) sample weights (0: an empty slot)
    mem_ptr: torch.Tensor     # int32 0-d ring counter
    center: torch.Tensor      # (2,) target centre (y, x), image px
    target_sz: torch.Tensor   # (2,) target (h, w), image px


def gauss_labels(h: int, w: int, sigma, centers: torch.Tensor) -> torch.Tensor:
    """Gaussian labels (N, h, w) at centres (N, 2) (cy, cx)."""
    dev = centers.device
    ky = torch.arange(h, dtype=torch.float32, device=dev)[None] - centers[:, :1]
    kx = torch.arange(w, dtype=torch.float32, device=dev)[None] - centers[:, 1:]
    gy = torch.exp(-0.5 * (ky / sigma) ** 2)
    gx = torch.exp(-0.5 * (kx / sigma) ** 2)
    return gy[:, :, None] * gx[:, None, :]


def conv_same(samples: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """The filter (C, fh, fw) correlated over (M, C, h, w) with XLA's
    'SAME' padding (an even filter pads one less before than after) ->
    (M, h, w)."""
    fh, fw = filt.shape[-2], filt.shape[-1]
    pad = [(fw - 1) // 2, fw - 1 - (fw - 1) // 2, (fh - 1) // 2, fh - 1 - (fh - 1) // 2]
    return torch.nn.functional.conv2d(torch.nn.functional.pad(samples, pad), filt[None])[:, 0]


@dataclasses.dataclass
class ATOMTracker:
    """The host API (initialize / track) over the device steps; the
    fields are the JAX package's, plus `device` (CUDA unless "cpu") and
    `draw` (the random-draw hook; None: TorchDraws from rng_seed)."""
    search_factor: float = 5.0
    crop_size: int = 288                # features at /16: 18x18
    filter_size: int = 4
    memory_size: int = 16
    learning_rate: float = 0.01
    reg: float = 0.1
    num_gn_iter: int = 2
    num_cg_iter: int = 5
    update_interval: int = 10
    sigma_factor: float = 0.25
    refine: bool = True
    scale_factors: Tuple[float, ...] = (1.0,)
    refine_steps: int = 5
    refine_lr: float = 1.0
    num_random_boxes: int = 9
    iounet_topk: int = 3
    rng_seed: int = 0
    augmentation: Optional[dict] = None
    random_shift_factor: float = 1.0 / 3.0
    advanced_localization: bool = True
    target_not_found_threshold: float = 0.25
    distractor_threshold: float = 0.8
    hard_negative_threshold: float = 0.5
    target_neighborhood_scale: float = 2.2
    displacement_scale: float = 0.8
    hard_negative_learning_rate: float = 0.02
    hard_negative_cg_iter: int = 5
    device: str = "cuda"
    draw: Optional[Draw] = None

    #: the JAX package's seed offsets of its two draws
    DRAW_OFFSETS = {"dropout": 2, "proposals": 3}

    def __post_init__(self):
        self.device = resolve_device(self.device)
        set_precision(torch.float32)
        self.augmenter = InitAugmenter(self.crop_size, spec=self.augmentation,
                                       random_shift_factor=self.random_shift_factor,
                                       seed=self.rng_seed)
        if self.augmenter.num_samples >= self.memory_size:
            raise ValueError(f"memory_size={self.memory_size} must exceed the augmented "
                             f"init batch {self.augmenter.num_samples}")
        self.net = ATOMNet()
        init_like_flax(self.net, torch.Generator().manual_seed(self.rng_seed))
        self.net.to(self.device).eval().requires_grad_(False)
        if self.draw is None:
            self.draw = TorchDraws(self.rng_seed, self.device, self.DRAW_OFFSETS)
        h = self.crop_size
        for _ in range(3):
            h = down2(h)
        self._l2_hw = (h, h)
        self._feat_hw = (down2(h), down2(h))
        self._feat_c = 256
        self._scale = self._feat_hw[0] / self.crop_size
        self._scales = torch.tensor(self.scale_factors, dtype=torch.float32, device=self.device)
        self._hann = hann2d(*self._feat_hw, device=self.device)

    def _draw(self, site: str, shape, frame: int) -> torch.Tensor:
        """The draw hook's uniforms on this tracker's device."""
        return self.draw(site, tuple(shape), frame).to(self.device)

    @property
    def backbone(self):
        return self.net.feature_extractor

    @property
    def iou_net(self) -> AtomIoUNet:
        return self.net.bb_regressor

    def load_backbone(self, state_dict) -> None:
        """A torchvision / pytracking ResNet-18 state dict into the feature
        extractor (`dimpnet.load_resnet`)."""
        load_resnet(self.backbone, state_dict)

    def load_network(self, state_dict) -> None:
        """A full ATOMnet checkpoint (feature_extractor.* + bb_regressor.*),
        strict (dimpnet.IGNORED_KEYS aside)."""
        self.net.load_network(state_dict)

    # ------------------------------------------------------------ device steps
    def _backbone(self, crops: torch.Tensor):
        """(N, H, W, 3) crops on the 0..255 scale -> {layer2, layer3} NCHW."""
        return self.backbone(normalize_imagenet(crops).permute(0, 3, 1, 2), last="layer3")

    def _features(self, image, center, size):
        crop, rf = crop_resize(image, center_box(center, size), self.search_factor,
                               self.crop_size)
        return self._backbone(crop[None]), 1.0 / rf

    def _features_pyramid(self, image, center, size):
        box = center_box(center, size)
        crops, pxs = [], []
        for sc in self.scale_factors:
            crop, rf = crop_resize(image, box, self.search_factor * sc, self.crop_size)
            crops.append(crop)
            pxs.append(1.0 / rf)
        return self._backbone(torch.stack(crops)), torch.stack(pxs)

    def _label(self, centers: torch.Tensor) -> torch.Tensor:
        h, w = self._feat_hw
        sigma = self.sigma_factor * float(np.sqrt(np.float32(h * w))) / self.search_factor
        return gauss_labels(h, w, sigma, centers)

    def _optimize_filter(self, state: ATOMState, num_gn_iter: Optional[int] = None,
                         num_cg_iter: Optional[int] = None) -> ATOMState:
        w = torch.sqrt(torch.clamp(state.weights, min=0.0))[:, None, None]
        sqrt_reg = float(np.sqrt(np.float32(self.reg)))

        def residual(filt):
            r = (conv_same(state.samples, filt) - state.labels) * w
            return {"data": r, "reg": sqrt_reg * filt}

        def jvp_fn(filt, d):                  # the residual is affine in the filter
            return {"data": conv_same(state.samples, d) * w, "reg": sqrt_reg * d}

        filt = state.filt
        gn = self.num_gn_iter if num_gn_iter is None else num_gn_iter
        cg = self.num_cg_iter if num_cg_iter is None else num_cg_iter
        for _ in range(gn):                   # a linear problem: GN repeats the CG solve
            filt = solve_normal_equations(residual, filt, num_iter=cg, jvp_fn=jvp_fn)
        return state._replace(filt=filt)

    def _init_fn(self, image, box) -> ATOMState:
        center, size = init_state(box)
        crop, _ = crop_resize(image, center_box(center, size), self.search_factor,
                              self.crop_size)
        feats = self._backbone(self.augmenter(crop))["layer3"]
        num = self.augmenter.dropout[0] if self.augmenter.dropout else 0
        feats = self.augmenter.augment_features(
            feats, self._draw("dropout", (num, 1, 1, feats.shape[1]), 0) if num else None)
        A = self.augmenter.num_samples
        h, w = self._feat_hw
        shifts = torch.from_numpy(self.augmenter.shifts).to(self.device)
        centers = torch.tensor([h / 2.0, w / 2.0], device=self.device)[None] + shifts * self._scale
        M = self.memory_size
        samples = feats.new_zeros((M,) + tuple(feats.shape[1:]))
        samples[:A] = feats
        labels = torch.zeros((M, h, w), device=self.device)
        labels[:A] = self._label(centers)
        weights = torch.zeros(M, device=self.device)
        weights[:A] = 1.0 / A
        st = ATOMState(filt=torch.zeros((self._feat_c, self.filter_size, self.filter_size),
                                        device=self.device),
                       samples=samples, labels=labels, weights=weights,
                       mem_ptr=torch.tensor(A, dtype=torch.int32, device=self.device),
                       center=center, target_sz=size)
        return self._optimize_filter(st)

    def _modulation(self, image, center, size):
        feats, px = self._features(image, center, size)
        sz_crop = size / px
        c = self.crop_size / 2.0
        box = torch.stack([c - sz_crop[1] / 2.0, c - sz_crop[0] / 2.0, sz_crop[1], sz_crop[0]])
        return self.iou_net.get_modulation(feats["layer2"], feats["layer3"], box[None])

    def _track_fn(self, state: ATOMState, image, modulation, frame: int):
        feats, pxs = self._features_pyramid(image, state.center, state.target_sz)
        scores = conv_same(feats["layer3"], state.filt) * self._hann[None]   # (S, h, w)
        best = torch.argmax(scores.amax(dim=(1, 2)))
        score = take(scores, best)
        feat = take(feats["layer3"], best)
        px = take(pxs, best)
        scale_best = take(self._scales, best)
        h, w = self._feat_hw
        dev = self.device
        fs = 1.0 / px
        if self.advanced_localization:
            disp_sc, flag, conf = localize_advanced(
                score, state.target_sz * fs * self._scale,
                not_found_threshold=self.target_not_found_threshold,
                distractor_threshold=self.distractor_threshold,
                hard_negative_threshold=self.hard_negative_threshold,
                target_neighborhood_scale=self.target_neighborhood_scale,
                displacement_scale=self.displacement_scale)
            peak = disp_sc + const([(h - 1) / 2.0, (w - 1) / 2.0], dev)
        else:
            conf, peak = max2d(score)
            peak = subpixel_peak(score, peak)
            flag = torch.full((), FLAG_NORMAL, dtype=torch.int32, device=dev)
        found = flag != FLAG_NOT_FOUND
        update_ok = found & (flag != FLAG_UNCERTAIN)
        half = const([h / 2.0, w / 2.0], dev)
        disp = (peak - half) * (1.0 / self._scale) * px
        center = state.center + disp
        c_crop = torch.full((2,), self.crop_size / 2.0, device=dev) + disp * fs
        sz_crop = state.target_sz * fs
        if self.refine:
            box = torch.stack([c_crop[1] - sz_crop[1] / 2.0, c_crop[0] - sz_crop[0] / 2.0,
                               sz_crop[1], sz_crop[0]])
            iou_feat = self.iou_net.get_iou_feat(take(feats["layer2"], best)[None], feat[None])
            refined, _ = refine_box_iounet(
                self.iou_net, iou_feat, modulation, box,
                self._draw("proposals", (self.num_random_boxes, 4), frame),
                steps=self.refine_steps, step_length=self.refine_lr, topk=self.iounet_topk)
            c_new = torch.stack([refined[1] + refined[3] / 2.0, refined[0] + refined[2] / 2.0])
            center = state.center + (c_new - self.crop_size / 2.0) * px
            target_sz = torch.clamp(torch.stack([refined[3], refined[2]]) * px, min=4.0)
        else:
            target_sz = state.target_sz * scale_best
        center = torch.where(found, center, state.center)
        target_sz = torch.where(found, target_sz, state.target_sz)

        lbl_center = half + (center - state.center) * fs * self._scale
        (samples, labels), weights, mem_ptr = protected_ring_insert(
            state.mem_ptr, update_ok, flag,
            [(state.samples, feat), (state.labels, self._label(lbl_center[None])[0])],
            state.weights, memory_size=self.memory_size,
            n_protected=min(self.augmenter.num_samples, self.memory_size - 1),
            learning_rate=self.learning_rate,
            hard_negative_learning_rate=self.hard_negative_learning_rate)
        return ATOMState(filt=state.filt, samples=samples, labels=labels, weights=weights,
                         mem_ptr=mem_ptr, center=center, target_sz=target_sz), conf, flag

    # ----------------------------------------------------------------- host API
    @torch.no_grad()
    def initialize(self, image: np.ndarray, info: dict) -> None:
        img = upload_image(image, self.device)
        box = torch.as_tensor(np.asarray(info["init_bbox"], np.float32), device=self.device)
        self._state = self._init_fn(img, box)
        # the reference branch of the IoUNet, kept for the sequence
        self._mod = self._modulation(img, self._state.center, self._state.target_sz)
        self._frame = 0

    @torch.no_grad()
    def track(self, image: np.ndarray, info: Optional[dict] = None) -> dict:
        self._frame += 1
        img = upload_image(image, self.device)
        self._state, conf, flag = self._track_fn(self._state, img, self._mod, self._frame)
        vals = fetch(flag, conf, self._state.center, self._state.target_sz)
        flag = int(vals[0])
        # the filter refresh: a boosted run at once on a hard negative, else
        # the periodic schedule
        if flag == FLAG_HARD_NEGATIVE:
            self._state = self._optimize_filter(self._state, num_gn_iter=1,
                                                num_cg_iter=self.hard_negative_cg_iter)
        elif self._frame % self.update_interval == 0:
            self._state = self._optimize_filter(self._state)
        return {"target_bbox": box_xywh(vals[2:4], vals[4:6]), "pred_score": vals[1],
                "flag": FLAG_NAMES[flag]}
