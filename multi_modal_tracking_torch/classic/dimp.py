"""DiMP: learned discriminative filter prediction with IoUNet box
refinement, the port's counterpart of the JAX package's `classic/dimp.py`.

The classification features (layer3 through the learned extractor) seed
a filter with FilterInitializerLinear and refine it with the learned
steepest-descent Gauss-Newton optimizer (init_opt_iter steps at init,
update_opt_iter on the periodic schedule, hn_opt_iter on a hard
negative) over a protected-ring memory; the AtomIoUNet refines the box as
ATOM's does (`atom.refine_box_iounet`). arch "resnet18" (DiMP-18) or
"resnet50" (DiMP-50).

Each frame is one eager dispatch with one read back (flag, score, centre,
size in one copy), as in ATOM.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from multi_modal_tracking_torch.classic.atom import refine_box_iounet
from multi_modal_tracking_torch.classic.augmentation import Draw, InitAugmenter, TorchDraws
from multi_modal_tracking_torch.classic.common import (FLAG_NAMES, box_xywh, center_box, down2,
                                                       fetch, init_state,
                                                       protected_ring_insert, upload_image)
from multi_modal_tracking_torch.classic.dcf import (FLAG_HARD_NEGATIVE, FLAG_NORMAL,
                                                    FLAG_NOT_FOUND, FLAG_UNCERTAIN, const, hann2d,
                                                    localize_advanced, max2d, subpixel_peak)
from multi_modal_tracking_torch.classic.dimpnet import (ARCH, AtomIoUNet, DiMPClassifier, DiMPNet,
                                                        init_like_flax)
from multi_modal_tracking_torch.ops.crop import crop_resize, normalize_imagenet
from multi_modal_tracking_torch.utils.device import resolve_device, set_precision


class DiMPState(NamedTuple):
    filt: torch.Tensor        # (C, fs, fs) classification filter
    samples: torch.Tensor     # (M, C, h, w) classification features
    boxes: torch.Tensor       # (M, 4) each sample's target xywh, crop px
    weights: torch.Tensor     # (M,) sample weights (0: an empty slot)
    mem_ptr: torch.Tensor     # int32 0-d ring counter
    center: torch.Tensor      # (2,) target centre (y, x), image px
    target_sz: torch.Tensor   # (2,) target (h, w), image px


@dataclasses.dataclass
class DiMPTracker:
    """The host API (initialize / track) over the device steps; the
    fields are the JAX package's, plus `device` (CUDA unless "cpu") and
    `draw` (the random-draw hook; None: TorchDraws from rng_seed)."""
    arch: str = "resnet18"              # "resnet50" for DiMP-50
    search_factor: float = 5.0
    crop_size: int = 288
    filter_size: int = 4
    memory_size: int = 16
    learning_rate: float = 0.01
    init_opt_iter: int = 10
    update_opt_iter: int = 2
    update_interval: int = 20
    window_output: bool = False
    refine: bool = True
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
    hn_opt_iter: int = 1
    device: str = "cuda"
    draw: Optional[Draw] = None

    DRAW_OFFSETS = {"dropout": 3, "proposals": 4}

    def __post_init__(self):
        self.device = resolve_device(self.device)
        set_precision(torch.float32)
        self.augmenter = InitAugmenter(self.crop_size, spec=self.augmentation,
                                       random_shift_factor=self.random_shift_factor,
                                       seed=self.rng_seed)
        if self.augmenter.num_samples >= self.memory_size:
            raise ValueError(f"memory_size={self.memory_size} must exceed the augmented "
                             f"init batch {self.augmenter.num_samples}")
        self.net = DiMPNet(self.arch, self.filter_size, self.init_opt_iter)
        init_like_flax(self.net, torch.Generator().manual_seed(self.rng_seed))
        self.net.to(self.device).eval().requires_grad_(False)
        if self.draw is None:
            self.draw = TorchDraws(self.rng_seed, self.device, self.DRAW_OFFSETS)
        h = self.crop_size
        for _ in range(4):
            h = down2(h)
        self._feat_hw = (h, h)
        self._scale = h / self.crop_size
        self._clf_c = ARCH[self.arch][3]
        self._hann = hann2d(h + (self.filter_size + 1) % 2, h + (self.filter_size + 1) % 2,
                            device=self.device)

    def _draw(self, site: str, shape, frame: int) -> torch.Tensor:
        """The draw hook's uniforms on this tracker's device."""
        return self.draw(site, tuple(shape), frame).to(self.device)

    @property
    def backbone(self):
        return self.net.feature_extractor

    @property
    def classifier(self) -> DiMPClassifier:
        return self.net.classifier

    @property
    def iou_net(self) -> AtomIoUNet:
        return self.net.bb_regressor

    def load_network(self, state_dict) -> None:
        """A full DiMPnet checkpoint (feature_extractor.* + classifier.* +
        bb_regressor.*), strict (dimpnet.IGNORED_KEYS aside)."""
        self.net.load_network(state_dict)

    # ------------------------------------------------------------ device steps
    def _features(self, image, center, size):
        crop, rf = crop_resize(image, center_box(center, size), self.search_factor,
                               self.crop_size)
        feats = self.backbone(normalize_imagenet(crop[None]).permute(0, 3, 1, 2), last="layer3")
        return feats, self.classifier.extract_classification_feat(feats["layer3"]), 1.0 / rf

    def _target_box_crop(self, size_img, px, shift_yx=None):
        """Target xywh in crop px, centred, moved by shift_yx ((..., 2) or
        None) -> (..., 4)."""
        sz = size_img / px
        c = self.crop_size / 2.0
        if shift_yx is None:
            shift_yx = torch.zeros(2, device=sz.device)
        dy, dx = shift_yx[..., 0], shift_yx[..., 1]
        return torch.stack([c + dx - sz[1] / 2.0, c + dy - sz[0] / 2.0,
                            sz[1].expand_as(dx), sz[0].expand_as(dx)], dim=-1)

    def _init_fn(self, image, box) -> DiMPState:
        center, size = init_state(box)
        crop, rf = crop_resize(image, center_box(center, size), self.search_factor,
                               self.crop_size)
        l3 = self.backbone(normalize_imagenet(self.augmenter(crop)).permute(0, 3, 1, 2),
                           last="layer3")["layer3"]
        clf = self.classifier.extract_classification_feat(l3)
        num = self.augmenter.dropout[0] if self.augmenter.dropout else 0
        clf = self.augmenter.augment_features(
            clf, self._draw("dropout", (num, 1, 1, clf.shape[1]), 0) if num else None)
        A = self.augmenter.num_samples
        shifts = torch.from_numpy(self.augmenter.shifts).to(self.device)
        boxes = self._target_box_crop(size, 1.0 / rf, shifts)              # (A, 4)
        filt = self.classifier.get_filter(clf, boxes, None, self.init_opt_iter)
        M = self.memory_size
        samples = clf.new_zeros((M,) + tuple(clf.shape[1:]))
        samples[:A] = clf
        box_mem = torch.zeros((M, 4), device=self.device)
        box_mem[:A] = boxes
        weights = torch.zeros(M, device=self.device)
        weights[:A] = 1.0 / A
        return DiMPState(filt=filt, samples=samples, boxes=box_mem, weights=weights,
                         mem_ptr=torch.tensor(A, dtype=torch.int32, device=self.device),
                         center=center, target_sz=size)

    def _update_fn(self, state: DiMPState, num_iter: Optional[int] = None) -> DiMPState:
        filt = self.classifier.optimize_filter(
            state.filt, state.samples, state.boxes, state.weights,
            self.update_opt_iter if num_iter is None else num_iter)
        return state._replace(filt=filt)

    def _modulation(self, image, center, size):
        feats, _, px = self._features(image, center, size)
        box = self._target_box_crop(size, px)
        return self.iou_net.get_modulation(feats["layer2"], feats["layer3"], box[None])

    def _track_fn(self, state: DiMPState, image, modulation, frame: int):
        feats, clf_feat, px = self._features(image, state.center, state.target_sz)
        score = self.classifier.classify(state.filt, clf_feat)[0]         # (sh, sw)
        sh, sw = score.shape
        if self.window_output:
            score = score * self._hann
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
        else:
            conf, peak = max2d(score)
            disp_sc = subpixel_peak(score, peak) - const([(sh - 1) / 2.0, (sw - 1) / 2.0], dev)
            flag = torch.full((), FLAG_NORMAL, dtype=torch.int32, device=dev)
        found = flag != FLAG_NOT_FOUND
        update_ok = found & (flag != FLAG_UNCERTAIN)
        disp = disp_sc * (1.0 / self._scale) * px
        center = state.center + disp
        if self.refine:
            c_crop = torch.full((2,), self.crop_size / 2.0, device=dev) + disp * fs
            sz_crop = state.target_sz * fs
            box = torch.stack([c_crop[1] - sz_crop[1] / 2.0, c_crop[0] - sz_crop[0] / 2.0,
                               sz_crop[1], sz_crop[0]])
            iou_feat = self.iou_net.get_iou_feat(feats["layer2"], feats["layer3"])
            best, _ = refine_box_iounet(
                self.iou_net, iou_feat, modulation, box,
                self._draw("proposals", (self.num_random_boxes, 4), frame),
                steps=self.refine_steps, step_length=self.refine_lr, topk=self.iounet_topk)
            c_new = torch.stack([best[1] + best[3] / 2.0, best[0] + best[2] / 2.0])
            center = state.center + (c_new - self.crop_size / 2.0) * px
            target_sz = torch.clamp(torch.stack([best[3], best[2]]) * px, min=4.0)
        else:
            target_sz = state.target_sz
        center = torch.where(found, center, state.center)
        target_sz = torch.where(found, target_sz, state.target_sz)

        new_box = self._target_box_crop(target_sz, px, (center - state.center) * fs)
        (samples, boxes), weights, mem_ptr = protected_ring_insert(
            state.mem_ptr, update_ok, flag,
            [(state.samples, clf_feat[0]), (state.boxes, new_box)],
            state.weights, memory_size=self.memory_size,
            n_protected=min(self.augmenter.num_samples, self.memory_size - 1),
            learning_rate=self.learning_rate,
            hard_negative_learning_rate=self.hard_negative_learning_rate)
        return DiMPState(filt=state.filt, samples=samples, boxes=boxes, weights=weights,
                         mem_ptr=mem_ptr, center=center, target_sz=target_sz), conf, flag

    # ----------------------------------------------------------------- host API
    @torch.no_grad()
    def initialize(self, image: np.ndarray, info: dict) -> None:
        img = upload_image(image, self.device)
        box = torch.as_tensor(np.asarray(info["init_bbox"], np.float32), device=self.device)
        self._state = self._init_fn(img, box)
        self._mod = self._modulation(img, self._state.center, self._state.target_sz)
        self._frame = 0

    @torch.no_grad()
    def track(self, image: np.ndarray, info: Optional[dict] = None) -> dict:
        self._frame += 1
        img = upload_image(image, self.device)
        self._state, conf, flag = self._track_fn(self._state, img, self._mod, self._frame)
        vals = fetch(flag, conf, self._state.center, self._state.target_sz)
        flag = int(vals[0])
        # the filter refresh: a short run at once on a hard negative, else
        # the periodic schedule on frames whose sample entered the memory
        if flag == FLAG_HARD_NEGATIVE:
            self._state = self._update_fn(self._state, num_iter=self.hn_opt_iter)
        elif flag == FLAG_NORMAL and self._frame % self.update_interval == 0:
            self._state = self._update_fn(self._state)
        return {"target_bbox": box_xywh(vals[2:4], vals[4:6]), "pred_score": vals[1],
                "flag": FLAG_NAMES[flag]}
