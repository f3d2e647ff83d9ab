"""Numpy augmentations of the training data workers: the port's own copy of
the JAX package's `train/data/transforms.py` (the RGB-T part).

  JointAugment: grayscale (RGB only, p 0.05) and horizontal flip (p 0.5),
    rolled once per sample and shared by template and search;
  tensor_and_jitter_rgbt: brightness jitter (RGB and TIR draw independent
    factors from U[1 - b, 1 + b]), the JET map of the TIR crop, ImageNet
    normalisation of both;
  flip_norm: the per-crop flip of a processed crop and its normalised box.

Outputs are float32 HWC: the models are NHWC.
"""
from __future__ import annotations

import random
from typing import Optional

import numpy as np

from multi_modal_tracking_torch.ops.colormap import apply_jet_np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], dtype=np.float32)


class JointAugment:
    """Per-sample joint augmentation state: grayscale + horizontal flip."""

    def __init__(self, p_gray: float = 0.05, p_flip: float = 0.5,
                 rng: Optional[random.Random] = None):
        self.p_gray = p_gray
        self.p_flip = p_flip
        self.rng = rng or random

    def roll(self):
        return {"gray": self.rng.random() < self.p_gray,
                "flip": self.rng.random() < self.p_flip}

    @staticmethod
    def apply_image_pair(img_v: np.ndarray, img_i: np.ndarray, state: dict):
        if state["gray"]:
            # cv2 RGB2GRAY fixed point, rounding to nearest (RGB modality only)
            if np.issubdtype(img_v.dtype, np.integer):
                r, gg, b = (img_v[..., c].astype(np.int32) for c in range(3))
                g = ((9798 * r + 19235 * gg + 3735 * b + (1 << 14)) >> 15).astype(img_v.dtype)
            else:
                g = (0.299 * img_v[..., 0] + 0.587 * img_v[..., 1]
                     + 0.114 * img_v[..., 2]).astype(img_v.dtype)
            img_v = np.stack([g, g, g], axis=-1)
        if state["flip"]:
            img_v = img_v[:, ::-1].copy()
            img_i = img_i[:, ::-1].copy()
        return img_v, img_i

    @staticmethod
    def apply_box(box_xywh: np.ndarray, img_w: int, state: dict) -> np.ndarray:
        if state["flip"]:
            b = np.asarray(box_xywh, dtype=np.float32).copy()
            b[0] = img_w - b[0] - b[2] - 1
            return b
        return np.asarray(box_xywh, dtype=np.float32)


def brightness_factors(brightness_jitter: float, rng: Optional[random.Random] = None):
    """(RGB, TIR) brightness factors, independent draws from U[1 - b, 1 + b]."""
    rnd = rng or random
    lo, hi = max(0, 1 - brightness_jitter), 1 + brightness_jitter
    return rnd.uniform(lo, hi), rnd.uniform(lo, hi)


def tensor_and_jitter_rgbt(img_v: np.ndarray, img_i: np.ndarray,
                           brightness_jitter: float = 0.2,
                           rng: Optional[random.Random] = None):
    """uint8 crops -> normalised float32 (HWC) pair with brightness jitter and
    the TIR JET map."""
    bf, tir_f = brightness_factors(brightness_jitter, rng)

    v = np.clip(img_v.astype(np.float32) * (bf / 255.0), 0.0, 1.0)
    i8 = np.clip(img_i.astype(np.float32) * tir_f, 0.0, 255.0).astype(np.uint8)
    i = apply_jet_np(i8).astype(np.float32) / 255.0

    v = (v - IMAGENET_MEAN) / IMAGENET_STD
    i = (i - IMAGENET_MEAN) / IMAGENET_STD
    return v, i


def flip_norm(img: np.ndarray, box_norm: np.ndarray):
    """Horizontal flip of a processed crop and its [0, 1]-normalised xywh
    box: (x, y, w, h) -> (1 - x - w, y, w, h)."""
    return np.ascontiguousarray(img[:, ::-1]), flip_box_norm(box_norm)


def flip_box_norm(box_norm: np.ndarray) -> np.ndarray:
    """The box half of `flip_norm`: (x, y, w, h) -> (1 - x - w, y, w, h)."""
    b = np.asarray(box_norm, np.float32).copy()
    b[0] = 1.0 - b[0] - b[2]
    return b
