"""Training-sample processing for RGB-T pairs: box jitter -> paired crops ->
transforms -> validity checks. The port's own copy of the JAX package's
`train/data/processing.py RGBTProcessing`, without cv2: the same random
draws in the same order, so one seed gives the same samples.

Per frame the jitter roll (scale, centre offset) is shared by both
modalities; both modal crops are taken around the jittered RGB box; a
sample is invalid when the crop would be empty or when the padding mask
covers the whole crop at full or stride-16 resolution.
"""
from __future__ import annotations

import random
from typing import Dict, Optional

import numpy as np

from multi_modal_tracking_torch.train.data import processing_utils as prutils
from multi_modal_tracking_torch.train.data.transforms import (JointAugment, flip_norm,
                                                              tensor_and_jitter_rgbt)


def _jittered_box(bbox: np.ndarray, center_jitter: float, roll) -> np.ndarray:
    """Jitter one xywh box by a (scale, offset) roll shared across modalities."""
    scale, offset_factor = roll
    bbox = np.asarray(bbox, dtype=np.float32)
    jittered_size = bbox[2:4] * scale
    max_offset = np.sqrt(jittered_size.prod()) * center_jitter
    jittered_center = bbox[0:2] + 0.5 * bbox[2:4] + max_offset * offset_factor
    return np.concatenate([jittered_center - 0.5 * jittered_size, jittered_size]).astype(np.float32)


def _att_mask_valid(att: np.ndarray, output_sz: int) -> bool:
    """False if the (padding) mask is all-True at full or /16 resolution."""
    if att.all():
        return False
    return not prutils.resize_nearest(att, output_sz // 16).all()


class RGBTProcessing:
    """Processes one raw RGB-T sample dict into normalised crop arrays."""

    def __init__(self, search_area_factor: Dict[str, float], output_sz: Dict[str, int],
                 center_jitter_factor: Dict[str, float], scale_jitter_factor: Dict[str, float],
                 p_gray: float = 0.05, p_flip: float = 0.5, brightness_jitter: float = 0.2,
                 rng: Optional[random.Random] = None, train: bool = True):
        self.search_area_factor = search_area_factor
        self.output_sz = output_sz
        self.center_jitter_factor = center_jitter_factor
        self.scale_jitter_factor = scale_jitter_factor
        self.brightness_jitter = brightness_jitter
        self.rng = rng or random.Random()
        self.joint = JointAugment(p_gray, p_flip, self.rng)
        # train: brightness jitter + a per-crop flip; val: neither
        self.train = train

    def __call__(self, data: dict, rng=None) -> dict:
        """data: template_images/search_images [N][2](H,W,3) uint8,
        template_anno/search_anno [N](2,4). Returns the processed dict with
        a 'valid' flag; on False the caller resamples."""
        rng = rng or self.rng
        state = JointAugment(self.joint.p_gray, self.joint.p_flip, rng).roll()

        for s in ("template", "search"):
            imgs, annos = [], []
            for img_vi, anno_vi in zip(data[s + "_images"], data[s + "_anno"]):
                v, i = self.joint.apply_image_pair(np.asarray(img_vi[0]), np.asarray(img_vi[1]),
                                                   state)
                annos.append((self.joint.apply_box(anno_vi[0], v.shape[1], state),
                              self.joint.apply_box(anno_vi[1], v.shape[1], state)))
                imgs.append((v, i))

            jit = []
            for a_v, a_i in annos:
                roll = (np.exp(np.asarray([rng.gauss(0, 1), rng.gauss(0, 1)])
                               * self.scale_jitter_factor[s]),
                        np.asarray([rng.random() - 0.5, rng.random() - 0.5]))
                jit.append((_jittered_box(a_v, self.center_jitter_factor[s], roll),
                            _jittered_box(a_i, self.center_jitter_factor[s], roll)))

            for jv, _ in jit:
                if np.ceil(np.sqrt(jv[2] * jv[3]) * self.search_area_factor[s]) < 1:
                    data["valid"] = False
                    return data

            out_v, out_i, boxes_v, boxes_i = [], [], [], []
            for (v, i), (a_v, a_i), (jv, _) in zip(imgs, annos, jit):
                try:
                    crop_v, rf_v, att_v = prutils.sample_target(v, jv, self.search_area_factor[s],
                                                                self.output_sz[s])
                    crop_i, rf_i, att_i = prutils.sample_target(i, jv, self.search_area_factor[s],
                                                                self.output_sz[s])
                except ValueError:
                    data["valid"] = False
                    return data
                if not (_att_mask_valid(att_v, self.output_sz[s])
                        and _att_mask_valid(att_i, self.output_sz[s])):
                    data["valid"] = False
                    return data
                b_v = prutils.transform_image_to_crop(a_v, jv, rf_v, self.output_sz[s],
                                                      normalize=True)
                b_i = prutils.transform_image_to_crop(a_i, jv, rf_i, self.output_sz[s],
                                                      normalize=True)
                cv_, ci_ = tensor_and_jitter_rgbt(
                    crop_v, crop_i, self.brightness_jitter if self.train else 0.0, rng)
                # per-crop flip, one roll per frame shared by both modalities
                if self.train and rng.random() < 0.5:
                    cv_, b_v = flip_norm(cv_, b_v)
                    ci_, b_i = flip_norm(ci_, b_i)
                boxes_v.append(b_v)
                boxes_i.append(b_i)
                out_v.append(cv_)
                out_i.append(ci_)

            data[s + "_images_v"] = out_v
            data[s + "_images_i"] = out_i
            data[s + "_anno_v"] = boxes_v
            data[s + "_anno_i"] = boxes_i
            del data[s + "_images"], data[s + "_anno"]

        data["valid"] = True
        return data
