"""Training-sample processing for RGB-T pairs (`RGBTProcessing`) and for
one modality (`UnimodalProcessing`): box jitter -> crops -> transforms ->
validity checks. The port's own copies of the JAX package's
`train/data/processing.py` classes, without cv2: the same random draws in
the same order, so one seed gives the same samples.

Per frame the jitter roll (scale, centre offset) is shared by both
modalities; both modal crops are taken around the jittered RGB box; a
sample is invalid when the crop would be empty or when the padding mask
covers the whole crop at full or stride-16 resolution.

The pixel work (crops, brightness jitter, JET, normalisation, the per-crop
flip) runs in the port's C++ host data library (`native`), which computes
what the numpy functions compute bit for bit and releases the interpreter
lock, so the loader's threads run in parallel. `pixels="plain"` runs the
numpy functions instead: the reference that tests and `chip_smoke.py`
compare with. Every random draw stays here, in the same order either way.
"""
from __future__ import annotations

import random
from typing import Dict, Optional

import numpy as np

from multi_modal_tracking_torch import native
from multi_modal_tracking_torch.train.data import processing_utils as prutils
from multi_modal_tracking_torch.train.data.transforms import (JointAugment, brightness_factors,
                                                              flip_box_norm, flip_norm,
                                                              tensor_and_jitter,
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
    """Processes one raw RGB-T sample dict into normalised crop arrays.
    `pixels` is "native" (the C++ host data library) or "plain" (numpy);
    both give the same bits."""

    def __init__(self, search_area_factor: Dict[str, float], output_sz: Dict[str, int],
                 center_jitter_factor: Dict[str, float], scale_jitter_factor: Dict[str, float],
                 p_gray: float = 0.05, p_flip: float = 0.5, brightness_jitter: float = 0.2,
                 rng: Optional[random.Random] = None, train: bool = True,
                 pixels: str = "native"):
        if pixels not in ("native", "plain"):
            raise ValueError(f"pixels must be 'native' or 'plain', got {pixels!r}")
        self.search_area_factor = search_area_factor
        self.output_sz = output_sz
        self.center_jitter_factor = center_jitter_factor
        self.scale_jitter_factor = scale_jitter_factor
        self.brightness_jitter = brightness_jitter
        self.rng = rng or random.Random()
        self.joint = JointAugment(p_gray, p_flip, self.rng)
        # train: brightness jitter + a per-crop flip; val: neither
        self.train = train
        self.pixels = pixels
        if pixels == "native":
            # build (or load) the library here, where a failure raises: in
            # a worker the sampler would catch it and resample forever
            native.library()

    def _crops(self, v, i, box, s: str, state: dict):
        """Both modal crops around `box`: (crop_v, rf_v, crop_i, rf_i, valid).
        Native: `v`, `i` are the frames before the joint augmentation, which
        the library applies as it reads them; plain: after it."""
        f, o = self.search_area_factor[s], self.output_sz[s]
        if self.pixels == "plain":
            crop_v, rf_v, att_v = prutils.sample_target(v, box, f, o)
            crop_i, rf_i, att_i = prutils.sample_target(i, box, f, o)
            return (crop_v, rf_v, crop_i, rf_i,
                    _att_mask_valid(att_v, o) and _att_mask_valid(att_i, o))
        if v.shape == i.shape:
            crop_v, crop_i, rf, ok = native.sample_target_pair(v, i, box, f, o, gray=state["gray"],
                                                               flip=state["flip"])
            return crop_v, rf, crop_i, rf, ok
        crop_v, rf_v, _, ok_v = native.sample_target(v, box, f, o, gray=state["gray"],
                                                     flip=state["flip"])
        crop_i, rf_i, _, ok_i = native.sample_target(i, box, f, o, flip=state["flip"])
        return crop_v, rf_v, crop_i, rf_i, ok_v and ok_i

    def _pixels(self, crop_v, crop_i, b_v, b_i, rng, dest=(None, None)):
        """Brightness jitter, JET, normalisation, then the per-crop flip
        (one roll per frame shared by both modalities) of a crop pair and
        its boxes. Native: the images are written into `dest` (float32
        arrays of the crops' shape, or None to allocate)."""
        b = self.brightness_jitter if self.train else 0.0
        if self.pixels == "native":
            bf, tir_f = brightness_factors(b, rng)
            flip = self.train and rng.random() < 0.5
            cv_, ci_ = native.jitter_jet_normalise(crop_v, crop_i, bf, tir_f, flip,
                                                   out_v=dest[0], out_i=dest[1])
            if flip:
                b_v, b_i = flip_box_norm(b_v), flip_box_norm(b_i)
            return cv_, ci_, b_v, b_i
        cv_, ci_ = tensor_and_jitter_rgbt(crop_v, crop_i, b, rng)
        if self.train and rng.random() < 0.5:
            cv_, b_v = flip_norm(cv_, b_v)
            ci_, b_i = flip_norm(ci_, b_i)
        return cv_, ci_, b_v, b_i

    def __call__(self, data: dict, rng=None, out=None) -> dict:
        """data: template_images/search_images [N][2](H,W,3) uint8,
        template_anno/search_anno [N](2,4). Returns the processed dict with
        a 'valid' flag; on False the caller resamples. `out(key, n_frames,
        frame, shape)` (or None) gives the float32 array that the native
        pixels write frame `frame` of image field `key` into (the sample's
        slot in its batch: `loader.BatchArrays.destination`)."""
        rng = rng or self.rng
        state = JointAugment(self.joint.p_gray, self.joint.p_flip, rng).roll()

        for s in ("template", "search"):
            imgs, annos = [], []
            for img_vi, anno_vi in zip(data[s + "_images"], data[s + "_anno"]):
                v, i = np.asarray(img_vi[0]), np.asarray(img_vi[1])
                width = v.shape[1]
                if self.pixels == "plain":
                    v, i = self.joint.apply_image_pair(v, i, state)
                annos.append((self.joint.apply_box(anno_vi[0], width, state),
                              self.joint.apply_box(anno_vi[1], width, state)))
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
            for f, ((v, i), (a_v, a_i), (jv, _)) in enumerate(zip(imgs, annos, jit)):
                try:
                    crop_v, rf_v, crop_i, rf_i, valid = self._crops(v, i, jv, s, state)
                except ValueError:
                    data["valid"] = False
                    return data
                if not valid:
                    data["valid"] = False
                    return data
                b_v = prutils.transform_image_to_crop(a_v, jv, rf_v, self.output_sz[s],
                                                      normalize=True)
                b_i = prutils.transform_image_to_crop(a_i, jv, rf_i, self.output_sz[s],
                                                      normalize=True)
                dest = (None, None) if out is None else tuple(
                    out(f"{s}_images_{m}", len(imgs), f, crop_v.shape) for m in "vi")
                cv_, ci_, b_v, b_i = self._pixels(crop_v, crop_i, b_v, b_i, rng, dest)
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


class UnimodalProcessing:
    """Processes one raw unimodal sample dict (template_images /
    search_images [N](H, W, 3) uint8, template_anno / search_anno [N](4,))
    into normalised crops, the JAX package's `UnimodalProcessing`: the joint
    grey and flip roll (the grey on the one image), then per frame its own
    jitter roll, the crop, the brightness jitter, normalisation and the
    per-crop flip. `pixels` as for RGBTProcessing."""

    def __init__(self, search_area_factor: Dict[str, float], output_sz: Dict[str, int],
                 center_jitter_factor: Dict[str, float], scale_jitter_factor: Dict[str, float],
                 p_gray: float = 0.05, p_flip: float = 0.5, brightness_jitter: float = 0.2,
                 rng: Optional[random.Random] = None, train: bool = True,
                 pixels: str = "native"):
        if pixels not in ("native", "plain"):
            raise ValueError(f"pixels must be 'native' or 'plain', got {pixels!r}")
        self.search_area_factor = search_area_factor
        self.output_sz = output_sz
        self.center_jitter_factor = center_jitter_factor
        self.scale_jitter_factor = scale_jitter_factor
        self.brightness_jitter = brightness_jitter
        self.rng = rng or random.Random()
        self.joint = JointAugment(p_gray, p_flip, self.rng)
        self.train = train
        self.pixels = pixels
        if pixels == "native":
            native.library()

    def _crop(self, img, box, s: str, state: dict):
        """(crop, resize factor, valid) of `img` (before the joint
        augmentation for the native pixels, after it for the plain ones)."""
        f, o = self.search_area_factor[s], self.output_sz[s]
        if self.pixels == "plain":
            crop, rf, att = prutils.sample_target(img, box, f, o)
            return crop, rf, _att_mask_valid(att, o)
        crop, rf, _, ok = native.sample_target(img, box, f, o, gray=state["gray"],
                                               flip=state["flip"])
        return crop, rf, ok

    def _pixels(self, crop, box, rng, dest=None):
        b = self.brightness_jitter if self.train else 0.0
        if self.pixels == "plain":
            c = tensor_and_jitter(crop, b, rng)
            if self.train and rng.random() < 0.5:
                c, box = flip_norm(c, box)
            return c, box
        bf = rng.uniform(max(0, 1 - b), 1 + b)
        flip = self.train and rng.random() < 0.5
        return native.jitter_normalise(crop, bf, flip, out=dest), \
            (flip_box_norm(box) if flip else box)

    def __call__(self, data: dict, rng=None, out=None) -> dict:
        """Returns the processed dict with a 'valid' flag; on False the
        caller resamples. `out` as for RGBTProcessing (image fields
        template_images / search_images)."""
        rng = rng or self.rng
        state = JointAugment(self.joint.p_gray, self.joint.p_flip, rng).roll()
        for s in ("template", "search"):
            imgs, annos = [], []
            for img, anno in zip(data[s + "_images"], data[s + "_anno"]):
                img = np.asarray(img)
                annos.append(self.joint.apply_box(anno, img.shape[1], state))
                imgs.append(self.joint.apply_image_pair(img, img, state)[0]
                            if self.pixels == "plain" else img)
            crops, boxes = [], []
            for f, (img, a) in enumerate(zip(imgs, annos)):
                roll = (np.exp(np.asarray([rng.gauss(0, 1), rng.gauss(0, 1)])
                               * self.scale_jitter_factor[s]),
                        np.asarray([rng.random() - 0.5, rng.random() - 0.5]))
                jb = _jittered_box(a, self.center_jitter_factor[s], roll)
                if np.ceil(np.sqrt(max(jb[2], 0) * max(jb[3], 0))
                           * self.search_area_factor[s]) < 1:
                    data["valid"] = False
                    return data
                try:
                    crop, rf, valid = self._crop(img, jb, s, state)
                except ValueError:
                    data["valid"] = False
                    return data
                if not valid:
                    data["valid"] = False
                    return data
                b = prutils.transform_image_to_crop(a, jb, rf, self.output_sz[s], normalize=True)
                dest = None if out is None else out(f"{s}_images", len(imgs), f, crop.shape)
                c, b = self._pixels(crop, b, rng, dest)
                crops.append(c)
                boxes.append(b)
            data[s + "_images"] = crops
            data[s + "_anno"] = boxes
        data["valid"] = True
        return data
