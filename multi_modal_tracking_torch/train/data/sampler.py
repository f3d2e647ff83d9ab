"""Frame sampling over training sequences: the port's own copy of the JAX
package's `train/data/sampler.py TrackingSampler`, the same draws in the
same order from the same seed.

A virtual epoch of samples_per_epoch items; the dataset is picked by
probability; sequences need > 2 * (Ns + Nt) visible frames and length
>= 20; frame-id modes causal / trident / trident_pro / stark; image
datasets repeat one frame; invalid samples are resampled; getitem_cls
draws the score-branch samples (50 % positives, negatives from invisible
frames or other sequences with a centred dummy box).
"""
from __future__ import annotations

import random
import threading
import traceback
from typing import List, Optional

import numpy as np


class TrackingSampler:
    def __init__(self, datasets, p_datasets, samples_per_epoch: int, max_gap,
                 num_search_frames: int = 1, num_template_frames: int = 1,
                 processing=None, frame_sample_mode: str = "causal",
                 train_cls: bool = False, pos_prob: float = 0.5,
                 rgbt: bool = True, seed: Optional[int] = None):
        self.datasets = datasets
        self.train_cls = train_cls
        self.pos_prob = pos_prob
        self.rgbt = rgbt
        if p_datasets is None:
            p_datasets = [len(d) for d in datasets]
        total = sum(p_datasets)
        self.p_datasets = [p / total for p in p_datasets]
        self.samples_per_epoch = samples_per_epoch
        self.max_gap = max_gap if isinstance(max_gap, (list, tuple)) else [max_gap]
        self.num_search_frames = num_search_frames
        self.num_template_frames = num_template_frames
        self.processing = processing
        self.frame_sample_mode = frame_sample_mode
        self.seed = seed
        self._tls = threading.local()

    @property
    def rng(self) -> random.Random:
        """Thread-local RNG, reseeded per item index in __getitem__."""
        r = getattr(self._tls, "rng", None)
        if r is None:
            r = random.Random(self.seed)
            self._tls.rng = r
        return r

    def __len__(self):
        return self.samples_per_epoch

    # ------------------------------------------------------------- frame ids
    def _sample_visible_ids(self, visible, num_ids=1, min_id=None, max_id=None,
                            allow_invisible=False, force_invisible=False):
        if num_ids == 0:
            return []
        if min_id is None or min_id < 0:
            min_id = 0
        if max_id is None or max_id > len(visible):
            max_id = len(visible)
        if force_invisible:
            valid = [i for i in range(min_id, max_id) if not visible[i]]
        elif allow_invisible:
            valid = list(range(min_id, max_id))
        else:
            valid = [i for i in range(min_id, max_id) if visible[i]]
        if not valid:
            return None
        return self.rng.choices(valid, k=num_ids)

    def _sample_seq(self, dataset, is_video: bool):
        while True:
            seq_id = self.rng.randint(0, dataset.get_num_sequences() - 1)
            info = dataset.get_sequence_info(seq_id)
            visible = np.asarray(info["visible"])
            enough = (visible.sum() > 2 * (self.num_search_frames + self.num_template_frames)
                      and len(visible) >= 20)
            if enough or not is_video:
                return seq_id, visible, info

    def _ids_causal(self, visible):
        template_ids, search_ids, gap_increase = None, None, 0
        while search_ids is None:
            base = self._sample_visible_ids(visible, 1, self.num_template_frames - 1,
                                            len(visible) - self.num_search_frames)
            if base is None:
                return None, None
            prev = self._sample_visible_ids(visible, self.num_template_frames - 1,
                                            base[0] - self.max_gap[0] - gap_increase, base[0])
            if prev is None:
                gap_increase += 5
                continue
            template_ids = base + prev
            search_ids = self._sample_visible_ids(visible, self.num_search_frames,
                                                  template_ids[0] + 1,
                                                  template_ids[0] + self.max_gap[0] + gap_increase)
            gap_increase += 5
        return template_ids, search_ids

    def _ids_trident(self, visible, allow_invisible: bool):
        while True:
            extra: List[Optional[int]] = []
            t1 = self._sample_visible_ids(visible, 1)
            s = self._sample_visible_ids(visible, 1)
            if t1 is None or s is None:
                continue
            for max_gap in self.max_gap:
                if t1[0] >= s[0]:
                    min_id, max_id = s[0], s[0] + max_gap
                else:
                    min_id, max_id = s[0] - max_gap, s[0]
                f = self._sample_visible_ids(visible, 1, min_id, max_id,
                                             allow_invisible=allow_invisible)
                extra += f if f is not None else [None]
            if extra and None not in extra:
                return t1 + extra, s

    def _ids_stark(self, visible, valid):
        while True:
            extra: List[Optional[int]] = []
            t1 = self._sample_visible_ids(visible, 1)
            s = self._sample_visible_ids(visible, 1)
            if t1 is None or s is None:
                continue
            for max_gap in self.max_gap:
                if t1[0] >= s[0]:
                    min_id, max_id = s[0], s[0] + max_gap
                else:
                    min_id, max_id = s[0] - max_gap, s[0]
                f = self._sample_visible_ids(valid, 1, min_id, max_id)
                extra += f if f is not None else [None]
            if extra and None not in extra:
                return t1 + extra, s

    # ---------------------------------------------------------------- getitem
    def __getitem__(self, index):
        # Per-index RNG: deterministic under concurrent (threaded) loading.
        self._tls.rng = random.Random(hash((self.seed, index)))
        return self.getitem_cls() if self.train_cls else self.getitem()

    def getitem(self):
        while True:
            dataset = self.rng.choices(self.datasets, self.p_datasets)[0]
            is_video = dataset.is_video_sequence()
            seq_id, visible, info = self._sample_seq(dataset, is_video)
            if is_video:
                if self.frame_sample_mode == "causal":
                    t_ids, s_ids = self._ids_causal(visible)
                elif self.frame_sample_mode in ("trident", "trident_pro"):
                    t_ids, s_ids = self._ids_trident(
                        visible, allow_invisible=self.frame_sample_mode == "trident_pro")
                elif self.frame_sample_mode == "stark":
                    t_ids, s_ids = self._ids_stark(visible, info["valid"])
                else:
                    raise ValueError(f"Illegal frame sample mode {self.frame_sample_mode}")
                if t_ids is None:
                    continue
            else:
                t_ids = [0] * self.num_template_frames
                s_ids = [0] * self.num_search_frames
            try:
                t_frames, t_anno, _ = dataset.get_frames(seq_id, t_ids, info)
                s_frames, s_anno, _ = dataset.get_frames(seq_id, s_ids, info)
                data = {"template_images": t_frames, "template_anno": t_anno["bbox"],
                        "search_images": s_frames, "search_anno": s_anno["bbox"],
                        "dataset": dataset.get_name()}
                data = self.processing(data, rng=self.rng)
                if data.get("valid"):
                    return data
            except Exception:
                traceback.print_exc()

    def _center_box(self, H, W, ratio=1 / 8):
        cx, cy, w, h = W / 2, H / 2, W * ratio, H * ratio
        b = np.asarray([int(cx - w / 2), int(cy - h / 2), int(w), int(h)], np.float32)
        return np.stack([b, b]) if self.rgbt else b

    def _one_search(self):
        dataset = self.rng.choices(self.datasets, self.p_datasets)[0]
        is_video = dataset.is_video_sequence()
        seq_id, visible, info = self._sample_seq(dataset, is_video)
        if is_video:
            if self.frame_sample_mode == "stark":
                s_ids = self._sample_visible_ids(info["valid"], 1)
            else:
                s_ids = self._sample_visible_ids(visible, 1, allow_invisible=True)
        else:
            s_ids = [0]
        return dataset.get_frames(seq_id, s_ids, info)

    def getitem_cls(self):
        """SPM stage-2 sample: label 1 with a real search box, label 0 with an
        invisible frame or a centred dummy box from another sequence
        (sampler_rgbt.py:114-207)."""
        label = 1.0 if self.rng.random() < self.pos_prob else 0.0
        while True:
            dataset = self.rng.choices(self.datasets, self.p_datasets)[0]
            is_video = dataset.is_video_sequence()
            seq_id, visible, info = self._sample_seq(dataset, is_video)
            if is_video:
                if self.frame_sample_mode in ("trident", "trident_pro"):
                    t_ids, s_ids = self._ids_trident(
                        visible, self.frame_sample_mode == "trident_pro")
                elif self.frame_sample_mode == "stark":
                    t_ids, s_ids = self._ids_stark(visible, info["valid"])
                else:
                    t_ids, s_ids = self._ids_causal(visible)
                if t_ids is None:
                    continue
            else:
                t_ids = [0] * self.num_template_frames
                s_ids = [0]
            try:
                t_frames, t_anno, _ = dataset.get_frames(seq_id, t_ids, info)
                if label == 1.0:
                    s_frames, s_anno, _ = dataset.get_frames(seq_id, s_ids, info)
                else:
                    # negatives, reference semantics (sampler_rgbt.py:159-171):
                    # video -> prefer an invisible frame whose (garbage) anno
                    # is REPLACED by the centred dummy box (template-frame
                    # dims); no invisible frame / image dataset -> a random
                    # other-sequence search with its REAL anno (the crop then
                    # centres on a wrong object — that mismatch IS the
                    # negative signal)
                    neg_ids = self._sample_visible_ids(
                        visible, 1, force_invisible=True) if is_video else None
                    if neg_ids is not None:
                        s_frames, s_anno, _ = dataset.get_frames(seq_id, neg_ids, info)
                        h, w = np.asarray(t_frames[0][0] if self.rgbt
                                          else t_frames[0]).shape[:2]
                        s_anno = dict(s_anno)
                        s_anno["bbox"] = [self._center_box(h, w)]
                    else:
                        s_frames, s_anno, _ = self._one_search()
                data = {"template_images": t_frames, "template_anno": t_anno["bbox"],
                        "search_images": s_frames, "search_anno": s_anno["bbox"],
                        "dataset": dataset.get_name(), "label": np.float32(label)}
                data = self.processing(data, rng=self.rng)
                if data.get("valid"):
                    return data
            except Exception:
                traceback.print_exc()
