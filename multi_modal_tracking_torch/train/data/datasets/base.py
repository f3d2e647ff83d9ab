"""Dataset adapter base classes and the image loader (the port's own copy
of the JAX package's `train/data/datasets/base.py`). The adapter API the
sampler consumes:

  get_num_sequences() -> int
  get_sequence_info(seq_id) -> {'bbox': (N, 2, 4), 'valid': (N,), 'visible': (N,)}
  get_frames(seq_id, ids, info) -> (frames, {'bbox': [..], ...}, meta)

RGB-T adapters return frames as [img_v, img_i] pairs and bbox rows (2, 4).
The file-based adapters read their frames with `opencv_loader`, which
decodes with the port's own JPEG/PNG decoder.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from multi_modal_tracking_torch import native


def opencv_loader(path: str) -> np.ndarray:
    """An image file -> RGB uint8 (H, W, 3), what the JAX package's
    `opencv_loader` reads (its libjpeg decoder for JPEGs, else cv2),
    through the port's decoder; a file it does not take raises
    ValueError with the path and the reason."""
    return native.imread(path)


class BaseVideoDataset:
    def __init__(self, name: str, root: str, image_loader=opencv_loader):
        self.name = name
        self.root = root
        self.image_loader = image_loader

    def get_name(self) -> str:
        return self.name

    def is_video_sequence(self) -> bool:
        return True

    def __len__(self) -> int:
        return self.get_num_sequences()

    def get_num_sequences(self) -> int:
        raise NotImplementedError

    def get_sequence_info(self, seq_id: int) -> dict:
        raise NotImplementedError

    def get_frames(self, seq_id: int, frame_ids: List[int], anno: Optional[dict] = None):
        raise NotImplementedError

    @staticmethod
    def _anno_frames(anno: dict, frame_ids: List[int]) -> dict:
        return {k: [np.asarray(v[f]) for f in frame_ids] for k, v in anno.items()}


class BaseImageDataset(BaseVideoDataset):
    def is_video_sequence(self) -> bool:
        return False
