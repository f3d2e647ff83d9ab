"""Dataset adapter base class (the port's own copy of the JAX package's
`train/data/datasets/base.py`, without its image loader: the port's only
dataset so far renders its frames). The adapter API the sampler consumes:

  get_num_sequences() -> int
  get_sequence_info(seq_id) -> {'bbox': (N, 2, 4), 'valid': (N,), 'visible': (N,)}
  get_frames(seq_id, ids, info) -> (frames, {'bbox': [..], ...}, meta)

RGB-T adapters return frames as [img_v, img_i] pairs and bbox rows (2, 4).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


class BaseVideoDataset:
    def __init__(self, name: str, root: str):
        self.name = name
        self.root = root

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
