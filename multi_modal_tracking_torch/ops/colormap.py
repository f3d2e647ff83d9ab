"""JET pseudo-colour mapping of TIR crops (cv2.COLORMAP_JET, bit-exact):
`apply_jet` on tensors (the tracking loop, on the device) and
`apply_jet_np` on uint8 numpy arrays (the training data workers)."""
from __future__ import annotations

import numpy as np
import torch


def _jet_table() -> np.ndarray:
    """(256, 3) uint8 BGR table of the closed form in `apply_jet`."""
    i = np.arange(256, dtype=np.float64)
    b = np.clip(np.minimum(4 * i + 128, -4 * i + 638), 0, 255) - (i == 159)
    g = np.clip(np.minimum(4 * i - 128, -4 * i + 892), 0, 255)
    r = np.clip(np.minimum(4 * i - 382, -4 * i + 1148), 0, 255)
    return np.stack([b, g, r], axis=-1).astype(np.uint8)


_JET_BGR = _jet_table()


def apply_jet_np(img: np.ndarray) -> np.ndarray:
    """uint8 (H, W) or (H, W, 3) -> (H, W, 3) JET-mapped uint8 in cv2's BGR
    byte order; a 3-channel input first goes through cv2's BGR2GRAY 15-bit
    fixed point."""
    idx = np.asarray(img, dtype=np.uint8)
    if idx.ndim == 3:
        x = idx.astype(np.int64)
        idx = np.clip((9798 * x[..., 2] + 19235 * x[..., 1] + 3735 * x[..., 0] + 16384) >> 15,
                      0, 255)
    return _JET_BGR[idx]


def apply_jet(img: torch.Tensor) -> torch.Tensor:
    """float/uint8 (..., H, W) or (..., H, W, 3) in 0..255 -> (..., H, W, 3)
    float32 JET-mapped values, still on the 0..255 scale, in cv2's BGR order.

    Closed form of cv2's 256-entry table: each channel is a clamped tent
    with slope +/-4 per index,

        B = clamp(min(4 i + 128, -4 i + 638), 0, 255) - [i == 159]
        G = clamp(min(4 i - 128, -4 i + 892), 0, 255)
        R = clamp(min(4 i - 382, -4 i + 1148), 0, 255)

    including cv2's single rounding artefact at B[159]. A 3-channel input
    first goes through cv2's BGR2GRAY 15-bit fixed point on channels rounded
    to integers.
    """
    if img.dim() >= 3 and img.shape[-1] == 3:
        xi = torch.round(img.float()).to(torch.int32)
        idx = (9798 * xi[..., 2] + 19235 * xi[..., 1] + 3735 * xi[..., 0] + 16384) >> 15
    else:
        idx = torch.round(img.float()).to(torch.int32)
    i = torch.clamp(idx, 0, 255).float()
    b = torch.clamp(torch.minimum(4.0 * i + 128.0, -4.0 * i + 638.0), 0.0, 255.0) \
        - (i == 159.0).float()
    g = torch.clamp(torch.minimum(4.0 * i - 128.0, -4.0 * i + 892.0), 0.0, 255.0)
    r = torch.clamp(torch.minimum(4.0 * i - 382.0, -4.0 * i + 1148.0), 0.0, 255.0)
    return torch.stack([b, g, r], dim=-1)
