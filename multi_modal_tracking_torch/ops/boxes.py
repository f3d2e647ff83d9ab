"""Box conversions and clipping on tensors (the tracking loop's box math)."""
from __future__ import annotations

import torch


def box_xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([(x0 + x1) * 0.5, (y0 + y1) * 0.5, x1 - x0, y1 - y0], dim=-1)


def clip_box(box: torch.Tensor, H: int, W: int, margin: int = 0) -> torch.Tensor:
    """Clip a (4,) xywh box to the image, keeping at least `margin` pixels of
    width and height inside it (the tracking loop calls it with margin 10)."""
    x1, y1, w, h = box.unbind(-1)
    x2, y2 = x1 + w, y1 + h
    x1 = torch.clamp(x1, 0, W - margin)
    x2 = torch.clamp(x2, margin, W)
    y1 = torch.clamp(y1, 0, H - margin)
    y2 = torch.clamp(y2, margin, H)
    w = torch.clamp(x2 - x1, min=margin)
    h = torch.clamp(y2 - y1, min=margin)
    return torch.stack([x1, y1, w, h], dim=-1)
