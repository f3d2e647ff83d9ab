"""Box conversions, IoU family, CIoU and L1 on tensors (the tracking loop's
box math and the training losses' box terms). Boxes are [..., 4]."""
from __future__ import annotations

import math

import torch


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([(x0 + x1) * 0.5, (y0 + y1) * 0.5, x1 - x0, y1 - y0], dim=-1)


def box_xywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    x, y, w, h = b.unbind(-1)
    return torch.stack([x, y, x + w, y + h], dim=-1)


def box_xyxy_to_xywh(b: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([x0, y0, x1 - x0, y1 - y0], dim=-1)


def box_area(b: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes, shape [...]."""
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Elementwise IoU of xyxy boxes -> (iou, union), shape [...]."""
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes1) + box_area(boxes2) - inter
    return inter / union, union


def generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Elementwise GIoU of xyxy boxes -> (giou, iou)."""
    iou, union = box_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area, iou


def ciou(bboxes1: torch.Tensor, bboxes2: torch.Tensor):
    """Elementwise complete IoU of xyxy boxes -> (ciou, iou): IoU minus the
    normalised centre distance minus alpha * v (aspect-ratio term), with
    alpha = S * v / (1 - iou + v), S = [iou > 0.5], alpha held constant
    under differentiation, the result clamped to [-1, 1]."""
    w1 = bboxes1[..., 2] - bboxes1[..., 0]
    h1 = bboxes1[..., 3] - bboxes1[..., 1]
    w2 = bboxes2[..., 2] - bboxes2[..., 0]
    h2 = bboxes2[..., 3] - bboxes2[..., 1]
    cx1 = (bboxes1[..., 0] + bboxes1[..., 2]) * 0.5
    cy1 = (bboxes1[..., 1] + bboxes1[..., 3]) * 0.5
    cx2 = (bboxes2[..., 0] + bboxes2[..., 2]) * 0.5
    cy2 = (bboxes2[..., 1] + bboxes2[..., 3]) * 0.5

    inter_l = torch.maximum(cx1 - w1 * 0.5, cx2 - w2 * 0.5)
    inter_r = torch.minimum(cx1 + w1 * 0.5, cx2 + w2 * 0.5)
    inter_t = torch.maximum(cy1 - h1 * 0.5, cy2 - h2 * 0.5)
    inter_b = torch.minimum(cy1 + h1 * 0.5, cy2 + h2 * 0.5)
    inter_area = torch.clamp(inter_r - inter_l, min=0.0) * torch.clamp(inter_b - inter_t, min=0.0)

    c_l = torch.minimum(cx1 - w1 * 0.5, cx2 - w2 * 0.5)
    c_r = torch.maximum(cx1 + w1 * 0.5, cx2 + w2 * 0.5)
    c_t = torch.minimum(cy1 - h1 * 0.5, cy2 - h2 * 0.5)
    c_b = torch.maximum(cy1 + h1 * 0.5, cy2 + h2 * 0.5)

    inter_diag = (cx2 - cx1) ** 2 + (cy2 - cy1) ** 2
    c_diag = torch.clamp(c_r - c_l, min=0.0) ** 2 + torch.clamp(c_b - c_t, min=0.0) ** 2

    union = w1 * h1 + w2 * h2 - inter_area
    u = inter_diag / c_diag
    iou = inter_area / union
    v = (4.0 / (math.pi ** 2)) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    with torch.no_grad():
        S = (iou > 0.5).to(v.dtype)
        alpha = S * v / (1.0 - iou + v)
    return torch.clamp(iou - u - alpha * v, -1.0, 1.0), iou


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs().mean()


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
