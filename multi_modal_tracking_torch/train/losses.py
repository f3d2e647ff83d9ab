"""Training objective of the box head (the JAX package's
`train/losses.py box_losses`): CIoU + L1 on xyxy box vectors, the ground
truth clamped to [0, 1], weighted by TRAIN.IOU_WEIGHT / TRAIN.L1_WEIGHT."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from multi_modal_tracking_torch.ops.boxes import (box_cxcywh_to_xyxy, box_xywh_to_xyxy,
                                                  ciou, l1_loss)


def box_losses(pred_boxes: torch.Tensor, gt_xywh: torch.Tensor, iou_weight: float,
               l1_weight: float) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """pred_boxes: (B, N, 4) cxcywh in [0, 1]; gt_xywh: (B, 4) normalised.
    Returns (total, {"Loss/total", "Loss/ciou", "Loss/l1", "IoU"}), all 0-d
    tensors on the predictions' device."""
    B, N, _ = pred_boxes.shape
    pred_vec = box_cxcywh_to_xyxy(pred_boxes).reshape(-1, 4)
    gt_vec = torch.clamp(box_xywh_to_xyxy(gt_xywh), 0.0, 1.0)
    gt_vec = gt_vec[:, None, :].expand(B, N, 4).reshape(-1, 4)
    cious, ious = ciou(pred_vec, gt_vec)
    ciou_l = (1.0 - cious).mean()
    l1 = l1_loss(pred_vec, gt_vec)
    total = iou_weight * ciou_l + l1_weight * l1
    return total, {"Loss/total": total, "Loss/ciou": ciou_l, "Loss/l1": l1,
                   "IoU": ious.detach().mean()}
