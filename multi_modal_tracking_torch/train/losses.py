"""Training objectives (the JAX package's `train/losses.py`): the box
head's CIoU + L1 on xyxy box vectors, the ground truth clamped to [0, 1],
weighted by TRAIN.IOU_WEIGHT / TRAIN.L1_WEIGHT (`box_losses`); in stage 2
(TRAIN_SCORE) the score branch's binary cross-entropy on its logits,
weighted by TRAIN.SCORE_WEIGHT, in place of the box loss (`score_loss`)."""
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


def score_loss(pred_scores: torch.Tensor, labels: torch.Tensor,
               score_weight: float) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean binary cross-entropy of the SPM's logits against the 0/1
    labels, as optax.sigmoid_binary_cross_entropy writes it (-y log
    sigmoid(x) - (1 - y) log sigmoid(-x)) and in the logits' dtype, as
    optax computes it (bf16 in a bf16 model), times score_weight. Returns
    (total, {"Loss/total", "Loss/scores"})."""
    x = pred_scores.reshape(-1)
    y = labels.reshape(-1).to(x.dtype)
    bce = (-y * torch.nn.functional.logsigmoid(x)
           - (1.0 - y) * torch.nn.functional.logsigmoid(-x)).mean()
    total = score_weight * bce
    return total, {"Loss/total": total, "Loss/scores": bce}
