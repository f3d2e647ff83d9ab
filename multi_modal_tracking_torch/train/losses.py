"""Training objectives (the JAX package's `train/losses.py`): the box
head's CIoU + L1 on xyxy box vectors, the ground truth clamped to [0, 1],
weighted by TRAIN.IOU_WEIGHT / TRAIN.L1_WEIGHT (`box_losses`); in stage 2
(TRAIN_SCORE) the score branch's binary cross-entropy on its logits,
weighted by TRAIN.SCORE_WEIGHT, in place of the box loss (`score_loss`).

The classic trackers' objectives (the JAX package's train/losses.py:44-129):
`lb_hinge` (LBHinge), `iou_pred_loss` (IOULoss on left, right, top,
bottom offsets), `reg_loss` (REGLoss, loss_type "iou") and its gather
`_gather_feat_hw`."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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


def lb_hinge(prediction: torch.Tensor, label: torch.Tensor, threshold: float = 0.05,
             clip: Optional[float] = None) -> torch.Tensor:
    """Lower-bound hinge MSE (LBHinge): where the label is below
    `threshold` the sample is negative and only positive predictions are
    penalised (relu); positives take the squared error against the label."""
    negative = (label < threshold).to(prediction.dtype)
    positive = 1.0 - negative
    pred = negative * torch.relu(prediction) + positive * prediction
    loss = torch.mean((pred - positive * label) ** 2)
    if clip is not None:
        loss = torch.clamp(loss, max=clip)
    return loss


def iou_pred_loss(pred: torch.Tensor, target: torch.Tensor,
                  weight: Optional[torch.Tensor] = None, reduction: str = "mean") -> torch.Tensor:
    """-log IoU of (left, right, top, bottom) centre-offset encodings
    (IOULoss; columns [l, r, t, b]). With `weight`, the weighted mean when
    the weights sum above 0, else the plain reduction."""
    pl, pr, pt, pb = pred.unbind(1)
    tl, tr, tt, tb = target.unbind(1)
    target_area = (tl + tr) * (tt + tb)
    pred_area = (pl + pr) * (pt + pb)
    w_i = torch.minimum(pl, tl) + torch.minimum(pr, tr)
    h_i = torch.minimum(pb, tb) + torch.minimum(pt, tt)
    inter = w_i * h_i
    union = target_area + pred_area - inter
    losses = -torch.log((inter + 1.0) / (union + 1.0))
    plain = losses.mean() if reduction == "mean" else losses.sum()
    if weight is not None:
        wsum = weight.sum()
        return torch.where(wsum > 0, (losses * weight).sum() / torch.clamp(wsum, min=1e-8),
                           plain)
    return plain


def _gather_feat_hw(feat: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """feat (B, H*W, C) at flat spatial indices ind (B,) -> (B, C)."""
    return torch.gather(feat, 1, ind.long()[:, None, None].expand(-1, 1, feat.shape[-1]))[:, 0]


def reg_loss(output: torch.Tensor, ind: torch.Tensor, target: torch.Tensor, radius: int = 1,
             norm: float = 1.0 / 20.0) -> torch.Tensor:
    """Centre-vicinity ltrb regression loss (REGLoss, loss_type "iou").

    output (B, H, W, 4) ltrb map (NHWC), ind (B,) flat centre indices
    (h * W + w), target (B, 4) ltrb at the centre. Each offset (rw, rh) of
    the radius window shifts the targets by `norm` and gathers the
    prediction at the shifted centre; it counts only if all its shifted
    targets and centres are valid (the reference's batch-level checks),
    rows bounded by H and columns by W. The mean over the valid offsets,
    or the centre's loss when none is valid."""
    B, H, W, D = output.shape
    feat = output.reshape(B, H * W, D)
    cw = (ind % W).float()
    ch = torch.div(ind, W, rounding_mode="floor").float()
    center_loss = iou_pred_loss(_gather_feat_hw(feat, ind), target)
    losses, valids = [], []
    for rw in range(-radius, radius + 1):
        for rh in range(-radius, radius + 1):
            t = torch.stack([target[:, 0] + rw * norm, target[:, 1] - rw * norm,
                             target[:, 2] + rh * norm, target[:, 3] - rh * norm], dim=1)
            ok_t = torch.all(t >= 0.0)
            ok_c = torch.all((ch + rh >= 0) & (ch + rh < H) & (cw + rw >= 0) & (cw + rw < W))
            ind_c = torch.clamp(((ch + rh) * W + (cw + rw)).to(ind.dtype), 0, H * W - 1)
            losses.append(iou_pred_loss(_gather_feat_hw(feat, ind_c), t))
            valids.append(ok_t & ok_c)
    losses = torch.stack(losses)
    valid = torch.stack(valids).to(losses.dtype)
    n_valid = valid.sum()
    window_loss = (losses * valid).sum() / torch.clamp(n_valid, min=1.0)
    return torch.where(n_valid > 0, window_loss, center_loss)
