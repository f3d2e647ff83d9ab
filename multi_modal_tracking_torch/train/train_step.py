"""One training step and one val step of the RGB-T flagship, and the CE
keep-rate schedule.

The port's counterpart of the JAX package's `train/train_step.py`: forward
on the bimodal crops in training mode, CIoU + L1 loss, backward (K2 and K4
on the GPU, or K2-bf16 and K4-bf16 in bf16), then the optimizer's update
(global-norm clip and AdamW, once per ACCUM_ITER micro-batches). The
model's compute dtype is its precision policy, as the JAX package's
`dtype=bf16` is ("AMP becomes the bf16 compute policy — no loss scaler",
train/train_step.py:9-10): parameters, gradients, optimizer state and the
loss stay float32 whatever it is. The metrics include `grad_norm`, the global
norm of this micro-batch's gradients before clipping. The val step runs the
model in eval mode without gradients and without a keep rate. Metrics come
back as 0-d device tensors, so a caller that does not read them every step
does not synchronise with the device every step.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from multi_modal_tracking_torch.models.layers import compute_dtype
from multi_modal_tracking_torch.train.losses import box_losses
from multi_modal_tracking_torch.utils.device import (require_float32_params, resolve_device,
                                                     set_precision)


def adjust_keep_rate(epoch: int, warmup_epochs: int, total_epochs: int,
                     iters_per_epoch: int, base_keep_rate: float = 0.5,
                     max_keep_rate: float = 1.0, iters: int = -1) -> float:
    """Cosine CE keep-rate schedule: 1 before warmup_epochs, base_keep_rate
    from total_epochs on, a cosine between."""
    if epoch < warmup_epochs:
        return 1.0
    if epoch >= total_epochs:
        return base_keep_rate
    if iters == -1:
        iters = epoch * iters_per_epoch
    total_iters = iters_per_epoch * (total_epochs - warmup_epochs)
    iters = iters - iters_per_epoch * warmup_epochs
    return base_keep_rate + (max_keep_rate - base_keep_rate) * \
        (math.cos(iters / total_iters * math.pi) + 1) * 0.5


def bucketize_keep_rate(rate: Optional[float], n_search: int, bucket: int = 16) -> Optional[float]:
    """Round a keep rate so ceil(rate * n_search) goes UP to a multiple of
    `bucket` tokens (never pruning more than the schedule asks); the set of
    keep lengths, and so of kernel shapes, stays small."""
    if rate is None or rate >= 1.0:
        return rate
    keep = math.ceil(rate * n_search)
    keep_b = min(n_search, math.ceil(keep / bucket) * bucket)
    return keep_b / n_search


def model_inputs(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Host batch (`batch_to_model_inputs`) -> the model's stacked bimodal
    inputs on `device`: t/ot/s (2B, H, W, 3), [:B] RGB, [B:] TIR, and
    gt_xywh (B, 4)."""
    def up(*keys):
        x = np.concatenate([batch[k] for k in keys], axis=0)
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)
    return {"t": up("template_v", "template_i"),
            "ot": up("online_template_v", "online_template_i"),
            "s": up("search_v", "search_i"), "gt_xywh": up("gt_xywh")}


def make_train_step(model: nn.Module, optimizer, device="cuda", iou_weight: float = 2.0,
                    l1_weight: float = 5.0):
    """step(batch, ce_keep_rate=None) -> metrics {"Loss/total", "Loss/ciou",
    "Loss/l1", "IoU", "grad_norm"} (0-d device tensors). `batch` is a host
    batch of `batch_to_model_inputs` or the output of `model_inputs`.
    Runs on the GPU unless device="cpu"; raises without a GPU. The model
    computes in its compute dtype (`models.layers.compute_dtype`: float32 or
    bf16) on float32 parameters; a model whose parameters were cast to bf16
    raises."""
    dev = resolve_device(device)
    require_float32_params(model, "make_train_step")
    set_precision(compute_dtype(model))

    def step(batch, ce_keep_rate: Optional[float] = None) -> Dict[str, torch.Tensor]:
        x = batch if "s" in batch else model_inputs(batch, dev)
        model.train()
        out = model(x["t"], x["ot"], x["s"], ce_keep_rate)
        loss, metrics = box_losses(out["pred_boxes"], x["gt_xywh"], iou_weight, l1_weight)
        optimizer.zero_grad()
        loss.backward()
        grad_norm = optimizer.update()
        return dict({k: v.detach() for k, v in metrics.items()}, grad_norm=grad_norm)

    return step


def make_eval_step(model: nn.Module, iou_weight: float = 2.0, l1_weight: float = 5.0,
                   device="cuda"):
    """eval_step(batch) -> the metrics of `box_losses` ("Loss/total",
    "Loss/ciou", "Loss/l1", "IoU"; 0-d device tensors) of the model in eval
    mode, without gradients and with ce_keep_rate None. Runs on the GPU
    unless device="cpu"; raises without a GPU. The model's compute dtype
    and float32 parameters, as for training."""
    dev = resolve_device(device)
    require_float32_params(model, "make_eval_step")
    set_precision(compute_dtype(model))

    @torch.no_grad()
    def eval_step(batch) -> Dict[str, torch.Tensor]:
        x = batch if "s" in batch else model_inputs(batch, dev)
        model.eval()
        out = model(x["t"], x["ot"], x["s"], None)
        _, metrics = box_losses(out["pred_boxes"], x["gt_xywh"], iou_weight, l1_weight)
        return metrics

    return eval_step
