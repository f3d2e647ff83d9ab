"""One training step and one val step of the port's models (the RGB-T
ones on stacked bimodal inputs, the unimodal ones on one modality), and
the CE keep-rate schedule.

Stage 2 (TRAIN_SCORE, the online scripts' recipes): the step trains the
SPM score branch. Its forward runs the whole net in eval mode under
autograd, as the JAX step does (train/train_step.py:88-120): no drop path
or dropout, BatchNorm on its running statistics, which stay as they are;
the score branch pools the ground-truth box (`gt_xyxy`) and the loss is
`score_loss` against the batch's `labels`. The gradients of the frozen
parameters are taken all the same (K2 and K4 run), because the JAX chain
clips by the global norm of every gradient before it zeroes the frozen
groups' updates, so the backbone's and the fusion's gradients set the clip
scale of the score branch's update.

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

The training step is the port's counterpart of the JAX package's
`_jitted(ce_keep_rate)` (train/train_step.py:125-147: one jitted program
per CE keep bucket, the state donated). It reads and writes only static
tensors: its inputs (copied into static buffers of their shapes), the
parameters, BN buffers, gradients and optimizer state, the optimizer's
learning-rate and count tensors, and a static vector of its metrics, which
each call clones out. On CUDA with graphs=True (the default) it runs as
CUDA graphs (tracking/graphs.py `StepGraphs.run`), one per key: the keep
rate, the compute dtype, the micro-batch's role under ACCUM_ITER
("accumulate", or "update": clip and AdamW) and the input shapes, which the
host's counters pick as `lax.cond` and the jit cache do on the JAX side.
The first step of a key runs eager and is captured after it; later ones
are replays. The recipe's keep schedule gives at most 8 keys in a run (keep
1.0 and the buckets of 240 to 320 of 324 search tokens). graphs=False, and
any CPU step, runs the same static-buffer step eager.

Data parallel (`dp`, parallel/mesh.py DataParallel; the JAX package's
`make_train_step(mesh=...)`): each rank runs the step on its local batch;
between the backward and the optimizer the replicated gradients are
averaged over the ranks (one collective over the optimizer's flat
gradient buffer; FSDP2 has reduce-scattered the sharded ones in the
backward), and so are the loss metrics, so the clip and AdamW run on the
same gradients on every rank and `grad_norm` is the norm of the global
gradient (of every micro-batch under ACCUM_ITER). BatchNorm syncs its
statistics over the group (models/layers.py). With NCCL the collectives
are captured in the step's graphs; gloo's cannot be, and a CUDA step over
gloo with graphs=True raises, as does FSDP (sharded parameters) with
graphs=True: FSDP2 gathers and frees parameters from the host.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from multi_modal_tracking_torch.models.layers import _RandomMask, compute_dtype
from multi_modal_tracking_torch.tracking.graphs import StaticInputs, StepGraphs
from multi_modal_tracking_torch.train.losses import box_losses, score_loss
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


#: each model input and the host batch fields it concatenates, RGB first;
#: gt_xyxy and labels (stage 2) only where the batch has them
MODEL_INPUTS = {"t": ("template_v", "template_i"),
                "ot": ("online_template_v", "online_template_i"),
                "s": ("search_v", "search_i"), "gt_xywh": ("gt_xywh",),
                "gt_xyxy": ("gt_xyxy",), "labels": ("labels",)}
#: the images of a unimodal batch (`batch_to_model_inputs(rgbt=False)`)
UNIMODAL_INPUTS = {"t": ("template",), "ot": ("online_template",), "s": ("search",)}
#: the inputs of the box step, then those stage 2 adds
BOX_INPUTS = ("t", "ot", "s", "gt_xywh")
SCORE_INPUTS = BOX_INPUTS + ("gt_xyxy", "labels")


def _fields(batch) -> Dict[str, tuple]:
    table = MODEL_INPUTS if "template_v" in batch else dict(MODEL_INPUTS, **UNIMODAL_INPUTS)
    return {k: f for k, f in table.items() if f[0] in batch}


def input_buffers(batch: Dict[str, np.ndarray], pin: bool = False) -> Dict[str, torch.Tensor]:
    """Empty float32 host tensors for `model_inputs(batch, ..., out=)`,
    page-locked if `pin` (so that their copies to the GPU need not block)."""
    return {k: torch.empty((sum(batch[f].shape[0] for f in fields),) + batch[fields[0]].shape[1:],
                           dtype=torch.float32, pin_memory=pin)
            for k, fields in _fields(batch).items()}


def model_inputs(batch: Dict[str, np.ndarray], device,
                 out: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """Host batch (`batch_to_model_inputs`) -> the model's inputs on
    `device`: t/ot/s, the stacked bimodal (2B, H, W, 3) images ([:B] RGB,
    [B:] TIR) or a unimodal batch's (B, H, W, 3) ones, and gt_xywh (B, 4);
    with a stage-2 batch also gt_xyxy (B, 4) and labels (B,). With `out`
    (`input_buffers`), the host arrays are
    concatenated into those buffers and copied from them with
    non_blocking=True on the current stream: the caller keeps a buffer
    untouched until that copy has completed. On the CPU the buffers are
    what it returns."""
    if out is None:
        def up(*keys):
            x = np.concatenate([batch[k] for k in keys], axis=0)
            return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)
        return {k: up(*fields) for k, fields in _fields(batch).items()}
    fields = _fields(batch)
    for k, fs in fields.items():
        np.concatenate([batch[f] for f in fs], axis=0, out=out[k].numpy())
    return {k: out[k].to(device, non_blocking=True) for k in fields}


#: the training step's metrics, in the order of its static output vector
METRICS = ("Loss/total", "Loss/ciou", "Loss/l1", "IoU", "grad_norm")
#: and those of the stage-2 step
SCORE_METRICS = ("Loss/total", "Loss/scores", "grad_norm")


class TrainStep:
    """The training step of `make_train_step` (module docstring): call it
    with (batch, ce_keep_rate). `graphs` is its StepGraphs on CUDA with
    graphs=True, else None."""

    def __init__(self, model: nn.Module, optimizer, device: torch.device, iou_weight: float,
                 l1_weight: float, graphs: bool, train_score: bool = False,
                 score_weight: float = 1.0, dp=None):
        self.model, self.optimizer, self.device, self.dp = model, optimizer, device, dp
        self.iou_weight, self.l1_weight = iou_weight, l1_weight
        self.train_score, self.score_weight = train_score, score_weight
        self.metrics = SCORE_METRICS if train_score else METRICS
        self.input_keys = SCORE_INPUTS if train_score else BOX_INPUTS
        self.dtype = compute_dtype(model)
        self.graphs = StepGraphs(device, "training step") \
            if graphs and device.type == "cuda" else None
        self._inputs: Dict[tuple, StaticInputs] = {}
        self._out = torch.zeros(len(self.metrics), device=device)

    def _generators(self):
        gens = {id(m.generator): m.generator for m in self.model.modules()
                if isinstance(m, _RandomMask) and m.generator is not None}
        return list(gens.values())

    def _device_step(self, inputs, ce_keep_rate: Optional[float], role: str) -> None:
        """Forward, loss, backward and the optimizer's part of `role`, from
        and into static tensors (`inputs` in `input_keys`' order); reads no
        value on the host."""
        x = dict(zip(self.input_keys, inputs))
        self.optimizer.zero_grad()
        if self.train_score:
            self.model.eval()
            out = self.model(x["t"], x["ot"], x["s"], ce_keep_rate, run_score_head=True,
                             gt_bboxes=x["gt_xyxy"])
            loss, metrics = score_loss(out["pred_scores"], x["labels"], self.score_weight)
        else:
            self.model.train()
            out = self.model(x["t"], x["ot"], x["s"], ce_keep_rate)
            loss, metrics = box_losses(out["pred_boxes"], x["gt_xywh"], self.iou_weight,
                                       self.l1_weight)
        loss.backward()
        values = torch.stack([metrics[k].detach().float() for k in self.metrics[:-1]])
        if self.dp is not None:
            self.dp.reduce_grads_(self.optimizer)
            self.dp.all_reduce_mean_(values)
        norm = self.optimizer.apply(role)
        self._out.copy_(torch.cat([values, norm[None]]))

    def __call__(self, batch, ce_keep_rate: Optional[float] = None) -> Dict[str, torch.Tensor]:
        x = batch if "s" in batch else model_inputs(batch, self.device)
        src = [x[k] for k in self.input_keys]
        shapes = tuple((tuple(t.shape), t.dtype) for t in src)
        inputs = self._inputs.get(shapes)
        if inputs is None:
            inputs = self._inputs[shapes] = StaticInputs(*zip(*shapes), device=self.device)
        inputs.load_device(src)
        self.optimizer.bind_grads()
        role = self.optimizer.prepare()
        step = lambda: self._device_step(inputs.tensors, ce_keep_rate, role)   # noqa: E731
        if self.graphs is None:
            step()
        else:
            self.graphs.run((ce_keep_rate, self.dtype, role, inputs.key), step,
                            self._generators)
        self.optimizer.finish(role)
        out = self._out.clone()
        return {k: out[i] for i, k in enumerate(self.metrics)}


def make_train_step(model: nn.Module, optimizer, device="cuda", iou_weight: float = 2.0,
                    l1_weight: float = 5.0, graphs: bool = True, train_score: bool = False,
                    score_weight: float = 1.0, dp=None) -> TrainStep:
    """step(batch, ce_keep_rate=None) -> metrics {"Loss/total", "Loss/ciou",
    "Loss/l1", "IoU", "grad_norm"} (0-d device tensors, copies that later
    steps leave alone); with train_score the stage-2 step of the score
    branch (module docstring), metrics {"Loss/total", "Loss/scores",
    "grad_norm"}, on batches with gt_xyxy and labels. `batch` is a host batch of `batch_to_model_inputs`
    or the output of `model_inputs`. Runs on the GPU unless device="cpu";
    raises without a GPU. On the GPU each step is a CUDA graph replay
    unless graphs=False (module docstring); a capture that fails raises.
    The model computes in its compute dtype (`models.layers.compute_dtype`:
    float32 or bf16) on float32 parameters; a model whose parameters were
    cast to bf16 raises. `dp`: the data-parallel group (module docstring);
    a graphed CUDA step over gloo, or over FSDP-sharded parameters, raises
    ValueError."""
    dev = resolve_device(device)
    require_float32_params(model, "make_train_step")
    set_precision(compute_dtype(model))
    if graphs and dev.type == "cuda":
        if dp is not None and not dp.capturable:
            raise ValueError(f"make_train_step: a CUDA graph cannot capture {dp.backend}'s "
                             f"collectives (host calls); pass graphs=False, or use NCCL")
        if any(getattr(optimizer, "sharded", ())):
            raise ValueError("make_train_step: FSDP gathers and frees the parameters from the "
                             "host at every step, which a CUDA graph replay would skip; pass "
                             "graphs=False")
    return TrainStep(model, optimizer, dev, iou_weight, l1_weight, graphs, train_score,
                     score_weight, dp)


def make_eval_step(model: nn.Module, iou_weight: float = 2.0, l1_weight: float = 5.0,
                   device="cuda", dp=None):
    """eval_step(batch) -> the metrics of `box_losses` ("Loss/total",
    "Loss/ciou", "Loss/l1", "IoU"; 0-d device tensors) of the model in eval
    mode, without gradients and with ce_keep_rate None, averaged over the
    ranks of `dp` if given. Runs on the GPU unless device="cpu"; raises
    without a GPU. The model's compute dtype and float32 parameters, as for
    training."""
    dev = resolve_device(device)
    require_float32_params(model, "make_eval_step")
    set_precision(compute_dtype(model))

    @torch.no_grad()
    def eval_step(batch) -> Dict[str, torch.Tensor]:
        x = batch if "s" in batch else model_inputs(batch, dev)
        model.eval()
        out = model(x["t"], x["ot"], x["s"], None)
        _, metrics = box_losses(out["pred_boxes"], x["gt_xywh"], iou_weight, l1_weight)
        if dp is None:
            return metrics
        values = dp.all_reduce_mean_(torch.stack([v.float() for v in metrics.values()]))
        return dict(zip(metrics, values))

    return eval_step
