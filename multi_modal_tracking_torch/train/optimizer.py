"""Optimizer: AdamW over parameter groups by training regime, each group's
learning-rate multiplier times an epoch schedule, global-norm gradient
clipping, and gradient accumulation. The port's counterpart of the JAX
package's `train/optimizer.py` (optax `multi_transform` over AdamW,
`clip_by_global_norm` first, `MultiSteps` around both for ACCUM_ITER > 1).

Matching optax, on purpose:
  * the schedule is called with the number of updates already applied
    (0 for the first step), and an epoch is steps_per_epoch // ACCUM_ITER
    applied updates;
  * clipping scales the gradients by max_norm / norm when norm >= max_norm,
    with no epsilon (`torch.nn.utils.clip_grad_norm_` adds 1e-6), over every
    gradient of the model, frozen groups included;
  * AdamW (b1 0.9, b2 0.999, eps 1e-8) decays every parameter of a
    trainable group; a frozen group (multiplier < 0, optax `set_to_zero`)
    takes no step at all;
  * ACCUM_ITER k: the k micro-batch gradients are averaged as MultiSteps
    does (acc + (g - acc) / (n + 1)); the mean is clipped and one AdamW
    update applied per k micro-batches;
  * regimes match parameter names by substring; the port's dotted names
    have `blocks.{i}.` where flax has `blocks_{i}/`.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
from torch import nn


def _regime_labeler(cfg) -> Tuple[Callable[[str], str], Dict[str, float]]:
    """(parameter name -> group, group -> lr multiplier; < 0 = frozen)."""
    t = cfg.TRAIN
    bmult = t.BACKBONE_MULTIPLIER
    offsets = ("reference_points", "sampling_offsets")

    def fusion_or(p, other):
        if "fusion_vi" in p:
            return "fusion_off" if any(k in p for k in offsets) else "fusion"
        return other

    if t.get("TRAIN_SCORE", False):
        return (lambda p: "main" if "score" in p else "frozen"), {"main": 1.0, "frozen": -1.0}
    if t.get("FREEZE_STAGE0", False):
        def lab(p):
            if "stage1" in p or "stage2" in p:
                return "backbone"
            return "main" if "box_head" in p else "frozen"
        return lab, {"main": 1.0, "backbone": bmult, "frozen": -1.0}
    if t.get("FREEZE_FIRST_6LAYERS", False):
        frozen_blocks = tuple(f"blocks.{i}." for i in range(6))

        def lab(p):
            if any(b in p for b in frozen_blocks) or "patch_embed" in p:
                return "frozen"
            return "backbone" if "backbone" in p else "main"
        return lab, {"main": 1.0, "backbone": bmult, "frozen": -1.0}
    if t.get("RGBT_TRACK", False):                      # two-stream
        def lab(p):
            for k in ("backbone_i", "backbone_v"):
                if k in p:
                    return k
            return "head" if "box_head" in p else fusion_or(p, "main")
        return lab, {"backbone_i": 0.1, "backbone_v": 0.02, "head": 0.02,
                     "fusion": 1.0, "fusion_off": 0.1, "main": 1.0}
    for flag, bb in (("RGBT_TRACK_SHARED", 0.02), ("RGBT_TRACK_UNIBACKBONE", 0.1)):
        if t.get(flag, False):
            def lab(p):
                if "backbone" in p:
                    return "backbone"
                return "head" if "box_head" in p else fusion_or(p, "main")
            return lab, {"backbone": bb, "head": 0.02, "fusion": 1.0, "fusion_off": 0.1,
                         "main": 1.0}

    def lab(p):
        if "score" in p:
            return "frozen"
        return "backbone" if "backbone" in p else "main"
    return lab, {"main": 1.0, "backbone": bmult, "frozen": -1.0}


def make_epoch_schedule(cfg, steps_per_epoch: int) -> Callable[[int], float]:
    """Update count -> learning-rate scale (epoch-granular, like the
    reference's per-epoch schedulers)."""
    t = cfg.TRAIN
    sched_type = t.SCHEDULER.TYPE
    spe = max(steps_per_epoch, 1)
    if sched_type == "step":
        drop = t.LR_DROP_EPOCH
        return lambda step: 0.1 ** ((step // spe) // drop)
    if sched_type == "Mstep":
        milestones = sorted(t.LR_DROP_EPOCH)
        gamma = t.SCHEDULER.DECAY_RATE
        return lambda step: gamma ** sum((step // spe) >= m for m in milestones)
    if sched_type == "warmup_cosine":
        warm, total, base, mn = t.WARMUP_EPOCHS, t.EPOCH, t.LR, t.MIN_LR

        def fn(step):
            e = step / spe                  # fractional epoch, as the MAE warmup
            if e < warm:
                return e / max(warm, 1)
            cos = 0.5 * (1.0 + math.cos(math.pi * (e - warm) / max(total - warm, 1)))
            return (mn + (base - mn) * cos) / base
        return fn
    raise ValueError(f"Unsupported scheduler {sched_type}")


class RegimeAdamW:
    """AdamW with the regime's parameter groups, the epoch schedule,
    global-norm clipping and ACCUM_ITER accumulation. `update()` after each
    backward (or, without accumulation, `clip_()` then `step()`)."""

    def __init__(self, cfg, model: nn.Module, steps_per_epoch: int = 1):
        lab, mults = _regime_labeler(cfg)
        self.accum = cfg.TRAIN.get("ACCUM_ITER", 1) or 1
        self.base_lr = cfg.TRAIN.LR
        self.max_norm = cfg.TRAIN.GRAD_CLIP_NORM
        self.scale = make_epoch_schedule(cfg, max(1, steps_per_epoch // self.accum))
        self.params: List[nn.Parameter] = []
        groups: Dict[str, List[nn.Parameter]] = {}
        for name, p in model.named_parameters():
            self.params.append(p)
            g = lab(name)
            if mults[g] >= 0:
                groups.setdefault(g, []).append(p)
        self.mults = {g: mults[g] for g in groups}
        self.opt = torch.optim.AdamW(
            [dict(params=ps, group=g) for g, ps in groups.items()], lr=self.base_lr,
            betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.TRAIN.WEIGHT_DECAY)
        self.count = 0            # updates applied so far (optax's count)
        self.mini_step = 0        # micro-batches in the open accumulation group
        self._acc = None          # their gradients' running mean

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _grads(self) -> List[torch.Tensor]:
        """Every parameter's gradient; one that got none counts as zero."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    @staticmethod
    def _norm(grads: List[torch.Tensor]) -> torch.Tensor:
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))

    @torch.no_grad()
    def clip_(self) -> torch.Tensor:
        """Clip the gradients in place to global norm <= max_norm (optax
        clip_by_global_norm); returns the norm before clipping, a 0-d tensor
        (no host sync)."""
        grads = self._grads()
        norm = self._norm(grads)
        clipped = norm >= self.max_norm
        one = torch.ones((), device=norm.device)
        torch._foreach_div_(grads, torch.where(clipped, norm, one))
        torch._foreach_mul_(grads, torch.where(clipped, torch.full_like(one, self.max_norm), one))
        return norm

    def step(self) -> None:
        scale = self.scale(self.count)
        for group in self.opt.param_groups:
            group["lr"] = self.base_lr * self.mults[group["group"]] * scale
        self.opt.step()
        self.count += 1

    @torch.no_grad()
    def update(self) -> torch.Tensor:
        """Take one micro-batch's gradients (in `.grad`); returns their
        global norm before clipping (0-d tensor). Without accumulation, clip
        and step. With ACCUM_ITER k, fold them into the group's running
        mean; the k-th clips the mean and applies one AdamW update."""
        if self.accum == 1:
            norm = self.clip_()
            self.step()
            return norm
        grads = self._grads()
        norm = self._norm(grads)
        if self.mini_step == 0:
            self._acc = [g.clone() for g in grads]
        else:
            diff = torch._foreach_sub(grads, self._acc)
            torch._foreach_div_(diff, float(self.mini_step + 1))
            torch._foreach_add_(self._acc, diff)
        self.mini_step += 1
        if self.mini_step == self.accum:
            for p, a in zip(self.params, self._acc):
                p.grad = a
            self._acc, self.mini_step = None, 0
            self.clip_()
            self.step()
        return norm

    def state_dict(self) -> dict:
        """AdamW's state, the applied-update count and the open
        accumulation group, on the CPU."""
        return {"adamw": _to_cpu(self.opt.state_dict()), "count": self.count,
                "mini_step": self.mini_step,
                "acc": None if self._acc is None else [a.cpu() for a in self._acc]}

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state["adamw"])
        self.count, self.mini_step = state["count"], state["mini_step"]
        self._acc = None if state["acc"] is None else [
            a.to(p.device) for a, p in zip(state["acc"], self.params)]


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def make_optimizer(cfg, model: nn.Module, steps_per_epoch: int = 1) -> RegimeAdamW:
    return RegimeAdamW(cfg, model, steps_per_epoch)
