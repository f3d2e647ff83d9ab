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
    have `blocks.{i}.` where flax has `blocks_{i}/`. A model may give the
    name its flax twin's path has (`regime_name`): CvT's stages are
    `backbone.stage{i}` in the port and `stage{i}` in flax, so the default
    regime puts them in `main`, at multiplier 1.0, as the JAX package does;
  * AdamW's arithmetic is optax's, in its order, each operation rounded
    once: the fused update of ops/adamw.py (kernel `csrc/adamw.cu` on the
    card, its plain version on the CPU, the same bits), with the bias
    corrections 1 - b^count computed on the host from the update count.

The whole state lives on the device, so that a CUDA graph can hold an
update (train/train_step.py): the gradients are static buffers bound as
`.grad` once (`bind_grads`) and zeroed in place, the moments and the
accumulator are allocated once and written in place, and each group's
learning rate and the two bias corrections are device tensors that
`prepare()` fills from the host's counters before each micro-batch. The
counters (`count`, `mini_step`) stay on the host, where they pick the
schedule and the micro-batch's role: "accumulate" or, on the
ACCUM_ITER-th, "update" (clip and AdamW). The same code runs on the CPU.

Data parallel (parallel/mesh.py). The gradients of the parameters that
are not sharded are views of one flat buffer (`flat_grads`), which the
training step averages over the ranks in one collective before `apply`.
Under FSDP a sharded parameter is a DTensor: its gradient buffer is a
DTensor that FSDP2 reduce-scatters into, and its moments and accumulator
are this rank's shard only; the clip's squared norm of the shards is
summed over the ranks (`dp`) before the replicated gradients' is added,
and the fused AdamW runs on each rank's shards.

Tensor parallel (`tp`, parallel/mesh.py `TensorParallel`; the JAX
package's `state_shardings` over a data x model mesh). A parameter cut
over the model group (parallel/tensor.py, `tp_dim`) is a plain tensor of
this rank's shard: its gradient is a view of the flat buffer like any
other, its moments are shards, and the fused AdamW updates the local flat
buffer. The clip's squared norm sums the sharded gradients' over the
model group and counts the replicated ones once (they are equal on the
ranks of a model group); in stage 2 (TRAIN_SCORE) that covers the frozen
parameters' gradients too, sharded or not, each square counted once.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from multi_modal_tracking_torch.ops.adamw import B1, B2, EPS, adamw_fused
from multi_modal_tracking_torch.parallel.mesh import is_sharded, local_tensor

#: each view of the flat gradient buffer starts on a multiple of this many
#: elements (512 bytes, the caching allocator's alignment)
_ALIGN = 128


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


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: the 2-norm of all gradients together (0-d)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Clip `grads` in place to global norm <= max_norm (optax
    clip_by_global_norm: scaled by max_norm / norm when norm >= max_norm,
    no epsilon); returns the norm before clipping, a 0-d tensor (no host
    sync). `norm`: their global norm, if the caller has it."""
    norm = global_norm(grads) if norm is None else norm
    clipped = norm >= max_norm
    one = torch.ones((), device=norm.device)
    torch._foreach_div_(grads, torch.where(clipped, norm, one))
    torch._foreach_mul_(grads, torch.where(clipped, torch.full_like(one, max_norm), one))
    return norm


class RegimeAdamW:
    """AdamW with the regime's parameter groups, the epoch schedule,
    global-norm clipping and ACCUM_ITER accumulation, its state on the
    device (module docstring). The training step calls `bind_grads()` and
    `prepare()` on the host, `zero_grad()` and `apply(role)` in the step,
    then `finish(role)`; `update()` does the last three in one call, after
    a backward that left its gradients in `.grad`."""

    def __init__(self, cfg, model: nn.Module, steps_per_epoch: int = 1, dp=None, tp=None):
        lab, mults = _regime_labeler(cfg)
        if dp is not None and tp is not None:
            raise ValueError("RegimeAdamW: pass the data-parallel group (dp) or the "
                             "tensor-parallel one (tp), whose data group it holds")
        self.dp = dp              # the data-parallel group (parallel/mesh.py) or None
        self.tp = tp              # the data x model group (parallel/mesh.py) or None
        self.accum = cfg.TRAIN.get("ACCUM_ITER", 1) or 1
        self.base_lr = cfg.TRAIN.LR
        self.max_norm = cfg.TRAIN.GRAD_CLIP_NORM
        self.weight_decay = cfg.TRAIN.WEIGHT_DECAY
        self.scale = make_epoch_schedule(cfg, max(1, steps_per_epoch // self.accum))
        self.params: List[nn.Parameter] = []
        self.groups: Dict[str, List[nn.Parameter]] = {}
        index = {}
        # the name the JAX package's labeller sees (MixFormerCvT.regime_name)
        label_name = getattr(model, "regime_name", lambda n: n)
        for name, p in model.named_parameters():
            index[p] = len(self.params)
            self.params.append(p)
            g = lab(label_name(name))
            if mults[g] >= 0:
                self.groups.setdefault(g, []).append(p)
        self.mults = {g: mults[g] for g in self.groups}
        self._index = {g: [index[p] for p in ps] for g, ps in self.groups.items()}
        #: whether each parameter is FSDP-sharded (a DTensor)
        self.sharded = [is_sharded(p) for p in self.params]
        #: whether each parameter is cut over the model group (tensor parallel)
        self.tp_sharded = [getattr(p, "tp_dim", None) is not None for p in self.params]
        if any(self.tp_sharded) and tp is None:
            raise ValueError("RegimeAdamW: tensor-parallel parameters need the "
                             "tensor-parallel group (tp)")
        if any(self.sharded) and dp is None:
            raise ValueError("RegimeAdamW: sharded parameters need the data-parallel group (dp)")
        dev = local_tensor(self.params[0]).device if self.params else torch.device("cpu")

        def zeros(ps):
            return [torch.zeros_like(local_tensor(p)) for p in ps]
        self.mu = {g: zeros(ps) for g, ps in self.groups.items()}
        self.nu = {g: zeros(ps) for g, ps in self.groups.items()}
        self._neg_lr = torch.zeros(len(self.groups), device=dev)     # each group's -lr
        self._bc = torch.ones(2, device=dev)            # 1 - b1^count, 1 - b2^count
        self._n = torch.ones((), device=dev)            # micro-batches in the group, this one too
        self._acc = zeros(self.params) if self.accum > 1 else None
        #: the static gradient buffers bound as `.grad` (`bind_grads`): views of
        #: `flat_grads`, or DTensors for the sharded parameters
        self.grads: Optional[List[torch.Tensor]] = None
        self.flat_grads: Optional[torch.Tensor] = None
        self._table = None        # the fused update's device tables (ops/adamw.py)
        self.count = 0            # updates applied so far (optax's count)
        self.mini_step = 0        # micro-batches in the open accumulation group

    # ------------------------------------------------------------- host side
    def bind_grads(self) -> None:
        """Make every parameter's `.grad` its static gradient buffer
        (allocated on the first call, zero): backward then accumulates into
        the same tensors at every step. The buffers of the parameters that
        are not sharded are views of one flat buffer, `flat_grads`, each
        starting on a 512-byte boundary."""
        if self.grads is None:
            plain = [p for p, sh in zip(self.params, self.sharded) if not sh]
            offsets, n = [], 0
            for p in plain:
                offsets.append(n)
                n += -(-p.numel() // _ALIGN) * _ALIGN
            dev = plain[0].device if plain else None
            self.flat_grads = torch.zeros(n, device=dev) if plain else None
            views = iter([self.flat_grads[o:o + p.numel()].view_as(p)
                          for o, p in zip(offsets, plain)])
            self.grads = [torch.zeros_like(p) if sh else next(views)
                          for p, sh in zip(self.params, self.sharded)]
        for p, g in zip(self.params, self.grads):
            if p.grad is not g:
                p.grad = g

    def prepare(self) -> str:
        """Fill the device scalars that the next micro-batch reads from the
        host's counters (if it updates: each group's -lr at the schedule's
        value for the updates applied so far, and the bias corrections at
        the update count after this update; under ACCUM_ITER, the
        accumulation divisor); returns its role, "update" or
        "accumulate"."""
        update = self.mini_step + 1 == self.accum
        if update:
            scale = self.scale(self.count)
            for i, g in enumerate(self.groups):
                self._neg_lr[i].fill_(-(self.base_lr * self.mults[g] * scale))
            self._bc[0].fill_(1.0 - B1 ** (self.count + 1))
            self._bc[1].fill_(1.0 - B2 ** (self.count + 1))
        if self.accum > 1:
            self._n.fill_(self.mini_step + 1)
        return "update" if update else "accumulate"

    def finish(self, role: str) -> None:
        """Advance the host's counters past a micro-batch of `role`."""
        if role == "update":
            self.count += 1
            self.mini_step = 0
        else:
            self.mini_step += 1

    # ----------------------------------------------------------- device side
    def zero_grad(self) -> None:
        """Zero the static gradient buffers in place (binding them first)."""
        self.bind_grads()
        torch._foreach_zero_([local_tensor(g) for g in self.grads])

    def _grads(self) -> List[torch.Tensor]:
        """Every parameter's gradient (this rank's shard of a sharded one);
        one that got none counts as zero."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [local_tensor(p.grad) for p in self.params]

    def _norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of `grads`; under FSDP the shards' squared norm
        is summed over the ranks first, under tensor parallelism over the
        model group (a sum over one rank is the plain norm)."""
        if self.tp is not None and self.tp.model.world > 1:
            sharded, group = self.tp_sharded, self.tp.model
        elif any(self.sharded):
            sharded, group = self.sharded, self.dp
        else:
            return global_norm(grads)
        sq = [torch.stack(torch._foreach_norm([g for g, s in zip(grads, sharded) if s]))
              .square().sum()]
        group.all_reduce_sum_(sq[0])
        rep = [g for g, s in zip(grads, sharded) if not s]
        if rep:
            sq.append(torch.stack(torch._foreach_norm(rep)).square().sum())
        return torch.stack(sq).sum().sqrt()

    def _adamw(self, grads: List[torch.Tensor]) -> None:
        if not self.groups:
            return
        groups = [([local_tensor(p) for p in ps], [grads[i] for i in self._index[g]],
                   self.mu[g], self.nu[g]) for g, ps in self.groups.items()]
        self._table = adamw_fused(groups, self._neg_lr, self._bc, self.weight_decay,
                                  self._table)

    @torch.no_grad()
    def apply(self, role: str) -> torch.Tensor:
        """The device part of a micro-batch of `role` (from `prepare`), on
        the gradients in `.grad`; returns their global norm before clipping
        (0-d tensor). Without accumulation, clip and AdamW. With ACCUM_ITER
        k, fold them into the group's running mean as MultiSteps does (acc +
        (g - acc) / n); on "update" the mean becomes the gradient, is
        clipped and applied, and the accumulator is zeroed for the next
        group. Reads no value on the host."""
        grads = self._grads()
        if self.accum == 1:
            norm = clip_by_global_norm_(grads, self.max_norm, self._norm(grads))
            self._adamw(grads)
            return norm
        norm = self._norm(grads)
        diff = torch._foreach_sub(grads, self._acc)
        torch._foreach_div_(diff, self._n)
        torch._foreach_add_(self._acc, diff)
        del diff
        if role == "update":
            torch._foreach_copy_(grads, self._acc)
            torch._foreach_zero_(self._acc)
            clip_by_global_norm_(grads, self.max_norm, self._norm(grads))
            self._adamw(grads)
        return norm

    def update(self) -> torch.Tensor:
        """Take one micro-batch's gradients (in `.grad`); returns their
        global norm before clipping (0-d tensor): `prepare`, `apply` and
        `finish` in one call."""
        role = self.prepare()
        norm = self.apply(role)
        self.finish(role)
        return norm

    # ------------------------------------------------------------ checkpoint
    def state_dict(self) -> dict:
        """AdamW's state in torch.optim.AdamW's layout (parameters numbered
        across the groups in order), the applied-update count and the open
        accumulation group's running mean (None when none is open), on the
        CPU."""
        state, groups, k = {}, [], 0
        for g, ps in self.groups.items():
            idx = list(range(k, k + len(ps)))
            k += len(ps)
            groups.append(dict(group=g, lr=self.base_lr * self.mults[g], betas=(B1, B2),
                               eps=EPS, weight_decay=self.weight_decay, params=idx))
            for i, m, v in zip(idx, self.mu[g], self.nu[g]):
                state[i] = {"step": torch.tensor(float(self.count)), "exp_avg": m.cpu(),
                            "exp_avg_sq": v.cpu()}
        return {"adamw": {"state": state, "param_groups": groups}, "count": self.count,
                "mini_step": self.mini_step,
                "acc": [a.cpu() for a in self._acc] if self.mini_step else None}

    def sharded_state_dict(self) -> Dict[str, torch.Tensor]:
        """The state for a sharded checkpoint (torch.distributed.checkpoint):
        each moment (and accumulator) by group and index, that of a sharded
        parameter as a DTensor over this rank's shard in its parameter's
        layout (no copy, so a load writes into the optimizer in place); the
        counters as 0-d tensors."""
        def wrap(t, p):
            if not is_sharded(p):
                return t
            from torch.distributed.tensor import DTensor
            return DTensor.from_local(t, p.device_mesh, p.placements, run_check=False,
                                      shape=p.shape, stride=p.stride())
        sd = {}
        for g, ps in self.groups.items():
            for k, (p, m, v) in enumerate(zip(ps, self.mu[g], self.nu[g])):
                sd[f"mu.{g}.{k}"], sd[f"nu.{g}.{k}"] = wrap(m, p), wrap(v, p)
        if self._acc is not None:
            for i, (p, a) in enumerate(zip(self.params, self._acc)):
                sd[f"acc.{i}"] = wrap(a, p)
        sd["count"] = torch.tensor(self.count)
        sd["mini_step"] = torch.tensor(self.mini_step)
        return sd

    def load_sharded_counters(self, sd: Dict[str, torch.Tensor]) -> None:
        """Take the counters of a `sharded_state_dict` that a checkpoint
        load has filled (the moments were filled in place)."""
        self.count, self.mini_step = int(sd["count"]), int(sd["mini_step"])
        if self._acc is not None and not self.mini_step:
            torch._foreach_zero_(self._acc)

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Load `state_dict()`'s output (or torch.optim.AdamW's of earlier
        checkpoints, whose state lacks the parameters that never stepped)
        into the existing tensors, in place: a CUDA graph that holds them
        stays valid."""
        adamw = state["adamw"]
        sizes = [len(g["params"]) for g in adamw["param_groups"]]
        if sizes != [len(ps) for ps in self.groups.values()]:
            raise ValueError(f"optimizer state has groups of {sizes} parameters, this "
                             f"optimizer {[len(ps) for ps in self.groups.values()]}")
        for saved, (g, ps) in zip(adamw["param_groups"], self.groups.items()):
            for i, m, v in zip(saved["params"], self.mu[g], self.nu[g]):
                st = adamw["state"].get(i)
                if st is None:
                    m.zero_()
                    v.zero_()
                else:
                    m.copy_(st["exp_avg"])
                    v.copy_(st["exp_avg_sq"])
        self.count, self.mini_step = state["count"], state["mini_step"]
        if state["acc"] is not None and self._acc is None:
            raise ValueError("optimizer state has an open accumulation group; ACCUM_ITER is 1")
        if self._acc is not None:
            if state["acc"] is None:
                torch._foreach_zero_(self._acc)
            else:
                for a, s in zip(self._acc, state["acc"], strict=True):
                    a.copy_(s)


def make_optimizer(cfg, model: nn.Module, steps_per_epoch: int = 1, dp=None,
                   tp=None) -> RegimeAdamW:
    return RegimeAdamW(cfg, model, steps_per_epoch, dp, tp)
