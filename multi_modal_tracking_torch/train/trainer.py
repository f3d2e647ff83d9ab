"""Epoch-loop trainer of the RGB-T flagship on one GPU, with checkpoints,
resume, the fail-safe restart, warm starts and the val loop.

The port's counterpart of the JAX package's `train/trainer.py Trainer`:
the train and val loaders (sampler + processing + threaded loader), the
model with seeded random weights, then the warm starts (the MAE backbone
file first, then TRACKER_ / SCORE_ / RGBT_PRETRAINED_PATH, each loaded
non-strictly; a configured path that does not exist raises
FileNotFoundError), the regime AdamW (ACCUM_ITER micro-batches per update),
the train and val steps, and the epoch loop with the CE keep-rate schedule
(keep 1.0 for CE_START_EPOCH epochs, then a cosine down to CE_KEEP_RATIO[0]
over CE_WARM_EPOCH epochs, bucketised to multiples of 16 search tokens).
Every VAL_EPOCH_INTERVAL epochs the val split runs after the train split.
After each epoch `<save_dir>/checkpoints/<script>/<Net>_ep%04d.pth.tar`
holds the network, the optimizer (AdamW moments, applied-update count, open
accumulation group) and the dropout / drop-path generator, so a resume is
exact. `train()` restarts from the latest checkpoint after a failure (at
most `max_failures` tries). Per-epoch means go to
`<save_dir>/logs/<script>/metrics.jsonl`. Metrics are read back from the
device every print interval, not every step; a non-finite loss raises
FloatingPointError at that point.

The model computes in `dtype`, bf16 by default, the JAX Trainer's only
mode (train/trainer.py:70), on float32 parameters: the master weights, the
AdamW moments, the clip and the update stay float32 (flax dtype=bf16,
param_dtype=float32); `dtype=torch.float32` is the parity path. TF32 is
off either way. TRAIN.AMP is accepted and changes nothing, as in the JAX
package, where AMP is the bf16 compute policy with no loss scaler. Not
ported yet, and raising NotImplementedError when configured (ROADMAP.md
queue 1): TRAIN_SCORE (SPM), FSDP / REMAT.
"""
from __future__ import annotations

import os
import time
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

from multi_modal_tracking_torch.models.build import build_model
from multi_modal_tracking_torch.models.layers import set_generator
from multi_modal_tracking_torch.train.builders import build_dataloaders
from multi_modal_tracking_torch.train.data.loader import batch_to_model_inputs
from multi_modal_tracking_torch.train.optimizer import make_optimizer
from multi_modal_tracking_torch.train.stats import StatsTracker
from multi_modal_tracking_torch.train.train_step import (adjust_keep_rate, bucketize_keep_rate,
                                                         make_eval_step, make_train_step,
                                                         model_inputs)
from multi_modal_tracking_torch.utils import checkpoint as ckpt
from multi_modal_tracking_torch.utils.device import resolve_device

_ROADMAP = "is not ported to multi_modal_tracking_torch yet (ROADMAP.md queue 1)"


def _check_ported(cfg) -> None:
    t = cfg.TRAIN
    for key in ("TRAIN_SCORE", "FSDP", "REMAT"):
        if t.get(key, False):
            raise NotImplementedError(f"TRAIN.{key} {_ROADMAP}")


def _warm_start_paths(cfg) -> List[tuple]:
    """(config key, path) of each configured warm start, in load order."""
    bb = cfg.MODEL.get("BACKBONE", {})
    paths = [("MODEL.BACKBONE.PRETRAINED_PATH",
              bb.get("PRETRAINED_PATH", "") if bb.get("PRETRAINED") else "")]
    paths += [(f"MODEL.{k}", cfg.MODEL.get(k, "")) for k in
              ("TRACKER_PRETRAINED_PATH", "SCORE_PRETRAINED_PATH", "RGBT_PRETRAINED_PATH")]
    return [(k, p) for k, p in paths if p]


class Trainer:
    """`Trainer(script, cfg, save_dir="output", device="cuda", seed=...)`;
    `train(max_epochs)` runs the epoch loop, `cycle_dataset(loader, train)`
    one pass over a loader at `self.epoch`. `spec_overrides` replace fields
    of the model spec (depth, widths, drop rates). `dtype` is the compute
    dtype (bf16 by default, as in the JAX package, or float32); the
    parameters are float32 either way. Runs on the GPU unless
    device="cpu"; raises without a GPU."""

    def __init__(self, script: str, cfg, save_dir: str = "output", device="cuda",
                 seed: int = 42, log_dir: Optional[str] = None,
                 print_interval: Optional[int] = None,
                 spec_overrides: Optional[dict] = None, dtype: torch.dtype = torch.bfloat16):
        self.device = resolve_device(device)
        _check_ported(cfg)
        warm_starts = _warm_start_paths(cfg)
        for key, path in warm_starts:
            if not os.path.isfile(path):
                raise FileNotFoundError(f"{key} = {path!r} not found (cwd {os.getcwd()!r}); "
                                        f"clear it to train from random weights")
        self.script, self.cfg = script, cfg
        self.ckpt_dir = os.path.join(save_dir, "checkpoints", script)
        self.epoch = 0
        self.train_loader, self.val_loader = build_dataloaders(cfg, seed=seed)
        self.steps_per_epoch = max(1, cfg.DATA.TRAIN.SAMPLE_PER_EPOCH // cfg.TRAIN.BATCH_SIZE)
        self.dtype = dtype
        self.model = build_model(script, cfg, device=self.device, dtype=dtype, seed=seed,
                                 spec_overrides=spec_overrides).train()
        self.net_name = type(self.model).__name__
        for key, path in warm_starts:
            ckpt.load_variables(path, self.model, strict=False)
            print(f"warm start from {key} = {path}", flush=True)
        # the masks of drop path and dropout come from this generator
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        set_generator(self.model, self.generator)
        self.optimizer = make_optimizer(cfg, self.model, self.steps_per_epoch)
        self._step = make_train_step(self.model, self.optimizer, device=self.device,
                                     iou_weight=cfg.TRAIN.IOU_WEIGHT,
                                     l1_weight=cfg.TRAIN.L1_WEIGHT)
        self._eval_step = make_eval_step(self.model, iou_weight=cfg.TRAIN.IOU_WEIGHT,
                                         l1_weight=cfg.TRAIN.L1_WEIGHT, device=self.device)
        self.stats = StatsTracker(log_dir or os.path.join(save_dir, "logs", script),
                                  print_interval or cfg.TRAIN.PRINT_INTERVAL)
        #: per-step metrics (floats) of the last cycle_dataset, in order
        self.history: List[Dict[str, float]] = []

    # ------------------------------------------------------------ ckpt/resume
    def save_checkpoint(self) -> Optional[str]:
        """Write this epoch's checkpoint (rank 0 only); returns its path."""
        if torch.distributed.is_initialized() and torch.distributed.get_rank() != 0:
            return None
        state = {"epoch": self.epoch, "net_type": self.net_name,
                 "net": {k: v.detach().cpu() for k, v in self.model.state_dict().items()},
                 "optimizer": self.optimizer.state_dict(),
                 "generator": self.generator.get_state()}
        return ckpt.save_checkpoint(self.ckpt_dir, self.net_name, self.epoch, state)

    def load_checkpoint(self, path: Optional[str] = None) -> bool:
        """Resume from `path` (default: the latest epoch in ckpt_dir);
        False if there is none."""
        path = path or ckpt.latest_checkpoint(self.ckpt_dir, self.net_name)
        if not path or not os.path.isfile(path):
            return False
        state = ckpt.load_checkpoint(path)
        self.model.load_state_dict(state["net"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.generator.set_state(state["generator"])
        self.epoch = int(state["epoch"])
        print(f"resumed from {path} (epoch {self.epoch})", flush=True)
        return True

    # ------------------------------------------------------------- keep rate
    def _keep_rate(self, epoch: int) -> Optional[float]:
        """keep 1.0 for the first CE_START_EPOCH epochs, then a cosine
        anneal to CE_KEEP_RATIO[0] over the next CE_WARM_EPOCH epochs,
        bucketised; None without CE."""
        cfg = self.cfg
        bb = cfg.MODEL.BACKBONE
        if not bb.get("CE_LOC", None):
            return None
        base = bb.CE_KEEP_RATIO[0] if bb.get("CE_KEEP_RATIO", None) else 1.0
        start = cfg.TRAIN.get("CE_START_EPOCH", 20)
        warm = cfg.TRAIN.get("CE_WARM_EPOCH", 80)
        rate = adjust_keep_rate(epoch, start, start + warm, self.steps_per_epoch,
                                base_keep_rate=base)
        return bucketize_keep_rate(rate, (cfg.DATA.SEARCH.SIZE // 16) ** 2)

    # ------------------------------------------------------------- epoch loop
    def cycle_dataset(self, loader=None, train: bool = True) -> dict:
        """One pass over `loader` (default: the train loader) at
        `self.epoch`: train steps, or val steps with train=False. Returns
        the epoch's record (loader, epoch, mean metrics), also appended to
        metrics.jsonl; keeps the per-step metrics in `self.history`."""
        loader = self.train_loader if loader is None else loader
        self.stats.new_epoch()
        keep_rate = self._keep_rate(self.epoch) if train else None
        n = len(loader)
        self.history = []
        pending = []

        def drain():
            for metrics, bsz in pending:
                m = {k: float(v) for k, v in metrics.items()}
                if not np.isfinite(m["Loss/total"]):
                    raise FloatingPointError(f"non-finite loss at epoch {self.epoch} "
                                             f"it {len(self.history) + 1}")
                self.stats.update(m, bsz)
                self.history.append(m)
            pending.clear()

        i = 0
        for batch in loader:
            i += 1
            inputs = model_inputs(batch_to_model_inputs(batch, rgbt=True), self.device)
            bsz = inputs["gt_xywh"].shape[0]
            if train:
                pending.append((self._step(inputs, ce_keep_rate=keep_rate), bsz))
            else:
                pending.append((self._eval_step(inputs), bsz))
            if i % self.stats.print_interval == 0 or i == n:
                drain()
                print(self.stats.line(loader.name, self.epoch, i, n), flush=True)
        drain()
        return self.stats.log_epoch(loader.name, self.epoch)

    def train_epoch(self) -> dict:
        rec = self.cycle_dataset(self.train_loader, train=True)
        if self.val_loader is not None and self.epoch % self.cfg.TRAIN.VAL_EPOCH_INTERVAL == 0:
            self.cycle_dataset(self.val_loader, train=False)
        return rec

    def train(self, max_epochs: Optional[int] = None, fail_safe: bool = True,
              load_latest: bool = False, max_failures: int = 5):
        """Run epochs self.epoch + 1 .. max_epochs (default TRAIN.EPOCH),
        saving a checkpoint after each. load_latest resumes first. With
        fail_safe, an exception in an epoch reloads the latest checkpoint
        (if there is none yet, training goes on from the current weights)
        and retries, up to max_failures tries in all."""
        max_epochs = max_epochs or self.cfg.TRAIN.EPOCH
        if load_latest:
            self.load_checkpoint()
        num_tries = max_failures if fail_safe else 1
        for attempt in range(num_tries):
            try:
                while self.epoch < max_epochs:
                    self.epoch += 1
                    t0 = time.time()
                    self.train_epoch()
                    self.save_checkpoint()
                    print(f"epoch {self.epoch}/{max_epochs} done in {time.time() - t0:.1f}s",
                          flush=True)
                return self.model
            except Exception:
                self.epoch -= 1
                if not fail_safe or attempt == num_tries - 1:
                    raise
                print("Training crashed at epoch", self.epoch + 1)
                traceback.print_exc()
                print("Restarting from last checkpoint ...", flush=True)
                if not self.load_checkpoint():
                    print("no checkpoint yet: going on from the current weights", flush=True)
        return self.model
