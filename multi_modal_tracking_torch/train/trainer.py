"""Epoch-loop trainer of the RGB-T flagship on one GPU.

The port's counterpart of the JAX package's `train/trainer.py Trainer`:
the training loader (sampler + processing + threaded loader), the model
with seeded random weights, the regime AdamW, the train step, and the
epoch loop with the CE keep-rate schedule (keep 1.0 for CE_START_EPOCH
epochs, then a cosine down to CE_KEEP_RATIO[0] over CE_WARM_EPOCH epochs,
bucketised to multiples of 16 search tokens). Metrics are read back from
the device every print interval, not every step; a non-finite loss raises
FloatingPointError at that point.

Work is float32 with TF32 off. Not ported yet, and raising
NotImplementedError when configured or asked for (ROADMAP.md queue 1):
checkpoint save/resume and the fail-safe restart, the val loop,
ACCUM_ITER > 1, TRAIN_SCORE (SPM), FSDP / REMAT, AMP / bf16, and warm
starts from checkpoint files (item 10; a configured path that does not
exist raises FileNotFoundError, as in the JAX package).
"""
from __future__ import annotations

import os
import time
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from multi_modal_tracking_torch.models.build import build_model
from multi_modal_tracking_torch.models.layers import set_generator
from multi_modal_tracking_torch.train.builders import build_train_loader
from multi_modal_tracking_torch.train.data.loader import batch_to_model_inputs
from multi_modal_tracking_torch.train.optimizer import make_optimizer
from multi_modal_tracking_torch.train.train_step import (adjust_keep_rate, bucketize_keep_rate,
                                                         make_train_step, model_inputs)
from multi_modal_tracking_torch.utils.device import resolve_device

_ROADMAP = "is not ported to multi_modal_tracking_torch yet (ROADMAP.md queue 1)"


def _check_ported(cfg) -> None:
    t = cfg.TRAIN
    for key, bad in (("ACCUM_ITER", (t.get("ACCUM_ITER", 1) or 1) > 1),
                     ("TRAIN_SCORE", t.get("TRAIN_SCORE", False)),
                     ("FSDP", t.get("FSDP", False)), ("REMAT", t.get("REMAT", False)),
                     ("AMP", t.get("AMP", False))):
        if bad:
            raise NotImplementedError(f"TRAIN.{key} {_ROADMAP}")
    if cfg.DATA.get("VAL") and cfg.DATA.VAL.get("DATASETS_NAME"):
        raise NotImplementedError(f"the val loop (DATA.VAL.DATASETS_NAME) {_ROADMAP}; "
                                  f"set it to []")
    bb = cfg.MODEL.get("BACKBONE", {})
    paths = [("MODEL.BACKBONE.PRETRAINED_PATH",
              bb.get("PRETRAINED_PATH", "") if bb.get("PRETRAINED") else "")]
    paths += [(f"MODEL.{k}", cfg.MODEL.get(k, "")) for k in
              ("TRACKER_PRETRAINED_PATH", "SCORE_PRETRAINED_PATH", "RGBT_PRETRAINED_PATH")]
    for key, path in paths:
        if not path:
            continue
        if not os.path.isfile(path):
            raise FileNotFoundError(f"{key} = {path!r} not found (cwd {os.getcwd()!r}); "
                                    f"clear it to train from random weights")
        raise NotImplementedError(f"warm start from {key} = {path!r}: checkpoint loading "
                                  f"{_ROADMAP}, item 10")


class Trainer:
    """`Trainer(script, cfg, device="cuda", seed=...)`; `train(max_epochs)`
    runs the epoch loop, `cycle_dataset()` one epoch at `self.epoch`.
    `spec_overrides` replace fields of the model spec (depth, widths, drop
    rates). Runs on the GPU unless device="cpu"; raises without a GPU."""

    def __init__(self, script: str, cfg, device="cuda", seed: int = 42,
                 print_interval: Optional[int] = None,
                 spec_overrides: Optional[dict] = None):
        self.device = resolve_device(device)
        _check_ported(cfg)
        self.script, self.cfg = script, cfg
        self.epoch = 0
        self.train_loader = build_train_loader(cfg, seed=seed)
        self.steps_per_epoch = max(1, cfg.DATA.TRAIN.SAMPLE_PER_EPOCH // cfg.TRAIN.BATCH_SIZE)
        self.model = build_model(script, cfg, device=self.device, seed=seed,
                                 spec_overrides=spec_overrides).train()
        # the masks of drop path and dropout come from this generator
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        set_generator(self.model, self.generator)
        self.optimizer = make_optimizer(cfg, self.model, self.steps_per_epoch)
        self._step = make_train_step(self.model, self.optimizer, device=self.device,
                                     iou_weight=cfg.TRAIN.IOU_WEIGHT,
                                     l1_weight=cfg.TRAIN.L1_WEIGHT)
        self.print_interval = print_interval or cfg.TRAIN.PRINT_INTERVAL
        #: per-step metrics (floats) of the last cycle_dataset, in order
        self.history: List[Dict[str, float]] = []

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
    def cycle_dataset(self) -> Dict[str, float]:
        """One training epoch at `self.epoch`; returns the epoch's mean
        metrics and keeps the per-step ones in `self.history`."""
        keep_rate = self._keep_rate(self.epoch)
        n = len(self.train_loader)
        self.history = []
        pending = []
        t0 = time.perf_counter()

        def drain(i):
            for metrics in pending:
                m = {k: float(v) for k, v in metrics.items()}
                if not np.isfinite(m["Loss/total"]):
                    raise FloatingPointError(f"non-finite loss at epoch {self.epoch} "
                                             f"it {len(self.history) + 1}")
                self.history.append(m)
            pending.clear()
            means = self._means()
            fps = i * self.train_loader.batch_size / max(time.perf_counter() - t0, 1e-9)
            print(f"[train: {self.epoch}, {i}/{n}] FPS: {fps:.1f} , "
                  + " , ".join(f"{k}: {v:.5f}" for k, v in means.items()), flush=True)

        i = 0
        for batch in self.train_loader:
            i += 1
            inputs = model_inputs(batch_to_model_inputs(batch, rgbt=True), self.device)
            pending.append(self._step(inputs, ce_keep_rate=keep_rate))
            if i % self.print_interval == 0 or i == n:
                drain(i)
        if pending:
            drain(i)
        return self._means()

    def _means(self) -> Dict[str, float]:
        out: Dict[str, float] = OrderedDict()
        for k in (self.history[0] if self.history else {}):
            out[k] = float(np.mean([m[k] for m in self.history]))
        return out

    def train(self, max_epochs: Optional[int] = None, fail_safe: bool = False,
              load_latest: bool = False):
        """Run epochs self.epoch + 1 .. max_epochs (default TRAIN.EPOCH)."""
        if fail_safe or load_latest:
            raise NotImplementedError(f"checkpoints and the fail-safe restart {_ROADMAP}, "
                                      f"item 10")
        max_epochs = max_epochs or self.cfg.TRAIN.EPOCH
        while self.epoch < max_epochs:
            self.epoch += 1
            t0 = time.time()
            self.cycle_dataset()
            print(f"epoch {self.epoch}/{max_epochs} done in {time.time() - t0:.1f}s", flush=True)
        return self.model

    def save_checkpoint(self):
        raise NotImplementedError(f"checkpoint saving {_ROADMAP}, item 10")

    def load_checkpoint(self, path: Optional[str] = None):
        raise NotImplementedError(f"checkpoint loading {_ROADMAP}, item 10")
