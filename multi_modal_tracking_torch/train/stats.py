"""Training statistics: running averages per epoch, a progress line, and
one JSON row per loader and epoch in `<log_dir>/metrics.jsonl`.

The port's own copy of the JAX package's `train/stats.py`. TensorBoard
scalars are written too where `torch.utils.tensorboard` imports.
"""
from __future__ import annotations

import json
import os
import time
from collections import OrderedDict
from typing import Dict, Optional


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val, self.avg, self.sum, self.count = 0.0, 0.0, 0.0, 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class StatsTracker:
    """Per-epoch named AverageMeters and throughput; JSONL and optional
    TensorBoard output under `log_dir`."""

    def __init__(self, log_dir: Optional[str] = None, print_interval: int = 50):
        self.meters: "OrderedDict[str, AverageMeter]" = OrderedDict()
        self.print_interval = print_interval
        self.log_dir = log_dir
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir)
            except ImportError:     # no tensorboard: JSONL only
                self._tb = None
        self.new_epoch()

    def new_epoch(self):
        self.meters.clear()
        self._t0 = time.time()
        self._frames = 0

    def update(self, metrics: Dict[str, float], batch_size: int = 1):
        for k, v in metrics.items():
            self.meters.setdefault(k, AverageMeter()).update(float(v), batch_size)
        self._frames += batch_size

    def fps(self) -> float:
        return self._frames / max(time.time() - self._t0, 1e-9)

    def line(self, loader_name: str, epoch: int, i: int, n: int) -> str:
        parts = [f"[{loader_name}: {epoch}, {i}/{n}]", f"FPS: {self.fps():.1f}"]
        parts += [f"{k}: {m.avg:.5f}" for k, m in self.meters.items()]
        return " , ".join(parts)

    def log_epoch(self, loader_name: str, epoch: int) -> dict:
        rec = {"loader": loader_name, "epoch": epoch,
               **{k: m.avg for k, m in self.meters.items()}}
        if self.log_dir:
            with open(os.path.join(self.log_dir, "metrics.jsonl"), "a") as f:
                f.write(json.dumps(rec) + "\n")
        if self._tb:
            for k, m in self.meters.items():
                self._tb.add_scalar(f"{loader_name}/{k}", m.avg, epoch)
            self._tb.flush()
        return rec
