"""Epoch-loop trainer of the port's scripts (the RGB-T ones and
the unimodal `mixformer_vit*`, whose configs train on one modality:
`train.builders.is_rgbt_config`), with checkpoints, resume, the
fail-safe restart, warm starts and the val loop.

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
package, where AMP is the bf16 compute policy with no loss scaler.

On the GPU each training step is a CUDA graph replay (`graphs=True`, the
default; train/train_step.py), one graph per CE keep bucket and
accumulation role, all from one memory pool; `graphs=False` runs the same
static-buffer step eager, as the CPU always does. A resume or the
fail-safe restart loads the checkpoint into the step's static tensors in
place (model, optimizer, generator), so the graphs stay bound to the
state. The val step runs eager.

TRAIN_SCORE (stage 2 of the online scripts) trains the SPM score branch
alone: the regime freezes every other parameter, the training step runs
the net in eval mode with the score loss (train/train_step.py), and the
val step keeps the box losses, as the JAX package's `make_eval_step`
does. A stage-1 checkpoint without the score branch's keys warm-starts it
(the loads are non-strict); the branch starts from `init_random`; a
script without the branch raises ValueError.

Several GPUs (the JAX package's data mesh, train/trainer.py:115-186). When
a process group is formed (`parallel.distributed.initialize_distributed`;
one process per GPU), the Trainer trains data-parallel over it: each rank
loads BATCH_SIZE // world samples of the global batch from a sampler
seeded with seed + rank, rank 0's weights and BN statistics are broadcast
at the start, BatchNorm syncs its statistics over the group, the step
averages gradients and metrics over the ranks (train/train_step.py), the
val metrics are averaged too, and each rank's dropout / drop-path
generator is seeded with seed + 1 + rank. Rank 0 alone prints, writes
`metrics.jsonl` and writes the checkpoint, which carries every rank's
generator state; every rank loads it, and a resume at another world size
raises. TRAIN.FSDP (a group is required) shards the parameters and AdamW
moments over the group with FSDP2 (parallel/mesh.py fsdp_shard), runs
eager (graphs=False) and writes sharded checkpoints
(`<Net>_ep%04d.dcp/`, every rank its own shards), which also load into a
one-process Trainer (`load_checkpoint(path, reshard=True)`) and into
`utils.checkpoint.load_variables`. TRAIN.REMAT recomputes the flagship
backbone's blocks in the backward (models/asymmetric_shared.py); the other
scripts have no remat path and train as without it, as in the JAX package.
The fail-safe restart is a one-process feature: under a group of more
than one rank a failure raises at once, on the rank that failed, and the
collectives the others wait in fail when its process ends. A restart of
one rank alone would pair its collectives with the other ranks' later
steps and average gradients of different steps without an error.
"""
from __future__ import annotations

import os
import queue
import threading
import time
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

import torch.distributed as dist

from multi_modal_tracking_torch.models.asymmetric_shared import MixFormerRGBT
from multi_modal_tracking_torch.models.build import build_model
from multi_modal_tracking_torch.models.layers import set_generator, set_sync_group
from multi_modal_tracking_torch.parallel.distributed import process_seed
from multi_modal_tracking_torch.parallel.mesh import DataParallel, fsdp_shard
from multi_modal_tracking_torch.train.builders import build_dataloaders, is_rgbt_config
from multi_modal_tracking_torch.train.data.loader import batch_to_model_inputs
from multi_modal_tracking_torch.train.optimizer import make_optimizer
from multi_modal_tracking_torch.train.stats import StatsTracker
from multi_modal_tracking_torch.train.train_step import (adjust_keep_rate, bucketize_keep_rate,
                                                         input_buffers, make_eval_step,
                                                         make_train_step, model_inputs)
from multi_modal_tracking_torch.utils import checkpoint as ckpt
from multi_modal_tracking_torch.utils.device import resolve_device

#: pinned host buffers of the look-ahead: one being filled while the other's
#: copy may still run
_RING = 2


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
    device="cpu"; raises without a GPU. `graphs=False` runs the training
    step eager on the GPU too. With a process group formed it trains
    data-parallel over it (module docstring); give each process its own
    GPU as `device` (`parallel.distributed.local_device`)."""

    def __init__(self, script: str, cfg, save_dir: str = "output", device="cuda",
                 seed: int = 42, log_dir: Optional[str] = None,
                 print_interval: Optional[int] = None,
                 spec_overrides: Optional[dict] = None, dtype: torch.dtype = torch.bfloat16,
                 graphs: bool = True):
        self.device = resolve_device(device)
        self.dp = DataParallel() if dist.is_initialized() else None
        self.fsdp = bool(cfg.TRAIN.get("FSDP", False))
        if self.fsdp and self.dp is None:
            raise ValueError("TRAIN.FSDP shards over the process group: start the run under "
                             "torchrun or with --coordinator/--num_processes/--process_id "
                             "(a group of one process works)")
        self.is_main = self.dp is None or self.dp.rank == 0
        warm_starts = _warm_start_paths(cfg)
        for key, path in warm_starts:
            if not os.path.isfile(path):
                raise FileNotFoundError(f"{key} = {path!r} not found (cwd {os.getcwd()!r}); "
                                        f"clear it to train from random weights")
        self.script, self.cfg = script, cfg
        self.rgbt = is_rgbt_config(cfg)
        self.ckpt_dir = os.path.join(save_dir, "checkpoints", script)
        self.epoch = 0
        self.train_loader, self.val_loader = build_dataloaders(cfg, seed=process_seed(seed))
        self.steps_per_epoch = max(1, cfg.DATA.TRAIN.SAMPLE_PER_EPOCH // cfg.TRAIN.BATCH_SIZE)
        self.dtype = dtype
        self.model = build_model(script, cfg, device=self.device, dtype=dtype, seed=seed,
                                 spec_overrides=spec_overrides).train()
        self.net_name = type(self.model).__name__
        train_score = cfg.TRAIN.get("TRAIN_SCORE", False)
        if train_score and not self.model.with_score:
            raise ValueError(f"TRAIN.TRAIN_SCORE trains the score branch, which {script!r} "
                             f"does not build (an *_online script does)")
        if cfg.TRAIN.get("REMAT", False) and not isinstance(self.model, MixFormerRGBT):
            self._print(f"TRAIN.REMAT: {script} has no remat path (as in the JAX package); "
                        f"it trains without")
        for key, path in warm_starts:
            ckpt.load_variables(path, self.model, strict=False)
            self._print(f"warm start from {key} = {path}")
        # the masks of drop path and dropout come from this generator, one
        # stream per rank (equal ones would mask every rank's half alike)
        rank = 0 if self.dp is None else self.dp.rank
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1 + rank)
        set_generator(self.model, self.generator)
        if self.dp is not None:
            set_sync_group(self.model, self.dp.group)
            self.dp.broadcast_state(self.model)
            if self.fsdp:
                fsdp_shard(self.model, self.dp)
        self.optimizer = make_optimizer(cfg, self.model, self.steps_per_epoch, dp=self.dp)
        self._step = make_train_step(self.model, self.optimizer, device=self.device,
                                     iou_weight=cfg.TRAIN.IOU_WEIGHT,
                                     l1_weight=cfg.TRAIN.L1_WEIGHT, graphs=graphs,
                                     train_score=train_score,
                                     score_weight=cfg.TRAIN.get("SCORE_WEIGHT", 1.0),
                                     dp=self.dp)
        self._eval_step = make_eval_step(self.model, iou_weight=cfg.TRAIN.IOU_WEIGHT,
                                         l1_weight=cfg.TRAIN.L1_WEIGHT, device=self.device,
                                         dp=self.dp)
        # rank 0 alone writes metrics.jsonl
        self.stats = StatsTracker((log_dir or os.path.join(save_dir, "logs", script))
                                  if self.is_main else None,
                                  print_interval or cfg.TRAIN.PRINT_INTERVAL)
        #: per-step metrics (floats) of the last cycle_dataset, in order
        self.history: List[Dict[str, float]] = []
        #: per step of the last cycle_dataset: (seconds the loop waited for the
        #: look-ahead's batch on the host, the two timing events around the
        #: device stream's wait on its upload, or None on the CPU)
        self.input_waits: List[tuple] = []

    def _print(self, *args) -> None:
        if self.is_main:
            print(*args, flush=True)

    # ------------------------------------------------------------ ckpt/resume
    @property
    def world_size(self) -> int:
        return 1 if self.dp is None else self.dp.world

    def _generator_states(self) -> list:
        state = self.generator.get_state()
        return [state] if self.dp is None else self.dp.gather_objects(state)

    def save_checkpoint(self) -> Optional[str]:
        """Write this epoch's checkpoint; returns its path (None on the
        ranks that do not write). Every rank of a group calls it: the
        generators' states are gathered. Under FSDP every rank writes its
        shards (`utils.checkpoint.save_checkpoint_sharded`); otherwise rank
        0 writes the file and the others wait for it."""
        generators = self._generator_states()
        if self.fsdp:
            state = {"model": self.model.state_dict(),
                     "optimizer": self.optimizer.sharded_state_dict(),
                     "generators": torch.stack(generators),
                     "meta": torch.tensor([self.epoch, self.world_size])}
            return ckpt.save_checkpoint_sharded(self.ckpt_dir, self.net_name, self.epoch, state)
        path = None
        if self.is_main:
            state = {"epoch": self.epoch, "net_type": self.net_name,
                     "net": {k: v.detach().cpu() for k, v in self.model.state_dict().items()},
                     "optimizer": self.optimizer.state_dict(),
                     "generator": generators[0]}
            if self.dp is not None:
                state.update(generators=generators, world_size=self.world_size)
            path = ckpt.save_checkpoint(self.ckpt_dir, self.net_name, self.epoch, state)
        if self.dp is not None:
            self.dp.barrier()
        return path

    def _check_world(self, path: str, saved: int, reshard: bool) -> None:
        if saved != self.world_size and not reshard:
            raise ValueError(f"{path} was written by {saved} processes, this run has "
                             f"{self.world_size}: an exact resume needs the same world size "
                             f"(load_checkpoint(path, reshard=True) takes the weights and "
                             f"the optimizer state without it)")

    def load_checkpoint(self, path: Optional[str] = None, reshard: bool = False) -> bool:
        """Resume from `path` (default: the latest epoch in ckpt_dir, a
        sharded one under FSDP); False if there is none. Weights, buffers,
        optimizer state and the generator's state are copied into the
        tensors the training step's graphs hold, in place; every rank loads
        and takes its own generator's state. A checkpoint of another world
        size raises ValueError unless `reshard`, which loads the weights
        and the optimizer state (a sharded checkpoint into a one-process
        Trainer, say) and gives this rank the generator of rank `rank %
        saved world`: not an exact resume."""
        latest = ckpt.latest_checkpoint_sharded if self.fsdp else ckpt.latest_checkpoint
        path = path or latest(self.ckpt_dir, self.net_name)
        if not path or not os.path.exists(path):
            return False
        rank = 0 if self.dp is None else self.dp.rank
        if ckpt.is_sharded_checkpoint(path):
            state = {"model": self.model.state_dict(),
                     "optimizer": self.optimizer.sharded_state_dict()}
            keys = ckpt.sharded_checkpoint_keys(path)
            state["generators"] = torch.empty(keys["generators"], dtype=torch.uint8)
            state["meta"] = torch.zeros(2, dtype=torch.int64)
            ckpt.load_checkpoint_sharded(path, state)
            epoch, saved = (int(v) for v in state["meta"])
            self._check_world(path, saved, reshard)
            if not self.fsdp:           # plain tensors were filled: copy them in place
                self.model.load_state_dict(state["model"], strict=True)
            self.optimizer.load_sharded_counters(state["optimizer"])
            # a clone: set_state reads a view from its storage's start
            generator = state["generators"][rank % saved].clone()
        else:
            state = ckpt.load_checkpoint(path)
            saved = int(state.get("world_size", 1))
            self._check_world(path, saved, reshard)
            if self.fsdp:
                raise ValueError(f"{path} is not a sharded checkpoint; TRAIN.FSDP resumes "
                                 f"from the sharded ones (<Net>_ep%04d.dcp)")
            self.model.load_state_dict(state["net"], strict=True)
            self.optimizer.load_state_dict(state["optimizer"])
            epoch = int(state["epoch"])
            generator = state.get("generators", [state["generator"]])[rank % saved]
        self.generator.set_state(generator)
        self.epoch = epoch
        self._print(f"resumed from {path} (epoch {self.epoch})")
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
    def _prepared_batches(self, loader):
        """(inputs, batch size) of each batch of `loader`, converted and
        uploaded one batch ahead on a thread while the device runs the
        current one (the JAX Trainer's `_prepared_batches`). On the GPU the
        thread fills a ring of pinned host buffers (`model_inputs(out=)`),
        copies each to the device without blocking on a side stream and
        records an event; the consumer's stream waits on that event, and a
        buffer is refilled only after its copy's event has completed. On the
        CPU the same look-ahead runs without pinning or streams. Closing
        the generator (an abandoned epoch: the fail-safe restart, the NaN
        abort) stops the thread and the loader."""
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None
        q: "queue.Queue" = queue.Queue(maxsize=1)
        stop = threading.Event()

        def put_guarded(item) -> bool:
            # never block forever on an abandoned consumer: the thread, its
            # loader and the batches it holds would leak on every restart
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            ring, copied = [], []           # pinned buffers, each one's last copy
            batches = iter(loader)
            try:
                for k, batch in enumerate(batches):
                    host = batch_to_model_inputs(batch, rgbt=self.rgbt)
                    if not cuda:
                        item = (model_inputs(host, self.device), None)
                    else:
                        slot = k % _RING
                        if slot == len(ring):
                            ring.append(input_buffers(host, pin=True))
                            copied.append(None)
                        if copied[slot] is not None:
                            copied[slot].synchronize()
                        with torch.cuda.stream(side):
                            inputs = model_inputs(host, self.device, out=ring[slot])
                            copied[slot] = torch.cuda.Event()
                            copied[slot].record(side)
                        item = (inputs, copied[slot])
                    if not put_guarded(item):
                        return
                put_guarded(None)
            except BaseException as e:      # surface loader errors in the loop
                put_guarded(e)
            finally:
                close = getattr(batches, "close", None)
                if close is not None:
                    close()

        thread = threading.Thread(target=produce, daemon=True, name="trainer-lookahead")
        thread.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                host_wait = time.perf_counter() - t0
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                inputs, copied = item
                waited = None
                if copied is not None:
                    stream = torch.cuda.current_stream(self.device)
                    waited = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                    waited[0].record(stream)
                    stream.wait_event(copied)
                    waited[1].record(stream)
                    for t in inputs.values():
                        t.record_stream(stream)
                self.input_waits.append((host_wait, waited))
                yield inputs, inputs["gt_xywh"].shape[0]
        finally:
            stop.set()
            try:                            # unblock + free any queued batches
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=30.0)

    def cycle_dataset(self, loader=None, train: bool = True) -> dict:
        """One pass over `loader` (default: the train loader) at
        `self.epoch`: train steps, or val steps with train=False, on batches
        prepared one ahead (`_prepared_batches`). Returns the epoch's record
        (loader, epoch, mean metrics), also appended to metrics.jsonl; keeps
        the per-step metrics in `self.history`."""
        loader = self.train_loader if loader is None else loader
        self.stats.new_epoch()
        keep_rate = self._keep_rate(self.epoch) if train else None
        n = len(loader)
        self.history = []
        self.input_waits = []
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

        batches = self._prepared_batches(loader)
        try:
            for i, (inputs, bsz) in enumerate(batches, start=1):
                if train:
                    pending.append((self._step(inputs, ce_keep_rate=keep_rate), bsz))
                else:
                    pending.append((self._eval_step(inputs), bsz))
                if i % self.stats.print_interval == 0 or i == n:
                    drain()
                    self._print(self.stats.line(loader.name, self.epoch, i, n))
            drain()
        finally:
            batches.close()
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
        and retries, up to max_failures tries in all; under a group of more
        than one rank it raises whatever fail_safe says (module
        docstring)."""
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
                    self._print(f"epoch {self.epoch}/{max_epochs} done in "
                                f"{time.time() - t0:.1f}s")
                return self.model
            except Exception:
                self.epoch -= 1
                if not fail_safe or attempt == num_tries - 1 or self.world_size > 1:
                    raise
                print("Training crashed at epoch", self.epoch + 1)
                traceback.print_exc()
                print("Restarting from last checkpoint ...", flush=True)
                if not self.load_checkpoint():
                    print("no checkpoint yet: going on from the current weights", flush=True)
        return self.model
