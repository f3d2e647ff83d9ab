"""Batch loader: thread-pool prefetching over a sampler + numpy collation.
The port's own copy of the JAX package's `train/data/loader.py`. The
workers are threads (numpy releases the GIL in its array work); the
sampler's per-index seeded random streams keep batches deterministic under
concurrent loading.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List

import numpy as np


def collate(samples: List[dict]) -> Dict[str, np.ndarray]:
    """Stack a list of processed sample dicts into batch arrays.

    List-of-frames fields (e.g. template_images_v = [t, ot]) become
    per-index keys: template_images_v -> stacked (n_frames, B, ...) array.
    """
    out: Dict[str, np.ndarray] = {}
    keys = samples[0].keys()
    for k in keys:
        v0 = samples[0][k]
        if isinstance(v0, list):
            out[k] = np.stack([np.stack([s[k][i] for s in samples]) for i in range(len(v0))])
        elif isinstance(v0, np.ndarray) or np.isscalar(v0):
            out[k] = np.stack([np.asarray(s[k]) for s in samples])
        # strings (dataset names) and bools dropped from the device batch
    return out


class Loader:
    """Iterable over an epoch of collated batches with background prefetch."""

    def __init__(self, sampler, batch_size: int, num_workers: int = 8,
                 prefetch: int = 4, drop_last: bool = True, name: str = "train",
                 training: bool = True, epoch_interval: int = 1):
        self.sampler = sampler
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.name = name
        self.training = training
        self.epoch_interval = epoch_interval
        self.n_batches = len(sampler) // batch_size

    def __len__(self):
        return self.n_batches

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_guarded(item) -> bool:
            # never block forever on an abandoned consumer (e.g. the NaN
            # fail-safe abort): a plain q.put would pin this thread, the
            # ThreadPoolExecutor scope, and prefetch+1 collated batches
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            with ThreadPoolExecutor(self.num_workers) as pool:
                for b in range(self.n_batches):
                    if stop.is_set():
                        return
                    futs = [pool.submit(self.sampler.__getitem__, b * self.batch_size + i)
                            for i in range(self.batch_size)]
                    try:
                        batch = collate([f.result() for f in futs])
                    except Exception:
                        import traceback
                        traceback.print_exc()
                        continue
                    if not put_guarded(batch):
                        return
            put_guarded(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                yield batch
        finally:
            stop.set()
            try:                    # unblock + free any queued batches
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5.0)


def batch_to_model_inputs(batch: Dict[str, np.ndarray], rgbt: bool = True) -> Dict[str, np.ndarray]:
    """Map collated batch fields to the train-step input dict.

    Reference layout (actors/mixformer_rgbt.py:54-63): template frame 0 is the
    static template, frame 1 the online template; RGB search anno is the
    training label.
    """
    if rgbt:
        out = {
            "template_v": batch["template_images_v"][0],
            "template_i": batch["template_images_i"][0],
            "online_template_v": batch["template_images_v"][1] if batch["template_images_v"].shape[0] > 1
            else batch["template_images_v"][0],
            "online_template_i": batch["template_images_i"][1] if batch["template_images_i"].shape[0] > 1
            else batch["template_images_i"][0],
            "search_v": batch["search_images_v"][0],
            "search_i": batch["search_images_i"][0],
            "gt_xywh": batch["search_anno_v"][0],
        }
    else:
        out = {
            "template": batch["template_images"][0],
            "online_template": batch["template_images"][1] if batch["template_images"].shape[0] > 1
            else batch["template_images"][0],
            "search": batch["search_images"][0],
            "gt_xywh": batch["search_anno"][0],
        }
    if "label" in batch:
        out["labels"] = batch["label"]
        xywh = np.asarray(out["gt_xywh"])
        out["gt_xyxy"] = np.concatenate(
            [xywh[..., :2], xywh[..., :2] + xywh[..., 2:]], axis=-1)
    return out
