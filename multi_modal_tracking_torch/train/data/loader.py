"""Batch loader: thread-pool prefetching over a sampler + numpy collation.
The port's own copy of the JAX package's `train/data/loader.py`. The
workers are threads (the pixel work runs in the C++ host data library,
which releases the interpreter lock); the sampler's per-index seeded random
streams keep batches deterministic under concurrent loading.
Each worker's sample goes straight into the batch's arrays (the processing
writes its images there; `BatchArrays`), so the collation runs in parallel
too, and the workers start on the next batch while one is collated.
"""
from __future__ import annotations

import queue
import threading
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np


def _is_frames(v) -> bool:
    return isinstance(v, list) and bool(v) and all(isinstance(a, np.ndarray) for a in v)


class BatchArrays:
    """The (n_frames, B, ...) arrays of a batch's list-of-frames fields,
    each allocated when a sample first asks for it. A worker puts sample j
    into slot j: the processing writes its images there itself
    (`destination(j)`), and `fill(j, sample)` copies whatever is not there
    yet. Thread-safe."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self.arrays: Dict[str, np.ndarray] = {}
        self._lock = threading.Lock()

    def _array(self, key: str, n_frames: int, shape: tuple, dtype) -> np.ndarray:
        want = (n_frames, self.batch_size) + tuple(shape)
        with self._lock:
            arr = self.arrays.get(key)
            if arr is None:
                arr = self.arrays[key] = np.empty(want, dtype)
        if arr.shape != want or arr.dtype != dtype:
            raise ValueError(f"field {key}: {np.dtype(dtype)} {want} does not match the "
                             f"batch's {arr.dtype} {arr.shape}")
        return arr

    def destination(self, j: int):
        """out(key, n_frames, frame, shape) -> the float32 slot of sample j's
        frame `frame` in field `key`, for the processing to write into."""
        return lambda key, n_frames, frame, shape: self._array(
            key, n_frames, shape, np.float32)[frame, j]

    def fill(self, j: int, sample: dict) -> None:
        for k, v in sample.items():
            if not _is_frames(v):
                continue
            for f, a in enumerate(v):
                slot = self._array(k, len(v), a.shape, a.dtype)[f, j]
                if slot.ctypes.data != a.ctypes.data:
                    slot[...] = a


def collate(samples: List[dict], filled: Optional[Dict[str, np.ndarray]] = None
            ) -> Dict[str, np.ndarray]:
    """Stack a list of processed sample dicts into batch arrays.

    List-of-frames fields (e.g. template_images_v = [t, ot]) become
    per-index keys: template_images_v -> stacked (n_frames, B, ...) array.
    `filled`: such arrays already filled (`BatchArrays`), used as they are;
    every sample must have exactly their list-of-frames fields.
    """
    if filled is not None:
        for i, s in enumerate(samples):
            if {k for k, v in s.items() if _is_frames(v)} != filled.keys():
                raise ValueError(f"sample {i}: frame fields differ from the batch's "
                                 f"{sorted(filled)}")
    out: Dict[str, np.ndarray] = {}
    keys = samples[0].keys()
    for k in keys:
        v0 = samples[0][k]
        if filled is not None and k in filled:
            out[k] = filled[k]
        elif isinstance(v0, list):
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

        def load(index: int, j: int, arrays: BatchArrays) -> dict:
            sample = self.sampler.sample(index, out=arrays.destination(j))
            arrays.fill(j, sample)
            return sample

        def produce():
            pool = ThreadPoolExecutor(self.num_workers, thread_name_prefix=f"loader-{self.name}")

            def submit(b):
                arrays = BatchArrays(self.batch_size)
                return arrays, [pool.submit(load, b * self.batch_size + i, i, arrays)
                                for i in range(self.batch_size)]
            try:
                ahead = submit(0) if self.n_batches else None
                for b in range(self.n_batches):
                    if stop.is_set():
                        return
                    arrays, futs = ahead
                    ahead = submit(b + 1) if b + 1 < self.n_batches else None
                    try:
                        batch = collate([f.result() for f in futs], arrays.arrays)
                    except Exception:
                        traceback.print_exc()
                        continue
                    if not put_guarded(batch):
                        return
                put_guarded(None)
            finally:
                pool.shutdown(wait=True, cancel_futures=True)

        t = threading.Thread(target=produce, daemon=True, name=f"loader-{self.name}")
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
