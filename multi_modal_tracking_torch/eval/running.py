"""Sequence runner: drive a tracker over evaluation sequences and write the
result files (the port's own counterpart of the JAX package's
`eval/running.py`).

`run_sequence` writes, per sequence, in the reference's layout:
  <seq>.txt       the boxes, one xywh row per frame, `%d`, tab-separated;
                  frame 0 holds the init box
  <seq>_time.txt  seconds per frame, `%f` (amortised over the sequence on
                  the chunked paths)
  <seq>_score.txt the online trackers' confidence per frame, `%.2f`,
                  frame 0 at 1.0
A background thread (`_Prefetcher`) stacks the next chunks of
frames while the device tracks; the chunked path dispatches every chunk
with `track_chunk(fetch=False)` and fetches all boxes once at the end.
With `roi_margin` > 0 only a window around the box is uploaded per chunk
(`track_chunk_roi`), and a chunk whose crops left the window is redone on
full frames from a snapshot, so the files are those of the full-frame path
byte for byte; the online and unimodal trackers have no ROI mode yet and
raise.

Frames are uint8 arrays, or image files that the prefetch thread decodes
with the port's own decoder (`native.imread`, JPEG and PNG): an RGB-T
pair of paths, a DepthTrack pair whose second file is a depth map
(rendered as replicated greyscale, `utils/depth.py`), or an LMDB (db,
key) pair. A file the decoder does not take raises with its path.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from queue import Queue
from typing import List, Optional

import numpy as np
import torch

from multi_modal_tracking_torch import native
from multi_modal_tracking_torch.eval.data import RGBTSequence, Sequence
from multi_modal_tracking_torch.tracking.tracker import (_select_init_box, place_window,
                                                         roi_window)

#: smallest ROI window side (pixels) and the multiple it is rounded up to;
#: the CLI and run_dataset always use these, only small-frame tests change them
ROI_MIN_SIZE, ROI_ALIGN = 192, 64


def _imread(path) -> np.ndarray:
    """An RGB uint8 frame from a JPEG or PNG file."""
    return native.imread(path)


def _read_depth_as_rgb(path) -> np.ndarray:
    """A depth map (a grey PNG, uint16 as stored) -> the clipped, min-max
    stretched map as replicated greyscale uint8 (H, W, 3), the JAX
    package's DepthTrack reading; the TIR pipeline's JET mapping follows
    in the tracker."""
    from multi_modal_tracking_torch.utils.depth import depth_rgb3d
    return depth_rgb3d(native.imread_unchanged(path))


def _load_frame(seq, k):
    """Frame k of a sequence: [frame_v, frame_i] for RGB-T sequences, the
    array for unimodal ones; files are decoded here."""
    fr = seq.frames[k]
    if isinstance(seq, RGBTSequence):
        fv, fi = fr
        if isinstance(fv, np.ndarray):
            return [fv, fi]
        img_v = _imread(fv)
        return [img_v, _read_depth_as_rgb(fi) if seq.depth_input else _imread(fi)]
    if isinstance(fr, np.ndarray):
        return fr
    if isinstance(fr, (tuple, list)):
        # an LMDB-packed frame: (db_path, key)
        from multi_modal_tracking_torch.utils.lmdb_utils import decode_img
        return decode_img(*fr)
    return _imread(fr)


#: threads that decode a chunk's frames (the decoder releases the
#: interpreter lock, so they decode in parallel)
DECODE_THREADS = 4


class _Prefetcher:
    """Background frame loader: keeps `depth` stacked chunks of frames ahead
    of the device, each chunk's frames read on DECODE_THREADS threads; an
    error while loading is raised in the consumer."""

    def __init__(self, seq, start: int, chunk: int, depth: int = 2):
        self.seq, self.chunk = seq, chunk
        self.q: Queue = Queue(maxsize=depth)
        self.n = len(seq.frames)
        self.start = start
        self.t = threading.Thread(target=self._work, daemon=True)
        self.t.start()

    def _work(self):
        try:
            with ThreadPoolExecutor(DECODE_THREADS) as pool:
                self._chunks(pool)
        except Exception as e:          # hand it to the consumer, which would
            self.q.put(e)               # otherwise wait for a sentinel that
            return                      # never comes
        self.q.put(None)

    def _chunks(self, pool):
        for lo in range(self.start, self.n, self.chunk):
            hi = min(lo + self.chunk, self.n)
            frames = list(pool.map(lambda k: _load_frame(self.seq, k), range(lo, hi)))
            if isinstance(self.seq, RGBTSequence):
                self.q.put((lo, hi, np.stack([f[0] for f in frames]),
                            np.stack([f[1] for f in frames])))
            else:
                self.q.put((lo, hi, np.stack(frames), None))

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item


def _track_roi(seq, tracker, chunk, roi_margin, roi_min_size, roi_align):
    """The ROI-window chunked path: (boxes of frames 1.., roi stats)."""
    collected = []
    n_fallback = n_windowed = n_chunks = 0
    # window-size hysteresis: keep the last (re-centred) size while it
    # still covers the size needed now, so the size changes only when the
    # target really grows
    prev_sz = None
    for _, _, fv, fi in _Prefetcher(seq, 1, chunk):
        n_chunks += 1
        fi = fv if fi is None else fi
        box = tracker.current_box()
        win = roi_window(box, fv.shape[1:3], tracker.search_factor, margin=roi_margin,
                         align=roi_align, min_size=roi_min_size)
        if win is None:                        # the window would be the frame
            collected.append(tracker.track_chunk(fv, fi, fetch=True))
            continue
        if prev_sz is not None and win[1][0] <= prev_sz[0] and win[1][1] <= prev_sz[1]:
            win = place_window(box, fv.shape[1:3], prev_sz)
        prev_sz = win[1]
        (ox, oy), (hw, ww) = win
        wv = np.ascontiguousarray(fv[:, oy:oy + hw, ox:ox + ww])
        wi = np.ascontiguousarray(fi[:, oy:oy + hw, ox:ox + ww])
        snap = tracker.snapshot()
        out, oks = tracker.track_chunk_roi(wv, wi, (ox, oy), fetch=True)
        if bool(np.all(oks)):
            n_windowed += 1
            collected.append(out)
        else:                                  # the crop left the window: redo
            n_fallback += 1
            tracker.restore(snap)
            collected.append(tracker.track_chunk(fv, fi, fetch=True))
    return np.concatenate(collected), {"n_chunks": n_chunks, "n_windowed": n_windowed,
                                       "n_fallback": n_fallback}


def run_sequence(seq: Sequence, tracker, results_dir: str, skip_if_done: bool = True,
                 chunk: int = 16, report_fps: bool = True, save_vis: bool = False,
                 roi_margin: float = 0.0, roi_min_size: int = ROI_MIN_SIZE,
                 roi_align: int = ROI_ALIGN) -> Optional[dict]:
    """Track one sequence and write <results_dir>/<seq>.txt and _time.txt.

    Returns None when the result file exists and skip_if_done is set, else
    {"seq", "n_frames", "fps", "boxes"} (boxes: the (n, 4) float64
    trajectory the file rounds; plus "scores" from an online tracker, which
    also writes <seq>_score.txt, and "n_chunks", "n_windowed",
    "n_fallback" in ROI mode). A tracker with `track_chunk` runs chunked
    (`chunk` frames per dispatch), one with only `track` per frame.

    roi_margin > 0 uploads, per chunk, a window of roi_margin times the
    search region (at least roi_min_size, rounded up to roi_align) instead
    of the frames, at the cost of one 4-float fetch per chunk; the files are
    the full-frame path's byte for byte. save_vis (a video of the search
    regions) needs cv2, which the port does not use, and raises."""
    if save_vis:
        raise NotImplementedError("save_vis writes a video with cv2, which the port does not "
                                  "use (ROADMAP.md queue 1 item 1)")
    online = getattr(tracker, "online", False)
    mode = getattr(tracker, "mode", None)           # the unimodal trackers' input mode
    if roi_margin > 0 and (online or mode):
        raise NotImplementedError("roi_margin > 0 with an online or unimodal tracker: "
                                  "ROI-window uploads are not ported for them (ROADMAP.md "
                                  "queue 1 item 1)")
    os.makedirs(results_dir, exist_ok=True)
    bbox_file = os.path.join(results_dir, f"{seq.name}.txt")
    if skip_if_done and os.path.isfile(bbox_file):
        return None

    n = len(seq.frames)
    boxes = np.zeros((n, 4), dtype=np.float64)
    times = np.zeros((n,), dtype=np.float64)
    scores = np.ones((n,), dtype=np.float64) if online else None
    frame0 = _load_frame(seq, 0)
    t0 = time.time()
    tracker.initialize(frame0, seq.init_info())
    # frame 0's box is the init box the tracker's mode took
    boxes[0] = np.asarray(_select_init_box(seq.init_info()["init_bbox"], mode or "RGB"))
    times[0] = time.time() - t0

    roi_stats = None
    if n > 1 and roi_margin > 0 and hasattr(tracker, "track_chunk_roi"):
        t_seq = time.time()
        tracked, roi_stats = _track_roi(seq, tracker, chunk, roi_margin, roi_min_size,
                                        roi_align)
        boxes[1:] = tracked[: n - 1]
        times[1:] = (time.time() - t_seq) / (n - 1)
    elif n > 1 and hasattr(tracker, "track_chunk"):
        # every chunk is dispatched without a fetch; the boxes come back in
        # one copy at the end
        t_seq = time.time()
        pending = [tracker.track_chunk(fv, fv if fi is None else fi, fetch=False)
                   for _, _, fv, fi in _Prefetcher(seq, 1, chunk)]
        if online:
            scores[1:] = torch.cat([p[1] for p in pending]).cpu().numpy()[: n - 1]
            pending = [p[0] for p in pending]
        boxes[1:] = torch.cat(pending).cpu().numpy()[: n - 1]
        times[1:] = (time.time() - t_seq) / (n - 1)   # amortised per frame
    else:
        for k in range(1, n):
            frame = _load_frame(seq, k)
            t0 = time.time()
            out = tracker.track(frame)
            boxes[k] = np.asarray(out["target_bbox"])
            times[k] = time.time() - t0
            if online:
                scores[k] = out["pred_score"]

    np.savetxt(bbox_file, boxes, delimiter="\t", fmt="%d")
    if online:
        np.savetxt(os.path.join(results_dir, f"{seq.name}_score.txt"), scores, delimiter="\t",
                   fmt="%.2f")
    np.savetxt(os.path.join(results_dir, f"{seq.name}_time.txt"), times, fmt="%f")
    fps = n / max(times.sum(), 1e-9)
    stats = {"seq": seq.name, "n_frames": n, "fps": fps, "boxes": boxes}
    if online:
        stats["scores"] = scores
    roi_msg = ""
    if roi_stats is not None:
        stats.update(roi_stats)
        roi_msg = (f" | roi: {roi_stats['n_windowed']}/{roi_stats['n_chunks']} chunks "
                   f"windowed, {roi_stats['n_fallback']} fallbacks")
    if report_fps:
        print(f"{seq.name}: {n} frames, {fps:.1f} FPS{roi_msg}")
    return stats


def run_dataset(dataset, tracker, results_dir: str, skip_if_done: bool = True,
                chunk: int = 16, threads: int = 0, tracker_factory=None, devices=None,
                save_vis: bool = False, roi_margin: float = 0.0) -> List[dict]:
    """Run a tracker over every sequence of `dataset`.

    threads > 0 with tracker_factory maps the sequences over a thread pool
    with one tracker per worker thread (host work of one worker overlaps
    the device work of another). Without `devices` the workers share the
    one card and call `tracker_factory()`. With `devices` (e.g.
    ["cuda:0", "cuda:1"]; the JAX package's `run_dataset(devices=...)`,
    the reference's per-GPU process pool) the workers are pinned to them
    round-robin: worker k makes devices[k % len(devices)] its thread's
    current CUDA device (so its graphs capture there) and calls
    `tracker_factory(device)`, which must build the tracker on that
    device; a tracker on another device raises. `devices` without threads
    and a factory raises."""
    if devices:
        if not (threads and tracker_factory is not None):
            raise ValueError("run_dataset(devices=...) pins worker threads to the devices: "
                             "pass threads > 0 and a tracker_factory(device)")
        devices = [torch.device(d) for d in devices]
    kw = dict(skip_if_done=skip_if_done, chunk=chunk, save_vis=save_vis,
              roi_margin=roi_margin)
    if threads and tracker_factory is not None:
        local = threading.local()
        worker_ids = itertools.count()

        def make():
            if not devices:
                return tracker_factory()
            dev = devices[next(worker_ids) % len(devices)]
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            made = tracker_factory(dev)
            got = torch.device(getattr(made, "device", dev))
            if got.type != dev.type or (dev.index is not None and got.index != dev.index):
                raise ValueError(f"run_dataset: the worker of {dev} got a tracker on {got}")
            return made

        def work(seq):
            if not hasattr(local, "tracker"):
                local.tracker = make()
            return run_sequence(seq, local.tracker, results_dir, **kw)
        with ThreadPoolExecutor(max_workers=threads) as ex:
            stats = [s for s in ex.map(work, dataset) if s is not None]
    else:
        stats = [s for s in (run_sequence(seq, tracker, results_dir, **kw) for seq in dataset)
                 if s is not None]
    if stats:
        total = sum(s["n_frames"] for s in stats)
        tfps = total / max(sum(s["n_frames"] / s["fps"] for s in stats), 1e-9)
        print(f"ran {len(stats)} sequences, {total} frames, mean {tfps:.1f} FPS")
    return stats
