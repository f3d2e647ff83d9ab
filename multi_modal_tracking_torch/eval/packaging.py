"""Benchmark-server result packaging (the port's own copy of the JAX
package's `eval/packaging.py`).

Parity target: lib/test/utils/transform_got10k.py (:10-43) and
transform_trackingnet.py — convert the runner's per-sequence txt output into
the zip layouts the GOT-10k / TrackingNet evaluation servers expect.
"""
from __future__ import annotations

import os
import shutil

import numpy as np


def transform_got10k(results_dir: str, out_dir: str, tracker_name: str) -> str:
    """<results>/<seq>.txt + <seq>_time.txt -> GOT-10k server zip:
    one folder per sequence with <seq>_001.txt (comma boxes) + <seq>_time.txt."""
    seq_names = sorted(f[:-4] for f in os.listdir(results_dir)
                       if f.endswith(".txt")
                       and not f.endswith(("_time.txt", "_score.txt")))
    stage = os.path.join(out_dir, tracker_name)
    os.makedirs(stage, exist_ok=True)
    for name in seq_names:
        boxes = np.loadtxt(os.path.join(results_dir, f"{name}.txt"), delimiter="\t")
        seq_dir = os.path.join(stage, name)
        os.makedirs(seq_dir, exist_ok=True)
        # integer boxes, comma-separated (transform_got10k.py:28-29)
        np.savetxt(os.path.join(seq_dir, f"{name}_001.txt"),
                   np.asarray(boxes, np.int64), fmt="%d", delimiter=",")
        time_file = os.path.join(results_dir, f"{name}_time.txt")
        if os.path.isfile(time_file):
            # the reference copies the time file verbatim (:36)
            shutil.copyfile(time_file, os.path.join(seq_dir, f"{name}_time.txt"))
    zip_path = shutil.make_archive(stage, "zip", stage)
    return zip_path


def transform_trackingnet(results_dir: str, out_dir: str, tracker_name: str) -> str:
    """<results>/<seq>.txt -> TrackingNet server zip: flat <seq>.txt with
    comma-separated boxes."""
    seq_names = sorted(f[:-4] for f in os.listdir(results_dir)
                       if f.endswith(".txt")
                       and not f.endswith(("_time.txt", "_score.txt")))
    stage = os.path.join(out_dir, tracker_name)
    os.makedirs(stage, exist_ok=True)
    for name in seq_names:
        boxes = np.loadtxt(os.path.join(results_dir, f"{name}.txt"), delimiter="\t")
        # integer boxes, comma-separated (transform_trackingnet.py:23-24)
        np.savetxt(os.path.join(stage, f"{name}.txt"),
                   np.asarray(boxes, np.int64), fmt="%d", delimiter=",")
    zip_path = shutil.make_archive(stage, "zip", stage)
    return zip_path
