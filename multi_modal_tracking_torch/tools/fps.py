"""Frames per second from saved <seq>_time.txt result files: all frames of
every sequence of a results directory over their summed seconds (the
per-frame times include pre- and post-processing, not the frame reads).
The port's counterpart of tracking/fps.py.

  python -m multi_modal_tracking_torch.tools.fps <results_dir>
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def fps(results_dir: str):
    """(frames, seconds) over every *_time.txt of `results_dir`."""
    total_time, total_frames = 0.0, 0
    for f in sorted(glob.glob(os.path.join(results_dir, "*_time.txt"))):
        t = np.loadtxt(f).reshape(-1)
        total_time += t.sum()
        total_frames += t.size
    return total_frames, total_time


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m multi_modal_tracking_torch.tools.fps")
    p.add_argument("results_dir", type=str)
    args = p.parse_args(argv)
    total_frames, total_time = fps(args.results_dir)
    if total_frames == 0:
        raise SystemExit(f"no *_time.txt under {args.results_dir}")
    print(f"{total_frames} frames, {total_time:.2f}s, "
          f"{total_frames / total_time:.2f} FPS")


if __name__ == "__main__":
    main()
