"""Warm the file system's cache by reading training datasets: of every
sequence its first, middle and last frame (--full: every frame), through
the port's own decoder (LMDB databases where the set is one). The port's
counterpart of tracking/pre_read_datasets.py.

  python -m multi_modal_tracking_torch.tools.pre_read_datasets --datasets LasHeR GOT10K_train
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m multi_modal_tracking_torch.tools."
                                     "pre_read_datasets")
    p.add_argument("--datasets", type=str, nargs="+", default=["LasHeR"])
    p.add_argument("--full", action="store_true", help="read every frame")
    args = p.parse_args(argv)

    from multi_modal_tracking_torch.train.builders import names2datasets

    t0 = time.time()
    n_read = 0
    for ds in names2datasets(args.datasets):
        for seq_id in range(len(ds.sequence_list)):
            info = ds.get_sequence_info(seq_id)
            n = int(info["visible"].shape[0])
            ids = range(n) if args.full else sorted({0, n // 2, n - 1})
            try:
                frames, _, _ = ds.get_frames(seq_id, list(ids), info)
                n_read += len(frames)
            except Exception as e:
                print(f"  ! {ds.get_name()}[{seq_id}]: {e}")
        print(f"{ds.get_name()}: warmed {len(ds.sequence_list)} sequences")
    print(f"read {n_read} frames in {time.time() - t0:.1f}s")
    return n_read


if __name__ == "__main__":
    main()
