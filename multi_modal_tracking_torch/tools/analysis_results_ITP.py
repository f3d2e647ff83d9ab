"""The metric tables of results addressed by a storage root and tracker
names (<root>/<script>/<config>[/<dataset>]); the port's counterpart of
tracking/analysis_results_ITP.py.

  python -m multi_modal_tracking_torch.tools.analysis_results_ITP --results_root /mnt/results \\
      --tracker_names asymmetric_shared_ce/baseline mixformer_vit/baseline --dataset_name lasher
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m multi_modal_tracking_torch.tools."
                                     "analysis_results_ITP")
    p.add_argument("--results_root", type=str, required=True)
    p.add_argument("--tracker_names", type=str, nargs="+", required=True,
                   help="paths under results_root, e.g. <script>/<config>")
    p.add_argument("--dataset_name", type=str, default="lasher")
    p.add_argument("--dataset_split", type=str, default="")
    p.add_argument("--per_sequence", action="store_true")
    args = p.parse_args(argv)

    from multi_modal_tracking_torch.eval.analysis import (TrackerResults,
                                                          print_per_sequence_results,
                                                          print_results)
    from multi_modal_tracking_torch.eval.datasets import get_dataset

    dataset_name = args.dataset_name + args.dataset_split
    dataset = get_dataset(dataset_name)
    trackers = []
    for name in args.tracker_names:
        d = os.path.join(args.results_root, name)
        sub = os.path.join(d, dataset_name)
        trackers.append(TrackerResults(sub if os.path.isdir(sub) else d, display_name=name))
    print_results(trackers, dataset, dataset_name)
    if args.per_sequence:
        print_per_sequence_results(trackers, dataset, dataset_name)


if __name__ == "__main__":
    main()
