"""Metric tables (AUC, OP50, OP75, precision, normalised precision with the
RGB-T max/min rule) and optionally the success / precision plots of the
result directories a glob finds; the port's counterpart of
tracking/analysis_results.py over `eval/analysis.py`.

  python -m multi_modal_tracking_torch.tools.analysis_results --dataset_name lasher \\
      --results_glob 'output/tracking_results/asymmetric_shared_ce/*' --plot

--plot needs matplotlib (ImportError without it).
"""
from __future__ import annotations

import argparse
import glob
import os


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m multi_modal_tracking_torch.tools."
                                     "analysis_results")
    p.add_argument("--dataset_name", type=str, default="lasher")
    p.add_argument("--dataset_split", type=str, default="",
                   help="e.g. _short/_long for vtuav")
    p.add_argument("--results_glob", type=str, required=True,
                   help="glob of tracker result dirs (each containing <dataset>/ or <seq>.txt)")
    p.add_argument("--report_name", type=str, default=None)
    p.add_argument("--plot", action="store_true")
    p.add_argument("--per_sequence", action="store_true")
    p.add_argument("--plot_dir", type=str, default="output/result_plots")
    args = p.parse_args(argv)

    from multi_modal_tracking_torch.eval.analysis import (TrackerResults, extract_results,
                                                          plot_results,
                                                          print_per_sequence_results,
                                                          print_results)
    from multi_modal_tracking_torch.eval.datasets import get_dataset

    dataset_name = args.dataset_name + args.dataset_split
    dataset = get_dataset(dataset_name)
    trackers = []
    for d in sorted(glob.glob(args.results_glob)):
        sub = os.path.join(d, dataset_name)
        trackers.append(TrackerResults(sub if os.path.isdir(sub) else d,
                                       display_name=os.path.basename(d.rstrip("/"))))
    if not trackers:
        raise SystemExit(f"no result dirs match {args.results_glob}")

    report = args.report_name or dataset_name
    # extract once; every report and plot below reuses the scored curves
    eval_data = extract_results(trackers, dataset, report)
    print_results(trackers, dataset, report, eval_data=eval_data)
    if args.per_sequence:
        print_per_sequence_results(trackers, dataset, report, eval_data=eval_data)
    if args.plot:
        files = plot_results(trackers, dataset, report, result_plot_path=args.plot_dir,
                             eval_data=eval_data)
        print("plots:", *files, sep="\n  ")


if __name__ == "__main__":
    main()
