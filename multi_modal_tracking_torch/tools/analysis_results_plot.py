"""Success / precision plots of this framework's results beside external
raw results (downloaded prior trackers) in one figure; --language cn
labels them in Chinese. The port's counterpart of
tracking/analysis_results_plot.py; needs matplotlib (ImportError without
it).

  python -m multi_modal_tracking_torch.tools.analysis_results_plot --dataset_name lasher \\
      --results_glob 'output/tracking_results/*/*' \\
      --external_glob 'output/external_results/*' --language en
"""
from __future__ import annotations

import argparse
import glob
import os


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m multi_modal_tracking_torch.tools."
                                     "analysis_results_plot")
    p.add_argument("--dataset_name", type=str, default="lasher")
    p.add_argument("--dataset_split", type=str, default="")
    p.add_argument("--results_glob", type=str, required=True)
    p.add_argument("--external_glob", type=str, default=None,
                   help="glob of downloaded prior-tracker result dirs")
    p.add_argument("--report_name", type=str, default=None)
    p.add_argument("--language", choices=["en", "cn"], default="en")
    p.add_argument("--plot_dir", type=str, default="output/result_plots")
    args = p.parse_args(argv)

    from multi_modal_tracking_torch.eval.analysis import TrackerResults, plot_results
    from multi_modal_tracking_torch.eval.datasets import get_dataset

    dataset_name = args.dataset_name + args.dataset_split
    dataset = get_dataset(dataset_name)
    globs = [args.results_glob] + ([args.external_glob] if args.external_glob else [])
    trackers = []
    for g in globs:
        for d in sorted(glob.glob(g)):
            sub = os.path.join(d, dataset_name)
            trackers.append(TrackerResults(sub if os.path.isdir(sub) else d,
                                           display_name=os.path.basename(d.rstrip("/"))))
    if not trackers:
        raise SystemExit("no result dirs found")
    files = plot_results(trackers, dataset, args.report_name or dataset_name,
                         result_plot_path=args.plot_dir, language=args.language)
    print("plots:", *files, sep="\n  ")


if __name__ == "__main__":
    main()
