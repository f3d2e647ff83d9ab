"""One table of AUC / precision per tracker over several datasets, each
cell from the result directories of the glob that hold that dataset's
results; the port's counterpart of tracking/analysis_results_crossdatasets.py.

  python -m multi_modal_tracking_torch.tools.analysis_results_crossdatasets \\
      --datasets_name lasher rgbt234 --results_glob 'output/tracking_results/*/*'
"""
from __future__ import annotations

import argparse
import glob
import os


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m multi_modal_tracking_torch.tools."
                                     "analysis_results_crossdatasets")
    p.add_argument("--datasets_name", type=str, nargs="+", required=True)
    p.add_argument("--results_glob", type=str, required=True)
    args = p.parse_args(argv)

    from multi_modal_tracking_torch.eval.analysis import (TrackerResults, compute_scores,
                                                          extract_results)
    from multi_modal_tracking_torch.eval.datasets import get_dataset

    table = {}          # display name -> {dataset -> (auc, precision)}
    for dataset_name in args.datasets_name:
        dataset = get_dataset(dataset_name)
        for d in sorted(glob.glob(args.results_glob)):
            sub = os.path.join(d, dataset_name)
            res_dir = sub if os.path.isdir(sub) else d
            name = os.path.relpath(d, os.path.commonpath(glob.glob(args.results_glob)) or d)
            tr = TrackerResults(res_dir, display_name=name)
            try:
                data = extract_results([tr], dataset, dataset_name)
            except (FileNotFoundError, OSError):
                continue
            scores = compute_scores(data)
            table.setdefault(name, {})[dataset_name] = (
                float(scores["AUC"][0]), float(scores["Precision"][0]))

    if not table:
        raise SystemExit("no results found for any dataset")
    cols = args.datasets_name
    head = "tracker".ljust(40) + "".join(f"{c:>22}" for c in cols)
    print(head)
    print("-" * len(head))
    for name, per_ds in sorted(table.items()):
        row = name.ljust(40)
        for c in cols:
            if c in per_ds:
                row += f"{per_ds[c][0]:>10.2f}/{per_ds[c][1]:<11.2f}"
            else:
                row += f"{'-':>22}"
        print(row)
    print("(cells: AUC/Precision)")


if __name__ == "__main__":
    main()
