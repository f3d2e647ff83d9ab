"""The VTUAV tables: analysis_results with --dataset_name vtuav and
--dataset_split _short unless given (the sparse 10-frame ground truth is
eval/metrics.py's); the port's counterpart of
tracking/analysis_results_vtuav.py.

  python -m multi_modal_tracking_torch.tools.analysis_results_vtuav --dataset_split _long \\
      --results_glob 'output/tracking_results/asymmetric_shared_ce/*'
"""
from __future__ import annotations

import sys

from multi_modal_tracking_torch.tools import analysis_results


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith("--dataset_name") for a in argv):
        argv = ["--dataset_name", "vtuav"] + argv
    if not any(a.startswith("--dataset_split") for a in argv):
        argv = ["--dataset_split", "_short"] + argv
    analysis_results.main(argv)


if __name__ == "__main__":
    main()
