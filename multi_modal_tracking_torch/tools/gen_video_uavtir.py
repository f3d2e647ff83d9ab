"""Result-vs-ground-truth videos on the TIR frames: gen_video with
--modality ir and --dataset_name vtuav_short unless given; the port's
counterpart of tracking/gen_video_uavtir.py.

  python -m multi_modal_tracking_torch.tools.gen_video_uavtir \\
      --results 'mine=output/tracking_results/asymmetric_shared_ce/baseline'
"""
from __future__ import annotations

import sys

from multi_modal_tracking_torch.tools import gen_video


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith("--modality") for a in argv):
        argv = ["--modality", "ir"] + argv
    if not any(a.startswith("--dataset_name") for a in argv):
        argv = ["--dataset_name", "vtuav_short"] + argv
    return gen_video.main(argv)


if __name__ == "__main__":
    main()
