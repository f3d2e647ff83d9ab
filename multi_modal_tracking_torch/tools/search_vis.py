"""Search-feature panels (RGB, TIR, fused) of several RGB-T models run on
the same frames, one PNG per model and frame; the port's counterpart of
tracking/search_vis.py over `eval/visualize.py dump_search_features`,
with the tracking overlay experiments/tracking_vis.yaml by default.

  python -m multi_modal_tracking_torch.tools.search_vis \\
      --scripts asymmetric_shared asymmetric_shared_ce \\
      --dataset_name synthetic_rgbt --sequence synthetic_00 --out output/search_vis
"""
from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m multi_modal_tracking_torch.tools.search_vis")
    p.add_argument("--scripts", type=str, nargs="+", required=True)
    p.add_argument("--configs", type=str, nargs="*", default=None)
    p.add_argument("--checkpoints", type=str, nargs="*", default=None)
    p.add_argument("--dataset_name", type=str, default="synthetic_rgbt")
    p.add_argument("--sequence", type=str, default=None)
    p.add_argument("--frames", type=int, nargs="*", default=[0],
                   help="frame indices to dump")
    p.add_argument("--out", type=str, default="output/search_vis")
    p.add_argument("--tracking_yaml", type=str, default="tracking_vis",
                   help="tracking-time overlay (experiments/<name>.yaml); "
                        "tracking_vis applies GT-anchored jitter crops")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["bfloat16", "float32"])
    args = p.parse_args(argv)

    from multi_modal_tracking_torch.eval.datasets import get_dataset
    from multi_modal_tracking_torch.eval.evaltracker import create_tracker
    from multi_modal_tracking_torch.eval.params import get_parameters
    from multi_modal_tracking_torch.eval.running import _load_frame
    from multi_modal_tracking_torch.eval.visualize import dump_search_features
    from multi_modal_tracking_torch.utils.device import DTYPES

    dataset = get_dataset(args.dataset_name)
    seq = dataset[args.sequence] if args.sequence else dataset[0]
    trackers = {}
    for i, script in enumerate(args.scripts):
        cfg_name = args.configs[i] if args.configs else None
        ckpt = args.checkpoints[i] if args.checkpoints else None
        params = get_parameters(script, cfg_name, tracking_yaml=args.tracking_yaml,
                                checkpoint=ckpt)
        trackers[script] = create_tracker(params, dataset_name=args.dataset_name,
                                          device=args.device, dtype=DTYPES[args.dtype])
    info = seq.init_info()
    written = []
    for fid in args.frames:
        frame = _load_frame(seq, fid)
        paths = dump_search_features(trackers, frame, info, args.out, frame_id=fid)
        print(*paths, sep="\n")
        written += paths
    return written


if __name__ == "__main__":
    main()
