"""Attention maps of the flagship CE model while it tracks a sequence: at
each listed frame, per CE block, the template->search attention of both
modalities as JET panels (PNG); the port's counterpart of
tracking/vis_attn.py over `eval/visualize.py dump_attention_maps`.

  python -m multi_modal_tracking_torch.tools.vis_attn asymmetric_shared_ce baseline \\
      --dataset_name lasher --sequence car1 --frames 10 20 --out_dir output/attn_vis
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m multi_modal_tracking_torch.tools.vis_attn")
    p.add_argument("script", type=str)
    p.add_argument("config", type=str)
    p.add_argument("--dataset_name", type=str, default="lasher")
    p.add_argument("--sequence", type=str, default=None)
    p.add_argument("--frames", type=int, nargs="+", default=[1, 25, 50])
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--out_dir", type=str, default="output/attn_vis")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["bfloat16", "float32"])
    args = p.parse_args(argv)

    from multi_modal_tracking_torch.eval.datasets import get_dataset
    from multi_modal_tracking_torch.eval.evaltracker import create_tracker
    from multi_modal_tracking_torch.eval.params import get_parameters
    from multi_modal_tracking_torch.eval.running import _load_frame
    from multi_modal_tracking_torch.eval.visualize import dump_attention_maps
    from multi_modal_tracking_torch.utils.device import DTYPES

    params = get_parameters(args.script, args.config, checkpoint=args.checkpoint)
    tracker = create_tracker(params, dataset_name=args.dataset_name, device=args.device,
                             dtype=DTYPES[args.dtype])
    dataset = get_dataset(args.dataset_name)
    seq = next(s for s in dataset if args.sequence is None or s.name == args.sequence)
    tracker.initialize(_load_frame(seq, 0), seq.init_info())
    out_paths = []
    for k in range(1, max(args.frames) + 1):
        frame = _load_frame(seq, k)
        tracker.track(frame)
        if k in args.frames:
            out_paths += dump_attention_maps(tracker, frame, os.path.join(args.out_dir, seq.name),
                                             frame_id=k)
    print(*out_paths, sep="\n")
    return out_paths


if __name__ == "__main__":
    main()
