"""Result-vs-ground-truth videos from saved result files: each tracker's
boxes and the ground truth drawn on the sequence's frames (the RGB ones,
or with --modality ir the TIR ones), an mp4 per sequence; the port's
counterpart of tracking/gen_video.py. The container is cv2's (ImportError
without it).

  python -m multi_modal_tracking_torch.tools.gen_video --dataset_name lasher --sequence car1 \\
      --results 'mine=output/tracking_results/asymmetric_shared_ce/baseline' \\
      --out_dir output/result_videos [--modality ir]
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def _load_result(res_dir: str, dataset_name: str, seq_name: str) -> np.ndarray:
    for cand in (os.path.join(res_dir, dataset_name, seq_name + ".txt"),
                 os.path.join(res_dir, seq_name + ".txt")):
        if os.path.isfile(cand):
            with open(cand) as f:
                delim = "\t" if "\t" in f.readline() else ","
            return np.loadtxt(cand, delimiter=delim).reshape(-1, 4)
    raise FileNotFoundError(f"no result for {seq_name} under {res_dir}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m multi_modal_tracking_torch.tools.gen_video")
    p.add_argument("--dataset_name", type=str, default="lasher")
    p.add_argument("--sequence", type=str, nargs="+", default=None,
                   help="sequence names (default: all in the dataset)")
    p.add_argument("--results", type=str, nargs="+", required=True,
                   help="name=result_dir pairs")
    p.add_argument("--out_dir", type=str, default="output/result_videos")
    p.add_argument("--modality", choices=["rgb", "ir"], default="rgb",
                   help="ir renders on the TIR frame (gen_video_uavtir)")
    p.add_argument("--fps", type=int, default=30)
    args = p.parse_args(argv)

    from multi_modal_tracking_torch.eval.datasets import get_dataset
    from multi_modal_tracking_torch.eval.visualize import render_result_video

    dataset = get_dataset(args.dataset_name)
    wanted = set(args.sequence) if args.sequence else None
    modality = 1 if args.modality == "ir" else 0
    written = []
    for seq in dataset:
        if wanted is not None and seq.name not in wanted:
            continue
        results = {}
        for spec in args.results:
            name, _, res_dir = spec.partition("=")
            try:
                results[name] = _load_result(res_dir, args.dataset_name, seq.name)
            except FileNotFoundError as e:
                print(f"skip {name} for {seq.name}: {e}")
        if not results:
            continue
        out = os.path.join(args.out_dir, f"{seq.name}_{args.modality}.mp4")
        written.append(render_result_video(seq, results, out, fps=args.fps, modality=modality))
        print(written[-1])
    return written


if __name__ == "__main__":
    main()
