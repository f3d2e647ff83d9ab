"""Run a classic tracker (ECO, ATOM or DiMP) over an evaluation dataset:
the port's counterpart of the repository's `tracking/run_classic.py`, with
its flags plus --device.

    python -m multi_modal_tracking_torch.classic.run dimp --dataset_name otb \\
        --checkpoint DiMPnet_ep0050.pth.tar --params arch=resnet50

--params sets tracker fields (key=value; ints, floats and true/false are
converted). --checkpoint loads a reference DiMPnet / ATOMnet file through
the restricted unpickler (`utils.convert.load_torch_state_dict`) strictly;
ECO runs online and takes none. The classic trackers are RGB only: a
multimodal dataset is refused. Results go to <results_dir>/<seq>.txt, by
default <results_path>/<tracker>/<dataset>/ (`results_path` from
train.admin.env_settings, else output/tracking_results); a sequence whose
file exists is skipped unless --rerun. The tracker runs on the GPU unless
--device cpu.
"""
from __future__ import annotations

import argparse
import os

from multi_modal_tracking_torch.classic import TRACKERS, build_classic_tracker


def _coerce(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Run ECO/ATOM/DiMP on a dataset.")
    p.add_argument("tracker", choices=TRACKERS)
    p.add_argument("--dataset_name", type=str, default="otb")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="reference DiMPnet/ATOMnet checkpoint (.pth) to load (dimp/atom; "
                        "eco is fully online)")
    p.add_argument("--results_dir", type=str, default=None)
    p.add_argument("--sequence", type=str, default=None)
    p.add_argument("--rerun", action="store_true")
    p.add_argument("--params", nargs="*", default=[],
                   help="tracker field overrides, key=value")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None):
    p = _parser()
    args = p.parse_args(argv)
    from multi_modal_tracking_torch.eval.datasets import get_dataset
    from multi_modal_tracking_torch.eval.running import run_dataset
    from multi_modal_tracking_torch.train.admin import env_settings
    from multi_modal_tracking_torch.utils.device import resolve_device

    resolve_device(args.device)                  # no GPU: raise before reading anything
    kwargs = {}
    for kv in args.params:
        k, _, v = kv.partition("=")
        kwargs[k] = _coerce(v)
    dataset = get_dataset(args.dataset_name)
    # the RGB-T / RGB-D sets give [visible, infrared] pairs per frame, which
    # these trackers cannot take
    probe = dataset[0] if len(dataset) else None
    if probe is not None and getattr(probe, "multimodal", False):
        p.error(f"dataset '{args.dataset_name}' is multimodal; eco/atom/dimp are RGB-only: "
                f"pick an RGB dataset (otb, lasot, got10k_test, synthetic_rgb, ...)")
    if args.sequence:
        dataset = type(dataset)([dataset[args.sequence]])

    tracker = build_classic_tracker(args.tracker, device=args.device, **kwargs)
    if args.checkpoint:
        if not hasattr(tracker, "load_network"):
            p.error(f"--checkpoint not supported for '{args.tracker}'")
        from multi_modal_tracking_torch.utils.convert import load_torch_state_dict
        tracker.load_network(load_torch_state_dict(args.checkpoint))

    results_dir = args.results_dir or os.path.join(
        env_settings().results_path or "output/tracking_results", args.tracker,
        args.dataset_name)
    stats = run_dataset(dataset, tracker, results_dir, skip_if_done=not args.rerun)
    print(f"{args.tracker} on {args.dataset_name}: {len(stats)} sequences -> {results_dir}")
    return stats


if __name__ == "__main__":
    main()
