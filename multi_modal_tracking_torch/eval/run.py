"""Evaluation CLI of the port: run a script's tracker over a registered
dataset and write its result files, then print the success / precision
table. The flags are those of the root `tracking/test.py`, plus --device
and --dtype (bfloat16, the default as in the JAX package, or float32).
--type picks the unimodal trackers' input mode (RGB, TIR or Prompt; the
default RGB for a unimodal script, RGBT for an RGB-T one, which ignores
it): `--type TIR` on an RGB-T dataset tracks its TIR stream.

    python -m multi_modal_tracking_torch.eval.run asymmetric_shared_ce \\
        attention_lasher_newfusion_2layer --dataset_name synthetic_rgbt_hard \\
        --batch_sequences 12

Results go to <results_dir>/<dataset>/, by default
<results_path>/<script>/<config>[_epN]/<dataset>/ (`results_path` from
train.admin.env_settings, else output/tracking_results). --checkpoint_dir
sweeps the `*_ep*.pth.tar` epoch files there (epochs > 10 unless the script
is an online one), each into its own _epN directory. Without a checkpoint
the weights are random from seed 0. --vis_search writes
<results_dir>/<dataset>/vis_video/<seq>.mp4 per sequence (the search
regions; cv2 writes the container, ImportError without it).
"""
from __future__ import annotations

import argparse
import ast
import glob
import os
import re
import sys
from typing import List, Optional

import torch

from multi_modal_tracking_torch.eval.analysis import TrackerResults, print_results
from multi_modal_tracking_torch.eval.datasets import get_dataset
from multi_modal_tracking_torch.eval.evaltracker import create_tracker
from multi_modal_tracking_torch.eval.params import get_parameters
from multi_modal_tracking_torch.eval.running import _load_frame, run_dataset
from multi_modal_tracking_torch.models.build import is_rgbt_script
from multi_modal_tracking_torch.tracking import batched, tracker as single
from multi_modal_tracking_torch.tracking.batched import run_sequences_batched
from multi_modal_tracking_torch.train.admin import env_settings
from multi_modal_tracking_torch.utils.device import DTYPES


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Run the port's tracker on an eval dataset.")
    p.add_argument("script", type=str, help="model script name (e.g. asymmetric_shared_ce)")
    p.add_argument("config", type=str, nargs="?", default=None,
                   help="training yaml name under experiments/<script>/")
    p.add_argument("--tracking_yaml", type=str, default="auto",
                   help="tracking-time overlay under experiments/; 'auto' is "
                        "experiments/tracking.yaml for the RGB-T scripts and none for the "
                        "unimodal ones; '' for none")
    p.add_argument("--dataset_name", type=str, default="synthetic_rgbt")
    p.add_argument("--type", type=str, default=None,
                   choices=[None, "RGB", "TIR", "Prompt", "RGBT"],
                   help="input mode of a unimodal script (default RGB); RGB-T scripts "
                        "ignore it")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--model", type=str, default=None,
                   help="checkpoint file name under save_dir (train.admin.env_settings)")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="sweep every epoch checkpoint in this directory")
    p.add_argument("--results_dir", type=str, default=None)
    p.add_argument("--search_area_scale", type=float, default=None)
    p.add_argument("--chunk", type=int, default=16, help="frames per dispatch")
    p.add_argument("--threads", type=int, default=0,
                   help="worker threads, one tracker each; with --device cuda they are "
                        "spread over every visible card")
    p.add_argument("--batch_sequences", type=int, default=0,
                   help="track N same-size sequences in lockstep as one batch")
    p.add_argument("--sequence", type=str, default=None, help="run a single sequence")
    p.add_argument("--rerun", action="store_true", help="do not skip finished sequences")
    p.add_argument("--roi_margin", type=float, default=0.0,
                   help="upload only a window of margin x the search region per chunk "
                        "(result files byte-identical)")
    p.add_argument("--vis_search", action="store_true",
                   help="search-region videos under vis_video/ (cv2 writes them)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--dtype", type=str, default="bfloat16", choices=sorted(DTYPES),
                   help="compute dtype of the model: bfloat16 (default, the JAX package's "
                        "eval default) or float32; result files are float32 text either way")
    return p


def _split_params_argv(argv):
    """Pull `--params__<name> <value>` / `--params__<name>=<value>` out of
    argv before argparse runs, so a bare value is not taken for the
    optional positional. Returns (remaining argv, extracted tokens)."""
    rest, extras = [], []
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok.startswith("--params__"):
            extras.append(tok)
            if "=" not in tok and i + 1 < len(argv):
                i += 1
                extras.append(argv[i])
        else:
            rest.append(tok)
        i += 1
    return rest, extras


def _parse_params_overrides(parser, tokens) -> dict:
    """--params__<name> <value> pairs -> {name: value} set on the tracker
    parameters; values are Python literals where they parse, else strings."""
    out = {}
    i = 0
    while i < len(tokens):
        key, eq, val = tokens[i][len("--params__"):].partition("=")
        if not eq:
            i += 1
            if i >= len(tokens):
                parser.error(f"--params__{key} needs a value")
            val = tokens[i]
        try:
            out[key] = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            out[key] = val
        i += 1
    return out


def _epoch_of(path: Optional[str]) -> int:
    m = re.search(r"_ep(\d+)\.pth\.tar$", path or "")
    return int(m.group(1)) if m else -1


#: each tracker class and its lockstep twin (the JAX package's
#: tracking/test.py:113-121)
_TWINS = {single.RGBTTracker: batched.BatchedRGBTTracker,
          single.RGBTCachedTracker: batched.BatchedRGBTCachedTracker,
          single.RGBTOnlineTracker: batched.BatchedRGBTOnlineTracker,
          single.RGBTOnlineCachedTracker: batched.BatchedRGBTOnlineCachedTracker,
          single.RGBTracker: batched.BatchedRGBTracker,
          single.RGBCachedTracker: batched.BatchedRGBCachedTracker,
          single.OnlineTracker: batched.BatchedOnlineTracker}


def _batched_twin(tracker, chunk: int):
    """The lockstep twin of the CLI's tracker, on its model (graphed on
    CUDA as the tracker is), with its settings: the mode of a unimodal
    tracker, the online size and decay of an online one."""
    t = tracker
    kw = dict(template_factor=t.template_factor, template_size=t.template_size,
              search_factor=t.search_factor, search_size=t.search_size,
              update_interval=t.update_interval, scan_chunk=chunk, device=t.device,
              graphs=t.graphs is not None)
    if isinstance(t, single.RGBTracker):
        kw["mode"] = t.mode
    else:
        kw["ce_keep_rate"] = t.ce_keep_rate
    if getattr(t, "online", False):
        kw["max_score_decay"] = t.max_score_decay
    if isinstance(t, single.OnlineTracker):
        kw["online_size"] = t.online_size
    return _TWINS[type(t)](t.model, **kw)


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Returns the results directories written, one per checkpoint."""
    parser = _parser()
    rest, extras = _split_params_argv(sys.argv[1:] if argv is None else list(argv))
    args = parser.parse_args(rest)
    overrides = _parse_params_overrides(parser, extras)
    # the input mode reaches create_tracker for a unimodal script only
    modal = {} if is_rgbt_script(args.script) else {"mode": args.type or "RGB"}

    dataset = get_dataset(args.dataset_name)
    if args.sequence:
        dataset = type(dataset)([dataset[args.sequence]])
    checkpoints = [args.checkpoint]
    if args.checkpoint_dir:
        checkpoints = sorted(glob.glob(os.path.join(args.checkpoint_dir, "*_ep*.pth.tar")))
        if not args.script.endswith("online"):
            checkpoints = [c for c in checkpoints if _epoch_of(c) > 10]
    base_results = args.results_dir or os.path.join(
        env_settings().results_path or "output/tracking_results", args.script,
        args.config or "default")

    written = []
    for ckpt in checkpoints:
        suffix = f"_ep{_epoch_of(ckpt)}" if (args.checkpoint_dir and ckpt) else ""
        results_dir = os.path.join(base_results + suffix, args.dataset_name)
        params = get_parameters(args.script, args.config, args.tracking_yaml or None,
                                checkpoint=ckpt, model=args.model,
                                search_area_scale=args.search_area_scale)
        for k, v in overrides.items():
            setattr(params, k, v)

        def make(device=args.device):
            return create_tracker(params, dataset_name=args.dataset_name, device=device,
                                  dtype=DTYPES[args.dtype], **modal)
        if args.batch_sequences > 1:
            bt = _batched_twin(make(), args.chunk)
            groups = {}
            for seq in dataset:
                fr = _load_frame(seq, 0)            # RGB-T: [v, i]; unimodal: the array
                groups.setdefault((fr[0] if isinstance(fr, list) else fr).shape[:2],
                                  []).append(seq)
            for seqs in groups.values():
                for lo in range(0, len(seqs), args.batch_sequences):
                    run_sequences_batched(seqs[lo:lo + args.batch_sequences], bt, results_dir,
                                          chunk=args.chunk, skip_if_done=not args.rerun)
        else:
            # with threads every worker builds its own tracker, on its own card
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())] \
                if args.threads and args.device == "cuda" else None
            run_dataset(dataset, None if args.threads else make(), results_dir,
                        skip_if_done=not args.rerun, chunk=args.chunk, threads=args.threads,
                        tracker_factory=make if args.threads else None, devices=devices,
                        save_vis=args.vis_search, roi_margin=args.roi_margin)
        print(f"results -> {results_dir}")
        name = f"{args.script}/{args.config or 'default'}{suffix}"
        print_results([TrackerResults(results_dir, name)], dataset, report_name=args.dataset_name)
        written.append(results_dir)
    return written


if __name__ == "__main__":
    main()
