"""Training command line of the port.

    python -m multi_modal_tracking_torch.train.run --script asymmetric_shared_ce \
        --config attention_lasher_newfusion_2layer --save_dir ./output [--resume]

The counterpart of the root `tracking/train.py`: loads the script's default
config and `experiments/<script>/<config>.yaml`, applies --epochs and
--batch, writes the effective config to
`<save_dir>/<script>_<config>.yaml`, then runs `Trainer.train` (fail-safe
unless --no_fail_safe; --resume starts from the latest checkpoint in
`<save_dir>/checkpoints/<script>/`). Runs on the GPU unless --device cpu,
in bf16 compute on float32 parameters unless --dtype float32.
--fsdp, --remat and the multi-process flags are not ported yet and raise
NotImplementedError (ROADMAP.md queue 1, item 12).
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

import yaml

from multi_modal_tracking_torch.utils.device import DTYPES

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_UNPORTED = ("fsdp", "remat", "coordinator", "num_processes", "process_id")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train a tracker (PyTorch port).")
    p.add_argument("--script", type=str, required=True,
                   help="model script name (e.g. asymmetric_shared_ce)")
    p.add_argument("--config", type=str, default=None,
                   help="experiment yaml under experiments/<script>/")
    p.add_argument("--save_dir", type=str, default="./output")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--epochs", type=int, default=None, help="override TRAIN.EPOCH")
    p.add_argument("--batch", type=int, default=None, help="override TRAIN.BATCH_SIZE")
    p.add_argument("--resume", action="store_true", help="resume from the latest checkpoint")
    p.add_argument("--no_fail_safe", action="store_true")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--dtype", type=str, default="bfloat16", choices=sorted(DTYPES),
                   help="compute dtype: bfloat16 (default, the JAX trainer's) or float32; "
                        "parameters and optimizer state are float32 either way")
    p.add_argument("--fsdp", action="store_true", default=None, help="not ported yet")
    p.add_argument("--remat", action="store_true", default=None, help="not ported yet")
    p.add_argument("--coordinator", type=str, default=None, help="not ported yet")
    p.add_argument("--num_processes", type=int, default=None, help="not ported yet")
    p.add_argument("--process_id", type=int, default=None, help="not ported yet")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None):
    args = parse_args(argv)
    given = [f"--{k}" for k in _UNPORTED if getattr(args, k) is not None]
    if given:
        raise NotImplementedError(f"{', '.join(given)}: FSDP, remat and multi-process "
                                  f"training are not ported to multi_modal_tracking_torch yet "
                                  f"(ROADMAP.md queue 1, item 12)")
    from multi_modal_tracking_torch.config import get_default_config
    from multi_modal_tracking_torch.train.trainer import Trainer

    cfg = get_default_config(args.script)
    if args.config:
        cfg.update_from_file(os.path.join(_ROOT, "experiments", args.script,
                                          f"{args.config}.yaml"))
    if args.epochs:
        cfg.TRAIN.EPOCH = args.epochs
    if args.batch:
        cfg.TRAIN.BATCH_SIZE = args.batch
    os.makedirs(args.save_dir, exist_ok=True)
    with open(os.path.join(args.save_dir, f"{args.script}_{args.config or 'default'}.yaml"),
              "w") as f:
        yaml.safe_dump(cfg.to_dict(), f, sort_keys=False)

    trainer = Trainer(args.script, cfg, save_dir=args.save_dir, device=args.device,
                      seed=args.seed, dtype=DTYPES[args.dtype])
    n_trainable = sum(len(g["params"]) for g in trainer.optimizer.opt.param_groups)
    print(f"model: {trainer.net_name}, {n_trainable} trainable param tensors, "
          f"{trainer.steps_per_epoch} steps/epoch", flush=True)
    trainer.train(load_latest=args.resume, fail_safe=not args.no_fail_safe)
    return trainer


if __name__ == "__main__":
    main()
