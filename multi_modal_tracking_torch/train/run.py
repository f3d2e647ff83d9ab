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

Several GPUs, one process each (`tracking/train.py:33-78` of the JAX
package):

    torchrun --nproc_per_node=N -m multi_modal_tracking_torch.train.run ...
    python -m multi_modal_tracking_torch.train.run ... \
        --coordinator HOST:PORT --num_processes N --process_id I

form the process group first (`parallel.distributed`; NCCL, or gloo with
--device cpu) and train data-parallel over it, each process on
`cuda:LOCAL_RANK` (or the process id modulo the visible cards). --fsdp
sets TRAIN.FSDP (sharded parameters and moments, sharded checkpoints; it
runs eager) and --remat TRAIN.REMAT. Rank 0 alone writes the config yaml
and prints the model line; the group is torn down at exit. Alone, with no
launcher, the command trains on one GPU (the JAX CLI's one process spans
every local chip instead).
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

import yaml

from multi_modal_tracking_torch.utils.device import DTYPES

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


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
    p.add_argument("--fsdp", action="store_true",
                   help="shard parameters and optimizer state over the processes "
                        "(sets TRAIN.FSDP; needs a process group)")
    p.add_argument("--remat", action="store_true",
                   help="recompute the backbone blocks in the backward (sets TRAIN.REMAT)")
    p.add_argument("--coordinator", type=str, default=None,
                   help="multi-process: rendezvous HOST:PORT (or a tcp:// or file:// "
                        "init method); torchrun's environment otherwise")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--dtype", type=str, default="bfloat16", choices=sorted(DTYPES),
                   help="compute dtype: bfloat16 (default, the JAX trainer's) or float32; "
                        "parameters and optimizer state are float32 either way")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None):
    args = parse_args(argv)
    from multi_modal_tracking_torch.parallel import distributed as D

    grouped = D.initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                                       device=args.device)
    try:
        return _train(args, D, grouped)
    finally:
        D.shutdown_distributed()


def _train(args: argparse.Namespace, D, grouped: bool):
    from multi_modal_tracking_torch.config import get_default_config
    from multi_modal_tracking_torch.train.trainer import Trainer

    device = str(D.local_device()) if grouped and args.device == "cuda" else args.device
    if grouped and D.is_main_process():
        print(f"distributed: {D.world_size()} processes, "
              f"rank 0 on {device}", flush=True)

    cfg = get_default_config(args.script)
    if args.config:
        cfg.update_from_file(os.path.join(_ROOT, "experiments", args.script,
                                          f"{args.config}.yaml"))
    if args.epochs:
        cfg.TRAIN.EPOCH = args.epochs
    if args.batch:
        cfg.TRAIN.BATCH_SIZE = args.batch
    if args.fsdp:
        cfg.TRAIN.FSDP = True
    if args.remat:
        cfg.TRAIN.REMAT = True
    if D.is_main_process():
        os.makedirs(args.save_dir, exist_ok=True)
        with open(os.path.join(args.save_dir, f"{args.script}_{args.config or 'default'}.yaml"),
                  "w") as f:
            yaml.safe_dump(cfg.to_dict(), f, sort_keys=False)

    trainer = Trainer(args.script, cfg, save_dir=args.save_dir, device=device,
                      seed=args.seed, dtype=DTYPES[args.dtype], graphs=not cfg.TRAIN.FSDP)
    n_trainable = sum(len(ps) for ps in trainer.optimizer.groups.values())
    if D.is_main_process():
        print(f"model: {trainer.net_name}, {n_trainable} trainable param tensors, "
              f"{trainer.steps_per_epoch} steps/epoch", flush=True)
    trainer.train(load_latest=args.resume, fail_safe=not args.no_fail_safe)
    return trainer


if __name__ == "__main__":
    main()
