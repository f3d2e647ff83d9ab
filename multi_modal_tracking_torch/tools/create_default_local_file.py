"""Write the machine-local paths file (local_paths.json, or the file
MMT_LOCAL_PATHS names), which both training and evaluation read; the
port's counterpart of tracking/create_default_local_file.py.

  python -m multi_modal_tracking_torch.tools.create_default_local_file \\
      --workspace_dir . --data_dir ./data --save_dir ./output
"""
from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m multi_modal_tracking_torch.tools."
                                     "create_default_local_file")
    p.add_argument("--workspace_dir", type=str, default=".")
    p.add_argument("--data_dir", type=str, default="./data")
    p.add_argument("--save_dir", type=str, default="./output")
    args = p.parse_args(argv)
    from multi_modal_tracking_torch.train.admin import create_default_local_file
    path = create_default_local_file(args.workspace_dir, args.data_dir, args.save_dir)
    print(f"wrote {path} — edit dataset paths there")


if __name__ == "__main__":
    main()
