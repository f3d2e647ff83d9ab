"""JAX (flax) variables -> the port's state dict.

The port's modules carry the reference's torch key names, so a flax
`{"params": ..., "batch_stats": ...}` tree of the flagship maps onto them
with layout changes only:

  Dense kernel (in, out)      -> Linear weight (out, in)
  Conv kernel HWIO            -> Conv2d weight OIHW
  LayerNorm/GroupNorm/BN scale -> weight
  BN batch_stats mean/var     -> running_mean / running_var

and these path renames:

  blocks_N / layers_N                 -> blocks.N / encoder.layers.N
  norm1 / norm_v (modal LN pair)      -> norm1_v
  tower_tl / conv1 / conv | bn        -> conv1_tl.0 | .1
  tower_tl / adjust3_1 / conv         -> adjust3_tl.1.0
  <adjust> / conv | gn (1x1 + GN)     -> <adjust>.0 | .1

Input leaves are numpy arrays (or anything np.asarray accepts).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


def _flatten(tree, prefix=()) -> Iterator[Tuple[tuple, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    else:
        yield prefix, tree


def _module_path(path: Tuple[str, ...]) -> str:
    out = []
    i = 0
    while i < len(path):
        s = path[i]
        m = re.fullmatch(r"(blocks|layers)_(\d+)", s)
        if m:
            out += (["encoder"] if m.group(1) == "layers" else []) + [m.group(1), m.group(2)]
        elif s in ("tower_tl", "tower_br"):
            i += 1
            stage = re.fullmatch(r"(adjust[34])_(\d)", path[i])
            out += ([f"{stage.group(1)}_{s[-2:]}", stage.group(2)] if stage
                    else [f"{path[i]}_{s[-2:]}"])
        elif s in ("norm1", "norm2") and i + 1 < len(path) and path[i + 1] in ("norm_v", "norm_i"):
            i += 1
            out.append(s + path[i][4:])
        elif s == "conv":
            out.append("0")
        elif s in ("bn", "gn"):
            out.append("1")
        else:
            out.append(s)
        i += 1
    return ".".join(out)


def _leaf(coll: str, name: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    if name == "kernel":
        if arr.ndim == 4:
            return "weight", np.transpose(arr, (3, 2, 0, 1))
        return "weight", arr.T
    if name == "scale":
        return "weight", arr
    if coll == "batch_stats":
        return {"mean": "running_mean", "var": "running_var"}[name], arr
    return name, arr


def from_jax_variables(variables_np: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax variables of MixFormerRGBT (numpy leaves) -> the port's
    state_dict, loadable with `load_state_dict(..., strict=True)` (every
    BatchNorm also gets num_batches_tracked = 0)."""
    sd: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in _flatten(variables_np.get(coll, {})):
            name, arr = _leaf(coll, path[-1], np.asarray(leaf))
            mod = _module_path(path[:-1])
            key = f"{mod}.{name}" if mod else name
            sd[key] = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
            if name == "running_mean":
                sd[f"{mod}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd
