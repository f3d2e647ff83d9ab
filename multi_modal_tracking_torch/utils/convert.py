"""Checkpoint formats -> the port's state dict.

Reference `.pth` files already carry the port's key names:
`load_torch_state_dict` unwraps and cleans them, `add_backbone_prefix` and
`expand_modality_lns` rewrite the keys of warm-start files (bare MAE
backbones, unimodal nets) as the JAX package's `utils/checkpoint.py` and
`utils/torch_convert.py` do.

The port's modules carry the reference's torch key names, so a flax
`{"params": ..., "batch_stats": ...}` tree of the flagship maps onto them
with layout changes only:

  Dense kernel (in, out)      -> Linear weight (out, in)
  Conv kernel HWIO            -> Conv2d weight OIHW
  LayerNorm/GroupNorm/BN scale -> weight
  BN batch_stats mean/var     -> running_mean / running_var
  frozen BN batch_stats bn_scale / bn_bias / bn_mean / bn_var
                              -> FrozenBatchNorm2d (`.1`) weight / bias /
                                 running_mean / running_var

and these path renames:

  blocks_N / layers_N                 -> blocks.N / encoder.layers.N
  norm1 / norm_v (modal LN pair)      -> norm1_v
  tower_tl / conv1 / conv | bn        -> conv1_tl.0 | .1
  tower_tl / adjust3_1 / conv         -> adjust3_tl.1.0
  <adjust> / conv | gn (1x1 + GN)     -> <adjust>.0 | .1
  score_branch / proj_q_0 | norm2_1   -> score_branch.proj_q.0 | .norm2.1
  score_branch / score_head / layers_2 -> score_branch.score_head.layers.2

Input leaves are numpy arrays (or anything np.asarray accepts).
"""
from __future__ import annotations

import collections
import pickle
import re
import types
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


def is_ignored_key(key: str) -> bool:
    """Keys a load never counts as missing or unexpected: the fixed sin-cos
    position embeddings and MAE's mask token (reference checkpoints store
    them, the port recomputes or lacks them) and BatchNorm's step counter."""
    return "pos_embed" in key or "mask_token" in key or key.endswith("num_batches_tracked")


class _Inert:
    """What every global outside the allow-list unpickles to. Building,
    reducing, calling or filling one runs no code and gives an _Inert."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(_Inert)

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, *args, **kwargs):
        return _Inert()

    def __setstate__(self, state):
        pass

    def __setitem__(self, key, value):
        pass

    def append(self, item):
        pass

    def extend(self, items):
        pass


def _allowed_globals() -> Dict[str, Any]:
    """"module.name" -> object for the globals a checkpoint may use: torch's
    tensor and storage rebuilds and whatever else torch's weights-only
    unpickler allows, the safe globals registered with torch.serialization,
    OrderedDict, and numpy's array reconstruction."""
    from torch import _weights_only_unpickler
    allowed = dict(_weights_only_unpickler._get_allowed_globals())
    for obj in torch.serialization.get_safe_globals():
        obj = obj[0] if isinstance(obj, tuple) else obj
        allowed[f"{obj.__module__}.{obj.__qualname__}"] = obj
    allowed["collections.OrderedDict"] = collections.OrderedDict
    try:
        from numpy._core import multiarray
    except ImportError:                    # numpy < 2
        from numpy.core import multiarray
    for mod in ("numpy.core.multiarray", "numpy._core.multiarray"):
        allowed[f"{mod}._reconstruct"] = multiarray._reconstruct
        allowed[f"{mod}.scalar"] = multiarray.scalar
    allowed["numpy.ndarray"] = np.ndarray
    allowed["numpy.dtype"] = np.dtype
    return allowed


class _RestrictedUnpickler(pickle.Unpickler):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._allowed = _allowed_globals()

    def find_class(self, module: str, name: str):
        return self._allowed.get(f"{module}.{name}", _Inert)


#: `torch.load`'s pickle_module for reference files: the standard pickle
#: with every global outside `_allowed_globals` resolved to `_Inert`
_restricted_pickle = types.ModuleType("restricted_pickle")
_restricted_pickle.Unpickler = _RestrictedUnpickler
_restricted_pickle.load = lambda f, **kw: _RestrictedUnpickler(f, **kw).load()


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference checkpoint as {key: CPU tensor}: unwraps the `net`
    (trainer), `model` (MAE release) and `state_dict` envelopes, strips DDP's
    `module.` prefix and drops entries that are not tensors. A reference
    trainer file may pickle objects beside the weights (settings, stats);
    they unpickle as inert stubs (`_Inert`), so no pickled code runs and the
    tensors load as the JAX package's unrestricted load gives them."""
    obj = torch.load(path, map_location="cpu", weights_only=False,
                     pickle_module=_restricted_pickle)
    for key in ("net", "model", "state_dict"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
            break
    return {(k[len("module."):] if k.startswith("module.") else k): v.detach()
            for k, v in obj.items() if isinstance(v, torch.Tensor)}


def add_backbone_prefix(sd: Dict[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], bool]:
    """A bare backbone-pretrain dict (MAE ViT, ConvMAE, CvT: no `backbone.`
    or `box_head.` key, but `blocks.` / `patch_embed.` ones) gets the
    `backbone.` prefix; returns (dict, whether it was applied)."""
    if not any(k.startswith(("backbone", "box_head")) for k in sd) and \
            any(k.startswith(("blocks.", "blocks1.", "patch_embed.", "patch_embed1.", "stage0."))
                for k in sd):
        return {"backbone." + k: v for k, v in sd.items()}, True
    return sd, False


def expand_modality_lns(sd: Dict[str, Any]) -> Dict[str, Any]:
    """MAE / unimodal warm start: every block LayerNorm norm1/norm2 becomes
    the modal pair norm1_v/norm1_i (norm2 alike); position embeddings and
    mask tokens are dropped."""
    out = {}
    for k, v in sd.items():
        if "pos_embed" in k or "mask_token" in k:
            continue
        m = re.search(r"\.(norm[12])\.(weight|bias)$", k)
        if m and re.search(r"(^|\.)blocks\.", k):
            for suffix in ("_v", "_i"):
                out[k.replace(f".{m.group(1)}.", f".{m.group(1)}{suffix}.")] = v
        else:
            out[k] = v
    return out


def _flatten(tree, prefix=()) -> Iterator[Tuple[tuple, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    else:
        yield prefix, tree


def _score_path(path: Tuple[str, ...]) -> str:
    """The SPM's reference names: flax `proj_q_0`, `norm2_1` and
    `score_head/layers_2` are the ModuleList entries `proj_q.0`, `norm2.1`
    and `score_head.layers.2` (utils/torch_convert.py _map_score_key)."""
    return ".".join(re.sub(r"^(proj_q|proj_k|proj_v|proj|norm2|layers)_(\d+)$", r"\1.\2", s)
                    for s in path)


def _module_path(path: Tuple[str, ...]) -> str:
    if path[:1] == ("score_branch",):
        return _score_path(path)
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


_FROZEN_BN = {"bn_scale": "weight", "bn_bias": "bias", "bn_mean": "running_mean",
              "bn_var": "running_var"}


def _leaf(coll: str, name: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    if name in _FROZEN_BN:
        return _FROZEN_BN[name], arr
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
    BatchNorm also gets num_batches_tracked = 0; a frozen one has none)."""
    sd: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in _flatten(variables_np.get(coll, {})):
            name, arr = _leaf(coll, path[-1], np.asarray(leaf))
            mod = _module_path(path[:-1]) + (".1" if path[-1] in _FROZEN_BN else "")
            key = f"{mod}.{name}" if mod else name
            sd[key] = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
            if name == "running_mean" and path[-1] not in _FROZEN_BN:
                sd[f"{mod}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd
