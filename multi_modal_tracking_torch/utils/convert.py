"""Checkpoint formats -> the port's state dict.

Reference `.pth` files already carry the port's key names:
`load_torch_state_dict` unwraps and cleans them, `add_backbone_prefix`,
`expand_two_stream` and `expand_modality_lns` rewrite the keys of
warm-start files (bare MAE backbones, unimodal nets) as the JAX package's
`utils/checkpoint.py` and `utils/torch_convert.py` do.

The port's modules carry the reference's torch key names, so a flax
`{"params": ..., "batch_stats": ...}` tree of an RGB-T model maps onto them
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
  norm1 / norm (shared encoder LN)    -> norm1
  fusion_kernel (deformable conv)     -> fusion.weight
  fusion_offset (one deform group)    -> fusion.conv_offset
  tower_tl / conv1 / conv | bn        -> conv1_tl.0 | .1
  tower_tl / adjust3_1 / conv         -> adjust3_tl.1.0
  <adjust> / conv | gn (1x1 + GN)     -> <adjust>.0 | .1
  score_branch / proj_q_0 | norm2_1   -> score_branch.proj_q.0 | .norm2.1
  score_branch / score_head / layers_2 -> score_branch.score_head.layers.2
  stage{i} (CvT, at the top level)     -> backbone.stage{i}
  stage{i} / blocks_N / fc1 (CvT)      -> backbone.stage{i}.blocks.N.mlp.fc1
  conv_proj_q / conv | bn (CvT)        -> conv_proj_q.conv | .bn
  blocks1_N / mlp_fc1 (ConvMAE)        -> blocks1.N.mlp.fc1

A BatchNorm whose scale and bias live in batch_stats (CvT's frozen
ConvProj BN: scale, bias, mean, var) is a FrozenBatchNorm2d, without a
step counter.

Alpha-Refine (`feature_extractor` / `neck` / `refiner` at the top), a
bare ResNet (`conv1`, `layer1_0`, ... at the top) and a classic tracker's
combined tree (`backbone` / `classifier` / `bb_regressor`, `_classic_leaf`)
have their own renames
(`_refine_path`, the inverse of the JAX package's
utils/torch_convert.py:444-532 key maps):

  layer1_0 / down_conv | down_bn      -> layer1.0.downsample.0 | .1
  spatial_attention / phi | g         -> spatial_attention.phi.0 | .g.0
  spatial_attention / w_conv | w_bn   -> spatial_attention.W.0 | .W.1
  channel_attention / fc1 (Dense)     -> channel_attention.fc1 (1x1 conv,
                                         weight (out, in, 1, 1))
  TSE_layer5 / reduce0 | transform2   -> TSE.layer5.reduce.0 | .transform.2
  RRB1_layer4 / bblock1               -> RRB1.layer4.bblock.1
  CAB_layer3 / convreluconv0          -> CAB.layer3.convreluconv.0

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


def expand_two_stream(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Unimodal warm start of the two-stream model: every `backbone.*` key
    becomes a `backbone_v.*` and a `backbone_i.*` key (the JAX package's
    utils/torch_convert.py:75-87); position embeddings and mask tokens are
    dropped."""
    out = {}
    for k, v in sd.items():
        if "pos_embed" in k or "mask_token" in k:
            continue
        if k.startswith("backbone."):
            out["backbone_v." + k[len("backbone."):]] = v
            out["backbone_i." + k[len("backbone."):]] = v
        else:
            out[k] = v
    return out


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
    if path and re.fullmatch(r"stage\d+", path[0]):   # CvT's stages sit at the top level
        path = ("backbone",) + path
    out = []
    i = 0
    while i < len(path):
        s = path[i]
        m = re.fullmatch(r"(blocks[123]?|layers)_(\d+)", s)
        if m:
            out += (["encoder"] if m.group(1) == "layers" else []) + [m.group(1), m.group(2)]
        elif s in ("fc1", "fc2") and i and re.fullmatch(r"blocks_\d+", path[i - 1]):
            out += ["mlp", s]                       # CvT's MAMBlock holds fc1 and fc2
        elif s in ("mlp_fc1", "mlp_fc2"):           # ConvMAE's CBlock
            out += ["mlp", s[4:]]
        elif i and path[i - 1].startswith("conv_proj_"):  # CvT's ConvProj: conv and bn
            out.append(s)
        elif s in ("tower_tl", "tower_br"):
            i += 1
            stage = re.fullmatch(r"(adjust[34])_(\d)", path[i])
            out += ([f"{stage.group(1)}_{s[-2:]}", stage.group(2)] if stage
                    else [f"{path[i]}_{s[-2:]}"])
        elif s in ("norm1", "norm2") and i + 1 < len(path) and \
                path[i + 1] in ("norm_v", "norm_i", "norm"):
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
    if coll == "batch_stats" and name != "bias":
        return {"mean": "running_mean", "var": "running_var"}[name], arr
    return name, arr


def _deform_paths(path: Tuple[str, ...], arr: np.ndarray) -> Tuple[Tuple[str, ...], np.ndarray]:
    """The deform fusions' flax leaves under their reference names:
    `fusion_kernel` (HWIO) is the deformable conv's `fusion.weight`; the
    offset conv `fusion_offset` is RGBT_Fusion_2's own, or, in RGBT_Fusion_3
    (the only class with one deform group: 3 * 9 = 27 output channels), the
    pack's `fusion.conv_offset` (utils/torch_convert.py:328-333 maps both
    names onto it)."""
    if path[-1] == "fusion_kernel":
        return path[:-1] + ("fusion", "kernel"), arr
    if len(path) >= 2 and path[-2] == "fusion_offset" and arr.shape[-1] == 27:
        return path[:-2] + ("fusion", "conv_offset", path[-1]), arr
    return path, arr


def from_jax_variables(variables_np: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax variables of a model of any family (numpy leaves) -> the
    port's state_dict, loadable with `load_state_dict(..., strict=True)`
    (every BatchNorm also gets
    num_batches_tracked = 0; a frozen one has none)."""
    # a BN whose scale lives in batch_stats is frozen (CvT's ConvProj): no step counter
    frozen = {p[:-1] for p, _ in _flatten(variables_np.get("batch_stats", {})) if p[-1] == "scale"}
    sd: Dict[str, torch.Tensor] = {}
    for coll, path, key, arr in _port_leaves(variables_np):
        # a copy: the leaf may be a read-only array
        sd[key] = torch.from_numpy(np.array(arr, dtype=np.float32))
        if coll == "batch_stats" and path[-1] == "mean" and path[:-1] not in frozen:
            sd[key[:-len("running_mean")] + "num_batches_tracked"] = \
                torch.tensor(0, dtype=torch.long)
    return sd


def _is_refine_tree(variables_np: Dict[str, Any]) -> bool:
    """Whether a flax tree is an AlphaRefineNet's or a bare ResNet's."""
    top = variables_np.get("params", {})
    return "feature_extractor" in top or ("conv1" in top and "layer1_0" in top)


_REFINE_RENAMES = {"down_conv": "downsample.0", "down_bn": "downsample.1", "w_conv": "W.0",
                   "w_bn": "W.1"}


def _refine_path(path: Tuple[str, ...]) -> str:
    """An Alpha-Refine or ResNet module path under the reference's names."""
    out = []
    for i, s in enumerate(path):
        m = re.fullmatch(r"(layer\d)_(\d+)", s) or re.fullmatch(r"(TSE|RRB[12]|CAB)_(layer\d)", s) \
            or re.fullmatch(r"(reduce|transform|bblock|convreluconv)(\d)", s)
        if m:
            out += [m.group(1), m.group(2)]
        elif s in ("phi", "g") and i and path[i - 1] == "spatial_attention":
            out += [s, "0"]
        else:
            out.append(_REFINE_RENAMES.get(s, s))
    return ".".join(out)


def _is_classic_tree(variables_np: Dict[str, Any]) -> bool:
    """Whether a flax tree is a classic tracker's combined DiMPnet / ATOMnet
    tree ({"backbone", "classifier", "bb_regressor"} at the top, the JAX
    package's classic/common.py combine_nets)."""
    top = variables_np.get("params", {})
    return "bb_regressor" in top or "classifier" in top or (
        "backbone" in top and "layer1_0" in top["backbone"])


#: the learned optimizer's 1x1 predictors, flax (bins, 1) -> conv (1, bins, 1, 1)
_PREDICTORS = {"label_map_predictor": "label_map_predictor.weight",
               "spatial_weight_predictor": "spatial_weight_predictor.weight",
               "target_mask_predictor": "target_mask_predictor.0.weight"}


def _classic_leaf(coll: str, path: Tuple[str, ...], arr: np.ndarray) -> Tuple[str, np.ndarray]:
    """A classic tree's leaf under the reference's DiMPnet / ATOMnet key
    (the inverse of the JAX package's utils/torch_convert.py:579-685
    map_dimpnet_key): backbone -> feature_extractor (ResNet names);
    classifier / feature_extractor / seq{i} -> classifier.feature_extractor.{i};
    classifier / filter_optimizer's scalars as they are and its predictors
    as 1x1 conv weights; bb_regressor / <stage> / conv | bn ->
    bb_regressor.<stage>.0 | .1 (fc3_rt / fc4_rt keep linear and bn)."""
    top, rest = path[0], path[1:]
    if top == "backbone":
        name, arr = _leaf(coll, rest[-1], arr)
        return f"feature_extractor.{_refine_path(rest[:-1])}.{name}", arr
    if top == "classifier":
        if rest[0] == "filter_optimizer":
            if rest[1] in _PREDICTORS:
                return f"classifier.filter_optimizer.{_PREDICTORS[rest[1]]}", arr.T[:, :, None, None]
            return f"classifier.filter_optimizer.{rest[1]}", arr
        name, arr = _leaf(coll, rest[-1], arr)
        mods = [re.sub(r"^seq(\d+)$", r"\1", m) for m in rest[:-1]]
        return f"classifier.{_refine_path(tuple(mods))}.{name}", arr
    name, arr = _leaf(coll, rest[-1], arr)
    mods = ["0" if m == "conv" else "1" if m == "bn" and rest[0] not in ("fc3_rt", "fc4_rt")
            else m for m in rest[:-1]]
    return f"bb_regressor.{'.'.join(mods)}.{name}", arr


def _port_leaves(variables_np: Dict[str, Any]) -> Iterator[Tuple[str, tuple, str, np.ndarray]]:
    """(collection, flax path, the port's key, array in the port's layout)
    of every leaf of a flax variables tree."""
    refine = _is_refine_tree(variables_np)
    classic = not refine and _is_classic_tree(variables_np)
    for coll in ("params", "batch_stats"):
        for path, leaf in _flatten(variables_np.get(coll, {})):
            if classic:
                key, arr = _classic_leaf(coll, path, np.asarray(leaf))
                yield coll, path, key, arr
                continue
            if refine:
                name, arr = _leaf(coll, path[-1], np.asarray(leaf))
                if path[-2:-1] in (("fc1",), ("fc2",)) and arr.ndim == 2:
                    arr = arr[:, :, None, None]          # the SE's Dense is a 1x1 conv
                yield coll, path, f"{_refine_path(path[:-1])}.{name}", arr
                continue
            fpath, leaf = _deform_paths(path, np.asarray(leaf))
            name, arr = _leaf(coll, fpath[-1], leaf)
            mod = _module_path(fpath[:-1]) + (".1" if fpath[-1] in _FROZEN_BN else "")
            yield coll, path, f"{mod}.{name}" if mod else name, arr
