"""Checkpoints: epoch files for exact resume, and weight loads for warm
starts and evaluation.

The port's counterpart of the JAX package's `utils/checkpoint.py`. Epoch
files use the reference's own naming and format, `<Net>_ep%04d.pth.tar`
holding a dict with the network under "net" (so the JAX package's
`load_variables` reads them too); each is written to a `.tmp` file and moved
into place, and older ones are pruned (keep the last `keep_last` epochs and
every `keep_every`-th). `load_variables` puts a reference `.pth` /
`.pth.tar` / `.pt` file or a JAX `.msgpack` checkpoint onto a model: strict
for evaluation, partial (same-shape keys load, the rest keep their init)
for warm starts.

Sharded checkpoints (FSDP; the JAX package's orbax
`save_checkpoint_sharded` / `load_checkpoint_sharded`): a directory
`<Net>_ep%04d.dcp` written by `torch.distributed.checkpoint`, every rank
writing its own shards and nothing gathered on one rank. It loads back
into the same shardings (exact resume), into a process without a group
(the full tensors: a one-GPU Trainer), and into `load_variables`.
"""
from __future__ import annotations

import glob
import os
import re
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from multi_modal_tracking_torch.utils import flax_msgpack
from multi_modal_tracking_torch.utils.convert import (add_backbone_prefix, expand_modality_lns,
                                                      expand_two_stream, from_jax_variables,
                                                      is_ignored_key, load_torch_state_dict)

_EPOCH_RE = re.compile(r"_ep(\d+)\.(?:pth\.tar|dcp)$")


def _ckpt_path(directory: str, name: str, epoch: int) -> str:
    return os.path.join(directory, f"{name}_ep{epoch:04d}.pth.tar")


def checkpoint_epoch(path: str) -> int:
    """The epoch in a checkpoint's file name, -1 if it has none."""
    m = _EPOCH_RE.search(path)
    return int(m.group(1)) if m else -1


def save_checkpoint(directory: str, name: str, epoch: int, state: Dict[str, Any],
                    keep_last: int = 10, keep_every: int = 5) -> str:
    """Write `state` (tensors on the CPU) to `<name>_ep%04d.pth.tar` through
    a `.tmp` file and `os.replace`, then delete the epochs that are neither
    among the last `keep_last` nor a multiple of `keep_every`."""
    os.makedirs(directory, exist_ok=True)
    path = _ckpt_path(directory, name, epoch)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    for p in glob.glob(os.path.join(directory, f"{name}_ep*.pth.tar")):
        ep = checkpoint_epoch(p)
        if 0 <= ep <= epoch - keep_last and ep % keep_every != 0:
            try:
                os.remove(p)
            except OSError:
                pass
    return path


def latest_checkpoint(directory: str, name: str) -> Optional[str]:
    paths = [p for p in glob.glob(os.path.join(directory, f"{name}_ep*.pth.tar"))
             if checkpoint_epoch(p) >= 0]
    return max(paths, key=checkpoint_epoch) if paths else None


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The dict `save_checkpoint` wrote, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def save_checkpoint_sharded(directory: str, name: str, epoch: int,
                            state: Dict[str, Any], keep_last: int = 10,
                            keep_every: int = 5) -> str:
    """Write `state` (a dict of state dicts whose tensors may be DTensors)
    to the directory `<name>_ep%04d.dcp` with torch.distributed.checkpoint:
    every rank of the group calls it and writes its own shards. The files
    go to a `.tmp` directory that rank 0 moves into place once all have
    written; rank 0 then prunes as `save_checkpoint` does. Returns the
    path."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp
    path = os.path.join(directory, f"{name}_ep{epoch:04d}.dcp")
    tmp = path + ".tmp"
    main = not dist.is_initialized() or dist.get_rank() == 0
    if main:
        os.makedirs(directory, exist_ok=True)
        shutil.rmtree(tmp, ignore_errors=True)
    if dist.is_initialized():
        dist.barrier()
    dcp.save(state, checkpoint_id=tmp)
    if dist.is_initialized():
        dist.barrier()
    if main:
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        for p in glob.glob(os.path.join(directory, f"{name}_ep*.dcp")):
            ep = checkpoint_epoch(p)
            if 0 <= ep <= epoch - keep_last and ep % keep_every != 0:
                shutil.rmtree(p, ignore_errors=True)
    if dist.is_initialized():
        dist.barrier()
    return path


def latest_checkpoint_sharded(directory: str, name: str) -> Optional[str]:
    """The sharded checkpoint of the latest epoch in `directory`, or None."""
    paths = [p for p in glob.glob(os.path.join(directory, f"{name}_ep*.dcp"))
             if checkpoint_epoch(p) >= 0 and os.path.isdir(p)]
    return max(paths, key=checkpoint_epoch) if paths else None


def is_sharded_checkpoint(path: str) -> bool:
    return os.path.isdir(path) and os.path.isfile(os.path.join(path, ".metadata"))


def sharded_checkpoint_keys(path: str) -> Dict[str, tuple]:
    """Every tensor key of a sharded checkpoint and its global shape."""
    import torch.distributed.checkpoint as dcp
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    return {k: tuple(getattr(m, "size", ())) for k, m in meta.items()}


def load_checkpoint_sharded(path: str, state: Dict[str, Any],
                            no_dist: bool = False) -> Dict[str, Any]:
    """Fill `state` (the structure `save_checkpoint_sharded` wrote, or a
    part of it) from a sharded checkpoint, in place: DTensors take their
    own shards, plain tensors the whole tensor (in a process without a
    group, or with `no_dist`, which reads everything in this process);
    values that are not tensors are replaced in the dict. Returns
    `state`."""
    import torch.distributed.checkpoint as dcp
    dcp.load(state, checkpoint_id=path, no_dist=no_dist)
    return state


def load_variables(path: str, model: nn.Module, strict: bool = True) -> Dict[str, Any]:
    """Load a checkpoint's weights onto `model` in place; returns a report
    {"path", "loaded", "total", "missing", "unexpected"}.

    A sharded checkpoint's directory (`save_checkpoint_sharded`): its
    network, read whole in this process.
    `.pth` / `.pth.tar` / `.pt`: a reference or port file (`net`, `model`
    and `state_dict` envelopes); a bare backbone dict gets the `backbone.`
    prefix; a unimodal one (`backbone.*`, norm1/norm2) fills both backbones
    of a two-stream model (`backbone_v.*`, `backbone_i.*`), or gets the
    modal LayerNorm pair when the model has it. Any expansion is a warm
    start and makes the load non-strict. `.msgpack`: a JAX checkpoint, a TrainState (params and
    batch_stats; opt_state is ignored, also inside the trainer's `state`
    envelope) or a bare variables dict, mapped by `from_jax_variables`.

    strict=True raises ValueError if a key of the model is missing or
    mis-shaped, or the checkpoint has a key the model lacks (position
    embeddings, mask tokens and num_batches_tracked aside). strict=False
    loads the same-shape keys, leaves the rest at their init and prints one
    report line."""
    extra = []
    if is_sharded_checkpoint(path):               # Trainer(FSDP)'s "model" entry
        shapes = sharded_checkpoint_keys(path)
        target = model.state_dict()
        sd = {k: torch.empty(shapes[f"model.{k}"], dtype=t.dtype) for k, t in target.items()
              if shapes.get(f"model.{k}") is not None}
        load_checkpoint_sharded(path, {"model": sd}, no_dist=True)
        unexpected = [k[len("model."):] for k in shapes
                      if k.startswith("model.") and k[len("model."):] not in target]
        return _partial_load(model, sd, path, strict, unexpected)
    if path.endswith((".pth", ".pth.tar", ".pt")):
        sd, warm = add_backbone_prefix(load_torch_state_dict(path))
        target = model.state_dict()
        two_stream = any(k.startswith("backbone_v.") for k in target)
        target_modal = any(re.match(r"backbone\.blocks\.\d+\.norm1_v\.", k) for k in target)
        unimodal = any(k.startswith("backbone.") for k in sd)
        if two_stream and unimodal and not any(k.startswith("backbone_v.") for k in sd):
            sd, warm = expand_two_stream(sd), True
        elif target_modal and unimodal and not any(".norm1_v." in k for k in sd):
            sd, warm = expand_modality_lns(sd), True
        return _partial_load(model, sd, path, strict and not warm)
    with open(path, "rb") as f:
        tree = flax_msgpack.restore(f.read())
    for key in ("state", "net"):
        if isinstance(tree, dict) and key in tree and "params" not in tree:
            tree = tree[key]
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: not a flax variables tree")
    if "opt_state" not in tree:                # a bare variables dict
        extra = [k for k in tree if k not in ("params", "batch_stats")]
    variables = {c: _to_numpy(tree[c]) for c in ("params", "batch_stats") if tree.get(c)}
    return _partial_load(model, from_jax_variables(variables), path, strict, extra)


def _to_numpy(tree):
    """Writable numpy leaves; bfloat16 ones (torch tensors from the reader)
    become float32."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return np.array(tree)


def _partial_load(model: nn.Module, sd: Dict[str, torch.Tensor], label: str, strict: bool,
                  extra=()) -> Dict[str, Any]:
    target = model.state_dict()
    loaded, missing = {}, []
    for k, t in target.items():
        v = sd.get(k)
        if v is not None and tuple(v.shape) == tuple(t.shape):
            loaded[k] = v
        elif not is_ignored_key(k):
            missing.append(k)
    unexpected = [k for k in sd if k not in target and not is_ignored_key(k)] + list(extra)
    if missing or unexpected:
        msg = (f"restore of {label}: {len(loaded)}/{len(target)} tensors loaded; "
               f"missing/mis-shaped {missing[:4]}{'...' if len(missing) > 4 else ''}; "
               f"{len(unexpected)} checkpoint-only keys")
        if strict:
            raise ValueError("strict " + msg + " — the checkpoint does not match the model "
                             "(wrong script/config/stage?); pass strict=False only for "
                             "training warm starts")
        print("partial " + msg + " ignored", flush=True)
    with torch.no_grad():
        for k, v in loaded.items():
            target[k].copy_(v)
    return dict(path=label, loaded=len(loaded), total=len(target), missing=missing,
                unexpected=unexpected)


def cast_floating(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every floating parameter of `model` to `dtype` in place; buffers
    keep their dtype. The port's copy of the JAX package's `cast_floating`
    (utils/checkpoint.py:230), which casts the `params` collection only:
    the parameters here are that collection (Linear, conv, LayerNorm,
    GroupNorm and BatchNorm affine weights, the fusion's level embed), and
    the buffers hold `batch_stats` (BatchNorm and FrozenBatchNorm running
    statistics and the frozen affine), which stay float32, and the fixed
    position embeddings, which the model casts where it adds them. So
    `model.to(dtype)`, which casts buffers too, is not used. Returns
    `model`."""
    for p in model.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return model
