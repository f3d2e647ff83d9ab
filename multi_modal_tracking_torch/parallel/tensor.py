"""Tensor parallelism over the model group of a data x model group
(parallel/mesh.py `create_mesh_2d`): Megatron's operators written out with
explicit collectives.

The JAX package annotates the parameters with `param_shardings` and GSPMD
inserts the collectives (parallel/mesh.py:53-81 there). Here the
placement is the same rule (`tensor_parallel_dims`, on the flax names of
the converter's key map) and the collectives are four autograd Functions
over the model group:

  * `copy_to`: the identity forward, an all-reduce of the gradient
    backward (the input of a column-parallel layer: each rank's output
    columns give a part of its gradient);
  * `reduce_from`: an all-reduce forward, the identity backward (the
    output of a row-parallel layer: each rank's input columns give a part
    of the product);
  * `scatter_last`: this rank's slice of the last dimension forward, an
    all-gather of the gradient backward (a replicated activation entering
    a row-parallel layer);
  * `scatter_channels`: the same on dim 1 of an NCHW map (a replicated
    map entering a row-parallel convolution).

With NCCL the collectives run on the current stream and a CUDA graph
captures them, as the data-parallel reductions are captured. Sums are
taken in f32 whatever the compute dtype (a bf16 partial product is
rounded once, then summed in f32). Over a group of one rank every one of
them is the identity, and the layers compute exactly the plain `Linear`
and `Conv2d`.

`shard_tensor_parallel_` cuts a model of any script of `models/build.py
SCRIPTS` (the flagship and its online script, the RGB-T ViT family, the
unimodal ViT, CvT and ConvMAE families; any other model raises
NotImplementedError) in place:
  * attention with a `qkv` (the flagship's `AsymCrossModalAttention`,
    models/vit.py's `MixedAttention` of the ViT families and ConvMAE's
    third stage): `qkv` column-parallel, `proj` row-parallel. The qkv rows
    are split per head, each rank holding its heads' q, k and v rows,
    where the JAX rule cuts the kernel's last axis into contiguous pieces
    (at n_model 2 rank 0 would hold all of q and half of k, and GSPMD
    reshards the attention's operands silently). The attention then runs
    on the rank's heads (K1 / K2 on num_heads / n_model heads) with no
    collective inside; CE's ranking sums the attention over the model
    group before dividing by the total head count
    (models/asymmetric_shared.py). A model whose heads the group does not
    split, or whose qkv and proj the rule cuts unalike, raises ValueError;
  * CvT's MAM attention (no `qkv`: `proj_q`, `proj_k`, `proj_v` and the
    conv projections are no owners of the rule): the whole attention on
    every model rank, then `proj` row-parallel behind `scatter_last`;
  * MLPs: `fc1` column-, `fc2` row-parallel (ConvMAE's conv FFN,
    flax's `mlp_fc1` / `mlp_fc2`, stays whole);
  * fusion FFN: `linear1` column-, `linear2` row-parallel; `output_proj`
    row-parallel behind `scatter_last` (its input, MSDA's output, is
    replicated); `value_proj`, `sampling_offsets` and `attention_weights`
    stay replicated, so K3 / K4 run whole on every model rank;
  * patch-embedding convolutions named `proj` whose input channels the
    group divides: `RowParallelConv2d` behind `scatter_channels` (the
    ViT's 3 channels at n_model 3, CvT's later stages, ConvMAE's
    `patch_embed2` and `patch_embed3`);
  * the SPM score branch stays whole and reads the replicated outputs of
    the cut backbone and fusion;
  * BatchNorm syncs over the data group only (each sample counted once).
A row-parallel layer scatters its input unless the column-parallel
layer before it (its `qkv`, `fc1` or `linear1` sibling) is cut too.
Random masks: a mask on a replicated activation (drop path, the fusion's
`dropout1` and `dropout3`) must be the same on every rank of a model group;
one on the sharded FFN hidden (`dropout2`) must differ between them
(`set_tensor_parallel_generators`, Megatron's rule). No other family
draws a mask on a sharded activation: the ViT and CvT MLPs have no
dropout.

`shard_state_dict` / `gather_state_dict` carry a whole state dict (that
of `utils.convert.from_jax_variables`, say) to a rank's shards and back.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from multi_modal_tracking_torch.models.layers import (Conv2d, Linear, _RandomMask,
                                                      set_generator, set_sync_group,
                                                      skip_default_init)
from multi_modal_tracking_torch.parallel.mesh import (COLUMN_PARALLEL, DataParallel,
                                                      TensorParallel, tensor_parallel_dims)
from multi_modal_tracking_torch.utils.convert import flax_owner

#: each row-parallel owner and the column-parallel one before it: the row
#: layer's input is sharded where that sibling is cut, else replicated
_COLUMN_BEFORE = {"proj": "qkv", "fc2": "fc1", "linear2": "linear1"}


def _all_reduce_f32(t: torch.Tensor, group: DataParallel) -> torch.Tensor:
    """t summed over the group in f32, returned in f32 (a new tensor)."""
    out = t.float().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group.group)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, ctx.group).to(g.dtype), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


class _ScatterLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.chunk(group.world, dim=-1)[group.rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(_all_gather(g.float(), ctx.group), dim=-1).to(g.dtype), None


class _ScatterChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        fmt = torch.channels_last if x.is_contiguous(memory_format=torch.channels_last) \
            else torch.contiguous_format
        return x.chunk(group.world, dim=1)[group.rank].contiguous(memory_format=fmt)

    @staticmethod
    def backward(ctx, g):
        return torch.cat(_all_gather(g.float(), ctx.group), dim=1).to(g.dtype), None


def _all_gather(t: torch.Tensor, group: DataParallel) -> list:
    """Every rank's `t`, in rank order, on t's device; gloo gathers from
    the CPU, as chip_smoke.py's `_gathered` does (DTensor's gloo
    collectives on CUDA tensors ended the process there)."""
    part = (t.cpu() if group.backend == "gloo" else t).contiguous()
    parts = [torch.empty_like(part) for _ in range(group.world)]
    dist.all_gather(parts, part, group=group.group)
    return [p.to(t.device) for p in parts]


def copy_to(x: torch.Tensor, group: DataParallel) -> torch.Tensor:
    """Identity forward, the gradient all-reduced over `group` backward."""
    return x if group.world == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group: DataParallel) -> torch.Tensor:
    """x summed over `group` (in f32, returned in f32); identity backward."""
    return x if group.world == 1 else _ReduceFrom.apply(x, group)


def scatter_last(x: torch.Tensor, group: DataParallel) -> torch.Tensor:
    """This rank's slice of x's last dimension; the gradient all-gathered."""
    return x if group.world == 1 else _ScatterLast.apply(x, group)


def scatter_channels(x: torch.Tensor, group: DataParallel) -> torch.Tensor:
    """This rank's slice of the channels (dim 1) of an NCHW map, in its
    memory format; the gradient all-gathered on dim 1."""
    return x if group.world == 1 else _ScatterChannels.apply(x, group)


class ColumnParallelLinear(Linear):
    """`models.layers.Linear` holding this rank's rows of the weight (its
    output features) and of the bias; its replicated input's gradient is
    summed over the model group (`copy_to`). Casts at use, as Linear."""

    def __init__(self, in_features: int, out_features: int, bias: bool, group: DataParallel):
        with skip_default_init():
            super().__init__(in_features, out_features, bias=bias)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        return super().forward(copy_to(x.to(dt), self.group))


class RowParallelLinear(Linear):
    """`models.layers.Linear` holding this rank's columns of the weight
    (its input features); the partial products are summed over the model
    group in f32 (`reduce_from`), then the replicated bias is added and the
    sum rounded to the compute dtype once. With `scatter_input` the input
    is replicated and this rank takes its slice first (`scatter_last`).
    Over a group of one rank it is the plain Linear."""

    def __init__(self, in_features: int, out_features: int, bias: bool, group: DataParallel,
                 scatter_input: bool = False):
        with skip_default_init():
            super().__init__(in_features, out_features, bias=bias)
        self.group, self.scatter_input = group, scatter_input

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.group.world == 1:
            return super().forward(x)
        dt = self.compute_dtype or self.weight.dtype
        x = x.to(dt)
        if self.scatter_input:
            x = scatter_last(x, self.group)
        y = reduce_from(nn.functional.linear(x, self.weight.to(dt)), self.group)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(dt)


class RowParallelConv2d(Conv2d):
    """`models.layers.Conv2d` holding this rank's slice of the input
    channels (weight dim 1): it takes the same slice of its replicated NCHW
    input (`scatter_channels`) and convolves it at the same stride and
    padding; by linearity the ranks' parts sum to the whole convolution,
    which `reduce_from` takes over the model group in f32. The replicated
    bias is added once to the f32 sum, then the result is rounded to the
    compute dtype, as `RowParallelLinear` does. Over a group of one rank it
    is the plain Conv2d. `calls` counts its forwards over more than one
    rank."""

    calls = 0

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride, padding,
                 dilation, bias: bool, group: DataParallel):
        with skip_default_init():
            super().__init__(in_channels, out_channels, kernel_size, stride, padding,
                             dilation, bias=bias)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.group.world == 1:
            return super().forward(x)
        RowParallelConv2d.calls += 1
        dt = self.compute_dtype or self.weight.dtype
        x = scatter_channels(x.to(dt), self.group)
        y = reduce_from(self._conv_forward(x, self.weight.to(dt), None), self.group)
        if self.bias is not None:
            y = y + self.bias.float()[:, None, None]
        return y.to(dt)


def _is_qkv(key: str) -> bool:
    return key.rsplit(".", 2)[-2] == "qkv"


def _local_slice(t: torch.Tensor, key: str, dim: int, rank: int, n: int) -> torch.Tensor:
    if dim == 0 and _is_qkv(key):
        # per head: this rank's rows of q, of k and of v
        parts = t.reshape((3, t.shape[0] // 3) + tuple(t.shape[1:]))
        return parts.chunk(n, dim=1)[rank].reshape((-1,) + tuple(t.shape[1:]))
    return t.chunk(n, dim=dim)[rank]


def shard_state_dict(state: Dict[str, torch.Tensor], dims: Dict[str, int], rank: int,
                     n_model: int) -> Dict[str, torch.Tensor]:
    """A whole state dict -> model rank `rank`'s of `n_model`: each key of
    `dims` (`tensor_parallel_dims`) cut on its dimension, the qkv rows per
    head (module docstring); the rest as they are."""
    return {k: (_local_slice(v, k, dims[k], rank, n_model).clone() if k in dims else v)
            for k, v in state.items()}


def gather_state_dict(state: Dict[str, torch.Tensor], dims: Dict[str, int],
                      group: DataParallel) -> Dict[str, torch.Tensor]:
    """The inverse of `shard_state_dict` over the model group: every rank
    passes its shards (parameters, or gradients keyed by parameter name)
    and gets the whole tensors, on the CPU."""
    out = {}
    for k, v in state.items():
        v = v.detach()
        if k not in dims:
            out[k] = v.cpu().clone()
            continue
        parts = [p.cpu() for p in _all_gather(v, group)]
        if dims[k] == 0 and _is_qkv(k):
            rest = tuple(v.shape[1:])
            whole = torch.cat([p.reshape((3, -1) + rest) for p in parts], dim=1)
            out[k] = whole.reshape((-1,) + rest)
        else:
            out[k] = torch.cat(parts, dim=dims[k])
    return out


def _check_model(model: nn.Module) -> None:
    from multi_modal_tracking_torch.models.asymmetric_shared import MixFormerRGBT
    from multi_modal_tracking_torch.models.cvt import MixFormerCvT
    from multi_modal_tracking_torch.models.mixformer import MixFormer
    from multi_modal_tracking_torch.models.vit_rgbt import MixFormerViTRGBT
    if not isinstance(model, (MixFormerRGBT, MixFormerViTRGBT, MixFormer, MixFormerCvT)):
        raise NotImplementedError(f"tensor parallelism is ported for the models of "
                                  f"models/build.py SCRIPTS, not {type(model).__name__}")


def _swap(model: nn.Module, name: str, new: nn.Module) -> None:
    parent, _, attr = name.rpartition(".")
    setattr(model.get_submodule(parent) if parent else model, attr, new)


def _check_heads(model: nn.Module, dims: Dict[str, int], n: int) -> None:
    """Every attention with a `qkv` must have qkv and proj cut alike, and by
    whole heads, else ValueError."""
    for name, mod in model.named_modules():
        if not hasattr(mod, "qkv") or not hasattr(mod, "num_heads"):
            continue
        q, p = f"{name}.qkv.weight" in dims, f"{name}.proj.weight" in dims
        if q != p or (q and mod.num_heads % n):
            raise ValueError(f"{name}: {mod.num_heads} heads cannot be split over "
                             f"{n} model ranks (qkv sharded {q}, proj sharded {p})")


def _parallel_layer(name: str, mod: nn.Module, w: torch.Tensor, dims: Dict[str, int],
                    group: DataParallel) -> nn.Module:
    """The tensor-parallel layer that replaces `mod` (its weight cut to `w`)."""
    owner = flax_owner(f"{name}.weight")
    bias = mod.bias is not None
    if isinstance(mod, Conv2d):
        if owner in COLUMN_PARALLEL or mod.groups != 1:
            raise NotImplementedError(f"{name}: only a row-parallel convolution of one group "
                                      f"is ported")
        return RowParallelConv2d(w.shape[1], w.shape[0], mod.kernel_size, mod.stride,
                                 mod.padding, mod.dilation, bias, group)
    if owner in COLUMN_PARALLEL:
        return ColumnParallelLinear(w.shape[1], w.shape[0], bias, group)
    parent = name.rpartition(".")[0]
    before = _COLUMN_BEFORE.get(owner)
    sharded_input = before is not None and \
        f"{parent + '.' if parent else ''}{before}.weight" in dims
    return RowParallelLinear(w.shape[1], w.shape[0], bias, group,
                             scatter_input=not sharded_input)


@torch.no_grad()
def shard_tensor_parallel_(model: nn.Module, tp: TensorParallel) -> Dict[str, int]:
    """Cut `model` (whole, the same weights on every rank) in place into
    this rank's shards over `tp.model` (module docstring) and make its
    BatchNorm sync over `tp.data`; returns the sharded parameters' dims
    (also `model.tp_dims`; each sharded parameter carries its `tp_dim`).
    The model's attention layers must shard qkv and proj alike and by
    whole heads, else ValueError."""
    _check_model(model)
    n, mp = tp.n_model, tp.model
    dims = tensor_parallel_dims(model, n)
    _check_heads(model, dims, n)
    local = shard_state_dict({k: v for k, v in model.named_parameters()}, dims,
                             tp.model_rank, n)
    for name, mod in list(model.named_modules()):
        if not isinstance(mod, (Linear, Conv2d)) or f"{name}.weight" not in dims:
            continue
        w = local[f"{name}.weight"]
        new = _parallel_layer(name, mod, w, dims, mp)
        new.compute_dtype = mod.compute_dtype
        new.to(device=w.device)
        new.weight.copy_(w)
        if mod.bias is not None:
            new.bias.copy_(local[f"{name}.bias"])
        _swap(model, name, new)
    for name, mod in model.named_modules():
        if hasattr(mod, "set_model_group") and f"{name}.qkv.weight" in dims:
            mod.set_model_group(mp)
        if type(mod).__name__ == "DeformableEncoderLayer" and f"{name}.linear1.weight" in dims:
            mod.dropout2.tp_sharded = True
    for k, p in model.named_parameters():
        if k in dims:
            p.tp_dim = dims[k]
    set_sync_group(model, tp.data.group)
    model.tp_dims = dims
    return dims


def set_tensor_parallel_generators(model: nn.Module, replicated: Optional[torch.Generator],
                                   sharded: Optional[torch.Generator]) -> None:
    """The generators of a tensor-parallel model's random masks: masks on
    replicated activations draw from `replicated` (seed it alike on the
    ranks of a model group, by data rank), those on the sharded FFN hidden
    from `sharded` (seed it by data and model rank)."""
    set_generator(model, replicated)
    for m in model.modules():
        if isinstance(m, _RandomMask) and getattr(m, "tp_sharded", False):
            m.generator = sharded


def tensor_parallel_seeds(seed: int, tp: TensorParallel) -> tuple:
    """(replicated, sharded) generator seeds of this rank: seed + 1 +
    data_rank, as a data-parallel rank's; seed + 2718 + the global rank
    (Megatron's offset) for the sharded masks."""
    return seed + 1 + tp.data_rank, seed + 2718 + tp.data_rank * tp.n_model + tp.model_rank

