"""The data-parallel group of a training run: gradient and metric
reductions, the start-up broadcast, and FSDP's sharding rule; the data x
model group of tensor parallelism and its placement rule.

The port's counterpart of the JAX package's `parallel/mesh.py`. There, one
'data' mesh axis holds the batch and GSPMD inserts the reductions; here
one process drives one GPU and `DataParallel` makes them explicit:

  * `broadcast_state`: rank 0's parameters and buffers (BN statistics) go
    to every rank before training starts;
  * `reduce_grads_`: after the backward, the gradients are averaged over
    the ranks in one collective over the optimizer's flat gradient buffer
    (`train/optimizer.py RegimeAdamW.bind_grads`, every gradient a view of
    it), so the clip and AdamW see the global batch's gradient on every
    rank;
  * `all_reduce_mean_`: the step's metrics (and the val step's) averaged
    the same way;
  * `all_reduce_sum_`: the FSDP clip's squared norm of the shards.

With NCCL these run on the step's stream and are captured inside its CUDA
graphs (PyTorch's notes on capturing NCCL collectives: the communicator
exists before the first capture, since the first step of a graph key runs
eager). gloo's collectives are host calls, which a graph cannot hold:
`capturable` is False and the training step raises rather than run them
eager unasked.

FSDP (`fsdp_shard`, TRAIN.FSDP). The route is PyTorch's FSDP2
(`torch.distributed.fsdp.fully_shard`), one unit per transformer block and
one over the rest of the model, with the JAX package's `fsdp_shardings`
rule (parallel/mesh.py:84-117 there) as its placement: a float parameter
of at least `min_size` elements is sharded on its largest dimension that
the world size divides (the trailing one on a tie), anything else is
replicated. The replicated ones are FSDP2's ignored parameters: their
gradients go through `reduce_grads_` as under DP. A sharded parameter is
gathered before its unit runs, forward and backward, and its gradient
reduce-scattered after; the AdamW moments of a sharded parameter are
shards too (`RegimeAdamW`), and the fused AdamW kernel updates each rank's
shard. FSDP2 gathers and frees from the host at every step, hooks a graph
replay would skip, so FSDP runs eager (`graphs=False`).

Tensor parallelism (`create_mesh_2d`, `TensorParallel`): the world split
into data groups and model groups, as the JAX package's 2-D mesh;
`tensor_parallel_dims` is the JAX `param_shardings` rule (parallel/mesh.py
:53-81 there) on the flax names of any model of `models/build.py
SCRIPTS`, and parallel/tensor.py cuts the model by it.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Set

import torch
import torch.distributed as dist
from torch import nn

from multi_modal_tracking_torch.utils.convert import flax_owner


class DataParallel:
    """The reductions of a data-parallel run over `group` (default: the
    whole process group, which must be formed)."""

    def __init__(self, group: Optional[dist.ProcessGroup] = None):
        if not dist.is_initialized():
            raise RuntimeError("DataParallel: no process group; call "
                               "parallel.distributed.initialize_distributed first")
        self.group = group or dist.group.WORLD
        self.world = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.backend = dist.get_backend(self.group)

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can hold this group's collectives (NCCL)."""
        return self.backend == "nccl"

    def all_reduce_sum_(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def all_reduce_mean_(self, t: torch.Tensor) -> torch.Tensor:
        """`t` summed over the ranks, then divided by their count, in place."""
        self.all_reduce_sum_(t)
        if self.world > 1:
            t.div_(self.world)
        return t

    def reduce_grads_(self, optimizer) -> None:
        """Average the replicated gradients (the optimizer's flat buffer)
        over the ranks, in place."""
        flat = optimizer.flat_grads
        if flat is not None and flat.numel():
            self.all_reduce_mean_(flat)

    @torch.no_grad()
    def broadcast_state(self, model: nn.Module) -> None:
        """Rank 0's parameters and buffers to every rank, in place."""
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t.data, src=dist.get_global_rank(self.group, 0), group=self.group)

    def gather_objects(self, obj) -> list:
        """Every rank's `obj`, in rank order, on every rank."""
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def barrier(self) -> None:
        dist.barrier(group=self.group)


class TensorParallel:
    """The data x model group of a tensor-parallel run (`create_mesh_2d`):
    `data` and `model` are the reductions (`DataParallel`) over this
    rank's data group and model group; `n_data`, `n_model`, `data_rank`,
    `model_rank` place it in the grid."""

    def __init__(self, n_data: int, n_model: int, data: DataParallel, model: DataParallel):
        self.n_data, self.n_model = n_data, n_model
        self.data, self.model = data, model
        self.data_rank, self.model_rank = data.rank, model.rank

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can hold both groups' collectives (NCCL)."""
        return self.data.capturable and self.model.capturable

    @property
    def backend(self) -> str:
        return self.data.backend


def create_mesh_2d(n_data: int, n_model: int) -> TensorParallel:
    """Split the formed world into the data x model group (module
    docstring): rank = data_rank * n_model + model_rank. Every rank calls
    it, in the same order as its other groups. A world that is not n_data
    * n_model raises: unlike the JAX function, which falls back to the
    CPU's virtual devices, the port forms its groups from processes (gloo
    on the CPU)."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh_2d: no process group; call "
                           "parallel.distributed.initialize_distributed first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data < 1 or n_model < 1 or world != n_data * n_model:
        raise ValueError(f"create_mesh_2d: a {n_data} x {n_model} group needs "
                         f"{n_data * n_model} processes, the world has {world}")
    # every rank forms every group, in the same order (torch.distributed's rule)
    data_groups = [dist.new_group([d * n_model + m for d in range(n_data)])
                   for m in range(n_model)]
    model_groups = [dist.new_group([d * n_model + m for m in range(n_model)])
                    for d in range(n_data)]
    return TensorParallel(n_data, n_model, DataParallel(data_groups[rank % n_model]),
                          DataParallel(model_groups[rank // n_model]))


#: the JAX rule's owners: column-parallel (output dimension sharded) and
#: row-parallel (input dimension sharded) layers
COLUMN_PARALLEL = ("qkv", "fc1", "linear1")
ROW_PARALLEL = ("proj", "fc2", "linear2", "output_proj")


def tensor_parallel_dims(model: nn.Module, n_model: int) -> Dict[str, int]:
    """The JAX package's `param_shardings` rule on the port's parameters:
    {parameter name: the dimension sharded over the model group}; a
    parameter not named is replicated. The rule reads the flax module
    names (`utils.convert.flax_owner`, the converter's key map), not the
    port's: ConvMAE's conv FFN, the port's `mlp.fc1` / `mlp.fc2` of a
    `CBlock`, is flax's `mlp_fc1` / `mlp_fc2` and stays replicated, as
    the SPM's `proj.0` (flax `proj_0`) does. Column-parallel owners
    (`qkv`, `fc1`, `linear1`) shard their output dimension, weight and
    bias; row-parallel ones (`proj`, `fc2`, `linear2`, `output_proj`)
    their weight's input dimension, the bias replicated. A dimension that
    n_model does not divide stays replicated. A torch weight is the flax
    kernel's transpose, (out, in) for a Linear and (out, in, kh, kw) for a
    Conv2d, so the output dimension is 0 and the input one 1. Like the JAX
    rule, which reads a conv kernel's input channels (its axis -2), the
    patch embeddings' `proj` convs are row-parallel where n_model divides
    their input channels: the ViT's 3 at n_model 3; at the recipes'
    widths CvT's `stage1` and `stage2` (64 and 192) and ConvMAE's
    `patch_embed2` and `patch_embed3` (256 and 384)."""
    dims = {}
    for name, p in model.named_parameters():
        owner, leaf = flax_owner(name), name.rsplit(".", 1)[-1]
        if leaf == "weight" and p.dim() >= 2:
            if owner in COLUMN_PARALLEL and p.shape[0] % n_model == 0:
                dims[name] = 0
            elif owner in ROW_PARALLEL and p.shape[1] % n_model == 0:
                dims[name] = 1
        elif leaf == "bias" and owner in COLUMN_PARALLEL and p.shape[0] % n_model == 0:
            dims[name] = 0
    return dims


def shard_dim(shape: Iterable[int], world: int, min_size: int = 1024) -> Optional[int]:
    """The JAX package's `fsdp_shardings` rule for one float leaf: the
    dimension it is sharded on (its largest that `world` divides,
    preferring the trailing one), or None (replicated: fewer than
    `min_size` elements, a 0-d leaf, or no divisible dimension)."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    if not shape or n < min_size:
        return None
    for d in sorted(range(len(shape)), key=lambda d: (shape[d], d), reverse=True):
        if shape[d] % world == 0:
            return d
    return None


def _units(model: nn.Module):
    """FSDP2's units below the root: every module of a `blocks` list."""
    for name, m in model.named_modules():
        if isinstance(m, nn.ModuleList) and name.rsplit(".", 1)[-1] == "blocks":
            yield from m


def fsdp_shard(model: nn.Module, dp: DataParallel, min_size: int = 1024) -> Set[nn.Parameter]:
    """Shard `model` in place over `dp`'s ranks with FSDP2 and the JAX
    package's placement rule (module docstring); returns the replicated
    parameters (FSDP2's ignored ones). Call it after the warm starts and
    `broadcast_state`, and before building the optimizer."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    device = next(model.parameters()).device
    mesh = DeviceMesh.from_group(dp.group, device.type)
    dims = {p: shard_dim(p.shape, dp.world, min_size) if p.is_floating_point() else None
            for p in model.parameters()}
    replicated = {p for p, d in dims.items() if d is None}

    def placement(p):
        return Shard(dims[p])

    for unit in _units(model):
        fully_shard(unit, mesh=mesh, shard_placement_fn=placement,
                    ignored_params=replicated & set(unit.parameters()))
    fully_shard(model, mesh=mesh, shard_placement_fn=placement, ignored_params=replicated)
    return replicated


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of an FSDP-sharded tensor (a DTensor), or `t`."""
    to_local = getattr(t, "to_local", None)
    return to_local() if to_local is not None else t


def is_sharded(t: torch.Tensor) -> bool:
    return hasattr(t, "to_local")
