"""Multi-process bootstrap, rank gating and per-rank seeds and batches.

The port's counterpart of the JAX package's `parallel/distributed.py`. One
process drives one GPU; `initialize_distributed` forms the process group
that joins them (the JAX package's `jax.distributed.initialize`):

  * explicit arguments win: `coordinator` ("host:port", or a `tcp://` or
    `file://` init method), `num_processes` and `process_id`;
  * otherwise torchrun's environment: `RANK`, `WORLD_SIZE`, `LOCAL_RANK`
    and `MASTER_ADDR` / `MASTER_PORT` (PyTorch's counterpart of the
    `JAX_*` variables);
  * nothing configured: a single-process run, nothing happens and it
    returns False.

The backend is NCCL for CUDA and gloo for the CPU. There is no
auto-detection here, so there is no fallback either: every failure to form
the group raises (the JAX function swallows a ValueError of its pod
auto-detection, which the port does not have).

Under a launcher a process's device is `cuda:LOCAL_RANK` (`local_device`).
The JAX package's `shard_host_batch` has no counterpart: each rank's
loader already yields its own `BATCH_SIZE // world` samples
(train/builders.py), and the data-parallel step (parallel/mesh.py)
reduces over the group.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

#: the torchrun variables that configure a group
_TORCHRUN = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
#: how long a collective or the rendezvous may wait for the other ranks
TIMEOUT = timedelta(minutes=10)


def _init_method(coordinator: str) -> str:
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda", backend: Optional[str] = None) -> bool:
    """Form the process group (module docstring); True if one was formed,
    False when nothing is configured. `device` picks the backend: NCCL for
    "cuda", gloo for "cpu"; `backend="gloo"` with "cuda" runs gloo's
    collectives on CUDA tensors (several processes on one card, which NCCL
    refuses). Under NCCL the process's current CUDA device becomes
    `local_device()` first. A partial configuration (a coordinator without
    a process count or id, or the reverse), a group that is already formed
    or a rendezvous that fails raises."""
    explicit = (coordinator, num_processes, process_id)
    if any(a is not None for a in explicit):
        if any(a is None for a in explicit):
            raise ValueError(f"initialize_distributed: coordinator, num_processes and "
                             f"process_id go together, got {explicit}")
        init, world, rank = _init_method(coordinator), int(num_processes), int(process_id)
    elif any(k in os.environ for k in _TORCHRUN):
        missing = [k for k in _TORCHRUN if k not in os.environ]
        if missing:
            raise ValueError(f"initialize_distributed: torchrun's environment lacks {missing}")
        init, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        return False
    if not 0 <= rank < world:
        raise ValueError(f"initialize_distributed: process id {rank} outside 0..{world - 1}")
    if dist.is_initialized():
        raise RuntimeError("initialize_distributed: a process group is already formed")
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"initialize_distributed: unsupported device {device!r}")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo") or (backend == "nccl" and dev.type != "cuda"):
        raise ValueError(f"initialize_distributed: backend {backend!r} on {device!r} "
                         f"(nccl on cuda, gloo on either)")
    dev_id = None
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed: NCCL needs a CUDA device; pass "
                               "device='cpu' for a gloo group on the CPU")
        # the step's collectives are captured in CUDA graphs: no watchdog
        # error handling on them (PyTorch's notes on capturing NCCL)
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
        dev_id = local_device(rank)
        torch.cuda.set_device(dev_id)
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=TIMEOUT, device_id=dev_id)
    return True


def shutdown_distributed() -> None:
    """Tear the process group down (nothing if none is formed)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    """Processes in the group, 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank, 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """The rank-0 gate of checkpoints, logs and prints."""
    return rank() == 0


def process_seed(base_seed: int) -> int:
    """This process's sampler seed: base_seed + rank."""
    return base_seed + rank()


def local_device(global_rank: Optional[int] = None) -> torch.device:
    """This process's GPU: `cuda:LOCAL_RANK` under torchrun, else the rank
    modulo the visible cards (one process per card on each host)."""
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    r = rank() if global_rank is None else global_rank
    return torch.device("cuda", r % max(1, torch.cuda.device_count()))

