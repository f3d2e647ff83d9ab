"""The trainer's AdamW update, fused: kernel `csrc/adamw.cu` for CUDA
tensors, `adamw_ref` (its plain version) for CPU tensors.

One update of every trainable parameter group at once, in place, in
optax's order with each operation rounded once (the kernel's comment has
the formula): the JAX package's `optax.adamw` (train/optimizer.py), which
XLA fuses into one program. Each group has its own -lr; the update count
enters only through the two bias corrections 1 - b1^count and
1 - b2^count. All of these are f32 device tensors that the caller fills
before the update, so that a CUDA graph holding the launch follows the
schedule. The kernel and the plain version give the same bits, on the card
and on the CPU.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from multi_modal_tracking_torch.ops import _build

#: AdamW's constants (optax.adamw's defaults, which the JAX package uses)
B1, B2, EPS = 0.9, 0.999, 1e-8
#: the f32 values the update multiplies and adds, as the kernel receives them
_F32 = {k: float(np.float32(v)) for k, v in
        dict(b1=B1, omb1=1.0 - B1, b2=B2, omb2=1.0 - B2, eps=EPS).items()}

#: (params, grads, mu, nu) of one parameter group
Group = Tuple[Sequence[torch.Tensor], Sequence[torch.Tensor], Sequence[torch.Tensor],
              Sequence[torch.Tensor]]
CHUNK = 1 << 16                 # elements per block of the kernel (csrc/adamw.cu kChunk)


def adamw_ref(params, grads, mu, nu, neg_lr: torch.Tensor, bc1: torch.Tensor,
              bc2: torch.Tensor, weight_decay: float) -> None:
    """The plain version, for one group: the kernel's formula as one
    PyTorch operation per step, each rounded once in f32. `neg_lr`, `bc1`
    and `bc2` are 0-d f32 tensors."""
    c = _F32
    torch._foreach_mul_(mu, c["b1"])
    torch._foreach_add_(mu, torch._foreach_mul(grads, c["omb1"]))
    t = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(t, c["omb2"])
    torch._foreach_mul_(nu, c["b2"])
    torch._foreach_add_(nu, t)
    del t
    # f32 sqrt correctly rounded, as the kernel's: torch's own on the CPU is
    # not under AVX-512; f64 has more than 2 x 24 + 2 bits, so its sqrt
    # rounded to f32 is
    den = [torch.sqrt(d.double()).float() for d in torch._foreach_div(nu, bc2)]
    torch._foreach_add_(den, c["eps"])
    u = torch._foreach_div(mu, bc1)
    torch._foreach_div_(u, den)
    del den
    if weight_decay:
        torch._foreach_add_(u, torch._foreach_mul(params, float(np.float32(weight_decay))))
    torch._foreach_mul_(u, neg_lr)
    torch._foreach_add_(params, u)


class AdamWTable:
    """The kernel's device tables of a fixed set of tensors: their
    addresses, sizes and groups, and the chunks (tensor, first element) its
    blocks take. Built once for an optimizer's static buffers; `matches`
    says whether it still describes a list of groups."""

    def __init__(self, groups: Sequence[Group]):
        per = [[], [], [], []]
        group_of, numel = [], []
        for gi, g in enumerate(groups):
            for i in range(4):
                per[i] += list(g[i])
            group_of += [gi] * len(g[0])
            numel += [t.numel() for t in g[0]]
        self.key = tuple(t.data_ptr() for ts in per for t in ts)
        dev = per[0][0].device
        chunks = [(ti, s) for ti, n in enumerate(numel) for s in range(0, n, CHUNK)]
        self.n_tensors, self.n_chunks = len(numel), len(chunks)
        self.n_elements = sum(numel)
        self.ptrs = torch.tensor(self.key, dtype=torch.int64, device=dev)
        self.numel = torch.tensor(numel, dtype=torch.int64, device=dev)
        self.group = torch.tensor(group_of, dtype=torch.int32, device=dev)
        self.chunk_tensor = torch.tensor([c[0] for c in chunks], dtype=torch.int32, device=dev)
        self.chunk_start = torch.tensor([c[1] for c in chunks], dtype=torch.int64, device=dev)

    def matches(self, groups: Sequence[Group]) -> bool:
        return self.key == tuple(t.data_ptr() for i in range(4) for g in groups for t in g[i])


def _check(groups: Sequence[Group], neg_lr: torch.Tensor, bc: torch.Tensor) -> None:
    dev = neg_lr.device
    for g in groups:
        if len({len(ts) for ts in g}) != 1:
            raise ValueError("adamw_fused: a group's params, grads, mu and nu differ in count")
        for ps in zip(*g):
            if any(t.device != dev or t.dtype != torch.float32 or not t.is_contiguous()
                   or t.shape != ps[0].shape for t in ps):
                raise ValueError("adamw_fused: every tensor must be contiguous f32 on "
                                 f"{dev} and a parameter's four tensors of one shape")
    if neg_lr.shape != (len(groups),) or bc.shape != (2,) or \
            {neg_lr.dtype, bc.dtype} != {torch.float32} or bc.device != dev:
        raise ValueError(f"adamw_fused: neg_lr must be ({len(groups)},) and bc (2,), "
                         f"f32 on {dev}")


def adamw_fused(groups: Sequence[Group], neg_lr: torch.Tensor, bc: torch.Tensor,
                weight_decay: float, table: Optional[AdamWTable] = None) -> Optional[AdamWTable]:
    """One AdamW update of every group, in place. `groups`: (params, grads,
    mu, nu) lists per group; `neg_lr` (groups,) f32, each group's -lr;
    `bc` (2,) f32, 1 - b1^count and 1 - b2^count at the update count after
    this update. CUDA tensors: one launch of the kernel (counted in
    `adamw_fused.launches`) over the tables of `table` if it still matches
    the groups, else of a new AdamWTable, after checking every tensor (its
    tables are uploaded from the host: build it outside a graph capture);
    returns the table used. CPU tensors: `adamw_ref` per group; returns
    None."""
    if neg_lr.device.type == "cpu" and all(t.device.type == "cpu" for g in groups
                                           for ts in g for t in ts):
        for gi, (ps, gs, ms, vs) in enumerate(groups):
            adamw_ref(ps, gs, ms, vs, neg_lr[gi], bc[0], bc[1], weight_decay)
        return None
    if table is None or not table.matches(groups):
        _check(groups, neg_lr, bc)
        table = AdamWTable(groups)
    c = _F32
    lib = _build.library("adamw")
    err = _build.launch(neg_lr.device, lib.adamw_f32,
        table.ptrs.data_ptr(), table.numel.data_ptr(), table.group.data_ptr(),
        table.chunk_tensor.data_ptr(), table.chunk_start.data_ptr(),
        table.n_tensors, table.n_chunks, neg_lr.data_ptr(), bc.data_ptr(),
        c["b1"], c["omb1"], c["b2"], c["omb2"], c["eps"],
        float(np.float32(weight_decay)),
        torch.cuda.current_stream(neg_lr.device).cuda_stream)
    _build.check(err, "adamw_f32")
    _build.count_launch(adamw_fused, neg_lr.device)
    return table


adamw_fused.launches = 0
