"""Analytic matmul+conv FLOP counting, the port's counterpart of the JAX
package's `utils/flops.py`.

The JAX walker sums 2*M*N*K over every `dot_general` and the equivalent
over every `conv_general_dilated` (with its groups) in the unoptimised
jaxpr of a function, recursing into scans, conds and custom VJPs, so a
train step's count holds its backward. Here `matmul_conv_flops(fn, *args)`
runs `fn` under a `TorchDispatchMode` that counts the products PyTorch
dispatches below autograd: `mm`, `addmm`, `bmm`, `baddbmm`, `mv`, `dot`,
`convolution` and `convolution_backward`, by the JAX walker's formulas
(a convolution's count is 2 * N * out pixels * C_out * C_in / groups *
kernel pixels of the convolution JAX runs: a strided convolution's input
gradient runs over the input's pixels, a grouped one's weight gradient
divides the batch by the groups as well as the input channels). Everything else (gathers, elementwise, reductions,
softmaxes) counts 0, as in JAX.

Run it on the plain path: CPU tensors, or the `meta` device, where every
op of the path has a meta kernel and nothing is computed (the kernels'
wrappers take their plain versions for meta tensors only while a count
runs, `plain_device`). The hand-written kernels (CUDA tensors) are
invisible to the mode, so counting CUDA tensors raises.

Where the port computes a function by other products than the JAX
package's, the function adds the JAX package's count itself and the mode
does not count its plain version (`kernel_region`):
  * mixed attention (`ops/attention.py mixed_attention`), which JAX runs
    as the two-call XLA lowering (template rows against the first n_mt
    keys, search rows against every key): 2 * 2 * B * H * D * (n_mt^2 +
    n_s * Nk) forward, twice that backward (each einsum's two operand
    gradients);
  * MSDA (`ops/msda.py ms_deform_attn`), which JAX runs on the CPU as the
    dense einsums of `_dense_sample_level` for levels of at most 4096
    pixels (the interpolation matrix, then its product with the values)
    and as a gather above: per dense level 2 * B * Lq * M * HW * (P + D)
    forward, and in the backward each einsum once per operand that takes
    a gradient;
  * CE's token selection and restore (`models/asymmetric_shared.py
    _ce_select`, `_recover`), which JAX writes as one-hot matmuls
    (`_select_rows`, `_scatter_rows`) and the port as a gather and a
    scatter: 2 * B * K * L * C forward, once more backward (only the
    tokens take a gradient) — `one_hot_rows`.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

#: the counter running now (one at a time; the CPU and meta backward runs
#: in the thread that called it)
_ACTIVE: Optional["_Counter"] = None


def _mm(args, out) -> float:
    a, b = args[0], args[1]
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]


def _addmm(args, out) -> float:
    return _mm(args[1:], out)


def _bmm(args, out) -> float:
    a, b = args[0], args[1]
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _baddbmm(args, out) -> float:
    return _bmm(args[1:], out)


def _mv(args, out) -> float:
    return 2.0 * args[0].shape[0] * args[0].shape[1]


def _addmv(args, out) -> float:
    return _mv(args[1:], out)


def _dot(args, out) -> float:
    return 2.0 * args[0].shape[0]


def conv_flops(n: int, c_in: int, c_out: int, groups: int, out_pixels: int,
               kernel_pixels: int) -> float:
    """The JAX walker's count of one convolution (utils/flops.py
    `_conv_flops`): 2 * N * out pixels * C_out * (C_in // groups) * kernel
    pixels."""
    return 2.0 * n * out_pixels * c_out * (c_in // groups) * kernel_pixels


def _convolution(args, out) -> float:
    x, w, groups = args[0], args[1], int(args[8])
    # a transposed convolution counts as JAX's input-dilated one: over the
    # output's pixels
    return conv_flops(x.shape[0], x.shape[1], out.shape[1], groups, math.prod(out.shape[2:]),
                      math.prod(w.shape[2:]))


def _convolution_backward(args, out) -> float:
    """The gradients JAX's transpose rules run: the input gradient a
    convolution over the input's pixels (C_out -> C_in), the weight
    gradient one whose 'batch' is C_in // groups, contracting N // groups
    batch rows over the output's pixels, with the kernel's pixels as
    output and C_out as features."""
    g, x, w = args[0], args[1], args[2]
    transposed, groups, mask = bool(args[7]), int(args[9]), args[10]
    if transposed:
        raise NotImplementedError("matmul_conv_flops: the backward of a transposed "
                                  "convolution is not counted")
    k = math.prod(w.shape[2:])
    n, c_in, c_out = x.shape[0], x.shape[1], w.shape[0]
    total = 0.0
    if mask[0]:
        total += conv_flops(n, c_out, c_in, groups, math.prod(x.shape[2:]), k)
    if mask[1]:
        total += 2.0 * (c_in // groups) * k * c_out * (n // groups) * math.prod(g.shape[2:])
    return total


_FORMULAS: Dict[object, Callable] = {
    aten.mm: _mm, aten.addmm: _addmm, aten.bmm: _bmm, aten.baddbmm: _baddbmm,
    aten.mv: _mv, aten.addmv: _addmv, aten.dot: _dot,
    aten.convolution: _convolution, aten._convolution: _convolution,
    aten.convolution_backward: _convolution_backward,
}


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.total = 0.0
        self.by_op: Dict[str, float] = {}
        self.suppress = 0

    def add(self, name: str, flops: float) -> None:
        self.total += flops
        self.by_op[name] = self.by_op.get(name, 0.0) + flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.suppress:
            return out
        formula = _FORMULAS.get(func.overloadpacket)
        if formula is not None:
            if any(isinstance(a, torch.Tensor) and a.device.type == "cuda" for a in args):
                raise RuntimeError("matmul_conv_flops counts the plain path: pass CPU or "
                                   "meta tensors (the CUDA kernels are invisible to it)")
            self.add(str(func.overloadpacket).split(".")[-1], formula(args, out))
        return out


def plain_device(tensors) -> bool:
    """Whether a kernel wrapper takes its plain version for `tensors`: all
    on the CPU, or all on the meta device while a count runs."""
    kind = "meta" if _ACTIVE is not None else "cpu"
    return all(t.device.type in ("cpu", kind) for t in tensors)


@contextlib.contextmanager
def kernel_region(name: str, flops: float):
    """Inside a count: add `flops` under `name` and count none of the
    products run inside (a kernel's plain version, whose products are not
    the JAX package's). Outside a count it does nothing."""
    c = _ACTIVE
    if c is None:
        yield
        return
    c.add(name, flops)
    c.suppress += 1
    try:
        yield
    finally:
        c.suppress -= 1


class _BackwardTerm(torch.autograd.Function):
    """Identity whose backward adds a count (a term that the JAX package's
    backward has where the port's has none of its products)."""

    @staticmethod
    def forward(ctx, x, name, flops):
        ctx.name, ctx.flops = name, flops
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if _ACTIVE is not None:
            _ACTIVE.add(ctx.name, ctx.flops)
        return g, None, None


def one_hot_rows(out: torch.Tensor, B: int, K: int, L: int, C: int) -> torch.Tensor:
    """Inside a count: add the JAX package's one-hot row product (B, K, L) x
    (B, L, C) that `out` stands for, 2 * B * K * L * C, and the same once
    more in the backward if `out` takes a gradient. Returns `out` (outside
    a count, untouched)."""
    if _ACTIVE is None:
        return out
    flops = 2.0 * B * K * L * C
    _ACTIVE.add("one_hot_rows", flops)
    if out.requires_grad and torch.is_grad_enabled():
        return _BackwardTerm.apply(out, "one_hot_rows_bwd", flops)
    return out


def matmul_conv_flops(fn, *args, by_op: Optional[dict] = None, **kwargs) -> float:
    """Total matmul+conv FLOPs of one call of `fn(*args, **kwargs)` on CPU or
    meta tensors (a train step's includes its backward, if `fn` runs it).
    `by_op`, a dict, receives the count by op name."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("matmul_conv_flops: a count is already running")
    counter = _Counter()
    _ACTIVE = counter
    try:
        with counter:
            fn(*args, **kwargs)
    finally:
        _ACTIVE = None
    if by_op is not None:
        by_op.update(counter.by_op)
    return counter.total
