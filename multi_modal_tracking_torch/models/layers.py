"""Building blocks shared by the port's models.

Conventions, as in the JAX package: images are NHWC at the public model
functions, token sequences (B, N, C); the backbone's LayerNorm eps is 1e-6.
Module attribute names give the reference's torch state-dict keys.

Random layers (`DropPath`, `Dropout`) draw their masks from an explicit
`torch.Generator` that the caller owns (`set_generator`), on the device of
the tensor, so a seeded generator gives the same masks run after run.
Under `remat` (TRAIN.REMAT) a block's masks are kept on a tape as it runs
forward and read back from it when the backward recomputes the block:
`torch.utils.checkpoint` restores only the default generators' states, and
a second draw from the explicit one would give other masks.

Synced BatchNorm. With a process group of more than one rank
(`set_sync_group`), `BatchNorm2d` in training normalises with the
statistics of the global batch, the JAX package's BN under GSPMD (its
parallel/mesh.py:7-9) and the reference's SyncBatchNorm: the per-channel
sums of x and the element count, then those of (x - mean)^2, are summed
over the ranks (var biased, as flax's; the running variance stays the
biased one), and the backward sums dy and dy * x_hat over the ranks the
same way, so the input gradients are those of the global batch's
statistics. Eval mode syncs nothing.

Compute dtype. A model's parameters and buffers are float32 (the master
weights of training) or bf16 (after `utils.checkpoint.cast_floating`, for
serving; buffers, i.e. BN statistics, stay float32). Its compute dtype is
set apart from them (`set_compute_dtype`; `models.build.build_model(...,
dtype=)` sets it): float32, or bf16, as the JAX package's flax modules
compute at dtype=bf16 with param_dtype=float32 (training) or with pre-cast
parameters (serving). None means "the parameters' dtype". The rounding
points are flax's:
  * `Linear` and `Conv2d` cast input, weight and bias to the compute dtype
    at every call (flax `promote_dtype`) and return it (PyTorch's bf16
    kernels accumulate in f32 and round once). Under autograd the gradient
    reaching a float32 parameter is the bf16 gradient converted back, and a
    weight used by several calls sums those conversions in f32, as JAX's
    transposed casts do. The patch embedding's float32 crops are cast by
    its `Conv2d`.
  * `LayerNorm` and `GroupNorm` compute their statistics and the
    normalisation in f32 and round the output to the input's dtype once,
    as flax's, which promote to f32: bf16 inputs with bf16 parameters take
    PyTorch's bf16 kernels (which do so), bf16 inputs with float32
    parameters go through f32 explicitly, so the f32 scale and bias are
    applied unrounded.
  * BatchNorm keeps its running statistics in f32 and normalises in f32,
    returning the input's dtype (`BatchNorm2d`: batch statistics of the
    f32 input in training; eval hands F.batch_norm f32 statistics and
    affine, its mixed-dtype form); FrozenBatchNorm2d forms scale and shift
    in f32 and applies them in the input's dtype, as the JAX package's
    frozen BN (models/layers.py:96-98).
  * Softmaxes that JAX takes in f32 (CE ranking, fusion attention weights,
    head soft-argmax) are `.float()` at their call sites, so the boxes and
    the loss are f32.
  * Dropout and drop path divide by the keep probability in the input's
    dtype, as the JAX package's `x / keep` on bf16 does
    (models/layers.py:63).
No `torch.autocast`: its lists of ops kept in f32 are not flax's.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, Optional

import torch
import torch.distributed as dist
from torch import nn


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, C) -> (B, H, N, C/H), contiguous."""
    B, N, C = x.shape
    return x.reshape(B, N, num_heads, C // num_heads).permute(0, 2, 1, 3).contiguous()


def _merge(x: torch.Tensor) -> torch.Tensor:
    """(B, H, N, D) -> (B, N, H*D)."""
    B, H, N, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B, N, H * D)


class Linear(nn.Linear):
    """nn.Linear that casts input, weight and bias to its compute dtype at
    every call (None: the weight's dtype); the state-dict keys are
    nn.Linear's."""
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        return nn.functional.linear(x.to(dt), self.weight.to(dt),
                                    None if self.bias is None else self.bias.to(dt))


class Conv2d(nn.Conv2d):
    """nn.Conv2d that casts input, weight and bias to its compute dtype at
    every call (None: the weight's dtype)."""
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  None if self.bias is None else self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm; an input whose dtype differs from the parameters'
    (bf16 activations, float32 parameters) is normalised in f32 with the
    f32 scale and bias and rounded to its dtype once."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        return nn.functional.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                                        self.bias.float(), self.eps).to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm with LayerNorm's rule for an input of another dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        return nn.functional.group_norm(x.float(), self.num_groups, self.weight.float(),
                                        self.bias.float(), self.eps).to(x.dtype)


def set_compute_dtype(model: nn.Module, dtype: Optional[torch.dtype]) -> nn.Module:
    """Make every `Linear` and `Conv2d` of `model` compute in `dtype` (None:
    in its parameters' dtype); the parameters keep their dtype."""
    for m in model.modules():
        if isinstance(m, (Linear, Conv2d)):
            m.compute_dtype = dtype
    return model


def compute_dtype(model: nn.Module) -> torch.dtype:
    """The dtype `model` computes in: that of its first `Linear` or
    `Conv2d` (float32 for a model that has neither)."""
    for m in model.modules():
        if isinstance(m, (Linear, Conv2d)):
            return m.compute_dtype or m.weight.dtype
    return torch.float32


class Mlp(nn.Module):
    """Transformer FFN: Linear -> exact GELU -> Linear."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features)
        self.fc2 = Linear(hidden_features, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(nn.functional.gelu(self.fc1(x)))


class PatchEmbed(nn.Module):
    """Conv patchify of an NHWC image: (B, H, W, 3) -> (B, H/p * W/p, C)."""

    def __init__(self, patch_size: int = 16, in_chans: int = 3, embed_dim: int = 768):
        super().__init__()
        self.proj = Conv2d(in_chans, embed_dim, kernel_size=patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(x.permute(0, 3, 1, 2))
        return x.flatten(2).transpose(1, 2)


class _RandomMask(nn.Module):
    """Base of the layers that zero part of their input in training mode and
    scale the rest by 1 / keep; the identity in eval mode or at rate 0."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None

    def _mask_shape(self, x: torch.Tensor):
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError(f"{type(self).__name__}(rate={self.rate}) in training mode "
                               f"needs a generator: call set_generator(model, g)")
        keep = 1.0 - self.rate
        u = _draw(self._mask_shape(x), self.generator, x.device)
        # keep in x's dtype, as JAX's weakly typed `x / keep` (a bf16 divisor);
        # filled on x's device: torch.tensor would copy from the host and
        # synchronise the stream, and a Python float divisor turns CUDA's
        # division into a product with its reciprocal
        scaled = x / torch.full((), keep, dtype=x.dtype, device=x.device)
        return torch.where(u < keep, scaled, torch.zeros((), dtype=x.dtype, device=x.device))


class DropPath(_RandomMask):
    """Per-sample stochastic depth: a whole sample (leading axis) is zeroed
    with probability `rate` (the JAX package's `DropPath`)."""

    def _mask_shape(self, x):
        return (x.shape[0],) + (1,) * (x.dim() - 1)


class Dropout(_RandomMask):
    """Element-wise dropout (flax `nn.Dropout`), with an explicit generator
    (`torch.nn.functional.dropout` takes none)."""

    def _mask_shape(self, x):
        return x.shape


#: the open remat tape: (the masks, the position read next, or None while
#: the masks are recorded)
_TAPE: List = []


def _draw(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Uniforms for a mask: drawn from `generator`, or read back from the
    open remat tape while a block is recomputed."""
    if _TAPE and _TAPE[-1][1] is not None:
        masks, pos = _TAPE[-1]
        _TAPE[-1][1] = pos + 1
        return masks[pos]
    u = torch.rand(shape, generator=generator, device=device)
    if _TAPE:
        _TAPE[-1][0].append(u)
    return u


@contextlib.contextmanager
def _taping(masks: list, replay: bool):
    _TAPE.append([masks, 0 if replay else None])
    try:
        yield
    finally:
        _TAPE.pop()


def remat(fn: Callable, *args):
    """`fn(*args)` under `torch.utils.checkpoint` (use_reentrant=False):
    its activations are recomputed in the backward instead of kept. The
    random masks drawn in `fn` are kept on a tape and the recomputation
    reads them back, so it replays the same masks (also inside a CUDA
    graph, where the tape's tensors are static); the default generators
    are not touched (preserve_rng_state=False: nothing in `fn` draws from
    them)."""
    from torch.utils.checkpoint import checkpoint
    masks: list = []
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (_taping(masks, False), _taping(masks, True)))


def set_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Give every DropPath / Dropout of `model` the generator its training-mode
    masks are drawn from (it must live on the model's device)."""
    for m in model.modules():
        if isinstance(m, _RandomMask):
            m.generator = generator


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with the JAX package's training semantics (flax
    `nn.BatchNorm`, momentum 0.9 = torch momentum 0.1, eps 1e-5): in training
    mode it normalises with the batch statistics and updates running_var with
    the BIASED batch variance, where torch's BatchNorm2d uses the unbiased
    one (8 values 0..7 from running_var 1: flax 1.425, torch 1.5). Eval mode
    is torch's; a bf16 input (with bf16 or float32 affine) is normalised in
    f32 with the f32 running statistics and returned in bf16. In training a
    bf16 input is normalised in f32 with its f32 batch statistics and the
    f32 affine, and rounded once (flax BatchNorm at dtype=bf16). With a
    `process_group` of more than one rank (`set_sync_group`), training
    uses the global batch's statistics (module docstring)."""
    process_group: Optional["dist.ProcessGroup"] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = self.process_group
        if self.training and group is not None and dist.get_world_size(group) > 1:
            y, mean, var = _SyncBatchNorm.apply(x.float(), self.weight, self.bias, self.eps,
                                                group)
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
                self.num_batches_tracked += 1
            return y.to(x.dtype)
        if not self.training and x.dtype != torch.float32:
            return nn.functional.batch_norm(x, self.running_mean, self.running_var,
                                            self.weight.float(), self.bias.float(), False, 0.0,
                                            self.eps)
        if not self.training:
            return super().forward(x)
        xf = x.float()
        y = nn.functional.batch_norm(xf, None, None, self.weight, self.bias, True, 0.0,
                                     self.eps).to(x.dtype)
        with torch.no_grad():
            var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        return y


def _channels(t: torch.Tensor) -> torch.Tensor:
    """(C,) -> (1, C, 1, 1)."""
    return t[None, :, None, None]


class _SyncBatchNorm(torch.autograd.Function):
    """BatchNorm over the global batch of a process group: f32 x (N, C, H,
    W) -> (y, batch mean, biased batch variance). Forward, two all-reduces:
    [sum x, count], then sum (x - mean)^2 (two passes: E[x^2] - E[x]^2
    loses the variance's digits in f32 where the mean is large against
    the spread); backward, one of [sum dy, sum dy * x_hat]. The weight and
    bias gradients are this rank's sums: the data-parallel gradient
    reduction averages them with every other gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        C = x.shape[1]
        count = torch.full((1,), x.numel() // C, dtype=torch.float32, device=x.device)
        stats = torch.cat([x.sum(dim=(0, 2, 3)), count])
        dist.all_reduce(stats, group=group)
        n = stats[C]
        mean = stats[:C] / n
        xc = x - _channels(mean)
        sq = xc.square().sum(dim=(0, 2, 3))
        dist.all_reduce(sq, group=group)
        var = sq / n
        invstd = torch.rsqrt(var + eps)
        xhat = xc * _channels(invstd)
        ctx.save_for_backward(xhat, weight, invstd, n)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return xhat * _channels(weight) + _channels(bias), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        xhat, weight, invstd, n = ctx.saved_tensors
        C = xhat.shape[1]
        gy = gy.float()
        local = torch.cat([gy.sum(dim=(0, 2, 3)), (gy * xhat).sum(dim=(0, 2, 3))])
        dbias, dweight = local[:C].clone(), local[C:].clone()
        dist.all_reduce(local, group=ctx.group)
        mean_dy, mean_dy_xhat = local[:C] / n, local[C:] / n
        gx = (gy - _channels(mean_dy) - xhat * _channels(mean_dy_xhat)) * \
            _channels(invstd * weight)
        return gx, dweight, dbias, None, None


def set_sync_group(model: nn.Module, group: Optional["dist.ProcessGroup"]) -> None:
    """Make every `BatchNorm2d` of `model` sync its training statistics over
    `group` (None: each process's own batch)."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.process_group = group


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with constant statistics and affine (the reference's
    FrozenBatchNorm2d, `HEAD_FREEZE_BN`): all four are buffers, so they take
    no gradient and no weight decay, and train mode changes nothing. The JAX
    package keeps them in `batch_stats` as bn_scale, bn_bias, bn_mean,
    bn_var (models/layers.py:86-98)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * inv
        return x * inv.to(x.dtype)[None, :, None, None] + shift.to(x.dtype)[None, :, None, None]


def ConvBNRelu(in_planes: int, out_planes: int, kernel_size: int = 3,
               frozen: bool = False) -> nn.Sequential:
    """Conv2d + BatchNorm + ReLU stage of the corner heads; the Sequential
    gives the reference's `.0` (conv) / `.1` (BN) key names. `frozen` makes
    the BN a FrozenBatchNorm2d."""
    bn = FrozenBatchNorm2d(out_planes) if frozen else BatchNorm2d(out_planes, eps=1e-5)
    return nn.Sequential(
        Conv2d(in_planes, out_planes, kernel_size=kernel_size, padding=kernel_size // 2,
               bias=True),
        bn,
        nn.ReLU(inplace=True))
