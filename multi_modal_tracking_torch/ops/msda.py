"""Multi-scale deformable attention sampling (MSDeformAttn core): kernel K3
and its plain version.

Shapes (L levels with static spatial shapes):
  value              : (B, S, M, D)        S = sum_l H_l * W_l
  spatial_shapes     : ((H_0, W_0), ...)
  sampling_locations : (B, Lq, M, L, P, 2) normalised to [0, 1], (x, y)
  attention_weights  : (B, Lq, M, L, P)
  returns            : (B, Lq, M * D)

Per (query, head, level, point) a bilinear sample at pixel coordinate
loc * size - 0.5 with zero padding outside the map — the numerics of
grid_sample(align_corners=False, padding_mode='zeros') — weighted by the
attention weights and summed.

`ms_deform_attn` runs the hand-written CUDA kernel (`csrc/msda.cu`) for CUDA
tensors and the plain PyTorch version `ms_deform_attn_ref` for CPU tensors,
and raises for anything else. There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from multi_modal_tracking_torch.ops import _build


def _bilinear_sample_level(value_l: torch.Tensor, loc: torch.Tensor, H: int,
                           W: int) -> torch.Tensor:
    """value_l (B, H*W, M, D), loc (B, Lq, M, P, 2) -> (B, Lq, M, P, D)."""
    B, _, M, D = value_l.shape
    Lq, P = loc.shape[1], loc.shape[3]
    x = loc[..., 0] * W - 0.5
    y = loc[..., 1] * H - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    v = value_l.permute(0, 2, 1, 3)                               # (B, M, HW, D)

    def tap(xi, yi, wgt):
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        flat = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)        # (B, Lq, M, P)
        idx = flat.permute(0, 2, 1, 3).reshape(B, M, Lq * P, 1).expand(-1, -1, -1, D)
        g = torch.gather(v, 2, idx).reshape(B, M, Lq, P, D).permute(0, 2, 1, 3, 4)
        return g * (wgt * inside.to(value_l.dtype))[..., None]

    out = tap(x0i, y0i, (1 - fx) * (1 - fy))
    out = out + tap(x0i + 1, y0i, fx * (1 - fy))
    out = out + tap(x0i, y0i + 1, (1 - fx) * fy)
    out = out + tap(x0i + 1, y0i + 1, fx * fy)
    return out


def ms_deform_attn_ref(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                       sampling_locations: torch.Tensor,
                       attention_weights: torch.Tensor) -> torch.Tensor:
    """Plain version: gather-based bilinear sampling per level, summed with
    the attention weights."""
    B, S, M, D = value.shape
    Lq = sampling_locations.shape[1]
    out = None
    start = 0
    for lid, (H, W) in enumerate(spatial_shapes):
        samp = _bilinear_sample_level(value[:, start:start + H * W],
                                      sampling_locations[:, :, :, lid], H, W)
        o = (samp * attention_weights[:, :, :, lid, :, None]).sum(dim=3)
        out = o if out is None else out + o
        start += H * W
    return out.reshape(B, Lq, M * D)


def _check_kernel_args(value, spatial_shapes, loc, attw):
    for name, t in (("value", value), ("sampling_locations", loc),
                    ("attention_weights", attw)):
        if t.device.type != "cuda":
            raise ValueError(f"ms_deform_attn: {name} is on {t.device}; all inputs "
                             f"must be CPU or all CUDA tensors")
        if t.dtype != torch.float32:
            raise TypeError(f"ms_deform_attn kernel takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"ms_deform_attn kernel takes contiguous {name}")
    if not value.device == loc.device == attw.device:
        raise ValueError(f"ms_deform_attn: inputs on {value.device}, {loc.device}, "
                         f"{attw.device}")
    if value.dim() != 4:
        raise ValueError(f"ms_deform_attn: value must be (B, S, M, D), is {tuple(value.shape)}")
    B, S, M, D = value.shape
    L = len(spatial_shapes)
    if loc.dim() != 6 or loc.shape[0] != B or loc.shape[2] != M or loc.shape[3] != L \
            or loc.shape[5] != 2:
        raise ValueError(f"ms_deform_attn: sampling_locations {tuple(loc.shape)} does not "
                         f"match value {tuple(value.shape)} with {L} levels")
    if tuple(attw.shape) != tuple(loc.shape[:5]):
        raise ValueError(f"ms_deform_attn: attention_weights {tuple(attw.shape)} != "
                         f"{tuple(loc.shape[:5])}")
    if sum(h * w for h, w in spatial_shapes) != S or not 1 <= L <= 8 or not 1 <= D <= 128:
        raise ValueError(f"ms_deform_attn kernel: levels {spatial_shapes} must cover "
                         f"S={S}, 1 <= L <= 8 and 1 <= D <= 128 (D={D})")


def ms_deform_attn(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """Multi-scale deformable attention core (see module docstring). CUDA
    tensors go to kernel K3 (each launch counted in
    `ms_deform_attn.launches`), CPU tensors to `ms_deform_attn_ref`."""
    tensors = (value, sampling_locations, attention_weights)
    if all(t.device.type == "cpu" for t in tensors):
        return ms_deform_attn_ref(value, spatial_shapes, sampling_locations,
                                  attention_weights)
    _check_kernel_args(value, spatial_shapes, sampling_locations, attention_weights)
    B, S, M, D = value.shape
    Lq, L, P = sampling_locations.shape[1], sampling_locations.shape[3], \
        sampling_locations.shape[4]
    out = torch.empty((B, Lq, M * D), dtype=value.dtype, device=value.device)
    shapes = (ctypes.c_int * (2 * L))(*[int(s) for hw in spatial_shapes for s in hw])
    lib = _build.library("msda")
    err = lib.msda_fwd_f32(value.data_ptr(), sampling_locations.data_ptr(),
                           attention_weights.data_ptr(), out.data_ptr(),
                           B, S, M, D, Lq, L, P, shapes,
                           torch.cuda.current_stream(value.device).cuda_stream)
    _build.check(err, "msda_fwd_f32")
    ms_deform_attn.launches += 1
    return out


ms_deform_attn.launches = 0
