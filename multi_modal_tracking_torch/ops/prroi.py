"""Precise RoI pooling (PrRoI) in closed form: the port's counterpart of
the JAX package's `ops/prroi.py`.

Each output bin is the exact integral average of the bilinearly
interpolated feature map over the bin's rectangle. The integral of a
bilinear surface separates into products of 1-D integrals of the unit hat,
so one RoI's pooling is two small products,

    out = (A_y @ feat @ A_x^T) / bin_area,

with A_y (ph, H) and A_x (pw, W) built from the hat's closed-form integral.
It is smooth in the RoI's coordinates, so autograd gives the coordinate
gradient too. The JAX package computes it in XLA, outside any Pallas
kernel; here it is plain PyTorch, batched over the RoIs (one set of
operations for all of them, none per RoI), in float32 with TF32 off
(`utils.device.set_precision`), as JAX's precision="highest".
"""
from __future__ import annotations

import torch


def _hat_cdf(u: torch.Tensor) -> torch.Tensor:
    """G(u) = integral from -inf to u of max(0, 1 - |t|) dt (total mass 1)."""
    u = torch.clamp(u, -1.0, 1.0)
    neg = 0.5 * (u + 1.0) ** 2
    pos = 0.5 + u - 0.5 * u ** 2
    return torch.where(u <= 0.0, neg, pos)


def _axis_matrix(extent: int, pooled: int, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(N, pooled, extent) per-bin hat integrals along one axis for N RoIs
    spanning [lo, hi] (N,): bin k spans [lo + k bw, lo + (k + 1) bw], bw =
    (hi - lo) / pooled; entry [n, k, p] is the integral over bin k of the
    unit hat centred at pixel p. Outside [0, extent - 1] the features are
    zero, as those hats have no column."""
    bw = (hi - lo) / pooled
    k = torch.arange(pooled, dtype=torch.float32, device=lo.device)
    a = lo[:, None] + k * bw[:, None]                   # (N, pooled)
    b = a + bw[:, None]
    p = torch.arange(extent, dtype=torch.float32, device=lo.device)
    return _hat_cdf(b[..., None] - p) - _hat_cdf(a[..., None] - p)


def prroi_pool(feat: torch.Tensor, rois: torch.Tensor, pooled_h: int, pooled_w: int,
               spatial_scale: float = 1.0) -> torch.Tensor:
    """Precise RoI pooling.

    feat: (B, H, W, C) feature maps (NHWC); rois: (N, 5) rows [batch index,
    x0, y0, x1, y1] in unscaled coordinates. Returns (N, pooled_h,
    pooled_w, C) float32; a RoI whose bins have no area gives zeros (the
    reference kernel's guard)."""
    B, H, W, C = feat.shape
    rois = rois.float()
    bidx = rois[:, 0].to(torch.long)
    x0, y0, x1, y1 = (rois[:, i] * spatial_scale for i in range(1, 5))
    ay = _axis_matrix(H, pooled_h, y0, y1)              # (N, ph, H)
    ax = _axis_matrix(W, pooled_w, x0, x1)              # (N, pw, W)
    f = feat.float().index_select(0, bidx)              # (N, H, W, C)
    tmp = torch.matmul(ay, f.reshape(-1, H, W * C)).reshape(-1, pooled_h, W, C)
    out = torch.matmul(ax[:, None], tmp)                # (N, ph, pw, C)
    bin_area = ((y1 - y0) / pooled_h) * ((x1 - x0) / pooled_w)
    area = bin_area[:, None, None, None]
    return torch.where(area > 0, out / torch.clamp(area, min=1e-12), torch.zeros_like(out))
