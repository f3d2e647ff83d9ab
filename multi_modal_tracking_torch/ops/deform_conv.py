"""Modulated deformable convolution v2 (the mmcv `ModulatedDeformConv2d`
of the RGBT_Fusion_2 / RGBT_Fusion_3 fusions), in plain PyTorch.

The JAX package computes it as an XLA gather and one matmul
(ops/deform_conv.py there), not as a Pallas kernel; so does this port:
per output position and kernel tap the input is sampled bilinearly at the
tap's position plus its learned offset, scaled by the learned modulation
mask, and all (tap, channel) pairs are contracted with the weight in one
matmul. The whole batch goes through one set of operations (no loop over
images), so a CUDA graph of a step holds a fixed handful of kernels, and
autograd gives the backward (gather -> scatter-add).

mmcv's border: a bilinear tap outside the map contributes zero, each of the
four corners checked on its own. Everything is computed in float32 from
inputs of any floating dtype and returned in the input's dtype, as the JAX
op does.

Layouts (NHWC, as in the JAX package): x (B, H, W, Cin); offset
(B, Ho, Wo, dg * kh * kw * 2) with the (dy, dx) pairs of each tap
interleaved, one deform group after the other; mask (B, Ho, Wo,
dg * kh * kw); weight (Cout, Cin, kh, kw), torch's layout. Deform group g
samples input channels [g * Cin / dg, (g + 1) * Cin / dg) with its own
offsets and mask.
"""
from __future__ import annotations

from typing import Optional

import torch


def _bilinear_zero_border(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                          H: int, W: int) -> torch.Tensor:
    """img: (B, H * W, C) float32; ys/xs: (B, N) sample rows and columns.
    Returns (B, N, C), the four corners summed in the JAX op's order with
    zeros for corners outside [0, H-1] x [0, W-1]."""
    B, _, C = img.shape
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy1, wx1 = ys - y0, xs - x0
    out = None
    for dy, wy in ((0, 1.0 - wy1), (1, wy1)):
        for dx, wx in ((0, 1.0 - wx1), (1, wx1)):
            yy, xx = y0 + dy, x0 + dx
            valid = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).long()
            v = torch.gather(img, 1, idx[..., None].expand(B, idx.shape[1], C))
            term = torch.where(valid[..., None], (wy * wx)[..., None] * v, 0.0)
            out = term if out is None else out + term
    return out


def modulated_deform_conv2d(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                            weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                            stride: int = 1, padding: int = 1,
                            deform_groups: int = 1) -> torch.Tensor:
    """DCNv2 forward (module docstring), differentiable in every tensor
    argument. Returns (B, Ho, Wo, Cout) in x's dtype."""
    B, H, W, Cin = x.shape
    Cout, _, kh, kw = weight.shape
    dg, K = deform_groups, kh * kw
    Ho = (H + 2 * padding - kh) // stride + 1
    Wo = (W + 2 * padding - kw) // stride + 1
    cg = Cin // dg
    dev = x.device
    # output position p, tap k -> p * stride - padding + k
    oy = torch.arange(Ho, dtype=torch.float32, device=dev) * stride - padding
    ox = torch.arange(Wo, dtype=torch.float32, device=dev) * stride - padding
    ky = torch.arange(kh, dtype=torch.float32, device=dev)
    kx = torch.arange(kw, dtype=torch.float32, device=dev)
    base_y = (oy[:, None, None, None] + ky[None, None, :, None]).expand(Ho, Wo, kh, kw)
    base_x = (ox[None, :, None, None] + kx[None, None, None, :]).expand(Ho, Wo, kh, kw)
    base_y, base_x = base_y.reshape(Ho, Wo, K), base_x.reshape(Ho, Wo, K)

    off = offset.float().reshape(B, Ho, Wo, dg, K, 2)
    m = mask.float().reshape(B, Ho, Wo, dg, K)
    img = x.float().reshape(B, H * W, Cin)
    cols = []
    for g in range(dg):
        ys = (base_y + off[..., g, :, 0]).reshape(B, Ho * Wo * K)
        xs = (base_x + off[..., g, :, 1]).reshape(B, Ho * Wo * K)
        s = _bilinear_zero_border(img[..., g * cg:(g + 1) * cg], ys, xs, H, W)
        cols.append(s * m[..., g, :].reshape(B, Ho * Wo * K, 1))
    # the groups are the channel slices in order: their concat restores the
    # input's channel order, and one product contracts every (tap, channel)
    sampled = torch.cat(cols, dim=-1).reshape(B * Ho * Wo, K * Cin)
    wmat = weight.float().permute(2, 3, 1, 0).reshape(K * Cin, Cout)
    out = torch.matmul(sampled, wmat).reshape(B, Ho, Wo, Cout)
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
