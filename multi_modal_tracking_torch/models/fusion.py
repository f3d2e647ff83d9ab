"""RGB-T deformable-attention fusion (`Attention_Fusion_Bimodal_LNSpecific`
and `_LNSpecific_2`).

A 2-level ("level" = modality) Deformable-DETR encoder over the two
flattened modal search maps: sine position encoding + a per-level embed,
per-pixel reference points, N x (bimodal MSDeformAttn -> LN -> FFN -> LN)
with modality-specific LayerNorms. Sampling offsets and attention weights
are predicted from the channel concat of both modal queries and shared by
both modalities. The sampling core is kernel K3 (`ops/msda.py`).

Module attribute names give the reference's state-dict keys, e.g.
`fusion_vi.fusion_attention.encoder.layers.0.self_attn.value_proj.weight`.
Each encoder layer has the reference's three dropouts (rate 0.1: after the
deformable attention, after the FFN's ReLU, after its second linear); they
act in training mode only and draw from the generator of `set_generator`.
Gradients flow through K3's backward, kernel K4. A model cast to bf16 runs
K3-bf16: bf16 values and attention weights, f32 sampling locations.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
from torch import nn

from multi_modal_tracking_torch.models.layers import Conv2d, Dropout, GroupNorm, LayerNorm, Linear
from multi_modal_tracking_torch.ops.msda import ms_deform_attn
from multi_modal_tracking_torch.ops.pos_embed import sine_position_encoding


def _msda_grid_bias(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Directional grid init of the sampling-offset bias."""
    thetas = np.arange(n_heads, dtype=np.float64) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid.reshape(n_heads, 1, 1, 2), (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1).astype(np.float32)


class MSDeformAttnBimodal(nn.Module):
    """Deformable attention over 2 levels = 2 modalities (`attn_type`
    'bimodal'): offsets/weights from the concat of both modal queries,
    shared across modalities."""

    def __init__(self, d_model: int = 256, n_levels: int = 2, n_heads: int = 8,
                 n_points: int = 4):
        super().__init__()
        self.d_model, self.n_levels, self.n_heads, self.n_points = \
            d_model, n_levels, n_heads, n_points
        self.sampling_offsets = Linear(2 * d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = Linear(2 * d_model, n_heads * n_levels * n_points)
        self.value_proj = Linear(d_model, d_model)
        self.output_proj = Linear(d_model, d_model)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's init: zero offset kernel + directional grid bias,
        zero attention weights, xavier-uniform value/output projections."""
        nn.init.zeros_(self.sampling_offsets.weight)
        self.sampling_offsets.bias.copy_(torch.from_numpy(
            _msda_grid_bias(self.n_heads, self.n_levels, self.n_points)))
        nn.init.zeros_(self.attention_weights.weight)
        nn.init.zeros_(self.attention_weights.bias)
        for lin in (self.value_proj, self.output_proj):
            nn.init.xavier_uniform_(lin.weight, generator=generator)
            nn.init.zeros_(lin.bias)

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                src: torch.Tensor, spatial_shapes: Tuple[Tuple[int, int], ...]) -> torch.Tensor:
        """query/src: (B, 2*HW, C); reference_points: (Lq, L, 2)."""
        B, Lq, C = query.shape
        M, L, P = self.n_heads, self.n_levels, self.n_points
        half = Lq // 2
        value = self.value_proj(src).reshape(B, Lq, M, C // M)
        q_bi = torch.cat([query[:, :half], query[:, half:]], dim=2)    # (B, Lq/2, 2C)
        off = self.sampling_offsets(q_bi).reshape(B, half, M, L, P, 2)
        off = torch.cat([off, off], dim=1)
        w = self.attention_weights(q_bi)
        w = torch.cat([w, w], dim=1).reshape(B, Lq, M, L * P)
        # f32 softmax, then the model's dtype; locations stay f32 (the JAX
        # layer's rounding points, models/fusion.py:115-125)
        w = torch.softmax(w.float(), dim=-1).to(value.dtype).reshape(B, Lq, M, L, P)
        normalizer = torch.tensor([[w_, h_] for h_, w_ in spatial_shapes],
                                  dtype=torch.float32, device=query.device)
        loc = reference_points[None, :, None, :, None, :] \
            + off / normalizer[None, None, None, :, None, :]
        out = ms_deform_attn(value.contiguous(), spatial_shapes, loc.contiguous(),
                             w.contiguous())
        return self.output_proj(out)


def _modal_layer_norm(x: torch.Tensor, norm_v: LayerNorm, norm_i: LayerNorm) -> torch.Tensor:
    """LN per modality half of a (B, 2*HW, C) sequence (eps 1e-5, the torch
    default the reference's encoder uses, unlike the backbone's 1e-6)."""
    half = x.shape[1] // 2
    return torch.cat([norm_v(x[:, :half]), norm_i(x[:, half:])], dim=1)


class DeformableEncoderLayer(nn.Module):
    def __init__(self, d_model: int, d_ffn: int, n_levels: int = 2, n_heads: int = 8,
                 n_points: int = 4, dropout: float = 0.1):
        super().__init__()
        self.dropout1, self.dropout2, self.dropout3 = (Dropout(dropout) for _ in range(3))
        self.self_attn = MSDeformAttnBimodal(d_model, n_levels, n_heads, n_points)
        self.norm1_v = LayerNorm(d_model, eps=1e-5)
        self.norm1_i = LayerNorm(d_model, eps=1e-5)
        self.linear1 = Linear(d_model, d_ffn)
        self.linear2 = Linear(d_ffn, d_model)
        self.norm2_v = LayerNorm(d_model, eps=1e-5)
        self.norm2_i = LayerNorm(d_model, eps=1e-5)

    def forward(self, src, pos, reference_points, spatial_shapes):
        src2 = self.dropout1(self.self_attn(src + pos, reference_points, src, spatial_shapes))
        src = _modal_layer_norm(src + src2, self.norm1_v, self.norm1_i)
        ff = self.dropout3(self.linear2(self.dropout2(torch.relu(self.linear1(src)))))
        return _modal_layer_norm(src + ff, self.norm2_v, self.norm2_i)


class _Encoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class DeformableAttentionFusion(nn.Module):
    """N-layer deformable encoder over the two flattened modal search maps."""

    def __init__(self, d_model: int = 512, n_heads: int = 8, num_encoder_layers: int = 6,
                 n_points: int = 4, dropout: float = 0.1):
        super().__init__()
        self.d_model = d_model
        self.level_embed = nn.Parameter(torch.zeros(2, d_model))
        self.encoder = _Encoder([DeformableEncoderLayer(d_model, 4 * d_model, 2, n_heads,
                                                        n_points, dropout)
                                 for _ in range(num_encoder_layers)])
        self._geometry = {}

    def _pos_and_ref(self, H: int, W: int, device):
        """Sine position encoding (HW, C) and reference points (2HW, 2, 2),
        computed once per map size and device."""
        key = (H, W, str(device))
        if key not in self._geometry:
            pos1 = torch.from_numpy(sine_position_encoding(H, W, self.d_model // 2))
            ys, xs = np.meshgrid(np.linspace(0.5, H - 0.5, H) / H,
                                 np.linspace(0.5, W - 0.5, W) / W, indexing="ij")
            ref1 = np.stack([xs.reshape(-1), ys.reshape(-1)], -1)
            ref = np.tile(np.concatenate([ref1, ref1], 0)[:, None, :], (1, 2, 1))
            self._geometry[key] = (pos1.to(device),
                                   torch.from_numpy(ref.astype(np.float32)).to(device))
        return self._geometry[key]

    def forward(self, src_v: torch.Tensor, src_i: torch.Tensor) -> torch.Tensor:
        """src_v/src_i: (B, H, W, d_model) -> (B, 2*H*W, d_model)."""
        B, H, W, C = src_v.shape
        spatial_shapes = ((H, W), (H, W))
        src = torch.cat([src_v.reshape(B, H * W, C), src_i.reshape(B, H * W, C)], dim=1)
        pos1, ref = self._pos_and_ref(H, W, src.device)
        pos = torch.cat([pos1 + self.level_embed[0], pos1 + self.level_embed[1]],
                        dim=0)[None].to(src.dtype)
        for layer in self.encoder.layers:
            src = layer(src, pos, ref, spatial_shapes)
        return src


def _AdjustConv(in_channels: int, out_channels: int) -> nn.Sequential:
    """1x1 conv + GroupNorm(32, eps 1e-5) channel adjust (`.0` / `.1` keys)."""
    return nn.Sequential(Conv2d(in_channels, out_channels, kernel_size=1),
                         GroupNorm(32, out_channels, eps=1e-5))


def _adjust(mod: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """Apply an _AdjustConv to an NHWC map."""
    return mod(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class AttentionFusionBimodal(nn.Module):
    """mode 'cat': separate in-adjusts, concat modal outputs -> out adjust
    (`Attention_Fusion_Bimodal_LNSpecific`, the shipped recipe);
    mode 'shared_sum': shared in-adjust, sum of modal outputs, shared out
    adjust (`Attention_Fusion_Bimodal_LNSpecific_2`)."""

    def __init__(self, channels: int = 768, d_model: int = 512, num_encoder_layers: int = 6,
                 mode: str = "cat", dropout: float = 0.1):
        super().__init__()
        if mode not in ("cat", "shared_sum"):
            raise ValueError(f"mode {mode!r}")
        self.mode = mode
        if mode == "shared_sum":
            self.adjust_in = _AdjustConv(channels, d_model)
        else:
            self.adjust_v = _AdjustConv(channels, d_model)
            self.adjust_i = _AdjustConv(channels, d_model)
        self.fusion_attention = DeformableAttentionFusion(d_model, 8, num_encoder_layers,
                                                          dropout=dropout)
        if mode == "cat":
            self.adjust_cat = _AdjustConv(2 * d_model, channels)
        else:
            self.adjust_out = _AdjustConv(d_model, channels)

    def forward(self, x_v: torch.Tensor, x_i: torch.Tensor) -> torch.Tensor:
        """(B, H, W, channels) x2 -> (B, H, W, channels) fused map."""
        B, H, W, _ = x_v.shape
        if self.mode == "shared_sum":
            v, i = _adjust(self.adjust_in, x_v), _adjust(self.adjust_in, x_i)
        else:
            v, i = _adjust(self.adjust_v, x_v), _adjust(self.adjust_i, x_i)
        out = self.fusion_attention(v, i)
        d = out.shape[-1]
        out_v = out[:, :H * W].reshape(B, H, W, d)
        out_i = out[:, H * W:].reshape(B, H, W, d)
        if self.mode == "cat":
            return _adjust(self.adjust_cat, torch.cat([out_v, out_i], dim=-1))
        return _adjust(self.adjust_out, out_v + out_i)


#: FUSION_CLASS -> AttentionFusionBimodal mode, for the classes ported so far
_FUSION_MODES = {
    "Attention_Fusion_Bimodal_LNSpecific": "cat",
    "Attention_Fusion_Bimodal_LNSpecific_2": "shared_sum",
}


def build_fusion(fusion_class: str, channels: int, d_model: int,
                 num_encoder_layers: int, dropout: float = 0.1) -> AttentionFusionBimodal:
    if fusion_class not in _FUSION_MODES:
        raise NotImplementedError(
            f"FUSION_CLASS {fusion_class!r} is not ported to multi_modal_tracking_torch "
            f"yet (ROADMAP.md queue 1, item 6: the rest of the fusion zoo)")
    return AttentionFusionBimodal(channels, d_model, num_encoder_layers,
                                  _FUSION_MODES[fusion_class], dropout)
