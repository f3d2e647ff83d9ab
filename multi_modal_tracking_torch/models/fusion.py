"""RGB-T fusions: the whole FUSION_CLASS table of the JAX package
(`build_fusion`, models/fusion.py:381-411 there).

Deformable-attention fusions (`Attention_Fusion_*`): a 2-level ("level" =
modality) Deformable-DETR encoder over the two flattened modal search maps:
sine position encoding + a per-level embed, per-pixel reference points,
N x (MSDeformAttn -> LN -> FFN -> LN), with modality-specific or shared
LayerNorms; sampling offsets and attention weights predicted from the
channel concat of both modal queries (shared by both modalities, or one set
per modality), or from each query alone; 1x1 conv + GroupNorm adjusts
around the encoder, or none. The sampling core is kernel K3
(`ops/msda.py`); its head dim is d_model / 8: 64 at the recipes' d_model
512, 96 for Attention_Fusion_1, whose encoder runs at the backbone's 768.

Conv fusions (`RGBT_Fusion_*`): conv-BN-ReLU stacks over the concatenated
modal maps, RGBT_Fusion_2 and _3 with a modulated deformable convolution
first (`ops/deform_conv.py`, plain PyTorch: the JAX op is no Pallas
kernel).

Module attribute names give the reference's state-dict keys, e.g.
`fusion_vi.fusion_attention.encoder.layers.0.self_attn.value_proj.weight`,
`fusion_vi.fusion_bn.running_mean`. Each encoder layer has the reference's
three dropouts (rate 0.1: after the deformable attention, after the FFN's
ReLU, after its second linear); they act in training mode only and draw
from the generator of `set_generator`. Gradients flow through K3's
backward, kernel K4. A model cast to bf16 runs K3-bf16: bf16 values and
attention weights, f32 sampling locations.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
from torch import nn

from multi_modal_tracking_torch.models.layers import (BatchNorm2d, Conv2d, Dropout, GroupNorm,
                                                      LayerNorm, Linear)
from multi_modal_tracking_torch.ops.deform_conv import modulated_deform_conv2d
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
    """Deformable attention over 2 levels = 2 modalities. `attn_type`:
      'bimodal'   offsets/weights predicted from the channel concat of both
                  modal queries and shared by both modalities;
      'bimodal_2' separate V/I offsets/weights, still from the concat query
                  (twice the prediction width, the grid bias tiled twice);
      'normal'    each query predicts its own offsets/weights from itself."""

    def __init__(self, d_model: int = 256, n_levels: int = 2, n_heads: int = 8,
                 n_points: int = 4, attn_type: str = "bimodal"):
        super().__init__()
        if attn_type not in ("bimodal", "bimodal_2", "normal"):
            raise ValueError(f"attn_type {attn_type!r}")
        self.d_model, self.n_levels, self.n_heads, self.n_points = \
            d_model, n_levels, n_heads, n_points
        self.attn_type = attn_type
        q_dim = d_model if attn_type == "normal" else 2 * d_model
        self._reps = 2 if attn_type == "bimodal_2" else 1
        n = n_heads * n_levels * n_points
        self.sampling_offsets = Linear(q_dim, self._reps * n * 2)
        self.attention_weights = Linear(q_dim, self._reps * n)
        self.value_proj = Linear(d_model, d_model)
        self.output_proj = Linear(d_model, d_model)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's init: zero offset kernel + directional grid bias
        (tiled once per predicted modality), zero attention weights,
        xavier-uniform value/output projections."""
        nn.init.zeros_(self.sampling_offsets.weight)
        self.sampling_offsets.bias.copy_(torch.from_numpy(np.tile(
            _msda_grid_bias(self.n_heads, self.n_levels, self.n_points), self._reps)))
        nn.init.zeros_(self.attention_weights.weight)
        nn.init.zeros_(self.attention_weights.bias)
        for lin in (self.value_proj, self.output_proj):
            nn.init.xavier_uniform_(lin.weight, generator=generator)
            nn.init.zeros_(lin.bias)

    def _offsets_and_weights(self, query: torch.Tensor):
        """(B, Lq, M, L, P, 2) offsets and (B, Lq, M, L * P) weight logits."""
        B, Lq, _ = query.shape
        M, L, P = self.n_heads, self.n_levels, self.n_points
        if self.attn_type == "normal":
            return (self.sampling_offsets(query).reshape(B, Lq, M, L, P, 2),
                    self.attention_weights(query).reshape(B, Lq, M, L * P))
        half = Lq // 2
        q_bi = torch.cat([query[:, :half], query[:, half:]], dim=2)    # (B, Lq/2, 2C)
        off = self.sampling_offsets(q_bi)
        w = self.attention_weights(q_bi)
        if self.attn_type == "bimodal_2":
            # V's predictions, then I's, aligned with the [V; I] token
            # order, as the JAX package keeps them (models/fusion.py:53-58,
            # :93-103); the reference `view`s the doubled prediction to the
            # sequence length, which interleaves the modalities
            off = off.reshape(B, half, 2, M, L, P, 2)
            w = w.reshape(B, half, 2, M, L * P)
            return (torch.cat([off[:, :, 0], off[:, :, 1]], dim=1),
                    torch.cat([w[:, :, 0], w[:, :, 1]], dim=1))
        off = off.reshape(B, half, M, L, P, 2)
        return (torch.cat([off, off], dim=1),
                torch.cat([w, w], dim=1).reshape(B, Lq, M, L * P))

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                src: torch.Tensor, spatial_shapes: Tuple[Tuple[int, int], ...],
                normalizer: torch.Tensor) -> torch.Tensor:
        """query/src: (B, 2*HW, C); reference_points: (Lq, L, 2); normalizer:
        (L, 2) float32 (W_l, H_l) of spatial_shapes, on query's device."""
        B, Lq, C = query.shape
        M, L, P = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(src).reshape(B, Lq, M, C // M)
        off, w = self._offsets_and_weights(query)
        # f32 softmax, then the model's dtype; locations stay f32 (the JAX
        # layer's rounding points, models/fusion.py:115-125)
        w = torch.softmax(w.float(), dim=-1).to(value.dtype).reshape(B, Lq, M, L, P)
        loc = reference_points[None, :, None, :, None, :] \
            + off / normalizer[None, None, None, :, None, :]
        out = ms_deform_attn(value.contiguous(), spatial_shapes, loc.contiguous(),
                             w.contiguous())
        return self.output_proj(out)


class DeformableEncoderLayer(nn.Module):
    """Deformable attention -> LN -> FFN -> LN. The LNs (eps 1e-5, the torch
    default the reference's encoder uses, unlike the backbone's 1e-6) are
    one per modality half of the sequence with `ln_specific` (`norm1_v`,
    `norm1_i`, ...), else one shared LN each (`norm1`, `norm2`)."""

    def __init__(self, d_model: int, d_ffn: int, n_levels: int = 2, n_heads: int = 8,
                 n_points: int = 4, dropout: float = 0.1, ln_specific: bool = True,
                 attn_type: str = "bimodal"):
        super().__init__()
        self.ln_specific = ln_specific
        self.dropout1, self.dropout2, self.dropout3 = (Dropout(dropout) for _ in range(3))
        self.self_attn = MSDeformAttnBimodal(d_model, n_levels, n_heads, n_points, attn_type)
        self._add_norm("norm1", d_model)
        self.linear1 = Linear(d_model, d_ffn)
        self.linear2 = Linear(d_ffn, d_model)
        self._add_norm("norm2", d_model)

    def _add_norm(self, name: str, d_model: int) -> None:
        if self.ln_specific:
            setattr(self, name + "_v", LayerNorm(d_model, eps=1e-5))
            setattr(self, name + "_i", LayerNorm(d_model, eps=1e-5))
        else:
            setattr(self, name, LayerNorm(d_model, eps=1e-5))

    def _norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        if not self.ln_specific:
            return getattr(self, name)(x)
        half = x.shape[1] // 2
        return torch.cat([getattr(self, name + "_v")(x[:, :half]),
                          getattr(self, name + "_i")(x[:, half:])], dim=1)

    def forward(self, src, pos, reference_points, spatial_shapes, normalizer):
        src2 = self.dropout1(self.self_attn(src + pos, reference_points, src, spatial_shapes,
                                            normalizer))
        src = self._norm(src + src2, "norm1")
        ff = self.dropout3(self.linear2(self.dropout2(torch.relu(self.linear1(src)))))
        return self._norm(src + ff, "norm2")


class _Encoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class DeformableAttentionFusion(nn.Module):
    """N-layer deformable encoder over the two flattened modal search maps."""

    def __init__(self, d_model: int = 512, n_heads: int = 8, num_encoder_layers: int = 6,
                 n_points: int = 4, dropout: float = 0.1, ln_specific: bool = True,
                 attn_type: str = "bimodal"):
        super().__init__()
        self.d_model = d_model
        self.level_embed = nn.Parameter(torch.zeros(2, d_model))
        self.encoder = _Encoder([DeformableEncoderLayer(d_model, 4 * d_model, 2, n_heads,
                                                        n_points, dropout, ln_specific,
                                                        attn_type)
                                 for _ in range(num_encoder_layers)])
        self._geometry = {}

    def _pos_and_ref(self, H: int, W: int, device):
        """Sine position encoding (HW, C), reference points (2HW, 2, 2) and
        the MSDA level normaliser (2, 2) of (W, H) per level, computed once
        per map size and device: a tensor made from host data would be a
        copy from the host at every call, which synchronises the stream and
        cannot be captured in a CUDA graph."""
        key = (H, W, str(device))
        if key not in self._geometry:
            pos1 = torch.from_numpy(sine_position_encoding(H, W, self.d_model // 2))
            ys, xs = np.meshgrid(np.linspace(0.5, H - 0.5, H) / H,
                                 np.linspace(0.5, W - 0.5, W) / W, indexing="ij")
            ref1 = np.stack([xs.reshape(-1), ys.reshape(-1)], -1)
            ref = np.tile(np.concatenate([ref1, ref1], 0)[:, None, :], (1, 2, 1))
            norm = np.asarray([[W, H], [W, H]], np.float32)
            self._geometry[key] = (pos1.to(device),
                                   torch.from_numpy(ref.astype(np.float32)).to(device),
                                   torch.from_numpy(norm).to(device))
        return self._geometry[key]

    def forward(self, src_v: torch.Tensor, src_i: torch.Tensor) -> torch.Tensor:
        """src_v/src_i: (B, H, W, d_model) -> (B, 2*H*W, d_model)."""
        B, H, W, C = src_v.shape
        spatial_shapes = ((H, W), (H, W))
        src = torch.cat([src_v.reshape(B, H * W, C), src_i.reshape(B, H * W, C)], dim=1)
        pos1, ref, normalizer = self._pos_and_ref(H, W, src.device)
        pos = torch.cat([pos1 + self.level_embed[0], pos1 + self.level_embed[1]],
                        dim=0)[None].to(src.dtype)
        for layer in self.encoder.layers:
            src = layer(src, pos, ref, spatial_shapes, normalizer)
        return src


def _AdjustConv(in_channels: int, out_channels: int) -> nn.Sequential:
    """1x1 conv + GroupNorm(32, eps 1e-5) channel adjust (`.0` / `.1` keys)."""
    return nn.Sequential(Conv2d(in_channels, out_channels, kernel_size=1),
                         GroupNorm(32, out_channels, eps=1e-5))


def _adjust(mod: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """Apply an _AdjustConv to an NHWC map."""
    return mod(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class AttentionFusionBimodal(nn.Module):
    """The deformable-attention fusions, by `mode`:
      'cat'        separate in-adjusts, concat of the modal outputs -> out
                   adjust (Attention_Fusion_Bimodal, _LNSpecific,
                   _Bimodal_2, Attention_Fusion_512);
      'sum'        separate in-adjusts, sum of the modal outputs -> out
                   adjust (Attention_Fusion_Bimodal_LNSpecific_Sum);
      'shared_sum' shared in-adjust, sum, shared out adjust
                   (Attention_Fusion_Bimodal_LNSpecific_2);
      'raw_sum'    no adjusts: the encoder at d_model = channels, the modal
                   outputs summed (Attention_Fusion_1).
    `ln_specific` and `attn_type` go to the encoder layers."""

    def __init__(self, channels: int = 768, d_model: int = 512, num_encoder_layers: int = 6,
                 mode: str = "cat", dropout: float = 0.1, ln_specific: bool = True,
                 attn_type: str = "bimodal"):
        super().__init__()
        if mode not in ("cat", "sum", "shared_sum", "raw_sum"):
            raise ValueError(f"mode {mode!r}")
        self.mode = mode
        if mode == "raw_sum":
            d_model = channels
        elif mode == "shared_sum":
            self.adjust_in = _AdjustConv(channels, d_model)
        else:
            self.adjust_v = _AdjustConv(channels, d_model)
            self.adjust_i = _AdjustConv(channels, d_model)
        self.fusion_attention = DeformableAttentionFusion(d_model, 8, num_encoder_layers,
                                                          dropout=dropout,
                                                          ln_specific=ln_specific,
                                                          attn_type=attn_type)
        if mode == "cat":
            self.adjust_cat = _AdjustConv(2 * d_model, channels)
        elif mode == "sum":
            self.adjust_sum = _AdjustConv(d_model, channels)
        elif mode == "shared_sum":
            self.adjust_out = _AdjustConv(d_model, channels)

    def forward(self, x_v: torch.Tensor, x_i: torch.Tensor) -> torch.Tensor:
        """(B, H, W, channels) x2 -> (B, H, W, channels) fused map."""
        B, H, W, _ = x_v.shape
        if self.mode == "raw_sum":
            v, i = x_v, x_i
        elif self.mode == "shared_sum":
            v, i = _adjust(self.adjust_in, x_v), _adjust(self.adjust_in, x_i)
        else:
            v, i = _adjust(self.adjust_v, x_v), _adjust(self.adjust_i, x_i)
        out = self.fusion_attention(v, i)
        d = out.shape[-1]
        out_v = out[:, :H * W].reshape(B, H, W, d)
        out_i = out[:, H * W:].reshape(B, H, W, d)
        if self.mode == "raw_sum":
            return out_v + out_i
        if self.mode == "cat":
            return _adjust(self.adjust_cat, torch.cat([out_v, out_i], dim=-1))
        adj = self.adjust_out if self.mode == "shared_sum" else self.adjust_sum
        return _adjust(adj, out_v + out_i)


# ----------------------------------------------------------- conv fusions
# BatchNorm: momentum 0.1, eps 1e-5, batch statistics in training
# (models/layers.py BatchNorm2d). The convolutions carry no bias, as the
# reference's; their keys are `fusion.weight`, `fusion_bn.*`, ...

def _conv3x3(cin: int, cout: int) -> Conv2d:
    return Conv2d(cin, cout, kernel_size=3, padding=1, bias=False)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class ConvFusion(nn.Module):
    """RGBT_Fusion_1: concat of the modal maps -> two 3x3 conv-BN-ReLU."""

    def __init__(self, channels: int = 768):
        super().__init__()
        self.fusion = _conv3x3(2 * channels, channels)
        self.fusion_bn = BatchNorm2d(channels, eps=1e-5)
        self.fusion2 = _conv3x3(channels, channels)
        self.fusion2_bn = BatchNorm2d(channels, eps=1e-5)

    def forward(self, x_v: torch.Tensor, x_i: torch.Tensor) -> torch.Tensor:
        x = self.fusion_bn(self.fusion(_nchw(torch.cat([x_v, x_i], dim=-1)))).relu()
        return _nhwc(self.fusion2_bn(self.fusion2(x)).relu())


class ModulatedDeformConv2d(nn.Module):
    """The 3x3 modulated deformable convolution of the deform fusions
    (`weight` (Cout, Cin, 3, 3), no bias), computed by
    ops/deform_conv.py. With `pack` it predicts its own offsets and mask
    with `conv_offset` (mmcv's ModulatedDeformConv2dPack, RGBT_Fusion_3);
    else the caller passes them (RGBT_Fusion_2's `fusion_offset`)."""

    def __init__(self, cin: int, cout: int, deform_groups: int, pack: bool = False):
        super().__init__()
        self.deform_groups = deform_groups
        self.weight = nn.Parameter(torch.zeros(cout, cin, 3, 3))
        if pack:
            self.conv_offset = Conv2d(cin, 3 * deform_groups * 9, kernel_size=3, padding=1)

    def forward(self, x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor):
        return modulated_deform_conv2d(x, offset, mask, self.weight, padding=1,
                                       deform_groups=self.deform_groups)


class DeformConvFusion(nn.Module):
    """RGBT_Fusion_2 (deform groups 2, offsets from `fusion_offset`) and
    RGBT_Fusion_3 (deform groups 1, offsets from `fusion.conv_offset`): a
    3x3 conv over the concatenated modalities predicts (o1, o2, mask), each
    dg * 9 channels; the offset is cat(o1, o2), read per deform group as
    the per-tap interleaved (dy, dx) pairs (with dg = 2, o1 is group 0's
    pairs and o2 group 1's: the JAX package's note at models/fusion.py:
    336-343), the mask their sigmoid; then the modulated deformable conv,
    BN, ReLU, and a 3x3 conv-BN-ReLU."""

    def __init__(self, channels: int = 768, deform_groups: int = 2, pack: bool = False):
        super().__init__()
        cin = 2 * channels
        self.pack = pack
        if not pack:
            self.fusion_offset = Conv2d(cin, 3 * deform_groups * 9, kernel_size=3, padding=1)
        self.fusion = ModulatedDeformConv2d(cin, channels, deform_groups, pack)
        self.fusion_bn = BatchNorm2d(channels, eps=1e-5)
        self.fusion2 = _conv3x3(channels, channels)
        self.fusion2_bn = BatchNorm2d(channels, eps=1e-5)

    @property
    def offset_conv(self) -> Conv2d:
        return self.fusion.conv_offset if self.pack else self.fusion_offset

    def forward(self, x_v: torch.Tensor, x_i: torch.Tensor) -> torch.Tensor:
        x = torch.cat([x_v, x_i], dim=-1)
        o1, o2, mask = torch.chunk(_nhwc(self.offset_conv(_nchw(x))), 3, dim=-1)
        x = self.fusion(x, torch.cat([o1, o2], dim=-1), torch.sigmoid(mask))
        x = self.fusion_bn(_nchw(x)).relu()
        return _nhwc(self.fusion2_bn(self.fusion2(x)).relu())


class CatConvFusion(nn.Module):
    """RGBT_Fusion_Cat: concat of the modal maps -> three 3x3 conv-BN-ReLU
    (2C -> 2C -> C -> C)."""

    def __init__(self, channels: int = 768):
        super().__init__()
        widths = [2 * channels, 2 * channels, channels, channels]
        for i in range(3):
            setattr(self, f"fusion{i + 1}", _conv3x3(widths[i], widths[i + 1]))
            setattr(self, f"fusion{i + 1}_bn", BatchNorm2d(widths[i + 1], eps=1e-5))

    def forward(self, x_v: torch.Tensor, x_i: torch.Tensor) -> torch.Tensor:
        x = _nchw(torch.cat([x_v, x_i], dim=-1))
        for i in range(1, 4):
            x = getattr(self, f"fusion{i}_bn")(getattr(self, f"fusion{i}")(x)).relu()
        return _nhwc(x)


#: FUSION_CLASS -> AttentionFusionBimodal arguments (the JAX package's table,
#: models/fusion.py:381-411, after the reference's globals()[FUSION_CLASS])
_ATTENTION_FUSIONS = {
    "Attention_Fusion_1": dict(ln_specific=False, mode="raw_sum"),
    "Attention_Fusion_512": dict(ln_specific=False, mode="cat", attn_type="normal"),
    "Attention_Fusion_Bimodal": dict(ln_specific=False, mode="cat"),
    "Attention_Fusion_Bimodal_2": dict(ln_specific=False, mode="cat", attn_type="bimodal_2"),
    "Attention_Fusion_Bimodal_LNSpecific": dict(ln_specific=True, mode="cat"),
    "Attention_Fusion_Bimodal_LNSpecific_Sum": dict(ln_specific=True, mode="sum"),
    "Attention_Fusion_Bimodal_LNSpecific_2": dict(ln_specific=True, mode="shared_sum"),
}
#: and the conv fusions
_CONV_FUSIONS = {
    "RGBT_Fusion_1": lambda c: ConvFusion(c),
    "RGBT_Fusion_2": lambda c: DeformConvFusion(c, deform_groups=2),
    "RGBT_Fusion_3": lambda c: DeformConvFusion(c, deform_groups=1, pack=True),
    "RGBT_Fusion_Cat": lambda c: CatConvFusion(c),
}
#: every FUSION_CLASS the port builds
FUSION_CLASSES = tuple(_ATTENTION_FUSIONS) + tuple(_CONV_FUSIONS)


def build_fusion(fusion_class: str, channels: int, d_model: int,
                 num_encoder_layers: int, dropout: float = 0.1) -> nn.Module:
    """The fusion module of cfg.MODEL.FUSION_CLASS: (B, H, W, channels) x2 ->
    (B, H, W, channels). d_model, num_encoder_layers and dropout apply to
    the deformable-attention fusions."""
    if fusion_class in _ATTENTION_FUSIONS:
        return AttentionFusionBimodal(channels, d_model, num_encoder_layers,
                                      dropout=dropout, **_ATTENTION_FUSIONS[fusion_class])
    if fusion_class in _CONV_FUSIONS:
        return _CONV_FUSIONS[fusion_class](channels)
    raise ValueError(f"Unknown FUSION_CLASS {fusion_class!r} (known: {FUSION_CLASSES})")
