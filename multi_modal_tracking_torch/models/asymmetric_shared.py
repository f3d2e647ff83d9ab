"""Asymmetric-shared RGB-T MixFormer (the flagship) with candidate
elimination (CE).

A shared-weight ViT with modality-specific LayerNorms (norm{1,2}_{v,i}) and
cross-modal asymmetric attention: each modality's templates attend within
their own modality, each modality's search attends to its own search plus
the templates of BOTH modalities. The modalities ride the leading batch
axis ([:B] = RGB, [B:] = TIR) for every shared dense op and separate only
inside attention. CE at the configured blocks ranks search tokens by the
template->search attention and keeps the top ceil(keep_ratio * L_s) per
modality; removed tokens come back as zeros in their original positions
before the fusion and the head. `CE_TEMPLATE_RANGE` chooses the template
rows whose attention is pooled for the ranking, in each of the four
template copies (t and ot of both modalities): CTR_POINT the centre token,
CTR_REC the centre rectangle (2 x 2 cells on an even grid, the centre cell
on an odd one), ALL every row, and GT_BOX the rows under the ground-truth
box (`ce_box_row_weights`) when the forward is given `ce_gt_boxes`, else
every row, as in the JAX package (its trainer and trackers pass none).

All backbone attention runs in kernel K1 (`ops/attention.py`), and its
gradient in kernel K2:
  * full forward: one call per block with the per-modality key layout
    [own templates; other templates; own search] and n_mt = 2 * n_t;
  * template cache (`template_step`): one call, no mask;
  * cached search (`search_step`): one call with n_mt = 0.
The template->search attention that ranks CE candidates stays plain torch,
under `torch.no_grad()`: it only feeds `topk` indices, which carry no
gradient.

Training (`model.train()`): stochastic depth with per-block rates
linspace(0, drop_path_rate, depth) on both residual branches of every
block (an independent per-sample mask for each modality), CE under a
runtime keep rate (`ce_keep_rate`), the fusion's dropouts and the head's
BatchNorm statistics; the random layers draw from the generator given
with `models.layers.set_generator`. With TRAIN.REMAT (`RGBTSpec.remat`)
the full forward runs each backbone block under `models.layers.remat`
whenever gradients are recorded, so the backward recomputes its
activations with the same masks; the cached tracking path never does.
The flagship family is the only one with a remat path, as in the JAX
package (whose other models ignore TRAIN.REMAT).

The online scripts (`asymmetric_shared_online`) add the SPM score branch
(`models/score_decoder.py`): with `run_score_head` the forward also
returns `pred_scores`, the branch reading the fused search features, the
two modalities' template features stacked on the height axis and the box
(`gt_bboxes` in training, else the predicted box without its gradient).

Inputs are NHWC at the public functions, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

from multi_modal_tracking_torch.models.fusion import build_fusion
from multi_modal_tracking_torch.models.heads import CornerPredictor, PyramidCornerPredictor
from multi_modal_tracking_torch.models.layers import (DropPath, LayerNorm, Linear, Mlp,
                                                      PatchEmbed, _heads, _merge, remat)
from multi_modal_tracking_torch.models.score_decoder import ScoreDecoder
from multi_modal_tracking_torch.ops.attention import mixed_attention
from multi_modal_tracking_torch.ops.boxes import box_xyxy_to_cxcywh
from multi_modal_tracking_torch.ops.pos_embed import get_2d_sincos_pos_embed
from multi_modal_tracking_torch.utils import flops as _flops


#: the CE template-row modes (models/asymmetric_shared.py:55 there)
CE_TEMPLATE_RANGES = ("CTR_POINT", "CTR_REC", "GT_BOX", "ALL")

class CeSpan(NamedTuple):
    """CTR_REC's template rows: the cells [lo, hi) of both axes of each of
    the four F x F template grids."""
    F: int
    lo: int
    hi: int


#: template rows pooled for the CE ranking: a CeSpan (CTR_REC), or rows of
#: the four grids' concatenation by a slice (CTR_POINT's centre rows, step
#: F * F) or by a sequence of indices
CeRows = Union[CeSpan, slice, Sequence[int]]


def _check_ce_range(mode: str) -> str:
    if mode not in CE_TEMPLATE_RANGES:
        raise ValueError(f"unsupported CE_TEMPLATE_RANGE '{mode}' "
                         f"(implemented: {', '.join(CE_TEMPLATE_RANGES)})")
    return mode


def _ctr_rec_span(F: int) -> Tuple[int, int]:
    """CTR_REC's row and column span on an F x F template grid: 2 cells
    from (F - 1) // 2 on an even grid, the centre cell on an odd one (8 ->
    3:5, 12 -> 5:7, 7 -> 3:4)."""
    lo = (F - 1) // 2
    return lo, lo + (2 if F % 2 == 0 else 1)


def ce_box_row_weights(gt_xywh: torch.Tensor, template_size: int, grid: int) -> torch.Tensor:
    """GT_BOX template-row weights: the normalised (B, 4) xywh boxes
    rasterised at template resolution with the reference's integer
    truncation (rows and columns [floor(a), floor(a + len - 1))), a
    bilinear downsample by the stride (align_corners False, no
    antialias: centres (i + 0.5) * stride - 0.5, edges clamped) and a
    nonzero threshold. Returns (B, grid * grid) float {0, 1} weights of
    one template copy; device ops only, so a CUDA graph holds them."""
    box = gt_xywh.float() * template_size
    x1, y1, w, h = box.unbind(-1)
    r = torch.arange(template_size, dtype=torch.float32, device=box.device)
    rows = (r[None] >= torch.floor(y1)[:, None]) & (r[None] < torch.floor(y1 + h - 1.0)[:, None])
    cols = (r[None] >= torch.floor(x1)[:, None]) & (r[None] < torch.floor(x1 + w - 1.0)[:, None])
    mask = (rows[:, :, None] & cols[:, None, :]).float()
    stride = template_size // grid
    src = (torch.arange(grid, dtype=torch.float32, device=box.device) + 0.5) * stride - 0.5
    i0 = torch.clamp(torch.floor(src), 0, template_size - 1).long()
    i1 = torch.clamp(i0 + 1, 0, template_size - 1)
    fr = torch.clamp(src - i0, 0.0, 1.0)

    def down(m, dim):
        f = fr.reshape((-1,) + (1,) * (m.dim() - 1 - dim))
        return m.index_select(dim, i0) * (1.0 - f) + m.index_select(dim, i1) * f

    small = down(down(mask, 1), 2)
    return (small > 0).float().reshape(gt_xywh.shape[0], -1)


@torch.no_grad()
def _t2s_attention(q_mt: torch.Tensor, k_s: torch.Tensor, scale: float,
                   ce_rows: Optional[CeRows]) -> torch.Tensor:
    """Template->search attention for CE ranking: its own f32 softmax over
    the concatenated bimodal search axis, over the `ce_rows` template rows
    only (None = all rows). No gradient: only `topk` reads it. In a bf16
    model the scores are a bf16 product, scaled in bf16, before the f32
    softmax, as in the JAX model (models/asymmetric_shared.py:210, :262).
    The rows are a strided view of q_mt's four F x F grids, so no index
    tensor is copied from the host (a CUDA graph can hold the step); made
    contiguous, they are the product's operand an index would give, in
    the JAX package's order (copy, then row, then column)."""
    if isinstance(ce_rows, CeSpan):
        F, lo, hi = ce_rows
        B, H, _, D = q_mt.shape
        q_mt = q_mt.reshape(B, H, 4, F, F, D)[:, :, :, lo:hi, lo:hi].reshape(B, H, -1, D)
    elif ce_rows is not None:
        q_mt = q_mt[:, :, ce_rows].contiguous()
    a = torch.matmul(q_mt, k_s.transpose(-2, -1)) * scale
    return torch.softmax(a.float(), dim=-1)


class AsymCrossModalAttention(nn.Module):
    """Cross-modal asymmetric mixed attention over per-modality [t; ot; s].

    Under tensor parallelism (parallel/tensor.py, `set_model_group`) `qkv`
    holds this rank's heads' rows of q, of k and of v (the rows split per
    head, not the JAX rule's contiguous cut of the kernel's last axis,
    which GSPMD reshards) and `proj` the matching input columns:
    `num_heads` is then the rank's head count and the attention runs on
    its heads with no collective; `ce_scores` sums the CE ranking over the
    model group's heads."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = self.total_heads = num_heads
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = Linear(dim, dim)
        self.scale = (dim // num_heads) ** -0.5
        #: the model group of tensor parallelism (parallel/mesh.py), or None
        self.model_group = None

    def set_model_group(self, group) -> None:
        """Run on this rank's heads of `group`'s (its qkv and proj already
        cut: parallel/tensor.py shard_tensor_parallel_)."""
        self.model_group = group
        self.num_heads = self.total_heads // group.world

    def _head_sum(self, x: torch.Tensor, dims) -> torch.Tensor:
        """x summed over `dims` (dim 1, the heads, among them) and over the
        model group's heads."""
        x = x.sum(dim=dims)
        dist.all_reduce(x, group=self.model_group.group)
        return x

    @torch.no_grad()
    def ce_scores(self, attn_t2s: torch.Tensor,
                  row_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The CE ranking (B, 2 * L_s) of `_t2s_attention`'s (B, H, R, 2 *
        L_s): the mean over heads and rows, or with GT_BOX's (B, R) row
        weights the mean over heads, then the weighted mean over rows. Under
        tensor parallelism the sums run over every rank's heads before the
        division by the total head count, so every model rank keeps the
        same tokens."""
        tp = self.model_group is not None and self.model_group.world > 1
        if row_weights is not None:
            wr = row_weights[:, :, None].to(attn_t2s.dtype)
            heads = self._head_sum(attn_t2s, 1) / self.total_heads if tp \
                else attn_t2s.mean(dim=1)
            return (heads * wr).sum(dim=1) / wr.sum(dim=1).clamp_min(1e-6)
        if tp:
            return self._head_sum(attn_t2s, (1, 2)) / (self.total_heads * attn_t2s.shape[2])
        return attn_t2s.mean(dim=(1, 2))

    def _qkv_heads(self, x):
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        return (_heads(q, self.num_heads), _heads(k, self.num_heads),
                _heads(v, self.num_heads))

    def forward(self, x_v: torch.Tensor, x_i: torch.Tensor, n_mt: int,
                return_attention: bool = False,
                ce_rows: Optional[CeRows] = None):
        """x_v/x_i: (B, n_mt + n_s, C) -> (x_v, x_i, attn_t2s | None)."""
        B = x_v.shape[0]
        q, k, v = self._qkv_heads(torch.cat([x_v, x_i], dim=0))
        kV, kI, vV, vI = k[:B], k[B:], v[:B], v[B:]
        # Per modality the keys are [own templates; other templates; own
        # search], so the standard asymmetric mask (template rows see
        # j < n_mt, search rows see every key) gives the cross-modal
        # semantics and both modalities ride one kernel call.
        k_all = torch.cat([
            torch.cat([kV[:, :, :n_mt], kI[:, :, :n_mt], kV[:, :, n_mt:]], dim=2),
            torch.cat([kI[:, :, :n_mt], kV[:, :, :n_mt], kI[:, :, n_mt:]], dim=2)], dim=0)
        v_all = torch.cat([
            torch.cat([vV[:, :, :n_mt], vI[:, :, :n_mt], vV[:, :, n_mt:]], dim=2),
            torch.cat([vI[:, :, :n_mt], vV[:, :, :n_mt], vI[:, :, n_mt:]], dim=2)], dim=0)
        out = self.proj(_merge(mixed_attention(q, k_all, v_all, n_mt, self.scale)))
        attn_t2s = None
        if return_attention:
            q_mt = torch.cat([q[:B, :, :n_mt], q[B:, :, :n_mt]], dim=2)
            k_s = torch.cat([kV[:, :, n_mt:], kI[:, :, n_mt:]], dim=2)
            attn_t2s = _t2s_attention(q_mt, k_s, self.scale, ce_rows)
        return out[:B], out[B:], attn_t2s

    # ------------------------------------------------- cached-template path
    # Template tokens never attend to search, so their per-block q/k/v
    # depend only on the templates and are computed once per template
    # update instead of every frame.

    def template_step(self, nv: torch.Tensor, ni: torch.Tensor):
        """Normed template tokens (B, n_mt, C) per modality -> attention
        output + this block's cache {q, k, v per modality}."""
        B = nv.shape[0]
        q, k, v = self._qkv_heads(torch.cat([nv, ni], dim=0))
        out = self.proj(_merge(mixed_attention(q, k, v, 0, self.scale)))
        cache = {"qV": q[:B], "kV": k[:B], "vV": v[:B],
                 "qI": q[B:], "kI": k[B:], "vI": v[B:]}
        return out[:B], out[B:], cache

    def search_step(self, nsv: torch.Tensor, nsi: torch.Tensor, cache,
                    return_attention: bool = False,
                    ce_rows: Optional[CeRows] = None):
        """Normed search tokens (B, n_s, C) per modality + the cached
        template q/k/v -> attention output of the search rows + the t->s CE
        attention. Keys per modality: [RGB templates; TIR templates; own
        search]."""
        B = nsv.shape[0]
        qs, ks, vs = self._qkv_heads(torch.cat([nsv, nsi], dim=0))
        k_mt = torch.cat([cache["kV"], cache["kI"]], dim=2)
        v_mt = torch.cat([cache["vV"], cache["vI"]], dim=2)
        k_all = torch.cat([torch.cat([k_mt, ks[:B]], dim=2),
                           torch.cat([k_mt, ks[B:]], dim=2)], dim=0)
        v_all = torch.cat([torch.cat([v_mt, vs[:B]], dim=2),
                           torch.cat([v_mt, vs[B:]], dim=2)], dim=0)
        out = self.proj(_merge(mixed_attention(qs, k_all, v_all, 0, self.scale)))
        attn_t2s = None
        if return_attention:
            q_mt = torch.cat([cache["qV"], cache["qI"]], dim=2)
            k_s = torch.cat([ks[:B], ks[B:]], dim=2)
            attn_t2s = _t2s_attention(q_mt, k_s, self.scale, ce_rows)
        return out[:B], out[B:], attn_t2s


def _ce_select(attn_m: torch.Tensor, tokens: torch.Tensor, gidx: torch.Tensor,
               n_mt: int, lens_keep: int):
    """Top-k search-token selection for one modality.

    attn_m: (B, L_s) ranking scores; tokens: (B, n_mt + L_s, C);
    gidx: (B, L_s) original positions. Returns (tokens_new, gidx_new), the
    kept tokens in descending score order.
    """
    top_idx = torch.topk(attn_m, lens_keep, dim=1).indices
    gidx_new = torch.gather(gidx, 1, top_idx)
    B, C = tokens.shape[0], tokens.shape[-1]
    kept = torch.gather(tokens[:, n_mt:], 1, top_idx[..., None].expand(-1, -1, C))
    # a FLOP count adds the JAX package's one-hot row product (_select_rows)
    kept = _flops.one_hot_rows(kept, B, lens_keep, attn_m.shape[1], C)
    return torch.cat([tokens[:, :n_mt], kept], dim=1), gidx_new


def _recover(sm: torch.Tensor, gidx: torch.Tensor, n_s: int) -> torch.Tensor:
    """(B, K, C) kept search tokens at original positions gidx -> (B, n_s, C)
    with zeros at the pruned positions."""
    if sm.shape[1] == n_s:
        return sm
    B, K, C = sm.shape
    out = sm.new_zeros(B, n_s, C).scatter(1, gidx[..., None].expand(-1, -1, C), sm)
    # a FLOP count adds the JAX package's one-hot product (_scatter_rows)
    return _flops.one_hot_rows(out, B, K, n_s, C)


class SharedBlock(nn.Module):
    """Transformer block with modality-specific LNs and optional CE."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path: float = 0.0):
        super().__init__()
        self.dp1, self.dp2 = DropPath(drop_path), DropPath(drop_path)
        self.norm1_v = LayerNorm(dim, eps=1e-6)
        self.norm1_i = LayerNorm(dim, eps=1e-6)
        self.norm2_v = LayerNorm(dim, eps=1e-6)
        self.norm2_i = LayerNorm(dim, eps=1e-6)
        self.attn = AsymCrossModalAttention(dim, num_heads, qkv_bias)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def _mlp(self, x_v, x_i):
        B = x_v.shape[0]
        m = self.mlp(torch.cat([self.norm2_v(x_v), self.norm2_i(x_i)], dim=0))
        return x_v + self.dp2(m[:B]), x_i + self.dp2(m[B:])

    def forward(self, x_v, x_i, n_mt: int, gidx_v, gidx_i,
                lens_keep: Optional[int] = None,
                ce_rows: Optional[CeRows] = None,
                ce_row_weights: Optional[torch.Tensor] = None,
                return_scores: bool = False):
        """lens_keep: keep count (None = no CE at this block); ce_rows:
        template rows pooled for the CE ranking (None = all rows);
        ce_row_weights: (B, 4 * n_t) {0, 1} weights of the rows (GT_BOX,
        with ce_rows None), whose masked rows are averaged. return_scores
        also returns the pooled t->s attention per modality with the
        search positions it scores, taken before this block prunes:
        (a_v, a_i, gidx_v, gidx_i) (a diagnostic, the JAX block's
        `return_scores`; it raises under tensor parallelism)."""
        if return_scores and self.attn.model_group is not None:
            raise NotImplementedError("return_scores under tensor parallelism (each rank "
                                      "holds only its heads' attention)")
        exe_ce = lens_keep is not None and lens_keep < gidx_v.shape[1]
        av, ai, attn_t2s = self.attn(self.norm1_v(x_v), self.norm1_i(x_i), n_mt,
                                     return_attention=exe_ce or return_scores,
                                     ce_rows=ce_rows)
        x_v, x_i = x_v + self.dp1(av), x_i + self.dp1(ai)
        scores = None
        if exe_ce or return_scores:
            lens_s = gidx_v.shape[1]
            a = self.attn.ce_scores(attn_t2s, ce_row_weights if ce_rows is None else None)
            if return_scores:
                scores = (a[:, :lens_s], a[:, lens_s:], gidx_v, gidx_i)
            if exe_ce:
                x_v, gidx_v = _ce_select(a[:, :lens_s], x_v, gidx_v, n_mt, lens_keep)
                x_i, gidx_i = _ce_select(a[:, lens_s:], x_i, gidx_i, n_mt, lens_keep)
        x_v, x_i = self._mlp(x_v, x_i)
        if return_scores:
            return x_v, x_i, gidx_v, gidx_i, scores
        return x_v, x_i, gidx_v, gidx_i

    # ------------------------------------------------- cached-template path
    def template_step(self, x_v, x_i):
        """Template-only block step -> evolved template tokens + the block's
        attention cache."""
        av, ai, cache = self.attn.template_step(self.norm1_v(x_v), self.norm1_i(x_i))
        x_v, x_i = self._mlp(x_v + av, x_i + ai)
        return x_v, x_i, cache

    def search_step(self, s_v, s_i, cache, gidx_v, gidx_i,
                    lens_keep: Optional[int] = None,
                    ce_rows: Optional[CeRows] = None):
        """Search-only block step against a template cache; CE selects among
        pure search tokens."""
        exe_ce = lens_keep is not None and lens_keep < gidx_v.shape[1]
        av, ai, attn_t2s = self.attn.search_step(self.norm1_v(s_v), self.norm1_i(s_i),
                                                 cache, return_attention=exe_ce,
                                                 ce_rows=ce_rows)
        s_v, s_i = s_v + av, s_i + ai
        if exe_ce:
            lens_s = gidx_v.shape[1]
            a = self.attn.ce_scores(attn_t2s)
            s_v, gidx_v = _ce_select(a[:, :lens_s], s_v, gidx_v, 0, lens_keep)
            s_i, gidx_i = _ce_select(a[:, lens_s:], s_i, gidx_i, 0, lens_keep)
        s_v, s_i = self._mlp(s_v, s_i)
        return s_v, s_i, gidx_v, gidx_i


def ce_keep_schedule(n_search: int, depth: int, ce_loc: Sequence[int],
                     ce_keep_ratio: Sequence[float], ce_keep_rate: Optional[float]):
    """Per-block keep lengths (None = no pruning at that block):
    lens_keep = ceil(rate * current L_s) at each CE block, with a runtime
    ce_keep_rate overriding the per-block ratios when given."""
    keeps: List[Optional[int]] = [None] * depth
    cur = n_search
    ce_loc = list(ce_loc or [])
    ratios = list(ce_keep_ratio or [])
    for bi in range(depth):
        if bi in ce_loc:
            r = ce_keep_rate if ce_keep_rate is not None else ratios[ce_loc.index(bi)]
            k = min(math.ceil(r * cur), cur)
            if k < cur:
                keeps[bi] = k
                cur = k
    return keeps, cur


class AsymSharedViT(nn.Module):
    """Shared-weight bimodal ViT backbone (modalities on the batch axis)."""

    def __init__(self, img_size_s: int = 288, img_size_t: int = 128, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 ce_loc: Optional[Tuple[int, ...]] = None,
                 ce_keep_ratio: Optional[Tuple[float, ...]] = None,
                 ce_template_range: str = "CTR_POINT", drop_path_rate: float = 0.0,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.ce_template_range = _check_ce_range(ce_template_range)
        self.img_size_t = img_size_t
        self.depth = depth
        self.ce_loc, self.ce_keep_ratio = ce_loc, ce_keep_ratio
        self.patch_embed = PatchEmbed(patch_size, 3, embed_dim)
        dpr = [float(r) for r in torch.linspace(0, drop_path_rate, depth, dtype=torch.float64)]
        self.blocks = nn.ModuleList([SharedBlock(embed_dim, num_heads, mlp_ratio, qkv_bias, dpr[i])
                                     for i in range(depth)])
        self.grid_size_s = img_size_s // patch_size
        self.grid_size_t = img_size_t // patch_size
        # fixed sin-cos embeddings: buffers, not part of the state dict
        self.register_buffer("pos_embed_s", torch.from_numpy(
            get_2d_sincos_pos_embed(embed_dim, self.grid_size_s))[None], persistent=False)
        self.register_buffer("pos_embed_t", torch.from_numpy(
            get_2d_sincos_pos_embed(embed_dim, self.grid_size_t))[None], persistent=False)

    def _embed(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """Patch tokens plus the fixed position embedding, cast to the model's
        dtype as the JAX model casts it (models/asymmetric_shared.py:500-502)."""
        x = self.patch_embed(x)
        return x + pos.to(x.dtype)

    def _ce_rows(self, use_mask: bool) -> Optional[CeRows]:
        """Template rows ([t_v, ot_v, t_i, ot_i] order, F*F rows each) pooled
        for the CE ranking in the static modes: the centre token (CTR_POINT,
        rows c*F + c + g*F*F for g = 0..3, c = (F - 1) // 2, a slice) or the
        centre rectangle (CTR_REC, a CeSpan) of each template copy. None
        pools every row (ALL, GT_BOX, or no mask)."""
        if not use_mask or self.ce_template_range not in ("CTR_POINT", "CTR_REC"):
            return None
        F = self.grid_size_t
        if self.ce_template_range == "CTR_POINT":
            c = (F - 1) // 2
            return slice(c * F + c, None, F * F)
        return CeSpan(F, *_ctr_rec_span(F))

    def _ce_row_weights(self, use_mask: bool, ce_gt_boxes: Optional[torch.Tensor]
                        ) -> Optional[torch.Tensor]:
        """GT_BOX's (B, 4 * n_t) row weights of runtime boxes (the same box in
        all four template copies), else None."""
        if not use_mask or self.ce_template_range != "GT_BOX" or ce_gt_boxes is None:
            return None
        return ce_box_row_weights(ce_gt_boxes, self.img_size_t, self.grid_size_t).repeat(1, 4)

    def _keeps(self, n_s: int, ce_keep_rate: Optional[float]):
        return ce_keep_schedule(n_s, self.depth, self.ce_loc or (),
                                self.ce_keep_ratio or (), ce_keep_rate)[0]

    def forward(self, x_t, x_ot, x_s, ce_keep_rate: Optional[float] = None,
                use_ce_template_mask: bool = True,
                ce_gt_boxes: Optional[torch.Tensor] = None,
                return_attn_maps: bool = False):
        """x_*: stacked bimodal NHWC batches (2B, H, W, 3), [:B] RGB, [B:] TIR;
        ce_gt_boxes: (B, 4) normalised template-crop xywh, read by GT_BOX
        only. Returns the (t, ot, s) feature maps (2B, h, w, C), search
        tokens zero-restored at pruned positions. return_attn_maps also
        returns {CE block index: (B, 2, gs, gs) float32}: that block's
        head- and row-pooled t->s attention per modality (the ranking's,
        before the block prunes) scattered back to the search grid, zero
        at positions pruned earlier (the JAX backbone's
        `return_attn_maps`, the reference's attention-map
        visualisation; it raises under tensor parallelism)."""
        if return_attn_maps and self.blocks[0].attn.model_group is not None:
            raise NotImplementedError("return_attn_maps under tensor parallelism (each rank "
                                      "holds only its heads' attention)")
        t, ot, s = self._embed(x_t, self.pos_embed_t), self._embed(x_ot, self.pos_embed_t), \
            self._embed(x_s, self.pos_embed_s)
        B = t.shape[0] // 2
        n_t, n_s = t.shape[1], s.shape[1]
        n_mt = 2 * n_t
        x = torch.cat([t, ot, s], dim=1)
        x_v, x_i = x[:B], x[B:]
        keeps = self._keeps(n_s, ce_keep_rate)
        ce_rows = self._ce_rows(use_ce_template_mask)
        ce_row_weights = self._ce_row_weights(use_ce_template_mask, ce_gt_boxes)
        gidx = torch.arange(n_s, device=x.device)[None].expand(B, n_s)
        gidx_v = gidx_i = gidx
        # remat: each block's activations recomputed in the backward (the
        # JAX package's nn.remat(SharedBlock), models/asymmetric_shared.py:446)
        run = remat if self.remat and torch.is_grad_enabled() else (lambda f, *a: f(*a))
        gt, gs = self.grid_size_t, self.grid_size_s
        attn_maps = {}

        def grid(score, gi):
            full = torch.zeros(B, n_s, dtype=torch.float32, device=score.device)
            return full.scatter(1, gi, score.float()).reshape(B, gs, gs)
        for bi, blk in enumerate(self.blocks):
            if return_attn_maps and bi in (self.ce_loc or ()):
                x_v, x_i, gidx_v, gidx_i, (a_v, a_i, g_v, g_i) = blk(
                    x_v, x_i, n_mt, gidx_v, gidx_i, keeps[bi], ce_rows, ce_row_weights, True)
                attn_maps[bi] = torch.stack([grid(a_v, g_v), grid(a_i, g_i)], dim=1)
            else:
                x_v, x_i, gidx_v, gidx_i = run(blk, x_v, x_i, n_mt, gidx_v, gidx_i,
                                               keeps[bi], ce_rows, ce_row_weights)
        x_v = torch.cat([x_v[:, :n_mt], _recover(x_v[:, n_mt:], gidx_v, n_s)], dim=1)
        x_i = torch.cat([x_i[:, :n_mt], _recover(x_i[:, n_mt:], gidx_i, n_s)], dim=1)
        x = torch.cat([x_v, x_i], dim=0)
        feats = (x[:, :n_t].reshape(2 * B, gt, gt, -1),
                 x[:, n_t:n_mt].reshape(2 * B, gt, gt, -1),
                 x[:, n_mt:].reshape(2 * B, gs, gs, -1))
        return feats + (attn_maps,) if return_attn_maps else feats

    # ------------------------------------------------- cached-template path
    def build_template_cache(self, x_t, x_ot):
        """Run the template tokens through all blocks once, collecting every
        block's attention cache. Returns {"kv": [per-block cache], "t", "ot"}
        with the final template feature maps."""
        t, ot = self._embed(x_t, self.pos_embed_t), self._embed(x_ot, self.pos_embed_t)
        B = t.shape[0] // 2
        n_t = t.shape[1]
        x = torch.cat([t, ot], dim=1)
        x_v, x_i = x[:B], x[B:]
        kv = []
        for blk in self.blocks:
            x_v, x_i, c = blk.template_step(x_v, x_i)
            kv.append(c)
        x = torch.cat([x_v, x_i], dim=0)
        gt = self.grid_size_t
        return {"kv": kv, "t": x[:, :n_t].reshape(2 * B, gt, gt, -1),
                "ot": x[:, n_t:].reshape(2 * B, gt, gt, -1)}

    def forward_search(self, cache, x_s, ce_keep_rate: Optional[float] = None,
                       use_ce_template_mask: bool = True):
        """Per-frame search-only forward against a template cache; the same
        function of the inputs as forward's search output (GT_BOX has no
        boxes here and pools every row, as the JAX package's)."""
        s = self._embed(x_s, self.pos_embed_s)
        B = s.shape[0] // 2
        n_s = s.shape[1]
        s_v, s_i = s[:B], s[B:]
        keeps = self._keeps(n_s, ce_keep_rate)
        ce_rows = self._ce_rows(use_ce_template_mask)
        gidx = torch.arange(n_s, device=s.device)[None].expand(B, n_s)
        gidx_v = gidx_i = gidx
        for bi, blk in enumerate(self.blocks):
            s_v, s_i, gidx_v, gidx_i = blk.search_step(s_v, s_i, cache["kv"][bi],
                                                       gidx_v, gidx_i, keeps[bi], ce_rows)
        s = torch.cat([_recover(s_v, gidx_v, n_s), _recover(s_i, gidx_i, n_s)], dim=0)
        gs = self.grid_size_s
        return s.reshape(2 * B, gs, gs, -1)


@dataclasses.dataclass(frozen=True)
class RGBTSpec:
    """Model spec extracted from a CfgNode."""
    search_size: int = 288
    template_size: int = 128
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    head_type: str = "CORNER"
    head_dim: int = 384
    head_freeze_bn: bool = False
    fusion_class: str = "Attention_Fusion_Bimodal_LNSpecific_2"
    fusion_layers: int = 6
    ce_loc: Optional[Tuple[int, ...]] = None
    ce_keep_ratio: Optional[Tuple[float, ...]] = None
    ce_template_range: str = "CTR_POINT"
    drop_path_rate: float = 0.1
    fusion_dropout: float = 0.1
    nlayer_head: int = 3
    #: TRAIN.REMAT: recompute each backbone block in the backward
    remat: bool = False

    @staticmethod
    def from_cfg(cfg) -> "RGBTSpec":
        dims = dict(base_patch16=(768, 12, 12), large_patch16=(1024, 24, 16))[cfg.MODEL.VIT_TYPE]
        bb = cfg.MODEL.BACKBONE
        return RGBTSpec(
            search_size=cfg.DATA.SEARCH.SIZE, template_size=cfg.DATA.TEMPLATE.SIZE,
            embed_dim=dims[0], depth=dims[1], num_heads=dims[2],
            head_type=cfg.MODEL.HEAD_TYPE, head_dim=cfg.MODEL.get("HEAD_DIM", 384),
            head_freeze_bn=cfg.MODEL.get("HEAD_FREEZE_BN", False),
            fusion_class=cfg.MODEL.FUSION_CLASS, fusion_layers=cfg.MODEL.FUSION_LAYERS,
            ce_loc=tuple(bb.CE_LOC) if "CE_LOC" in bb else None,
            ce_keep_ratio=tuple(bb.CE_KEEP_RATIO) if "CE_KEEP_RATIO" in bb else None,
            ce_template_range=_check_ce_range(bb.get("CE_TEMPLATE_RANGE", "CTR_POINT")),
            nlayer_head=cfg.MODEL.get("NLAYER_HEAD", 3),
            remat=bool(cfg.TRAIN.get("REMAT", False)))


def _build_head(sp: RGBTSpec) -> nn.Module:
    if sp.head_type == "CORNER":
        return CornerPredictor(sp.embed_dim, sp.head_dim, sp.search_size // 16, 16,
                               sp.head_freeze_bn)
    if sp.head_type == "CORNER_UP":
        return PyramidCornerPredictor(sp.embed_dim, sp.head_dim, sp.search_size // 4, 4,
                                      sp.head_freeze_bn)
    raise NotImplementedError(f"HEAD_TYPE {sp.head_type!r} is not ported "
                              f"(CORNER and CORNER_UP are)")


class MixFormerRGBT(nn.Module):
    """Backbone + deformable fusion + corner head (+ the SPM score branch
    with `with_score`)."""

    def __init__(self, spec: RGBTSpec, with_score: bool = False):
        super().__init__()
        sp = self.spec = spec
        self.with_score = with_score
        self.backbone = AsymSharedViT(
            img_size_s=sp.search_size, img_size_t=sp.template_size,
            embed_dim=sp.embed_dim, depth=sp.depth, num_heads=sp.num_heads,
            ce_loc=sp.ce_loc, ce_keep_ratio=sp.ce_keep_ratio,
            ce_template_range=sp.ce_template_range, drop_path_rate=sp.drop_path_rate,
            remat=sp.remat)
        # the fusion's d_model is fixed at 512 for every recipe
        self.fusion_vi = build_fusion(sp.fusion_class, sp.embed_dim, 512, sp.fusion_layers,
                                      sp.fusion_dropout)
        self.box_head = _build_head(sp)
        if with_score:
            self.score_branch = ScoreDecoder(sp.num_heads, sp.embed_dim, sp.nlayer_head)

    def _head(self, s: torch.Tensor, t: Optional[torch.Tensor], run_score_head: bool,
              gt_bboxes: Optional[torch.Tensor] = None, return_features: bool = False):
        B = s.shape[0] // 2
        fused = self.fusion_vi(s[:B], s[B:])
        box_xyxy = self.box_head(fused)
        out = {"pred_boxes": box_xyxy_to_cxcywh(box_xyxy).reshape(B, 1, 4)}
        if run_score_head and self.with_score:
            box = gt_bboxes if gt_bboxes is not None else box_xyxy.detach()
            # the modalities' template maps stacked on the HEIGHT axis, as
            # the reference concatenates NCHW dim 2: the width would permute
            # the tokens the SPM attends over
            out["pred_scores"] = self.score_branch(fused, torch.cat([t[:B], t[B:]], dim=1),
                                                   box.reshape(B, 4))
        if return_features:
            out["search_v"], out["search_i"], out["search_fused"] = s[:B], s[B:], fused
        return out

    def forward(self, t_vi, ot_vi, s_vi, ce_keep_rate: Optional[float] = None,
                use_ce_template_mask: bool = True, run_score_head: bool = False,
                gt_bboxes: Optional[torch.Tensor] = None,
                ce_gt_boxes: Optional[torch.Tensor] = None, return_features: bool = False):
        """t_vi/ot_vi/s_vi: (2B, H, W, 3) bimodal stacks ([:B] RGB, [B:] TIR).
        Returns {'pred_boxes': (B, 1, 4) cxcywh in [0, 1]}, and with
        run_score_head (a model with the score branch) 'pred_scores' (B, 1,
        1) logits; gt_bboxes (B, 4) normalised xyxy replaces the predicted
        box the score branch pools; ce_gt_boxes (B, 4) normalised
        template-crop xywh are GT_BOX's boxes (no other mode reads them).
        return_features adds the search feature maps 'search_v',
        'search_i' (B, gs, gs, C) and the fused 'search_fused' (the JAX
        model's diagnostic outputs)."""
        t, _, s = self.backbone(t_vi, ot_vi, s_vi, ce_keep_rate, use_ce_template_mask,
                                ce_gt_boxes)
        return self._head(s, t, run_score_head, gt_bboxes, return_features)

    # ------------------------------------------------- cached-template path
    def set_online(self, t_vi, ot_vi):
        """Per-block template k/v cache + final template features; rebuilt
        only at template updates, consumed by forward_track."""
        return self.backbone.build_template_cache(t_vi, ot_vi)

    def forward_track(self, cache, s_vi, ce_keep_rate: Optional[float] = None,
                      use_ce_template_mask: bool = True, run_score_head: bool = False):
        """Per-frame tracking forward over the search tokens only; the score
        branch reads the cache's template features."""
        s = self.backbone.forward_search(cache, s_vi, ce_keep_rate, use_ce_template_mask)
        return self._head(s, cache["t"], run_score_head)


def build_mixformer_rgbt(cfg, with_score: bool = False, **spec_overrides) -> MixFormerRGBT:
    """The flagship model of a config, with the SPM score branch if
    `with_score`; `spec_overrides` replace fields of the spec read from it
    (e.g. depth, or the drop rates)."""
    return MixFormerRGBT(dataclasses.replace(RGBTSpec.from_cfg(cfg), **spec_overrides),
                         with_score=with_score)
