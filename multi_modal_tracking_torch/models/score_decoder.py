"""SPM, the score prediction module of the online trackers: the port's
counterpart of the JAX package's `models/score_decoder.py ScoreDecoder`.

A learned score token attends first to the 16 PrRoI-pooled tokens of the
search box, then to the template features, and a 3-layer MLP turns it into
one confidence logit. The attention is written with matmuls and a float32
softmax, in the JAX einsums' order (it is not a Pallas kernel in the JAX
package). Parameter names are the reference's (`score_token`, `proj_q.0`,
`norm2.1`, `score_head.layers.2`, ...), so a reference checkpoint loads
strictly.
"""
from __future__ import annotations

import torch
from torch import nn

from multi_modal_tracking_torch.models.heads import MLPHead
from multi_modal_tracking_torch.models.layers import LayerNorm, Linear
from multi_modal_tracking_torch.ops.prroi import prroi_pool


class ScoreDecoder(nn.Module):
    def __init__(self, num_heads: int = 12, hidden_dim: int = 768, nlayer_head: int = 3,
                 pool_size: int = 4):
        super().__init__()
        self.num_heads, self.hidden_dim, self.pool_size = num_heads, hidden_dim, pool_size
        c = hidden_dim
        self.score_token = nn.Parameter(torch.zeros(1, 1, c))
        self.norm1 = LayerNorm(c, eps=1e-5)
        self.proj_q = nn.ModuleList(Linear(c, c) for _ in range(2))
        self.proj_k = nn.ModuleList(Linear(c, c) for _ in range(2))
        self.proj_v = nn.ModuleList(Linear(c, c) for _ in range(2))
        self.proj = nn.ModuleList(Linear(c, c) for _ in range(2))
        self.norm2 = nn.ModuleList(LayerNorm(c, eps=1e-5) for _ in range(2))
        self.score_head = MLPHead(c, c, 1, nlayer_head)

    def forward(self, search_feat: torch.Tensor, template_feat: torch.Tensor,
                search_box: torch.Tensor) -> torch.Tensor:
        """search_feat (B, h, w, C), template_feat (B, ht, wt, C), search_box
        (B, 4) xyxy normalised to [0, 1]. Returns (B, 1, 1) logits."""
        B, h, w, C = search_feat.shape
        nh, ps = self.num_heads, self.pool_size
        dt = self.proj_q[0].compute_dtype or self.proj_q[0].weight.dtype
        # the reference scales by the full width, not the head width
        scale = self.hidden_dim ** -0.5
        rois = torch.cat([torch.arange(B, dtype=torch.float32, device=search_box.device)[:, None],
                          search_box.float() * w], dim=1)
        box_feat = prroi_pool(search_feat, rois, ps, ps, 1.0).reshape(B, ps * ps, C).to(dt)
        tmpl = template_feat.reshape(B, -1, C)
        x = self.norm1(self.score_token.expand(B, 1, C).to(dt))
        for i, mem in enumerate((box_feat, tmpl)):
            q = self.proj_q[i](x).reshape(B, 1, nh, -1).transpose(1, 2)
            k = self.proj_k[i](mem).reshape(B, -1, nh, q.shape[-1]).transpose(1, 2)
            v = self.proj_v[i](mem).reshape(B, -1, nh, q.shape[-1]).transpose(1, 2)
            attn = torch.matmul(q, k.transpose(-1, -2)) * scale
            attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
            o = torch.matmul(attn, v).transpose(1, 2).reshape(B, 1, C)
            x = self.norm2[i](self.proj[i](o))
        return self.score_head(x)
