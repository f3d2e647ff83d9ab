"""Asymmetric mixed attention (the MixFormer hot op): kernels K1 (forward)
and K2 (backward) and their plain versions.

Tokens are [templates (n_mt); search]; template queries attend only to the
template keys, search queries attend to every key:

    allowed(i, j) = (i >= n_mt) | (j < n_mt)

q is (B, H, Nq, D) and k/v are (B, H, Nk, D); Nq may differ from Nk (the
flagship's cross-modal key layouts carry the other modality's templates).
n_mt = 0 is plain attention of every query over every key; n_mt = Nq = Nk
is plain attention within the templates.

`mixed_attention` goes through a `torch.autograd.Function` whenever a
gradient is to be taken: its forward runs the
hand-written CUDA kernel K1 (`csrc/mixed_attention.cu`) for CUDA tensors and
`mixed_attention_ref` for CPU tensors; its backward runs K2
(`csrc/mixed_attention_bwd.cu`) for CUDA tensors and
`mixed_attention_bwd_ref` for CPU tensors. Anything else raises. There is
no fallback from a kernel to a plain version.
"""
from __future__ import annotations

import torch

from multi_modal_tracking_torch.ops import _build

NEG_INF = -1e30
_KERNEL_HEAD_DIMS = (16, 32, 64)


def _allowed(n_mt: int, Nq: int, Nk: int, device) -> torch.Tensor:
    rows = torch.arange(Nq, device=device)[:, None]
    cols = torch.arange(Nk, device=device)[None, :]
    return (rows >= n_mt) | (cols < n_mt)


def _probs(q, k, n_mt, scale):
    s = torch.matmul(q, k.transpose(-2, -1))
    s = s.to(torch.promote_types(s.dtype, torch.float32)) * scale
    allowed = _allowed(n_mt, q.shape[2], k.shape[2], q.device)
    return torch.softmax(s.masked_fill(~allowed, NEG_INF), dim=-1), allowed


def mixed_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        n_mt: int, scale: float) -> torch.Tensor:
    """Plain version: masked scores, f32 row softmax, weighted sum."""
    p, _ = _probs(q, k, n_mt, scale)
    return torch.matmul(p.to(v.dtype), v)


def mixed_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            g: torch.Tensor, n_mt: int, scale: float):
    """Plain backward, the explicit formulas of the JAX package's
    `_fused_bwd` (ops/attention.py:189-202): recompute P, then
    dP = g V^T, dS = P o (dP - rowsum(P o dP)) masked and scaled,
    dQ = dS K, dK = dS^T Q, dV = P^T g. Returns (dq, dk, dv)."""
    dtype = q.dtype
    p, allowed = _probs(q, k, n_mt, scale)
    q, k, v, g = (t.to(p.dtype) for t in (q, k, v, g))
    dp = torch.matmul(g, v.transpose(-2, -1))
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    ds = ds.masked_fill(~allowed, 0.0) * scale
    return tuple(t.to(dtype) for t in (torch.matmul(ds, k),
                                       torch.matmul(ds.transpose(-2, -1), q),
                                       torch.matmul(p.transpose(-2, -1), g)))


def _check_kernel_args(tensors, n_mt):
    q, k = tensors["q"], tensors["k"]
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"mixed_attention: {name} is on {t.device}; "
                             f"all tensors must be CPU or all CUDA tensors")
        if t.dtype != torch.float32:
            raise TypeError(f"mixed_attention kernel takes float32, {name} is {t.dtype}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"mixed_attention kernel takes contiguous (B, H, N, D) "
                             f"tensors, {name} is {tuple(t.shape)} "
                             f"contiguous={t.is_contiguous()}")
        if t.data_ptr() % 16:
            raise ValueError(f"mixed_attention kernel needs 16-byte aligned {name}")
        if t.device != q.device:
            raise ValueError(f"mixed_attention: {name} on {t.device}, q on {q.device}")
        like = q if name in ("q", "o", "g") else k
        if t.shape != like.shape:
            raise ValueError(f"mixed_attention: shapes {name} {tuple(t.shape)} and "
                             f"{tuple(like.shape)} do not match")
    B, H, Nq, D = q.shape
    if k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(f"mixed_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"do not match")
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"mixed_attention kernel takes D in {_KERNEL_HEAD_DIMS}, got {D}")
    if not (0 <= n_mt <= k.shape[2]) or k.shape[2] < 1:
        raise ValueError(f"mixed_attention: need 0 <= n_mt <= Nk and Nk >= 1, "
                         f"got n_mt={n_mt}, Nk={k.shape[2]}")


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def mixed_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        n_mt: int, scale: float) -> torch.Tensor:
    """Forward without autograd: kernel K1 for CUDA tensors (each launch
    counted in `mixed_attention.launches`), `mixed_attention_ref` for CPU
    tensors."""
    if _on_cpu(q, k, v):
        return mixed_attention_ref(q, k, v, n_mt, scale)
    _check_kernel_args(dict(q=q, k=k, v=v), n_mt)
    B, H, Nq, D = q.shape
    out = torch.empty_like(q)
    lib = _build.library("mixed_attention")
    err = lib.mixed_attention_fwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B * H, Nq, k.shape[2], D, int(n_mt), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "mixed_attention_fwd_f32")
    mixed_attention.launches += 1
    return out


def mixed_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, g: torch.Tensor, n_mt: int, scale: float):
    """(dq, dk, dv) for the forward output o and its incoming gradient g:
    kernel K2 for CUDA tensors (each launch counted in
    `mixed_attention_bwd.launches`), `mixed_attention_bwd_ref` for CPU
    tensors (which recomputes P and does not need o)."""
    if _on_cpu(q, k, v, o, g):
        return mixed_attention_bwd_ref(q, k, v, g, n_mt, scale)
    _check_kernel_args(dict(q=q, k=k, v=v, o=o, g=g), n_mt)
    B, H, Nq, D = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lse = torch.empty(B * H, Nq, dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    lib = _build.library("mixed_attention_bwd")
    err = lib.mixed_attention_bwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        B * H, Nq, k.shape[2], D, int(n_mt), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "mixed_attention_bwd_f32")
    mixed_attention_bwd.launches += 1
    return dq, dk, dv


class _MixedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, n_mt, scale):
        out = mixed_attention_fwd(q, k, v, n_mt, scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.n_mt, ctx.scale = n_mt, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out = ctx.saved_tensors
        # the model's head merge can hand over a non-contiguous gradient
        dq, dk, dv = mixed_attention_bwd(q, k, v, out, g.contiguous(), ctx.n_mt, ctx.scale)
        return dq, dk, dv, None, None


def mixed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    n_mt: int, scale: float) -> torch.Tensor:
    """(B, H, Nq, D) x (B, H, Nk, D) x2 -> (B, H, Nq, D), differentiable in
    q, k and v: K1 forward and K2 backward on CUDA tensors, the plain
    versions on CPU tensors. n_mt and scale are not differentiated. Without
    a gradient to take (inference) it skips the autograd Function's
    per-call cost."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _MixedAttention.apply(q, k, v, int(n_mt), float(scale))
    return mixed_attention_fwd(q, k, v, int(n_mt), float(scale))


mixed_attention.launches = 0
mixed_attention_bwd.launches = 0
