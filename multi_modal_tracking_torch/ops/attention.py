"""Asymmetric mixed attention (the MixFormer hot op): kernel K1 and its
plain version.

Tokens are [templates (n_mt); search]; template queries attend only to the
template keys, search queries attend to every key:

    allowed(i, j) = (i >= n_mt) | (j < n_mt)

q is (B, H, Nq, D) and k/v are (B, H, Nk, D); Nq may differ from Nk (the
flagship's cross-modal key layouts carry the other modality's templates).
n_mt = 0 is plain attention of every query over every key; n_mt = Nq = Nk
is plain attention within the templates.

`mixed_attention` runs the hand-written CUDA kernel
(`csrc/mixed_attention.cu`) for CUDA tensors and the plain PyTorch version
`mixed_attention_ref` for CPU tensors, and raises for anything else. There
is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from multi_modal_tracking_torch.ops import _build

NEG_INF = -1e30
_KERNEL_HEAD_DIMS = (16, 32, 64)


def mixed_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        n_mt: int, scale: float) -> torch.Tensor:
    """Plain version: masked scores, f32 row softmax, weighted sum."""
    Nq, Nk = q.shape[2], k.shape[2]
    s = torch.matmul(q, k.transpose(-2, -1)).float() * scale
    rows = torch.arange(Nq, device=q.device)[:, None]
    cols = torch.arange(Nk, device=q.device)[None, :]
    s = s.masked_fill(~((rows >= n_mt) | (cols < n_mt)), NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p, v)


def _check_kernel_args(q, k, v, n_mt):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"mixed_attention: {name} is on {t.device}; "
                             f"q, k and v must all be CPU or all CUDA tensors")
        if t.dtype != torch.float32:
            raise TypeError(f"mixed_attention kernel takes float32, {name} is {t.dtype}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"mixed_attention kernel takes contiguous (B, H, N, D) "
                             f"tensors, {name} is {tuple(t.shape)} "
                             f"contiguous={t.is_contiguous()}")
        if t.data_ptr() % 16:
            raise ValueError(f"mixed_attention kernel needs 16-byte aligned {name}")
    if not q.device == k.device == v.device:
        raise ValueError(f"mixed_attention: q, k, v on {q.device}, {k.device}, {v.device}")
    B, H, Nq, D = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(f"mixed_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not match")
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"mixed_attention kernel takes D in {_KERNEL_HEAD_DIMS}, got {D}")
    if not (0 <= n_mt <= k.shape[2]) or k.shape[2] < 1:
        raise ValueError(f"mixed_attention: need 0 <= n_mt <= Nk and Nk >= 1, "
                         f"got n_mt={n_mt}, Nk={k.shape[2]}")


def mixed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    n_mt: int, scale: float) -> torch.Tensor:
    """(B, H, Nq, D) x (B, H, Nk, D) x2 -> (B, H, Nq, D). CUDA tensors go to
    kernel K1 (each launch counted in `mixed_attention.launches`), CPU
    tensors to `mixed_attention_ref`."""
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return mixed_attention_ref(q, k, v, n_mt, scale)
    _check_kernel_args(q, k, v, n_mt)
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


mixed_attention.launches = 0
