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
`mixed_attention_ref` for CPU tensors, and on CUDA saves the row
logsumexp; its backward runs K2 (`csrc/mixed_attention_bwd.cu`), which
reads that logsumexp, for CUDA tensors and `mixed_attention_bwd_ref`
(which recomputes P) for CPU tensors.
Anything else raises. There is no fallback from a kernel to a plain
version.

Both kernels run their products on the tensor cores as 3xTF32
(`csrc/tf32_mma.cuh`): f32-accurate, whatever the `allow_tf32` flags say.

bf16 q/k/v (the JAX package's dtype) go to K1-bf16
(`csrc/mixed_attention_bf16.cu`, wgmma on bf16 operands, TMA loads, key
shares chosen by `attention_bf16_plan`) for CUDA tensors and
`mixed_attention_bf16_ref` for CPU tensors, both with the rounding points
of the Pallas kernel at bf16. Under autograd the bf16
forward saves K1-bf16's f32 row logsumexp and the backward runs K2-bf16
(`csrc/mixed_attention_bwd_bf16.cu`) for CUDA tensors and
`mixed_attention_bwd_bf16_ref` for CPU tensors.
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


def _masked_scores(q, k, n_mt, scale):
    s = torch.matmul(q, k.transpose(-2, -1))
    s = s.to(torch.promote_types(s.dtype, torch.float32)) * scale
    allowed = _allowed(n_mt, q.shape[2], k.shape[2], q.device)
    return s.masked_fill(~allowed, NEG_INF), allowed


def _probs(q, k, n_mt, scale):
    s, allowed = _masked_scores(q, k, n_mt, scale)
    return torch.softmax(s, dim=-1), allowed


def mixed_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        n_mt: int, scale: float) -> torch.Tensor:
    """Plain version: masked scores, f32 row softmax, weighted sum."""
    p, _ = _probs(q, k, n_mt, scale)
    return torch.matmul(p.to(v.dtype), v)


def mixed_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, n_mt: int,
                            scale: float) -> torch.Tensor:
    """Plain row logsumexp of the masked, scaled scores, (B, H, Nq) f32:
    what K1 saves for K2."""
    return torch.logsumexp(_masked_scores(q, k, n_mt, scale)[0], dim=-1)


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


def _bf16_scores(q, k, n_mt, scale):
    """Masked scores of bf16 q and k as the Pallas kernel forms them at
    bf16: Q K^T accumulated in f32 (products of bf16 values are exact in
    f32), scaled in f32, masked with NEG_INF; and the allowed mask."""
    s = torch.matmul(q.float(), k.float().transpose(-2, -1)) * scale
    allowed = _allowed(n_mt, q.shape[2], k.shape[2], q.device)
    return s.masked_fill(~allowed, NEG_INF), allowed


def _bf16_probs(q, k, n_mt, scale):
    """The f32 row softmax as the Pallas kernel writes it (max, exp, divide
    by the sum), and the allowed mask."""
    s, allowed = _bf16_scores(q, k, n_mt, scale)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return p / p.sum(dim=-1, keepdim=True), allowed


def mixed_attention_bf16_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             n_mt: int, scale: float) -> torch.Tensor:
    """Plain K1-bf16: bf16 q/k/v -> bf16 output with the rounding points of
    the JAX package's `_attn_kernel` at bf16 (ops/attention.py:44-57):
    S = Q K^T accumulated in f32 (products of bf16 values are exact in f32)
    and scaled in f32, the mask, the row softmax in f32 as the Pallas kernel
    writes it (max, exp, divide by the sum), P rounded to bf16, O = P V
    accumulated in f32, the output rounded to bf16."""
    p, _ = _bf16_probs(q, k, n_mt, scale)
    return torch.matmul(p.to(torch.bfloat16).float(), v.float()).to(torch.bfloat16)


def mixed_attention_bf16_lse_ref(q: torch.Tensor, k: torch.Tensor, n_mt: int,
                                 scale: float) -> torch.Tensor:
    """Plain row logsumexp of bf16 q and k's f32 scores, (B, H, Nq) f32:
    what K1-bf16 saves for K2-bf16."""
    return torch.logsumexp(_bf16_scores(q, k, n_mt, scale)[0], dim=-1)


def mixed_attention_bwd_bf16_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 g: torch.Tensor, n_mt: int, scale: float):
    """Plain K2-bf16: bf16 q/k/v and incoming gradient g -> bf16 (dq, dk,
    dv) with the rounding points of the JAX package's `_attn_bwd_kernel` at
    bf16 (ops/attention.py:91-118): P recomputed in f32 as the forward
    forms it, dP = g V^T accumulated in f32, dS = P o (dP - rowsum(P o dP))
    in f32, masked and scaled; dS rounded to bf16 for dQ = dS K and
    dK = dS^T Q, P rounded to bf16 for dV = P^T g; each product accumulated
    in f32 and rounded to bf16 once."""
    p, allowed = _bf16_probs(q, k, n_mt, scale)
    q, k, v, g = (t.float() for t in (q, k, v, g))
    dp = torch.matmul(g, v.transpose(-2, -1))
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    ds = (ds.masked_fill(~allowed, 0.0) * scale).to(torch.bfloat16).float()
    p = p.to(torch.bfloat16).float()
    return tuple(t.to(torch.bfloat16) for t in (torch.matmul(ds, k),
                                                torch.matmul(ds.transpose(-2, -1), q),
                                                torch.matmul(p.transpose(-2, -1), g)))


def _check_kernel_args(tensors, n_mt, dtype=torch.float32):
    q, k = tensors["q"], tensors["k"]
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"mixed_attention: {name} is on {t.device}; "
                             f"all tensors must be CPU or all CUDA tensors")
        if t.dtype != dtype:
            raise TypeError(f"mixed_attention kernel takes {dtype}, {name} is {t.dtype}")
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


def query_warps(BH: int, Nq: int, n_sm: int) -> int:
    """Warps of 16 query rows per K1 block: the most of 4 and 2 that still
    gives every SM two blocks, else 1. 64 rows at the training shapes
    (B*H 384), 16 or 32 at the tracking shapes (B*H 24)."""
    for nw in (4, 2):
        if BH * -(-Nq // (16 * nw)) >= 2 * n_sm:
            return nw
    return 1


#: rows of K1-bf16's query tile and keys of its key tile (one wgmma each)
BF16_TILE = 64
#: most key shares (consumer warpgroups) per K1-bf16 block: with a fourth,
#: ptxas caps the block's 17 warps at 96 registers a thread, spills and
#: serialises the wgmma chain
BF16_MAX_SPLITS = 3


def attention_bf16_plan(BH: int, Nq: int, Nk: int, n_sm: int) -> int:
    """Key shares per K1-bf16 block of 64 query rows: the fewest of 1 to 3
    that put two consumer warpgroups on every SM (else 3), and never more
    than the 64-key tiles. 1 at the training shapes (B*H 384) and lockstep
    N = 12 (B*H 288); 2 or 3 at the tracking shapes (B*H 24, 48 to 144
    blocks)."""
    blocks = BH * -(-Nq // BF16_TILE)
    splits = next((s for s in range(1, BF16_MAX_SPLITS + 1) if blocks * s >= 2 * n_sm),
                  BF16_MAX_SPLITS)
    return max(1, min(splits, -(-Nk // BF16_TILE)))


def mixed_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        n_mt: int, scale: float, return_lse: bool = False):
    """Forward without autograd: kernel K1 for CUDA tensors (each launch
    counted in `mixed_attention.launches`), `mixed_attention_ref` for CPU
    tensors. With `return_lse` it returns (out, lse), lse the (B, H, Nq)
    row logsumexp (`mixed_attention_lse_ref` on CPU tensors); K1 writes it
    only when asked."""
    if _on_cpu(q, k, v):
        out = mixed_attention_ref(q, k, v, n_mt, scale)
        return (out, mixed_attention_lse_ref(q, k, n_mt, scale)) if return_lse else out
    _check_kernel_args(dict(q=q, k=k, v=v), n_mt)
    B, H, Nq, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Nq, dtype=torch.float32, device=q.device) if return_lse else None
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    lib = _build.library("mixed_attention")
    err = _build.launch(q.device, lib.mixed_attention_fwd_f32,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None,
        B * H, Nq, k.shape[2], D, int(n_mt), float(scale), query_warps(B * H, Nq, n_sm),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "mixed_attention_fwd_f32")
    _build.count_launch(mixed_attention, q.device)
    return (out, lse) if return_lse else out


def _check_lse(lse, q):
    B, H, Nq, _ = q.shape
    if lse is None:
        raise ValueError("mixed_attention backward: the kernel needs the lse that the "
                         "forward returned with return_lse=True")
    if (lse.device != q.device or lse.dtype != torch.float32 or not lse.is_contiguous()
            or tuple(lse.shape) != (B, H, Nq) or lse.data_ptr() % 16):
        raise ValueError(f"mixed_attention backward: lse must be a contiguous, 16-byte "
                         f"aligned float32 ({B}, {H}, {Nq}) tensor on {q.device}, got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}")


def mixed_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, g: torch.Tensor, n_mt: int, scale: float,
                        lse: torch.Tensor | None = None):
    """(dq, dk, dv) for the forward output o, its incoming gradient g and
    the row logsumexp lse that K1 returned: kernel K2 for CUDA tensors (each
    launch counted in `mixed_attention_bwd.launches`; it needs lse and
    raises without it), `mixed_attention_bwd_ref` for CPU tensors (which
    recomputes P and needs neither o nor lse)."""
    if _on_cpu(q, k, v, o, g):
        return mixed_attention_bwd_ref(q, k, v, g, n_mt, scale)
    _check_kernel_args(dict(q=q, k=k, v=v, o=o, g=g), n_mt)
    B, H, Nq, D = q.shape
    _check_lse(lse, q)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(B * H, Nq, dtype=torch.float32, device=q.device)
    lib = _build.library("mixed_attention_bwd")
    err = _build.launch(q.device, lib.mixed_attention_bwd_f32,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.data_ptr(), lse.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
        B * H, Nq, k.shape[2], D, int(n_mt), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "mixed_attention_bwd_f32")
    _build.count_launch(mixed_attention_bwd, q.device)
    return dq, dk, dv


def _check_bf16(**tensors):
    for name, t in tensors.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"mixed_attention bf16 kernels take bfloat16, {name} is {t.dtype}")


def mixed_attention_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         n_mt: int, scale: float, return_lse: bool = False):
    """bf16 forward without autograd: kernel K1-bf16 for CUDA tensors (each
    launch counted in `mixed_attention_bf16.launches`),
    `mixed_attention_bf16_ref` for CPU tensors. q, k and v must all be
    bf16; the kernel takes the f32 kernel's shapes (D in
    `_KERNEL_HEAD_DIMS`) and raises on others. With `return_lse` it returns
    (out, lse), lse the (B, H, Nq) f32 row logsumexp of the f32 scores
    (`mixed_attention_bf16_lse_ref` on CPU tensors); K1-bf16 writes it only
    when asked, and its output is the same either way."""
    _check_bf16(q=q, k=k, v=v)
    if _on_cpu(q, k, v):
        out = mixed_attention_bf16_ref(q, k, v, n_mt, scale)
        return (out, mixed_attention_bf16_lse_ref(q, k, n_mt, scale)) if return_lse else out
    _check_kernel_args(dict(q=q, k=k, v=v), n_mt, torch.bfloat16)
    B, H, Nq, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Nq, dtype=torch.float32, device=q.device) if return_lse else None
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    lib = _build.library("mixed_attention_bf16")
    err = _build.launch(q.device, lib.mixed_attention_fwd_bf16,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None,
        B * H, Nq, k.shape[2], D, int(n_mt), float(scale),
        attention_bf16_plan(B * H, Nq, k.shape[2], n_sm),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "mixed_attention_fwd_bf16")
    _build.count_launch(mixed_attention_bf16, q.device)
    return (out, lse) if return_lse else out


def mixed_attention_bwd_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             g: torch.Tensor, n_mt: int, scale: float,
                             lse: torch.Tensor | None = None):
    """bf16 (dq, dk, dv) for the bf16 incoming gradient g of the forward
    output and the f32 row logsumexp lse that K1-bf16 returned: kernel
    K2-bf16 for CUDA tensors (each launch counted in
    `mixed_attention_bwd_bf16.launches`; it needs lse and raises without
    it), `mixed_attention_bwd_bf16_ref` for CPU tensors (which recomputes P
    and needs no lse). Neither reads the forward output: Delta =
    rowsum(P o dP) is summed from the f32 P and dP, as the Pallas kernel
    does (PERF.md §6)."""
    _check_bf16(q=q, k=k, v=v, g=g)
    if _on_cpu(q, k, v, g):
        return mixed_attention_bwd_bf16_ref(q, k, v, g, n_mt, scale)
    _check_kernel_args(dict(q=q, k=k, v=v, g=g), n_mt, torch.bfloat16)
    _check_lse(lse, q)
    B, H, Nq, D = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(B * H, Nq, dtype=torch.float32, device=q.device)
    lib = _build.library("mixed_attention_bwd_bf16")
    err = _build.launch(q.device, lib.mixed_attention_bwd_bf16,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
        B * H, Nq, k.shape[2], D, int(n_mt), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "mixed_attention_bwd_bf16")
    _build.count_launch(mixed_attention_bwd_bf16, q.device)
    return dq, dk, dv


class _MixedAttention(torch.autograd.Function):
    """K1 forward and K2 backward, or with `bf16` K1-bf16 and K2-bf16. Only
    the kernels read the logsumexp: the CPU backward recomputes P. Only K2
    reads the forward output, so only the f32 forward saves it."""

    @staticmethod
    def forward(ctx, q, k, v, n_mt, scale, bf16):
        with_lse = not _on_cpu(q, k, v)
        fwd = mixed_attention_bf16 if bf16 else mixed_attention_fwd
        out = fwd(q, k, v, n_mt, scale, return_lse=with_lse)
        out, lse = out if with_lse else (out, None)
        ctx.save_for_backward(*((q, k, v, lse) if bf16 else (q, k, v, out, lse)))
        ctx.n_mt, ctx.scale, ctx.bf16 = n_mt, scale, bf16
        return out

    @staticmethod
    def backward(ctx, g):
        # the model's head merge can hand over a non-contiguous gradient
        g = g.contiguous()
        if ctx.bf16:
            q, k, v, lse = ctx.saved_tensors
            dq, dk, dv = mixed_attention_bwd_bf16(q, k, v, g, ctx.n_mt, ctx.scale, lse)
        else:
            q, k, v, out, lse = ctx.saved_tensors
            dq, dk, dv = mixed_attention_bwd(q, k, v, out, g, ctx.n_mt, ctx.scale, lse)
        return dq, dk, dv, None, None, None


def mixed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    n_mt: int, scale: float) -> torch.Tensor:
    """(B, H, Nq, D) x (B, H, Nk, D) x2 -> (B, H, Nq, D), differentiable in
    q, k and v: K1 forward and K2 backward on CUDA tensors, the plain
    versions on CPU tensors. n_mt and scale are not differentiated. Without
    a gradient to take (inference) it skips the autograd Function's
    per-call cost. bf16 q/k/v go to `mixed_attention_bf16`, and under
    autograd to K1-bf16 and K2-bf16."""
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    bf16 = torch.bfloat16 in (q.dtype, k.dtype, v.dtype)
    if grad:
        return _MixedAttention.apply(q, k, v, int(n_mt), float(scale), bf16)
    if bf16:
        return mixed_attention_bf16(q, k, v, int(n_mt), float(scale))
    return mixed_attention_fwd(q, k, v, int(n_mt), float(scale))


mixed_attention.launches = 0
mixed_attention_bf16.launches = 0
mixed_attention_bwd.launches = 0
mixed_attention_bwd_bf16.launches = 0
