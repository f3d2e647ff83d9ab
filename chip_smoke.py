"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:
  1. device   - requires CUDA, prints the card's name and power limit,
                turns TF32 off;
  2. build    - compiles every kernel of the main paths from csrc/ (one nvcc
                per source, all at once), then one short untimed profiler
                session (`warm_profiler`);
  3. kernels  - each kernel (K1, K2 mixed-attention forward/backward, K3, K4
                MSDA forward/backward) against its plain PyTorch version on
                the card at the main paths' shapes (and narrow and ragged
                edge cases), K1's saved logsumexp included and fed to K2,
                timed on the device (torch.profiler) and with CUDA events,
                beside the plain version, a PyTorch library yardstick where
                one call computes the same function (and the ratio of the
                kernel's time to it), and the card's bound: K1 and K2 run
                3xTF32 on the tensor cores, so their bound_ms is at
                495 / 3 = 165 TFLOP/s, with the f32 CUDA-core bound at
                67 TFLOP/s beside it as bound_f32_ms;
  4. model    - the full-width asymmetric_shared_ce recipe (seeded random
                weights): cached path (set_online + forward_track) against
                the full forward, and the GPU run against the same model on
                the CPU (plain versions) on the same crops;
  5. tracker  - create_tracker -> initialize -> track over a seeded
                synthetic 512x640 RGB-T sequence (64 frames, update interval
                25), with every kernel's launch count read over that run;
  6. profile  - where a frame's time goes: each layer on the host clock, and
                a torch.profiler trace of 10 more frames for the device's busy
                time, idle share, operations per frame and top kernels;
  7. train    - Trainer on the full-width recipe at batch 16 on SyntheticRGBT:
                an epoch of steps at epoch 1 (keep 1.0) and one at epoch 51
                (keep 0.7, bucketised to 240/324), launch counts per step;
                step time, samples/s, host data time, device busy time and
                idle share, peak memory, loss per step; and one full-width
                step at batch 2 (dropout and drop path off) on the GPU held
                against the same step on the CPU.
Then the kernel table line and, last, {"ok": true, "device": {...}}.

Tolerances (f32 everywhere, TF32 off for cuBLAS and cuDNN):
  * kernels: 2e-5 abs or 1e-4 rel (K1 and its logsumexp, K2, K3). Both sides
    are f32 sums of the same terms in another order; K1 and K2 form their
    products as 3xTF32, which drops only the small*small term (~2^-22 of a
    product), and sum long reductions tile by tile (tf32_mma.cuh); measured
    differences are up to ~6e-6. One TF32 pass would give 3e-4 to 6e-4
    and fail (tests/test_torch_port_attention_lse.py). K4:
    1e-5 of each output's largest magnitude or 1e-4 rel; it sums dValue with
    atomics in an order that changes from run to run, and dLoc (a factor W
    or H times sums of D products) reaches ~1e3. A wrong mask, tap or
    coordinate gives errors of order 1e-2 of the output or more.
  * model boxes (normalised to [0, 1]): 1e-4, i.e. 0.03 px at 288. The paths
    compared use other key orders, GEMM shapes and CPU vs GPU kernels
    through 12 blocks, 2 fusion layers and the head.
  * train step, GPU vs CPU (loss and grad norm 1e-3 rel; gradients, with G
    the global grad norm): all gradients together within 1e-2 G, each
    tensor within 5e-2 of its own norm + 1e-6 G, each element within 1e-1
    of its tensor's largest gradient + 1e-6 G. The bounds of
    tests/test_torch_port_train_step.py (the port against JAX on the CPU),
    where the reasons are written out: ReLU and MSDA's corner choice switch
    where an input crosses 0 or a pixel centre, so rounding flips a few
    switches; gradients that are exactly zero (conv biases before a BN) come
    out as rounding noise.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12         # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12             # f32 outside the tensor cores
H100_TF32X3_FLOPS = 495e12 / 3     # f32-accurate products as 3 TF32 MMAs (K1, K2)
KERNEL_TOL = dict(atol=2e-5, rtol=1e-4)
BOX_TOL = 1e-4
SCRIPT, RECIPE = "asymmetric_shared_ce", "attention_lasher_newfusion_2layer"
# the recipe's backbone attention shapes: search lengths per block after CE
# at blocks 3/6/9 (keep 0.7): 4 blocks at 324, 3 at 227, 3 at 159, 2 at 112
CE_LENGTHS = ((324, 4), (227, 3), (159, 3), (112, 2))
N_MT = 128                         # 2 templates x 8x8 tokens per modality
B2, HEADS, HEAD_D = 2, 12, 64      # both modalities on the batch axis
TRAIN_B = 16                       # the recipe's batch; 2 x 16 on the batch axis
TRAIN_STEPS = 3                    # steps per epoch in the train phase
KEEP_FINAL = 240 / 324             # keep 0.7 bucketised to a multiple of 16
MSDA_SHAPES = ((18, 18), (18, 18))  # the fusion's two modal 18x18 maps
M_HEADS, M_D, M_L, M_P = 8, 64, 2, 4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, names=None, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call of fn from a torch.profiler trace of `iters`
    calls: the summed durations of the kernels whose names contain one of
    `names` (None: every kernel, copy and memset)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e - s for s, e, n in _device_intervals(prof)
                if names is None or any(k in n for k in names))
    require(total > 0, f"the profiler saw no device time for {names}")
    return total / iters / 1e3


def warm_profiler() -> None:
    """One short profiler session before any timing. The first session of
    a process starts CUPTI's tracing, and a timed first session has once
    recorded no kernel at all; later sessions record every kernel."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1 << 20, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            x.mul_(1.0)
        torch.cuda.synchronize()
    emit({"phase": "profiler warm-up", "device_events": len(_device_intervals(prof))})


def bound_ms(n_bytes: float, flops: float, rate: float = H100_F32_FLOPS):
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got: torch.Tensor, want: torch.Tensor, tol=KERNEL_TOL):
    """(max abs error, max rel error over |want| >= 1e-3, within tol)."""
    diff = (got - want).abs()
    ok = bool((diff <= tol["atol"] + tol["rtol"] * want.abs()).all())
    big = want.abs() >= 1e-3
    return float(diff.max()), float((diff[big] / want.abs()[big]).max()), ok


def max_err_scaled(got, want):
    """K4's tolerance: 1e-5 of the output's largest magnitude, or 1e-4 rel."""
    return max_err(got, want, dict(atol=1e-5 * max(1.0, float(want.abs().max())), rtol=1e-4))


def _sum_rows(rows, weight_key):
    """Per-step or per-frame totals of per-launch numbers."""
    out = {}
    for key in ("ms", "event_ms", "plain_ms", "library_ms", "bytes", "flops"):
        if all(r.get(key) is not None for r in rows):
            out[key] = sum(r[weight_key] * r[key] for r in rows)
    return out


# ------------------------------------------------------------------ phases
def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run needs "
              "an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
               count=torch.cuda.device_count())
    emit({"phase": "device", "nvidia_smi": smi, **dev, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return dev, smi


def phase_build():
    from multi_modal_tracking_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build()
    secs = time.perf_counter() - t0
    require(set(logs) >= {"mixed_attention", "mixed_attention_bwd", "msda", "msda_bwd"},
            f"built {sorted(logs)}")
    ptxas = {name: [ln.strip() for ln in log.splitlines() if "registers" in ln]
             for name, log in logs.items()}
    emit({"phase": "build", "seconds": round(secs, 3), "ptxas": ptxas})


def _qkv(B, H, Nq, Nk, D, g):
    return (torch.randn(B, H, Nq, D, generator=g).cuda(),
            torch.randn(B, H, Nk, D, generator=g).cuda(),
            torch.randn(B, H, Nk, D, generator=g).cuda())


def _allowed(Nq, Nk, n_mt):
    rows = torch.arange(Nq, device="cuda")[:, None]
    cols = torch.arange(Nk, device="cuda")[None, :]
    return (rows >= n_mt) | (cols < n_mt)


def _pairs(Nq, Nk, n_mt):
    """Allowed (query, key) pairs of the mask."""
    return (Nq - n_mt) * Nk + n_mt * min(n_mt, Nk) if n_mt else Nq * Nk


def train_attention_lengths(keep):
    """(Nq, calls per training step) of the full forward at a keep rate:
    Nq = n_mt + the search tokens left at each block, Nk = Nq + n_mt."""
    from multi_modal_tracking_torch.models.asymmetric_shared import ce_keep_schedule
    keeps, _ = ce_keep_schedule(324, 12, (3, 6, 9), (0.7, 0.7, 0.7), keep)
    lengths, cur = [], 324
    for k in keeps:
        lengths.append(N_MT + cur)
        cur = k if k is not None else cur
    return [(n, lengths.count(n)) for n in sorted(set(lengths), reverse=True)]


def _attn_bounds(n_bytes, flops):
    """K1/K2 rows: the bound at the 3xTF32 rate and the f32 CUDA-core one."""
    b_ms, b_by = bound_ms(n_bytes, flops, H100_TF32X3_FLOPS)
    return dict(bound_ms=b_ms, bound_by=b_by, bound_f32_ms=bound_ms(n_bytes, flops)[0])


def kernel_k1(g):
    import torch.nn.functional as F
    from multi_modal_tracking_torch.ops.attention import (mixed_attention_fwd,
                                                          mixed_attention_lse_ref,
                                                          mixed_attention_ref)

    scale = HEAD_D ** -0.5
    # (form, batch, Nq, Nk, n_mt, calls per tracked frame, calls per training step)
    cases = [("template_step", B2, N_MT, N_MT, 0, 0, 0)]
    cases += [("search_step", B2, L, L + 2 * N_MT, 0, n, 0) for L, n in CE_LENGTHS]
    cases += [("full_forward", B2, N_MT + L, 2 * N_MT + L, N_MT, 0, 0) for L, _ in CE_LENGTHS]
    cases += [("train_forward", 2 * TRAIN_B, n, n + N_MT, N_MT, 0, c)
              for n, c in train_attention_lengths(KEEP_FINAL)]
    rows, err_max = [], 0.0
    for form, B, Nq, Nk, n_mt, calls, step_calls in cases:
        q, k, v = _qkv(B, HEADS, Nq, Nk, HEAD_D, g)
        with_lse = form == "train_forward"     # the training forward saves lse for K2
        got = mixed_attention_fwd(q, k, v, n_mt, scale, return_lse=with_lse)
        want = mixed_attention_ref(q, k, v, n_mt, scale)
        err, rel, ok = max_err(got[0] if with_lse else got, want)
        require(ok, f"K1 {form} Nq={Nq} Nk={Nk} n_mt={n_mt} disagrees with its plain "
                    f"version: max abs err {err}")
        lse_err = None
        if with_lse:
            lse_err, _, ok = max_err(got[1], mixed_attention_lse_ref(q, k, n_mt, scale))
            require(ok, f"K1 {form} Nq={Nq} Nk={Nk} n_mt={n_mt}: lse disagrees with "
                        f"mixed_attention_lse_ref: max abs err {lse_err}")
        err_max = max(err_max, err, lse_err or 0.0)
        mask = _allowed(Nq, Nk, n_mt)
        kern = lambda: mixed_attention_fwd(q, k, v, n_mt, scale, return_lse=with_lse)  # noqa: E731
        lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,  # noqa: E731
                                                     scale=scale)
        n_bytes = 4 * B * HEADS * HEAD_D * (2 * Nq + 2 * Nk)
        flops = 4 * B * HEADS * HEAD_D * _pairs(Nq, Nk, n_mt)
        row = dict(form=form, B=B, Nq=Nq, Nk=Nk, n_mt=n_mt, calls_per_frame=calls,
                   calls_per_step=step_calls, max_abs_err=err, max_rel_err=rel,
                   lse_max_abs_err=lse_err,
                   ms=device_ms(kern, ["mixed_attention_fwd_kernel"]),
                   event_ms=cuda_time_ms(kern),
                   plain_ms=cuda_time_ms(lambda: mixed_attention_ref(q, k, v, n_mt, scale)),
                   library_ms=device_ms(lib), bytes=n_bytes, flops=flops,
                   **_attn_bounds(n_bytes, flops))
        row["library_ratio"] = row["ms"] / row["library_ms"]
        rows.append(row)
    emit({"phase": "kernels", "kernel": "K1 mixed_attention_fwd", "tolerance": KERNEL_TOL,
          "cases": rows})
    return rows, err_max


def kernel_k2(g):
    """K2 at the training shapes (B 2 x 16, H 12, D 64, n_mt 128): the no-CE
    length and the bucketised CE lengths at the final keep."""
    import torch.nn.functional as F
    from multi_modal_tracking_torch.ops.attention import (mixed_attention_bwd,
                                                          mixed_attention_bwd_ref,
                                                          mixed_attention_fwd)
    scale = HEAD_D ** -0.5
    B = 2 * TRAIN_B
    rows, err_max = [], 0.0
    for Nq, calls in train_attention_lengths(KEEP_FINAL):
        Nk, n_mt = Nq + N_MT, N_MT
        q, k, v = _qkv(B, HEADS, Nq, Nk, HEAD_D, g)
        gr = torch.randn(B, HEADS, Nq, HEAD_D, generator=g).cuda()
        o, lse = mixed_attention_fwd(q, k, v, n_mt, scale, return_lse=True)
        got = mixed_attention_bwd(q, k, v, o, gr, n_mt, scale, lse)
        want = mixed_attention_bwd_ref(q, k, v, gr, n_mt, scale)
        errs = [max_err(a, b) for a, b in zip(got, want)]
        require(all(e[2] for e in errs), f"K2 Nq={Nq} Nk={Nk} disagrees with its plain "
                                         f"version: max abs errs {[e[0] for e in errs]}")
        err = max(e[0] for e in errs)
        err_max = max(err_max, err)
        kern = lambda: mixed_attention_bwd(q, k, v, o, gr, n_mt, scale, lse)  # noqa: E731
        mask = _allowed(Nq, Nk, n_mt)
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))

        def sdpa_fwd():
            return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, scale=scale)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa_fwd(), (qs, ks, vs), gr)
        n_bytes = 4 * B * HEADS * HEAD_D * (4 * Nq + 4 * Nk)
        flops = 10 * B * HEADS * HEAD_D * _pairs(Nq, Nk, n_mt)
        row = dict(B=B, Nq=Nq, Nk=Nk, n_mt=n_mt, calls_per_step=calls,
                   max_abs_err=err, max_abs_err_dq_dk_dv=[e[0] for e in errs],
                   max_rel_err=max(e[1] for e in errs), ms=device_ms(kern, ["attn_bwd_"]),
                   event_ms=cuda_time_ms(kern, iters=20),
                   plain_ms=cuda_time_ms(
                       lambda: mixed_attention_bwd_ref(q, k, v, gr, n_mt, scale), iters=10),
                   library_ms=device_ms(sdpa_fwd_bwd) - device_ms(sdpa_fwd),
                   bytes=n_bytes, flops=flops, **_attn_bounds(n_bytes, flops))
        row["library_ratio"] = row["ms"] / row["library_ms"]
        rows.append(row)
    emit({"phase": "kernels", "kernel": "K2 mixed_attention_bwd", "tolerance": KERNEL_TOL,
          "library": "scaled_dot_product_attention with the boolean mask: fwd+bwd minus fwd",
          "cases": rows})
    return rows, err_max


def _msda_inputs(B, shapes, Lq, M, D, P, g, lo=-0.2, hi=1.2):
    S = sum(h * w for h, w in shapes)
    value = torch.randn(B, S, M, D, generator=g).cuda()
    loc = (torch.rand(B, Lq, M, len(shapes), P, 2, generator=g) * (hi - lo) + lo).cuda()
    attw = torch.softmax(torch.randn(B, Lq, M, len(shapes) * P, generator=g), -1) \
        .reshape(B, Lq, M, len(shapes), P).cuda()
    return value, loc, attw


def _live_corners(loc, shapes):
    """Corner taps inside their map: the work the data needs."""
    n = 0
    for lid, (H, W) in enumerate(shapes):
        x = torch.floor(loc[:, :, :, lid, :, 0] * W - 0.5)
        y = torch.floor(loc[:, :, :, lid, :, 1] * H - 0.5)
        n += sum(int(((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)).sum())
                 for xi in (x, x + 1) for yi in (y, y + 1))
    return n


def kernel_k3(g):
    from multi_modal_tracking_torch.ops.msda import ms_deform_attn_fwd, ms_deform_attn_ref
    rows, err_max = [], 0.0
    S = Lq = 648
    for B in (1, TRAIN_B):
        value, loc, attw = _msda_inputs(B, MSDA_SHAPES, Lq, M_HEADS, M_D, M_P, g, -0.1, 1.1)
        got = ms_deform_attn_fwd(value, MSDA_SHAPES, loc, attw)
        err, rel, ok = max_err(got, ms_deform_attn_ref(value, MSDA_SHAPES, loc, attw))
        require(ok, f"K3 B={B} disagrees with its plain version: max abs err {err}")
        err_max = max(err_max, err)
        kern = lambda: ms_deform_attn_fwd(value, MSDA_SHAPES, loc, attw)   # noqa: E731
        flops = 2.0 * M_D * _live_corners(loc, MSDA_SHAPES)
        n_bytes = 4 * (value.numel() + loc.numel() + attw.numel() + got.numel())
        b_ms, b_by = bound_ms(n_bytes, flops)
        rows.append(dict(B=B, S=S, Lq=Lq, M=M_HEADS, D=M_D, L=M_L, P=M_P, max_abs_err=err,
                         max_rel_err=rel, ms=device_ms(kern, ["msda_fwd_kernel"]),
                         event_ms=cuda_time_ms(kern),
                         plain_ms=cuda_time_ms(
                             lambda: ms_deform_attn_ref(value, MSDA_SHAPES, loc, attw), iters=10),
                         library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=n_bytes,
                         flops=flops, calls_per_frame=2 if B == 1 else 0,
                         calls_per_step=2 if B == TRAIN_B else 0))
    emit({"phase": "kernels", "kernel": "K3 ms_deform_attn_fwd", "tolerance": KERNEL_TOL,
          "cases": rows})
    return rows, err_max


def kernel_k4(g):
    from multi_modal_tracking_torch.ops.msda import ms_deform_attn_bwd, ms_deform_attn_bwd_ref
    rows, err_max = [], 0.0
    cases = [(TRAIN_B, MSDA_SHAPES, 648, M_HEADS, M_D, M_P), (1, MSDA_SHAPES, 648, M_HEADS, M_D, M_P),
             (2, ((6, 7), (5, 4), (3, 3)), 30, 4, 32, 4)]
    for B, shapes, Lq, M, D, P in cases:
        value, loc, attw = _msda_inputs(B, shapes, Lq, M, D, P, g)
        gr = torch.randn(B, Lq, M * D, generator=g).cuda()
        got = ms_deform_attn_bwd(value, shapes, loc, attw, gr)
        want = ms_deform_attn_bwd_ref(value, shapes, loc, attw, gr)
        errs = [max_err_scaled(a, b) for a, b in zip(got, want)]
        require(all(e[2] for e in errs), f"K4 {(B, shapes, Lq, M, D, P)} disagrees with its "
                                         f"plain version: max abs errs {[e[0] for e in errs]}")
        err = max(e[0] for e in errs)
        err_max = max(err_max, err)
        kern = lambda: ms_deform_attn_bwd(value, shapes, loc, attw, gr)   # noqa: E731
        live = _live_corners(loc, shapes)
        n_bytes = 4 * 2 * (value.numel() + loc.numel() + attw.numel()) + 4 * gr.numel()
        b_ms, b_by = bound_ms(n_bytes, 4.0 * D * live)
        rows.append(dict(B=B, shapes=[list(s) for s in shapes], Lq=Lq, M=M, D=D, P=P,
                         max_abs_err=err, max_abs_err_by_output=[e[0] for e in errs],
                         ms=device_ms(kern, ["msda_bwd_kernel"]), event_ms=cuda_time_ms(kern),
                         plain_ms=cuda_time_ms(
                             lambda: ms_deform_attn_bwd_ref(value, shapes, loc, attw, gr),
                             iters=5, warmup=1),
                         library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=n_bytes,
                         flops=4.0 * D * live, calls_per_step=2 if B == TRAIN_B else 0))
    emit({"phase": "kernels", "kernel": "K4 ms_deform_attn_bwd",
          "tolerance": "1e-5 of each output's largest magnitude, or 1e-4 rel", "cases": rows})
    return rows, err_max


# (B, H, Nq, Nk, D, n_mt) of K1/K2's edge cases: n_mt 0, inside a tile, = Nq =
# Nk; Nq != Nk; one query row, Nq 17 and 33 past 16-row tiles, Nk 9 inside a
# 32-key tile, n_mt 8 inside a 16-row tile, at D 16/32/64; the last one is
# large enough to take 64-row K1 blocks (the others take 16)
ATTN_EDGES = [(2, 3, 40, 64, 16, 8), (2, 2, 70, 100, 32, 37), (1, 2, 5, 7, 16, 5),
              (1, 2, 131, 197, 64, 65), (2, 3, 40, 40, 16, 40), (1, 2, 30, 70, 32, 0),
              (1, 2, 1, 9, 16, 0), (1, 2, 1, 9, 64, 8), (2, 3, 17, 9, 16, 8),
              (1, 2, 17, 33, 32, 8), (2, 2, 33, 9, 64, 8), (1, 3, 33, 41, 32, 33),
              (32, 12, 70, 100, 64, 37)]


def kernel_edges(g):
    """Narrow widths and ragged tiles for K1 (with its lse), K2 and K3."""
    from multi_modal_tracking_torch.ops.attention import (mixed_attention_bwd,
                                                          mixed_attention_bwd_ref,
                                                          mixed_attention_fwd,
                                                          mixed_attention_lse_ref,
                                                          mixed_attention_ref)
    from multi_modal_tracking_torch.ops.msda import ms_deform_attn_fwd, ms_deform_attn_ref
    edge = []
    for (B, H, Nq, Nk, D, n_mt) in ATTN_EDGES:
        q, k, v = _qkv(B, H, Nq, Nk, D, g)
        gr = torch.randn(B, H, Nq, D, generator=g).cuda()
        o_only = mixed_attention_fwd(q, k, v, n_mt, D ** -0.5)
        o, lse = mixed_attention_fwd(q, k, v, n_mt, D ** -0.5, return_lse=True)
        require(torch.equal(o, o_only), f"K1 edge case {(B, H, Nq, Nk, D, n_mt)}: output "
                                        f"depends on whether lse is written")
        err, _, ok = max_err(o, mixed_attention_ref(q, k, v, n_mt, D ** -0.5))
        require(ok, f"K1 edge case {(B, H, Nq, Nk, D, n_mt)}: max abs err {err}")
        lse_err, _, ok = max_err(lse, mixed_attention_lse_ref(q, k, n_mt, D ** -0.5))
        require(ok, f"K1 edge case {(B, H, Nq, Nk, D, n_mt)}: lse max abs err {lse_err}")
        edge.append(dict(kernel="K1", shape=[B, H, Nq, Nk, D, n_mt], max_abs_err=err,
                         lse_max_abs_err=lse_err))
        errs = [max_err(a, b) for a, b in zip(
            mixed_attention_bwd(q, k, v, o, gr, n_mt, D ** -0.5, lse),
            mixed_attention_bwd_ref(q, k, v, gr, n_mt, D ** -0.5))]
        require(all(e[2] for e in errs), f"K2 edge case {(B, H, Nq, Nk, D, n_mt)}: "
                                         f"max abs errs {[e[0] for e in errs]}")
        edge.append(dict(kernel="K2", shape=[B, H, Nq, Nk, D, n_mt],
                         max_abs_err=max(e[0] for e in errs)))
    for (B, shp, Lq, M, D, P) in [(2, ((9, 12), (5, 7)), 17, 2, 8, 3),
                                  (1, ((6, 7), (5, 4), (3, 3)), 30, 4, 32, 4)]:
        value, loc, attw = _msda_inputs(B, shp, Lq, M, D, P, g)
        err, _, ok = max_err(ms_deform_attn_fwd(value, shp, loc, attw),
                             ms_deform_attn_ref(value, shp, loc, attw))
        require(ok, f"K3 edge case {(B, shp, Lq, M, D, P)}: max abs err {err}")
        edge.append(dict(kernel="K3", shape=[B, shp, Lq, M, D, P], max_abs_err=err))
    torch.cuda.synchronize()
    emit({"phase": "kernels", "kernel": "edge cases", "cases": edge})


def phase_kernels(g: torch.Generator) -> dict:
    """Every kernel against its plain version; per-frame (K1, K3: the
    tracked frame's launches) and per-step (K2, K4: a training step at the
    final keep) totals for the kernel table."""
    k1_rows, k1_err = kernel_k1(g)
    k2_rows, k2_err = kernel_k2(g)
    k3_rows, k3_err = kernel_k3(g)
    k4_rows, k4_err = kernel_k4(g)
    kernel_edges(g)
    table = {}
    for key, name, src, repl, rows, err, weight in (
            ("K1", "mixed_attention_fwd (K1)", "mixed_attention.cu", "attention.py:44",
             k1_rows, k1_err, "calls_per_frame"),
            ("K2", "mixed_attention_bwd (K2)", "mixed_attention_bwd.cu", "attention.py:91",
             k2_rows, k2_err, "calls_per_step"),
            ("K3", "msda_fwd (K3)", "msda.cu", "msda.py:171", k3_rows, k3_err,
             "calls_per_frame"),
            ("K4", "msda_bwd (K4)", "msda_bwd.cu", "msda.py:301", k4_rows, k4_err,
             "calls_per_step")):
        tot = _sum_rows(rows, weight)
        if key in ("K1", "K2"):
            bounds = _attn_bounds(tot["bytes"], tot["flops"])
        else:
            b_ms, b_by = bound_ms(tot["bytes"], tot["flops"])
            bounds = dict(bound_ms=b_ms, bound_by=b_by, bound_f32_ms=b_ms)
        lib_ms = tot.get("library_ms")
        table[key] = dict(name=name, route="cuda", source=f"multi_modal_tracking_torch/csrc/{src}",
                          replaces=f"multi_modal_tracking_tpu/ops/{repl}", max_abs_err=err,
                          ms=tot["ms"], event_ms=tot["event_ms"], plain_ms=tot["plain_ms"],
                          library_ms=lib_ms, library_ratio=tot["ms"] / lib_ms if lib_ms else None,
                          per="tracked frame" if weight == "calls_per_frame" else "training step",
                          **bounds)
    # K1 and K3 also run in every training step: their device ms per step
    k1_step = _sum_rows(k1_rows, "calls_per_step")
    table["K1"]["train_step_ms"] = k1_step["ms"]
    table["K1"]["train_step_library_ms"] = k1_step["library_ms"]
    table["K3"]["train_step_ms"] = _sum_rows(k3_rows, "calls_per_step")["ms"]
    return table


def _params():
    from multi_modal_tracking_torch.eval.params import get_parameters
    return get_parameters("asymmetric_shared_ce", "attention_lasher_newfusion_2layer")


def phase_model(g: torch.Generator) -> None:
    from multi_modal_tracking_torch.models.build import build_model
    params = _params()
    model = build_model(params.script, params.cfg, device="cuda", seed=0)
    ts, ss = params.cfg.DATA.TEMPLATE.SIZE, params.cfg.DATA.SEARCH.SIZE
    t = torch.randn(2, ts, ts, 3, generator=g)
    ot = torch.randn(2, ts, ts, 3, generator=g)
    s = torch.randn(2, ss, ss, 3, generator=g)
    with torch.no_grad():
        tc, otc, sc = t.cuda(), ot.cuda(), s.cuda()
        full = model(tc, otc, sc, use_ce_template_mask=False)["pred_boxes"]
        cache = model.set_online(tc, otc)
        cached = model.forward_track(cache, sc, use_ce_template_mask=False)["pred_boxes"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            model.forward_track(cache, sc, use_ce_template_mask=False)
        torch.cuda.synchronize()
        track_ms = (time.perf_counter() - t0) / 10 * 1e3
        t0 = time.perf_counter()
        for _ in range(10):
            model(tc, otc, sc, use_ce_template_mask=False)
        torch.cuda.synchronize()
        full_ms = (time.perf_counter() - t0) / 10 * 1e3
    cpu_model = build_model(params.script, params.cfg, device="cpu", seed=0)
    with torch.no_grad():
        cpu_cached = cpu_model.forward_track(cpu_model.set_online(t, ot), s,
                                             use_ce_template_mask=False)["pred_boxes"]
    full, cached = full.cpu(), cached.cpu()
    d_cached = float((cached - full).abs().max())
    d_cpu = float((cached - cpu_cached).abs().max())
    require(tuple(full.shape) == (1, 1, 4) and bool(torch.isfinite(full).all()),
            f"model output {tuple(full.shape)} not finite (1, 1, 4)")
    require(d_cached <= BOX_TOL, f"cached path differs from the full forward by {d_cached}")
    require(d_cpu <= BOX_TOL, f"GPU forward_track differs from the CPU one by {d_cpu}")
    emit({"phase": "model", "recipe": "asymmetric_shared_ce/attention_lasher_newfusion_2layer",
          "params": sum(p.numel() for p in model.parameters()),
          "pred_boxes": full.reshape(-1).tolist(), "cached_vs_full_max_abs": d_cached,
          "gpu_vs_cpu_max_abs": d_cpu, "tolerance": BOX_TOL,
          "forward_track_ms": track_ms, "forward_ms": full_ms})


def _sequence(n, H=512, W=640, seed=0):
    """Textured noise with a bright moving 48x48 square; replicated-gray TIR."""
    rng = np.random.default_rng(seed)
    for t in range(n):
        fv = rng.integers(0, 120, (H, W, 3), dtype=np.uint8)
        fi = rng.integers(0, 120, (H, W, 1), dtype=np.uint8)
        x, y = 80 + 5 * t, 60 + 3 * t
        fv[y:y + 48, x:x + 48] = 230
        fi[y:y + 48, x:x + 48] = 200
        yield fv, np.repeat(fi, 3, axis=-1)


def _counters():
    from multi_modal_tracking_torch.ops.attention import mixed_attention, mixed_attention_bwd
    from multi_modal_tracking_torch.ops.msda import ms_deform_attn, ms_deform_attn_bwd
    return {"K1": mixed_attention, "K2": mixed_attention_bwd, "K3": ms_deform_attn,
            "K4": ms_deform_attn_bwd}


def reset_launches() -> None:
    for fn in _counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {k: fn.launches for k, fn in _counters().items()}


def phase_tracker(smi: str, frames) -> tuple:
    from multi_modal_tracking_torch.eval.evaltracker import create_tracker
    n_frames, warm = len(frames), 8
    H, W = frames[0][0].shape[:2]
    tracker = create_tracker(_params(), "TRACKINGNET", seed=0)   # update interval 25
    require(tracker.update_interval == 25, f"update interval {tracker.update_interval}")

    reset_launches()
    tracker.initialize(list(frames[0]), {"init_bbox": [80.0, 60.0, 48.0, 48.0]})
    boxes = []
    for i, (fv, fi) in enumerate(frames[1:], start=1):
        if i == warm + 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        boxes.append(tracker.track([fv, fi])["target_bbox"])
    secs = time.perf_counter() - t0
    launches = read_launches()

    n_track = n_frames - 1
    boxes = np.asarray(boxes)
    require(launches["K1"] >= 12 * n_track, f"K1 launched {launches['K1']} times over "
                                            f"{n_track} frames (need >= 12 per frame)")
    require(launches["K3"] == 2 * n_track, f"K3 launched {launches['K3']} times over "
                                           f"{n_track} frames (need 2 per frame)")
    require(launches["K2"] == launches["K4"] == 0, f"backward kernels ran while tracking: "
                                                   f"{launches}")
    require(bool(np.isfinite(boxes).all()), "non-finite box")
    inside = (boxes[:, 0] >= 0) & (boxes[:, 1] >= 0) & (boxes[:, 2] > 0) & (boxes[:, 3] > 0) \
        & (boxes[:, 0] + boxes[:, 2] <= W) & (boxes[:, 1] + boxes[:, 3] <= H)
    require(bool(inside.all()), "box outside the frame")
    ms = secs / (n_track - warm) * 1e3
    emit({"phase": "tracker", "frames": n_track, "frame_hw": [H, W], "update_interval": 25,
          "launches": launches, "ms_per_frame": ms, "fps": 1e3 / ms,
          "timed_frames": n_track - warm, "card": smi, "last_box": boxes[-1].tolist()})
    return launches, tracker


def _wall_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Host clock around `iters` calls ending in a synchronise: what a call
    costs the caller, launch overhead included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def _device_intervals(prof) -> list:
    """(start_us, end_us, name) of every kernel, copy and memset in a
    torch.profiler run, read from its Chrome trace."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def _busy_us(intervals) -> float:
    """Length of the union of the intervals (the device is busy if any of
    them runs)."""
    busy, end = 0.0, float("-inf")
    for s, e, _ in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def phase_profile(tracker, frames, smi: str) -> None:
    """Where a tracked frame's time goes: each layer of the main path on the
    host clock (launch overhead included), then a torch.profiler trace of
    whole frames for the device's busy time, its idle share, the number of
    device operations per frame and the kernels that take the most time."""
    from torch.profiler import ProfilerActivity, profile
    from multi_modal_tracking_torch.tracking.tracker import _prep_rgbt
    model = tracker.model
    fv, fi = frames[0]
    with torch.no_grad():
        img_v, img_i = tracker._upload(fv), tracker._upload(fi)
        prep = lambda: _prep_rgbt(img_v, img_i, tracker._state, tracker.search_factor,
                                  tracker.search_size)
        sv, si, _ = prep()
        s_vi = torch.cat([sv, si], dim=0)
        backbone = lambda: model.backbone.forward_search(tracker._cache, s_vi,
                                                         use_ce_template_mask=False)
        feat = backbone()
        fusion = lambda: model.fusion_vi(feat[:1], feat[1:])
        fused = fusion()
        layers = {"upload": _wall_ms(lambda: (tracker._upload(fv), tracker._upload(fi))),
                  "crop_jet_normalise": _wall_ms(prep),
                  "backbone": _wall_ms(backbone),
                  "fusion": _wall_ms(fusion),
                  "head": _wall_ms(lambda: model.box_head(fused))}
    layers["track_total"] = _wall_ms(lambda: tracker.track([fv, fi]))

    n = len(frames)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for fv, fi in frames:
            tracker.track([fv, fi])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ivals = _device_intervals(prof)
    require(len(ivals) > 0, "the profiler saw no device operation in the traced frames")
    busy = _busy_us(ivals)
    by_name = {}
    for s, e, name in ivals:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    share = lambda key: sum(t for k, t in by_name.items() if key in k) / busy
    emit({"phase": "profile", "card": smi, "layers_ms": layers, "traced_frames": n,
          "wall_ms_per_frame_profiled": wall_us / n / 1e3,
          "device_busy_ms_per_frame": busy / n / 1e3,
          "device_idle_share": 1.0 - busy / wall_us,
          "device_ops_per_frame": len(ivals) / n,
          "K1_share_of_busy": share("mixed_attention_fwd_kernel"),
          "K3_share_of_busy": share("msda_fwd_kernel"),
          "top_kernels_ms_per_frame": [[k[:90], t / n / 1e3] for k, t in top]})


def _train_cfg(batch: int, steps: int):
    """The flagship recipe with the synthetic set, no val split and no warm
    starts (their weight files are not in the repository)."""
    from multi_modal_tracking_torch.config import get_default_config
    cfg = get_default_config(SCRIPT)
    cfg.update_from_file(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                      "experiments", SCRIPT, f"{RECIPE}.yaml"))
    cfg.DATA.TRAIN.DATASETS_NAME = ["SyntheticRGBT"]
    cfg.DATA.VAL.DATASETS_NAME = []
    cfg.MODEL.BACKBONE.PRETRAINED = False
    cfg.MODEL.RGBT_PRETRAINED_PATH = ""
    cfg.TRAIN.BATCH_SIZE = batch
    cfg.DATA.TRAIN.SAMPLE_PER_EPOCH = batch * steps
    return cfg


def _grads_agree(gpu, cpu):
    """The train-step tolerance of the module docstring; returns the worst
    ratios of error to bound (<= 1 passes)."""
    named_cpu = dict(cpu.named_parameters())
    gnorm = float(torch.sqrt(sum((p.grad.double() ** 2).sum() for p in cpu.parameters())))
    floor, total, worst_t, worst_e = 1e-6 * gnorm, 0.0, 0.0, 0.0
    for name, p in gpu.named_parameters():
        g, w = p.grad.detach().cpu().double(), named_cpu[name].grad.double()
        err = float((g - w).norm())
        total += err ** 2
        worst_t = max(worst_t, err / (5e-2 * float(w.norm()) + floor))
        worst_e = max(worst_e, float((g - w).abs().max()) / (1e-1 * float(w.abs().max()) + floor))
    return dict(all=total ** 0.5 / (1e-2 * gnorm), tensor=worst_t, element=worst_e), gnorm


def _compare_step_gpu_cpu():
    """One full-width training step at batch 2 (dropout and drop path off,
    keep 1.0) on the GPU against the same step on the CPU (plain versions)."""
    from multi_modal_tracking_torch.models.build import build_model
    from multi_modal_tracking_torch.train.builders import build_train_loader
    from multi_modal_tracking_torch.train.data.loader import batch_to_model_inputs
    from multi_modal_tracking_torch.train.losses import box_losses
    from multi_modal_tracking_torch.train.train_step import model_inputs
    cfg = _train_cfg(batch=2, steps=1)
    batch = batch_to_model_inputs(next(iter(build_train_loader(cfg, seed=1))))
    off = dict(drop_path_rate=0.0, fusion_dropout=0.0)
    out = {}
    models = {}
    for dev in ("cuda", "cpu"):
        m = build_model(SCRIPT, cfg, device=dev, seed=0, spec_overrides=off).train()
        if dev == "cpu":
            m.load_state_dict({k: v.cpu() for k, v in models["cuda"].state_dict().items()})
        x = model_inputs(batch, dev)
        t0 = time.perf_counter()
        loss, metrics = box_losses(m(x["t"], x["ot"], x["s"], 1.0)["pred_boxes"], x["gt_xywh"],
                                   cfg.TRAIN.IOU_WEIGHT, cfg.TRAIN.L1_WEIGHT)
        loss.backward()
        out[dev] = dict(loss=float(loss.detach()), seconds=time.perf_counter() - t0)
        models[dev] = m
    ratios, gnorm_cpu = _grads_agree(models["cuda"], models["cpu"])
    gnorm_gpu = float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                     for p in models["cuda"].parameters())))
    d_loss = abs(out["cuda"]["loss"] - out["cpu"]["loss"]) / abs(out["cpu"]["loss"])
    d_norm = abs(gnorm_gpu - gnorm_cpu) / gnorm_cpu
    require(d_loss <= 1e-3 and d_norm <= 1e-3, f"GPU vs CPU step: loss rel diff {d_loss}, "
                                               f"grad norm rel diff {d_norm}")
    require(max(ratios.values()) <= 1.0, f"GPU vs CPU gradients beyond the bounds: {ratios}")
    return dict(loss_gpu=out["cuda"]["loss"], loss_cpu=out["cpu"]["loss"], loss_rel_diff=d_loss,
                grad_norm_gpu=gnorm_gpu, grad_norm_cpu=gnorm_cpu, grad_norm_rel_diff=d_norm,
                error_over_bound=ratios, cpu_step_s=out["cpu"]["seconds"])


def phase_train(smi: str) -> dict:
    """The training main path: Trainer on the full-width recipe at batch 16.
    Returns the launch counts of its two epochs."""
    from torch.profiler import ProfilerActivity, profile
    from multi_modal_tracking_torch.train.data.loader import batch_to_model_inputs
    from multi_modal_tracking_torch.train.train_step import make_train_step, model_inputs
    from multi_modal_tracking_torch.train.trainer import Trainer
    cfg = _train_cfg(TRAIN_B, TRAIN_STEPS)
    tr = Trainer(SCRIPT, cfg, device="cuda", seed=0, print_interval=TRAIN_STEPS)
    per_step = {"K1": 12, "K2": 12, "K3": 2, "K4": 2}
    epochs, launches, losses = {}, {k: 0 for k in per_step}, []
    for epoch, keep in ((1, 1.0), (51, KEEP_FINAL)):
        tr.epoch = epoch
        require(tr._keep_rate(epoch) == keep, f"keep rate {tr._keep_rate(epoch)} at epoch {epoch}")
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.cycle_dataset()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_launches()
        for k, n in per_step.items():
            require(counts[k] == n * TRAIN_STEPS, f"{k} launched {counts[k]} times in "
                                                  f"{TRAIN_STEPS} steps at keep {keep}")
            launches[k] += counts[k]
        step_losses = [m["Loss/total"] for m in tr.history]
        require(len(step_losses) == TRAIN_STEPS and all(np.isfinite(step_losses)),
                f"losses {step_losses}")
        losses += step_losses
        epochs[epoch] = dict(keep=keep, launches=counts, ms_per_step_in_epoch=secs / TRAIN_STEPS * 1e3,
                             loss=step_losses, grad_norm=[m["grad_norm"] for m in tr.history])

    # host data time: batches from the threaded loader, after a warm one
    it = iter(tr.train_loader)
    next(it)
    t0 = time.perf_counter()
    batches = list(it)
    data_ms = (time.perf_counter() - t0) / len(batches) * 1e3
    t0 = time.perf_counter()
    inputs = model_inputs(batch_to_model_inputs(batches[-1]), "cuda")
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) * 1e3
    del it

    step = make_train_step(tr.model, tr.optimizer)
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(inputs, KEEP_FINAL)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    n_prof = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_prof):
            step(inputs, KEEP_FINAL)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ivals = _device_intervals(prof)
    require(len(ivals) > 0, "the profiler saw no device operation in the traced steps")
    busy = _busy_us(ivals)
    by_name = {}
    for s, e, name in ivals:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    share = lambda keys: sum(t for k, t in by_name.items() if any(x in k for x in keys)) / busy
    med = float(np.median(step_ms))
    emit({"phase": "train", "card": smi, "recipe": f"{SCRIPT}/{RECIPE}", "batch": TRAIN_B,
          "epochs": epochs, "loss_per_step": losses,
          "ms_per_step_median": med, "ms_per_step": step_ms, "samples_per_s": TRAIN_B / med * 1e3,
          "host_data_ms_per_batch": data_ms, "host_upload_ms_per_batch": upload_ms,
          "data_workers": cfg.TRAIN.NUM_WORKER,
          "profiled_steps": n_prof, "wall_ms_per_step_profiled": wall_us / n_prof / 1e3,
          "device_busy_ms_per_step": busy / n_prof / 1e3,
          "device_idle_share": 1.0 - busy / wall_us,
          "device_ops_per_step": len(ivals) / n_prof,
          "kernel_share_of_busy": {"K1": share(["mixed_attention_fwd_kernel"]),
                                   "K2": share(["attn_bwd_"]),
                                   "K3": share(["msda_fwd_kernel"]),
                                   "K4": share(["msda_bwd_kernel"])},
          "peak_memory_gib": peak / 2 ** 30,
          "top_kernels_ms_per_step": [[k[:90], t / n_prof / 1e3] for k, t in top]})
    del tr, step, inputs
    torch.cuda.empty_cache()
    emit({"phase": "train", "check": "gpu vs cpu step, batch 2, keep 1.0",
          **_compare_step_gpu_cpu()})
    return launches


def main() -> None:
    dev, smi = phase_device()
    phase_build()
    warm_profiler()
    g = torch.Generator().manual_seed(0)
    kernels = phase_kernels(g)
    phase_model(g)
    frames = list(_sequence(74))
    track_launches, tracker = phase_tracker(smi, frames[:64])
    phase_profile(tracker, frames[64:], smi)
    del tracker
    train_launches = phase_train(smi)
    table = []
    for key in ("K1", "K2", "K3", "K4"):
        by_path = {"tracker": track_launches[key], "train": train_launches[key]}
        row = dict(kernels[key], launches=sum(by_path.values()), launches_by_path=by_path)
        table.append({k: row[k] for k in ("name", "route", "source", "replaces", "launches",
                                          "max_abs_err", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "bound_f32_ms", "library_ms",
                                          "library_ratio", "event_ms", "per",
                                          "launches_by_path") + (
            ("train_step_ms", "train_step_library_ms") if key == "K1" else
            ("train_step_ms",) if key == "K3" else ())})
    # ms is device time (torch.profiler): per tracked frame for K1 and K3
    # (12 search-step calls at the CE lengths, 2 calls at B=1), per training
    # step at the final keep for K2 and K4; train_step_ms is K1's and K3's
    # device time per training step; bound_ms is at 165 TFLOP/s (3xTF32) for
    # K1 and K2, bound_f32_ms at 67 TFLOP/s (f32 CUDA cores) for all four
    emit({"kernels": table})
    emit({"ok": True, "device": dev})


if __name__ == "__main__":
    main()
