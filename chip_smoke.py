"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:
  1. device   - requires CUDA, prints the card's name and power limit,
                turns TF32 off;
  2. build    - compiles every kernel of the main path from csrc/ (nvcc);
  3. kernels  - each kernel against its plain PyTorch version on the card at
                the main path's shapes (and at narrow edge-case shapes),
                timed with CUDA events beside the plain version, a PyTorch
                library yardstick and the card's bound for the same work;
  4. model    - the full-width asymmetric_shared_ce recipe (seeded random
                weights): cached path (set_online + forward_track) against
                the full forward, and the GPU run against the same model on
                the CPU (plain versions) on the same crops;
  5. tracker  - create_tracker -> initialize -> track over a seeded
                synthetic 512x640 RGB-T sequence (64 frames, update interval
                25), with every kernel's launch count read over that run;
  6. profile  - where a frame's time goes: each layer on the host clock, and
                a torch.profiler trace of 10 more frames for the device's busy
                time, idle share, operations per frame and top kernels.
Then the kernel table line and, last, {"ok": true, "device": {...}}.

Tolerances (f32 everywhere, TF32 off):
  * kernels: 2e-5 abs or 1e-4 rel. Both sides are f32 sums of the same
    terms in another order; measured differences are ~1e-6. A wrong mask,
    tap or coordinate gives errors of order 1e-2 or more.
  * model boxes (normalised to [0, 1]): 1e-4, i.e. 0.03 px at 288. The paths
    compared use other key orders, GEMM shapes and CPU vs GPU kernels
    through 12 blocks, 2 fusion layers and the head.
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
KERNEL_TOL = dict(atol=2e-5, rtol=1e-4)
BOX_TOL = 1e-4
# the recipe's backbone attention shapes: search lengths per block after CE
# at blocks 3/6/9 (keep 0.7): 4 blocks at 324, 3 at 227, 3 at 159, 2 at 112
CE_LENGTHS = ((324, 4), (227, 3), (159, 3), (112, 2))
N_MT = 128                         # 2 templates x 8x8 tokens per modality
B2, HEADS, HEAD_D = 2, 12, 64      # both modalities on the batch axis


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


def bound_ms(n_bytes: float, flops: float):
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got: torch.Tensor, want: torch.Tensor):
    """(max abs error, max rel error over |want| >= 1e-3, within KERNEL_TOL)."""
    diff = (got - want).abs()
    ok = bool((diff <= KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * want.abs()).all())
    big = want.abs() >= 1e-3
    return float(diff.max()), float((diff[big] / want.abs()[big]).max()), ok


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
    ptxas = {name: [ln.strip() for ln in log.splitlines() if "registers" in ln]
             for name, log in logs.items()}
    emit({"phase": "build", "seconds": round(secs, 3), "ptxas": ptxas})


def _qkv(B, H, Nq, Nk, D, g):
    return (torch.randn(B, H, Nq, D, generator=g).cuda(),
            torch.randn(B, H, Nk, D, generator=g).cuda(),
            torch.randn(B, H, Nk, D, generator=g).cuda())


def phase_kernels(g: torch.Generator) -> dict:
    import torch.nn.functional as F
    from multi_modal_tracking_torch.ops.attention import mixed_attention, mixed_attention_ref
    from multi_modal_tracking_torch.ops.msda import ms_deform_attn, ms_deform_attn_ref

    scale = HEAD_D ** -0.5
    # (form, Nq, Nk, n_mt, calls per frame on the cached tracking path)
    k1_cases = [("template_step", N_MT, N_MT, 0, 0)]
    k1_cases += [("search_step", L, L + 2 * N_MT, 0, n) for L, n in CE_LENGTHS]
    k1_cases += [("full_forward", N_MT + L, 2 * N_MT + L, N_MT, 0) for L, _ in CE_LENGTHS]
    k1_rows, k1_err = [], 0.0
    per_frame = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, flops=0.0)
    for form, Nq, Nk, n_mt, calls in k1_cases:
        q, k, v = _qkv(B2, HEADS, Nq, Nk, HEAD_D, g)
        got = mixed_attention(q, k, v, n_mt, scale)
        want = mixed_attention_ref(q, k, v, n_mt, scale)
        err, rel, ok = max_err(got, want)
        require(ok, f"K1 {form} Nq={Nq} Nk={Nk} n_mt={n_mt} disagrees with its plain "
                    f"version: max abs err {err}")
        k1_err = max(k1_err, err)
        rows = torch.arange(Nq, device="cuda")[:, None]
        cols = torch.arange(Nk, device="cuda")[None, :]
        mask = (rows >= n_mt) | (cols < n_mt)
        ms = cuda_time_ms(lambda: mixed_attention(q, k, v, n_mt, scale))
        plain = cuda_time_ms(lambda: mixed_attention_ref(q, k, v, n_mt, scale))
        lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                                  scale=scale))
        pairs = (Nq - n_mt) * Nk + n_mt * min(n_mt, Nk) if n_mt else Nq * Nk
        n_bytes = 4 * B2 * HEADS * HEAD_D * (2 * Nq + 2 * Nk)
        flops = 4 * B2 * HEADS * HEAD_D * pairs
        b_ms, b_by = bound_ms(n_bytes, flops)
        k1_rows.append(dict(form=form, Nq=Nq, Nk=Nk, n_mt=n_mt, calls_per_frame=calls,
                            max_abs_err=err, max_rel_err=rel, ms=ms, plain_ms=plain, sdpa_ms=lib,
                            bound_ms=b_ms, bound_by=b_by))
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bytes", n_bytes), ("flops", flops)):
            per_frame[key] += calls * val
    emit({"phase": "kernels", "kernel": "K1 mixed_attention", "tolerance": KERNEL_TOL,
          "cases": k1_rows})

    k3_rows, k3_err = [], 0.0
    shapes = ((18, 18), (18, 18))
    S = Lq = 648
    M, D, L, P = 8, 64, 2, 4
    k3_frame = None
    for B in (1, 4):
        value = torch.randn(B, S, M, D, generator=g).cuda()
        loc = (torch.rand(B, Lq, M, L, P, 2, generator=g) * 1.2 - 0.1).cuda()
        attw = torch.softmax(torch.randn(B, Lq, M, L * P, generator=g), -1) \
            .reshape(B, Lq, M, L, P).cuda()
        got = ms_deform_attn(value, shapes, loc, attw)
        want = ms_deform_attn_ref(value, shapes, loc, attw)
        err, rel, ok = max_err(got, want)
        require(ok, f"K3 B={B} disagrees with its plain version: max abs err {err}")
        k3_err = max(k3_err, err)
        ms = cuda_time_ms(lambda: ms_deform_attn(value, shapes, loc, attw))
        plain = cuda_time_ms(lambda: ms_deform_attn_ref(value, shapes, loc, attw))
        # work this data needs: 2 FLOP per channel per corner inside its map
        x = loc[..., 0] * 18 - 0.5
        y = loc[..., 1] * 18 - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        inside = sum(((xi >= 0) & (xi < 18) & (yi >= 0) & (yi < 18)).sum()
                     for xi in (x0, x0 + 1) for yi in (y0, y0 + 1))
        flops = 2.0 * D * float(inside)
        n_bytes = 4 * (value.numel() + loc.numel() + attw.numel() + got.numel())
        b_ms, b_by = bound_ms(n_bytes, flops)
        row = dict(B=B, S=S, Lq=Lq, M=M, D=D, L=L, P=P, max_abs_err=err, max_rel_err=rel, ms=ms,
                   plain_ms=plain, bound_ms=b_ms, bound_by=b_by)
        k3_rows.append(row)
        if B == 1:
            k3_frame = dict(ms=2 * ms, plain_ms=2 * plain, bound_ms=2 * b_ms, bound_by=b_by)
    emit({"phase": "kernels", "kernel": "K3 ms_deform_attn", "tolerance": KERNEL_TOL,
          "cases": k3_rows})

    # narrow widths and ragged tiles: n_mt inside a key tile, Nq != Nk, D 16/32
    edge = []
    for (B, H, Nq, Nk, D, n_mt) in [(2, 3, 40, 64, 16, 8), (2, 2, 70, 100, 32, 37),
                                    (1, 2, 5, 7, 16, 5), (1, 2, 131, 197, 64, 65)]:
        q, k, v = _qkv(B, H, Nq, Nk, D, g)
        err, _, ok = max_err(mixed_attention(q, k, v, n_mt, D ** -0.5),
                             mixed_attention_ref(q, k, v, n_mt, D ** -0.5))
        require(ok, f"K1 edge case {(B, H, Nq, Nk, D, n_mt)}: max abs err {err}")
        edge.append(dict(kernel="K1", shape=[B, H, Nq, Nk, D, n_mt], max_abs_err=err))
    for (B, shp, Lq, M, D, P) in [(2, ((9, 12), (5, 7)), 17, 2, 8, 3),
                                  (1, ((6, 7), (5, 4), (3, 3)), 30, 4, 32, 4)]:
        S = sum(h * w for h, w in shp)
        value = torch.randn(B, S, M, D, generator=g).cuda()
        loc = (torch.rand(B, Lq, M, len(shp), P, 2, generator=g) * 1.4 - 0.2).cuda()
        attw = torch.rand(B, Lq, M, len(shp), P, generator=g).cuda()
        err, _, ok = max_err(ms_deform_attn(value, shp, loc, attw),
                             ms_deform_attn_ref(value, shp, loc, attw))
        require(ok, f"K3 edge case {(B, shp, Lq, M, D, P)}: max abs err {err}")
        edge.append(dict(kernel="K3", shape=[B, shp, Lq, M, D, P], max_abs_err=err))
    torch.cuda.synchronize()
    emit({"phase": "kernels", "kernel": "edge cases", "cases": edge})

    b_ms, b_by = bound_ms(per_frame["bytes"], per_frame["flops"])
    return {
        "K1": dict(name="mixed_attention_fwd (K1)", route="cuda",
                   source="multi_modal_tracking_torch/csrc/mixed_attention.cu",
                   replaces="multi_modal_tracking_tpu/ops/attention.py:44",
                   max_abs_err=k1_err, ms=per_frame["ms"], plain_ms=per_frame["plain_ms"],
                   bound_ms=b_ms, bound_by=b_by, library_ms=per_frame["library_ms"]),
        "K3": dict(name="msda_fwd (K3)", route="cuda",
                   source="multi_modal_tracking_torch/csrc/msda.cu",
                   replaces="multi_modal_tracking_tpu/ops/msda.py:171",
                   max_abs_err=k3_err, library_ms=None, **k3_frame),
    }


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


def phase_tracker(smi: str, frames) -> tuple:
    from multi_modal_tracking_torch.eval.evaltracker import create_tracker
    from multi_modal_tracking_torch.ops.attention import mixed_attention
    from multi_modal_tracking_torch.ops.msda import ms_deform_attn
    n_frames, warm = len(frames), 8
    H, W = frames[0][0].shape[:2]
    tracker = create_tracker(_params(), "TRACKINGNET", seed=0)   # update interval 25
    require(tracker.update_interval == 25, f"update interval {tracker.update_interval}")

    mixed_attention.launches = 0
    ms_deform_attn.launches = 0
    tracker.initialize(list(frames[0]), {"init_bbox": [80.0, 60.0, 48.0, 48.0]})
    boxes = []
    for i, (fv, fi) in enumerate(frames[1:], start=1):
        if i == warm + 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        boxes.append(tracker.track([fv, fi])["target_bbox"])
    secs = time.perf_counter() - t0
    launches = {"K1": mixed_attention.launches, "K3": ms_deform_attn.launches}

    n_track = n_frames - 1
    boxes = np.asarray(boxes)
    require(launches["K1"] >= 12 * n_track, f"K1 launched {launches['K1']} times over "
                                            f"{n_track} frames (need >= 12 per frame)")
    require(launches["K3"] == 2 * n_track, f"K3 launched {launches['K3']} times over "
                                           f"{n_track} frames (need 2 per frame)")
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


def main() -> None:
    dev, smi = phase_device()
    phase_build()
    g = torch.Generator().manual_seed(0)
    kernels = phase_kernels(g)
    phase_model(g)
    frames = list(_sequence(74))
    launches, tracker = phase_tracker(smi, frames[:64])
    phase_profile(tracker, frames[64:], smi)
    table = []
    for key in ("K1", "K3"):
        row = dict(kernels[key], launches=launches[key])
        table.append({k: row[k] for k in ("name", "route", "source", "replaces", "launches",
                                          "max_abs_err", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")})
    # times are per tracked frame: K1's 12 search_step calls at the CE
    # lengths, K3's 2 calls at B=1
    emit({"kernels": table})
    emit({"ok": True, "device": dev})


if __name__ == "__main__":
    main()
