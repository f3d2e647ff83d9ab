"""Times the bf16 MSDA kernels K3-bf16 and K4-bf16 of one or more trees of
this repository on one NVIDIA GPU, each tree in its own process, so two
versions of the kernels can be compared on the same card:

    python3 msda_bf16_ab.py TREE [TREE ...]

A TREE is a directory holding a `multi_modal_tracking_torch/` package (this
checkout, `.`, or another commit unpacked with `git archive`). Give the
trees in turns, e.g. `parent . . parent`, and compare within one call. For
each tree it prints one JSON line with, at the flagship's shapes (M 8,
D 64, two 18x18 levels, P 4, Lq 648; seeded random bf16 inputs, uniform
locations in [-0.1, 1.1]):
  * k3_frame_ms: K3-bf16 device ms per tracked frame (2 calls at B 1);
  * k3_lockstep_ms: per lockstep N = 12 step (2 calls at B 12);
  * k3_step_ms, k4_step_ms: per bf16 training step (2 calls each at B 16);
  * *_event_ms: the same on CUDA events (launch gaps included);
  * k3_differing_share, k4_dvalue_differing_share: the share of the B 16
    outputs (K4-bf16: dValue) not bit-equal to the plain version;
  * k4_repeatable: two K4-bf16 calls on one input give the same bits;
  * drift_px_mean, drift_px_max: the bf16 tracker's centre distance from
    the f32 tracker's over chip_smoke.py's synthetic 512x640 sequence (63
    frames, seed-0 weights, both eager);
and the card's name and power limit. Device ms come from torch.profiler:
every kernel the calls launch, summed, per frame or step.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

LQ, M, D, SHAPES = 648, 8, 64, ((18, 18), (18, 18))


def _one(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from multi_modal_tracking_torch.ops import msda as MS
    assert MS.__file__.startswith(os.path.abspath(tree)), MS.__file__
    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(0)

    def inputs(B):
        value = torch.randn(B, 648, M, D, generator=g).cuda().to(torch.bfloat16)
        loc = (torch.rand(B, LQ, M, 2, 4, 2, generator=g) * 1.2 - 0.1).cuda()
        attw = torch.softmax(torch.randn(B, LQ, M, 8, generator=g), -1).reshape(
            B, LQ, M, 2, 4).cuda().to(torch.bfloat16)
        gr = torch.randn(B, LQ, M * D, generator=g).cuda().to(torch.bfloat16)
        return value, loc, attw, gr

    def device_ms(fn, iters=10):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        return sum(e.device_time for e in prof.events()
                   if e.device_type.name == "CUDA" and e.device_time > 0) / iters / 1e3

    def event_ms(fn, iters=20):
        for _ in range(3):
            fn()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    x1, x12, x16 = inputs(1), inputs(12), inputs(16)

    def fwd(x):
        return lambda: [MS.ms_deform_attn_bf16(x[0], SHAPES, x[1], x[2]) for _ in range(2)]

    def bwd(x):
        return lambda: [MS.ms_deform_attn_bwd_bf16(x[0], SHAPES, x[1], x[2], x[3])
                        for _ in range(2)]

    out = {"tree": tree}
    for key, fn in (("k3_frame", fwd(x1)), ("k3_lockstep", fwd(x12)), ("k3_step", fwd(x16)),
                    ("k4_step", bwd(x16))):
        out[f"{key}_ms"] = device_ms(fn)
        out[f"{key}_event_ms"] = event_ms(fn)
    value, loc, attw, gr = x16
    got = MS.ms_deform_attn_bf16(value, SHAPES, loc, attw)
    out["k3_differing_share"] = float((got != MS.ms_deform_attn_bf16_ref(
        value, SHAPES, loc, attw)).float().mean())
    dv = MS.ms_deform_attn_bwd_bf16(value, SHAPES, loc, attw, gr)
    again = MS.ms_deform_attn_bwd_bf16(value, SHAPES, loc, attw, gr)
    out["k4_repeatable"] = all(torch.equal(a, b) for a, b in zip(dv, again))
    out["k4_dvalue_differing_share"] = float((dv[0] != MS.ms_deform_attn_bwd_bf16_ref(
        value, SHAPES, loc, attw, gr)[0]).float().mean())

    from multi_modal_tracking_torch.eval.evaltracker import create_tracker
    frames = list(chip_smoke._sequence(64))
    boxes = {}
    for dtype in (torch.float32, torch.bfloat16):
        tracker = create_tracker(chip_smoke._params(), "TRACKINGNET", seed=0, dtype=dtype,
                                 graphs=False)
        tracker.initialize(list(frames[0]), {"init_bbox": chip_smoke.INIT_BOX})
        boxes[dtype] = np.asarray([tracker.track([fv, fi])["target_bbox"]
                                   for fv, fi in frames[1:]])
        del tracker
    d = chip_smoke._centre_px(boxes[torch.bfloat16], boxes[torch.float32])
    out.update(drift_px_mean=float(d.mean()), drift_px_max=float(d.max()))
    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip().splitlines()[0]
    return out


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(_one(sys.argv[2])), flush=True)
        return
    import torch
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__ if len(sys.argv) < 2 else "msda_bf16_ab: needs an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(2)
    for tree in sys.argv[1:]:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout, res.stderr, file=sys.stderr)
            sys.exit(res.returncode)
        print(res.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
