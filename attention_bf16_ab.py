"""Times the bf16 attention kernels K1-bf16 and K2-bf16 of one or more trees
of this repository on one NVIDIA GPU, each tree in its own process, so two
versions of the kernels can be compared on the same card:

    python3 attention_bf16_ab.py TREE [TREE ...]

A TREE is a directory holding a `multi_modal_tracking_torch/` package (this
checkout, `.`, or another commit unpacked with `git archive`). Give the
trees in turns, e.g. `parent . . parent`, and compare within one call. For
each tree it prints one JSON line with, at the flagship's shapes (12 heads,
D 64, seeded random bf16 inputs):
  * k1_frame_ms: K1-bf16 device ms per tracked frame (12 calls: B*H 24,
    Nq the CE lengths 324 x 4, 227 x 3, 159 x 3, 112 x 2, Nk = Nq + 256);
  * k1_step_ms: K1-bf16 with the logsumexp per bf16 training step (B*H 384,
    Nq 452 x 4, 368 x 3, 306 x 3, 260 x 2, Nk = Nq + 128, n_mt 128);
  * k2_step_ms: K2-bf16 per bf16 training step at the same shapes;
  * *_event_ms: the same on CUDA events (launch gaps included);
  * k1_host_us, k2_host_us: the wrappers' host CPU time per call (median
    of 10 runs of 20 calls at Nq 324 / 260), tensor-map encoding included;
and the card's name and power limit. Device ms come from torch.profiler:
every kernel the calls launch, summed, per frame or step.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

FRAME = ((324, 4), (227, 3), (159, 3), (112, 2))      # (Nq, calls) per tracked frame
STEP = ((452, 4), (368, 3), (306, 3), (260, 2))       # (Nq, calls) per training step


def _one(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from multi_modal_tracking_torch.ops import attention as A
    from multi_modal_tracking_torch.ops import _build
    assert A.__file__.startswith(os.path.abspath(tree)), A.__file__
    _build.build(["mixed_attention_bf16", "mixed_attention_bwd_bf16"])
    g = torch.Generator().manual_seed(0)

    def bf16(*shape):
        return torch.randn(*shape, generator=g).cuda().to(torch.bfloat16)

    def device_ms(fn, iters=5):
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

    def host_us(fn):
        runs = []
        for _ in range(10):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(20):
                fn()
            runs.append((time.perf_counter() - t) / 20 * 1e6)
        torch.cuda.synchronize()
        return sorted(runs)[len(runs) // 2]

    frame = [(bf16(2, 12, n, 64), bf16(2, 12, n + 256, 64), bf16(2, 12, n + 256, 64), c)
             for n, c in FRAME]
    step = []
    for n, c in STEP:
        q, k, v, gr = (bf16(32, 12, m, 64) for m in (n, n + 128, n + 128, n))
        step.append((q, k, v, gr, A.mixed_attention_bf16(q, k, v, 128, 0.125, True)[1], c))

    def k1_frame():
        for q, k, v, c in frame:
            for _ in range(c):
                A.mixed_attention_bf16(q, k, v, 0, 0.125)

    def k1_step():
        for q, k, v, _, _, c in step:
            for _ in range(c):
                A.mixed_attention_bf16(q, k, v, 128, 0.125, True)

    def k2_step():
        for q, k, v, gr, lse, c in step:
            for _ in range(c):
                A.mixed_attention_bwd_bf16(q, k, v, gr, 128, 0.125, lse)

    q, k, v, _ = frame[0]
    sq, sk, sv, sg, slse, _ = step[-1]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    return dict(tree=tree, card=smi,
                k1_frame_ms=device_ms(k1_frame), k1_step_ms=device_ms(k1_step),
                k2_step_ms=device_ms(k2_step), k1_frame_event_ms=event_ms(k1_frame),
                k1_step_event_ms=event_ms(k1_step), k2_step_event_ms=event_ms(k2_step),
                k1_host_us=host_us(lambda: A.mixed_attention_bf16(q, k, v, 0, 0.125)),
                k2_host_us=host_us(lambda: A.mixed_attention_bwd_bf16(sq, sk, sv, sg, 128, 0.125,
                                                                      slse)))


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(_one(sys.argv[2])), flush=True)
        return
    import torch
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__ if len(sys.argv) < 2 else "attention_bf16_ab: needs an NVIDIA GPU",
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
