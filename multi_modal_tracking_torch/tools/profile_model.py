"""Model profile: parameters, the forward's matmul+conv FLOPs and the device
latency a frame; the port's counterpart of tracking/profile_model.py.

The model is `build_model(script, cfg, dtype=bfloat16)`, the JAX script's
dtype, at the recipe's sizes or --search_size / --template_size. The FLOPs
are the analytic count of `utils/flops.py` (JAX's jaxpr walker's
accounting) of the forward `model(t, t, s)` on the meta device; the JAX
script prints XLA's cost analysis and its HBM bytes, which have no
counterpart here (the bytes are left out). The latency: the forward
captured as a CUDA graph, replayed `--repeats` times between CUDA events,
ended by a 4-byte read of the output. On the CPU (--device cpu) the
latency is the host clock of eager forwards.

  python -m multi_modal_tracking_torch.tools.profile_model --script asymmetric_shared_ce
  python -m multi_modal_tracking_torch.tools.profile_model --script mixformer_vit --repeats 100
"""
from __future__ import annotations

import argparse
import copy
import time
from typing import Optional

import torch

from multi_modal_tracking_torch.utils.device import resolve_device


def forward_flops(model, t: torch.Tensor, s: torch.Tensor) -> float:
    """The matmul+conv FLOPs of `model(t, t, s)`, counted on a meta copy (no
    arithmetic, whatever device the model is on)."""
    from multi_modal_tracking_torch.utils.flops import matmul_conv_flops
    meta = copy.deepcopy(model).to("meta")
    tm, sm = t.to("meta"), s.to("meta")
    with torch.no_grad():
        return matmul_conv_flops(lambda: meta(tm, tm, sm))


def graphed_forward(model, t: torch.Tensor, s: torch.Tensor):
    """(replay, out): `model(t, t, s)` run once eager on a side stream and
    captured as a CUDA graph (tracking/graphs.py); `replay()` replays it,
    writing the first four output values into `out`."""
    from multi_modal_tracking_torch.tracking.graphs import StepGraphs
    graphs = StepGraphs(t.device, "profiled forward")
    out = torch.zeros(4, device=t.device)

    def step():
        out.copy_(model(t, t, s)["pred_boxes"].reshape(-1)[:4].float())

    def replay():
        graphs.run(("forward",), step)
    with torch.no_grad():
        replay()                                    # eager, then captured
    return replay, out


def graphed_ms(model, t: torch.Tensor, s: torch.Tensor, repeats: int) -> float:
    """Device ms per forward: one CUDA graph of `model(t, t, s)` replayed
    `repeats` times between two events, then a 4-byte read of its output."""
    replay, out = graphed_forward(model, t, s)
    replay()
    torch.cuda.synchronize(t.device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        replay()
    end.record()
    float(out[0])                                   # the real read that ends the run
    return start.elapsed_time(end) / repeats


def eager_ms(model, t: torch.Tensor, s: torch.Tensor, repeats: int) -> float:
    with torch.no_grad():
        model(t, t, s)
        t0 = time.perf_counter()
        for _ in range(repeats):
            model(t, t, s)["pred_boxes"].reshape(-1)[0].item()
    return (time.perf_counter() - t0) / repeats * 1e3


def profile(script: str, search_size: Optional[int] = None, template_size: Optional[int] = None,
            repeats: int = 50, device="cuda", spec_overrides: Optional[dict] = None,
            keep_model: bool = False) -> dict:
    """{"params", "flops", "latency_ms", "search_size", "template_size"} of
    the script's model at bf16 (see the module docstring); `spec_overrides`
    replace fields of the model spec (narrow widths for a test);
    `keep_model` adds the model and its inputs (t, s)."""
    from multi_modal_tracking_torch.config import get_default_config
    from multi_modal_tracking_torch.models.build import build_model, is_rgbt_script

    dev = resolve_device(device)
    cfg = get_default_config(script)
    if search_size:
        cfg.DATA.SEARCH.SIZE = search_size
    if template_size:
        cfg.DATA.TEMPLATE.SIZE = template_size
    model = build_model(script, cfg, device=dev, dtype=torch.bfloat16,
                        spec_overrides=spec_overrides)
    lead = 2 if is_rgbt_script(script) else 1
    ts, ss = cfg.DATA.TEMPLATE.SIZE, cfg.DATA.SEARCH.SIZE
    t = torch.zeros(lead, ts, ts, 3, device=dev)
    s = torch.zeros(lead, ss, ss, 3, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    flops = forward_flops(model, t, s)
    lat_ms = graphed_ms(model, t, s, repeats) if dev.type == "cuda" else \
        eager_ms(model, t, s, repeats)
    clock = "CUDA graph, events" if dev.type == "cuda" else "host clock, eager"
    print(f"script:           {script}")
    print(f"search/template:  {ss} / {ts}")
    print(f"params:           {n_params / 1e6:.2f} M")
    print(f"forward FLOPs:    {flops / 1e9:.2f} G (analytic matmul+conv count)")
    print(f"device latency:   {lat_ms:.3f} ms/frame ({1e3 / lat_ms:.1f} FPS; {clock})")
    out = {"params": n_params, "flops": flops, "latency_ms": lat_ms,
           "search_size": ss, "template_size": ts}
    if keep_model:
        out.update(model=model, inputs=(t, s))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m multi_modal_tracking_torch.tools.profile_model")
    ap.add_argument("--script", default="asymmetric_shared_ce")
    ap.add_argument("--search_size", type=int, default=None)
    ap.add_argument("--template_size", type=int, default=None)
    ap.add_argument("--repeats", type=int, default=50)
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return profile(args.script, args.search_size, args.template_size, args.repeats,
                   args.device)


if __name__ == "__main__":
    main()
