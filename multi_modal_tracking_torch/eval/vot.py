"""VOT toolkit integration over TraX: the port's counterpart of the JAX
package's `eval/vot.py`, and its command line.

Three entries, as the reference's:
  run_vot_exp          VOT-RGBD (score-gated online bimodal tracker over
                       colour + depth, rectangle and confidence per frame);
  run_vot20_lt_exp     VOT2020-LT (colour only, rectangle and confidence);
  run_vot20_mask_exp   VOT2020 (the tracker's box refined by Alpha-Refine
                       into a mask, threshold 0.6, AR input 384).
Each reads the toolkit's requests through `VOTClient`: the compiled `trax`
package when it is installed, else the port's own text protocol over
stdio (`eval/trax_wire.py`, rectangles only), or a server the caller
injects (tests, the chip script).

Command line, the counterpart of `vot_workspace/*/vot_entry_*.py` (the
toolkit launches it as the tracker command):

  python -m multi_modal_tracking_torch.eval.vot {mask,lt,rgbd} \\
      [--script S] [--yaml Y] [--checkpoint F] [--refine_checkpoint F] \\
      [--device cuda|cpu] [--dtype bfloat16|float32]

On the wire, standard output carries protocol messages only: the command
keeps the original stdout for the protocol and points file descriptor 1
and `sys.stdout` at stderr before anything else runs, so a print or a
compiler's output on the tracker's path cannot corrupt the stream.
"""
from __future__ import annotations

import argparse
import collections
import os
import sys
from typing import Optional

import numpy as np
import torch

from multi_modal_tracking_torch.utils.device import DTYPES, resolve_device

Rectangle = collections.namedtuple("Rectangle", ["x", "y", "width", "height"])

_CHANNELS = {"color": ["color"], "rgbd": ["color", "depth"], "rgbt": ["color", "ir"],
             "ir": ["ir"]}


class VOTClient:
    """Minimal VOT/TraX client.

    Uses the `trax` package when it is installed (as the reference does),
    else the port's `TraxWireServer` over stdio; `server` injects another
    object with wait() -> request (.type in {"initialize", "frame",
    "quit"}, .region (x, y, w, h), .image paths), status(region,
    properties) and quit()."""

    def __init__(self, channels: str = "color", server=None):
        chans = _CHANNELS[channels]
        if server is not None:
            self._trax = server
        else:
            try:
                import trax
                self._trax = trax.Server([trax.Region.RECTANGLE], [trax.Image.PATH], chans,
                                         customMetadata=dict(vot="python"))
            except ImportError:
                from multi_modal_tracking_torch.eval.trax_wire import TraxWireServer
                self._trax = TraxWireServer(channels=chans)
        request = self._trax.wait()
        assert request.type == "initialize"
        self._region = Rectangle(*self._unpack_region(request))
        self._image = self._unpack_image(request)
        self._trax.status(request.region if hasattr(request, "region") else None)

    @staticmethod
    def _unpack_region(request):
        r = request.region
        if hasattr(r, "bounds"):
            return r.bounds()
        return tuple(r)

    @staticmethod
    def _unpack_image(request):
        img = request.image
        if isinstance(img, dict):
            paths = [x.path() if hasattr(x, "path") else x for x in img.values()]
        elif isinstance(img, (list, tuple)):
            paths = [x.path() if hasattr(x, "path") else x for x in img]
        else:
            paths = [img.path() if hasattr(img, "path") else img]
        return paths if len(paths) > 1 else paths[0]

    def region(self) -> Rectangle:
        return self._region

    def report(self, region, confidence: Optional[float] = None):
        """region: a Rectangle for box trackers, or a binary uint8 (H, W)
        array for the VOT2020 mask experiment."""
        r = region
        try:
            import trax
            if isinstance(region, Rectangle):
                r = trax.Region.create("rectangle", region.x, region.y, region.width,
                                       region.height)
            elif isinstance(region, np.ndarray):
                r = trax.Mask.create(region)
        except ImportError:
            pass
        self._trax.status(r, {"confidence": confidence} if confidence is not None else {})

    def frame(self):
        """The next frame's path(s), or None at the end of the sequence."""
        request = self._trax.wait()
        if request.type != "frame":
            return None
        return self._unpack_image(request)

    def quit(self):
        if hasattr(self._trax, "quit"):
            self._trax.quit()


def run_vot_exp(script: str, training_yaml: Optional[str] = None,
                checkpoint: Optional[str] = None, channels: str = "rgbd",
                update_interval: Optional[int] = None, server=None, tracker=None,
                dataset_name: str = "DepthTrack", device="cuda", dtype=torch.bfloat16):
    """The VOT experiment loop (the reference's tracker_class.py
    run_vot_exp): [colour, depth as replicated clipped grey] (or colour /
    IR) pairs go to the tracker, whose TIR pipeline applies the JET map;
    the rectangle and the confidence are reported every frame.

    update_interval None resolves through TEST.UPDATE_INTERVALS under the
    reference's dataset name "DepthTrack", which has no entry: the
    fallback never commits a template candidate, the reference's shipped
    VOT-RGBD behaviour. `tracker` None builds the script's tracker with
    `create_tracker` on `device` (CUDA unless "cpu"; raises without a card)
    in `dtype`."""
    from multi_modal_tracking_torch.eval.running import _imread, _read_depth_as_rgb

    def load(paths):
        if isinstance(paths, (list, tuple)) and len(paths) == 2:
            aux = _read_depth_as_rgb(paths[1]) if channels == "rgbd" else _imread(paths[1])
            return [_imread(paths[0]), aux]
        img = _imread(paths if isinstance(paths, str) else paths[0])
        return [img, img]

    if tracker is None:
        resolve_device(device)              # raise before the toolkit's first request
    handle = VOTClient(channels=channels, server=server)
    if tracker is None:
        tracker = _create(script, training_yaml, checkpoint, dataset_name,
                          "RGBT" if channels in ("rgbd", "rgbt") else "RGB", device, dtype)
        if update_interval is not None:
            tracker.update_interval = update_interval
    r = handle.region()
    tracker.initialize(load(handle._image), {"init_bbox": [r.x, r.y, r.width, r.height]})
    while True:
        paths = handle.frame()
        if paths is None:
            break
        out = tracker.track(load(paths))
        x, y, w, h = out["target_bbox"]
        handle.report(Rectangle(x, y, w, h), out.get("pred_score", 1.0))
    handle.quit()


def run_vot20_lt_exp(script: str, training_yaml: Optional[str] = None,
                     checkpoint: Optional[str] = None, server=None, tracker=None,
                     device="cuda", dtype=torch.bfloat16):
    """VOT2020-LT: colour frames, the rectangle and the confidence every
    frame (the reference's stark_vot20lt.py); dataset name "VOT20LT"
    resolves UPDATE_INTERVALS.VOT20LT."""
    return run_vot_exp(script, training_yaml, checkpoint=checkpoint, channels="color",
                       server=server, tracker=tracker, dataset_name="VOT20LT", device=device,
                       dtype=dtype)


def run_vot20_mask_exp(script: str, training_yaml: Optional[str] = None,
                       checkpoint: Optional[str] = None,
                       refine_checkpoint: Optional[str] = None,
                       mask_threshold: float = 0.6, server=None, tracker=None, refiner=None,
                       device="cuda", dtype=torch.bfloat16):
    """VOT2020 mask experiment (the reference's
    VOT2020_super_only_mask_384_HP/mixformer_alpha_seg_class.py): every
    frame the tracker's box is refined by Alpha-Refine (input 384, f32)
    into a mask, thresholded at `mask_threshold`, and reported as a binary
    uint8 (H, W) array. `refiner` None builds `ARcmSeg` on `device` with
    random weights, or `refine_checkpoint`'s (a strict load). The port's
    own wire reports rectangles only: a mask run over it raises ValueError
    at the first report; the `trax` package or an injected server takes
    masks."""
    from multi_modal_tracking_torch.eval.running import _imread

    if tracker is None or refiner is None:
        resolve_device(device)              # raise before the toolkit's first request
    handle = VOTClient(channels="color", server=server)
    if tracker is None:
        tracker = _create(script, training_yaml, checkpoint, "VOT20", "RGB", device, dtype)
    if refiner is None:
        from multi_modal_tracking_torch.models.alpha_refine import ARcmSeg, build_alpha_refine
        net, _ = build_alpha_refine(input_sz=384, device=device)
        if refine_checkpoint:
            from multi_modal_tracking_torch.utils.checkpoint import load_variables
            load_variables(refine_checkpoint, net, strict=True)
        refiner = ARcmSeg(net)

    def load(paths):
        return _imread(paths if isinstance(paths, str) else paths[0])

    r = handle.region()
    box = [r.x, r.y, r.width, r.height]
    frame0 = load(handle._image)
    tracker.initialize(frame0, {"init_bbox": box})
    refiner.initialize(frame0, box)
    while True:
        paths = handle.frame()
        if paths is None:
            break
        frame = load(paths)
        out = tracker.track(frame)
        mask = (refiner.get_mask(frame, out["target_bbox"]) > mask_threshold).astype(np.uint8)
        handle.report(mask, out.get("pred_score", 1.0))
    handle.quit()


def _create(script, training_yaml, checkpoint, dataset_name, mode, device, dtype):
    from multi_modal_tracking_torch.eval.evaltracker import create_tracker
    from multi_modal_tracking_torch.eval.params import get_parameters
    params = get_parameters(script, training_yaml, checkpoint=checkpoint)
    return create_tracker(params, dataset_name=dataset_name, device=device, dtype=dtype,
                          mode=mode)


# ---------------------------------------------------------------------------
# Mask <-> rectangle helpers (the reference's vot20_utils.py)

def make_full_size(x: np.ndarray, output_sz) -> np.ndarray:
    """Zero-pad (right, down) or crop a mask to output_sz = [width, height]."""
    if x.shape[0] == output_sz[1] and x.shape[1] == output_sz[0]:
        return x
    pad_x = output_sz[0] - x.shape[1]
    if pad_x < 0:
        x = x[:, :x.shape[1] + pad_x]
        pad_x = 0
    pad_y = output_sz[1] - x.shape[0]
    if pad_y < 0:
        x = x[:x.shape[0] + pad_y, :]
        pad_y = 0
    return np.pad(x, ((0, pad_y), (0, pad_x)), "constant", constant_values=0)


def rect_from_mask(mask: np.ndarray):
    """Tight [x, y, w, h] around the nonzero pixels."""
    x_ = np.sum(mask, axis=0)
    y_ = np.sum(mask, axis=1)
    x0, x1 = np.min(np.nonzero(x_)), np.max(np.nonzero(x_))
    y0, y1 = np.min(np.nonzero(y_)), np.max(np.nonzero(y_))
    return [x0, y0, x1 - x0 + 1, y1 - y0 + 1]


def mask_from_rect(rect, output_sz) -> np.ndarray:
    """Binary uint8 mask of rect [x, y, w, h] inside output_sz = [w, h]."""
    mask = np.zeros((output_sz[1], output_sz[0]), dtype=np.uint8)
    x0 = max(int(round(rect[0])), 0)
    y0 = max(int(round(rect[1])), 0)
    x1 = min(int(round(rect[0] + rect[2])), output_sz[0])
    y1 = min(int(round(rect[1] + rect[3])), output_sz[1])
    mask[y0:y1, x0:x1] = 1
    return mask


def bbox_clip(x1, y1, x2, y2, boundary, min_sz: int = 10):
    """Clip an xyxy box to the image boundary (H, W), keeping at least
    min_sz of extent."""
    x1_new = max(0, min(x1, boundary[1] - min_sz))
    y1_new = max(0, min(y1, boundary[0] - min_sz))
    x2_new = max(min_sz, min(x2, boundary[1]))
    y2_new = max(min_sz, min(y2, boundary[0]))
    return x1_new, y1_new, x2_new, y2_new


# ---------------------------------------------------------------------------
# Command line

#: each entry's script and recipe, those of vot_workspace/*/vot_entry_*.py
ENTRIES = {
    "mask": ("mixformer_vit", "baseline"),
    "lt": ("mixformer_vit", "baseline"),
    "rgbd": ("asymmetric_shared_online", "baseline"),
}


def protocol_stdout():
    """A text stream on the process's original standard output, for the
    protocol; file descriptor 1 and `sys.stdout` then write to stderr."""
    sys.stdout.flush()
    proto = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    return proto


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m multi_modal_tracking_torch.eval.vot",
                                description="Run a VOT entry over TraX on stdio.")
    p.add_argument("entry", choices=sorted(ENTRIES))
    p.add_argument("--script", default=None, help="tracker script (default: the entry's)")
    p.add_argument("--yaml", default=None, help="training recipe (default: the entry's)")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--refine_checkpoint", default=None, help="Alpha-Refine weights (mask)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    args = p.parse_args(argv)
    resolve_device(args.device)
    script = args.script or ENTRIES[args.entry][0]
    yaml = args.yaml or ENTRIES[args.entry][1]
    channels = "rgbd" if args.entry == "rgbd" else "color"
    server = None
    try:
        import trax  # noqa: F401  (VOTClient speaks through it)
    except ImportError:
        from multi_modal_tracking_torch.eval.trax_wire import TraxWireServer
        server = TraxWireServer(channels=_CHANNELS[channels], fin=sys.stdin,
                                fout=protocol_stdout())
    common = dict(checkpoint=args.checkpoint, server=server, device=args.device,
                  dtype=DTYPES[args.dtype])
    if args.entry == "mask":
        run_vot20_mask_exp(script, yaml, refine_checkpoint=args.refine_checkpoint, **common)
    elif args.entry == "lt":
        run_vot20_lt_exp(script, yaml, **common)
    else:
        run_vot_exp(script, yaml, channels="rgbd", **common)


if __name__ == "__main__":
    main()
