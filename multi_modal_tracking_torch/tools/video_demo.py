"""Track a video file or an image directory from an initial box and write
an mp4 with the predicted box drawn on every frame; the port's counterpart
of tracking/video_demo.py. An image directory is read through the port's
own decoder (JPEG and PNG; other files are skipped); a video file is read,
and the mp4 written, through cv2 (ImportError without it). --select_roi
picks the initial box with cv2.selectROI on a display.

  python -m multi_modal_tracking_torch.tools.video_demo mixformer_vit baseline video.mp4 \\
      --optional_box 120 80 60 50 --checkpoint ckpt.pth.tar
"""
from __future__ import annotations

import argparse
import os


def _frames_from(path):
    """RGB uint8 frames of an image directory (the port's decoder) or of a
    video file (cv2)."""
    from multi_modal_tracking_torch import native
    if os.path.isdir(path):
        for n in sorted(os.listdir(path)):
            try:
                yield native.imread(os.path.join(path, n))
            except ValueError:          # not an image the decoder reads
                continue
        return
    from multi_modal_tracking_torch.eval.visualize import import_cv2
    cv2 = import_cv2("video_demo")
    cap = cv2.VideoCapture(path)
    while True:
        ok, img = cap.read()
        if not ok:
            return
        yield img[..., ::-1].copy()


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m multi_modal_tracking_torch.tools.video_demo")
    p.add_argument("script", type=str)
    p.add_argument("config", type=str, nargs="?", default=None)
    p.add_argument("video", type=str, help="video file or image directory")
    p.add_argument("--optional_box", type=float, nargs=4, default=None,
                   metavar=("x", "y", "w", "h"))
    p.add_argument("--select_roi", action="store_true",
                   help="pick the init box with cv2.selectROI (needs cv2 and a display; "
                        "headless hosts use --optional_box)")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--out", type=str, default="output/demo.mp4")
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["bfloat16", "float32"])
    args = p.parse_args(argv)

    from multi_modal_tracking_torch.eval.evaltracker import create_tracker
    from multi_modal_tracking_torch.eval.params import get_parameters
    from multi_modal_tracking_torch.eval.visualize import draw_boxes, import_cv2
    from multi_modal_tracking_torch.models.build import is_rgbt_script
    from multi_modal_tracking_torch.utils.device import DTYPES

    cv2 = import_cv2("video_demo")                   # the mp4 writer
    params = get_parameters(args.script, args.config, checkpoint=args.checkpoint)
    mode = "RGBT" if is_rgbt_script(args.script) else "RGB"
    tracker = create_tracker(params, mode=mode, device=args.device, dtype=DTYPES[args.dtype])

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    writer = None
    init_box = args.optional_box
    for k, frame in enumerate(_frames_from(args.video)):
        image = [frame, frame] if mode == "RGBT" else frame
        if k == 0:
            if init_box is None:
                if not args.select_roi:
                    raise SystemExit("pass --optional_box x y w h, or --select_roi on a "
                                     "host with a display")
                x, y, w, h = cv2.selectROI("Select target ROI and press ENTER",
                                           frame[..., ::-1].copy(), fromCenter=False)
                init_box = [float(x), float(y), float(w), float(h)]
            tracker.initialize(image, {"init_bbox": list(init_box)})
            box = list(init_box)
        else:
            box = tracker.track(image)["target_bbox"]
        vis = draw_boxes(frame, {"pred": box})
        if writer is None:
            h, w = vis.shape[:2]
            writer = cv2.VideoWriter(args.out, cv2.VideoWriter_fourcc(*"mp4v"), args.fps, (w, h))
        writer.write(vis[..., ::-1].copy())
    if writer is not None:
        writer.release()
    print("wrote", args.out)
    return args.out


if __name__ == "__main__":
    main()
