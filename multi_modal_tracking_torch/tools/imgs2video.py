"""An image directory (files ordered by name length, then name) to an mp4;
the port's counterpart of tracking/imgs2video.py. cv2 reads the images and
writes the container (ImportError without it).

  python -m multi_modal_tracking_torch.tools.imgs2video <img_dir> <video_path> [--fps 20]
"""
from __future__ import annotations

import argparse
import os


def imgs2video(img_dir: str, video_path: str, fps: int = 20) -> str:
    from multi_modal_tracking_torch.eval.visualize import import_cv2
    cv2 = import_cv2("imgs2video")
    names = sorted((n for n in os.listdir(img_dir)
                    if n.lower().endswith((".jpg", ".jpeg", ".png", ".bmp"))),
                   key=lambda x: (len(x), x))
    if not names:
        raise SystemExit(f"no images in {img_dir}")
    first = cv2.imread(os.path.join(img_dir, names[0]))
    h, w = first.shape[:2]
    writer = cv2.VideoWriter(video_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h),
                             isColor=True)
    for n in names:
        frame = cv2.imread(os.path.join(img_dir, n))
        if frame is not None:
            writer.write(frame)
    writer.release()
    return video_path


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m multi_modal_tracking_torch.tools.imgs2video")
    p.add_argument("img_dir", type=str)
    p.add_argument("video_path", type=str)
    p.add_argument("--fps", type=int, default=20)
    a = p.parse_args(argv)
    print(imgs2video(a.img_dir, a.video_path, a.fps))


if __name__ == "__main__":
    main()
