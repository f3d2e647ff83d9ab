"""A video to numbered image files (<img_dir>/000000.<ext>, ...); the
port's counterpart of tracking/video2imgs.py. cv2 reads the container and
writes the images (ImportError without it).

  python -m multi_modal_tracking_torch.tools.video2imgs <video_path> <img_dir> [--ext jpg]
"""
from __future__ import annotations

import argparse
import os


def video2imgs(video_path: str, img_dir: str, ext: str = "jpg") -> int:
    from multi_modal_tracking_torch.eval.visualize import import_cv2
    cv2 = import_cv2("video2imgs")
    os.makedirs(img_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    k = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        cv2.imwrite(os.path.join(img_dir, f"{k:06d}.{ext}"), frame)
        k += 1
    cap.release()
    return k


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m multi_modal_tracking_torch.tools.video2imgs")
    p.add_argument("video_path", type=str)
    p.add_argument("img_dir", type=str)
    p.add_argument("--ext", type=str, default="jpg")
    a = p.parse_args(argv)
    print(f"wrote {video2imgs(a.video_path, a.img_dir, a.ext)} frames")


if __name__ == "__main__":
    main()
