"""Offline media preprocessing: the reference's `independent/` scripts as
importable functions and a CLI (counterpart of ofa_sr_tpu/tools/media.py,
this package's own copy of that host code: numpy, with PIL imported inside
the functions that open or write an image, so importing the module needs
neither PIL nor OpenCV).

    python -m ofa_sr_tpu_torch.tools.media {mp4_to_png,yuv_to_png,crop,resize,scene_cuts} ...

- mp4_to_png: OpenCV frame extraction -> numbered PNGs
  (independent/mp4_to_png.py:4-49)
- yuv_to_png: ffmpeg rawvideo yuv420p decode -> PNG frames, with clip
  bucketing/train-test-val splitting (independent/uvg_to_png.py:40-135);
  a numpy decoder where ffmpeg is absent
- crop_and_save: center-crop batch job (independent/crop_and_save.py:7-17)
- resize_and_save: bicubic downscale batch job (independent/resize_and_save.py:7-12)
- color_histogram_difference: per-channel histogram L2 between consecutive
  frames for scene-cut detection (independent/color_histogram_difference.py:10-33)
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Optional

import numpy as np


def mp4_to_png(video_path: str, out_dir: str, *, start=0, limit=None,
               name_fmt="%04d.png") -> int:
    """Extract frames with OpenCV; returns the number written."""
    import cv2
    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    n = 0
    idx = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if idx >= start and (limit is None or n < limit):
            cv2.imwrite(os.path.join(out_dir, name_fmt % n), frame)
            n += 1
        idx += 1
    cap.release()
    return n


def _yuv420_to_rgb(y, u, v):
    """BT.601 full-range YUV420p -> RGB (numpy)."""
    h, w = y.shape
    u = np.repeat(np.repeat(u, 2, 0), 2, 1)[:h, :w]
    v = np.repeat(np.repeat(v, 2, 0), 2, 1)[:h, :w]
    yf = y.astype(np.float32)
    uf = u.astype(np.float32) - 128.0
    vf = v.astype(np.float32) - 128.0
    r = yf + 1.402 * vf
    g = yf - 0.344136 * uf - 0.714136 * vf
    b = yf + 1.772 * uf
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def yuv_to_png(yuv_path: str, out_dir: str, width=1920, height=1080, *,
               limit=None, name_fmt="%04d.png") -> int:
    """Decode rawvideo yuv420p to PNG frames. Uses ffmpeg when available
    (the reference command, uvg_to_png.py:40), else a numpy decoder."""
    os.makedirs(out_dir, exist_ok=True)
    if shutil.which("ffmpeg"):
        cmd = ["ffmpeg", "-y", "-pix_fmt", "yuv420p",
               "-s", "%dx%d" % (width, height), "-i", yuv_path]
        if limit:
            cmd += ["-vframes", str(limit)]
        cmd += [os.path.join(out_dir, name_fmt)]
        subprocess.run(cmd, check=True, capture_output=True)
        return len([f for f in os.listdir(out_dir) if f.endswith(".png")])
    from PIL import Image

    frame_bytes = width * height * 3 // 2
    n = 0
    with open(yuv_path, "rb") as f:
        while limit is None or n < limit:
            buf = f.read(frame_bytes)
            if len(buf) < frame_bytes:
                break
            arr = np.frombuffer(buf, np.uint8)
            y = arr[:width * height].reshape(height, width)
            u = arr[width * height:width * height * 5 // 4].reshape(height // 2, width // 2)
            v = arr[width * height * 5 // 4:].reshape(height // 2, width // 2)
            Image.fromarray(_yuv420_to_rgb(y, u, v)).save(
                os.path.join(out_dir, name_fmt % n))
            n += 1
    return n


def split_frames(frames_dir: str, out_root: str, *, train=0.8, test=0.1,
                 bucket_size: Optional[int] = None) -> dict:
    """Clip bucketing + train/test/val split (uvg_to_png.py:45-135): frames
    are grouped into buckets (clips) and whole buckets are assigned."""
    frames = sorted(f for f in os.listdir(frames_dir) if f.endswith(".png"))
    bucket_size = bucket_size or max(1, len(frames) // 10)
    buckets = [frames[i:i + bucket_size]
               for i in range(0, len(frames), bucket_size)]
    n_train = int(round(train * len(buckets)))
    n_test = int(round(test * len(buckets)))
    assign = (["train"] * n_train + ["test"] * n_test
              + ["val"] * (len(buckets) - n_train - n_test))
    counts = {"train": 0, "test": 0, "val": 0}
    for bucket, split in zip(buckets, assign):
        d = os.path.join(out_root, split)
        os.makedirs(d, exist_ok=True)
        for fname in bucket:
            shutil.copy(os.path.join(frames_dir, fname), os.path.join(d, fname))
            counts[split] += 1
    return counts


def crop_and_save(in_dir: str, out_dir: str, size=448) -> int:
    """Center-crop every image (crop_and_save.py:7-17)."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for fname in sorted(os.listdir(in_dir)):
        if not fname.lower().endswith((".png", ".jpg", ".jpeg")):
            continue
        img = Image.open(os.path.join(in_dir, fname)).convert("RGB")
        w, h = img.size
        j, i = (w - size) // 2, (h - size) // 2
        img.crop((j, i, j + size, i + size)).save(os.path.join(out_dir, fname))
        n += 1
    return n


def resize_and_save(in_dir: str, out_dir: str, factor=4) -> int:
    """Bicubic downscale every image (resize_and_save.py:7-12)."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for fname in sorted(os.listdir(in_dir)):
        if not fname.lower().endswith((".png", ".jpg", ".jpeg")):
            continue
        img = Image.open(os.path.join(in_dir, fname)).convert("RGB")
        w, h = img.size
        img.resize((w // factor, h // factor), Image.BICUBIC).save(
            os.path.join(out_dir, fname))
        n += 1
    return n


def color_histogram_difference(frames_dir: str, bins=256) -> List[float]:
    """Per-channel 256-bin histogram L2 between consecutive frames
    (color_histogram_difference.py:10-33); peaks mark scene cuts."""
    from PIL import Image

    frames = sorted(f for f in os.listdir(frames_dir)
                    if f.lower().endswith((".png", ".jpg", ".jpeg")))
    diffs = []
    prev = None
    for fname in frames:
        arr = np.asarray(Image.open(os.path.join(frames_dir, fname)).convert("RGB"))
        hist = np.stack([np.histogram(arr[..., c], bins=bins,
                                      range=(0, 255))[0]
                         for c in range(3)]).astype(np.float64)
        if prev is not None:
            diffs.append(float(np.sqrt(((hist - prev) ** 2).sum())))
        prev = hist
    return diffs


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("mp4_to_png")
    s.add_argument("video"); s.add_argument("out_dir")
    s = sub.add_parser("yuv_to_png")
    s.add_argument("yuv"); s.add_argument("out_dir")
    s.add_argument("--width", type=int, default=1920)
    s.add_argument("--height", type=int, default=1080)
    s = sub.add_parser("crop")
    s.add_argument("in_dir"); s.add_argument("out_dir")
    s.add_argument("--size", type=int, default=448)
    s = sub.add_parser("resize")
    s.add_argument("in_dir"); s.add_argument("out_dir")
    s.add_argument("--factor", type=int, default=4)
    s = sub.add_parser("scene_cuts")
    s.add_argument("frames_dir")
    args = p.parse_args(argv)
    if args.cmd == "mp4_to_png":
        print(mp4_to_png(args.video, args.out_dir))
    elif args.cmd == "yuv_to_png":
        print(yuv_to_png(args.yuv, args.out_dir, args.width, args.height))
    elif args.cmd == "crop":
        print(crop_and_save(args.in_dir, args.out_dir, args.size))
    elif args.cmd == "resize":
        print(resize_and_save(args.in_dir, args.out_dir, args.factor))
    elif args.cmd == "scene_cuts":
        for i, d in enumerate(color_histogram_difference(args.frames_dir)):
            print(i, d)


if __name__ == "__main__":
    main()
