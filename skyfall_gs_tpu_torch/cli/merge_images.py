"""Side-by-side / split-wipe comparison frames from two render folders.

A copy of ``skyfall_gs_tpu/cli/merge_images.py`` (host work with OpenCV,
no tensor work, so no ``--device``): composites two image sequences into
comparison frames, split at a fixed or moving seam, for before / after
IDU visualizations (reference scripts/merge_images.py).

Usage:
    python -m skyfall_gs_tpu_torch.cli.merge_images --left A --right B --out OUT \
        [--mode wipe|side] [--sweep]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def merge_pair(a: np.ndarray, b: np.ndarray, seam: float,
               mode: str = "wipe") -> np.ndarray:
    h, w = a.shape[:2]
    if mode == "side":
        return np.concatenate([a, b], axis=1)
    out = a.copy()
    x = int(w * seam)
    out[:, x:] = b[:, x:]
    out[:, max(x - 1, 0):x + 1] = 1.0
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--left", required=True, help="first frames dir")
    parser.add_argument("--right", required=True, help="second frames dir")
    parser.add_argument("--out", required=True)
    parser.add_argument("--mode", choices=["wipe", "side"], default="wipe")
    parser.add_argument("--sweep", action="store_true",
                        help="animate the seam across the sequence")
    args = parser.parse_args(argv)

    import cv2

    os.makedirs(args.out, exist_ok=True)
    names = sorted(os.listdir(args.left))
    n = len(names)
    for i, name in enumerate(names):
        pa = os.path.join(args.left, name)
        pb = os.path.join(args.right, name)
        if not os.path.exists(pb):
            continue
        a = cv2.imread(pa).astype(np.float32) / 255.0
        b = cv2.imread(pb).astype(np.float32) / 255.0
        if a.shape != b.shape:
            b = cv2.resize(b, (a.shape[1], a.shape[0]))
        seam = (i / max(n - 1, 1)) if args.sweep else 0.5
        m = merge_pair(a, b, seam, args.mode)
        cv2.imwrite(os.path.join(args.out, name),
                    (np.clip(m, 0, 1) * 255).astype(np.uint8))
    print(f"wrote {n} merged frames to {args.out}")


if __name__ == "__main__":
    main()
