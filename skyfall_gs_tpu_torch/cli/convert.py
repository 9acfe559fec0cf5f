"""COLMAP scene conversion wrapper.

A copy of ``skyfall_gs_tpu/cli/convert.py`` (host work, no tensor work, so
no ``--device``; reference convert.py:31-130): drives the ``colmap``
binary (feature_extractor -> exhaustive_matcher -> mapper ->
image_undistorter), moves the sparse model into ``sparse/0`` and
optionally writes ``images_2/4/8`` pyramids (``INTER_AREA``), the layout
``io/colmap.py`` reads.

Usage:
    python -m skyfall_gs_tpu_torch.cli.convert -s <scene with input/> \
        [--skip_matching] [--resize] [--no_gpu] [--colmap_executable PATH]
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys


def run(cmd: list, allow_fail: bool = False) -> None:
    print("+", " ".join(cmd), flush=True)
    rc = subprocess.call(cmd)
    if rc != 0 and not allow_fail:
        print(f"command failed with code {rc}", file=sys.stderr)
        sys.exit(rc)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--camera", default="OPENCV")
    parser.add_argument("--colmap_executable", default="colmap")
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--resize", action="store_true",
                        help="also write images_2/4/8 pyramids")
    args = parser.parse_args(argv)

    colmap = args.colmap_executable
    if shutil.which(colmap) is None:
        print(f"colmap binary '{colmap}' not found on PATH", file=sys.stderr)
        sys.exit(1)
    src = args.source_path
    use_gpu = "0" if args.no_gpu else "1"

    if not args.skip_matching:
        os.makedirs(os.path.join(src, "distorted", "sparse"), exist_ok=True)
        run([colmap, "feature_extractor",
             "--database_path", os.path.join(src, "distorted", "database.db"),
             "--image_path", os.path.join(src, "input"),
             "--ImageReader.single_camera", "1",
             "--ImageReader.camera_model", args.camera,
             "--SiftExtraction.use_gpu", use_gpu])
        run([colmap, "exhaustive_matcher",
             "--database_path", os.path.join(src, "distorted", "database.db"),
             "--SiftMatching.use_gpu", use_gpu])
        run([colmap, "mapper",
             "--database_path", os.path.join(src, "distorted", "database.db"),
             "--image_path", os.path.join(src, "input"),
             "--output_path", os.path.join(src, "distorted", "sparse"),
             "--Mapper.ba_global_function_tolerance=0.000001"])

    run([colmap, "image_undistorter",
         "--image_path", os.path.join(src, "input"),
         "--input_path", os.path.join(src, "distorted", "sparse", "0"),
         "--output_path", src,
         "--output_type", "COLMAP"])

    # move sparse files into sparse/0 (reference convert.py layout)
    sparse0 = os.path.join(src, "sparse", "0")
    os.makedirs(sparse0, exist_ok=True)
    for f in os.listdir(os.path.join(src, "sparse")):
        full = os.path.join(src, "sparse", f)
        if os.path.isfile(full):
            shutil.move(full, os.path.join(sparse0, f))

    if args.resize:
        import cv2

        for div in (2, 4, 8):
            out_dir = os.path.join(src, f"images_{div}")
            os.makedirs(out_dir, exist_ok=True)
            for name in os.listdir(os.path.join(src, "images")):
                img = cv2.imread(os.path.join(src, "images", name))
                if img is None:
                    continue
                h, w = img.shape[:2]
                cv2.imwrite(os.path.join(out_dir, name),
                            cv2.resize(img, (w // div, h // div),
                                       interpolation=cv2.INTER_AREA))
    print("done.")


if __name__ == "__main__":
    main()
