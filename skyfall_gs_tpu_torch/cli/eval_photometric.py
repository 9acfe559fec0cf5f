"""Photometric/perceptual evaluation CLI over rendered videos.

Port of ``skyfall_gs_tpu/cli/eval_photometric.py`` (reference
eval.py:410-590): per scene, extract GT frames from reference videos and
method frames from rendered videos, compute PSNR/SSIM on ``--device``,
patch-level CLIP-FID and CMMD with ``--distribution`` (needs local CLIP
weights), and write per-scene + summary CSVs.  ``--device`` defaults to
``cuda``; there is no fallback to the CPU.

Layout (reference results_eval/README.md):
    <root>/gt/<scene>.mp4
    <root>/<method>/<scene>.mp4

Usage:
    python -m skyfall_gs_tpu_torch.cli.eval_photometric --root <root> \
        --methods ours --scenes JAX_004 [--distribution] [--out_csv res.csv]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> list:
    """Evaluate every (method, scene) pair; returns the CSV rows."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", required=True)
    parser.add_argument("--methods", nargs="+", required=True)
    parser.add_argument("--scenes", nargs="+", required=True)
    parser.add_argument("--num_frames", type=int, default=30)
    parser.add_argument("--resize", type=int, default=1024)
    parser.add_argument("--no_resize", action="store_true")
    parser.add_argument("--distribution", action="store_true",
                        help="also compute CLIP-FID/CMMD (needs local CLIP)")
    parser.add_argument("--out_csv", default="eval_results.csv")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from skyfall_gs_tpu_torch.cli.train import resolve_device
    from skyfall_gs_tpu_torch.eval.photometric import (
        distribution_metrics,
        extract_frames,
        paired_metrics,
        summarize,
        write_csv,
    )

    device = resolve_device(args.device)
    resize = None if args.no_resize else args.resize
    rows = []
    for method in args.methods:
        for scene in args.scenes:
            gt_path = os.path.join(args.root, "gt", f"{scene}.mp4")
            mp = os.path.join(args.root, method, f"{scene}.mp4")
            if not (os.path.exists(gt_path) and os.path.exists(mp)):
                print(f"skip {method}/{scene}: missing video")
                continue
            gt = extract_frames(gt_path, args.num_frames, resize)
            pred = extract_frames(mp, args.num_frames, resize)
            row = {"method": method, "scene": scene}
            row.update(paired_metrics(gt, pred, device=device))
            if args.distribution:
                try:
                    row.update(distribution_metrics(gt, pred, device=device))
                except RuntimeError as e:
                    print(f"distribution metrics unavailable: {e}")
            rows.append(row)
            print(row)

    write_csv(args.out_csv, rows)
    for method in args.methods:
        mrows = [r for r in rows if r["method"] == method]
        print(method, summarize(mrows, ["psnr", "ssim", "lpips", "clip_fid", "cmmd"]))
    return rows


if __name__ == "__main__":
    main()
