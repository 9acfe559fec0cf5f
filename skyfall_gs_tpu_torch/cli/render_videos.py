"""Batch trajectory rendering across scenes and camera paths.

Port of ``skyfall_gs_tpu/cli/render_videos.py`` (reference
render_videos.py:12-176): finds the trajectory JSONs of ``--camera_paths``
(a directory, or one file), renders each (scene, path) pair from
``<output_root>/<scene>/chkpnt<iteration>.npz`` through a
``skyfall_gs_tpu_torch.cli.render_video`` subprocess, the jobs spread over
``--num_workers`` launcher slots, and logs failures without stopping the
batch.  ``--device`` (default ``cuda``; there is no fallback to the CPU)
is passed to every job.

Usage:
    python -m skyfall_gs_tpu_torch.cli.render_videos --output_root OUT \\
        --scenes A B --camera_paths paths/ --iteration 30000 --num_workers 2
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

from skyfall_gs_tpu_torch.parallel.launcher import SceneJob, run_scene_jobs


def main(argv=None):
    """Run the jobs; returns them with their return codes."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--output_root", required=True,
                        help="root containing per-scene model dirs")
    parser.add_argument("--scenes", nargs="+", required=True)
    parser.add_argument("--camera_paths", required=True,
                        help="dir of trajectory JSONs (or a single json)")
    parser.add_argument("--iteration", type=int, default=80000)
    parser.add_argument("--mode", choices=["rgb", "depth"], default="rgb")
    parser.add_argument("--num_workers", type=int, default=1)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from skyfall_gs_tpu_torch.cli.train import resolve_device

    resolve_device(args.device)
    if os.path.isdir(args.camera_paths):
        paths = sorted(glob.glob(os.path.join(args.camera_paths, "*.json")))
    else:
        paths = [args.camera_paths]

    jobs = []
    for scene in args.scenes:
        model_dir = os.path.join(args.output_root, scene)
        ckpt = os.path.join(model_dir, f"chkpnt{args.iteration}.npz")
        for path in paths:
            tag = os.path.splitext(os.path.basename(path))[0]
            out = os.path.join(model_dir, "videos", f"{tag}_{args.mode}.mp4")
            jobs.append(SceneJob(
                name=f"{scene}_{tag}",
                argv=[sys.executable, "-m", "skyfall_gs_tpu_torch.cli.render_video",
                      "--checkpoint", ckpt, "--camera_path", path,
                      "--out", out, "--mode", args.mode, "--device", args.device],
            ))
    return run_scene_jobs(jobs, os.path.join(args.output_root, "render_logs"),
                          num_workers=args.num_workers)


if __name__ == "__main__":
    main()
