"""Orbit trajectory JSON generator CLI.

Port of ``skyfall_gs_tpu/cli/gen_render_path.py``: an orbit path, with the
optional Google-Earth-Studio altitude conversion (``--ges``).
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> str:
    """Write the path; returns its file name."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--fov", type=float, default=60.0)
    parser.add_argument("--target", type=str, default="0,0,0")
    parser.add_argument("--elevation", type=float, default=0.0)
    parser.add_argument("--radius", type=float, default=200.0)
    parser.add_argument("--num_frame", type=int, default=240)
    parser.add_argument("--fps", type=int, default=24)
    parser.add_argument("--height", type=int, default=512)
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--output_folder", type=str, required=True)
    parser.add_argument("--ges", action="store_true")
    parser.add_argument("--alt_tar", type=float)
    parser.add_argument("--alt_cam", type=float)
    args = parser.parse_args(argv)

    from skyfall_gs_tpu_torch.viz.paths import ges_to_orbit, save_orbit_path

    elevation, radius = args.elevation, args.radius
    if args.ges:
        if args.alt_tar is None or args.alt_cam is None:
            parser.error("--ges requires --alt_tar and --alt_cam")
        elevation, radius = ges_to_orbit(args.radius, args.alt_tar, args.alt_cam)
        print(f"GES conversion: elevation={elevation:.2f} radius={radius:.2f}")

    target = [float(x) for x in args.target.split(",")]
    out = os.path.join(args.output_folder,
                       f"r{int(radius)}_e{int(elevation)}_fov{int(args.fov)}.json")
    save_orbit_path(out, target, elevation, radius, args.num_frame,
                    args.fov, args.width, args.height, args.fps)
    print("Camera path saved to", out)
    return out


if __name__ == "__main__":
    main()
