"""Fused-PLY / .splat export CLI: bake the 3D filter (and optionally the
appearance MLP) into a viewer-compatible point cloud.

Port of ``skyfall_gs_tpu/cli/create_fused_ply.py``: the format follows the
output's extension (``.splat``, else a fused PLY); ``--color_mapped``
bakes the appearance MLP into the PLY's SH colours.  The checkpoint
loads on ``--device`` (default ``cuda``; there is no fallback to the CPU),
where the filter bake and the appearance MLP run; only the file write is
host work.

Usage:
    python -m skyfall_gs_tpu_torch.cli.create_fused_ply -c out/chkpnt30000.npz -o fused.ply
    python -m skyfall_gs_tpu_torch.cli.create_fused_ply -c ... -o scene.splat --device cpu
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", "-c", type=str, required=True)
    parser.add_argument("--output", "-o", type=str, required=True)
    parser.add_argument("--color_mapped", action="store_true",
                        help="bake the appearance MLP into the SH colors")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from skyfall_gs_tpu_torch.cli.render_video import load_state_from_checkpoint
    from skyfall_gs_tpu_torch.cli.train import resolve_device
    from skyfall_gs_tpu_torch.io.gaussian_ply import save_fused_ply, save_splat

    state, it = load_state_from_checkpoint(args.checkpoint, device=resolve_device(args.device))
    print(f"loaded checkpoint at iteration {it}; {int(state.num_alive)} gaussians")
    if args.output.endswith(".splat"):
        # SH band 0 only, the filter baked as in the fused PLY.
        save_splat(state, args.output)
    else:
        save_fused_ply(state, args.output, color_mapped=args.color_mapped)
    print("wrote", args.output)


if __name__ == "__main__":
    main()
