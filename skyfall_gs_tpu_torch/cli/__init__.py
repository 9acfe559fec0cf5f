"""Command-line entry points (port of skyfall_gs_tpu.cli): ``train``,
``gen_render_path``, ``render_video`` and ``create_fused_ply``.  Each
``main(argv)`` takes its arguments as a list, so the chain also runs
in-process."""
