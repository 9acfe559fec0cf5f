"""Command-line entry points (port of skyfall_gs_tpu.cli): ``train``
(with the SIBR viewer bridge, ``--gui_port``), ``gen_render_path``,
``render_video``, ``render_videos`` (a batch over scenes and paths),
``create_fused_ply``, ``align_ges``, ``eval_geometry``,
``eval_photometric``, and the host-only tools ``merge_images`` and
``convert`` (COLMAP).  Each ``main(argv)`` takes its arguments as a list,
so the chain also runs in-process."""
