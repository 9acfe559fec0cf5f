"""Scene readers and containers, synthetic scenes, PNG, PLY and ``.splat``
I/O (port of skyfall_gs_tpu.io)."""
