"""Scene containers, the synthetic city scene and PLY I/O (port of
skyfall_gs_tpu.io).  The on-disk scene readers are not ported yet."""
