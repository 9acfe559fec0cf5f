"""Visualization helpers (port of skyfall_gs_tpu.viz): depth colorization."""
