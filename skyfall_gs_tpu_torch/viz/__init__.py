"""Visualization (port of skyfall_gs_tpu.viz): depth colorization,
trajectories and trajectory video."""
