"""The Stage-1 training step (port of skyfall_gs_tpu.train)."""
