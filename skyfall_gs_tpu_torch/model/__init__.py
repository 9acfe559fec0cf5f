"""Gaussian state, appearance model, rendering front-end, optimizer and
adaptive density control (port of skyfall_gs_tpu.model)."""
