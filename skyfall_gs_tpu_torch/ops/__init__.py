"""Projection, binning, compositing and losses (port of skyfall_gs_tpu.ops)."""
