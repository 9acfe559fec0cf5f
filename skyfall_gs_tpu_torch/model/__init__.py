"""Gaussian state, rendering front-end, optimizer, densification statistics
(port of skyfall_gs_tpu.model)."""
