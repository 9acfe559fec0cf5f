"""Small numeric utilities (port of skyfall_gs_tpu.utils)."""
