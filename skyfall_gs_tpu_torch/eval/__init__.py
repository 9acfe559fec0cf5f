"""Evaluation suites (port of skyfall_gs_tpu.eval): DSM registration and
geometric accuracy, geodesy, photometric and distribution metrics, LPIPS
and CMMD."""
