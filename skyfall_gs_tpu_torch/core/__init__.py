"""Math primitives: transforms, spherical harmonics, cameras (port of skyfall_gs_tpu.core)."""
