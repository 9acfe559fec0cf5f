"""The Stage-1 training step, the Trainer, checkpoints and metrics logging
(port of skyfall_gs_tpu.train)."""
