"""Checkpoints (timers and logging come from ``wgsassign_tpu.obs``)."""
