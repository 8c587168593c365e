"""Training: digits data, checkpoints, the single-device harness."""
