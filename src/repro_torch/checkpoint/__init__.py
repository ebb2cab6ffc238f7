"""Atomic, restart-safe checkpoints of the training state."""
