"""Atomic, rotating checkpoints of a training state."""
