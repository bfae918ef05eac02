"""Fault-tolerant checkpoints of train states."""
