"""Batched serving of the LM substrate."""
