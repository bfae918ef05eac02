"""Step builders of the LM substrate (serving steps only so far)."""
