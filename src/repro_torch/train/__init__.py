"""Train and serve steps of the LM substrate, on one device or a
mesh."""
