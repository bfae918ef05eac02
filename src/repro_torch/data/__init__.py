"""The synthetic token pipeline of the LM substrate."""
